"""chip_smoke.py --four-cards rehearsed on four virtual CPU devices: each
sharded path gives exactly the counters of the same work on one device."""
import jax
import pytest

import chip_smoke as cs


def _bp(devices, log):
    h, g = cs._code("data/H.txt")
    return cs._four_bp(devices, h, g, -3.0, 16, 10, log)


def _admm(devices, log):
    h, g = cs._code("data/H.txt")
    return cs._four_admm(devices, h, g, -3.0, 16, 200, 96, log)


def _population(devices, log):
    return cs._four_population(devices, 16, 50, (4, 3, 6), log)


@pytest.mark.parametrize("path", [_bp, _admm, _population])
def test_four_card_path_matches_one_device(path):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    lines = []
    one, four, same = path(devices, lines.append)
    assert same
    assert len(lines) == 1 and "equal" in lines[0]


def test_four_card_phase_raises_on_mismatch(monkeypatch):
    """A path whose sharded run differs from one device fails the phase,
    after every path has run."""
    ran = []

    def fake(name, same):
        def run(*args, **kwargs):
            ran.append(name)
            return None, None, same
        return run

    monkeypatch.setattr(cs, "_four_bp", fake("bp", False))
    monkeypatch.setattr(cs, "_four_admm", fake("qp-admm", True))
    monkeypatch.setattr(cs, "_four_population", fake("population", True))
    with pytest.raises(AssertionError, match=r"\['bp'\]"):
        cs.phase_four_cards(jax.devices()[:4], matrix="data/H.txt")
    assert ran == ["bp", "qp-admm", "population"]
