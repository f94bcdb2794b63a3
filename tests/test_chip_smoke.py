"""chip_smoke.py and bench.py on a host without a card: they refuse to
measure, and each smoke phase runs at a tiny size on data/H.txt."""
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
from ldpc_tpu.config import DecoderConfig

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY_CFG = DecoderConfig(admm_max_iter=200, lp_max_rounds=3,
                         agc_max_rows=64)


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_phase_device_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_exit_nonzero_without_card(script):
    proc = _run([script], ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cw/s" not in proc.stdout and '"value"' not in proc.stdout


def test_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_bp_tiny():
    out = cs.phase_bp(matrix="data/H.txt", trials=256, batch=128,
                      max_iter=10, log=lambda *a: None)
    assert set(out) == {"edge", "mxu"}
    # the layouts decode the same trials identically
    assert out["edge"].correct == out["mxu"].correct
    assert all(r.total == 256 for r in out.values())


@pytest.mark.parametrize("kind", ["qp-admm", "alp", "agc-alp"])
def test_phase_sweep_tiny(kind):
    lines = []
    out = cs.phase_sweep(kinds=(kind,), trials={kind: 16},
                         matrix="data/H.txt", decoder_cfg=TINY_CFG,
                         log=lines.append)
    assert out[kind].total == 16
    assert len(lines) == 1 and "z n/a" in lines[0]


def test_phase_gauss_tiny():
    lines = []
    out = cs.phase_gauss(matrices=("data/H.txt",), bsz=8, rounds=1,
                         reps=1, interpret=True, log=lines.append)
    assert "bit-identical on 8 lanes" in lines[0]
    assert all(t > 0 for t in out["data/H.txt"])


def test_phase_agc_backends_tiny():
    out = cs.phase_agc_backends(matrix="data/H.txt", trials=8,
                                backends=("xla", "xla"),
                                decoder_kw={"max_rows": 64, "max_rounds": 3},
                                log=lambda *a: None)
    assert out["xla"].total == 8


def test_check_result_enforces_z_bar():
    from ldpc_tpu.harness.experiment import ExperimentResult
    res = ExperimentResult(total=10_000, correct=10_000, time_sec=1.0)
    with pytest.raises(AssertionError, match=r"\|z\|"):
        cs.check_result("BP", res, 10_000, "optimalH", "BP", -3.0, 0.0,
                        log=lambda *a: None)
    with pytest.raises(AssertionError, match="counted"):
        cs.check_result("BP", res, 20_000, None, "BP", -3.0, 0.0,
                        log=lambda *a: None)
