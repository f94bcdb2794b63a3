"""Smoke tests for the analysis-plots app (notebooks/plots.ipynb equivalent)
and the FER-parity validate app, plus a large-code (H02, 520x640) decode —
surfaces previously only exercised by hand on an accelerator."""
import csv
import os

import numpy as np
import pytest

from ldpc_tpu.codes.gf2 import gf2_nullspace, is_codeword
from ldpc_tpu.codes.io import read_pcm


def repo_path(*parts):
    return os.path.join(os.path.dirname(__file__), "..", *parts)


def _write_report(path, methods=("BP", "QP-ADMM"), snrs=(-3.0, -2.0, -1.0)):
    with open(path, "w") as f:
        f.write("Method,SNR,Sigma,FER,Time,"
                "AvgHamming,AvgHammingCorrect,AvgHammingWrong\n")
        for mi, m in enumerate(methods):
            for si, s in enumerate(snrs):
                fer = 0.5 / (mi + si + 1.0)
                f.write(f"{m},{s},1.0,{fer},0.001,30.0,28.0,35.0\n")


def test_plots_app(tmp_path):
    from ldpc_tpu.apps import plots
    rep_a = str(tmp_path / "a.csv")
    rep_b = str(tmp_path / "b.csv")
    _write_report(rep_a)
    _write_report(rep_b, methods=("BP",))
    out = str(tmp_path / "plots")
    plots.main([rep_a, "--compare", rep_b, "--out", out, "--fmt", "png"])
    for name in ("fer.png", "time.png", "hamming.png", "fer_compare.png"):
        p = os.path.join(out, name)
        assert os.path.exists(p) and os.path.getsize(p) > 0, name

    data = plots.read_report(rep_a)
    assert set(data) == {"BP", "QP-ADMM"}
    # rows come back sorted by SNR with float fields
    assert [r["SNR"] for r in data["BP"]] == [-3.0, -2.0, -1.0]
    assert isinstance(data["BP"][0]["FER"], float)


def test_validate_app_smoke(tmp_path):
    """End-to-end validate run at a tiny trial budget: exercises the golden
    transcription lookup, z-scoring, reference-format CSV, and the markdown
    parity table. Verdicts are not asserted (16 trials has no power)."""
    from ldpc_tpu.apps.validate import validate
    report = str(tmp_path / "rep.csv")
    table = str(tmp_path / "parity.md")
    rows = validate(matrix="optimalH", decoders=("bp",), batch_size=16,
                    max_trials=16, report=report, table_out=table,
                    log=lambda *a, **k: None)
    assert len(rows) == 11  # full SNR grid
    assert all(r["n"] == 16 for r in rows)
    assert all(np.isfinite(r["z"]) for r in rows)
    with open(report) as f:
        csv_rows = list(csv.DictReader(f))
    assert len(csv_rows) == 11 and csv_rows[0]["Method"] == "BP"
    text = open(table).read()
    assert "| BP |" in text and text.count("\n") >= 13


def test_h02_large_code_bp():
    """The 520x640 H02 code (the reference's largest committed asset, unused
    there): parse, nullspace consistency with the committed G02, and a
    batched BP decode at high SNR recovering transmitted codewords."""
    import jax
    from ldpc_tpu.channel.awgn import gen_random_codewords, transmit
    from ldpc_tpu.decoders.bp import BPDecoder

    h = read_pcm(repo_path("data", "H02.txt"))
    g_ref = read_pcm(repo_path("data", "G02.txt"))
    assert h.shape == (520, 640) and g_ref.shape == (120, 640)
    # every committed generator row is a codeword of H02
    assert bool(np.all(np.asarray(is_codeword(h, g_ref))))

    g, ok = gf2_nullspace(h)
    assert ok and bool(np.all(np.asarray(is_codeword(h, g))))

    key = jax.random.PRNGKey(7)
    cw = np.asarray(gen_random_codewords(key, g_ref, 8))
    llrs = transmit(jax.random.PRNGKey(8), cw, snr=3.0)
    dec = BPDecoder(h, max_iter=30)
    res = dec.decode_batch(llrs)
    dec_ok = np.asarray(res.success)
    bits = np.asarray(res.bits)
    # at 3 dB on a rate-0.1875 code essentially every frame decodes
    assert dec_ok.mean() >= 0.75
    assert np.all(bits[dec_ok] == cw[dec_ok])
