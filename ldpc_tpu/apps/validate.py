"""FER-parity validation sweep vs the reference's golden CSVs.

Runs each decoder over the 11-point SNR grid with a per-point trial budget
sized to the golden FER (see ``reference_data.suggested_trials``), computes
two-proportion z-scores against the transcribed ``reports/report_opt.csv`` /
``reports/report_H05.csv`` curves, and writes (a) a reference-format CSV and
(b) a markdown parity table. Statistical bar: |z| < 3.5 (the RNG streams
differ by construction — mt19937 vs threefry — so bitwise parity is
impossible; see VALIDATION.md).

Run:  python -m ldpc_tpu.apps.validate --decoders alp,agc-alp --matrix optimalH
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np

from ..channel.awgn import gen_random_codewords
from ..codes.gf2 import gf2_nullspace
from ..codes.io import read_pcm
from ..decoders import default_batch, make_decoder
from ..harness.experiment import run_experiment
from ..harness.report import ReportWriter
from ..harness.reference_data import (SNR_GRID, Z_BOUND, ref_fer,
                                      suggested_trials, z_score)

CSV_NAMES = {"bp": "BP", "qp-admm": "QP-ADMM", "alp": "ALP",
             "agc-alp": "AGC-ALP"}


def validate(matrix: str = "optimalH", decoders=("alp", "agc-alp"),
             batch_size: int = 0, seed: int = 239_239_239,
             max_trials: int = 10_000, min_trials: int = 0, report: str = "",
             table_out: str = "", decoder_cfg=None, snrs=None, log=print):
    h = read_pcm(f"data/{matrix}.txt")
    g, ok = gf2_nullspace(h)
    assert ok
    key = jax.random.PRNGKey(seed)
    cw_key, noise_key = jax.random.split(key)

    report = report or f"reports/report_{matrix}_validate.csv"
    unknown = [k for k in decoders if k not in CSV_NAMES]
    if unknown:
        raise SystemExit(f"unknown decoder(s) {unknown}; "
                         f"choose from {sorted(CSV_NAMES)}")
    if matrix == "H05" and decoder_cfg is None:
        # the reference's H05 run is the non-OPTIMAL build, whose QP-ADMM
        # uses alpha=1.95, mu=0.5 (main.cpp:30-34); other decoders identical
        from ..config import DecoderConfig
        decoder_cfg = DecoderConfig(admm_alpha=1.95, admm_mu=0.5)
    rows = []
    # a full-grid run replaces the artifact; an --snrs fill-in appends
    with ReportWriter(report, resume=snrs is not None) as rep:
        for kind in decoders:
            name = CSV_NAMES[kind]
            dec = make_decoder(kind, h, decoder_cfg)
            bs = batch_size or default_batch(kind)
            for snr in (snrs if snrs is not None else SNR_GRID):
                p_ref = ref_fer(matrix, name, snr)
                trials = min(max(suggested_trials(p_ref), min_trials),
                             max_trials)
                cw = np.asarray(gen_random_codewords(cw_key, g, trials))
                # keep the streaming drain-refill path engaged at small
                # trial budgets: run_experiment auto-streams only when
                # trials >= 2*batch, and stragglers hurt most exactly at
                # the high-FER (small-budget) points
                bs_eff = (min(bs, max(1, trials // 2))
                          if hasattr(dec, "stream_init") else bs)
                t0 = time.time()
                res = run_experiment(dec, h, cw, snr, noise_key,
                                     batch_size=bs_eff)
                z = z_score(res.fer, trials, p_ref)
                verdict = ("PASS" if abs(z) < Z_BOUND
                           else ("better" if z < 0 else "FAIL"))
                log(f"{name} snr={snr:+.1f}: fer={res.fer:.4f} "
                    f"ref={p_ref:.4f} z={z:+.2f} {verdict} "
                    f"(n={trials}, {res.throughput:.1f} cw/s, "
                    f"{time.time()-t0:.0f}s)", flush=True)
                rep.write_row(name, snr, res)
                rows.append(dict(method=name, snr=snr, fer=res.fer,
                                 ref=p_ref, z=z, n=trials,
                                 verdict=verdict,
                                 throughput=res.throughput))

    if table_out:
        with open(table_out, "w") as f:
            f.write(f"## Parity table — {matrix} "
                    f"(generated by apps.validate)\n\n")
            f.write("| Method | SNR | ours | reference | n | z | verdict |\n")
            f.write("|---|---:|---:|---:|---:|---:|---|\n")
            for r in rows:
                f.write(f"| {r['method']} | {r['snr']:+.1f} | "
                        f"{r['fer']:.4f} | {r['ref']:.4f} | {r['n']} | "
                        f"{r['z']:+.2f} | {r['verdict']} |\n")
    n_fail = sum(r["verdict"] == "FAIL" for r in rows)
    log(f"validate({matrix}): {len(rows)} points, {n_fail} FAIL")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="optimalH",
                   choices=["optimalH", "H05"])
    p.add_argument("--decoders", default="alp,agc-alp")
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = per-decoder measured optimum (decoders.DEFAULT_BATCH)")
    p.add_argument("--max-trials", type=int, default=10_000)
    p.add_argument("--min-trials", type=int, default=0,
                   help="floor on the per-point trial budget (use 10000 for "
                        "full-power parity runs on fast decoders)")
    p.add_argument("--report", default="")
    p.add_argument("--table-out", default="")
    p.add_argument("--json-out", default="")
    p.add_argument("--snrs", default="",
                   help="comma-separated SNR subset (resume/fill-in); "
                        "use --snrs=-1.0,-0.5 form for negatives")
    a = p.parse_args(argv)
    snrs = tuple(float(s) for s in a.snrs.split(",")) if a.snrs else None
    rows = validate(matrix=a.matrix, decoders=a.decoders.split(","),
                    batch_size=a.batch_size, max_trials=a.max_trials,
                    min_trials=a.min_trials,
                    snrs=snrs, report=a.report, table_out=a.table_out,
                    log=lambda *x, **k: print(*x, file=sys.stderr, **k))
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
