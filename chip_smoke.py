"""Smoke run of the main path on one CUDA card, in one process.

Phases:

0. The device. The first JAX device must be a GPU, else the script exits
   non-zero. Prints its kind and count, nvidia-smi's card name and power
   limit, and whether the native host library loaded.
1. BP through ``harness.run_experiment`` at bench.py's configuration
   (optimalH, −3 dB, 100 iterations, sum-product, batch 8192, 65,536
   trials), once per layout (``edge`` and ``mxu``): throughput, FER with
   its z against the reference golden (|z| < 3.5), average iterations,
   compile seconds and peak device memory.
2. QP-ADMM, ALP and AGC-ALP through ``apps.benchmark.run_sweep`` at −3 dB,
   each at its default batch, with the same printout and bar.
3. The Triton GF(2) elimination against the XLA elimination, bit for bit,
   on LP points that AGC-ALP reaches at −3 dB on optimalH and H05 (B=128),
   both timed; then AGC-ALP end to end with each elimination backend,
   whose counters must agree exactly.

Any failed phase exits non-zero. The last line of standard output is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

``--four-cards`` runs, on four cards and instead of phases 1-3, the paths
users reach with more than one device, each against the same work on one
card with the same per-device batch: the sharded batched harness (BP), the
sharded streaming harness (QP-ADMM) and the sharded PopulationEvaluator.
Their counters must match exactly.

Run:  python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import ldpc_tpu  # noqa: F401  (compile cache; fails outside a checkout)

import jax
import jax.numpy as jnp

from ldpc_tpu.channel.awgn import channel_llr, gen_random_codewords
from ldpc_tpu.codes.gf2 import gf2_nullspace
from ldpc_tpu.codes.io import read_pcm
from ldpc_tpu.harness.reference_data import Z_BOUND, ref_fer, z_score
from ldpc_tpu.utils.profiling import (CompileClock, card_query, peak_bytes,
                                      require_gpu)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "smoke")   # gitignored
SEED = 239_239_239
# Phase 2 trial counts: several default batches each, sized so the whole
# script stays far inside its 1200 s limit on one H100.
SWEEP_TRIALS = {"qp-admm": 8192, "alp": 2048, "agc-alp": 1024}
COUNTERS = ("total", "correct", "pseudo", "sum_hamming", "sum_hamming_ok",
            "sum_hamming_wrong", "sum_iterations", "sum_dropped")


def _path(rel: str) -> str:
    return os.path.join(ROOT, rel)


def _code(matrix: str):
    h = read_pcm(_path(matrix))
    g, ok = gf2_nullspace(h)
    if not ok:
        raise ValueError(f"{matrix} is singular")
    return h, g


def _golden_name(matrix: str) -> str | None:
    stem = os.path.splitext(os.path.basename(matrix))[0]
    return stem if stem in ("optimalH", "H05") else None


def check_result(name: str, res, trials: int, golden: str | None,
                 method: str, snr: float, compile_s: float, log=print):
    """Print one decoder run and hold it to the reference: every trial
    counted, a finite rate, and |z| < Z_BOUND against the golden FER
    (when the code has one). Returns z (None without a golden)."""
    if res.total != trials:
        raise AssertionError(f"{name}: counted {res.total} of {trials}")
    if not np.isfinite(res.throughput) or res.throughput <= 0:
        raise AssertionError(f"{name}: throughput {res.throughput}")
    z = None
    if golden is not None:
        ref = ref_fer(golden, method, snr)
        z = z_score(res.fer, res.total, ref)
    peak = peak_bytes(jax.devices()[0])
    log(f"{name}: {res.throughput:.1f} cw/s  FER {res.fer:.5f} "
        f"({res.total - res.correct}/{res.total})  "
        f"z {'n/a' if z is None else f'{z:+.2f}'}  "
        f"avg iters {res.sum_iterations / res.total:.2f}  "
        f"compile {compile_s:.1f} s  timed {res.time_sec:.3f} s  "
        f"peak {'n/a' if peak is None else f'{peak / 2**20:.0f} MiB'}")
    if z is not None and not abs(z) < Z_BOUND:
        raise AssertionError(f"{name}: |z| = {abs(z):.2f} >= {Z_BOUND}")
    return z


def phase_device(expect_count: int | None = None, log=print):
    """Phase 0. Returns the device summary of the final JSON line."""
    devices = require_gpu()
    dev = devices[0]
    if expect_count is not None and len(devices) != expect_count:
        raise RuntimeError(f"need {expect_count} cards, JAX sees "
                           f"{len(devices)}")
    from ldpc_tpu import _native
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)}")
    log(f"card (nvidia-smi name, power.limit): {card_query()}")
    log(f"native host library: "
        f"{'loaded' if _native.load() is not None else 'not loaded'}")
    log(f"jax {jax.__version__}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def phase_bp(matrix: str = "data/optimalH.txt", trials: int = 65536,
             batch: int = 8192, snr: float = -3.0, max_iter: int = 100,
             layouts=("edge", "mxu"), log=print) -> dict:
    """Phase 1. Returns {layout: ExperimentResult}."""
    from ldpc_tpu.config import platform_choice
    from ldpc_tpu.decoders.bp import BPDecoder
    from ldpc_tpu.harness.experiment import run_experiment

    h, g = _code(matrix)
    cw_key, noise_key = jax.random.split(jax.random.PRNGKey(SEED))
    cw = np.asarray(gen_random_codewords(cw_key, g, trials))
    default = platform_choice("bp_layout")
    out = {}
    for layout in layouts:
        dec = BPDecoder(h, max_iter=max_iter, layout=layout)
        with CompileClock() as cc:
            res = run_experiment(dec, h, cw, snr, noise_key,
                                 batch_size=batch)
        tag = " (policy default)" if layout == default else ""
        check_result(f"BP-{max_iter} {layout}{tag}", res, trials,
                     _golden_name(matrix), "BP", snr, cc.seconds, log)
        out[layout] = res
    return out


def phase_sweep(kinds=("qp-admm", "alp", "agc-alp"),
                trials=None, matrix: str = "data/optimalH.txt",
                snr: float = -3.0, decoder_cfg=None, log=print) -> dict:
    """Phase 2. ``trials``: {kind: count}; default ``SWEEP_TRIALS``.
    ``decoder_cfg``: a DecoderConfig (default: the reference's). Returns
    {kind: ExperimentResult}."""
    from ldpc_tpu.apps.benchmark import CSV_NAMES, run_sweep
    from ldpc_tpu.config import DecoderConfig, SweepConfig
    from ldpc_tpu.decoders import default_batch

    os.makedirs(OUT_DIR, exist_ok=True)
    out = {}
    for kind in kinds:
        n_trials = (trials or SWEEP_TRIALS)[kind]
        cfg = SweepConfig(matrix=_path(matrix), decoders=(kind,),
                          snrs=(snr,), trials=n_trials, shard=False,
                          report=os.path.join(OUT_DIR, "smoke_report.csv"),
                          extended_report=None,
                          decoder_cfg=decoder_cfg or DecoderConfig())
        with CompileClock() as cc:
            rows = run_sweep(cfg, log=lambda *a, **k: None)
        (_, _, res), = rows
        check_result(f"{CSV_NAMES[kind]} batch {default_batch(kind)}", res,
                     n_trials, _golden_name(matrix), CSV_NAMES[kind], snr,
                     cc.seconds, log)
        out[kind] = res
    return out


def _lp_points(h, g, bsz: int, snr: float, rounds: int):
    """LP solutions x (B, n) after ``rounds`` AGC-ALP cut rounds at
    ``snr``: the points at which AGC-ALP eliminates."""
    from ldpc_tpu.decoders.agc_alp import AGCALPDecoder

    key = jax.random.PRNGKey(SEED)
    cw = np.asarray(gen_random_codewords(key, g, bsz))
    _, llrs = channel_llr(jax.random.fold_in(key, 1), cw, snr)
    dec = AGCALPDecoder(h, max_rounds=rounds, gauss_backend="xla")
    st = dec._init_state(jnp.asarray(llrs))
    round_fn = jax.jit(dec._round_body)
    for _ in range(rounds):
        st = round_fn(st)
    return st["x"]


def _time(fn, *args, reps: int) -> float:
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase_gauss(matrices=("data/optimalH.txt", "data/H05.txt"),
                bsz: int = 128, snr: float = -3.0, rounds: int = 2,
                reps: int = 20, interpret: bool = False, log=print) -> dict:
    """Phase 3a: the Triton elimination against the XLA one, bit for bit,
    on every lane, plus the active mask; both timed. ``interpret`` runs
    the kernel through the Pallas interpreter (for tests without a card).
    Returns {matrix: (triton seconds, xla seconds)}."""
    from ldpc_tpu.ops.gf2_gauss import (fractional_column_order,
                                        gf2_eliminate_ordered)
    from ldpc_tpu.ops.pallas.gauss_kernel import gf2_eliminate_triton

    tri = jax.jit(lambda hp, act: gf2_eliminate_triton(
        hp, act, interpret=interpret))
    xla = jax.jit(gf2_eliminate_ordered)
    out = {}
    for matrix in matrices:
        h, g = _code(matrix)
        x = _lp_points(h, g, bsz, snr, rounds)
        p = fractional_column_order(x)
        h_perm = jnp.take(jnp.asarray(h), p, axis=1).transpose(1, 0, 2)
        ones = jnp.ones((bsz,), bool)
        ref = np.asarray(xla(h_perm))
        got = np.asarray(tri(h_perm, ones))
        bad = int(np.sum(np.any(got != ref, axis=(1, 2))))
        if bad:
            raise AssertionError(f"{matrix}: {bad}/{bsz} lanes differ")
        half = jnp.arange(bsz) % 2 == 0
        got_half = np.asarray(tri(h_perm, half))
        if not (np.array_equal(got_half[::2], ref[::2]) and
                np.array_equal(got_half[1::2], np.asarray(h_perm)[1::2])):
            raise AssertionError(f"{matrix}: active mask not honoured")
        frac = float(jnp.mean(jnp.sum((x > 1e-8) & (x < 1 - 1e-8),
                                      axis=1)))
        t_tri = _time(tri, h_perm, ones, reps=reps)
        t_xla = _time(xla, h_perm, reps=reps)
        log(f"gauss {os.path.basename(matrix)} B={bsz}: bit-identical on "
            f"{bsz} lanes (mean {frac:.1f} fractional coordinates); "
            f"triton {t_tri * 1e3:.3f} ms  xla {t_xla * 1e3:.3f} ms  "
            f"({t_xla / t_tri:.1f}x)")
        out[matrix] = (t_tri, t_xla)
    return out


def phase_agc_backends(matrix: str = "data/optimalH.txt", trials: int = 512,
                       snr: float = -3.0, backends=("triton", "xla"),
                       decoder_kw=None, log=print) -> dict:
    """Phase 3b: AGC-ALP end to end with each elimination backend on the
    same trials; the eliminations are bit-identical, so the counters must
    be too. ``decoder_kw``: extra AGCALPDecoder arguments (default: the
    reference's settings). Returns {backend: ExperimentResult}."""
    from ldpc_tpu.decoders import default_batch
    from ldpc_tpu.decoders.agc_alp import AGCALPDecoder
    from ldpc_tpu.harness.experiment import run_experiment

    h, g = _code(matrix)
    cw_key, noise_key = jax.random.split(jax.random.PRNGKey(SEED))
    cw = np.asarray(gen_random_codewords(cw_key, g, trials))
    out = {}
    for backend in backends:
        dec = AGCALPDecoder(h, gauss_backend=backend, **(decoder_kw or {}))
        with CompileClock() as cc:
            res = run_experiment(dec, h, cw, snr, noise_key,
                                 batch_size=default_batch("agc-alp"))
        check_result(f"AGC-ALP gauss={backend}", res, trials,
                     _golden_name(matrix), "AGC-ALP", snr, cc.seconds, log)
        out[backend] = res
    first = out[backends[0]]
    for backend in backends[1:]:
        _same_counters(f"AGC-ALP {backends[0]} vs {backend}", first,
                       out[backend])
    return out


def _counter_diff(a, b) -> dict:
    return {k: (getattr(a, k), getattr(b, k)) for k in COUNTERS
            if getattr(a, k) != getattr(b, k)}


def _same_counters(name: str, a, b):
    diff = _counter_diff(a, b)
    if diff:
        raise AssertionError(f"{name}: counters differ {diff}")


def _four_bp(devices, h, g, snr, batch, iters, log):
    """Sharded batched harness (BP): the same trials on one device at
    ``batch`` and on all devices at ``len(devices) * batch``."""
    from ldpc_tpu.decoders.bp import BPDecoder
    from ldpc_tpu.harness.experiment import run_experiment
    from ldpc_tpu.parallel.mesh import make_trial_mesh

    n_dev = len(devices)
    cw_key, noise_key = jax.random.split(jax.random.PRNGKey(SEED))
    trials = 2 * n_dev * batch
    cw = np.asarray(gen_random_codewords(cw_key, g, trials))
    dec = BPDecoder(h, max_iter=iters)
    r1 = run_experiment(dec, h, cw, snr, noise_key, batch_size=batch,
                        sharding=make_trial_mesh(devices[:1]))
    rn = run_experiment(dec, h, cw, snr, noise_key,
                        batch_size=n_dev * batch,
                        sharding=make_trial_mesh(devices))
    diff = _counter_diff(r1, rn)
    log(f"BP ({dec.layout}) batched harness: {trials} trials, counters "
        f"{f'DIFFER {diff}' if diff else 'equal'} (correct {rn.correct}); "
        f"1 device {r1.throughput:.1f} cw/s, {n_dev} devices "
        f"{rn.throughput:.1f} cw/s")
    return r1, rn, not diff


def _four_admm(devices, h, g, snr, batch, iters, trials, log):
    """Sharded streaming harness (QP-ADMM), as :func:`_four_bp`."""
    from ldpc_tpu.decoders.admm import QPADMMDecoder
    from ldpc_tpu.harness.experiment import run_streaming_experiment
    from ldpc_tpu.parallel.mesh import make_trial_mesh

    n_dev = len(devices)
    cw_key, noise_key = jax.random.split(jax.random.PRNGKey(SEED))
    cw = np.asarray(gen_random_codewords(cw_key, g, trials))
    admm = QPADMMDecoder(h, alpha=1.2, mu=0.55, max_iter=iters)
    r1 = run_streaming_experiment(admm, h, cw, snr, noise_key,
                                  batch_size=batch,
                                  sharding=make_trial_mesh(devices[:1]))
    rn = run_streaming_experiment(admm, h, cw, snr, noise_key,
                                  batch_size=n_dev * batch,
                                  sharding=make_trial_mesh(devices))
    diff = _counter_diff(r1, rn)
    log(f"QP-ADMM streaming harness: {trials} trials, counters "
        f"{f'DIFFER {diff}' if diff else 'equal'} (correct {rn.correct}); "
        f"1 device {r1.throughput:.1f} cw/s, {n_dev} devices "
        f"{rn.throughput:.1f} cw/s")
    return r1, rn, not diff


def _four_population(devices, trials, iters, block, log):
    """Sharded PopulationEvaluator, one candidate per device, against the
    same candidate set on one device. (The set fixes the padded table
    capacities, so one candidate evaluated alone is a different program.)"""
    from ldpc_tpu.apps.optimize_h import PopulationEvaluator
    from ldpc_tpu.codes.qc import QCMatrix
    from ldpc_tpu.config import OptimizeConfig
    from ldpc_tpu.parallel.mesh import make_trial_mesh

    n_dev = len(devices)
    size, rows, cols = block
    ocfg = OptimizeConfig(block_size=size, block_rows=rows, block_cols=cols,
                          trials=trials, admm_max_iter=iters,
                          population=n_dev)
    rng = np.random.default_rng(SEED)
    cands = [QCMatrix.random(rng, size, rows, cols).to_dense()
             for _ in range(n_dev)]
    key = jax.random.PRNGKey(SEED)
    ev1 = PopulationEvaluator(ocfg, cols * size,
                              make_trial_mesh(devices[:1], axis_name="pop"))
    evn = PopulationEvaluator(ocfg, cols * size,
                              make_trial_mesh(devices, axis_name="pop"))
    t0 = time.perf_counter()
    f1 = ev1.evaluate(cands, key, trials)
    t1 = time.perf_counter()
    fn = evn.evaluate(cands, key, trials)
    t2 = time.perf_counter()
    same = bool(np.array_equal(f1, fn))
    log(f"PopulationEvaluator: {n_dev} candidates x {trials} trials, FERs "
        f"{'equal' if same else 'DIFFER'} {f1.tolist()} vs {fn.tolist()}; "
        f"1 device {t1 - t0:.1f} s, sharded "
        f"{t2 - t1:.1f} s (compile included)")
    return f1, fn, same


def phase_four_cards(devices, matrix: str = "data/optimalH.txt",
                     snr: float = -3.0, bp_batch: int = 8192,
                     bp_iters: int = 100, admm_batch: int = 1024,
                     admm_iters: int = 10000, admm_trials: int = 8192,
                     pop_trials: int = 1000, pop_iters: int = 1000,
                     block: tuple = (20, 8, 14), log=print) -> dict:
    """The sharded paths on ``devices`` against the same work on
    ``devices[0]`` alone, at equal per-device batch; counters must match
    exactly; every path runs before a mismatch is raised. ``block``: the
    QC (block size, rows, cols) of the population's random candidates.
    Returns {path: (one-device result, all-device result)}."""
    h, g = _code(matrix)
    runs = {
        "bp": _four_bp(devices, h, g, snr, bp_batch, bp_iters, log),
        "qp-admm": _four_admm(devices, h, g, snr, admm_batch, admm_iters,
                              admm_trials, log),
        "population": _four_population(devices, pop_trials, pop_iters,
                                       block, log),
    }
    differ = [path for path, (_, _, same) in runs.items() if not same]
    if differ:
        raise AssertionError(f"sharded paths differ from one device: "
                             f"{differ}")
    return {path: (r1, rn) for path, (r1, rn, _) in runs.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded paths, on four cards")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    device = phase_device(expect_count=4 if args.four_cards else None)
    if args.four_cards:
        phases = [lambda: phase_four_cards(jax.devices())]
    else:
        phases = [phase_bp, phase_sweep, phase_gauss, phase_agc_backends]
    for phase in phases:
        t = time.perf_counter()
        phase()
        print(f"  ({time.perf_counter() - t:.1f} s wall)")
    print(f"total {time.perf_counter() - t0:.1f} s wall")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
