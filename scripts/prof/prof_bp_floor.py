"""BP error-floor reproduction: the reference's high-SNR floor is a
phi-saturation numerics artifact, not a trapping-set floor.

The reference computes phi(x) = -log(tanh(x/2)) on unclamped long doubles
(``algo/bp.h:34``). At high SNR the check-node magnitudes saturate:
phi(large) rounds to exactly 0, and the outgoing magnitude phi(sum - mag)
then evaluates phi(0) = +inf. A variable node receiving conflicting
infinities computes inf - inf = NaN in its extrinsic sums; the NaN
propagates and the frame can never pass the syndrome check — a
numerics-induced frame error. Our production phi clamps its argument to
[1e-9, 31] (``ldpc_tpu/ops/phi.py``), which removes the floor.

This script runs the SAME flooding sum-product decode (the production
row-layout check update, ``decoders/bp.py:_check_update_rowlayout``) on the
SAME channel draws twice — once with the clamped production phi, once with
an unclamped float64 phi — and reports FER plus a per-frame NaN diagnosis
proving every extra failure is a NaN frame.

Measured (optimalH, 100 iters, committed run in
``logs/bp_floor_repro.log``): clamped FER = 0.000; unclamped f64 adds a
small NaN floor (~0.05% at 0 dB, ~0.15% at -1 dB), 100% of the extra
failures carrying NaN messages. NOTE: this phi-saturation path is the
*secondary* effect; the reference's published ~3.3% flat floor is a data
race in its threaded harness — see ``prof_bp_floor_race.sh`` and
VALIDATION.md for the full root-cause chain.

Usage:  JAX_PLATFORMS=cpu python scripts/prof/prof_bp_floor.py
        [--snr 0.0] [--trials 2000] [--iters 100]
(f64 messages; run on the CPU, where f64 is native.)
"""
from __future__ import annotations

import argparse
import os
import sys

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from ldpc_tpu.channel.awgn import (bpsk, gen_random_codewords,  # noqa: E402
                                   llr_variance)
from ldpc_tpu.codes.gf2 import gf2_nullspace  # noqa: E402
from ldpc_tpu.codes.io import read_pcm  # noqa: E402
from ldpc_tpu.decoders.bp import _check_update_rowlayout  # noqa: E402
from ldpc_tpu.ops.phi import phi  # noqa: E402


def phi_unclamped(x):
    """The reference's phi: no argument clamp (algo/bp.h:34). In f64,
    tanh(x/2) rounds to 1.0 for x >~ 38 -> phi = 0 exactly; phi(0) = +inf."""
    return -jnp.log(jnp.tanh(0.5 * x))


def decode_batch(h_mask, llrs, iters: int, phi_fn):
    """Flooding sum-product, dense (B, m, n) layout, f64, with the
    reference's per-iteration early exit (``algo/bp.h:191-196``): a frame
    freezes at its FIRST syndrome success. Early exit is essential to the
    floor's magnitude — frames that converge before the messages saturate
    escape the NaN; only still-iterating frames hit phi(0) = inf."""
    h_i = h_mask.astype(jnp.int32)

    def syndrome_ok(bits):
        return jnp.all(jnp.einsum("mn,bn->bm", h_i, bits) % 2 == 0, axis=-1)

    mask = h_mask[None]                                   # (1, m, n)
    v2c0 = jnp.where(mask, llrs[:, None, :], 0.0)
    bits0 = (llrs <= 0.0).astype(jnp.int32)

    def body(_, state):
        v2c, bits, done = state
        c2v = _check_update_rowlayout(v2c, mask, "sumprod", 0.75,
                                      phi_fn=phi_fn)
        total = llrs + jnp.sum(c2v, axis=1)
        v2c_next = jnp.where(mask, total[:, None, :] - c2v, 0.0)
        bits_new = (total <= 0.0).astype(jnp.int32)
        ok = syndrome_ok(bits_new)
        bits = jnp.where(done[:, None], bits, bits_new)
        v2c = jnp.where(done[:, None, None], v2c, v2c_next)
        done = done | ok
        return v2c, bits, done

    v2c, bits, done = jax.lax.fori_loop(
        0, iters, body, (v2c0, bits0, jnp.zeros(llrs.shape[:1], bool)))
    has_nan = jnp.any(jnp.isnan(v2c), axis=(1, 2))
    return bits.astype(jnp.uint8), done, has_nan


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="data/optimalH.txt")
    p.add_argument("--snr", type=float, default=0.0)
    p.add_argument("--trials", type=int, default=2000)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--batch", type=int, default=250)
    args = p.parse_args()

    h = read_pcm(args.matrix)
    g, ok = gf2_nullspace(h)
    assert ok
    h_mask = jnp.asarray(h.astype(bool))
    key = jax.random.PRNGKey(239)
    cw = np.asarray(gen_random_codewords(key, g, args.trials))
    sigma = float(np.sqrt(float(llr_variance(args.snr))))
    inv_var = 2.0 / float(llr_variance(args.snr))

    run = jax.jit(decode_batch, static_argnums=(2, 3))
    stats = {"clamped": [0, 0, 0], "unclamped": [0, 0, 0]}  # fail, nan, tot
    for s0 in range(0, args.trials, args.batch):
        cwb = cw[s0:s0 + args.batch]
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(s0, s0 + cwb.shape[0]))
        noise = jax.vmap(lambda k: jax.random.normal(
            k, (cw.shape[1],), jnp.float64))(keys)
        y = bpsk(jnp.asarray(cwb)).astype(jnp.float64) + sigma * noise
        llrs = inv_var * y
        for name, fn in (("clamped", phi), ("unclamped", phi_unclamped)):
            bits, ok_b, has_nan = run(h_mask, llrs, args.iters, fn)
            correct = np.asarray(ok_b) & np.all(
                np.asarray(bits) == cwb, axis=-1)
            fails = ~correct
            stats[name][0] += int(fails.sum())
            stats[name][1] += int((np.asarray(has_nan) & fails).sum())
            stats[name][2] += cwb.shape[0]
        done = stats["clamped"][2]
        print(f"  {done}/{args.trials}: clamped FER "
              f"{stats['clamped'][0] / done:.4f}, unclamped FER "
              f"{stats['unclamped'][0] / done:.4f}", flush=True)

    print(f"\nSNR={args.snr} dB, {args.trials} trials, {args.iters} iters, "
          f"matrix {args.matrix}")
    for name in ("clamped", "unclamped"):
        fail, nan, tot = stats[name]
        frac = nan / fail if fail else 0.0
        print(f"  {name:10s}: FER = {fail / tot:.4f}  ({fail} failures, "
              f"{nan} with NaN totals = {100 * frac:.0f}% of failures)")
    if stats["unclamped"][0] > stats["clamped"][0]:
        extra = stats["unclamped"][0] - stats["clamped"][0]
        print(f"\nFloor reinstated: removing the phi clamp adds {extra} "
              f"failures; NaN totals confirm the saturation mechanism "
              f"(algo/bp.h:34).")


if __name__ == "__main__":
    main()
