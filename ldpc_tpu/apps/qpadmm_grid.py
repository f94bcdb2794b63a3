"""QP-ADMM (alpha, mu) grid search — the ``make run_qpadmm_params``
equivalent (``qpadmm_params.cpp``).

Batched redesign: the 61x61 grid (``qpadmm_params.cpp:51-58``) is evaluated
by vmapping the traced-parameter QP-ADMM decode over batches of (alpha, mu)
cells on top of the trial batch — one compiled program for the whole sweep.
Cells violating the feasibility precondition ``min(e) * mu > alpha``
(``qp_admm.h:108-114``) are resolved to FER=1.0 on the host without burning
device time (the reference bails per decode call with the all-zero word).

Noise is shared across cells, matching the reference's per-trial determinism
(every cell re-decodes the same transmitted words, ``experiment.h:97``).

Run:  python -m ldpc_tpu.apps.qpadmm_grid --trials 1000
"""
from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..channel.awgn import bpsk, gen_random_codewords, llr_variance
from ..codes.gf2 import gf2_nullspace
from ..codes.io import read_pcm
from ..config import GridSearchConfig, add_dataclass_args, apply_args
from ..decoders.admm import ADMMStructure, QPADMMDecoder, decode_qp_admm


def run_grid(cfg: GridSearchConfig, log=print):
    h = read_pcm(cfg.matrix)
    g, ok = gf2_nullspace(h)
    if not ok:
        raise ValueError("singular matrix")
    log(f"n={h.shape[1]} k={h.shape[0]}", file=sys.stderr)

    key = jax.random.PRNGKey(cfg.seed)
    cw_key, noise_key = jax.random.split(key)
    cw = gen_random_codewords(cw_key, g, cfg.trials)

    # shared channel realization for every grid cell
    sigma = float(np.sqrt(float(llr_variance(cfg.snr))))
    inv_var = float(2.0 / float(llr_variance(cfg.snr)))
    keys = jax.vmap(lambda i: jax.random.fold_in(noise_key, i))(
        jnp.arange(cfg.trials, dtype=jnp.int32))
    noise = jax.vmap(lambda k: jax.random.normal(k, (h.shape[1],),
                                                 jnp.float32))(keys)
    llrs = inv_var * (bpsk(cw) + sigma * noise)
    cw_dev = jnp.asarray(cw)

    structure = ADMMStructure.from_h(h)
    e_min = structure.e_min
    tables = QPADMMDecoder(h, structure=structure).tables

    def cell_fer(alpha, mu):
        res = decode_qp_admm(tables, h.shape[1], llrs, alpha, mu,
                             cfg.admm_max_iter, cfg.admm_eps_stop)
        correct = res.success & jnp.all(res.bits == cw_dev, axis=-1)
        # `correct` in the harness also checks IsCodeword, but bits == cw
        # implies codeword; FER = 1 - correct/total (experiment.h:59)
        return 1.0 - jnp.mean(correct.astype(jnp.float32))

    cells_fn = jax.jit(jax.vmap(cell_fer))

    alphas = np.linspace(cfg.alpha_min, cfg.alpha_max, cfg.alpha_count)
    mus = np.linspace(cfg.mu_min, cfg.mu_max, cfg.mu_count)
    grid = [(a, m) for a in alphas for m in mus]
    feasible = [(a, m) for (a, m) in grid if e_min * m > a]
    log(f"{len(grid)} cells, {len(feasible)} feasible", file=sys.stderr)

    fers = {cell: 1.0 for cell in grid}
    t0 = time.perf_counter()
    best = (2.0, -1.0, -1.0)
    for i in range(0, len(feasible), cfg.batch_cells):
        chunk = feasible[i:i + cfg.batch_cells]
        # pad the final chunk so one program shape serves the sweep
        padded = chunk + [chunk[-1]] * (cfg.batch_cells - len(chunk))
        a_v = jnp.asarray([a for a, _ in padded], jnp.float32)
        m_v = jnp.asarray([m for _, m in padded], jnp.float32)
        out = np.asarray(cells_fn(a_v, m_v))
        for (cell, fer) in zip(chunk, out[: len(chunk)]):
            fers[cell] = float(fer)
            if fer < best[0]:
                best = (float(fer), cell[0], cell[1])
                log(f"new best fer found: {fer:.5f}| alpha={cell[0]:.5f}, "
                    f"mu={cell[1]:.5f}")
    dt = time.perf_counter() - t0

    log("Best parameters:")
    log(f"alpha={best[1]:.5f}")
    log(f"mu={best[2]:.5f}")
    log(f"fer={best[0]:.5f}")
    log(f"({len(feasible)} feasible cells x {cfg.trials} trials in {dt:.1f}s "
        f"= {len(feasible) * cfg.trials / dt:.0f} decodes/s)", file=sys.stderr)
    if cfg.grid_out:
        with open(cfg.grid_out, "w") as f:
            f.write("Alpha,Mu,FER\n")
            for (a, m), fer in sorted(fers.items()):
                f.write(f"{a:.6f},{m:.6f},{fer:.6f}\n")
        log(f"grid written to {cfg.grid_out}", file=sys.stderr)
    return fers, best


def main(argv=None):
    cfg = GridSearchConfig()
    p = argparse.ArgumentParser(description=__doc__)
    add_dataclass_args(p, cfg)
    apply_args(cfg, p.parse_args(argv))
    run_grid(cfg)


if __name__ == "__main__":
    main()
