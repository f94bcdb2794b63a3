"""Before/after FER measurement for the matrix-optimization run.

The reference's headline optimization artifact is a QP-ADMM FER drop from
its starting matrix to its optimized one (optimize_H.cpp:88-135, notebook
cells 6-7: H05 0.3380 -> optimalH 0.2751 at SNR=-3). Our population-parallel
run (`apps/optimize_h.py`, defaults: seed=239, random 8x14/z=20 QC init)
checkpoints to data/optimalH_search.txt + data/optimize_state.json. This
script reads the run's *initial* matrix from the state file (persisted at
run start since round 4; falls back to re-deriving it from the seed with a
warning for legacy states), measures initial vs optimized FER at the
evaluation config (QP-ADMM alpha=1.95 mu=0.5, 1000 iters, SNR=-3) with a
10k-trial budget and shared noise, and writes
reports/optimize_before_after.json.

Run: python scripts/opt_before_after.py [trials]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from ldpc_tpu.apps.optimize_h import PopulationEvaluator
from ldpc_tpu.codes.io import read_pcm
from ldpc_tpu.codes.qc import QCMatrix
from ldpc_tpu.config import OptimizeConfig


def main():
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    cfg = OptimizeConfig()
    with open("data/optimize_state.json") as f:
        st = json.load(f)
    gen = st["generation"]
    if "initial" in st and "--seed-init" not in sys.argv:
        init = QCMatrix(cfg.block_size,
                        np.array(st["initial"]["present"], bool),
                        np.array(st["initial"]["shifts"],
                                 np.int64)).to_dense()
    else:
        # --seed-init: force the seed re-derivation — correct for this
        # repo's continuous run, whose lineage began (round 3) as the
        # seed-239 random init before the state file tracked "initial"
        print("WARNING: legacy state without the initial matrix; "
              "re-deriving from OptimizeConfig defaults (wrong if the run "
              "used --init-matrix or a different seed)", file=sys.stderr)
        rng = np.random.default_rng(cfg.seed)
        init = QCMatrix.random(rng, cfg.block_size, cfg.block_rows,
                               cfg.block_cols).to_dense()
    opt = read_pcm("data/optimalH_search.txt")

    key = jax.random.PRNGKey(cfg.seed)
    ev = PopulationEvaluator(cfg, cfg.block_cols * cfg.block_size)
    # one evaluate() call = shared codeword/noise streams for all matrices;
    # reference optimalH and H05 included for calibrated context (the same
    # evaluator reproduces the reference's committed 0.2751 for optimalH
    # under the OPTIMAL config)
    ref_opt = read_pcm("data/optimalH.txt")
    h05 = read_pcm("data/H05.txt")
    mats = [init, opt, ref_opt, h05]
    fers = ev.evaluate(mats, key, trials)
    from ldpc_tpu.config import OptimizeConfig as _OC
    cfg_rep = _OC(admm_alpha=1.2, admm_mu=0.55, admm_max_iter=10000)
    ev_rep = PopulationEvaluator(cfg_rep, cfg.block_cols * cfg.block_size)
    fers_rep = ev_rep.evaluate(mats, key, trials)
    out = dict(trials=trials, snr=cfg.snr,
               proposals_evaluated=gen,
               objective_config=dict(alpha=cfg.admm_alpha, mu=cfg.admm_mu,
                                     admm_iters=cfg.admm_max_iter),
               fer_initial=float(fers[0]), fer_optimized=float(fers[1]),
               fer_reference_optimalH=float(fers[2]),
               fer_H05=float(fers[3]),
               improvement=float(fers[0] - fers[1]),
               report_config=dict(alpha=1.2, mu=0.55, admm_iters=10000),
               report_fer_initial=float(fers_rep[0]),
               report_fer_optimized=float(fers_rep[1]),
               report_fer_reference_optimalH=float(fers_rep[2]),
               report_fer_H05=float(fers_rep[3]))
    os.makedirs("reports", exist_ok=True)
    with open("reports/optimize_before_after.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
