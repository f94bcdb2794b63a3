"""Scaling-efficiency measurement: decode throughput at 1 device vs the full
mesh (cw/s at 1 device / 1 host / N hosts).

On a multi-host system, run one process per host with ``jax.distributed``
initialized (see ldpc_tpu.parallel.distributed; ``--auto-distributed``
lets JAX discover the cluster); on a single host this measures 1 device
vs all local devices. Under
``JAX_PLATFORMS=cpu`` with ``jax_num_cpu_devices=N`` it exercises the same
sharded program on the virtual mesh (functional check, not a perf claim).

Run:  python -m ldpc_tpu.apps.scaling_bench --trials 65536
"""
from __future__ import annotations

import argparse
import json

import jax
import numpy as np

from ..channel.awgn import gen_random_codewords
from ..codes.gf2 import gf2_nullspace
from ..codes.io import read_pcm
from ..decoders.bp import BPDecoder
from ..harness.experiment import run_experiment
from ..parallel.mesh import make_trial_mesh
from ..parallel.distributed import initialize_distributed


def measure(dec, h, cw, snr, key, batch, sharding=None):
    res = run_experiment(dec, h, cw, snr, key, batch_size=batch,
                         sharding=sharding)
    return res.throughput


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matrix", default="data/optimalH.txt")
    p.add_argument("--trials", type=int, default=65536)
    p.add_argument("--snr", type=float, default=-3.0)
    p.add_argument("--batch-per-device", type=int, default=4096)
    p.add_argument("--bp-iters", type=int, default=50)
    p.add_argument("--layout", default="auto",
                   help="bp layout; auto takes the platform policy's")
    p.add_argument("--auto-distributed", action="store_true",
                   help="join a multi-host cluster that JAX discovers")
    args = p.parse_args(argv)

    initialize_distributed(auto=args.auto_distributed)
    devices = jax.devices()
    n_dev = len(devices)

    h = read_pcm(args.matrix)
    g, _ = gf2_nullspace(h)
    key = jax.random.PRNGKey(0)
    cw = np.asarray(gen_random_codewords(key, g, args.trials))
    dec = BPDecoder(h, max_iter=args.bp_iters, layout=args.layout)

    # single device
    one = make_trial_mesh(devices[:1])
    thr1 = measure(dec, h, cw, args.snr, key, args.batch_per_device, one)

    out = {"devices": n_dev, "processes": jax.process_count(),
           "layout": dec.layout, "throughput_1dev": round(thr1, 1)}
    if n_dev > 1:
        full = make_trial_mesh(devices)
        thr_n = measure(dec, h, cw, args.snr, key,
                        args.batch_per_device * n_dev, full)
        out["throughput_ndev"] = round(thr_n, 1)
        out["scaling_efficiency"] = round(thr_n / (thr1 * n_dev), 4)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
