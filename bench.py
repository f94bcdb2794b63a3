"""Headline benchmark: decoded codewords/s for BP (100 iterations,
sum-product — the reference's exact config, main.cpp:29) on
data/optimalH.txt at SNR=-3 dB, on one CUDA card.

Prints the device (platform, kind, count, and nvidia-smi's card name and
power limit) on the lines before ONE final JSON line:
{"metric", "value", "unit", "vs_baseline", ...extras}. Exits non-zero,
printing no throughput, when the first JAX device is not a GPU.

Baseline: the reference's committed report gives BP 13.08 ms/codeword at
SNR=-3 with 100-iteration early-exit decoding on a CPU thread
(reports/report_opt.csv:6) => 76.4 cw/s/thread, 611 cw/s for the 8-thread
harness (main.cpp:23). vs_baseline compares one card's throughput against
the full 8-thread reference aggregate. A 50-iteration variant is reported
as an extra; early exit makes the difference small (frames at this SNR
average 55.75 iterations with the mxu layout on an H100, see PERF.md).
"""
from __future__ import annotations

import json

import numpy as np


def main():
    import jax

    from ldpc_tpu.channel.awgn import gen_random_codewords
    from ldpc_tpu.codes.gf2 import gf2_nullspace
    from ldpc_tpu.codes.io import read_pcm
    from ldpc_tpu.decoders.bp import BPDecoder
    from ldpc_tpu.harness.experiment import run_experiment
    from ldpc_tpu.utils.profiling import card_query, require_gpu

    devices = require_gpu()
    dev = devices[0]
    print(f"platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}")
    print(f"card: {card_query()}")

    h = read_pcm("data/optimalH.txt")
    g, _ = gf2_nullspace(h)
    key = jax.random.PRNGKey(239_239_239)
    cw_key, noise_key = jax.random.split(key)

    snr = -3.0
    trials = 65536
    batch = 8192
    codewords = np.asarray(gen_random_codewords(cw_key, g, trials))

    dec = BPDecoder(h, max_iter=100)
    res = run_experiment(dec, h, codewords, snr, noise_key, batch_size=batch)

    dec50 = BPDecoder(h, max_iter=50)
    res50 = run_experiment(dec50, h, codewords, snr, noise_key,
                           batch_size=batch)

    throughput = res.throughput
    baseline_cws = 611.0  # 8-thread reference aggregate at SNR=-3 (see above)

    out = {
        "metric": "BP-100it decoded codewords/s/card (optimalH, SNR=-3dB)",
        "value": round(throughput, 1),
        "unit": "codewords/s/card",
        "vs_baseline": round(throughput / baseline_cws, 2),
        "extra": {
            "fer_100it": round(res.fer, 4),
            "fer_ref_100it": 0.4860,   # reports/report_opt.csv:6
            "avg_iterations": round(res.sum_iterations / res.total, 2),
            "cws_50it": round(res50.throughput, 1),
            "fer_50it": round(res50.fer, 4),
            "trials": trials,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(devices)},
            "layout": dec.layout,
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
