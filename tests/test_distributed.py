"""True multi-process distributed test: two CPU processes joined via
jax.distributed, each holding 2 local virtual devices, run the sharded
experiment step over a global 4-device mesh; per-process partial counters
must psum to the single-process ground truth (SURVEY.md §4: multi-host
logic testable without a cluster)."""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    coord = sys.argv[1]; pid = int(sys.argv[2])
    from ldpc_tpu.parallel.distributed import initialize_distributed
    initialize_distributed(coordinator_address=coord, num_processes=2,
                           process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ldpc_tpu.codes.io import read_pcm
    from ldpc_tpu.codes.gf2 import gf2_nullspace
    from ldpc_tpu.channel.awgn import gen_random_codewords
    from ldpc_tpu.decoders.bp import BPDecoder
    from ldpc_tpu.harness.experiment import make_experiment_step
    from ldpc_tpu.parallel.mesh import make_trial_mesh

    h = read_pcm(os.path.join("data", "H.txt"))
    g, ok = gf2_nullspace(h); assert ok
    key = jax.random.PRNGKey(7)
    bsz = 64
    cw_host = np.asarray(gen_random_codewords(key, g, bsz))
    idx_host = np.arange(bsz, dtype=np.int32)

    ts = make_trial_mesh()
    assert ts.num_devices == 4
    # each process feeds only its addressable shard of the global batch
    half = bsz // 2
    cw = jax.make_array_from_process_local_data(
        ts.batch_sharding, cw_host[pid * half:(pid + 1) * half],
        cw_host.shape)
    idx = jax.make_array_from_process_local_data(
        ts.index_sharding, idx_host[pid * half:(pid + 1) * half],
        idx_host.shape)

    dec = BPDecoder(h, max_iter=8)
    step = make_experiment_step(dec, h, snr=0.0, base_key=key)
    with ts.mesh:
        counters = jax.jit(step)(cw, idx)
    total = int(counters["total"]); correct = int(counters["correct"])
    assert total == bsz, (total, bsz)
    print(f"RESULT {pid} total={total} correct={correct}", flush=True)
""")


@pytest.mark.slow
def test_two_process_psum(tmp_path):
    # ground truth in-process (8 local devices, same trial seeds)
    import jax
    import numpy as np
    from ldpc_tpu.codes.io import read_pcm
    from ldpc_tpu.codes.gf2 import gf2_nullspace
    from ldpc_tpu.channel.awgn import gen_random_codewords
    from ldpc_tpu.decoders.bp import BPDecoder
    from ldpc_tpu.harness.experiment import make_experiment_step

    h = read_pcm("data/H.txt")
    g, _ = gf2_nullspace(h)
    key = jax.random.PRNGKey(7)
    cw = np.asarray(gen_random_codewords(key, g, 64))
    dec = BPDecoder(h, max_iter=8)
    step = make_experiment_step(dec, h, snr=0.0, base_key=key)
    ref = step(cw, np.arange(64, dtype=np.int32))
    ref_correct = int(ref["correct"])

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.getcwd()}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), coord, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=os.getcwd()) for pid in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    # both processes observe the same fully-reduced (psum'd) counters,
    # equal to the single-process ground truth
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        fields = dict(kv.split("=") for kv in line.split()[2:])
        assert int(fields["total"]) == 64
        assert int(fields["correct"]) == ref_correct, (line, ref_correct)
