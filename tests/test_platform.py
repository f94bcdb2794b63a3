"""The platform policy (config.PLATFORM_POLICY), the refusal of removed
layout and backend names, and where the compile cache lands."""
import os
import subprocess
import sys

import numpy as np
import pytest

from ldpc_tpu.config import PLATFORM_POLICY, platform_choice

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_gpu_policy():
    assert platform_choice("gauss", "gpu") == "triton"
    assert platform_choice("bp_layout", "gpu") in ("edge", "mxu")


def test_cpu_policy():
    assert platform_choice("gauss", "cpu") == "xla"
    assert platform_choice("bp_layout", "cpu") in ("edge", "dense", "mxu")


@pytest.mark.parametrize("platform", ["neuron", "rocm", "METAL"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no kernel policy"):
        platform_choice("gauss", platform)


def test_policy_knows_gpu_and_cpu_only():
    assert sorted(PLATFORM_POLICY) == ["cpu", "gpu"]


def test_bp_auto_layout_follows_policy(small_h):
    from ldpc_tpu.decoders.bp import BPDecoder
    assert BPDecoder(small_h).layout == platform_choice("bp_layout", "cpu")


@pytest.mark.parametrize("layout", ["pallas", "pallas-interpret", "blocked"])
def test_removed_bp_layouts_raise(layout, small_h):
    from ldpc_tpu.decoders.bp import BPDecoder
    with pytest.raises(ValueError, match="unknown BP layout"):
        BPDecoder(small_h, layout=layout)


@pytest.mark.parametrize("backend", ["pallas", "pallas-interpret", "auto"])
def test_removed_lp_backends_raise(backend, small_h):
    from ldpc_tpu.decoders.alp import ALPDecoder
    with pytest.raises(ValueError, match="unknown lp_backend"):
        ALPDecoder(small_h, lp_backend=backend)


@pytest.mark.parametrize("param", ["factor_backend", "matvec_backend"])
def test_removed_ipm_parameters_raise(param):
    import jax.numpy as jnp
    from ldpc_tpu.ops.ipm_solver import ipm_box_lp
    c = jnp.ones((1, 4))
    a = jnp.zeros((1, 2, 4))
    b = jnp.zeros((1, 2))
    with pytest.raises(TypeError):
        ipm_box_lp(c, a, b, **{param: "xla"})


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c", "import ldpc_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout():
    assert _cache_dir(None) == os.path.join(os.path.abspath(ROOT),
                                            ".jax_cache")


def test_compile_cache_follows_env(tmp_path):
    target = str(tmp_path / "cache")
    assert _cache_dir(target) == target


def test_compile_cache_is_written_where_set(tmp_path):
    """A compile above the size threshold lands in the directory the
    environment names."""
    target = tmp_path / "cache"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(target)}
    code = ("import ldpc_tpu, jax, jax.numpy as jnp; "
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0); jax.jit(lambda x: x * 2 + 1)(jnp.arange(3.0))"
            ".block_until_ready()")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, capture_output=True)
    assert target.is_dir() and any(target.iterdir())


def test_alp_default_backend_is_xla(small_h):
    from ldpc_tpu.decoders.alp import ALPDecoder
    dec = ALPDecoder(small_h, max_rounds=1)
    assert dec.lp_backend == "xla"
    assert np.all(np.asarray(dec._tiers) % 128 == 0)
