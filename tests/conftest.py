"""Test configuration: by default an 8-virtual-device CPU platform, so
sharding logic is exercised without accelerator hardware, as SURVEY.md §4
prescribes.

Tests that need a CUDA card carry the ``gpu`` marker and skip themselves
(the ``gpu_device`` fixture) when the first JAX device is not a GPU. On a
machine with a card, run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def gpu_device():
    """The first JAX device, for tests marked ``gpu``; skips the test on a
    host whose first device is not a CUDA card. Decided at run time, never
    at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA card; first device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def small_h():
    """The committed 64x128 fixture matrix (data/H.txt)."""
    from ldpc_tpu.codes.io import read_pcm
    return read_pcm(os.path.join(os.path.dirname(__file__), "..", "data", "H.txt"))


@pytest.fixture(scope="session")
def opt_h():
    from ldpc_tpu.codes.io import read_pcm
    return read_pcm(os.path.join(os.path.dirname(__file__), "..", "data", "optimalH.txt"))


@pytest.fixture(scope="session")
def tiny_h():
    """A tiny hand-checkable (3, 7) Hamming-style parity-check matrix."""
    return np.array(
        [[1, 1, 0, 1, 1, 0, 0],
         [1, 0, 1, 1, 0, 1, 0],
         [0, 1, 1, 1, 0, 0, 1]], dtype=np.uint8)
