"""Batched GF(2) elimination tests vs a scalar transcription of
CalculateGauss (algo/agc_alp.h:19-74)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from ldpc_tpu.ops.gf2_gauss import calculate_gauss_batched, \
    fractional_column_order


def scalar_calculate_gauss(h0, u, eps=1e-8):
    """Direct NumPy transcription of the reference algorithm."""
    h0 = np.asarray(h0, np.uint8)
    u = np.asarray(u, float)
    n = len(u)
    non_int = [i for i in range(n) if eps <= u[i] <= 1 - eps]
    zeros = [i for i in range(n) if u[i] < eps]
    ones = [i for i in range(n) if u[i] > 1 - eps]
    non_int.sort(key=lambda i: abs(u[i] - 0.5))  # python sort is stable
    p = non_int + zeros + ones
    p_inv = np.empty(n, int)
    for i, pi in enumerate(p):
        p_inv[pi] = i
    h = h0[:, p].copy()
    m = h.shape[0]
    col = 0
    for i in range(m):
        while col < n:
            found = False
            for t in range(i, m):
                if h[t, col]:
                    h[[i, t]] = h[[t, i]]
                    found = True
                    break
            if found:
                break
            col += 1
        assert col < n
        piv = col
        col += 1
        for k in range(m):
            if k != i and h[k, piv]:
                h[k] ^= h[i]
    return h[:, p_inv]


def test_column_order_matches(tiny_h):
    rng = np.random.default_rng(0)
    u = rng.uniform(0, 1, (3, 7)).astype(np.float32)
    u[0, 2] = 0.0  # integral zero
    u[1, 4] = 1.0  # integral one
    p = np.asarray(fractional_column_order(jnp.asarray(u), 1e-8))
    for b in range(3):
        ub = u[b]
        non_int = sorted([i for i in range(7) if 1e-8 <= ub[i] <= 1 - 1e-8],
                         key=lambda i: abs(ub[i] - 0.5))
        zeros = [i for i in range(7) if ub[i] < 1e-8]
        ones = [i for i in range(7) if ub[i] > 1 - 1e-8]
        np.testing.assert_array_equal(p[b], non_int + zeros + ones)


def test_gauss_matches_scalar(small_h):
    rng = np.random.default_rng(1)
    bsz = 4
    u = rng.uniform(0.0, 1.0, (bsz, small_h.shape[1])).astype(np.float32)
    u[0, :40] = 0.0
    u[1, 10:30] = 1.0
    out = np.asarray(calculate_gauss_batched(jnp.asarray(small_h),
                                             jnp.asarray(u), 1e-8))
    for b in range(bsz):
        expect = scalar_calculate_gauss(small_h, u[b])
        np.testing.assert_array_equal(out[b], expect, err_msg=f"lane {b}")


def test_gauss_preserves_row_space(small_h):
    """The eliminated matrix must have the same GF(2) row space: every
    original row must be a combination of eliminated rows and vice versa —
    checked via equal rank of stacked matrices."""
    from ldpc_tpu.codes.gf2 import gf2_rank
    rng = np.random.default_rng(2)
    u = rng.uniform(0, 1, (2, small_h.shape[1])).astype(np.float32)
    out = np.asarray(calculate_gauss_batched(jnp.asarray(small_h),
                                             jnp.asarray(u), 1e-8))
    r0 = gf2_rank(small_h)
    for b in range(2):
        stacked = np.concatenate([small_h, out[b]])
        assert gf2_rank(out[b]) == r0
        assert gf2_rank(stacked) == r0


def scalar_eliminate(h):
    """Scalar oracle of the elimination core alone (CalculateGauss steps
    2's loop, agc_alp.h:44-72), tolerating rank deficiency: for each column
    left to right, the first row >= rank with a 1 swaps up to ``rank`` and
    is XORed out of every other row with a 1."""
    h = np.asarray(h, np.uint8).copy()
    m, n = h.shape
    rank = 0
    for col in range(n):
        if rank == m:
            break
        hits = [t for t in range(rank, m) if h[t, col]]
        if not hits:
            continue
        t = hits[0]
        h[[rank, t]] = h[[t, rank]]
        for k in range(m):
            if k != rank and h[k, col]:
                h[k] ^= h[rank]
        rank += 1
    return h


def _permuted(h, bsz, seed):
    """(B, m, n) copies of h, each column-permuted by the fractional order
    of a random LP point, as AGC-ALP feeds the elimination."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, (bsz, h.shape[1])).astype(np.float32)
    u[0, : h.shape[1] // 3] = 0.0          # integral coordinates too
    p = np.asarray(fractional_column_order(jnp.asarray(u)))
    return np.stack([h[:, p[b]] for b in range(bsz)]).astype(np.uint8)


def _code(name, tiny_h):
    from ldpc_tpu.codes.io import read_pcm
    if name == "tiny":
        return tiny_h
    if name.startswith("rand"):
        _, m, n = name.split("-")
        rng = np.random.default_rng(int(m) * 1000 + int(n))
        return (rng.uniform(size=(int(m), int(n))) < 0.3).astype(np.uint8)
    return read_pcm(os.path.join(DATA, name))


DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@pytest.mark.parametrize("code", ["tiny", "H.txt", "optimalH.txt",
                                  "H05.txt", "rand-37-101", "rand-50-77"])
def test_triton_elimination_matches_xla_and_oracle(code, tiny_h):
    """The Triton kernel (Pallas interpreter) is bit-identical to the XLA
    loop and to the scalar oracle, on real codes and on random matrices
    whose n is no multiple of 32 and whose m is no power of two."""
    from ldpc_tpu.ops.gf2_gauss import gf2_eliminate_ordered
    from ldpc_tpu.ops.pallas.gauss_kernel import gf2_eliminate_triton
    h = _code(code, tiny_h)
    h_perm = _permuted(h, 3, seed=len(code))
    ref = np.asarray(gf2_eliminate_ordered(jnp.asarray(h_perm)))
    out = np.asarray(gf2_eliminate_triton(jnp.asarray(h_perm),
                                          interpret=True))
    np.testing.assert_array_equal(out, ref)
    for b in range(3):
        np.testing.assert_array_equal(out[b], scalar_eliminate(h_perm[b]))


def test_triton_active_mask(small_h):
    """Inactive lanes run no column and come back unreduced; active lanes
    are reduced as usual."""
    from ldpc_tpu.ops.gf2_gauss import gf2_eliminate_ordered
    from ldpc_tpu.ops.pallas.gauss_kernel import gf2_eliminate_triton
    h_perm = _permuted(small_h, 4, seed=3)
    act = jnp.asarray([True, False, False, True])
    out = np.asarray(gf2_eliminate_triton(jnp.asarray(h_perm), act,
                                          interpret=True))
    ref = np.asarray(gf2_eliminate_ordered(jnp.asarray(h_perm)))
    np.testing.assert_array_equal(out[[0, 3]], ref[[0, 3]])
    np.testing.assert_array_equal(out[[1, 2]], h_perm[[1, 2]])


@pytest.mark.parametrize("shape", [(3, 7), (64, 128), (160, 280),
                                   (37, 101), (1, 33)])
def test_pack_unpack_roundtrip(shape):
    from ldpc_tpu.ops.pallas.gauss_kernel import (pack_bits, packed_shape,
                                                  unpack_bits)
    m, n = shape
    rng = np.random.default_rng(m + n)
    h = (rng.uniform(size=(2, m, n)) < 0.5).astype(np.uint8)
    packed = pack_bits(jnp.asarray(h))
    assert packed.shape == (2,) + packed_shape(m, n)
    assert packed.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(unpack_bits(packed, m, n)), h)
    # bit j % 32 of word j // 32 is column j; padding stays zero
    j = n - 1
    word = np.asarray(packed)[:, :m, j // 32].astype(np.uint32)
    np.testing.assert_array_equal((word >> (j % 32)) & 1, h[:, :, j])
    assert not np.asarray(packed)[:, m:].any()


@pytest.mark.parametrize("shape,block,fits", [
    ((160, 280), (256, 16), True),        # optimalH, H05
    ((64, 128), (64, 4), True),           # data/H.txt
    ((520, 640), (1024, 32), False),      # H02: beyond the block
])
def test_packed_block_and_fit(shape, block, fits):
    from ldpc_tpu.ops.pallas.gauss_kernel import (MAX_WORDS, kernel_fits,
                                                  packed_shape)
    assert packed_shape(*shape) == block
    assert kernel_fits(*shape) == fits == (block[0] * block[1] <= MAX_WORDS)


def test_triton_refuses_oversize_block():
    from ldpc_tpu.ops.pallas.gauss_kernel import gf2_eliminate_triton
    with pytest.raises(ValueError, match="XLA"):
        gf2_eliminate_triton(jnp.zeros((1, 520, 640), jnp.uint8),
                             interpret=True)


@pytest.mark.parametrize("backend,shape,platform,expect", [
    ("auto", (160, 280), "gpu", "triton"),
    ("auto", (520, 640), "gpu", "xla"),      # the explicit shape rule
    ("auto", (160, 280), "cpu", "xla"),
    ("xla", (160, 280), "gpu", "xla"),
    ("triton", (160, 280), "gpu", "triton"),
])
def test_gauss_backend_resolution(backend, shape, platform, expect):
    from ldpc_tpu.ops.gf2_gauss import resolve_gauss_backend
    assert resolve_gauss_backend(backend, *shape, platform=platform) == expect


@pytest.mark.parametrize("backend,shape,platform", [
    ("triton", (160, 280), "cpu"),           # no card: raise, not interpret
    ("triton", (520, 640), "gpu"),           # beyond the block
    ("pallas", (160, 280), "gpu"),           # removed names
    ("pallas-interpret", (160, 280), "cpu"),
    ("auto", (160, 280), "neuron"),             # no policy for the platform
])
def test_gauss_backend_refusals(backend, shape, platform):
    from ldpc_tpu.ops.gf2_gauss import resolve_gauss_backend
    with pytest.raises(ValueError):
        resolve_gauss_backend(backend, *shape, platform=platform)


def test_forced_triton_decoder_raises_without_card(small_h):
    """On this CPU host a forced Triton elimination raises at construction
    instead of silently interpreting or running XLA."""
    from ldpc_tpu.decoders.agc_alp import AGCALPDecoder
    with pytest.raises(ValueError, match="CUDA"):
        AGCALPDecoder(small_h, gauss_backend="triton")
    assert AGCALPDecoder(small_h).gauss_backend == "xla"


@pytest.mark.parametrize("shape", [(160, 280), (64, 128), (37, 101)])
def test_triton_kernel_lowers_for_cuda(shape):
    """The kernel lowers to Triton IR for a CUDA card (the step a host
    without a card can check; compiling the IR needs the card)."""
    import jax
    from ldpc_tpu.ops.pallas.gauss_kernel import gf2_eliminate_triton
    hp = jnp.zeros((4,) + shape, jnp.uint8)
    act = jnp.ones((4,), bool)
    lowered = jax.jit(gf2_eliminate_triton).trace(hp, act).lower(
        lowering_platforms=("cuda",))
    assert "gf2_eliminate" in lowered.as_text()


@pytest.mark.gpu
def test_triton_compiled_matches_xla(gpu_device, opt_h):
    """The kernel as compiled for the card, against the XLA loop."""
    from ldpc_tpu.ops.gf2_gauss import gf2_eliminate_ordered
    from ldpc_tpu.ops.pallas.gauss_kernel import gf2_eliminate_triton
    h_perm = jnp.asarray(_permuted(opt_h, 128, seed=5))
    np.testing.assert_array_equal(np.asarray(gf2_eliminate_triton(h_perm)),
                                  np.asarray(gf2_eliminate_ordered(h_perm)))
