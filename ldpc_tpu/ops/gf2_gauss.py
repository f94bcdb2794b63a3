"""Batched, jittable GF(2) Gaussian elimination with solution-adapted column
ordering — the cut-generation core of AGC-ALP.

Reproduces ``CalculateGauss`` (``algo/agc_alp.h:19-74``) per batch lane:

1. order columns: fractional entries first, stably sorted by |u - 0.5|
   ascending; then integral-zero columns (original order); then integral-one
   columns (original order)  (``agc_alp.h:20-39``);
2. GF(2) row-reduce H with pivoting in that column order — for each pivot
   step, advance the column pointer until some row >= r has a 1, swap it up,
   and XOR it out of *all* other rows (``agc_alp.h:44-72``);
3. un-permute the columns (``agc_alp.h:73``).

The data-dependent column advancement is restructured as a fixed n-trip
loop over columns: maintain the current pivot-row count r per lane; each
column either yields a pivot (swap + eliminate, r += 1) or is skipped —
exactly the same elimination order, fixed trip count.

Step 2 has two backends: the batched XLA loop below, and a Triton kernel
that keeps each lane's bit-packed matrix in registers
(:mod:`ldpc_tpu.ops.pallas.gauss_kernel`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import platform_choice
from .pallas.gauss_kernel import gf2_eliminate_triton, kernel_fits

EPS = 1e-8
GAUSS_BACKENDS = ("auto", "xla", "triton")

__all__ = ["fractional_column_order", "gf2_eliminate_ordered",
           "calculate_gauss_batched", "resolve_gauss_backend",
           "GAUSS_BACKENDS"]


def fractional_column_order(u, eps: float = EPS):
    """Per-lane column permutation p (B, n): fractional-first order.

    Lexicographic sort by (group, |u-0.5| for fractionals else 0, index);
    stable within groups, matching the reference's stable_sort + appends.
    """
    bsz, n = u.shape
    zeros = u < eps
    ones = u > 1.0 - eps
    group = jnp.where(zeros, 1, jnp.where(ones, 2, 0)).astype(jnp.int32)
    dist = jnp.where(group == 0, jnp.abs(u - 0.5), 0.0)
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (bsz, n))
    _, _, _, p = jax.lax.sort((group, dist, idx, idx), num_keys=3)
    return p


def gf2_eliminate_ordered(h_perm):
    """Row-reduce (B, m, n) uint8 matrices fully (RREF w.r.t. left-to-right
    column order). Returns the reduced matrices."""
    bsz, m, n = h_perm.shape
    row_iota = jnp.arange(m, dtype=jnp.int32)[None, :]          # (1, m)

    def step(col, carry):
        hm, r = carry                                            # (B,m,n), (B,)
        col_bits = jax.lax.dynamic_index_in_dim(
            hm, col, axis=2, keepdims=False)                     # (B, m)
        cand = (col_bits == 1) & (row_iota >= r[:, None])
        has = jnp.any(cand, axis=1)                              # (B,)
        t = jnp.argmax(cand, axis=1).astype(jnp.int32)           # first hit
        oh_r = row_iota == r[:, None]                            # (B, m)
        oh_t = row_iota == t[:, None]
        row_r = jnp.einsum("bm,bmn->bn", oh_r.astype(jnp.uint8), hm)
        row_t = jnp.einsum("bm,bmn->bn", oh_t.astype(jnp.uint8), hm)
        # swap rows r <-> t where a pivot exists
        do = has[:, None, None]
        hm = jnp.where(do & oh_r[:, :, None], row_t[:, None, :],
                       jnp.where(do & oh_t[:, :, None], row_r[:, None, :], hm))
        # eliminate the pivot column from all other rows
        col_bits2 = jax.lax.dynamic_index_in_dim(hm, col, axis=2,
                                                 keepdims=False)
        elim = (col_bits2 == 1) & ~oh_r & has[:, None]           # (B, m)
        hm = hm ^ (elim[:, :, None].astype(jnp.uint8) *
                   row_t[:, None, :])
        r = r + has.astype(jnp.int32)
        return hm, r

    # skip the remaining columns once every lane's rank saturates (no
    # further column can yield a pivot; the reference loop only skips
    # through them): a trip past saturation costs only the predicate.
    def maybe_step(col, carry):
        _, r = carry
        return jax.lax.cond(jnp.min(r) < m, lambda c: step(col, c),
                            lambda c: c, carry)

    hm, _ = jax.lax.fori_loop(0, n, maybe_step,
                              (h_perm, jnp.zeros((bsz,), jnp.int32)))
    return hm


def resolve_gauss_backend(backend: str, m: int, n: int,
                          platform: str | None = None) -> str:
    """The elimination backend that ``calculate_gauss_batched`` runs.

    "auto" takes the platform policy's choice (``config.PLATFORM_POLICY``),
    then the shape rule: a matrix larger than the Triton kernel's block
    (``gauss_kernel.kernel_fits``) runs on XLA. "triton" demands the
    kernel: it raises without a CUDA card or for a matrix beyond the
    block, rather than interpreting or running XLA instead."""
    if backend not in GAUSS_BACKENDS:
        raise ValueError(f"unknown gauss backend {backend!r}; "
                         f"known: {GAUSS_BACKENDS}")
    if backend == "xla":
        return backend
    if platform is None:
        platform = jax.devices()[0].platform
    if backend == "auto":
        backend = platform_choice("gauss", platform)
        if backend == "triton" and not kernel_fits(m, n):
            backend = "xla"
        return backend
    if platform != "gpu":
        raise ValueError(f"gauss backend 'triton' needs a CUDA card; "
                         f"platform is {platform!r}")
    if not kernel_fits(m, n):
        raise ValueError(f"({m}, {n}) exceeds the Triton kernel's block")
    return backend


def calculate_gauss_batched(h, u, eps: float = EPS, active=None,
                            backend: str = "auto"):
    """Full CalculateGauss: h (m, n) static uint8, u (B, n) -> (B, m, n).

    ``backend``: "auto", "xla" or "triton" (see
    :func:`resolve_gauss_backend`). ``active``: optional (B,) bool — the
    Triton kernel skips inactive lanes and returns them unreduced
    (callers must mask); the XLA path ignores it.
    """
    bsz, n = u.shape
    h = jnp.asarray(h, jnp.uint8)
    backend = resolve_gauss_backend(backend, h.shape[0], n)
    p = fractional_column_order(u, eps)                          # (B, n)
    # h_perm[b, i, j] = h[i, p[b, j]]
    h_perm = jnp.take(h, p, axis=1).transpose(1, 0, 2)
    if backend == "xla":
        he = gf2_eliminate_ordered(h_perm)
    else:
        he = gf2_eliminate_triton(h_perm, active)
    # un-permute: out[b, i, p[b, j]] = he[b, i, j], a gather by p's inverse
    lanes = jnp.arange(bsz)[:, None]
    p_inv = jnp.zeros_like(p).at[lanes, p].set(
        jnp.arange(n, dtype=p.dtype)[None, :])
    return jnp.take_along_axis(he, p_inv[:, None, :], axis=2)
