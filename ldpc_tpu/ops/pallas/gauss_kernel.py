"""Batched GF(2) Gaussian elimination as one Triton program per lane
(Pallas, ``backend="triton"``).

The XLA path (``ops.gf2_gauss.gf2_eliminate_ordered``) is an n-trip loop
whose every trip re-reads and re-writes the whole (B, m, n) buffer and
evaluates a batch-wide predicate: on a GPU each trip is several kernel
launches, so the elimination is bound by sequential launch overhead, not
by bandwidth. Here one program owns one lane for the whole elimination.
The lane's matrix is bit-packed along n into int32 words and padded to a
power-of-two block: optimalH's (160, 280) becomes (256, 16) words, 16 KB,
which the program keeps in registers from the first column to the last.

Per column c (word ``c // 32``, bit ``c % 32``):

* the column's bits come from a masked word reduction over each row;
* the pivot t is the smallest row index >= rank whose bit is set;
* the pivot row comes from a masked row reduction, and rows ``rank`` and
  t swap with ``where``;
* the pivot row is XORed into every other row whose bit is set.

Semantics are bit-identical to the XLA path (and to ``CalculateGauss``,
``algo/agc_alp.h:44-72``). A lane stops once its rank reaches m: no later
column can yield a pivot. Lanes whose ``active`` flag is False run no
column and return their input unchanged (callers mask those lanes).

Packing and unpacking are plain XLA around the call. Matrices whose
packed block exceeds ``MAX_WORDS`` are refused (``kernel_fits``); the
caller's shape rule sends them to the XLA path.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

__all__ = ["gf2_eliminate_triton", "kernel_fits", "pack_bits",
           "packed_shape", "unpack_bits", "MAX_WORDS"]

# Largest packed block (rows x words) one program holds: 8192 int32 words
# are 32 KB, 64 registers a thread at 4 warps for the matrix itself.
MAX_WORDS = 8192


def _pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def packed_shape(m: int, n: int) -> tuple[int, int]:
    """(rows, words) of one lane's packed block: both powers of two."""
    return _pow2(m), _pow2(-(-n // 32))


def kernel_fits(m: int, n: int) -> bool:
    """Whether an (m, n) matrix fits one program's packed block."""
    rows, words = packed_shape(m, n)
    return rows * words <= MAX_WORDS


def pack_bits(h):
    """(B, m, n) 0/1 -> (B, rows, words) int32; bit j % 32 of word j // 32
    holds column j. Padding rows and columns are zero."""
    bsz, m, n = h.shape
    rows, words = packed_shape(m, n)
    bits = jnp.pad((h != 0).astype(jnp.uint32),
                   [(0, 0), (0, rows - m), (0, words * 32 - n)])
    bits = bits.reshape(bsz, rows, words, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(packed, jnp.int32)


def unpack_bits(packed, m: int, n: int):
    """Inverse of :func:`pack_bits`: (B, rows, words) int32 -> (B, m, n)
    uint8."""
    bsz, rows, words = packed.shape
    bits = (packed[..., None] >> jnp.arange(32, dtype=jnp.int32)) & 1
    return bits.reshape(bsz, rows, words * 32)[:, :m, :n].astype(jnp.uint8)


def _kernel(act_ref, h_ref, o_ref, *, m: int, n: int):
    mat = h_ref[...]                                     # (rows, words)
    rows, words = mat.shape
    row_id = jax.lax.broadcasted_iota(jnp.int32, (rows, 1), 0)
    word_id = jax.lax.broadcasted_iota(jnp.int32, (1, words), 1)
    n_cols = act_ref[0] * n                   # act is 0 or 1

    def cond(carry):
        c, rank, _ = carry
        return (c < n_cols) & (rank < m)

    def body(carry):
        c, rank, mat = carry
        word = jnp.sum(jnp.where(word_id == c // 32, mat, 0), axis=1,
                       keepdims=True)                    # (rows, 1)
        bit = (word >> (c % 32)) & 1
        cand = (bit == 1) & (row_id >= rank)
        t = jnp.min(jnp.where(cand, row_id, rows))
        has = t < rows
        is_r = (row_id == rank) & has
        is_t = (row_id == t) & has
        row_t = jnp.sum(jnp.where(is_t, mat, 0), axis=0, keepdims=True)
        row_r = jnp.sum(jnp.where(is_r, mat, 0), axis=0, keepdims=True)
        bit_r = jnp.sum(jnp.where(is_r, bit, 0))
        mat = jnp.where(is_r, row_t, jnp.where(is_t, row_r, mat))
        bit = jnp.where(is_r, 1, jnp.where(is_t, bit_r, bit))
        elim = (bit == 1) & ~is_r & has
        mat = mat ^ jnp.where(elim, row_t, 0)
        return c + 1, rank + has.astype(jnp.int32), mat

    _, _, mat = jax.lax.while_loop(cond, body,
                                   (jnp.int32(0), jnp.int32(0), mat))
    o_ref[...] = mat


@functools.partial(jax.jit, static_argnames=("interpret",))
def gf2_eliminate_triton(h_perm, active=None, *, interpret: bool = False):
    """Row-reduce (B, m, n) 0/1 matrices w.r.t. left-to-right column
    order; same result as ``ops.gf2_gauss.gf2_eliminate_ordered``.
    ``active``: optional (B,) bool; inactive lanes come back unreduced.
    Returns (B, m, n) uint8. ``interpret`` runs the kernel through the
    Pallas interpreter (tests on a host without a card)."""
    bsz, m, n = h_perm.shape
    if not kernel_fits(m, n):
        raise ValueError(f"({m}, {n}) exceeds the kernel's "
                         f"{MAX_WORDS}-word block; use the XLA path")
    rows, words = packed_shape(m, n)
    act = (jnp.ones((bsz,), jnp.int32) if active is None
           else active.astype(jnp.int32))
    block = pl.BlockSpec((None, rows, words), lambda i: (i, 0, 0))
    out = pl.pallas_call(
        functools.partial(_kernel, m=m, n=n),
        grid=(bsz,),
        in_specs=[pl.BlockSpec((1,), lambda i: (i,)), block],
        out_specs=block,
        out_shape=jax.ShapeDtypeStruct((bsz, rows, words), jnp.int32),
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(num_warps=4,
                                                    num_stages=1),
        interpret=interpret,
        name="gf2_eliminate",
    )(act, pack_bits(h_perm))
    return unpack_bits(out, m, n)
