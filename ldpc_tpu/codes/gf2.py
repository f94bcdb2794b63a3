"""GF(2) linear algebra on the host (NumPy) and on device (JAX).

Batched re-design of the reference GF(2) core (``utils/codeword.h`` in the
reference repo): bit vectors/matrices become ``uint8`` / ``bool`` ndarrays, the
GF(2) matmul becomes an integer matmul reduced mod 2 (a plain matmul on device),
and the Gaussian-elimination nullspace (``GetOrtogonal``,
``utils/codeword.h:97-128``) is a vectorized row-reduction.

Host-side routines are NumPy (they run once per experiment); device-side
syndrome checks live in :func:`syndrome` / :func:`is_codeword` and are jittable.

When the optional native extension is available (``ldpc_tpu._native``), the
host nullspace uses bit-packed C++ elimination; the NumPy path is the fallback
and the reference for equivalence tests.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "gf2_matmul",
    "gf2_nullspace",
    "gf2_rank",
    "syndrome",
    "is_codeword",
]


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2) matrix product (host).  Mirrors ``operator*`` at
    ``utils/codeword.h:61-71`` of the reference."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return (a.astype(np.int32) @ b.astype(np.int32)) % 2


def gf2_rank(h: np.ndarray) -> int:
    """Rank of a GF(2) matrix via row reduction (host)."""
    h = np.array(h, dtype=np.uint8) % 2
    m, n = h.shape
    rank = 0
    for col in range(n):
        if rank >= m:
            break
        pivots = np.nonzero(h[rank:, col])[0]
        if pivots.size == 0:
            continue
        piv = rank + pivots[0]
        if piv != rank:
            h[[rank, piv]] = h[[piv, rank]]
        mask = h[:, col].copy().astype(bool)
        mask[rank] = False
        h[mask] ^= h[rank]
        rank += 1
    return rank


def gf2_nullspace(h: np.ndarray) -> tuple[np.ndarray | None, bool]:
    """Generator matrix G whose rows span the nullspace of H over GF(2).

    Reproduces the semantics of ``GetOrtogonal`` (``utils/codeword.h:97-128``):
    for each row i the pivot is the *first* nonzero column; if any row reduces
    to zero the routine fails (returns ``(None, False)``), exactly as the
    reference declares the matrix singular.  On success returns ``(G, True)``
    with ``G`` of shape ``(n - m, n)`` satisfying ``H @ G.T == 0 (mod 2)``.

    Uses the bit-packed native core when available; NumPy fallback below is
    the behavioural reference (equivalence unit-tested).
    """
    h = np.array(h, dtype=np.uint8) % 2
    if h.shape[1] > h.shape[0]:
        from .. import _native
        out = _native.nullspace(h)
        if out is not None:
            return out
    m, n = h.shape
    pos = np.full(m, -1, dtype=np.int64)
    is_main = np.zeros(n, dtype=bool)
    for i in range(m):
        nz = np.nonzero(h[i])[0]
        if nz.size == 0:
            return None, False
        p = nz[0]
        pos[i] = p
        mask = h[:, p].astype(bool).copy()
        mask[i] = False
        h[mask] ^= h[i]
        is_main[p] = True
    free_cols = np.nonzero(~is_main)[0]
    g = np.zeros((n - m, n), dtype=np.uint8)
    for idx, j in enumerate(free_cols):
        g[idx, j] = 1
        rows = np.nonzero(h[:, j])[0]
        g[idx, pos[rows]] = 1
    return g, True


def syndrome(h_dev, bits):
    """Device-side syndrome ``H @ c mod 2``.

    ``h_dev``: (m, n) array (any integer/bool dtype); ``bits``: (..., n).
    Returns (..., m) uint8 syndrome. Uses an integer matmul so XLA can map it
    to a device matmul for large batches.
    """
    h_i = jnp.asarray(h_dev, dtype=jnp.int32)
    b_i = jnp.asarray(bits, dtype=jnp.int32)
    return (b_i @ h_i.T) % 2


def is_codeword(h_dev, bits):
    """Device-side validity check, batched.  ``IsCodeword`` of
    ``utils/codeword.h:90-95``.  Returns (...,) bool."""
    return jnp.all(syndrome(h_dev, bits) == 0, axis=-1)
