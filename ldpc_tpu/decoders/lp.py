"""Full ("Feldman") LP decoding over the cascaded three-variable polytope.

Batched equivalent of ``algo/full_lp.h``: the LP rows are exactly the
cascaded constraints the reference builds into GLPK (``DecodeFullLP``,
``full_lp.h:61-156``) — the same structure the QP-ADMM decoder uses — but the
solve is a batched on-device PDHG (:mod:`ldpc_tpu.ops.lp_solver`) instead of
dual simplex. The constraint matrix is shared across the batch, so products
are true GEMMs.

Certificate semantics follow ``DecodeFromLp`` (``full_lp.h:44-59``): round at
0.5; integral iff no original variable lies in (tol, 1-tol). A first-order
solver reaches ~1e-3 accuracy, so ``int_tol`` defaults looser than the
reference's EPS=1e-8; certified outputs are additionally required to be valid
codewords (the reference asserts this, ``full_lp.h:151-153``).

Note: the reference ships this decoder but comments it out of the benchmark
list (``main.cpp:36``); it is the shared foundation of ALP/AGC-ALP.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.gf2 import is_codeword
from ..ops.lp_solver import pdhg_box_lp_shared
from .admm import ADMMStructure
from .base import DecodeResult

__all__ = ["FullLPDecoder"]


class FullLPDecoder:
    def __init__(self, h, iters: int = 2000, int_tol: float = 3e-2,
                 structure: ADMMStructure | None = None):
        self.name = "FullLP"
        h = np.asarray(h, dtype=np.uint8) % 2
        self._h = jnp.asarray(h)
        self.structure = s = structure or ADMMStructure.from_h(h)
        self.n = s.n
        self.iters = int(iters)
        self.int_tol = float(int_tol)

        # densify the cascade rows: (n_con, n_var) float32, a few MB
        a = np.zeros((s.n_con, s.n_var), np.float32)
        for ci in range(s.n_con):
            for sl in range(3):
                vi = s.con_var[ci, sl]
                if vi < s.n_var:
                    a[ci, vi] += s.con_coef[ci, sl]
        self._a = jnp.asarray(a)
        self._b = jnp.asarray(s.b)
        self._decode = jax.jit(self._decode_impl)

    def _decode_impl(self, llrs) -> DecodeResult:
        s = self.structure
        bsz = llrs.shape[0]
        c = jnp.concatenate(
            [jnp.asarray(llrs, jnp.float32),
             jnp.zeros((bsz, s.n_var - s.n), jnp.float32)], axis=1)
        x0 = (c < 0.0).astype(jnp.float32)   # box-LP vertex warm start
        y0 = jnp.zeros((bsz, s.n_con), jnp.float32)
        x, _ = pdhg_box_lp_shared(c, self._a, self._b, x0, y0, self.iters)
        xv = x[:, : s.n]
        bits = (xv > 0.5).astype(jnp.uint8)
        integral = jnp.all((xv < self.int_tol) | (xv > 1.0 - self.int_tol),
                           axis=-1)
        success = integral & is_codeword(self._h, bits)
        return DecodeResult(bits=bits, success=success,
                            iterations=jnp.full((bsz,), self.iters, jnp.int32))

    def decode_batch(self, llrs) -> DecodeResult:
        return self._decode(llrs)
