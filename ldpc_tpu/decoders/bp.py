"""Batched sum-product / min-sum belief propagation.

Batched re-design of the reference BP (``algo/bp.h``): the object-oriented
Tanner graph rebuilt per trial (``algo/bp.h:212-215``) becomes static padded
index arrays built once (:class:`ldpc_tpu.codes.graph.CodeGraph`), and the
per-edge message maps become dense message tensors updated with masked
vector ops — flooding schedule, exactly the reference semantics:

* check->variable:  sgn * phi(sum phi(|v2c|)) over the row excluding self
  (``algo/bp.h:49-57``)
* variable->check:  (channel_llr + sum incoming) excluding self
  (``algo/bp.h:77-83``)
* posterior estimate = channel_llr + sum incoming (``algo/bp.h:85-90``)
* hard decision: estimate <= 0 -> bit 1 (``algo/bp.h:193``)
* early exit on syndrome success each iteration (``algo/bp.h:191-196``);
  batched, the early exit is per-batch: a ``lax.while_loop`` runs until every
  lane has converged or ``max_iter`` is hit, with converged lanes' outputs
  frozen by a done-mask.

Three data layouts (``layout="auto"`` takes the platform policy's choice,
``config.PLATFORM_POLICY``):

* ``layout="edge"``: messages live on padded edge slots,
  ``(B, m, dc_max)`` row layout and ``(B, n, dv_max)`` col layout, re-bucketed
  with static flat ``take`` ops. Work is O(B * E).
* ``layout="dense"``: messages are full masked ``(B, m, n)`` tensors — no
  gathers at all, element-wise ops + reductions. Suits small codes where
  m*n is within a small factor of E; also the cross-check oracle.
* ``layout="mxu"``: row-layout messages with the column-side reduction and
  the edge re-broadcast expressed as matmuls against the static 0/1
  edge-incidence matrix S (S[e, col(e)] = 1):  L = llr + c2v @ S  and
  v2c = L @ S^T - c2v.  Zero gathers — both transfers are matrix products.
  ``mxu_dtype=bfloat16`` runs the incidence matmuls in bf16 (messages
  round to an 8-bit mantissa, with f32 accumulation).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.graph import CodeGraph
from ..config import platform_choice
from ..ops.phi import phi
from .base import DecodeResult

NEUTRAL_LLR = 64.0  # pad-slot LLR: phi() == 0, sign +1 -> no contribution
BP_LAYOUTS = ("edge", "dense", "mxu")

__all__ = ["BPDecoder", "BP_LAYOUTS"]


def _check_update_rowlayout(v2c, mask, variant: str, ms_factor: float,
                            phi_fn=None):
    """Row-layout check-node update: v2c (B, m, dc) -> c2v (B, m, dc).

    ``phi_fn`` overrides the phi-domain transform (default: the clamped
    production ``ops.phi.phi``). The only intended non-default use is the
    error-floor reproduction experiment (``scripts/prof/prof_bp_floor.py``),
    which passes an *unclamped* phi to reinstate the reference's inf/NaN
    saturation artifact (``algo/bp.h:34``)."""
    if phi_fn is None:
        phi_fn = phi
    neg = (v2c <= 0.0) & mask                       # sign conv: 0 -> negative (bp.h:83)
    sign_e = jnp.where(neg, -1.0, 1.0)
    total_neg = jnp.sum(neg, axis=-1, keepdims=True)
    sign_tot = 1.0 - 2.0 * (total_neg % 2).astype(v2c.dtype)
    if variant == "sumprod":
        mag = jnp.where(mask, phi_fn(jnp.abs(v2c)), 0.0)
        s = jnp.sum(mag, axis=-1, keepdims=True)
        out_mag = phi_fn(s - mag)
    elif variant == "minsum":
        a = jnp.where(mask, jnp.abs(v2c), jnp.inf)
        m1 = jnp.min(a, axis=-1, keepdims=True)
        # second minimum: min over the array with the (first) argmin removed
        idx = jnp.argmin(a, axis=-1, keepdims=True)
        slot = jax.lax.broadcasted_iota(jnp.int32, a.shape, a.ndim - 1)
        a2 = jnp.where(slot == idx, jnp.inf, a)
        m2 = jnp.min(a2, axis=-1, keepdims=True)
        out_mag = ms_factor * jnp.where(slot == idx, m2, m1)
    else:
        raise ValueError(f"unknown BP variant {variant!r}")
    return jnp.where(mask, sign_tot * sign_e * out_mag, 0.0)


class BPDecoder:
    """Flooding-schedule BP specialized to one H.

    Parameters mirror ``BeliefPropagationDecoder`` (``algo/bp.h:208-222``);
    ``max_iter`` defaults to the reference's benchmark value 100
    (``main.cpp:29``).

    Default precision: ``mxu_dtype=bfloat16`` for the ``mxu`` layout's
    incidence matmuls. bf16 rounds the messages (not the 0/1 incidence
    matrices, which are exact), so bit-identity with f32 is not claimed;
    on a GPU its FER-neutrality rests on the measured z against the
    reference golden (``chip_smoke.py`` Phase 1). Callers that need true
    f32 message matmuls can pass ``mxu_dtype=jnp.float32``.
    """

    def __init__(self, h, max_iter: int = 100, variant: str = "sumprod",
                 layout: str = "auto", ms_factor: float = 0.75,
                 dtype=jnp.float32, fixed_iters: bool = False,
                 mxu_dtype=jnp.bfloat16):
        if layout == "auto":
            layout = platform_choice("bp_layout")
        if layout not in BP_LAYOUTS:
            raise ValueError(f"unknown BP layout {layout!r}; "
                             f"known: {BP_LAYOUTS + ('auto',)}")
        self.name = "BP"
        self.graph = g = CodeGraph.from_h(np.asarray(h))
        self.n = g.n
        self.m = g.m
        self.max_iter = int(max_iter)
        self.variant = variant
        self.layout = layout
        self.ms_factor = float(ms_factor)
        self.dtype = dtype
        self.fixed_iters = bool(fixed_iters)
        self.mxu_dtype = mxu_dtype

        self._row_mask = jnp.asarray(g.row_mask)
        self._row_col = jnp.asarray(g.row_col)            # pads == n
        self._col_mask = jnp.asarray(g.col_mask)
        self._row_from_col = jnp.asarray(g.row_from_col)  # flat idx, pad == n*dv
        self._col_from_row = jnp.asarray(g.col_from_row)  # flat idx, pad == m*dc
        if layout == "dense":
            self._hmask = jnp.asarray(g.h.astype(bool))
        if layout == "mxu":
            # edge->column incidence: S[e, col(e)] = 1 (pad slots all-zero)
            e_flat = g.m * g.dc_max
            s = np.zeros((e_flat, g.n), np.float32)
            cols = g.row_col.reshape(-1)
            valid = g.row_mask.reshape(-1)
            s[np.arange(e_flat)[valid], cols[valid]] = 1.0
            self._s = jnp.asarray(s, mxu_dtype)
            self._st = jnp.asarray(s.T, mxu_dtype)
            self._ht = jnp.asarray(g.h.astype(np.float32).T, mxu_dtype)
        self._decode = jax.jit(partial(self._decode_impl))

    # ---- layout plumbing -------------------------------------------------
    def _col_to_row(self, x_col, fill):
        """(B, n, dv) -> (B, m, dc) via flat static gather."""
        b = x_col.shape[0]
        flat = x_col.reshape(b, -1)
        flat = jnp.concatenate([flat, jnp.full((b, 1), fill, flat.dtype)], axis=1)
        return jnp.take(flat, self._row_from_col.reshape(-1), axis=1).reshape(
            b, self.m, self.graph.dc_max)

    def _row_to_col(self, x_row, fill):
        b = x_row.shape[0]
        flat = x_row.reshape(b, -1)
        flat = jnp.concatenate([flat, jnp.full((b, 1), fill, flat.dtype)], axis=1)
        return jnp.take(flat, self._col_from_row.reshape(-1), axis=1).reshape(
            b, self.n, self.graph.dv_max)

    def _syndrome_ok(self, bits):
        """bits (B, n) int32 -> (B,) bool, via row-layout parity."""
        b = bits.shape[0]
        padded = jnp.concatenate([bits, jnp.zeros((b, 1), bits.dtype)], axis=1)
        gathered = jnp.take(padded, self._row_col.reshape(-1), axis=1).reshape(
            b, self.m, self.graph.dc_max)
        parity = jnp.sum(gathered, axis=-1) % 2
        return jnp.all(parity == 0, axis=-1)

    # ---- decode ----------------------------------------------------------
    def _decode_impl(self, llrs) -> DecodeResult:
        llrs = jnp.asarray(llrs, self.dtype)
        if self.layout == "edge":
            return self._decode_edge(llrs)
        if self.layout == "mxu":
            return self._decode_mxu(llrs)
        return self._decode_dense(llrs)

    def _decode_mxu(self, llrs):
        b = llrs.shape[0]
        g = self.graph
        rmask = self._row_mask
        rmask_flat = rmask.reshape(-1)
        md = self.m * g.dc_max

        def mm(x, w):
            return jnp.dot(x.astype(self.mxu_dtype), w,
                           preferred_element_type=jnp.float32)

        def iteration(v2c_flat):
            v2c = v2c_flat.reshape(b, self.m, g.dc_max)
            c2v = _check_update_rowlayout(v2c, rmask[None], self.variant,
                                          self.ms_factor)
            c2v_flat = c2v.reshape(b, md)
            total = llrs + mm(c2v_flat, self._s)           # column sums
            v2c_next = jnp.where(rmask_flat[None],
                                 mm(total, self._st) - c2v_flat, NEUTRAL_LLR)
            bits = (total <= 0.0).astype(jnp.int32)
            return v2c_next, bits

        def syndrome_ok(bits):
            parity = mm(bits.astype(jnp.float32), self._ht)
            return jnp.all(jnp.round(parity) % 2 == 0, axis=-1)

        bits0 = (llrs <= 0.0).astype(jnp.int32)
        v2c0 = jnp.where(rmask_flat[None], mm(llrs, self._st), NEUTRAL_LLR)

        def body(state):
            it, v2c, bits, done, iters = state
            v2c_next, bits_new = iteration(v2c)
            ok = syndrome_ok(bits_new)
            newly = ok & ~done
            bits = jnp.where(done[:, None], bits, bits_new)
            iters = jnp.where(newly, it + 1, iters)
            done = done | ok
            return it + 1, v2c_next, bits, done, iters

        def cond(state):
            it, _, _, done, _ = state
            if self.fixed_iters:
                return it < self.max_iter
            return (it < self.max_iter) & ~jnp.all(done)

        init = (jnp.int32(0), v2c0, bits0,
                jnp.zeros((b,), bool), jnp.full((b,), self.max_iter,
                                                jnp.int32))
        _, _, bits, done, iters = jax.lax.while_loop(cond, body, init)
        return DecodeResult(bits=bits.astype(jnp.uint8), success=done,
                            iterations=iters)

    def _decode_edge(self, llrs):
        b = llrs.shape[0]
        g = self.graph
        rmask, cmask = self._row_mask, self._col_mask

        def iteration(v2c_row):
            c2v_row = _check_update_rowlayout(v2c_row, rmask, self.variant,
                                              self.ms_factor)
            c2v_col = self._row_to_col(c2v_row, 0.0)
            total = llrs + jnp.sum(jnp.where(cmask, c2v_col, 0.0), axis=-1)
            v2c_col = jnp.where(cmask, total[:, :, None] - c2v_col, NEUTRAL_LLR)
            v2c_row_next = self._col_to_row(v2c_col, NEUTRAL_LLR)
            bits = (total <= 0.0).astype(jnp.int32)
            return v2c_row_next, bits

        # initial v->c message is just the channel LLR (all c2v start at 0,
        # matching init() at bp.h:42-45,70-73 + the pre-loop c_receive at :184)
        bits0 = (llrs <= 0.0).astype(jnp.int32)
        v2c0 = jnp.where(rmask, self._col_to_row(
            jnp.broadcast_to(llrs[:, :, None], (b, self.n, g.dv_max)),
            NEUTRAL_LLR), NEUTRAL_LLR)

        return self._run_loop(b, v2c0, bits0, iteration)

    def _decode_dense(self, llrs):
        b = llrs.shape[0]
        hmask = self._hmask  # (m, n)

        def iteration(v2c):
            # v2c: (B, m, n) masked. Check update along n.
            c2v = _check_update_rowlayout(v2c, hmask[None], self.variant,
                                          self.ms_factor)
            total = llrs + jnp.sum(c2v, axis=1)           # (B, n)
            v2c_next = jnp.where(hmask[None], total[:, None, :] - c2v,
                                 NEUTRAL_LLR)
            bits = (total <= 0.0).astype(jnp.int32)
            return v2c_next, bits

        bits0 = (llrs <= 0.0).astype(jnp.int32)
        v2c0 = jnp.where(hmask[None], llrs[:, None, :], NEUTRAL_LLR)
        return self._run_loop(b, v2c0, bits0, iteration)

    def _run_loop(self, b, v2c0, bits0, iteration):
        def body(state):
            it, v2c, bits, done, iters = state
            v2c_next, bits_new = iteration(v2c)
            ok = self._syndrome_ok(bits_new)
            newly = ok & ~done
            bits = jnp.where(done[:, None], bits, bits_new)
            iters = jnp.where(newly, it + 1, iters)
            done = done | ok
            return it + 1, v2c_next, bits, done, iters

        def cond(state):
            it, _, _, done, _ = state
            if self.fixed_iters:
                return it < self.max_iter
            return (it < self.max_iter) & ~jnp.all(done)

        init = (jnp.int32(0), v2c0, bits0,
                jnp.zeros((b,), bool), jnp.full((b,), self.max_iter, jnp.int32))
        _, _, bits, done, iters = jax.lax.while_loop(cond, body, init)
        return DecodeResult(bits=bits.astype(jnp.uint8), success=done,
                            iterations=iters)

    def decode_batch(self, llrs) -> DecodeResult:
        return self._decode(llrs)
