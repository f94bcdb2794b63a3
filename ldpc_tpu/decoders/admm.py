"""Batched penalized QP-ADMM LDPC decoding (paper arXiv:1910.12712).

Batched re-design of the reference QP-ADMM decoder (``algo/qp_admm.h``):
the per-trial sparse problem construction (``ConstructADMMProblem``,
``qp_admm.h:13-102``) is hoisted to the host — the cascaded three-variable
parity structure depends only on H — and stored as padded static index/coef
tables. The iteration (``qp_admm.h:130-163``) becomes masked gathers +
element-wise updates over a ``(B, n_var)`` / ``(B, n_con)`` batch, with the
per-trial early break (``sum2 < eps_stop``) replaced by a per-lane done mask
inside a ``lax.while_loop`` (converged lanes are frozen, so semantics match
the scalar break exactly).

Cascade construction semantics (mirrors ``qp_admm.h:58-93``):

* degree-1 check on x:            x <= 0
* degree-2 check on (x_i, x_j):   x_i - x_j <= 0 and x_j - x_i <= 0
* degree-d (d>=3): chain of d-2 three-variable parity constraints through
  d-3 auxiliary variables; each 3-var check (i, j, h) contributes the four
  inequalities (+,-,-)<=0, (-,+,-)<=0, (-,-,+)<=0, (+,+,+)<=2
  (``add_three``, ``qp_admm.h:34-57``).

The decoder certificate is always True when the (alpha, mu) precondition
``min(e) * mu > alpha`` holds, else the whole batch fails with the all-zero
word (``qp_admm.h:108-114,166``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .base import DecodeResult

__all__ = ["ADMMStructure", "QPADMMDecoder", "decode_qp_admm"]


def _structure_caps(h: np.ndarray) -> tuple[int, int, int]:
    """Exact (n_var, n_con, k_max) for the cascade of H, vectorized."""
    h = np.asarray(h, dtype=np.uint8) % 2
    m, n = h.shape
    deg = h.sum(axis=1).astype(np.int64)
    n_aux = int(np.maximum(deg - 3, 0).sum())
    n_con = int(np.where(deg >= 3, 4 * np.maximum(deg - 2, 0),
                         np.where(deg == 2, 2, deg)).sum())
    # per-variable constraint-entry counts: a var in a deg-d check gains
    # 4 (d>=3 cascade), 2 (d==2), or 1 (d==1) entries; each aux var gains 8
    contrib = np.where(deg >= 3, 4, np.where(deg == 2, 2, 1))
    k_var = (h.astype(np.int64) * contrib[:, None]).sum(axis=0)
    k_max = int(k_var.max(initial=0))
    if (deg >= 4).any():
        k_max = max(k_max, 8)
    return n + n_aux, n_con, max(k_max, 1)


@dataclass(frozen=True)
class ADMMStructure:
    """Static constraint structure of the cascaded parity polytope (host)."""

    n: int                    # codeword length
    n_var: int                # n + auxiliary variables
    n_con: int                # constraint rows
    con_var: np.ndarray       # (n_con, 3) int32 var index per slot; pad == n_var
    con_coef: np.ndarray      # (n_con, 3) float32; pad == 0
    b: np.ndarray             # (n_con,) float32 right-hand sides
    var_con: np.ndarray       # (n_var, k_max) int32 con index; pad == n_con
    var_coef: np.ndarray      # (n_var, k_max) float32; pad == 0
    e: np.ndarray             # (n_var,) float32: sum of squared coefs per var

    @staticmethod
    def from_h(h: np.ndarray, n_var_cap: int | None = None,
               n_con_cap: int | None = None,
               k_max_cap: int | None = None) -> "ADMMStructure":
        """Build the cascade from H. Optional caps pad the tables to fixed
        capacities so structures from different H (same caps) can be stacked
        and vmapped (used by the population-parallel matrix optimizer)."""
        h = np.asarray(h, dtype=np.uint8) % 2
        m, n = h.shape

        # native fast path (exact same table layout; see _native/ldpc_host.cpp)
        caps = _structure_caps(h)
        nv = n_var_cap or caps[0]
        nc = n_con_cap or caps[1]
        km = k_max_cap or caps[2]
        if nv >= caps[0] and nc >= caps[1] and km >= caps[2]:
            from .. import _native
            out = _native.admm_build(h, nv, nc, km)
            if out is not None:
                return ADMMStructure(
                    n=n, n_var=nv, n_con=nc, con_var=out["con_var"],
                    con_coef=out["con_coef"], b=out["b"],
                    var_con=out["var_con"], var_coef=out["var_coef"],
                    e=out["e"])

        cons: list[tuple[list[int], list[float], float]] = []

        def add(varids, coefs, rhs):
            cons.append((list(varids), list(coefs), float(rhs)))

        def add_three(i, j, k):
            add([i, j, k], [1.0, -1.0, -1.0], 0.0)
            add([i, j, k], [-1.0, 1.0, -1.0], 0.0)
            add([i, j, k], [-1.0, -1.0, 1.0], 0.0)
            add([i, j, k], [1.0, 1.0, 1.0], 2.0)

        pos = n
        for i in range(m):
            idx = np.nonzero(h[i])[0].tolist()
            if not idx:
                continue
            if len(idx) == 1:
                add([idx[0]], [1.0], 0.0)
                continue
            if len(idx) == 2:
                add([idx[0], idx[1]], [1.0, -1.0], 0.0)
                add([idx[0], idx[1]], [-1.0, 1.0], 0.0)
                continue
            last = idx[0]
            for j in range(1, len(idx) - 2):
                aux = pos
                pos += 1
                add_three(last, idx[j], aux)
                last = aux
            add_three(last, idx[-2], idx[-1])

        n_var = pos
        n_con = len(cons)
        nv = n_var_cap or n_var
        nc = n_con_cap or n_con
        assert nv >= n_var and nc >= n_con

        con_var = np.full((nc, 3), nv, dtype=np.int32)
        con_coef = np.zeros((nc, 3), dtype=np.float32)
        b = np.zeros((nc,), dtype=np.float32)
        per_var: list[list[tuple[int, float]]] = [[] for _ in range(nv)]
        for ci, (vids, cfs, rhs) in enumerate(cons):
            b[ci] = rhs
            for s, (vi, cf) in enumerate(zip(vids, cfs)):
                con_var[ci, s] = vi
                con_coef[ci, s] = cf
                per_var[vi].append((ci, cf))

        k_max = k_max_cap or max((len(p) for p in per_var), default=1)
        assert all(len(p) <= k_max for p in per_var)
        var_con = np.full((nv, k_max), nc, dtype=np.int32)
        var_coef = np.zeros((nv, k_max), dtype=np.float32)
        e = np.zeros((nv,), dtype=np.float32)
        for vi, plist in enumerate(per_var):
            for s, (ci, cf) in enumerate(plist):
                var_con[vi, s] = ci
                var_coef[vi, s] = cf
                e[vi] += cf * cf
        # capacity-padded phantom variables get e == 0; they are excluded from
        # the e_min precondition below by masking on real variables only.
        return ADMMStructure(n=n, n_var=nv, n_con=nc, con_var=con_var,
                             con_coef=con_coef, b=b, var_con=var_con,
                             var_coef=var_coef, e=e)

    @property
    def e_min(self) -> float:
        # min over *real* variables (phantom capacity rows have e == 0).
        # Real variables always have at least one constraint entry in the
        # reference construction whenever their check row is nonempty.
        real = self.e[self.e > 0]
        return float(real.min()) if real.size else float("inf")


def decode_qp_admm(tables: dict, n: int, llrs, alpha, mu,
                   max_iter: int, eps_stop: float) -> DecodeResult:
    """Functional QP-ADMM decode over explicit structure tensors.

    ``tables``: dict with keys con_var (nc,3) i32, con_coef (nc,3) f32,
    b (nc,) f32, var_con (nv,k) i32, var_coef (nv,k) f32, e (nv,) f32 —
    possibly capacity-padded (phantom vars/cons carry zero coefficients).
    This form is vmappable over a leading proposals axis (the matrix
    optimizer evaluates a population of H candidates in one program).
    """
    q, feasible, v0, z0, y0, iter_fn = _admm_setup(
        tables, n, llrs, alpha, mu, eps_stop)
    bsz = llrs.shape[0]

    def body(state):
        it, v, z, yl, done, done_it = state
        v, z, yl, now_done = iter_fn(q, v, z, yl, done)
        done_it = jnp.where(now_done, it + 1, done_it)  # per-lane count
        done = done | now_done
        return it + 1, v, z, yl, done, done_it

    def cond(state):
        it, _, _, _, done, _ = state
        return (it < max_iter) & ~jnp.all(done)

    init = (jnp.int32(0), v0, z0, y0, jnp.zeros((bsz,), bool),
            jnp.full((bsz,), max_iter, jnp.int32))
    it, v, _, _, done, done_it = jax.lax.while_loop(cond, body, init)

    bits = (v[:, :n] > 0.5).astype(jnp.uint8)
    bits = jnp.where(feasible, bits, 0)
    success = jnp.full((bsz,), True) & feasible     # qp_admm.h:166
    return DecodeResult(bits=bits, success=success, iterations=done_it)


def _admm_setup(tables: dict, n: int, llrs, alpha, mu, eps_stop):
    """Shared ADMM iteration builder for the batched and streaming paths.

    Returns ``(q, feasible, v0, z0, y0, iter_fn)`` with
    ``iter_fn(q, v, z, yl, done) -> (v, z, yl, now_done)`` performing
    exactly one reference iteration (``qp_admm.h:130-163``) with done-lane
    freezing (the scalar code's per-trial ``break``). ``q`` is an explicit
    argument (not closed over) so the streaming path can carry refilled
    per-lane objectives through its state.
    """
    con_var, con_coef = tables["con_var"], tables["con_coef"]
    b_vec = tables["b"]
    var_con, var_coef = tables["var_con"], tables["var_coef"]
    e = tables["e"]
    n_var = var_con.shape[0]
    n_con = con_var.shape[0]
    bsz = llrs.shape[0]

    q = jnp.concatenate(
        [jnp.asarray(llrs, jnp.float32),
         jnp.zeros((bsz, n_var - n), jnp.float32)], axis=1)

    e_min = jnp.min(jnp.where(e > 0, e, jnp.inf))
    feasible = e_min * mu > alpha                  # qp_admm.h:108-114

    denom = mu * e - alpha
    # phantom capacity vars have e == 0 -> denom == -alpha; their q is 0 and
    # they appear in no constraint, so their value is inert. Guard /0 anyway.
    inv_coef = -1.0 / jnp.where(denom == 0, 1.0, denom)

    v0 = (q > 0.0).astype(jnp.float32)             # qp_admm.h:116-119
    z0 = jnp.zeros((bsz, n_con), jnp.float32)
    y0 = jnp.zeros((bsz, n_con), jnp.float32)

    def gather_con(tcon):
        t = jnp.concatenate([tcon, jnp.zeros((bsz, 1), tcon.dtype)], axis=1)
        g = jnp.take(t, var_con.reshape(-1), axis=1).reshape(bsz, n_var, -1)
        return jnp.sum(g * var_coef[None], axis=-1)

    def gather_var(v):
        vpad = jnp.concatenate([v, jnp.zeros((bsz, 1), v.dtype)], axis=1)
        g = jnp.take(vpad, con_var.reshape(-1), axis=1).reshape(bsz, n_con, 3)
        return jnp.sum(g * con_coef[None], axis=-1)

    def iter_fn(q, v, z, yl, done):
        t = yl + mu * (z - b_vec[None])
        bq = q + alpha / 2.0 + gather_con(t)
        v_new = jnp.clip(bq * inv_coef[None], 0.0, 1.0)
        r = b_vec[None] - gather_var(v_new)
        z_new = jnp.maximum(0.0, r - yl)
        y_new = jnp.maximum(0.0, yl - r)
        sum2 = jnp.sum((z_new - r) ** 2, axis=-1)
        keep = done[:, None]                        # scalar-code `break`
        v = jnp.where(keep, v, v_new)
        z = jnp.where(keep, z, z_new)
        yl = jnp.where(keep, yl, y_new)
        now_done = ~done & (sum2 < eps_stop)
        return v, z, yl, now_done

    return q, feasible, v0, z0, y0, iter_fn


class QPADMMDecoder:
    """Penalized-objective ADMM decoder specialized to one H.

    Defaults mirror the reference's OPTIMAL config: alpha=1.2, mu=0.55,
    max_iter=10000, eps_stop=1e-5 (``main.cpp:30-34``).
    """

    def __init__(self, h, alpha: float = 1.2, mu: float = 0.55,
                 max_iter: int = 10000, eps_stop: float = 1e-5,
                 structure: ADMMStructure | None = None):
        self.name = "QP-ADMM"
        self.structure = structure or ADMMStructure.from_h(np.asarray(h))
        self.n = self.structure.n
        self.alpha = float(alpha)
        self.mu = float(mu)
        self.max_iter = int(max_iter)
        self.eps_stop = float(eps_stop)

        s = self.structure
        self._con_var = jnp.asarray(s.con_var)
        self._con_coef = jnp.asarray(s.con_coef)
        self._b = jnp.asarray(s.b)
        self._var_con = jnp.asarray(s.var_con)
        self._var_coef = jnp.asarray(s.var_coef)
        self._e = jnp.asarray(s.e)
        self._decode = jax.jit(self._decode_impl)
        self._decode_params = jax.jit(self._decode_params_impl)

    # ------------------------------------------------------------------
    @property
    def tables(self) -> dict:
        return {"con_var": self._con_var, "con_coef": self._con_coef,
                "b": self._b, "var_con": self._var_con,
                "var_coef": self._var_coef, "e": self._e}

    def _decode_params_impl(self, llrs, alpha, mu) -> DecodeResult:
        """Decode with traced (alpha, mu) — vmappable for grid search."""
        return decode_qp_admm(self.tables, self.n, llrs, alpha, mu,
                              self.max_iter, self.eps_stop)

    def _decode_impl(self, llrs):
        return self._decode_params_impl(llrs, self.alpha, self.mu)

    def decode_batch(self, llrs) -> DecodeResult:
        return self._decode(llrs)

    def decode_batch_params(self, llrs, alpha, mu) -> DecodeResult:
        """Traced-parameter entry point for the (alpha, mu) grid search."""
        return self._decode_params(llrs, alpha, mu)

    # ------------------------------------------------------------------
    # Streaming protocol (harness.experiment.run_streaming_experiment):
    # the batched decode's lax.while_loop runs the WHOLE batch to the
    # slowest lane's convergence — one stubborn 10000-iteration lane stalls
    # every other lane in the batch. The
    # streaming harness instead runs fixed-size chunks, drains converged
    # lanes between chunks, and refills their slots from the trial stream,
    # so steady-state cost per trial approaches mean-iterations, not
    # max-iterations. Per-lane numerics are identical to decode_batch:
    # the same _admm_setup iter_fn with per-lane freezing.
    stream_chunk_iters = 512

    def stream_init(self, llrs) -> dict:
        """Fresh per-lane solver state for a batch of LLRs (jit-safe)."""
        q, _, v0, z0, y0, _ = _admm_setup(
            self.tables, self.n, llrs, self.alpha, self.mu, self.eps_stop)
        bsz = llrs.shape[0]
        return {"q": q, "v": v0, "z": z0, "yl": y0,
                "done": jnp.zeros((bsz,), bool),
                "it": jnp.zeros((bsz,), jnp.int32)}

    def stream_chunk(self, state: dict) -> dict:
        """Run up to ``stream_chunk_iters`` iterations; freeze done lanes.

        A lane is done when converged (``sum2 < eps_stop``) or its own
        iteration count reaches ``max_iter`` — per-lane counts, unlike the
        batch-global counter of ``decode_batch`` (same resulting values:
        frozen lanes never advance their count).
        """
        _, _, _, _, _, iter_fn = _admm_setup(
            self.tables, self.n, state["q"][:, :self.n],
            self.alpha, self.mu, self.eps_stop)
        q = state["q"]

        def body(carry):
            k, v, z, yl, done, it = carry
            v, z, yl, now_done = iter_fn(q, v, z, yl, done)
            it = it + (~done).astype(jnp.int32)
            done = done | now_done | (it >= self.max_iter)
            return k + 1, v, z, yl, done, it

        def cond(carry):
            k, _, _, _, done, _ = carry
            return (k < self.stream_chunk_iters) & ~jnp.all(done)

        _, v, z, yl, done, it = jax.lax.while_loop(
            cond, body, (jnp.int32(0), state["v"], state["z"], state["yl"],
                         state["done"], state["it"]))
        return {"q": q, "v": v, "z": z, "yl": yl, "done": done, "it": it}

    def stream_done(self, state: dict):
        return state["done"]

    def stream_finish(self, state: dict) -> DecodeResult:
        e = self._e
        e_min = jnp.min(jnp.where(e > 0, e, jnp.inf))
        feasible = e_min * self.mu > self.alpha     # qp_admm.h:108-114
        bits = (state["v"][:, :self.n] > 0.5).astype(jnp.uint8)
        bits = jnp.where(feasible, bits, 0)
        success = jnp.full(bits.shape[:1], True) & feasible  # qp_admm.h:166
        return DecodeResult(bits=bits, success=success,
                            iterations=state["it"])
