"""Batched primal-dual interior-point LP solver (Mehrotra predictor-corrector).

Second on-device replacement for GLPK's dual simplex (``glp_simplex`` at
``algo/full_lp.h:142-145``, ``algo/alp.h:117-124``, ``algo/agc_alp.h:94-101``),
complementing the first-order PDHG solver (:mod:`ldpc_tpu.ops.lp_solver`).

Why a second solver: on the degenerate cut LPs of the ALP family, PDHG hits a
~1e-2 coordinate-accuracy plateau (1-4% relative objective) that no iteration
budget or restart scheme breaks, and the odd-set cut search run at such
off-optimum points selects measurably weaker cuts — the root cause of the
AGC-ALP FER gap vs the reference (see VALIDATION.md, round-3 investigation).
An interior-point method converges superlinearly to mu ~ 1e-7 in ~30 Newton
steps regardless of degeneracy, recovering coordinates to ~1e-4 — the same
regime as an exact simplex for cut-search purposes.

Every step is batched dense linear algebra. The normal matrix
``M = A^T diag(y/s) A + diag(zl/x + zu/w)`` is one (B, n, n) einsum; the
two Newton solves (predictor + corrector) share one batched Cholesky
factorization. All f32, with primal regularization ``delta*I`` to keep the
factorization stable as mu -> 0 (f32 Cholesky tolerates cond ~1e7; the
regularized M stays within it for mu >= ~1e-7).

Problem form (matches pdhg_box_lp):

    min  c^T x   s.t.  A x <= b,  0 <= x <= 1

with per-lane dense rows A (B, R, n). All-zero rows (the fixed-capacity cut
buffers' inactive slots) are detected and given a large benign rhs so their
slacks stay interior and their duals converge to ~0.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["ipm_box_lp"]


def _pos_step(v, dv, frac: float = 0.995):
    """Largest alpha in (0, 1] with v + alpha*dv >= (1-frac)*v, batched over
    the last axes; v > 0 assumed. Returns (B,)."""
    ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    amax = jnp.min(ratio.reshape(ratio.shape[0], -1), axis=-1)
    return jnp.minimum(1.0, frac * amax)


def ipm_box_lp(c, a_rows, b, iters: int = 35, tol: float = 1e-6,
               active=None, delta: float = 1e-6, check_every: int = 5,
               x0=None, y0=None, warm_shift: float = 1e-2,
               stall_ratio: float = 0.8):
    """Mehrotra predictor-corrector IPM, batched over lanes. All matmuls
    (einsums AND the Cholesky / triangular-solve internals) run at
    Precision.HIGHEST: a reduced-precision f32 matmul (bf16 passes, or TF32
    on a GPU) keeps ~3 significant digits, which destroys the late Newton
    systems (D entries span 1e+-8) — the solver then stalls at ~1e-2, no
    better than PDHG.

    c (B, n); a_rows (B, R, n); b (B, R); ``active`` optional (B,) bool —
    inactive lanes are excluded from the convergence check (their iterates
    still step; callers discard them).

    Returns (x, y, err): x (B, n) primal, y (B, R) duals of Ax <= b (>= 0),
    err (B,) = max(primal violation, relative duality gap) — the same
    per-lane certificate as ``pdhg_box_lp(tol=...)``.

    Fixed-trip ``fori_loop`` of up to ``iters`` Newton steps; every
    ``check_every`` steps the whole batch short-circuits (lax.cond) once
    all active lanes are below ``tol`` in mu/primal/dual residuals OR the
    batch error has plateaued — two consecutive chunk boundaries each
    improving it by less than ``1 - stall_ratio`` (see the chunk loop).

    The running ``A x`` residual is carried incrementally across Newton
    steps (the corrector's ``A dx`` is reused; ~1e-7-scale drift) and
    re-derived exactly at every chunk boundary and for the final
    certificate. The normal matrix is factored with ``jnp.linalg.cholesky``
    and solved with ``cho_solve`` (cuSOLVER / cuBLAS on a GPU).
    """
    with jax.default_matmul_precision("highest"):
        bsz, r_cap, n = a_rows.shape
        f32 = jnp.float32
        c = c.astype(f32)
        a = a_rows.astype(f32)

        def mv(x):
            return jnp.einsum("brn,bn->br", a, x,
                              preferred_element_type=f32,
                              precision=jax.lax.Precision.HIGHEST)

        def mvt(y):
            return jnp.einsum("brn,br->bn", a, y,
                              preferred_element_type=f32,
                              precision=jax.lax.Precision.HIGHEST)

        # per-lane objective scaling for conditioning (argmin-invariant)
        cscale = jnp.maximum(jnp.mean(jnp.abs(c), axis=-1, keepdims=True), 1e-6)
        cs = c / cscale

        # benign rhs for all-zero (inactive cut-slot) rows: slack stays at BIG,
        # dual -> mu/BIG ~ 0. BIG comfortably exceeds any real cut rhs (<= n).
        row_on = jnp.sum(jnp.abs(a), axis=-1) > 0                  # (B, R)
        big = f32(2.0 * n)
        be = jnp.where(row_on, b.astype(f32), big)

        # interior start; with (x0, y0) a *shifted warm start* from the
        # previous cut round's solution — pulled `warm_shift` into the
        # interior so complementarity products are bounded away from 0 and
        # Mehrotra recenters in a couple of steps instead of ~15 cold ones
        if x0 is not None:
            x = jnp.clip(x0.astype(f32), warm_shift, 1.0 - warm_shift)
        else:
            x = jnp.full((bsz, n), 0.5, f32)
        w = 1.0 - x
        ax = mv(x)
        s = jnp.maximum(be - ax, warm_shift if x0 is not None else 1.0)
        if y0 is not None:
            y = jnp.maximum(y0.astype(f32) / jnp.maximum(cscale, 1e-6),
                            warm_shift)
            rc0 = cs + mvt(y)
            zl = jnp.maximum(rc0, warm_shift)
            zu = jnp.maximum(-rc0, warm_shift)
        else:
            y = jnp.ones((bsz, r_cap), f32)
            zl = jnp.ones((bsz, n), f32) + jnp.maximum(cs, 0.0)
            zu = jnp.ones((bsz, n), f32) + jnp.maximum(-cs, 0.0)

        n_compl = f32(r_cap + 2 * n)
        eye = jnp.eye(n, dtype=f32)

        def residuals(ax, x, w, s, y, zl, zu):
            rp = ax + s - be                                        # (B, R)
            rd = cs + mvt(y) - zl + zu                              # (B, n)
            mu = (jnp.sum(y * s, axis=-1) + jnp.sum(zl * x, axis=-1)
                  + jnp.sum(zu * w, axis=-1)) / n_compl             # (B,)
            return rp, rd, mu

        def newton(state):
            x, w, s, y, zl, zu, ax = state
            rp, rd, mu = residuals(ax, x, w, s, y, zl, zu)

            dy_s = jnp.clip(y / s, 1e-10, 1e10)                     # (B, R)
            dxl = jnp.clip(zl / x, 1e-10, 1e10)
            dxu = jnp.clip(zu / w, 1e-10, 1e10)
            dxx = dxl + dxu                                         # (B, n)

            m = jnp.einsum("bri,br,brj->bij", a, dy_s, a,
                           preferred_element_type=f32,
                           precision=jax.lax.Precision.HIGHEST)
            m = m + jax.vmap(jnp.diag)(dxx) + delta * eye[None]
            chol = jnp.linalg.cholesky(m)

            def m_solve(r):
                return jax.scipy.linalg.cho_solve(
                    (chol, True), r[..., None])[..., 0]

            def solve_dir(sig_mu, extra_y, extra_l, extra_u):
                """Newton direction for complementarity targets
                y*s -> sig_mu - extra_y (etc.); returns (dx, dy, ds, dzl, dzu)."""
                # eliminate ds, dy, dzl, dzu onto dx (see module docstring)
                ry = (sig_mu[:, None] - extra_y) / s - y            # (B, R)
                rl = (sig_mu[:, None] - extra_l) / x - zl           # (B, n)
                ru = (sig_mu[:, None] - extra_u) / w - zu           # (B, n)
                rhs = -rd - mvt(ry + dy_s * rp) + rl - ru
                dx = m_solve(rhs)
                adx = mv(dx)
                ds = -rp - adx
                dy = ry - dy_s * ds
                dzl = rl - dxl * dx
                dzu = ru + dxu * dx
                return dx, dy, ds, dzl, dzu, adx

            zero_r = jnp.zeros_like(y)
            zero_n = jnp.zeros_like(x)
            # predictor (affine scaling, sigma = 0)
            dxa, dya, dsa, dzla, dzua, _ = solve_dir(
                jnp.zeros((bsz,), f32), zero_r, zero_n, zero_n)
            ap = jnp.minimum(_pos_step(s, dsa),
                             jnp.minimum(_pos_step(x, dxa),
                                         _pos_step(w, -dxa)))
            ad = jnp.minimum(_pos_step(y, dya),
                             jnp.minimum(_pos_step(zl, dzla),
                                         _pos_step(zu, dzua)))
            mu_aff = ((jnp.sum((y + ad[:, None] * dya) *
                               (s + ap[:, None] * dsa), axis=-1)
                       + jnp.sum((zl + ad[:, None] * dzla) *
                                 (x + ap[:, None] * dxa), axis=-1)
                       + jnp.sum((zu + ad[:, None] * dzua) *
                                 (w - ap[:, None] * dxa), axis=-1)) / n_compl)
            sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-12)) ** 3, 0.0, 1.0)

            # corrector (reuses the factorization)
            dx, dy, ds, dzl, dzu, adx = solve_dir(
                sigma * mu, dya * dsa, dzla * dxa, -dzua * dxa)
            ap = jnp.minimum(_pos_step(s, ds),
                             jnp.minimum(_pos_step(x, dx), _pos_step(w, -dx)))
            ad = jnp.minimum(_pos_step(y, dy),
                             jnp.minimum(_pos_step(zl, dzl),
                                         _pos_step(zu, dzu)))
            # f32 Cholesky safeguard: a lane whose factorization broke down
            # (NaN direction) freezes at its current (still finite) iterate
            # instead of poisoning the batch-max convergence check.
            ok = (jnp.all(jnp.isfinite(dx), axis=-1)
                  & jnp.all(jnp.isfinite(dy), axis=-1))[:, None]
            # running A x: reuse the corrector matvec instead of paying a
            # fresh one next step (re-derived exactly at chunk boundaries;
            # the interior clip below drifts it by at most the clip amount,
            # ~1e-12-scale)
            ax = jnp.where(ok, ax + ap[:, None] * adx, ax)
            x = jnp.where(ok, x + ap[:, None] * dx, x)
            w = 1.0 - x
            s = jnp.where(ok, s + ap[:, None] * ds, s)
            y = jnp.where(ok, y + ad[:, None] * dy, y)
            zl = jnp.where(ok, zl + ad[:, None] * dzl, zl)
            zu = jnp.where(ok, zu + ad[:, None] * dzu, zu)
            # keep strictly interior in f32
            floor = f32(1e-12)
            x = jnp.clip(x, floor, 1.0 - floor)
            w = 1.0 - x
            s = jnp.maximum(s, floor)
            y = jnp.maximum(y, floor)
            zl = jnp.maximum(zl, floor)
            zu = jnp.maximum(zu, floor)
            return x, w, s, y, zl, zu, ax

        def lane_errs(state):
            x, w, s, y, zl, zu, _ = state
            ax = mv(x)                      # exact refresh of the carry
            rp, rd, mu = residuals(ax, x, w, s, y, zl, zu)
            err = jnp.maximum(
                mu, jnp.maximum(jnp.max(jnp.abs(rp) * row_on, axis=-1),
                                jnp.max(jnp.abs(rd), axis=-1)))
            if active is not None:
                err = jnp.where(active, err, 0.0)
            return err, ax                                   # (B,), (B, R)

        def chunk(_, carry):
            # Run the next ``check_every`` Newton steps while ANY lane is
            # above tol and has not PLATEAUED — plateau means two
            # consecutive chunk boundaries each improving that lane's error
            # by less than (1 - stall_ratio). On the degenerate cut LPs the
            # f32 plateau sits above any usable tol, so a tol-only
            # short-circuit never fires and every solve pays the full
            # ``iters`` budget; the plateau cut stops there instead — the
            # steps it skips no longer change the iterate. Two structure
            # points, both measured: a single slow chunk is NOT terminal
            # (Mehrotra's decay is not monotone in 5-step windows; a
            # one-stall latch wrecked cut-search quality and FER), and the
            # stall counters are PER LANE — a batch-max rule would let the
            # single worst lane's plateau freeze lanes still converging
            # toward tol.
            state, best_err, stall_cnt = carry
            err, ax_fresh = lane_errs(state)
            state = state[:6] + (ax_fresh,)
            # "improving" is judged against the lane's RUNNING MINIMUM and
            # a stalled lane stays stalled: plateau errors fluctuate, and
            # judging against the previous boundary lets the noise read as
            # improvement, un-stall the lane, and keep the whole batch
            # running (it cost throughput for no FER change).
            improving = err < stall_ratio * best_err
            latched = stall_cnt >= 2
            stall_cnt = jnp.where(latched, stall_cnt,
                                  jnp.where(improving, 0, stall_cnt + 1))
            go = jnp.any((err > tol) & (stall_cnt < 2))

            def run(state):
                return jax.lax.fori_loop(
                    0, check_every, lambda _, s: newton(s), state)

            state = jax.lax.cond(go, run, lambda s: s, state)
            return state, jnp.minimum(best_err, err), stall_cnt

        n_chunks = -(-iters // check_every)
        state, _, _ = jax.lax.fori_loop(
            0, n_chunks, chunk,
            ((x, w, s, y, zl, zu, ax),
             jnp.full((bsz,), jnp.inf, f32), jnp.zeros((bsz,), jnp.int32)))
        x, w, s, y, zl, zu, _ = state

        # certificate in the caller's (unscaled-c) convention, matching
        # pdhg_box_lp's lane_err: max(primal violation, relative duality gap)
        ax = mv(x)
        viol = jnp.max(jnp.maximum(ax - be, 0.0), axis=-1)
        rc = cs + mvt(y)
        pobj = jnp.sum(cs * x, axis=-1)
        dobj = -jnp.sum(be * y * row_on, axis=-1) \
            + jnp.sum(jnp.minimum(rc, 0.0), axis=-1)
        gap = (pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))
        err = jnp.maximum(viol, gap)
        if active is not None:
            err = jnp.where(active, err, 0.0)
        return x, y * cscale, err
