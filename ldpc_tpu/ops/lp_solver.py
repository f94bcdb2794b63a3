"""Batched first-order LP solver (PDHG / Chambolle-Pock) for LP decoding.

Replaces GLPK's dual simplex (``glp_simplex`` with ``GLP_DUALP``, used at
``algo/full_lp.h:142-145``, ``algo/alp.h:117-124``, ``algo/agc_alp.h:94-101``)
with an on-device, batched primal-dual hybrid gradient method:

    min  c^T x   s.t.  A x <= b,  0 <= x <= 1

    x_{k+1} = clip_[0,1](x_k - tau (c + A^T y_k))
    y_{k+1} = max(0,  y_k + sigma (A (2 x_{k+1} - x_k) - b))

Step sizes obey tau * sigma * ||A||^2 < 1 via the bound
``||A||_2^2 <= ||A||_1 * ||A||_inf`` computed per lane from the *active*
constraint rows, so the solver adapts as cuts are added.

Constraints are stored as dense signed rows (B, R, n) — the cut matrices of
the ALP family are per-lane data, so A x / A^T y are batched GEMVs;
inactive rows are all-zero with rhs 0, which keeps their
duals at 0 automatically.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["pdhg_box_lp", "pdhg_steps"]


def pdhg_steps(a_rows, safety: float = 0.95, omega: float = 1.0):
    """Diagonal (Pock-Chambolle alpha=1) preconditioners, per lane.

    tau_j = omega / sum_i |A_ij|   (primal, (B, n));
    sigma_i = 1 / (omega * sum_j |A_ij|) (dual, (B, R)).
    Provably convergent for any constraint pattern and — unlike the scalar
    ||A||_1*||A||_inf bound — does not collapse when a few dense rows
    (AGC-ALP's Gaussian-eliminated cuts, ~n/2 nonzeros) join the buffer.
    Empty columns/rows get tau=1 / sigma=0 (a zero row's dual never moves).
    ``omega`` is the PDLP-style primal weight: it rebalances primal vs dual
    step sizes (tau*sigma is invariant, so convergence is unaffected) —
    useful when one space oscillates while the other crawls.
    """
    abs_a = jnp.abs(a_rows)
    row_sum = jnp.sum(abs_a, axis=-1)                  # (B, R)
    col_sum = jnp.sum(abs_a, axis=-2)                  # (B, n)
    tau = safety * omega / jnp.maximum(col_sum, 1.0)
    sigma = jnp.where(row_sum > 0,
                      safety / omega / jnp.maximum(row_sum, 1e-6), 0.0)
    return tau, sigma


def pdhg_box_lp(c, a_rows, b, x0, y0, iters: int, safety: float = 0.95,
                tol: float | None = None, check_every: int = 200,
                active=None, stall_ratio: float | None = None,
                average: bool = False, omega: float = 1.0):
    """Preconditioned PDHG steps, optionally tolerance-driven.
    Shapes: c,x0 (B,n); a_rows (B,R,n); b,y0 (B,R).

    With ``tol`` set, runs in ``check_every``-step chunks until the worst
    primal constraint violation across the batch falls below ``tol`` (or
    ``iters`` is reached) — adaptive LP cut loops need near-feasible
    solutions to avoid re-detecting the same cuts, and the iteration count
    that achieves this grows with the active row count, so a fixed budget
    either wastes time early or under-solves late. ``active``: optional
    (B,) bool; inactive lanes are excluded from the violation check (their
    x/y still step — callers freeze them by discarding the outputs).

    ``stall_ratio``: if set (e.g. 0.8), the chunk loop also stops once the
    batch-max violation improves by less than (1 - stall_ratio) over a
    chunk. Degenerate cut LPs (many near-parallel rows) give PDHG a
    violation *plateau* ~1e-2 that 20k+ iterations will not break — burning
    the full ``iters`` budget on a plateaued batch is pure waste, and the
    ALP cut loops tolerate plateau-quality solutions (their snapped cut
    search absorbs coordinate noise far above the plateau).

    ``average``: per chunk, also form the ergodic average of the chunk's
    iterates and keep, per lane, whichever of (last, average) has the
    smaller violation (PDLP-style restart-to-average — the average halves
    the oscillation plateau on degenerate cut LPs).

    Returns (x, y) when ``tol`` is None, else (x, y, err) with ``err`` the
    per-lane (B,) combined max(primal violation, relative duality gap) at
    exit — callers use it as the per-lane "LP actually converged (feasible
    AND optimal)" certificate. Warm-startable: pass previous (x, y).
    """
    tau, sigma = pdhg_steps(a_rows, safety, omega)
    # The batched matvecs are bandwidth-bound: HIGHEST precision (no TF32
    # or bf16 passes) adds arithmetic, not bytes, and keeps them f32-exact.
    hi = jax.lax.Precision.HIGHEST

    def step(xy):
        x, y = xy
        aty = jnp.einsum("brn,br->bn", a_rows, y,
                         preferred_element_type=jnp.float32, precision=hi)
        x_new = jnp.clip(x - tau * (c + aty), 0.0, 1.0)
        ax = jnp.einsum("brn,bn->br", a_rows, 2.0 * x_new - x,
                        preferred_element_type=jnp.float32, precision=hi)
        y_new = jnp.maximum(0.0, y + sigma * (ax - b))
        return x_new, y_new

    if tol is None:
        return jax.lax.fori_loop(0, iters, lambda _, xy: step(xy), (x0, y0))

    def lane_err(x, y):
        """Per-lane max(primal violation, relative duality gap). Primal
        feasibility alone is insufficient: a warm-started iterate can be
        feasible yet far from optimal, and ALP cut search at a suboptimal
        point generates junk cuts."""
        ax = jnp.einsum("brn,bn->br", a_rows, x,
                        preferred_element_type=jnp.float32, precision=hi)
        viol = jnp.max(jnp.maximum(ax - b, 0.0), axis=-1)
        aty = jnp.einsum("brn,br->bn", a_rows, y,
                         preferred_element_type=jnp.float32, precision=hi)
        rc = c + aty
        pobj = jnp.sum(c * x, axis=-1)
        dobj = (-jnp.sum(b * y, axis=-1)
                + jnp.sum(jnp.minimum(rc, 0.0), axis=-1))
        gap = (pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))
        v = jnp.maximum(viol, gap)
        if active is not None:
            v = jnp.where(active, v, 0.0)
        return v

    # a fixed chunk count with a predicated body: converged chunks are
    # skipped at run time, and the trip count stays static inside the
    # decoders' cut-round while_loop
    n_chunks = -(-iters // check_every)

    def chunk(_, carry):
        def run(carry):
            x, y, v, _ = carry
            if average:
                def astep(_, s):
                    x, y, sx, sy = s
                    x, y = step((x, y))
                    return x, y, sx + x, sy + y
                x, y, sx, sy = jax.lax.fori_loop(
                    0, check_every, astep,
                    (x, y, jnp.zeros_like(x), jnp.zeros_like(y)))
                xa, ya = sx / check_every, sy / check_every
                v_last, v_avg = lane_err(x, y), lane_err(xa, ya)
                take = (v_avg < v_last)
                x = jnp.where(take[:, None], xa, x)
                y = jnp.where(take[:, None], ya, y)
                return x, y, jnp.minimum(v_avg, v_last), jnp.max(v)
            x, y = jax.lax.fori_loop(0, check_every,
                                     lambda _, s: step(s), (x, y))
            return x, y, lane_err(x, y), jnp.max(v)
        x, y, v, vprev = carry
        vmax = jnp.max(v)
        go = vmax > tol
        if stall_ratio is not None:
            go &= (vmax < stall_ratio * vprev) | ~jnp.isfinite(vprev)
        return jax.lax.cond(go, run, lambda s: s, carry)

    x, y, v, _ = jax.lax.fori_loop(
        0, n_chunks, chunk,
        (x0, y0, lane_err(x0, y0), jnp.float32(jnp.inf)))
    return x, y, v


def pdhg_box_lp_shared(c, a, b, x0, y0, iters: int, safety: float = 0.95):
    """Preconditioned PDHG with a constraint matrix shared across the batch
    (FullLP case).

    c,x0: (B, n); a: (R, n) static; b: (R,); y0: (B, R). The products become
    true GEMMs, at HIGHEST precision like the batched solver's matvecs.
    """
    abs_a = jnp.abs(a)
    tau = safety / jnp.maximum(jnp.sum(abs_a, axis=0), 1.0)       # (n,)
    row_sum = jnp.sum(abs_a, axis=1)                              # (R,)
    sigma = jnp.where(row_sum > 0, safety / jnp.maximum(row_sum, 1e-6), 0.0)
    hi = jax.lax.Precision.HIGHEST

    def body(_, xy):
        x, y = xy
        x_new = jnp.clip(x - tau[None] * (c + jnp.dot(y, a, precision=hi)),
                         0.0, 1.0)
        y_new = jnp.maximum(0.0, y + sigma[None] * (
            jnp.dot(2.0 * x_new - x, a.T, precision=hi) - b[None]))
        return x_new, y_new

    return jax.lax.fori_loop(0, iters, body, (x0, y0))
