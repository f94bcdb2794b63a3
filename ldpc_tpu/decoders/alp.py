"""Adaptive LP decoding (ALP) with on-device cut generation.

Batched re-design of ``algo/alp.h``: start from the box LP whose optimum is
the hard decision on the LLRs (objective = channel LLRs, no parity rows,
``alp.h:110-121``), then repeatedly (a) search every check row for the most
violated odd-set parity cut (``AddRowsALP``, ``alp.h:21-97``), (b) append the
violated cuts into a fixed-capacity per-lane constraint buffer (masked write
— no dynamic shapes), and (c) re-solve the LP with warm-started batched PDHG
(:mod:`ldpc_tpu.ops.lp_solver`) — until no lane adds a cut or the round cap
hits. Certificate per ``DecodeFromLp`` (``full_lp.h:44-59``) plus the
is-codeword assertion (``alp.h:130-132``) folded into ``success``.

Cut search semantics (vectorized over (B, m, n) masks, exact transcription):
for each check row, V = {j in supp: u_j > 0.5}; if |V| is even, flip the
membership of the support position closest to 0.5 (first index on ties,
``alp.h:29-38,45-61``); the cut  sum_V x - sum_{supp \\ V} x <= |V| - 1  is
added iff  sum_V (1-u) + sum_{supp \\ V} u < 1 - tol  (``alp.h:63-94``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.gf2 import is_codeword
from ..ops.ipm_solver import ipm_box_lp
from ..ops.lp_solver import pdhg_box_lp
from .base import DecodeResult

__all__ = ["ALPDecoder", "alp_cut_candidates", "append_cuts", "LP_BACKENDS"]

# box-LP solvers of the cut loop: batched PDHG (ops.lp_solver) or the
# batched Mehrotra IPM (ops.ipm_solver)
LP_BACKENDS = ("xla", "ipm")


def alp_cut_candidates(sup, u, cut_tol: float):
    """Vectorized AddRowsALP cut search.

    sup: (..., m, n) bool support masks (static H rows broadcast, or per-lane
    eliminated rows); u: (B, n) current LP solution.
    Returns (rows (B, m, n) float32 signed cut rows, rhs (B, m) float32,
    add (B, m) bool).
    """
    u_b = u[:, None, :]                                   # (B, 1, n)
    sup = jnp.broadcast_to(sup, u_b.shape[:1] + sup.shape[-2:]) \
        if sup.ndim == 2 else sup
    n_size = jnp.sum(sup, axis=-1)                        # (B, m)
    dist = jnp.where(sup, jnp.abs(u_b - 0.5), jnp.inf)
    j_best = jnp.argmin(dist, axis=-1)                    # first min (B, m)
    in_v = sup & (u_b > 0.5)
    v_size = jnp.sum(in_v, axis=-1)
    flip = (v_size % 2 == 0)                              # (B, m)
    is_best = (jax.lax.broadcasted_iota(jnp.int32, sup.shape, sup.ndim - 1)
               == j_best[..., None])
    is_v = jnp.where(is_best & flip[..., None], u_b <= 0.5, u_b > 0.5) & sup
    viol = jnp.sum(jnp.where(is_v, 1.0 - u_b, jnp.where(sup, u_b, 0.0)),
                   axis=-1)
    add = (n_size > 0) & (viol < 1.0 - cut_tol)
    rows = jnp.where(is_v, 1.0, jnp.where(sup, -1.0, 0.0)).astype(jnp.float32)
    rhs = (jnp.sum(is_v, axis=-1) - 1).astype(jnp.float32)
    return rows, rhs, add


_HASH_SEED = 0x5DEECE66


def _hash_weights(n: int):
    rng = np.random.default_rng(_HASH_SEED)
    w1 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    w2 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    return jnp.asarray(w1), jnp.asarray(w2)


def cut_hashes(rows, w1, w2):
    """Two independent wraparound-int32 hashes of signed cut rows
    (B, m, n) -> ((B, m), (B, m)). Identical V-sets hash identically."""
    ri = rows.astype(jnp.int32)
    return (jnp.einsum("bmn,n->bm", ri, w1),
            jnp.einsum("bmn,n->bm", ri, w2))


def append_cuts(a_buf, rhs_buf, count, rows, rhs, add,
                hash_state=None, cand_hashes=None):
    """Masked append of candidate cuts into the per-lane buffers.

    a_buf (B, R, n) f32, rhs_buf (B, R), count (B,) int32; rows (B, m, n),
    rhs (B, m), add (B, m) bool. Overflowing cuts are dropped.

    When ``hash_state=(h1_buf, h2_buf)`` and ``cand_hashes=(h1c, h2c)`` are
    given, candidates identical to an already-active cut are suppressed and
    the appended cuts' hashes are recorded. This reproduces the exact-solver
    invariant (a cut satisfied by an exact LP re-solve is never re-added,
    so duplicates cannot occur — with a first-order solve, residual
    violations of ~solver-tolerance would otherwise re-add the same cut
    every round until the buffer bursts).

    Returns (a_buf, rhs_buf, count, n_added, n_dup, n_dropped, hash_state).
    """
    cap = a_buf.shape[1]
    bsz = a_buf.shape[0]
    n_dup = jnp.zeros((bsz,), jnp.int32)
    if hash_state is not None:
        h1_buf, h2_buf = hash_state
        h1c, h2c = cand_hashes
        slot = jax.lax.broadcasted_iota(jnp.int32, (bsz, cap), 1)
        active = slot < count[:, None]
        dup = jnp.any((h1c[:, :, None] == h1_buf[:, None, :]) &
                      (h2c[:, :, None] == h2_buf[:, None, :]) &
                      active[:, None, :], axis=-1)
        n_dup = jnp.sum(add & dup, axis=1).astype(jnp.int32)
        add = add & ~dup
    # target slot of each candidate (in row order), cap for dropped
    pos = count[:, None] + jnp.cumsum(add, axis=1) - add.astype(jnp.int32)
    pos = jnp.where(add & (pos < cap), pos, cap)
    a_buf = jax.vmap(lambda a, o, r: a.at[o].set(r, mode="drop"))(
        a_buf, pos, rows)
    rhs_buf = jax.vmap(lambda b, o, r: b.at[o].set(r, mode="drop"))(
        rhs_buf, pos, rhs)
    if hash_state is not None:
        h1_buf = jax.vmap(lambda b, o, r: b.at[o].set(r, mode="drop"))(
            h1_buf, pos, h1c)
        h2_buf = jax.vmap(lambda b, o, r: b.at[o].set(r, mode="drop"))(
            h2_buf, pos, h2c)
        hash_state = (h1_buf, h2_buf)
    n_added = jnp.sum(pos < cap, axis=1).astype(jnp.int32)
    n_dropped = jnp.sum(add, axis=1).astype(jnp.int32) - n_added
    return a_buf, rhs_buf, count + n_added, n_added, n_dup, n_dropped, \
        hash_state


class _AdaptiveLPBase:
    """Shared cut-loop driver for ALP and AGC-ALP."""

    use_gauss = False

    def __init__(self, h, max_rows: int, max_rounds: int, lp_iters: int,
                 int_tol: float, cut_tol: float = 1e-3,
                 snap_tol: float = 0.02, perturb: float = 1e-3,
                 lp_backend: str = "xla"):
        h = np.asarray(h, dtype=np.uint8) % 2
        self._h = jnp.asarray(h)
        self._sup = jnp.asarray(h.astype(bool))
        self.m, self.n = h.shape
        self.max_rows = int(max_rows)
        self.max_rounds = int(max_rounds)
        self.lp_iters = int(lp_iters)
        self.int_tol = float(int_tol)
        self.cut_tol = float(cut_tol)
        self.snap_tol = float(snap_tol)
        self.perturb = float(perturb)
        # IPM backend budget/tolerance (lp_backend="ipm"): ~35 Newton steps
        # reach mu ~ 1e-6; tol is on max(mu, |r_p|, |r_d|) in scaled units
        self.ipm_iters = 40
        self.ipm_tol = 1e-5
        # Newton-chunk granularity: the plateau stop rule needs two
        # consecutive non-improving chunk boundaries, so the minimum paid
        # work per solve is ~3*ipm_check_every steps (see ops.ipm_solver)
        self.ipm_check_every = 5
        # shifted warm start across cut rounds (see ops.ipm_solver)
        self.ipm_warm = True
        # adaptive inner-solve budget: chunks of lp_iters up to lp_max_iters,
        # stopping when the worst batch violation is below lp_tol. The cut
        # threshold must exceed the solve tolerance (cut_tol > lp_tol), else
        # residual violations on existing cuts read as fresh duplicates and
        # lanes never terminate.
        self.lp_tol = 3e-4
        self.lp_max_iters = max(8 * self.lp_iters, 4000)
        # chunk- and round-level stagnation threshold: stop solving /
        # terminate the lane when violation improves by <20% per step of
        # the respective loop (see the done rule and ops.lp_solver)
        self.stall_ratio = 0.8
        # static generic direction for the objective perturbation below
        rng = np.random.default_rng(0xC0FFEE)
        self._pert_dir = jnp.asarray(
            rng.uniform(-1.0, 1.0, self.n).astype(np.float32))
        # capacity: the reference checks `rows < max_rows` BEFORE a round and
        # lets the final round overshoot (agc_alp.h:99-101), so pad capacity
        # by up to 2m extra cuts; rounded up to a 128 multiple like every
        # rung of the tier ladder below
        self.capacity = -(-(self.max_rows + 2 * self.m) // 128) * 128
        # ladder of static LP row-slices, derived from the capacity rather
        # than hardcoded to one code's observed cut counts: fine 128-steps
        # while buffers are small (every lane starts there and most cut
        # activity happens in the first few hundred rows), 256-steps beyond
        # 512 where the marginal matvec cost per wasted row is amortized by
        # the rarity of lanes that deep. Works for any (m, n, max_rows).
        fine = list(range(128, min(512, self.capacity) + 1, 128))
        # coarse rungs: 256-step but phase-shifted to start at 640, so the
        # 896/1152 rungs sit under AGC's observed active-cut mass (~900-1150
        # of a 1408 cap), where 768/1024/1280 rungs overshot the matvec row
        # count by up to 16%
        coarse = list(range(640, self.capacity, 256))
        self._tiers = tuple(t for t in fine + coarse if t < self.capacity)
        if lp_backend not in LP_BACKENDS:
            raise ValueError(f"unknown lp_backend {lp_backend!r}; "
                             f"known: {LP_BACKENDS}")
        self.lp_backend = lp_backend
        # the cut threshold must exceed the solver's coordinate noise, else
        # residual violations on existing cuts read as fresh cuts and lanes
        # never terminate; the binding noise floor is the backend's
        assert self.cut_tol > (self.ipm_tol if lp_backend == "ipm"
                               else self.lp_tol), "cut_tol below solver tol"
        self._hash_w = _hash_weights(self.n)
        self._decode = jax.jit(self._decode_impl)

    # subclass hook: support masks of the solution-adapted (eliminated) H,
    # used as the extra cut source for lanes whose H-cut count was zero;
    # ``need`` (B,) bool marks the lanes whose output will actually be used
    def _gauss_sup(self, x, need=None):
        raise NotImplementedError

    def _init_state(self, llrs) -> dict:
        """Fresh per-lane cut-loop state (also the streaming protocol's
        ``stream_init``)."""
        bsz = llrs.shape[0]
        c = jnp.asarray(llrs, jnp.float32)
        cap = self.capacity
        # Generic objective perturbation (relative, ~0.1%): the simplex the
        # reference uses always lands on a *vertex*; a first-order method
        # converges to an interior point of the optimal face, where the
        # odd-set cut search finds far fewer violated cuts (cuts separate
        # vertices). A tiny generic tilt makes the optimum a unique vertex
        # almost surely — the classic lexicographic-perturbation trick.
        if self.perturb:
            scale = jnp.mean(jnp.abs(c), axis=1, keepdims=True)
            c = c + self.perturb * scale * self._pert_dir[None]
        return {
            "c": c,
            "x": (c < 0.0).astype(jnp.float32),   # exact box-LP optimum
            "y": jnp.zeros((bsz, cap), jnp.float32),
            "a": jnp.zeros((bsz, cap, self.n), jnp.float32),
            "rhs": jnp.zeros((bsz, cap), jnp.float32),
            "count": jnp.zeros((bsz,), jnp.int32),
            "done": jnp.zeros((bsz,), bool),
            "viol": jnp.zeros((bsz,), jnp.float32),
            "viol_prev": jnp.full((bsz,), jnp.inf, jnp.float32),
            "dropped": jnp.zeros((bsz,), jnp.int32),
            "rounds": jnp.zeros((bsz,), jnp.int32),
            "cum_h": jnp.zeros((bsz,), jnp.int32),   # H cuts appended
            "cum_g": jnp.zeros((bsz,), jnp.int32),   # gauss cuts appended
            "h1": jnp.zeros((bsz, cap), jnp.int32),
            "h2": jnp.zeros((bsz, cap), jnp.int32),
        }

    def _round_body(self, state: dict) -> dict:
        """One cut round (search + append + re-solve) over a state dict —
        shared by the batched while_loop and the streaming chunk path."""
        bsz = state["x"].shape[0]
        cap = self.capacity
        w1, w2 = self._hash_w
        c = state["c"]
        (x, y, a_buf, rhs_buf, count, done, viol, viol_prev, dropped,
         lane_rounds, hstate) = (
            state["x"], state["y"], state["a"], state["rhs"],
            state["count"], state["done"], state["viol"],
            state["viol_prev"], state["dropped"], state["rounds"],
            (state["h1"], state["h2"]))
        # per-lane diagnostic: rounds in which this lane actually worked
        lane_rounds = lane_rounds + (~done).astype(jnp.int32)
        eligible = ~done & (count < self.max_rows)
        # Snap near-integral coordinates to exactly 0/1 for cut *search*
        # (LP state itself is untouched). The simplex the reference uses
        # returns exact vertex solutions; a first-order solve leaves
        # ~1e-2 noise on every coordinate, which accumulates across a
        # wide cut row's support and masks genuinely violated cuts —
        # especially AGC's dense Gaussian-eliminated rows.
        x_s = jnp.where(x < self.snap_tol, 0.0,
                        jnp.where(x > 1.0 - self.snap_tol, 1.0, x))

        def tier_solve(obj, a_b, r_b, xx, yy, act, r_max):
            """PDHG solve of min obj.x s.t. a_b[:, :R] x <= r_b[:, :R],
            box — on the smallest static row-tier covering r_max (see
            the re-solve comment below for why tiers exist)."""
            def solve_tier(t):
                def run(args):
                    obj_, a_t, rhs_t, xx_, yy_, act_ = args
                    if self.lp_backend == "ipm":
                        # batched Mehrotra IPM: converges to ~1e-5
                        # coordinates where PDHG plateaus at ~1e-2 —
                        # exact-solver-grade cut-search points (the
                        # AGC-ALP FER-parity fix; see ops.ipm_solver)
                        warm = ({"x0": xx_, "y0": yy_[:, :t]}
                                if self.ipm_warm else {})
                        x_t, y_t, v_t = ipm_box_lp(
                            obj_, a_t[:, :t], rhs_t[:, :t],
                            iters=self.ipm_iters, tol=self.ipm_tol,
                            check_every=self.ipm_check_every,
                            active=act_, **warm)
                    else:
                        x_t, y_t, v_t = pdhg_box_lp(
                            obj_, a_t[:, :t], rhs_t[:, :t], xx_,
                            yy_[:, :t], self.lp_max_iters,
                            tol=self.lp_tol, check_every=self.lp_iters,
                            active=act_, stall_ratio=self.stall_ratio)
                    return x_t, yy_.at[:, :t].set(y_t), v_t
                return run

            tiers = [t for t in self._tiers if t < cap] + [cap]
            tier_idx = sum((r_max > t).astype(jnp.int32)
                           for t in tiers[:-1])
            return jax.lax.switch(
                tier_idx, [solve_tier(t) for t in tiers],
                (obj, a_b, r_b, xx, yy, act))

        rows, rhs, add = alp_cut_candidates(self._sup, x_s, self.cut_tol)
        add_h = add & eligible[:, None]
        a_buf, rhs_buf, count, n_h, d_h, drop_h, hstate = append_cuts(
            a_buf, rhs_buf, count, rows, rhs, add_h,
            hash_state=hstate, cand_hashes=cut_hashes(rows, w1, w2))
        dropped = dropped + drop_h
        if self.use_gauss:
            # short-circuit semantics (agc_alp.h:99-101): gauss cuts only
            # for lanes that added no H cuts this round; skip the whole
            # (expensive) elimination when no lane needs it
            need = eligible & (n_h == 0)

            def with_gauss(args):
                a_b, r_b, cnt, hs = args
                x_g = x_s
                g_sup = self._gauss_sup(x_g, need)
                # gauss rows are dense (~n/2 support): the violation sum
                # accumulates LP plateau noise over ~140 coordinates
                # (sigma ~ 0.07), so cuts an exact solver would find read
                # as unviolated. gauss_margin relaxes the acceptance
                # threshold; odd-set cuts from GF(2) row combinations are
                # valid inequalities whether or not currently violated,
                # so near-violated cuts are sound to add.
                g_tol = self.cut_tol - getattr(self, "gauss_margin", 0.0)
                g_rows, g_rhs, g_add = alp_cut_candidates(
                    g_sup, x_g, g_tol)
                g_add = g_add & need[:, None]
                return append_cuts(a_b, r_b, cnt, g_rows, g_rhs, g_add,
                                   hash_state=hs,
                                   cand_hashes=cut_hashes(g_rows, w1, w2))

            def without_gauss(args):
                a_b, r_b, cnt, hs = args
                return (a_b, r_b, cnt, jnp.zeros_like(n_h),
                        jnp.zeros_like(n_h), jnp.zeros_like(n_h), hs)

            a_buf, rhs_buf, count, n_g, d_g, drop_g, hstate = \
                jax.lax.cond(jnp.any(need), with_gauss, without_gauss,
                             (a_buf, rhs_buf, count, hstate))
            n_added = n_h + n_g
            cum_g = state["cum_g"] + n_g
            n_dups = d_h + d_g
            dropped = dropped + drop_g
        else:
            n_added = n_h
            n_dups = d_h
            cum_g = state["cum_g"]
        # a lane is finished when its cut search yields no NEW cut and
        # its LP solve is as good as it will get: either converged
        # (violation below lp_tol) or *plateaued* (violation stopped
        # improving across rounds — degenerate cut LPs give PDHG a
        # ~1e-2 violation floor that no iteration budget breaks; the
        # snapped cut search absorbs noise far above it, so plateaued
        # lanes behave exactly like converged ones for cut discovery).
        # Duplicate candidates never keep a lane alive: the snapped
        # solution re-violates existing cuts by up to snap_tol*|supp|,
        # which an exact solver would never re-find (round-1's
        # dup-polish rule made every lane spin to max_rounds).
        stalled = viol >= self.stall_ratio * viol_prev
        done = done | ((n_added == 0) &
                       ((viol <= self.lp_tol) | stalled))
        # re-solve for lanes that changed; frozen lanes keep their x, y.
        # PDHG runs on the smallest static row-slice of the buffer that
        # covers every lane's active cuts (lax.switch over geometric
        # tiers): rows >= max(count) are identically zero and contribute
        # nothing, but a full-capacity matvec would still stream them
        # from HBM — at typical cut counts (p99 ~275 ALP / ~1150 AGC,
        # <200 at high SNR) that is a 3-13x bandwidth waste.
        r_max = jnp.max(jnp.where(done, 0, count))
        act = ~done
        x_new, y_new, viol_new = tier_solve(c, a_buf, rhs_buf, x, y,
                                            act, r_max)
        keep = done[:, None]
        x = jnp.where(keep, x, x_new)
        y = jnp.where(keep, y, y_new)
        # viol_prev must stay inert (inf) until TWO real solves exist:
        # a lane's first worked round enters with the trivial viol0=0 of
        # the unconstrained box optimum, and 0.8*0 = 0 would make the
        # next round's stagnation test trivially true — terminating any
        # lane whose first re-search found no cut after a single
        # (possibly plateau-quality) solve. The second worked round
        # makes the first real solve-vs-solve comparison. (Per-lane:
        # streaming refills restart lanes mid-batch.)
        viol_prev = jnp.where(lane_rounds == 1, jnp.inf, viol)
        viol = jnp.where(done, 0.0, viol_new)
        # per-lane round budget (the batched path's former global cond)
        done = done | (lane_rounds >= self.max_rounds)
        return {"c": c, "x": x, "y": y, "a": a_buf, "rhs": rhs_buf,
                "count": count, "done": done, "viol": viol,
                "viol_prev": viol_prev, "dropped": dropped,
                "rounds": lane_rounds, "cum_h": state["cum_h"] + n_h,
                "cum_g": cum_g, "h1": hstate[0], "h2": hstate[1]}

    def _run_loop(self, llrs) -> dict:
        state = self._init_state(llrs)
        final = jax.lax.while_loop(
            lambda s: ~jnp.all(s["done"]), self._round_body, state)
        # full final state; jitted callers slice what they need (XLA DCEs
        # the big buffers out of programs that don't fetch them)
        return final

    def _decode_impl(self, llrs) -> DecodeResult:
        return self._finish(self._run_loop(llrs))

    def _finish(self, st: dict) -> DecodeResult:
        x = st["x"]
        bits = (x > 0.5).astype(jnp.uint8)
        integral = jnp.all((x < self.int_tol) | (x > 1.0 - self.int_tol),
                           axis=-1)
        success = integral & is_codeword(self._h, bits)
        return DecodeResult(bits=bits, success=success,
                            iterations=st["rounds"],
                            dropped=st["dropped"])

    def decode_batch(self, llrs) -> DecodeResult:
        return self._decode(llrs)

    # ------------------------------------------------------------------
    # Streaming protocol (harness.experiment.run_streaming_experiment):
    # one chunk = one cut round; converged lanes drain between rounds and
    # their 100 MB-scale buffer slots refill from the trial stream, so
    # straggler lanes (64-round spinners) stop holding whole batches.
    def stream_init(self, llrs) -> dict:
        return self._init_state(llrs)

    def stream_chunk(self, st: dict) -> dict:
        return jax.lax.cond(jnp.all(st["done"]), lambda s: s,
                            self._round_body, st)

    def stream_done(self, st: dict):
        return st["done"]

    def stream_finish(self, st: dict) -> DecodeResult:
        return self._finish(st)

    def stats(self, llrs):
        """Cut-loop telemetry for tuning: per-lane final active-cut count,
        per-lane rounds worked, integrality, per-lane done flag."""
        if not hasattr(self, "_run_loop_jit"):
            self._run_loop_jit = jax.jit(self._run_loop)
        st = self._run_loop_jit(llrs)
        x = st["x"]
        integral = jnp.all((x < self.int_tol) | (x > 1.0 - self.int_tol),
                           axis=-1)
        return {"count": st["count"], "rounds": st["rounds"],
                "integral": integral, "done": st["done"],
                "viol": st["viol"], "dropped": st["dropped"],
                "cum_h": st["cum_h"], "cum_g": st["cum_g"]}


class ALPDecoder(_AdaptiveLPBase):
    """Adaptive LP decoder (``ALPDecoder``, ``alp.h:99-138``). The reference
    has no row cap for plain ALP; ``max_rows`` defaults high enough to never
    bind in practice.

    Defaults: 64-iteration PDHG chunks with a 2048-iteration budget (FER
    within Monte-Carlo noise of the older 100/4000), and the batched runner
    preferred over streaming — ALP's cut rounds are narrow (mean 11 / max
    17 at −3 dB), so draining stragglers buys less than the streaming
    refill machinery costs. Neither choice has been re-tuned on a GPU.
    """

    use_gauss = False
    # opt out of run_experiment's auto-streaming (see class docstring)
    prefer_streaming = False

    def __init__(self, h, max_rounds: int = 64, lp_iters: int = 64,
                 int_tol: float = 3e-2, max_rows: int | None = None,
                 cut_tol: float = 1e-3, lp_backend: str = "xla"):
        if max_rows is None:
            # derived, not hardcoded: the reference ALP has NO row cap, so
            # the default must scale with the code — one cut round can add
            # up to m cuts, and a cap below ~2m binds on larger codes
            # (H02's m=520 deadlocked the old flat 512 in a single round)
            max_rows = max(512, 2 * int(np.asarray(h).shape[0]))
        super().__init__(h, max_rows=max_rows, max_rounds=max_rounds,
                         lp_iters=lp_iters, int_tol=int_tol, cut_tol=cut_tol,
                         lp_backend=lp_backend)
        self.lp_max_iters = 2048
        self.name = "ALP"
