"""Differential tests for the batched interior-point LP solver.

Oracle: scipy.optimize.linprog (HiGHS) on the same  min c.x, Ax<=b, 0<=x<=1
instances — random signed-ternary cut-style rows (the ALP family's
constraint structure) plus generic dense rows.
"""
import numpy as np
import pytest
import jax.numpy as jnp
from scipy.optimize import linprog

from ldpc_tpu.ops.ipm_solver import ipm_box_lp


def _rand_cut_lp(rng, n, r_active, r_cap, dense=False):
    """One lane: signed ternary rows (odd-set-cut-like) with feasible rhs."""
    a = np.zeros((r_cap, n), np.float32)
    b = np.zeros((r_cap,), np.float32)
    for i in range(r_active):
        supp = rng.choice(n, size=(n // 2 if dense else rng.integers(3, 9)),
                          replace=False)
        sgn = rng.choice([-1.0, 1.0], size=supp.size)
        if sgn.sum() <= -sgn.size:       # keep at least one +1
            sgn[0] = 1.0
        a[i, supp] = sgn
        b[i] = np.sum(sgn > 0) - 1       # odd-set cut rhs form
    c = rng.normal(0.0, 4.0, n).astype(np.float32)
    return a, b, c


@pytest.mark.parametrize("dense", [False, True])
def test_ipm_matches_highs(dense):
    rng = np.random.default_rng(7 + dense)
    n, r_cap, bsz = 24, 32, 8
    aa, bb, cc = [], [], []
    for _ in range(bsz):
        a, b, c = _rand_cut_lp(rng, n, rng.integers(4, 20), r_cap, dense)
        aa.append(a), bb.append(b), cc.append(c)
    aa, bb, cc = map(np.stack, (aa, bb, cc))

    x, y, err = ipm_box_lp(jnp.asarray(cc), jnp.asarray(aa), jnp.asarray(bb),
                           iters=40)
    x, err = np.asarray(x), np.asarray(err)

    for i in range(bsz):
        ref = linprog(cc[i], A_ub=aa[i], b_ub=bb[i], bounds=(0, 1),
                      method="highs")
        assert ref.status == 0
        ours = float(cc[i] @ x[i])
        scale = 1.0 + abs(ref.fun)
        # objective matches HiGHS to ~1e-4 relative
        assert abs(ours - ref.fun) / scale < 3e-4, (i, ours, ref.fun)
        # primal feasibility
        assert np.max(aa[i] @ x[i] - bb[i]) < 1e-4
        assert err[i] < 1e-3


def test_ipm_active_mask_freezes_check():
    """Inactive lanes may be arbitrarily hard; they must not gate the
    convergence check (err reported 0)."""
    rng = np.random.default_rng(3)
    n, r_cap = 16, 16
    a, b, c = _rand_cut_lp(rng, n, 10, r_cap)
    aa = np.stack([a, a])
    bb = np.stack([b, np.full_like(b, 0.0)])   # lane 1: tighter rhs
    cc = np.stack([c, c])
    x, y, err = ipm_box_lp(jnp.asarray(cc), jnp.asarray(aa), jnp.asarray(bb),
                           iters=30, active=jnp.asarray([True, False]))
    assert float(err[1]) == 0.0
    ref = linprog(c, A_ub=a, b_ub=b, bounds=(0, 1), method="highs")
    assert abs(float(cc[0] @ np.asarray(x)[0]) - ref.fun) / \
        (1.0 + abs(ref.fun)) < 3e-4


def test_ipm_box_only():
    """No active rows at all (round-0 box LP): optimum is the hard decision
    x_j = 1[c_j < 0], recovered to tight accuracy."""
    rng = np.random.default_rng(11)
    c = rng.normal(0.0, 5.0, (4, 20)).astype(np.float32)
    a = np.zeros((4, 8, 20), np.float32)
    b = np.zeros((4, 8), np.float32)
    x, _, err = ipm_box_lp(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                           iters=30)
    x = np.asarray(x)
    np.testing.assert_allclose(x, (c < 0).astype(np.float32), atol=1e-3)
    assert np.all(np.asarray(err) < 1e-3)


def test_ipm_warm_start_matches_cold():
    """A shifted warm start from a perturbed solution reaches the same
    optimum (same objective to ~1e-4) as a cold start."""
    rng = np.random.default_rng(21)
    n, r_cap, bsz = 24, 32, 4
    aa, bb, cc = [], [], []
    for _ in range(bsz):
        a, b, c = _rand_cut_lp(rng, n, 12, r_cap)
        aa.append(a), bb.append(b), cc.append(c)
    aa, bb, cc = map(np.stack, (aa, bb, cc))
    xc, yc, ec = ipm_box_lp(jnp.asarray(cc), jnp.asarray(aa),
                            jnp.asarray(bb), iters=40)
    x0 = jnp.clip(xc + 0.05, 0.0, 1.0)
    xw, yw, ew = ipm_box_lp(jnp.asarray(cc), jnp.asarray(aa),
                            jnp.asarray(bb), iters=40, x0=x0, y0=yc)
    oc = np.sum(np.asarray(cc) * np.asarray(xc), axis=1)
    ow = np.sum(np.asarray(cc) * np.asarray(xw), axis=1)
    np.testing.assert_allclose(ow, oc, atol=1e-3)
    assert np.all(np.asarray(ew) < 1e-3)
