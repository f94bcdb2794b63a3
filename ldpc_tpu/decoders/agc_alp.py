"""AGC-ALP: adaptive LP decoding with Adaptive Cut Generation
(paper IEEE 6218777; reference ``algo/agc_alp.h``).

Extends ALP with a second cut source: each round, for lanes where the
original H yielded no violated cut, H is GF(2)-Gaussian-eliminated with
columns ordered most-fractional-first w.r.t. the current LP solution
(``CalculateGauss``, ``agc_alp.h:19-74``), and the cut search runs over the
eliminated rows. The loop stops per lane when the total LP row count reaches
``max_rows`` (1000 in the reference benchmark, ``main.cpp:38``) or no cut
source fires (``agc_alp.h:99-101``, including the ``||`` short-circuit: gauss
cuts are only generated when zero H cuts were added that round).

The elimination backend follows the platform policy
(:func:`ldpc_tpu.ops.gf2_gauss.resolve_gauss_backend`): on a GPU the
Triton kernel (:mod:`ldpc_tpu.ops.pallas.gauss_kernel`), which skips the
lanes that need no gauss cuts this round; elsewhere the batched XLA loop.
"""
from __future__ import annotations

from ..ops.gf2_gauss import calculate_gauss_batched, resolve_gauss_backend
from .alp import _AdaptiveLPBase

__all__ = ["AGCALPDecoder"]


class AGCALPDecoder(_AdaptiveLPBase):
    use_gauss = True

    def __init__(self, h, max_rows: int = 1000, max_rounds: int = 64,
                 lp_iters: int = 100, int_tol: float = 3e-2,
                 cut_tol: float = 3e-4, gauss_eps: float = 1e-8,
                 gauss_margin: float = 0.0, snap_tol: float = 0.0,
                 lp_backend: str = "ipm", gauss_backend: str = "auto"):
        # Defaults are the FER-parity configuration (round 3): the exact-
        # grade IPM backend with *reference* cut semantics — no snapping, no
        # cut-threshold slack, gauss fractionality eps at the reference's
        # EPS=1e-8 (utils/channel.h:10). The PDHG-era compensations
        # (snap_tol=0.02, cut_tol=1e-3, gauss_eps=1e-3) mask genuinely
        # violated cuts and lose the 1000-row budget race on hard frames
        # (z up to +9 vs report_opt.csv); with IPM's ~1e-5 coordinates they
        # are unnecessary and harmful. See VALIDATION.md.
        super().__init__(h, max_rows=max_rows, max_rounds=max_rounds,
                         lp_iters=lp_iters, int_tol=int_tol, cut_tol=cut_tol,
                         snap_tol=snap_tol, lp_backend=lp_backend)
        self.name = "AGC-ALP"
        self.gauss_eps = float(gauss_eps)
        self.gauss_margin = float(gauss_margin)
        self.gauss_backend = resolve_gauss_backend(gauss_backend, self.m,
                                                   self.n)

    def _gauss_sup(self, x, need=None):
        he = calculate_gauss_batched(self._h, x, self.gauss_eps,
                                     active=need,
                                     backend=self.gauss_backend)
        return he.astype(bool)
