"""Decoder registry and factory."""
from __future__ import annotations

from .base import DecodeResult, Decoder
from .bp import BPDecoder
from .admm import ADMMStructure, QPADMMDecoder

__all__ = ["DecodeResult", "Decoder", "BPDecoder", "QPADMMDecoder",
           "ADMMStructure", "make_decoder", "default_batch",
           "DECODER_NAMES"]

DECODER_NAMES = ("bp", "qp-admm", "full-lp", "alp", "agc-alp")

# Starting defaults, not yet tuned on this card: BP scales to large
# batches; QP-ADMM's 512-iteration streaming granule wastes tail work on
# mostly-converged cohorts beyond ~1024 lanes; the ALP family keeps small
# cohorts so streaming refills stay prompt (AGC's IPM rounds are long).
DEFAULT_BATCH = {"bp": 8192, "qp-admm": 1024, "full-lp": 256,
                 "alp": 256, "agc-alp": 128}


def default_batch(kind: str) -> int:
    """Per-decoder default batch size (``DEFAULT_BATCH``)."""
    return DEFAULT_BATCH.get(kind.lower(), 256)


def make_decoder(kind: str, h, cfg=None):
    """Build a decoder by registry name using a DecoderConfig (or defaults)."""
    from ..config import DecoderConfig
    cfg = cfg or DecoderConfig()
    kind = kind.lower()
    if kind == "bp":
        return BPDecoder(h, max_iter=cfg.bp_max_iter, variant=cfg.bp_variant,
                         layout=cfg.bp_layout)
    if kind in ("qp-admm", "qpadmm", "admm"):
        return QPADMMDecoder(h, alpha=cfg.admm_alpha, mu=cfg.admm_mu,
                             max_iter=cfg.admm_max_iter,
                             eps_stop=cfg.admm_eps_stop)
    if kind in ("full-lp", "fulllp"):
        from .lp import FullLPDecoder
        return FullLPDecoder(h, iters=cfg.full_lp_iters,
                             int_tol=cfg.lp_int_tol)
    if kind == "alp":
        from .alp import ALPDecoder
        return ALPDecoder(h, max_rounds=cfg.lp_max_rounds, lp_iters=cfg.lp_iters,
                          int_tol=cfg.lp_int_tol)
    if kind in ("agc-alp", "agcalp", "agc"):
        from .agc_alp import AGCALPDecoder
        return AGCALPDecoder(h, max_rows=cfg.agc_max_rows,
                             max_rounds=cfg.lp_max_rounds,
                             lp_iters=cfg.lp_iters, int_tol=cfg.lp_int_tol)
    raise ValueError(f"unknown decoder {kind!r}; known: {DECODER_NAMES}")
