"""Batched decoder API.

The reference's decoder interface (``algo/algo.h:6-11``) is scalar:
``decode(H, y, snr) -> (codeword, certificate)`` per trial. Batched
decoders are *batched and specialized to H at construction time*: the graph /
constraint structure is extracted once on the host, and ``decode_batch`` is a
pure jittable function over a batch of channel LLRs.

Certificate (``success``) semantics per decoder, matching the reference:

* BP — converged to a valid codeword within ``max_iter`` (``algo/bp.h:191-198``)
* QP-ADMM — always True when the (alpha, mu) precondition holds
  (``algo/qp_admm.h:108-114,166``); the precondition is structure-level, so a
  failing configuration fails for the whole batch
* FullLP / ALP / AGC-ALP — the LP optimum was integral
  (``algo/full_lp.h:44-59``)
"""
from __future__ import annotations

from typing import NamedTuple, Protocol, runtime_checkable

import jax.numpy as jnp


class DecodeResult(NamedTuple):
    bits: jnp.ndarray       # (B, n) uint8 — hard decisions
    success: jnp.ndarray    # (B,) bool — decoder certificate
    iterations: jnp.ndarray  # (B,) int32 — iterations used (diagnostic)
    # (B,) int32 — resource-exhaustion telemetry; decoder-specific meaning
    # (ALP family: candidate cuts dropped by a full buffer — nonzero means
    # max_rows/capacity silently bound, raise them). None where N/A.
    dropped: jnp.ndarray | None = None


@runtime_checkable
class Decoder(Protocol):
    name: str
    n: int

    def decode_batch(self, llrs) -> DecodeResult:  # (B, n) float32 -> result
        ...
