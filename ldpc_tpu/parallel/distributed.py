"""Multi-host runtime initialization.

The reference is single-process (no MPI/NCCL/Gloo — SURVEY.md §2). Here
several hosts can share one trial mesh: call :func:`initialize_distributed`
once per host process before any JAX call; the counter reductions then
become collectives across hosts.

Pass the coordinator address, process count and process id explicitly
(also how a multi-process run is simulated on the CPU, with
``JAX_PLATFORMS=cpu``), or set ``auto=True`` to let
``jax.distributed.initialize()`` discover the cluster from its scheduler.
"""
from __future__ import annotations

import jax

__all__ = ["initialize_distributed", "is_multi_host", "process_index",
           "process_count"]


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           auto: bool = False) -> None:
    """Initialize jax.distributed when running multi-process.

    With explicit arguments, joins that cluster. With ``auto=True`` and no
    arguments, ``jax.distributed.initialize()`` detects the cluster itself
    (it raises where nothing describes one). With neither, or with
    ``num_processes <= 1``, this is a no-op: a single process.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None and not auto:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multi_host() -> bool:
    return jax.process_count() > 1


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()
