"""Tracing, timing and device-report helpers (SURVEY.md §5).

The reference's only tracing is per-trial wall-clock around ``decode()``
(``experiment.h:100-103``). Here:

* :func:`trace` — context manager around any region, emitting a
  ``jax.profiler`` trace when a directory is given, else a no-op;
* :class:`Timer` — wall-clock section timing with ``block_until_ready``
  semantics for honest device timing;
* :class:`CompileClock` — seconds JAX spent tracing, lowering and
  compiling inside a region (JAX's own compile-duration events);
* :func:`require_gpu` and :func:`card_query` — the device a measurement
  ran on, and a refusal to measure anything but a CUDA card.
"""
from __future__ import annotations

import contextlib
import subprocess
import time

import jax

__all__ = ["trace", "Timer", "CompileClock", "require_gpu", "card_query",
           "peak_bytes"]

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """jax.profiler trace of the enclosed region when trace_dir is set."""
    if not trace_dir:
        yield
        return
    with jax.profiler.trace(trace_dir):
        yield


class Timer:
    """Accumulating wall-clock timer; ``stop`` blocks on device work."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, *arrays):
        if arrays:
            jax.block_until_ready(arrays)
        self.total += time.perf_counter() - self._t0
        self._t0 = None
        return self.total

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class CompileClock:
    """``with CompileClock() as cc: ...`` then ``cc.seconds``: the time JAX
    spent tracing, lowering to MLIR and compiling inside the block. A hit
    in the persistent compilation cache skips the backend compile."""

    _active: list["CompileClock"] = []
    _registered = False

    def __init__(self):
        self.seconds = 0.0

    @classmethod
    def _listen(cls, event, duration, **_):
        if event in _COMPILE_EVENTS:
            for clock in cls._active:
                clock.seconds += duration

    def __enter__(self):
        if not CompileClock._registered:
            jax.monitoring.register_event_duration_secs_listener(
                CompileClock._listen)
            CompileClock._registered = True
        CompileClock._active.append(self)
        return self

    def __exit__(self, *exc):
        CompileClock._active.remove(self)


def require_gpu():
    """The JAX devices, if the first is a CUDA card; else RuntimeError.
    A measurement that finds no card fails rather than timing a CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"no CUDA card: the first JAX device is "
                           f"{devices[0].platform!r}")
    return devices


def card_query() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line,
    from a child process that stays off JAX."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip()


def peak_bytes(device) -> int | None:
    """Peak bytes the process's arrays have held on ``device`` so far, or
    None where the backend keeps no memory statistics."""
    stats = device.memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])
