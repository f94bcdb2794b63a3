"""Device mesh + sharding helpers for trial-parallel experiments.

The reference's parallelism is 8 pthreads popping a mutex-guarded work queue
(``experiment.h:86-93,125-139``). Here the trial axis is sharded over a
1-D ``jax.sharding.Mesh`` over the devices; inputs carry a
``NamedSharding`` along the batch axis, the experiment step is ``jit``-ed once,
and XLA turns the final counter sums into ``psum`` collectives
(SURVEY.md §2, parallelism items 1-3).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["TrialSharding", "make_trial_mesh"]


@dataclass(frozen=True)
class TrialSharding:
    mesh: Mesh
    batch_sharding: NamedSharding   # (B, n) sharded on axis 0
    index_sharding: NamedSharding   # (B,)  sharded on axis 0
    replicated: NamedSharding

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.mesh.devices.shape))


def make_trial_mesh(devices=None, axis_name: str = "trials") -> TrialSharding:
    """1-D mesh over all (or given) devices, trial axis sharded."""
    devices = list(devices if devices is not None else jax.devices())
    mesh = Mesh(np.array(devices), (axis_name,))
    return TrialSharding(
        mesh=mesh,
        batch_sharding=NamedSharding(mesh, P(axis_name, None)),
        index_sharding=NamedSharding(mesh, P(axis_name)),
        replicated=NamedSharding(mesh, P()),
    )
