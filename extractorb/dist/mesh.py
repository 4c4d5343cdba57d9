"""Device-mesh helpers.

The reference has no distributed backend at all (SURVEY.md §5.8: 4 CPU
threads + mutexes, src/System.cc:180-205).  This design scales
instead via SPMD over a 1-D jax.sharding.Mesh: bundle-adjustment
reductions ride psum, keyframe blocks shard over the mesh axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_leading(mesh: Mesh, axis: str = "shard"):
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
