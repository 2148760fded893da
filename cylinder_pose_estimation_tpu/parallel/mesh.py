"""Device mesh helpers.

The reference has no distributed runtime at all (SURVEY.md §2: the only
concurrency is intra-image thread pools); its scale axis is the *frame count*,
looped serially (ref exp_gridDetection.m:55, python_grid_detection_cylinder.py:32).
The scaling story is therefore pure data parallelism over frames on
a 1-D mesh, with one all-gather of per-frame fit outputs feeding the tiny
replicated 6-dof registration solve (SURVEY.md §5 "distributed communication
backend").  These helpers build that mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


FRAME_AXIS = "frames"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'frames'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (FRAME_AXIS,))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (frame) axis across the mesh."""
    return NamedSharding(mesh, PartitionSpec(FRAME_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
