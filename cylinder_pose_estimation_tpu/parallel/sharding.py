"""Sharded end-to-end pipelines over a device mesh.

Two equivalent expressions of the frame-parallel pipeline, both idiomatic
JAX/XLA (no NCCL/MPI translation -- the reference has none to translate,
SURVEY.md §5):

  * ``jit_sharded_pipeline``: GSPMD -- annotate the frame axis sharding on the
    batched program and let XLA insert the collectives.  The detection +
    per-frame fit stages are embarrassingly frame-parallel (zero
    communication); the multi-frame registration consumes all frames' points,
    which XLA lowers to one all-gather across the devices before the replicated 6-dof
    solve.
  * ``shard_map_pose``: explicit per-device shard_map for the
    detect->triangulate->fit stage, for cases where manual control of the
    collective schedule matters; returns per-frame results still sharded.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from cylinder_pose_estimation_tpu.config import (
    DetectConfig,
    FitConfig,
    RegistrationConfig,
)
from cylinder_pose_estimation_tpu.models.pipeline import (
    StereoPoseResult,
    estimate_poses_batch,
    full_experiment,
)
from cylinder_pose_estimation_tpu.parallel.mesh import (
    FRAME_AXIS,
    frame_sharding,
    replicated,
)
from cylinder_pose_estimation_tpu.types import RegistrationResult, StereoParams


def jit_sharded_pipeline(
    mesh: Mesh,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    reg_cfg: RegistrationConfig = RegistrationConfig(),
):
    """Compile the full multi-frame experiment with frame-axis sharding.

    Returns fn(images1, images2, angles) -> (StereoPoseResult, Registration).
    images*: (F, H, W[, 3]) with F divisible by the mesh size.
    """
    fs = frame_sharding(mesh)
    rep = replicated(mesh)

    fn = functools.partial(
        full_experiment,
        stereo=stereo,
        detect_cfg=detect_cfg,
        fit_cfg=fit_cfg,
        reg_cfg=reg_cfg,
    )
    return jax.jit(
        fn,
        in_shardings=(fs, fs, fs),
        out_shardings=(None, rep),
    )


def shard_map_pose(
    mesh: Mesh,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
):
    """Explicit shard_map variant of the batched detect->fit stage.

    Each device runs the pipeline on its local frame shard; outputs stay
    frame-sharded.  Communication-free by construction (the pose fit is
    per-frame), demonstrating the manual-collective style for later stages
    that need it.
    """

    def local(images1, images2):
        return estimate_poses_batch(images1, images2, stereo, detect_cfg, fit_cfg)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(FRAME_AXIS), P(FRAME_AXIS)),
            out_specs=P(FRAME_AXIS),
        )
    )
