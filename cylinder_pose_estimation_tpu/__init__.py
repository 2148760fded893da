"""Laser-grid cylinder pose estimation as one batched JAX program.

A from-scratch JAX/XLA rebuild of the capabilities of
cv3vpl-lab/cylinder-pose-estimation:
stereo laser-grid detection (ref: python_grid_detection_{plane,cylinder}.py,
utils/util_{plane,cylinder}.py) and the 3D geometry chain (ref: utils/*.m) as
one batched, jittable program over fixed-shape masked arrays.

Layer map (mirrors SURVEY.md §1, redesigned for a batched accelerator):
  ops/       -- image & numeric kernels (filters, morphology, labeling,
                batched polyfit, Levenberg-Marquardt) -- replaces the
                OpenCV/skimage/scipy primitives the reference calls.
  geometry/  -- transforms, triangulation, correspondence, curvature,
                cylinder fitting, pan/tilt kinematics, multi-frame
                registration -- replaces the MATLAB geometry chain.
  models/    -- the detection front-end (plane & cylinder model families)
                and end-to-end detect->correspond->triangulate->fit
                pipelines, vmappable over frames.
  parallel/  -- jax.sharding mesh / shard_map scaling over frame batches.
  utils/     -- host-side I/O (reference JSON contracts), synthetic
                ground-truth generation, visualization.
"""

from cylinder_pose_estimation_tpu import config, types
from cylinder_pose_estimation_tpu.config import (
    CylinderDetectConfig,
    DetectConfig,
    FitConfig,
    KinematicsConfig,
    PlaneDetectConfig,
    RegistrationConfig,
)
from cylinder_pose_estimation_tpu.types import (
    CameraModel,
    CylinderFitResult,
    DetectResult,
    GridPoints,
    StereoParams,
)

# Versioned public API surface (the functions a reference user needs):
# single-image detection, the stereo detect->fit step, batch / streaming
# serving, the full reference experiment, the per-frame cylinder fit, and
# the reference JSON I/O contracts.
from cylinder_pose_estimation_tpu.models.detector import detect_grid
from cylinder_pose_estimation_tpu.models.pose import fit_single_cylinder
from cylinder_pose_estimation_tpu.models.pipeline import (
    estimate_pose_stereo,
    estimate_poses_batch,
    estimate_poses_stream,
    full_experiment,
    register_sequence,
)
from cylinder_pose_estimation_tpu.utils import io

__all__ = [
    "config",
    "types",
    "io",
    "CylinderDetectConfig",
    "DetectConfig",
    "FitConfig",
    "KinematicsConfig",
    "PlaneDetectConfig",
    "RegistrationConfig",
    "CameraModel",
    "CylinderFitResult",
    "DetectResult",
    "GridPoints",
    "StereoParams",
    "detect_grid",
    "fit_single_cylinder",
    "estimate_pose_stereo",
    "estimate_poses_batch",
    "estimate_poses_stream",
    "full_experiment",
    "register_sequence",
]

__version__ = "0.1.0"
