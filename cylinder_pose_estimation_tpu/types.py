"""Pytree data types flowing through the pipeline.

Ragged data in the reference (dict-of-label point lists, variable-length
correspondence arrays) becomes fixed-capacity arrays + validity masks so the
whole pipeline stays jit/vmap-compatible (SURVEY.md §7).  All types are
NamedTuples, hence automatically pytrees: they vmap/shard transparently.

Conventions:
  * 2D pixel coordinates are (x, y) float arrays of shape (..., 2) -- same
    axis order as the reference's OpenCV points and MATLAB grid matrices
    (ref utils/pointsStruct2mat.m:1-31: rows are [x, y, x_index, y_index]).
  * 3D points are row vectors, shape (..., N, 3) (the reference uses 3xN
    MATLAB matrices; we transpose to the JAX-natural layout).
  * Rigid transforms are (4, 4) with X_cam = T @ [X; 1].
  * Cylinder parameters are a flat (6,) [origin, direction] vector, matching
    the reference's cylParams (ref utils/fitCylinderWPts3.m:1-3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CameraModel(NamedTuple):
    """One pinhole camera with radial/tangential distortion.

    Mirrors the camera JSON schema the reference exchanges between MATLAB and
    Python (ref utils/createCameraDataJSON.m:7-12, utils/iotool.py:8-39):
    FocalLength, PrincipalPoint, RadialDistortion (k1..k3), TangentialDistortion.
    """

    k: jnp.ndarray          # (3, 3) intrinsics
    radial: jnp.ndarray     # (3,) k1, k2, k3
    tangential: jnp.ndarray  # (2,) p1, p2


class StereoParams(NamedTuple):
    """Stereo rig: intrinsics + the cam1->cam2 rigid transform.

    ``t_c2_c1`` maps camera-1 coordinates into camera-2 coordinates, matching
    the reference's T_C2_C1 = stereoParams.PoseCamera2.A usage
    (ref utils/getCamParams.m:9, exp_gridDetection.m:93: drawCylinder with
    T_C2_C1 * cylT in view 2).

    The optional calibration-session artifacts mirror the rest of
    getCamParams' outputs (ref utils/getCamParams.m:11-21): per-pattern
    camera<-pattern extrinsics and the pattern's world points.  They are not
    consumed by the experiment chain; ``None`` (the default) keeps the pytree
    free of dummy leaves.
    """

    cam1: CameraModel
    cam2: CameraModel
    t_c2_c1: jnp.ndarray    # (4, 4)
    t_c1_patterns: jnp.ndarray | None = None  # (P, 4, 4) T_C1_P per pattern
    t_c2_patterns: jnp.ndarray | None = None  # (P, 4, 4)
    calib_points: jnp.ndarray | None = None   # (N, 2) checkerboard WorldPoints


class GridPoints(NamedTuple):
    """Detected laser-grid intersection points for one image.

    The dense equivalent of the reference's N x 4 [x, y, x_index, y_index]
    matrix (ref utils/pointsStruct2mat.m) plus the JSON center point
    (ref utils/util_cylinder.py:1674-1727 make_json).
    """

    xy: jnp.ndarray         # (N, 2) float pixel coords
    idx: jnp.ndarray        # (N, 2) int32 (x_index, y_index) relative to center
    valid: jnp.ndarray      # (N,) bool
    center: jnp.ndarray     # (2,) float; the brightest grid point (origin)

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


class Correspondences(NamedTuple):
    """Matched stereo grid points (dense raster layout, see geometry.correspond)."""

    xy1: jnp.ndarray        # (M, 2)
    xy2: jnp.ndarray        # (M, 2)
    idx: jnp.ndarray        # (M, 2) int32 grid indices
    valid: jnp.ndarray      # (M,) bool
    used_fallback: jnp.ndarray  # () bool: patch consensus empty -> plain
                                # index matching (ref utils/chooseIdx.m:101-104)


class TriangulationResult(NamedTuple):
    points3: jnp.ndarray    # (M, 3) world points (camera-1 frame)
    reproj_error: jnp.ndarray  # (M,) mean two-view reprojection error [px]
    valid: jnp.ndarray      # (M,) bool


class CylinderFitResult(NamedTuple):
    """Output of the per-frame cylinder fit (ref utils/fitSingleCylinder.m).

    ``params0``/``params`` are the init/optimized [origin, direction] after the
    prior; ``fvals`` = (initial, final) sum of squared (dist - R) residuals,
    matching the reference's printed sqrt(fval) error (ref fitSingleCylinder.m:28).
    """

    params0: jnp.ndarray    # (6,)
    params: jnp.ndarray     # (6,)
    fvals: jnp.ndarray      # (2,)
    t_cam_cyl: jnp.ndarray  # (4, 4) cylinder->camera (ref utils/cylParams2T.m)
    mean_reproj_error: jnp.ndarray  # ()
    points3: jnp.ndarray    # (M, 3) triangulated points used by the fit
    points_valid: jnp.ndarray  # (M,)


class DetectResult(NamedTuple):
    """Full per-image detection output (device-side part).

    Host code converts this to the reference's grid-point JSON contract
    (ref utils/util_cylinder.py make_json) via utils/io.py.
    """

    grid: GridPoints
    ok: jnp.ndarray          # () bool: pipeline produced a usable grid
    roi_bbox: jnp.ndarray    # (4,) int32 x, y, w, h
    circle_radius0: jnp.ndarray  # () float; saturation-circle radius, feeds
                                 # adaptive constants (ref util_cylinder.py:2022)
    labels_converged: jnp.ndarray  # () bool: the final row/col labeling CC
                                 # reached its min-propagation fixpoint
                                 # (exact masked 3x3 min-pool check)
    max_line_tilt: jnp.ndarray   # () float rad: median |line tilt| from the
                                 # grid axes, max over rows/cols -- steep
                                 # diagonals are the documented chaotic
                                 # regime (PARITY.md, known deviations)
    stable: jnp.ndarray          # () bool: converged AND tilt within
                                 # cfg.max_stable_tilt; unstable frames are
                                 # masked by pipeline.frame_health
    bridged_components: jnp.ndarray  # () int32: fragment components MERGED
                                 # by line bridging (pre-bridge count minus
                                 # final count, both exact; end-of-line
                                 # extensions do not merge and do not
                                 # count).  Gap-bridged frames may re-rank
                                 # near gate boundaries -- log / downweight
                                 # them in deployments


class RegistrationResult(NamedTuple):
    """Multi-frame camera<->AGV registration (ref utils/fitCylinderWPts3sAngs.m)."""

    t_cam_agv: jnp.ndarray  # (4, 4)
    fval0: jnp.ndarray      # () initial objective
    fval: jnp.ndarray       # () final objective
    jtj_min_eig: jnp.ndarray  # () min eigenvalue of the 6-dof JtJ at the
                              # solution, per contributing frame, rotation
                              # block non-dimensionalized by the scene's RMS
                              # point radius (scale-free): ~5.5e-3 for a
                              # well-spread pan/tilt sweep, ~2.2e-4 when the
                              # along-axis translation goes gauge-flat
                              # (PARITY.md, known deviations)
    well_posed: jnp.ndarray   # () bool: jtj_min_eig >= config.min_observability
                              # -- False means t_cam_agv has a practically
                              # unconstrained direction (typically translation
                              # along the shared cylinder axis); demand a wider
                              # pan/tilt spread before trusting it
