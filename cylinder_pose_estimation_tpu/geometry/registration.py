"""Multi-frame camera <-> AGV registration (ref utils/fitCylinderWPts3sAngs.m).

Given F frames of triangulated cylinder-surface points and the AGV's pan/tilt
angles per frame, solve for T_Cam_AGV such that the kinematically predicted
cylinder axis (T * T_AGV_cyl(pan, tilt), axis = its y column) explains all
frames' points at the known radius.

Reference structure preserved:
  1. per-frame kinematic poses + per-frame data-driven cylinder fits with the
     prior applied (ref :29-38);
  2. closed-form initialization from frames 1 & 2 via a triad construction
     aligning (frame-1 axis, origin-displacement direction) between the two
     coordinate systems (ref :51-69);
  3. refinement of the 6-dof [rotvec, t] pose over the objective
     sum_f mean_i (dist(pts_f,i -> predicted axis_f) - R)^2 (ref :71-94).

Batched redesign: frames are a batch axis, not a loop.  The final objective
consumes raw points only (SURVEY.md §3.5) -- expressed here as one masked
residual tensor of shape (F, N) with per-frame 1/sqrt(n_f) weights so LM's SSE
equals the reference's sum-of-means; per-frame fits feed *only* the
initialization, exactly like the reference.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.ops.linalg import mm

from cylinder_pose_estimation_tpu.config import RegistrationConfig
from cylinder_pose_estimation_tpu.geometry import transforms
from cylinder_pose_estimation_tpu.geometry.cylinder import (
    apply_prior,
    dist_points_to_line,
    fit_cylinder,
)
from cylinder_pose_estimation_tpu.geometry.kinematics import t_agv_cyl
from cylinder_pose_estimation_tpu.types import RegistrationResult

_EPS = 1e-12


def _normalize(v: jnp.ndarray) -> jnp.ndarray:
    return v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + _EPS)


def _triad_init(
    t_agv_cyls: jnp.ndarray, cyl_params_f0: jnp.ndarray
) -> jnp.ndarray:
    """Closed-form T0 from frames 0 & 1 (ref utils/fitCylinderWPts3sAngs.m:51-69).

    Aligns the frame-0 cylinder axis and the origin-displacement direction
    between the AGV-kinematic and camera-estimated coordinate systems.
    ``cyl_params_f0`` holds the fitted [origin, direction] for frames 0 and 1,
    shape (2, 6).
    """
    p1 = t_agv_cyls[0, :3, 3]
    p2 = t_agv_cyls[1, :3, 3]
    ep1 = cyl_params_f0[0, :3]
    ep2 = cyl_params_f0[1, :3]

    d12 = p2 - p1
    y_agv = t_agv_cyls[0, :3, 1]
    nd = _normalize(jnp.cross(y_agv, d12))

    ed12 = ep2 - ep1
    # Normalizing keeps the triad R orthonormal (the reference feeds the raw
    # post-fminsearch direction, whose norm drifts: ref :62).
    dir_cam = _normalize(cyl_params_f0[0, 3:6])
    end = _normalize(jnp.cross(dir_cam, ed12))

    basis_cam = jnp.stack([dir_cam, end, jnp.cross(dir_cam, end)], axis=-1)
    basis_agv = jnp.stack([y_agv, nd, jnp.cross(y_agv, nd)], axis=-1)
    # MATLAB: R = basis_cam / basis_agv  ==  basis_cam @ inv(basis_agv)
    r = mm(basis_cam, jnp.linalg.inv(basis_agv))
    t = ep1 - mm(r, p1)
    top = jnp.concatenate([r, t[:, None]], axis=-1)
    return jnp.concatenate(
        [top, jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=r.dtype)], axis=0
    )


def registration_residuals(
    pose6: jnp.ndarray,
    t_agv_cyls: jnp.ndarray,
    pts3s: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float,
) -> jnp.ndarray:
    """Masked residual tensor (F, N): dist to predicted axis minus radius.

    Weighted by 1/sqrt(n_f) per frame so sum(w r^2) = sum_f mean_i r^2,
    matching ref dist() (ref utils/fitCylinderWPts3sAngs.m:82-94).
    Invalid entries return exactly 0 so they drop out of the SSE *and* its
    Jacobian.
    """
    t = transforms.vec_to_transform(pose6)
    t_cam_cyl = mm(t, t_agv_cyls)                   # (F, 4, 4)
    origins = t_cam_cyl[:, :3, 3]
    dirs = t_cam_cyl[:, :3, 1]                      # y column = axis
    d = jax.vmap(dist_points_to_line)(pts3s, origins, dirs)  # (F, N)
    r = d - radius
    n = jnp.maximum(jnp.sum(valid, axis=-1, keepdims=True), 1)
    w = jnp.where(valid, 1.0 / jnp.sqrt(n.astype(r.dtype)), 0.0)
    return (r * w).reshape(-1)


def fit_cylinders_with_angles(
    pts3s: jnp.ndarray,
    valid: jnp.ndarray,
    angles: jnp.ndarray,
    config: RegistrationConfig = RegistrationConfig(),
    frame_valid: jnp.ndarray | None = None,
) -> RegistrationResult:
    """Full multi-frame registration (ref utils/fitCylinderWPts3sAngs.m:1-94).

    pts3s: (F, N, 3) per-frame triangulated points (camera-1 frame), masked by
    valid (F, N); angles: (F, 2) [pan, tilt] radians.  F >= 2 (static shape).

    ``frame_valid`` (F,) optionally masks out whole frames (failed detection /
    degenerate fits): their residuals drop from the objective and the
    closed-form init is built from the first two *valid* frames.  The
    reference has no equivalent -- one bad frame poisons its fminsearch
    (SURVEY.md §5 failure detection: degraded modes become explicit masks
    here).  If fewer than 2 frames are valid, the mask is ignored (degraded
    fallback, keeps the solve well-posed).
    """
    assert pts3s.shape[0] >= 2, "registration needs >= 2 frames (ref :18)"
    radius = config.cyl_radius
    f_total = pts3s.shape[0]

    if frame_valid is None:
        frame_valid = jnp.ones((f_total,), bool)
    enough = jnp.sum(frame_valid) >= 2
    frame_valid = frame_valid | ~enough
    valid = valid & frame_valid[:, None]

    t_agv_cyls = t_agv_cyl(angles[:, 0], angles[:, 1], config.kinematics)

    # First two valid frames feed the init (the reference hardcodes frames
    # 0 & 1, ref :51; picking valid ones keeps the triad meaningful when a
    # leading frame failed).
    order = jnp.argsort(
        jnp.where(frame_valid, 0, f_total) + jnp.arange(f_total)
    )[:2]
    init_pts = pts3s[order]
    init_val = valid[order]
    init_kin = t_agv_cyls[order]

    # Per-frame fits (only the two init frames feed the triad, exactly like
    # the reference's use of its loop results at ref :51-69).
    def per_frame(pts, v):
        f = fit_cylinder(pts, v, radius)
        return apply_prior(f.params, pts, v)

    cyl_params = jax.vmap(per_frame)(init_pts, init_val)  # (2, 6)

    def residual_fn(pose6):
        return registration_residuals(pose6, t_agv_cyls, pts3s, valid, radius)

    # The triad init assumes the prior-oriented camera-frame axis (dir_y >= 0,
    # ref utils/applyCylParamsPrior.m) corresponds to the AGV kinematic +y and
    # that the fitted origin displacement is clean -- but the prior slides
    # origins along their axes, contaminating it.  When either assumption
    # breaks, Nelder-Mead and LM alike stall in a local minimum (the reference
    # shares this failure mode).  Robustify beyond the reference with a
    # vmapped multi-start: both triad axis signs plus the 24-element cube
    # rotation group (translation aligned via the frame-0 origins), one
    # batched LM over all candidates, keep the best (26 solves of a 6-dof
    # problem).
    def pose_for(sign):
        cp = cyl_params.at[:, 3:6].multiply(sign)
        return transforms.transform_to_vec(_triad_init(init_kin, cp))

    triad_poses = jnp.stack([pose_for(1.0), pose_for(-1.0)])

    cube = _cube_group_rotvecs(pts3s.dtype)          # (24, 3)
    r_cube = transforms.rotvec_to_matrix(cube)       # (24, 3, 3)
    p1 = init_kin[0, :3, 3]
    ep1 = cyl_params[0, :3]
    t_cube = ep1[None, :] - mm(r_cube, p1).reshape(24, 3)
    cube_poses = jnp.concatenate([cube, t_cube], axis=-1)

    candidates = jnp.concatenate([triad_poses, cube_poses], axis=0)

    from cylinder_pose_estimation_tpu.ops.lm import levenberg_marquardt

    def solve(p0):
        r = levenberg_marquardt(
            residual_fn, p0, iters=config.lm_iters, lambda0=config.lm_lambda0
        )
        return r.params, r.cost

    params_all, costs = jax.vmap(solve)(candidates)
    best = jnp.argmin(costs)
    pose = params_all[best]

    r0 = residual_fn(triad_poses[0])

    # Observability diagnostic: min eigenvalue of the
    # 6-dof JtJ at the solution, per contributing frame.  A narrow pan/tilt
    # spread makes translation along the shared cylinder axis gauge-flat --
    # the objective cannot see it, so callers must not trust that component.
    # One extra (M, 6) Jacobian evaluation; negligible next to the solve.
    #
    # Scale normalization: the pose is
    # [rotvec, t], so the rotation columns of J carry mm of lever arm while
    # the translation columns are unit direction cosines -- raw eigenvalues
    # mix incommensurate units and scale with the squared scene extent (a
    # deployment at 2x the working distance would shift the eigenvalue for
    # reasons unrelated to pan spread).  Dividing the rotvec block by the
    # RMS point radius about the cloud centroid (the natural lever-arm
    # scale, in mm) makes every column dimensionless; dividing the
    # eigenvalue by the contributing-frame count makes it count-invariant
    # (residuals already carry 1/sqrt(n_f)).  min_eig then means the same
    # thing at 300 mm and 900 mm working distance (pinned by
    # tests/test_registration.py at 1x and 2x scene scale).
    jac = jax.jacfwd(residual_fn)(pose)               # (F*N, 6)
    w_all = valid.astype(pts3s.dtype)
    n_all = jnp.maximum(jnp.sum(w_all), 1.0)
    ctr = jnp.sum(pts3s * w_all[..., None], axis=(0, 1)) / n_all
    lever = jnp.sqrt(
        jnp.sum(w_all * jnp.sum((pts3s - ctr) ** 2, axis=-1)) / n_all
    )
    # Guard only against a truly degenerate (empty/single-point) cloud:
    # clamping at 1.0 would silently disable the unit invariance for
    # scenes measured in meters (lever ~ 0.3 for a 300 mm scene in m).
    jac = jac.at[:, :3].divide(jnp.maximum(lever, 1e-6))
    jtj = mm(jac.T, jac)
    f_used = jnp.maximum(
        jnp.sum(jnp.any(valid, axis=-1)).astype(jtj.dtype), 1.0
    )
    min_eig = jnp.linalg.eigvalsh(jtj)[0] / f_used

    return RegistrationResult(
        t_cam_agv=transforms.vec_to_transform(pose),
        fval0=jnp.sum(r0 * r0),  # triad-init objective (the reference's fval0)
        fval=costs[best],
        jtj_min_eig=min_eig,
        well_posed=min_eig >= config.min_observability,
    )


def _cube_group_rotvecs(dtype) -> jnp.ndarray:
    """Rotation vectors of the 24 rotational symmetries of the cube.

    A fixed global covering of SO(3) (max distance to any rotation ~62 deg)
    used as multi-start seeds for the registration solve.
    """
    import numpy as _np

    mats = []
    # All signed permutation matrices with determinant +1.
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)):
        for sx in (1, -1):
            for sy in (1, -1):
                for sz in (1, -1):
                    m = _np.zeros((3, 3))
                    m[0, perm[0]] = sx
                    m[1, perm[1]] = sy
                    m[2, perm[2]] = sz
                    if _np.linalg.det(m) > 0.5:
                        mats.append(m)
    mats = _np.stack(mats)  # (24, 3, 3)
    return transforms.matrix_to_rotvec(jnp.asarray(mats, dtype))


def predicted_cylinder_poses(
    t_cam_agv: jnp.ndarray,
    angles: jnp.ndarray,
    config: RegistrationConfig = RegistrationConfig(),
) -> jnp.ndarray:
    """T_Cam_cyl per frame = T_Cam_AGV @ T_AGV_cyl(pan, tilt) (ref exp_gridDetection.m:90-94)."""
    return mm(t_cam_agv, t_agv_cyl(angles[:, 0], angles[:, 1], config.kinematics))
