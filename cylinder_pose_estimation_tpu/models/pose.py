"""Per-frame stereo pose estimation (ref utils/fitSingleCylinder.m:12-28).

The numerically load-bearing sequence (SURVEY.md §3.4):
    choose_idx(patch=3, th=0.3) -> triangulate -> fit_cylinder -> prior x2
    -> cyl_params_to_transform
as one jittable function of two GridPoints + StereoParams.  vmap over a frame
axis turns the reference's serial per-image MATLAB loop
(ref exp_gridDetection.m:78-81) into one batched program.
"""

from __future__ import annotations

import jax.numpy as jnp

from cylinder_pose_estimation_tpu.config import FitConfig
from cylinder_pose_estimation_tpu.geometry import transforms
from cylinder_pose_estimation_tpu.geometry.correspond import choose_idx
from cylinder_pose_estimation_tpu.geometry.cylinder import apply_prior, fit_cylinder
from cylinder_pose_estimation_tpu.geometry.triangulate import triangulate
from cylinder_pose_estimation_tpu.types import (
    CylinderFitResult,
    GridPoints,
    StereoParams,
)


def fit_single_cylinder(
    gp1: GridPoints,
    gp2: GridPoints,
    stereo: StereoParams,
    config: FitConfig = FitConfig(),
) -> CylinderFitResult:
    """Estimate one cylinder pose from a stereo grid-point pair.

    Returns the init and optimized cylinder params (both with the prior
    applied, like ref utils/fitSingleCylinder.m:23-24), the [fval0, fval]
    objective pair, the cylinder->cam1 transform, and the mean reprojection
    error over the correspondences used.
    """
    corr = choose_idx(
        gp1,
        gp2,
        stereo,
        patch_size=config.patch_size,
        error_threshold=config.error_threshold,
        extent=config.grid_extent,
    )
    tri = triangulate(corr.xy1, corr.xy2, stereo, valid=corr.valid)
    w = tri.valid
    mean_error = jnp.sum(
        jnp.where(w, tri.reproj_error, 0.0)
    ) / jnp.maximum(jnp.sum(w.astype(tri.reproj_error.dtype)), 1.0)

    fit = fit_cylinder(
        tri.points3,
        w,
        config.cyl_radius,
        knn_k=config.knn_k,
        lm_iters=config.lm_iters,
        lm_lambda0=config.lm_lambda0,
    )
    params0 = apply_prior(fit.params0, tri.points3, w)
    params = apply_prior(fit.params, tri.points3, w)
    t_cam_cyl = transforms.cyl_params_to_transform(params)

    return CylinderFitResult(
        params0=params0,
        params=params,
        fvals=fit.fvals,
        t_cam_cyl=t_cam_cyl,
        mean_reproj_error=mean_error,
        points3=tri.points3,
        points_valid=w,
    )


def cylinder_axis_info(
    gp1: GridPoints,
    gp2: GridPoints,
    stereo: StereoParams,
    config: FitConfig = FitConfig(),
):
    """Triangulated points + fitted axis segment (ref utils/getInfo3dCylinder.m:1-48).

    The reference variant corresponds exact grid indices, triangulates, fits,
    and returns the axis segment spanning the projections of the points onto
    the axis.  Returns (points3, valid, axis_p1, axis_p2, params).
    """
    from cylinder_pose_estimation_tpu.geometry.correspond import (
        find_grid_correspondences,
    )
    from cylinder_pose_estimation_tpu.geometry.cylinder import fit_cylinder

    corr = find_grid_correspondences(gp1, gp2, extent=config.grid_extent)
    tri = triangulate(corr.xy1, corr.xy2, stereo, valid=corr.valid)
    fit = fit_cylinder(
        tri.points3, tri.valid, config.cyl_radius,
        knn_k=config.knn_k, lm_iters=config.lm_iters,
    )
    params = apply_prior(fit.params, tri.points3, tri.valid)
    org = params[:3]
    d = params[3:6] / jnp.linalg.norm(params[3:6])
    t = jnp.sum((tri.points3 - org) * d, axis=-1)
    big = jnp.asarray(jnp.finfo(t.dtype).max, t.dtype)
    t_lo = jnp.min(jnp.where(tri.valid, t, big))
    t_hi = jnp.max(jnp.where(tri.valid, t, -big))
    return tri.points3, tri.valid, org + t_lo * d, org + t_hi * d, params
