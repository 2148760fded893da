"""Cylinder fitting: residuals, curvature-seeded init, LM refinement, priors.

The batched equivalent of the reference's chain
  getDistPts3ToLine (ref utils/getDistPts3ToLine.m)
  fitCylinderWPts3   (ref utils/fitCylinderWPts3.m: PCA + curvature init,
                      fminsearch over [origin, direction])
  applyCylParamsPrior (ref utils/applyCylParamsPrior.m)
with masked, vmappable array code and a fixed-iteration Levenberg-Marquardt
solver in place of Nelder-Mead (see ops/lm.py for the rationale).

Everything here treats a cylinder as the 6-vector [origin(3), direction(3)]
(the reference's cylParams).  The objective is the sum of squared
(point-to-axis distance - radius) residuals over valid points, identical to
the reference's dist() (ref utils/fitCylinderWPts3.m:44-49).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from cylinder_pose_estimation_tpu.ops.linalg import mm

from cylinder_pose_estimation_tpu.geometry.curvature import estimate_curvature_at
from cylinder_pose_estimation_tpu.ops.linalg import masked_mean, pca_components
from cylinder_pose_estimation_tpu.ops.lm import levenberg_marquardt

_EPS = 1e-12


def dist_points_to_line(
    pts: jnp.ndarray, p1: jnp.ndarray, direction: jnp.ndarray
) -> jnp.ndarray:
    """Distance of (..., N, 3) points to the line p1 + t * direction.

    Matches ref utils/getDistPts3ToLine.m (which passes two points; here the
    direction is explicit).  Safe for ~zero-length directions via clamping.
    """
    v = direction
    nv2 = jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), _EPS)
    rel = pts - p1[..., None, :]
    alpha = mm(rel, v[..., :, None])[..., 0] / nv2
    proj = p1[..., None, :] + alpha[..., None] * v[..., None, :]
    return jnp.linalg.norm(pts - proj, axis=-1)


def cylinder_residuals(
    params: jnp.ndarray, pts: jnp.ndarray, radius: float | jnp.ndarray
) -> jnp.ndarray:
    """(dist to axis - radius) per point; params = [origin, direction]."""
    return dist_points_to_line(pts, params[..., :3], params[..., 3:6]) - radius


def cylinder_residuals_jac(
    params: jnp.ndarray, pts: jnp.ndarray, radius: float | jnp.ndarray
) -> jnp.ndarray:
    """Closed-form Jacobian of cylinder_residuals wrt [origin, direction].

    With q = p - o, alpha = (q.v)/|v|^2, u = q - alpha v (the radial
    component, u.v = 0), t = |u|:  dr/do = -u_hat and dr/dv = -alpha u_hat
    (the alpha-gradient terms vanish against u_hat because u is orthogonal
    to v).  One residual-shaped evaluation replaces jacfwd's 6-tangent JVP
    (~7 residual evaluations per LM step); equality with jacfwd is pinned
    by tests/test_cylinder_fit.py.
    """
    o = params[..., :3]
    v = params[..., 3:6]
    nv2 = jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), _EPS)
    rel = pts - o[..., None, :]
    alpha = mm(rel, v[..., :, None])[..., 0] / nv2
    u = rel - alpha[..., None] * v[..., None, :]
    t = jnp.linalg.norm(u, axis=-1, keepdims=True)
    uhat = u / jnp.maximum(t, _EPS)
    return jnp.concatenate([-uhat, -alpha[..., None] * uhat], axis=-1)


class CylinderInit(NamedTuple):
    params0: jnp.ndarray  # (6,)
    ok: jnp.ndarray       # () bool: init assumptions held (rdir_z sign flip
                          # sufficed -- the reference *asserts* rdir(3) > 0,
                          # ref utils/fitCylinderWPts3.m:19; we return a flag)


def init_cylinder(
    pts: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float | jnp.ndarray,
    knn_k: int = 20,
) -> CylinderInit:
    """Curvature-seeded initial cylinder (ref utils/fitCylinderWPts3.m:6-31).

    ctr = centroid; radial dir = least-variance PCA axis flipped so z > 0
    (the axis is behind the visible surface); surface distance = distance from
    ctr to the closest point along that radial line; axis dir = principal
    direction of minimum |curvature| at that closest point; origin = ctr +
    rdir * (radius - d2surface).
    """
    ctr = masked_mean(pts, valid)
    comps, _ = pca_components(pts, valid)
    rdir = comps[..., :, 2]                       # least-variance direction
    rdir = jnp.where(rdir[..., 2:3] < 0, -rdir, rdir)
    ok = rdir[..., 2] > 0

    d = dist_points_to_line(pts, ctr, rdir)
    d = jnp.where(valid, d, jnp.inf)
    i = jnp.argmin(d, axis=-1)
    closest = jnp.take_along_axis(pts, i[..., None, None].repeat(3, -1), axis=-2)[..., 0, :]
    d2surface = jnp.linalg.norm(ctr - closest, axis=-1)

    # Curvature only at the closest point (all the init consumes, ref
    # utils/fitCylinderWPts3.m:29) -- the all-points batch does N times
    # the work.
    curv = estimate_curvature_at(pts, valid, i, k=knn_k)
    cyldir = curv.flat_direction

    cylorg = ctr + rdir * (radius - d2surface)[..., None]
    return CylinderInit(params0=jnp.concatenate([cylorg, cyldir], axis=-1), ok=ok)


class CylinderFit(NamedTuple):
    params0: jnp.ndarray  # (6,) initial (pre-prior)
    params: jnp.ndarray   # (6,) optimized (pre-prior)
    fvals: jnp.ndarray    # (2,) [initial, final] sum squared residuals
    init_ok: jnp.ndarray  # ()


def fit_cylinder(
    pts: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float,
    knn_k: int = 20,
    lm_iters: int = 60,
    lm_lambda0: float = 1e-3,
) -> CylinderFit:
    """Full fit: init + LM over [origin, direction] (ref utils/fitCylinderWPts3.m).

    Returns both init and optimized params plus their objective values, like
    the reference's ``cylParams = [cylParams0; cylParams]; fvals = [fval0, fval]``.
    """
    init = init_cylinder(pts, valid, radius, knn_k=knn_k)
    w = valid.astype(pts.dtype)

    def residual_fn(p):
        return cylinder_residuals(p, pts, radius)

    res = levenberg_marquardt(
        residual_fn, init.params0, weights=w, iters=lm_iters,
        lambda0=lm_lambda0,
        jac_fn=lambda p: cylinder_residuals_jac(p, pts, radius),
    )
    return CylinderFit(
        params0=init.params0,
        params=res.params,
        fvals=jnp.stack([res.cost0, res.cost]),
        init_ok=init.ok,
    )


def apply_prior(
    params: jnp.ndarray, pts: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Axis-orientation + origin-height prior (ref utils/applyCylParamsPrior.m).

    Flip the direction so dir_y >= 0 (camera y ~ cylinder up), then slide the
    origin along the axis so origin_y equals the minimum y over the grid
    points.  dir_y ~ 0 leaves the origin unchanged (ref :20-24).
    """
    origin = params[..., :3]
    direction = params[..., 3:6]
    direction = jnp.where(direction[..., 1:2] < 0, -direction, direction)
    big = jnp.asarray(jnp.finfo(pts.dtype).max, pts.dtype)
    y_min = jnp.min(jnp.where(valid, pts[..., 1], big), axis=-1)
    dy = direction[..., 1]
    t = jnp.where(jnp.abs(dy) < 1e-12, 0.0, (y_min - origin[..., 1]) / jnp.where(
        jnp.abs(dy) < 1e-12, 1.0, dy))
    new_origin = origin + t[..., None] * direction
    return jnp.concatenate([new_origin, direction], axis=-1)


def mean_sq_residual(
    params: jnp.ndarray, pts: jnp.ndarray, valid: jnp.ndarray, radius: float
) -> jnp.ndarray:
    """Mean over valid points of squared residuals (used by registration)."""
    r = cylinder_residuals(params, pts, radius)
    w = valid.astype(pts.dtype)
    return jnp.sum(w * r * r) / jnp.maximum(jnp.sum(w), 1.0)
