"""Principal-curvature estimation over masked point clouds.

Replaces the reference's per-point MATLAB loop (ref utils/estCurvatures.m:1-38:
knnsearch K=20, local plane fit, local coordinate frame, least-squares quadric
z = a x^2 + b xy + c y^2 + d x + e y, eig of the shape matrix
[[2a, b], [b, 2c]]) with fully batched masked operations:

  * kNN: masked pairwise squared distances + lax.top_k (point counts here are
    a few hundred, so the dense (N, N) matrix is tiny);
  * per-neighborhood plane fit: batched 3x3 eigh;
  * quadric: one batched (N, 5, 5) normal-equations solve;
  * shape eig: closed-form 2x2.

Deviations from the reference, on purpose:

  * The local frame is NORMALIZED here.  The reference's createLocCoordSys
    (ref utils/estCurvatures.m:20-29) builds x/y columns of norm
    s = |cross(normal, x_seed)| <= 1, which scales its curvature
    eigenvalues by 1/s^2 -- a coordinate artifact that varies with the
    plane normal's orientation to the axes (directions are unaffected).
    The oracle parity test corrects for it explicitly
    (tests/test_reference_oracle.py::test_est_curvatures_matches_reference).

  * The reference takes K(:, 1, i) --
the eigenvector of the *ascending-ordered* MATLAB eig -- as the cylinder-axis
direction (ref utils/fitCylinderWPts3.m:29).  That ordering only selects the
axis when the fitted normal happens to orient the nonzero curvature positive;
with the opposite normal sign the ascending order puts the circumferential
direction first.  We instead select the direction of **minimum absolute
curvature**, which is the geometric meaning (a cylinder is flat along its
axis) and is sign-stable.  ``principal_directions`` still returns both.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.ops.linalg import mm

from cylinder_pose_estimation_tpu.ops.linalg import eigh2x2, solve_normal_equations


class CurvatureResult(NamedTuple):
    directions: jnp.ndarray   # (N, 3, 2) principal directions (columns)
    curvatures: jnp.ndarray   # (N, 2) eigenvalues of the shape matrix
    flat_direction: jnp.ndarray  # (N, 3) direction of min |curvature|


def _local_frame(normal: jnp.ndarray) -> jnp.ndarray:
    """Local coords with z = normal (ref estCurvatures.m createLocCoordSys).

    x seed is [1,0,0] unless |n . x| > 0.9, then [0,1,0]; y = z x x_seed,
    x = y x z (MATLAB writes cross(z,x) then cross(y,z)).
    """
    x0 = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], normal.dtype), normal.shape)
    x1 = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], normal.dtype), normal.shape)
    use_alt = (jnp.abs(normal[..., 0]) > 0.9)[..., None]
    xs = jnp.where(use_alt, x1, x0)
    y = jnp.cross(normal, xs)
    y = y / (jnp.linalg.norm(y, axis=-1, keepdims=True) + 1e-12)
    x = jnp.cross(y, normal)
    x = x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
    return jnp.stack([x, y, normal], axis=-1)  # (..., 3, 3) columns


def _curvature_from_neighborhood(
    nbr: jnp.ndarray, nbr_valid: jnp.ndarray
) -> CurvatureResult:
    """Shared per-neighborhood math: plane fit -> local frame -> quadric ->
    shape-operator eig.  nbr (..., k, 3), nbr_valid (..., k)."""
    dtype = nbr.dtype
    # Local plane per neighborhood -> normal (smallest eigvec of covariance).
    w = nbr_valid.astype(dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1.0)
    mean = jnp.sum(nbr * w, axis=-2, keepdims=True) / cnt
    cd = (nbr - mean) * w
    cov = mm(jnp.swapaxes(cd, -1, -2), cd) / jnp.maximum(cnt[..., 0, :, None] - 1.0, 1.0)
    _, vecs = jnp.linalg.eigh(cov)
    normal = vecs[..., :, 0]                      # (..., 3)

    frame = _local_frame(normal)                  # (..., 3, 3)
    local = mm(nbr - mean, frame)                 # (..., k, 3)
    x, y, z = local[..., 0], local[..., 1], local[..., 2]
    a = jnp.stack([x * x, x * y, y * y, x, y], axis=-1)  # (..., k, 5)
    coeffs = solve_normal_equations(a, z, nbr_valid.astype(dtype))  # (..., 5)

    evals, evecs2 = eigh2x2(2.0 * coeffs[..., 0], coeffs[..., 1], 2.0 * coeffs[..., 2])
    directions = mm(frame[..., :2], evecs2)       # (..., 3, 2)
    flat = jnp.argmin(jnp.abs(evals), axis=-1)    # min |curvature| -> axis dir
    hot = (jnp.arange(2) == flat[..., None]).astype(dtype)  # gather-free select
    flat_dir = jnp.sum(directions * hot[..., None, :], axis=-1)
    return CurvatureResult(directions=directions, curvatures=evals, flat_direction=flat_dir)


def estimate_curvatures(
    pts: jnp.ndarray, valid: jnp.ndarray, k: int = 20
) -> CurvatureResult:
    """pts (N, 3), valid (N,) -> per-point principal curvature frame.

    Masked points receive garbage outputs under their own mask.  If fewer than
    k valid points exist, neighborhoods duplicate the nearest valid points
    (top_k over masked distances), which degrades gracefully.
    """
    n = pts.shape[0]
    dtype = pts.dtype
    diff = pts[:, None, :] - pts[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    big = jnp.asarray(1e30, dtype)
    d2 = jnp.where(valid[None, :], d2, big)
    # k nearest (including self, as knnsearch of a set against itself does).
    k = min(k, n)
    _, nbr_idx = jax.lax.top_k(-d2, k)            # (N, k)
    nbr = pts[nbr_idx]                            # (N, k, 3)
    nbr_valid = valid[nbr_idx]                    # (N, k)
    return _curvature_from_neighborhood(nbr, nbr_valid)


def estimate_curvature_at(
    pts: jnp.ndarray, valid: jnp.ndarray, idx: jnp.ndarray, k: int = 20
) -> CurvatureResult:
    """Curvature frame at ONE point index -- pts (N, 3), valid (N,), idx ().

    The cylinder init needs the flat direction only at the point closest to
    the radial line (ref utils/fitCylinderWPts3.m:29), so computing all N
    neighborhoods is N x wasted work.  Numerically identical to
    ``estimate_curvatures(pts, valid, k).flat_direction[idx]``: the same
    distance row, same top_k tie-breaking, same neighborhood math.

    Gather-free on purpose: the point select and the k-neighbor select are
    one-hot HIGHEST-precision matmuls (exact for a 0/1 left operand; the
    form was chosen for the first target accelerator, whose dynamic gathers
    under vmap were slow, and has not been measured on the GPU).
    """
    n = pts.shape[0]
    dtype = pts.dtype
    hot0 = (jnp.arange(n) == idx).astype(dtype)
    p0 = jnp.einsum(
        "n,nd->d", hot0, pts, precision=jax.lax.Precision.HIGHEST
    )
    diff = pts - p0
    d2 = jnp.sum(diff * diff, axis=-1)
    big = jnp.asarray(1e30, dtype)
    d2 = jnp.where(valid, d2, big)
    k = min(k, n)
    _, nbr_idx = jax.lax.top_k(-d2, k)            # (k,)
    onehot = (nbr_idx[:, None] == jnp.arange(n)[None, :]).astype(dtype)
    payload = jnp.concatenate([pts, valid.astype(dtype)[:, None]], axis=-1)
    sel = jnp.einsum(
        "kn,nd->kd", onehot, payload, precision=jax.lax.Precision.HIGHEST
    )
    nbr, nbr_valid = sel[:, :3], sel[:, 3] > 0.5
    return _curvature_from_neighborhood(nbr, nbr_valid)
