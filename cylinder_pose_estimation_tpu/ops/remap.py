"""Image undistortion by inverse mapping (replaces cv2.undistort /
MATLAB undistortImage).

The reference undistorts every image up front: Python side with
cv2.undistort(K, [k1, k2, p1, p2, k3]) (ref utils/iotool.py:22-39), MATLAB
side with undistortImage(..., 'cubic') (ref utils/preProcessing.m:12-13).

cv2.undistort semantics: for every *destination* (undistorted) pixel, push its
normalized coordinates through the forward distortion model to find the source
pixel in the distorted image, then sample.  That is a dense, branch-free map
-- one fused coordinate computation + one bilinear gather.
"""

from __future__ import annotations

import jax.numpy as jnp

from cylinder_pose_estimation_tpu.ops.image import bilinear_sample
from cylinder_pose_estimation_tpu.types import CameraModel


def distort_points(xy_norm: jnp.ndarray, cam: CameraModel) -> jnp.ndarray:
    """Forward distortion of normalized camera coords (..., 2).

    Radial k1, k2, k3 + tangential p1, p2 (the OpenCV model the camera JSON
    carries: ref utils/iotool.py:33-35).
    """
    x = xy_norm[..., 0]
    y = xy_norm[..., 1]
    k1, k2, k3 = cam.radial[0], cam.radial[1], cam.radial[2]
    p1, p2 = cam.tangential[0], cam.tangential[1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_image(
    img: jnp.ndarray, cam: CameraModel, interp: str = "bilinear"
) -> jnp.ndarray:
    """Undistort an (H, W) or (H, W, C) image (cv2.undistort equivalent,
    identity new camera matrix).

    ``interp``: 'bilinear' matches the Python reference path (cv2.undistort's
    default); 'cubic' (Catmull-Rom) matches the MATLAB experiment path's
    undistortImage(..., 'cubic') (ref utils/preProcessing.m:12-13).  The two
    shift ridge peaks by ~0.01-0.1 px at realistic distortion -- bounded by
    tests/test_preprocess.py::test_undistort_cubic_vs_bilinear_ridge_shift."""
    from cylinder_pose_estimation_tpu.ops.image import cubic_sample

    sample = {"bilinear": bilinear_sample, "cubic": cubic_sample}[interp]
    h, w = img.shape[:2]
    k = cam.k
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    ys = (jnp.arange(h, dtype=jnp.float32)[:, None] - cy) / fy
    xs = (jnp.arange(w, dtype=jnp.float32)[None, :] - cx) / fx
    grid = jnp.stack(jnp.broadcast_arrays(xs, ys), axis=-1)  # (H, W, 2) normalized
    d = distort_points(grid, cam)
    src_x = d[..., 0] * fx + cx
    src_y = d[..., 1] * fy + cy
    if img.ndim == 2:
        return sample(img.astype(jnp.float32), src_x, src_y)
    chans = [
        sample(img[..., c].astype(jnp.float32), src_x, src_y)
        for c in range(img.shape[2])
    ]
    return jnp.stack(chans, axis=-1)


def undistort_points(xy: jnp.ndarray, cam: CameraModel, iters: int = 8) -> jnp.ndarray:
    """Invert the distortion for point coordinates (fixed-point iteration,
    the standard cv2.undistortPoints scheme, jit-static iteration count)."""
    k = cam.k
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    x, y = xn, yn
    for _ in range(iters):
        d = distort_points(jnp.stack([x, y], -1), cam)
        x = x + (xn - d[..., 0])
        y = y + (yn - d[..., 1])
    return jnp.stack([x * fx + cx, y * fy + cy], axis=-1)
