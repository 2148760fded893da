"""Contrast-limited adaptive histogram equalization (CLAHE).

Replaces both CLAHE call sites in the reference:
  * cv2.createCLAHE(clipLimit=4.5, tileGridSize=(4,4)) on the LAB L channel
    before blob detection (ref utils/util_cylinder.py:1839-1848);
  * MATLAB adapthisteq in stereo preprocessing (ref utils/preProcessing.m:17-18;
    defaults: 8x8 tiles, normalized clip 0.01, 256 bins, uniform).

Batched shape: per-tile 256-bin histograms via one segment_sum over
(tiles * 256) segments (small segment space -> cheap scatter), single-pass
clip + uniform redistribution of the excess, per-tile CDF, then bilinear
interpolation between the four surrounding tile mappings per pixel (the
standard CLAHE interpolation, which both cv2 and MATLAB use).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def clahe(
    img: jnp.ndarray,
    tiles: int = 8,
    clip_limit: float = 0.01,
    n_bins: int = 256,
    clip_is_normalized: bool = True,
) -> jnp.ndarray:
    """CLAHE over an (H, W) image with values in [0, 255].

    clip_is_normalized=True interprets clip_limit like MATLAB adapthisteq
    (fraction of tile pixels per bin, >= 1/n_bins); False interprets it like
    cv2 (multiplier on the uniform bin height: limit = clip * tile_px / bins).
    H and W must be divisible by ``tiles`` (pad beforehand otherwise).
    """
    h, w = img.shape
    assert h % tiles == 0 and w % tiles == 0, "pad image to a tile multiple"
    th, tw = h // tiles, w // tiles
    tile_px = th * tw

    x = jnp.clip(img.astype(jnp.float32), 0.0, 255.0)
    bins = jnp.clip((x * (n_bins / 256.0)).astype(jnp.int32), 0, n_bins - 1)

    ty = jnp.arange(h) // th
    tx = jnp.arange(w) // tw
    tile_id = ty[:, None] * tiles + tx[None, :]
    seg = (tile_id * n_bins + bins).reshape(-1)
    hist = jax.ops.segment_sum(
        jnp.ones_like(seg, jnp.float32), seg, num_segments=tiles * tiles * n_bins
    ).reshape(tiles * tiles, n_bins)

    if clip_is_normalized:
        # MATLAB adapthisteq's limit: minClip + round(norm*(tilePx-minClip)),
        # minClip = ceil(tilePx/nBins) (Zuiderveld CLAHE, which the MATLAB
        # docs cite) -- oracle-pinned vs tests/_oracle_clahe.py.
        min_clip = jnp.ceil(tile_px / n_bins)
        limit = min_clip + jnp.round(clip_limit * (tile_px - min_clip))
    else:
        limit = jnp.maximum(1.0, clip_limit * tile_px / n_bins)

    # ITERATIVE excess redistribution: a single uniform pass leaves bins
    # above the limit whenever the uniform share pushes clipped bins back
    # over it; re-clipping shrinks the regenerated excess geometrically
    # (factor = clipped-bin fraction), so 16 fixed rounds reach float32
    # resolution.  Total mass is preserved every round.
    def _round(h, _):
        excess = jnp.sum(jnp.maximum(h - limit, 0.0), axis=-1, keepdims=True)
        return jnp.minimum(h, limit) + excess / n_bins, None

    clipped, _ = jax.lax.scan(_round, hist, None, length=16)

    cdf = jnp.cumsum(clipped, axis=-1)
    # 'uniform'-distribution mapping over the FULL output range, like both
    # MATLAB adapthisteq ('full') and cv2: 255 * cdf / tilePx -- NOT the
    # equalizeHist (cdf - cdf_min)/(N - cdf_min) anchor used before r5.
    lut = jnp.minimum(255.0 * cdf / tile_px, 255.0)
    lut = lut.reshape(tiles, tiles, n_bins)

    # Bilinear interpolation between the 4 surrounding tile LUTs.
    fy = (jnp.arange(h, dtype=jnp.float32) + 0.5) / th - 0.5
    fx = (jnp.arange(w, dtype=jnp.float32) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, tiles - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, tiles - 1)
    y1 = jnp.clip(y0 + 1, 0, tiles - 1)
    x1 = jnp.clip(x0 + 1, 0, tiles - 1)
    wy = jnp.clip(fy - y0, 0.0, 1.0)[:, None]
    wx = jnp.clip(fx - x0, 0.0, 1.0)[None, :]

    b = bins
    y0g = y0[:, None]
    y1g = y1[:, None]
    x0g = x0[None, :]
    x1g = x1[None, :]
    v00 = lut[y0g, x0g, b]
    v01 = lut[y0g, x1g, b]
    v10 = lut[y1g, x0g, b]
    v11 = lut[y1g, x1g, b]
    out = (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )
    return out


def preprocess_stereo(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    cam1,
    cam2,
    tiles: int = 8,
    clip_limit: float = 0.01,
    interp: str = "cubic",
):
    """Stereo preprocessing (ref utils/preProcessing.m:1-22): to grayscale,
    undistort both views, adaptive histogram equalization.

    ``interp`` defaults to 'cubic' because this function mirrors the MATLAB
    experiment path, whose undistortImage call is explicitly cubic (ref
    utils/preProcessing.m:12-13); the Python reference path (cv2.undistort,
    bilinear) is the default elsewhere."""
    from cylinder_pose_estimation_tpu.ops.image import bgr_to_gray
    from cylinder_pose_estimation_tpu.ops.remap import undistort_image

    def one(img, cam):
        g = bgr_to_gray(img.astype(jnp.float32)) if img.ndim == 3 else img
        g = undistort_image(g, cam, interp=interp)
        return clahe(g, tiles=tiles, clip_limit=clip_limit)

    return one(img1, cam1), one(img2, cam2)
