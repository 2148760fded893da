"""Laser-grid detection front-end: image in, indexed grid points out.

The batched JAX rebuild of the reference's detect_grid six-stage pipeline
(ref python_grid_detection_cylinder.py:68-112, python_grid_detection_plane.py:74-119,
orchestrated by color_and_expand_lines, ref utils/util_cylinder.py:2014-2060):

  1. preprocess/binarize  -- Gaussian -> Hessian ridge minima -> Sauvola
  2. joints               -- 20-px line openings, AND, component centroids
  3. ROI                  -- line-density region (cylinder) / intensity
                             threshold hull (plane)
  4. center seed          -- brightest joint in ROI, 2nd-nearest radius
  5. saturation masking   -- carve the specular blob ellipse out of the masks
  6. lines -> grid        -- bridge -> label -> polyfit -> prune ->
                             intersections -> relabel -> index -> GridPoints

Everything is fixed-shape masked array code: ragged contour/label dicts of the
reference become (MAX_ROWS/MAX_COLS/MAX_POINTS)-capacity slots with validity
masks, so the whole detector jits once and vmaps over frames.

Documented deviations from the reference (capability-preserving redesigns;
each feeds *masks* or seeds, where the geometry chain's 1e-3 px parity budget
does not bind -- SURVEY.md §7 hard parts (c)):
  * SimpleBlobDetector ROI -> line-density ROI (dilated line masks, largest
    component, orthoconvex fill).  Same role: a mask containing the grid.
  * cv2.minEnclosingCircle -> component centroid + max point distance
    (a circumscribing circle; the +5/+20 padding absorbs the difference).
  * per-contour PCA endpoint expansion -> dense directional endpoint
    detection + oriented line dilation at the component-median angle.
(PARITY.md keeps the full list.)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.config import (
    CylinderDetectConfig,
    DetectConfig,
    PlaneDetectConfig,
)
from cylinder_pose_estimation_tpu.ops import labeling, morphology
from cylinder_pose_estimation_tpu.ops.image import (
    bgr_to_gray,
    box_filter,
    gaussian_blur_cv,
)
from cylinder_pose_estimation_tpu.ops.polyfit import (
    masked_polyfit,
    poly_domain,
    poly_intersection,
    polyder,
    polyval,
)
from cylinder_pose_estimation_tpu.ops.ridge import binarize_ridges
from cylinder_pose_estimation_tpu.types import DetectResult, GridPoints

_MAX_COMPONENTS = 48  # per-mask line components tracked for angles/gating


def _border_margin(cfg: DetectConfig) -> int:
    """Border band discarded by the binarize chain.

    Must cover the chain's full stencil reach -- Gaussian blur radius +
    scipy sigma-Gaussian radius + two central-difference passes + Sauvola
    box radius, +1 safety -- so no kept pixel depends on how the filters
    treat the image border.  Also at least the line-opening length, below
    which edge-clipped line responses fragment."""
    reach = (
        (cfg.blur_ksize - 1) // 2
        + int(4.0 * cfg.ridge_sigma + 0.5)
        + 2
        + cfg.sauvola_window // 2
        + 1
    )
    return max(cfg.line_kernel_len, reach)


class DetectDebug(NamedTuple):
    """Intermediate masks for visualization/tests.

    binary/roi_mask are full-res (H, W) bool.  h_mask/v_mask hold the
    POST-saturation-carve line masks (the bridge inputs), not the raw
    stage-2 openings.  Under the default bridge_half_res=True,
    h_expanded/v_expanded live on the HALF-RES padded canvas
    (ceil8(H/2+..), ceil128(W/2+..)) -- the resolution the labeling CC
    consumes -- and only match (H, W) when bridge_half_res is off."""

    binary: jnp.ndarray
    h_mask: jnp.ndarray
    v_mask: jnp.ndarray
    roi_mask: jnp.ndarray
    h_expanded: jnp.ndarray
    v_expanded: jnp.ndarray
    centroids: jnp.ndarray       # (P, 2) float
    centroids_valid: jnp.ndarray  # (P,)
    center_seed: jnp.ndarray     # (2,)
    row_coeffs: jnp.ndarray      # (R, D+1)
    col_coeffs: jnp.ndarray      # (C, D+1)
    row_valid: jnp.ndarray
    col_valid: jnp.ndarray


def _to_gray(image: jnp.ndarray, dtype) -> jnp.ndarray:
    img = image.astype(dtype)
    if img.ndim == 3:
        return bgr_to_gray(img)
    return img


def _joint_centroids(
    joints: jnp.ndarray, cfg: DetectConfig, window: int = 11,
    peak_iters: int | None = None,
    precomputed: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray] | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Joint-blob centroids via per-blob peak extraction, no labeling needed.

    Joint blobs (the AND of the h/v line openings) are tiny (<~9 px across).
    Each blob is identified by the unique pixel whose (box-count,
    linear-index) key is maximal WITHIN ITS 8-CONNECTED BLOB: the blob max
    is computed by ``peak_iters`` rounds of masked 3x3 max propagation
    (masking after each full 3x3 pass makes this exact 8-connected
    propagation -- a diagonal neighbor inside the window is by definition
    8-adjacent).  A fixed-window non-max suppression is NOT used: it
    suppresses whole blobs when the grid spacing is below the window
    (measured 14/68 joints lost at ~12 px spacing).  The blob centroid is
    the box centroid around the peak, matching the reference's
    int-truncated contour-moment centroids (ref extract_joints
    utils/util_cylinder.py:1818-1827) while avoiding a connected-components
    pass plus a (H*W, max_points) one-hot reduction -- the two most
    expensive ops of the round-1 formulation.

    ``peak_iters`` bounds the blob graph-radius (8 covers blobs up to
    ~17 px across; blobs are the AND of two <=9 px line masks).

    ``precomputed``: optional (peak 0/1 float, cx, cy) full-res images, as
    detect_grid computes them alongside its other statistic images; this
    function then only runs the block-reduce compaction.

    Returns (centroids (P, 2) float, valid (P,)) with P = cfg.max_points.
    """
    h, w = joints.shape
    if precomputed is not None:
        peak_f, cx, cy = precomputed
        peak = peak_f > 0.5
    else:
        f = joints.astype(jnp.float32)
        yy = jnp.arange(h, dtype=jnp.float32)[:, None]
        xx = jnp.arange(w, dtype=jnp.float32)[None, :]
        cnt = box_filter(f, window, mode="constant", normalize=False)
        sx = box_filter(f * xx, window, mode="constant", normalize=False)
        sy = box_filter(f * yy, window, mode="constant", normalize=False)
        iters = cfg.joint_peak_iters if peak_iters is None else peak_iters
        peak = _joint_peaks(joints, cnt, iters, window=window)
        c = jnp.maximum(cnt, 1.0)
        cx = jnp.floor(sx / c)
        cy = jnp.floor(sy / c)
    # Compact peak positions via a 4x4 block-reduce before ranking: distinct
    # blobs' peaks sit near their blob centers, so two peaks share a 4x4
    # block only when two blob centers are < 4 px apart -- below any
    # workable grid spacing -- and each block holds at most one peak,
    # reducing the compaction from H*W to H*W/16 elements.  The centroid
    # PAYLOAD (cx, cy at the peak) rides the same block reduce (max with a
    # -1 background; at most one peak per block makes the max exact), so the
    # compaction is one one-hot matmul with NO full-res dynamic gathers
    # (a form chosen for the first target accelerator, whose gathers were
    # slow; not measured on the GPU).
    neg1 = jnp.float32(-1.0)
    pkx = jnp.where(peak, cx, neg1)
    pky = jnp.where(peak, cy, neg1)
    ph = (-h) % 4
    pw = (-w) % 4
    if ph or pw:
        pkx = jnp.pad(pkx, ((0, ph), (0, pw)), constant_values=-1.0)
        pky = jnp.pad(pky, ((0, ph), (0, pw)), constant_values=-1.0)
    blkx = jax.lax.reduce_window(
        pkx, neg1, jax.lax.max, (4, 4), (4, 4), "VALID"
    ).reshape(-1)
    blky = jax.lax.reduce_window(
        pky, neg1, jax.lax.max, (4, 4), (4, 4), "VALID"
    ).reshape(-1)
    nb = blkx.shape[0]
    has_peak = blkx >= 0.0
    pos = labeling.prefix_rank(has_peak)
    k = cfg.max_points
    sel = (
        has_peak[:, None] & (pos[:, None] == jnp.arange(k)[None, :])
    ).astype(jnp.float32)  # (nb, k)
    payload = jnp.stack(
        [blkx, blky, jnp.ones((nb,), jnp.float32)], axis=-1
    )
    picked = jax.lax.dot_general(
        sel, payload,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST: centroids are exact integer-valued floats up to W
        # (floor'd box moments); bf16 would quantize coordinates > 256.
        precision=jax.lax.Precision.HIGHEST,
    )  # (k, 3)
    valid = picked[:, 2] > 0.5
    cents = picked[:, :2]
    return jnp.where(valid[:, None], cents, 0.0), valid


def _joint_peaks(
    joints: jnp.ndarray, cnt: jnp.ndarray, peak_iters: int = 8,
    window: int = 11,
) -> jnp.ndarray:
    """Per-blob peak mask: the unique pixel maximizing the (box-count,
    linear-index) key within its 8-connected joint blob (exact integer
    keys).  See _joint_centroids."""
    h, w = joints.shape
    lin = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    key = cnt.astype(jnp.int32) * (
        1 << labeling.peak_key_shift(h, w, window)
    ) + lin
    neg = jnp.iinfo(jnp.int32).min
    km = jnp.where(joints, key, neg)
    for _ in range(peak_iters):
        km = labeling.window_extreme(km, 3, 1, neg, jnp.maximum)
        km = labeling.window_extreme(km, 1, 3, neg, jnp.maximum)
        km = jnp.where(joints, km, neg)
    return joints & (key == km)


def _stats_images(
    gray: jnp.ndarray,
    joints_f: jnp.ndarray,
    cnt: jnp.ndarray,
    cfg: DetectConfig,
    joint_window: int = 11,
) -> Tuple[jnp.ndarray, ...]:
    """Saturation / brightness / joint-centroid statistic images as banded
    matmuls (ops/mxu_conv).

    Replaces (ref provenance):
      * saturation blur+threshold   (ref utils/util_cylinder.py:1962-1967)
      * center-seed box brightness  (ref :1914-1917)
      * indexing patch brightness   (ref :1377-1449; the Gaussian and the
        box mean compose into ONE separable correlation)
      * joint-blob box centroids    (ref extract_joints :1818-1827), via the
        exact first-moment identity  sum(j*x) = x*cnt + corr(j, ramp):
        ramp taps and 0/1 masks are bf16-exact and every partial sum stays
        < 256, so cx/cy match the f32 box-filter formulation bit-for-bit.

    Border semantics: zero padding (band-clipped matrices).  sat is masked
    by the detector margin; the brightness images are only ever gathered at
    interior points, and the bf16 tap rounding of the two Gaussian images
    (~0.2%) is identical on every path (documented micro-deviation from the
    reference's f32 filters).
    """
    from cylinder_pose_estimation_tpu.ops import mxu_conv as mxc

    h, w = gray.shape
    rr = jnp.arange(h)[:, None]
    cc_ = jnp.arange(w)[None, :]
    mrg = _border_margin(cfg)
    inside = (rr >= mrg) & (rr < h - mrg) & (cc_ >= mrg) & (cc_ < w - mrg)

    gt = mxc.gauss_taps_cv(cfg.sat_blur_ksize)
    sat = mxc.conv_y(mxc.conv_x(gray, mxc.x_mat(gt, w)), mxc.y_mat(gt, h))
    sat_mask = (sat > cfg.sat_threshold) & inside

    # Brightness images feed ARGMAX decisions (center seed, grid origin):
    # exact mode keeps f32 operands at HIGHEST so chained first-pass sums
    # (~2805 for an 11-box over gray 255) are not bf16-recast by the second
    # pass (rounding there measured large enough to swap near-tied argmax
    # candidates vs the cumsum box-filter fallback).
    if getattr(cfg, "bright_at_points", False):
        # The center-seed brightness is only ever READ at a few hundred
        # integer points (joint centroids): conv_at_points evaluates the
        # same exact-mode separable correlation AT those points -- one
        # (P, H) x (H, W) HIGHEST matmul instead of two full-image exact
        # matmuls plus a dynamic gather (chosen for the first target
        # accelerator; not measured on the GPU).
        bright_center = None
    else:
        pc = 2 * cfg.center_patch_half + 1
        bt = mxc.box_taps(pc)
        bc = mxc.conv_y(
            mxc.conv_x(gray, mxc.x_mat(bt, w, exact=True), exact=True),
            mxc.y_mat(bt, h, exact=True), exact=True,
        )
        bright_center = bc / float(pc * pc)

    # Grid-origin brightness (stage 6g) needs the Gaussian(index_blur_ksize)
    # image in FULL: the reference's patch size is adaptive in the traced
    # saturation radius (ref :1377-1379), so the old composed static
    # blur+box taps cannot express it -- 6g takes rectangle means of this
    # blurred image with traced bounds (mxu_conv.range_mean_at_points).
    # bf16 operands here: all values stay <= 255 (one ~0.4% rounding, on
    # par with the reference's own uint8 GaussianBlur quantization of
    # +-0.5 gray); the rectangle SUMS that consume this image accumulate
    # in f32 via the HIGHEST band dot.
    gk_i = mxc.gauss_taps_cv(cfg.index_blur_ksize)
    bright_blur = mxc.conv_y(
        mxc.conv_x(gray, mxc.x_mat(gk_i, w)), mxc.y_mat(gk_i, h)
    )

    jb = mxc.box_taps(joint_window)
    jr = mxc.ramp_taps(joint_window)
    tx = mxc.conv_x(joints_f, mxc.x_mat(jr, w))
    ty = mxc.conv_y(joints_f, mxc.y_mat(jr, h))
    sx = cc_.astype(jnp.float32) * cnt + mxc.conv_y(tx, mxc.y_mat(jb, h))
    sy = rr.astype(jnp.float32) * cnt + mxc.conv_x(ty, mxc.x_mat(jb, w))
    c = jnp.maximum(cnt, 1.0)
    cx = jnp.floor(sx / c)
    cy = jnp.floor(sy / c)
    return sat_mask, bright_center, bright_blur, cx, cy


# Lowres canvas shift: pooled content sits at [_SHIFT4:, _SHIFT4:] inside the
# padded canvas so the labeling's cleared 1-px border ring (_cc_lowres_pair)
# only ever touches padding, never real content (a lowres px is 4 full-res
# px -- an unshifted ring was measured to drop border-row grid points).
# The shift and the (8, 128) padding of the lowres canvases were shaped for
# the first target accelerator's tiles; the golden fixtures pin them
# (ROADMAP Speed 5).
_SHIFT4 = 1


def _pool2_pad(mask: jnp.ndarray) -> jnp.ndarray:
    """Half-res max-pool into an (8, 128)-padded canvas (no shift needed:
    line masks carry a >= line_kernel_len border margin).

    Connectivity semantics: components separated by >= 3 px stay separate
    (laser-grid line spacing is >= ~12 px); gaps of <= 2 px can fuse
    depending on pixel parity -- for *fragments of one line* that fusion is
    the behavior the reference's bridging stage exists to produce
    (ref utils/util_cylinder.py:137-237), so it is benign by construction."""
    h, w = mask.shape
    small = jax.lax.reduce_window(
        mask.astype(jnp.float32), -jnp.inf, jax.lax.max, (2, 2), (2, 2), "VALID"
    ) > 0.5
    h2, w2 = small.shape
    hp = ((h2 + 7) // 8) * 8
    wp = ((w2 + 127) // 128) * 128
    return jnp.pad(small, ((0, hp - h2), (0, wp - w2)))


def _upsample2(small: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Undo _pool2_pad: crop the padded canvas, 2x nearest upsample."""
    h2 = (h + 1) // 2
    w2 = (w + 1) // 2
    s = small[:h2, :w2]
    return jnp.repeat(jnp.repeat(s, 2, axis=0), 2, axis=1)[:h, :w]


def _pool4_pad(mask: jnp.ndarray) -> jnp.ndarray:
    """Quarter-res max-pool into an (8, 128)-padded canvas.

    Content is shifted by (+_SHIFT4, +_SHIFT4); height pads to a multiple of
    8 and width to a multiple of 128.  Padding is background; all lowres
    consumers work in this canvas space and crop/offset only at the boundary
    back to full resolution.  Accepts (H, W) or a leading stack axis (one
    pooled op for several masks)."""
    stacked = mask.ndim == 3
    wd = (1, 4, 4) if stacked else (4, 4)
    small = jax.lax.reduce_window(
        mask.astype(jnp.float32), -jnp.inf, jax.lax.max, wd, wd, "VALID"
    ) > 0.5
    h4, w4 = small.shape[-2:]
    hp = ((h4 + 2 * _SHIFT4 + 7) // 8) * 8
    wp = ((w4 + 2 * _SHIFT4 + 127) // 128) * 128
    pad2 = ((_SHIFT4, hp - h4 - _SHIFT4), (_SHIFT4, wp - w4 - _SHIFT4))
    return jnp.pad(small, ((0, 0),) + pad2 if stacked else pad2)


def _cc_lowres_pair(
    m0: jnp.ndarray, m1: jnp.ndarray, cfg: DetectConfig
) -> jnp.ndarray:
    """Label TWO quarter-res masks in one vmapped call -> (2, h4, wp) labels.

    The detector needs exactly two lowres labelings per image (the ROI merge
    blob and the saturation blob).  Lowres blobs are compact (dilated unions
    / Gaussian-blurred disks), so 8 pool+scan rounds converge with margin.
    A 1-px lowres border ring is cleared; with the _SHIFT4 shift it only
    ever holds padding."""
    h4, w4 = m0.shape
    rows = jnp.arange(h4)[:, None]
    cols = jnp.arange(w4)[None, :]
    ring = (rows >= 1) & (rows < h4 - 1) & (cols >= 1) & (cols < w4 - 1)
    stack = jnp.stack([m0 & ring, m1 & ring])
    return jax.vmap(
        lambda m: labeling.connected_components(m, iters=min(cfg.cc_iters, 8))
    )(stack)


def _roi_cylinder_from_labels(
    merged: jnp.ndarray, labels: jnp.ndarray, h: int, w: int, k: int = 128
) -> jnp.ndarray:
    """Grid-region mask from the labeled lowres merge blob: largest component,
    orthoconvex-fill, upsample (stands in for the blob-hull ROI,
    ref detect_largest_blob utils/util_cylinder.py:1830-1899).

    The chain runs at 1/4 resolution: the ROI feeds a bbox, an inside-gate
    for centroids, and mask ANDs whose reference counterpart carries +35 px
    margins, so quarter-pixel boundary fidelity is irrelevant, and the
    dilate + fill run on 16x fewer pixels."""
    largest = labeling.largest_component_mask(labels, k=k) & merged
    filled = labeling.fill_orthoconvex(largest)
    h4 = -(-h // 4)
    w4 = -(-w // 4)
    filled = filled[_SHIFT4:_SHIFT4 + h4, _SHIFT4:_SHIFT4 + w4]
    return jnp.repeat(jnp.repeat(filled, 4, axis=0), 4, axis=1)[:h, :w]


def _roi_plane_from_labels(
    th: jnp.ndarray, labels: jnp.ndarray, cfg: PlaneDetectConfig
) -> jnp.ndarray:
    """Threshold-127 hull ROI (ref get_convex_hull utils/util_plane.py:2590-2689),
    largest blob resolved at 1/4 resolution from the shared lowres labeling."""
    h, w = th.shape
    largest4 = labeling.largest_component_mask(
        labels, k=cfg.roi_blob_k
    )
    h4 = -(-h // 4)
    w4 = -(-w // 4)
    largest4 = largest4[_SHIFT4:_SHIFT4 + h4, _SHIFT4:_SHIFT4 + w4]
    largest = (
        jnp.repeat(jnp.repeat(largest4, 4, axis=0), 4, axis=1)[:h, :w] & th
    )
    hull = labeling.fill_orthoconvex(largest)
    return morphology.dilate_rect(hull, 2 * cfg.roi_expand + 1, 2 * cfg.roi_expand + 1)


def _bbox_of(mask: jnp.ndarray) -> jnp.ndarray:
    """(x, y, w, h) int32 bounding box of a bool mask (cv2.boundingRect)."""
    h, w = mask.shape
    cols_any = jnp.any(mask, axis=0)
    rows_any = jnp.any(mask, axis=1)
    xs = jnp.arange(w)
    ys = jnp.arange(h)
    x0 = jnp.min(jnp.where(cols_any, xs, w))
    x1 = jnp.max(jnp.where(cols_any, xs, -1))
    y0 = jnp.min(jnp.where(rows_any, ys, h))
    y1 = jnp.max(jnp.where(rows_any, ys, -1))
    return jnp.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1]).astype(jnp.int32)


def _center_seed(
    cents: jnp.ndarray,
    cvalid: jnp.ndarray,
    gray: jnp.ndarray,
    bbox: jnp.ndarray,
    cfg: DetectConfig,
    bright_img: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Brightest joint inside the ROI bbox + distance to its 2nd neighbor
    (ref find_cylinder_centroids_and_center utils/util_cylinder.py:1902-1941)."""
    x0, y0, bw, bh = bbox[0], bbox[1], bbox[2], bbox[3]
    inside = (
        cvalid
        & (cents[:, 0] >= x0)
        & (cents[:, 0] < x0 + bw)
        & (cents[:, 1] >= y0)
        & (cents[:, 1] < y0 + bh)
    )
    xi = jnp.clip(cents[:, 0].astype(jnp.int32), 0, gray.shape[1] - 1)
    yi = jnp.clip(cents[:, 1].astype(jnp.int32), 0, gray.shape[0] - 1)
    if bright_img is None and getattr(cfg, "bright_at_points", False):
        from cylinder_pose_estimation_tpu.ops import mxu_conv as mxc

        pc = 2 * cfg.center_patch_half + 1
        vals = mxc.conv_at_points(gray, yi, xi, mxc.box_taps(pc)) / float(
            pc * pc
        )
    else:
        if bright_img is None:
            patch = 2 * cfg.center_patch_half + 1
            bright_img = box_filter(gray, patch, mode="constant")
        vals = bright_img[yi, xi]
    bright = jnp.where(inside, vals, -jnp.inf)
    ci = jnp.argmax(bright)
    center = cents[ci]
    d = jnp.linalg.norm(cents - center, axis=-1)
    d = jnp.where(inside, d, jnp.inf)
    # 2nd nearest (the nearest is the center itself): two masked mins instead
    # of a full sort (chosen for the first target accelerator, where a
    # 512-sort was slow).
    i1 = jnp.argmin(d)
    d2 = jnp.min(jnp.where(jnp.arange(d.shape[0]) == i1, jnp.inf, d))
    d2 = jnp.where(jnp.isfinite(d2), d2, 0.0)
    return center, jnp.floor(d2), inside


def _saturation_carve(
    gray: jnp.ndarray,
    h_mask: jnp.ndarray,
    v_mask: jnp.ndarray,
    roi_mask: jnp.ndarray,
    cfg: DetectConfig,
    sat: jnp.ndarray | None = None,
    sat_small: jnp.ndarray | None = None,
    sat_labels: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Carve the saturated (specular) blob out of the line masks
    (ref mask_roi_around_center utils/util_cylinder.py:1944-2007).

    The blob's centroid/circumradius are measured at quarter resolution:
    specular blobs survive a 19x19 Gaussian + threshold-240, so they are
    tens of pixels across, and the measurements feed only heuristic carve
    sizes (+20/+5 radius pads, ellipse semi-axes, bridge kernel length) where
    ~2 px of quantization is immaterial, at 16x fewer pixels than full
    resolution.  ``sat_small``/``sat_labels`` (padded
    lowres space, see _pool4_pad) come from the shared one-launch lowres
    labeling when the caller is detect_grid."""
    if sat is None:
        blurred = gaussian_blur_cv(gray, cfg.sat_blur_ksize)
        sat = blurred > cfg.sat_threshold
    hgt, wdt = gray.shape
    small = _pool4_pad(sat) if sat_small is None else sat_small
    labels = (
        labeling.connected_components(small, iters=8)
        if sat_labels is None
        else sat_labels
    )
    # 32 scan-order slots: glare-heavy scenes can have > 16 small saturated
    # reflections PRECEDING the main specular blob in raster order, and a
    # dropped main blob miscenters the carve (same pitfall as roi_blob_k).
    stats = labeling.component_stats_first_k(labels, k=32, compute_bbox=False)
    li = jnp.argmax(stats.count)  # largest saturated blob
    has = stats.valid[li]
    # Canvas block (i, j) covers full-res [4(i-_SHIFT4), ...) x 4 (content is
    # shifted by _SHIFT4 inside the padded canvas, see _pool4_pad).
    cx = 4.0 * (stats.centroid[li, 0] - _SHIFT4) + 1.5
    cy = 4.0 * (stats.centroid[li, 1] - _SHIFT4) + 1.5
    # Circumscribing radius: max distance from the centroid to blob blocks
    # (+2.2 px block half-diagonal so the lowres estimate still circumscribes).
    sh, sw = small.shape
    yy_s = 4.0 * (jnp.arange(sh, dtype=jnp.float32)[:, None] - _SHIFT4) + 1.5
    xx_s = 4.0 * (jnp.arange(sw, dtype=jnp.float32)[None, :] - _SHIFT4) + 1.5
    blob = labels == stats.root[li]
    dist_s = jnp.sqrt((xx_s - cx) ** 2 + (yy_s - cy) ** 2) + 2.2
    radius0 = jnp.where(has, jnp.max(jnp.where(blob, dist_s, 0.0)), 0.0)
    r0i = jnp.floor(radius0)
    yy = jnp.arange(hgt, dtype=jnp.float32)[:, None]
    xx = jnp.arange(wdt, dtype=jnp.float32)[None, :]
    # ref :1979-1983: small blobs get +20, large +5
    radius = jnp.where(r0i < 30, r0i + 20.0, r0i + 5.0)
    # ellipse axes (ref :1986-1991): semi-x (r+40)/2, semi-y (r+20)/2
    ax = (radius + 40.0) / 2.0
    ay = jnp.maximum(radius + 20.0, 1.0) / 2.0
    in_ellipse = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
    carve = has & in_ellipse
    domain = ~carve & roi_mask  # where mh/mv can possibly be set
    mh = h_mask & domain
    mv = v_mask & domain
    mh = morphology.open_rect(mh, 3, 3)
    mv = morphology.open_rect(mv, 3, 3)
    return mh, mv, r0i, domain


def _bridge_angle_exp(
    out: jnp.ndarray,
    labels: jnp.ndarray,
    base_angle: float,
    cfg: DetectConfig,
    scale: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Median component orientation + per-pixel expandability gate for ONE
    line mask: the n=1 view of _bridge_angle_exp_pair.

    The reference takes the median of per-contour PCA angles
    (ref expand_line_roi utils/util_cylinder.py:78-135) and skips contours
    whose extent exceeds bridge_long_frac * max extent on the cylinder path
    (ref :169) -- unbroken full-length lines stay untouched, so tightly
    spaced neighbors cannot be bridged into one label.

    base_angle pins the orientation branch (0 rows, pi/2 cols).

    ``scale``: labels/out may live at 1/scale resolution (label_downsample):
    second-moment extents are rescaled to full-res pixels so the min/max/
    long-frac gates keep their reference-pixel meaning, and the returned
    expandability gate is at the small resolution (caller upsamples)."""
    angles, exps = _bridge_angle_exp_pair(
        out[None], labels[None], cfg, scale=scale,
        bases=(float(base_angle),),
    )
    return angles[0], exps[0]


def _bridge_angle_exp_pair(
    outs: jnp.ndarray,
    labels: jnp.ndarray,
    cfg: DetectConfig,
    scale: int = 1,
    bases: Tuple[float, ...] = (0.0, float(jnp.pi / 2)),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Median component orientation + expandability gates for a BATCH of
    line masks (the h/v pair) in ONE batched stats launch.

    Equivalent to per-mask calls (vmap is elementwise over the batch axis;
    h gets base angle 0, v gets pi/2) but the component-stats one-hot
    matmuls and the (HW, K) gate compare run as a single (n, ...)-batched
    launch instead of n -- the stats payload reads amortize and the
    dispatch count halves.

    outs/labels: (n, Hs, Ws).  Returns (angles (n,), exp_imgs (n, Hs, Ws)).
    """
    n, hgt, wdt = outs.shape
    base = jnp.asarray(bases, jnp.float32)
    quarter = cfg.bridge_stats_quarter and hgt % 2 == 0 and wdt % 2 == 0
    if quarter:
        # Moment sums over 2x2-min-pooled labels: label VALUES stay half-res
        # linear indices, so component_stats_first_k gets value_shape to map
        # each value to the pooled block holding its root (the plain
        # flat == lin root test can never match after pooling).  Component
        # identity survives the pooling (distinct line masks sit > 2 small-px
        # apart), the sel/onehot matmuls shrink 4x, and second moments of
        # the block pattern approximate the pixel moments (the consumers are
        # a MEDIAN and px-scale threshold gates).  The full-res gate compare
        # below still uses the half-res labels against the value-space roots.
        # The 2x2 min is four strided slices: as an int32 reduce_window it
        # returned wrong values on an H100 (labeling.window_extreme).
        stats_labels = jnp.minimum(
            jnp.minimum(labels[:, 0::2, 0::2], labels[:, 0::2, 1::2]),
            jnp.minimum(labels[:, 1::2, 0::2], labels[:, 1::2, 1::2]),
        )
        stats_scale = 2.0
        min_area = 1
        value_shape = (hgt, wdt)
    else:
        stats_labels = labels
        stats_scale = 1.0
        min_area = 4 if scale == 1 else 2
        value_shape = None
    stats = jax.vmap(
        lambda l: labeling.component_stats_first_k(
            l,
            k=cfg.bridge_stats_k,
            min_area=min_area,
            compute_bbox=False,
            value_shape=value_shape,
        )
    )(stats_labels)
    ang = jax.vmap(labeling.component_orientation)(stats)  # (n, K)
    # wrap into (base - pi/2, base + pi/2]
    ang = ang - base[:, None]
    ang = jnp.arctan2(jnp.sin(ang), jnp.cos(ang))
    ang = jnp.where(ang > jnp.pi / 2, ang - jnp.pi, ang)
    ang = jnp.where(ang <= -jnp.pi / 2, ang + jnp.pi, ang)
    # Segment extent from second moments: a uniform segment of length L has
    # variance L^2/12 along its axis, so L = sqrt(12 * lambda_max).  This is
    # the reference's own measure (per-contour PCA endpoint length, ref
    # get_pca_endpoints utils/util_cylinder.py:35-55) and avoids the four
    # (H*W, K) masked bbox reductions.
    half_tr = 0.5 * (stats.mxx + stats.myy)
    half_df = 0.5 * (stats.mxx - stats.myy)
    lam_max = half_tr + jnp.sqrt(half_df * half_df + stats.mxy * stats.mxy)
    diag = (float(scale) * stats_scale) * jnp.sqrt(
        12.0 * jnp.maximum(lam_max, 0.0)
    )
    gate_med = stats.valid & (diag >= cfg.bridge_min_len) & (
        diag <= cfg.bridge_max_len
    )
    med = jnp.nanmedian(jnp.where(gate_med, ang, jnp.nan), axis=1)  # (n,)
    angle = jnp.where(jnp.isnan(med), 0.0, med) + base
    # Per-pixel expansion gate: short (broken) segments only.  The gate map
    # is built by comparing the label image against the K expandable roots
    # ((HW, K) compare + any) instead of a scatter-into-table + HW gather
    # (chosen for the first target accelerator; not measured on the GPU).
    if cfg.bridge_skip_long:
        # Exclude SPECKS (diag < bridge_min_len) from expansion and from the
        # long-frac reference maximum: the reference's size gate (ref
        # expand_line_roi utils/util_cylinder.py:168-170) keeps tiny
        # contours out of the expansion list, and a speck's diag ~ 0
        # trivially passes the long-frac test only to be dilated with the
        # ~100 px oriented kernel -- fusing adjacent grid lines.  Segments
        # LONGER than bridge_max_len stay in the maximum (that cap gates the
        # median's angle fan, not the length reference).
        sized = stats.valid & (diag >= cfg.bridge_min_len)
        max_diag = jnp.max(jnp.where(sized, diag, 0.0), axis=1, keepdims=True)
        expandable = sized & (diag <= cfg.bridge_long_frac * max_diag)
        hit = (
            labels.reshape(n, -1)[:, :, None] == stats.root[:, None, :]
        ) & expandable[:, None, :]
        exp_img = jnp.any(hit, axis=-1).reshape(n, hgt, wdt)
    else:
        exp_img = outs
    return angle, exp_img


def _n_components(masks, labels) -> jnp.ndarray:
    """Count 8-connected components from min-linear-index labels: exactly
    one pixel per component holds its own raster index (for a converged
    labeling; under-convergence overcounts, which only makes the
    bridged-components diagnostic conservative).  Accepts (H, W) or a
    leading stack axis."""
    h, w = masks.shape[-2], masks.shape[-1]
    idx = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    root = masks & (labels.astype(jnp.int32) == idx)
    return jnp.sum(root).astype(jnp.int32)


def _bridge(
    mask: jnp.ndarray,
    base_angle: float,
    kernel_len: jnp.ndarray,
    max_kernel_len: int,
    cfg: DetectConfig,
    pre_pooled: bool = False,
    probe_len: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bridge broken line segments along their direction
    (ref expands_line_roi utils/util_cylinder.py:137-237).

    Per repeat: label components, take the *median* component orientation,
    detect endpoints (mask pixels whose directional probe is empty), and
    dilate them with an oriented line kernel of traced length; 3x3 erosion
    follows, as in the reference (ref :186-189).

    Labeling + component stats run at 1/label_downsample resolution (2x2
    max-pool): component identity survives pooling for line masks whose
    spacing exceeds 2 px, and the angle/extent statistics feed px-scale
    gates where half-pixel quantization is immaterial.

    ``pre_pooled``: the mask is ALREADY at label (half) resolution on the
    padded canvas, and the morphology runs there too (cfg.bridge_half_res);
    the caller halves kernel/probe lengths.

    Returns (bridged_mask, median_component_angle) -- the angle feeds the
    steep-diagonal stability fence (DetectResult.max_line_tilt)."""
    h_img, w_img = mask.shape
    ds = cfg.label_downsample
    probe = cfg.endpoint_probe_len if probe_len is None else probe_len
    out = mask
    angle = jnp.asarray(base_angle, jnp.float32)
    for _ in range(cfg.bridge_repeats):
        if pre_pooled:
            small = out
        else:
            small = _pool2_pad(out) if ds == 2 else out
        labels = labeling.connected_components(small, iters=cfg.cc_iters // 2)
        angle, exp_img = _bridge_angle_exp(small, labels, base_angle, cfg, scale=ds)
        if ds == 2 and not pre_pooled:
            exp_img = _upsample2(exp_img, h_img, w_img)
        fwd = morphology.directional_count(out, angle, probe, +1)
        bwd = morphology.directional_count(out, angle, probe, -1)
        endpoints = out & exp_img & ((fwd <= 1.0) | (bwd <= 1.0))
        grown = morphology.dilate_line(endpoints, angle, max_kernel_len, kernel_len)
        grown = morphology.dilate_rect(grown, 3, 3)  # give the line thickness
        out = out | (morphology.erode_rect(out | grown, 3, 3) & grown)
    return out, angle


def _bridge_pair(
    mh: jnp.ndarray,
    mv: jnp.ndarray,
    kernel_len: jnp.ndarray,
    max_kernel_len: int,
    cfg: DetectConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Bridge the h/v line-mask pair.

    Returns (h_bridged, v_bridged, angles): angles is the (2,) [h, v] median
    component orientation from the last bridge repeat; it feeds the
    steep-diagonal stability fence (DetectResult.max_line_tilt).

    Under bridge_half_res (+ label_downsample 2) the whole bridge runs at
    half resolution -- pooled masks, halved kernel reach and probe -- and
    returns masks on the half-res padded canvas (their only consumer is the
    half-res labeling CC)."""
    if cfg.label_downsample == 2 and cfg.bridge_half_res:
        # Halve the endpoint probe with the kernel: the probe counts mask
        # pixels within probe_len along the mask's own resolution, so an
        # unscaled probe would reach twice as far and see "more line ahead"
        # across exactly the gaps bridging targets.
        kl = kernel_len / 2.0
        mk = max(max_kernel_len // 2, 1)
        pr = max(2, (cfg.endpoint_probe_len + 1) // 2)
        h_out, h_ang = _bridge(_pool2_pad(mh), 0.0, kl, mk, cfg,
                               pre_pooled=True, probe_len=pr)
        v_out, v_ang = _bridge(_pool2_pad(mv), jnp.pi / 2, kl, mk, cfg,
                               pre_pooled=True, probe_len=pr)
    else:
        h_out, h_ang = _bridge(mh, 0.0, kernel_len, max_kernel_len, cfg)
        v_out, v_ang = _bridge(mv, jnp.pi / 2, kernel_len, max_kernel_len, cfg)
    return h_out, v_out, jnp.stack([h_ang, v_ang])


def _assign_labels(
    label_img: jnp.ndarray,
    cents: jnp.ndarray,
    cvalid: jnp.ndarray,
    capacity: int,
    scale: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Map each centroid to the component label under it (3x3 tolerant),
    compacted to [0, capacity) slot ids (ref group_points_by_label
    utils/util_cylinder.py:376-389).  ``scale``: label_img may live at
    1/scale resolution (labels are only keys; centroids index the pooled
    grid)."""
    h, w = label_img.shape
    hw = h * w
    xi = jnp.clip((cents[:, 0] / scale).astype(jnp.int32), 1, w - 2)
    yi = jnp.clip((cents[:, 1] / scale).astype(jnp.int32), 1, h - 2)
    # 3x3-tolerant label lookup as a dense separable 3x3 min THEN one gather
    # per centroid: 9 taps become 1 gather with identical semantics (min
    # over the 3x3 neighborhood); the form was chosen for the first target
    # accelerator, where scattered-point gathers were slow.
    m3 = labeling.window_extreme(label_img, 3, 1, jnp.int32(hw))
    m3 = labeling.window_extreme(m3, 1, 3, jnp.int32(hw))
    best = m3.reshape(-1)[yi * w + xi]
    assigned = cvalid & (best < hw)
    roots = jnp.where(assigned, best, hw)
    # Slot retention is by member count (centroids on the component), not
    # scan order: with more components than capacity, small clutter fragments
    # must not evict true grid lines.  Dominance counting over the (P, P)
    # compare matrix replaces the previous 3-sorts + argsort + searchsorted
    # formulation (P ~ 512; chosen for the first target accelerator, where
    # sorts were slow).
    p = roots.shape[0]
    pos = jnp.arange(p, dtype=jnp.int32)
    eq = (roots[:, None] == roots[None, :]) & assigned[None, :]  # (P, P)
    count = jnp.sum(eq, axis=1)  # members per root (0 for unassigned rows)
    is_first = assigned & (
        jnp.sum(eq & (pos[None, :] < pos[:, None]), axis=1) == 0
    )
    # Keep the top-`capacity` distinct roots by (count desc, root asc) --
    # identical to the old stable argsort(-count) over ascending uniques.
    better = is_first[None, :] & (
        (count[None, :] > count[:, None])
        | ((count[None, :] == count[:, None]) & (roots[None, :] < roots[:, None]))
    )
    kept = is_first & (jnp.sum(better, axis=1) < capacity)
    # Slot ids: rank of the root among kept roots, ascending.
    root_lt = kept[None, :] & (roots[None, :] < roots[:, None])
    slot_of = jnp.sum(root_lt, axis=1).astype(jnp.int32)
    ok = assigned & jnp.any(eq & kept[None, :], axis=1)
    n_kept = jnp.sum(kept.astype(jnp.int32))
    slot_valid = jnp.arange(capacity) < n_kept
    slot_of = jnp.clip(slot_of, 0, capacity - 1)
    return jnp.where(ok, slot_of, capacity - 1), ok, slot_valid


def _fit_label_polys(
    cents: jnp.ndarray,
    slot_of: jnp.ndarray,
    ok: jnp.ndarray,
    capacity: int,
    degree: int,
    margin: float,
    swap_xy: bool,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-label polynomial fit over member centroids, one batched solve
    (ref fit_and_draw_polynomial utils/util_cylinder.py:473-550).

    Rows fit y = f(x); cols (swap_xy) fit x = g(y).  Returns (coeffs, domain,
    valid, count)."""
    x = cents[:, 1] if swap_xy else cents[:, 0]
    y = cents[:, 0] if swap_xy else cents[:, 1]
    w = (
        (slot_of[None, :] == jnp.arange(capacity)[:, None]) & ok[None, :]
    ).astype(x.dtype)  # (capacity, P)
    xs = jnp.broadcast_to(x, w.shape)
    ys = jnp.broadcast_to(y, w.shape)
    coeffs = masked_polyfit(xs, ys, w, degree)
    domain = poly_domain(xs, w, margin)
    count = jnp.sum(w, axis=-1)
    valid = count >= degree + 1
    return coeffs, domain, valid, count


def _fit_label_polys_pair(
    cents: jnp.ndarray,
    row_of: jnp.ndarray,
    row_ok: jnp.ndarray,
    col_of: jnp.ndarray,
    col_ok: jnp.ndarray,
    cfg: DetectConfig,
):
    """Row AND col polynomial fits in one (R+C)-batched solve.

    Same math as two _fit_label_polys calls (rows: y=f(x), cols: x=g(y))
    but a single masked_polyfit/poly_domain launch -- the solves are tiny,
    so one batched solve of 48 replaces two of 24."""
    r, c = cfg.max_rows, cfg.max_cols
    x, y = cents[:, 0], cents[:, 1]
    w_r = ((row_of[None, :] == jnp.arange(r)[:, None]) & row_ok[None, :]).astype(x.dtype)
    w_c = ((col_of[None, :] == jnp.arange(c)[:, None]) & col_ok[None, :]).astype(x.dtype)
    w = jnp.concatenate([w_r, w_c], axis=0)  # (R+C, P)
    xs = jnp.concatenate(
        [jnp.broadcast_to(x, w_r.shape), jnp.broadcast_to(y, w_c.shape)], axis=0
    )
    ys = jnp.concatenate(
        [jnp.broadcast_to(y, w_r.shape), jnp.broadcast_to(x, w_c.shape)], axis=0
    )
    coeffs = masked_polyfit(xs, ys, w, cfg.poly_degree)
    domain = poly_domain(xs, w, cfg.domain_margin)
    count = jnp.sum(w, axis=-1)
    valid = count >= cfg.poly_degree + 1
    return (
        (coeffs[:r], domain[:r], valid[:r], count[:r]),
        (coeffs[r:], domain[r:], valid[r:], count[r:]),
    )


def _label_mean(
    vals: jnp.ndarray, slot_of: jnp.ndarray, ok: jnp.ndarray, capacity: int
) -> jnp.ndarray:
    """Per-label masked mean of a per-centroid value."""
    onehot = (slot_of[None, :] == jnp.arange(capacity)[:, None]) & ok[None, :]
    cnt = jnp.maximum(jnp.sum(onehot, axis=-1), 1)
    return jnp.sum(jnp.where(onehot, vals[None, :], 0.0), axis=-1) / cnt


def _merge_short_column_leaders(
    span: jnp.ndarray,
    mean_x: jnp.ndarray,
    valid: jnp.ndarray,
    capacity: int,
) -> jnp.ndarray:
    """Group leaders for the plane path's abnormal-short-column merge
    (ref utils/util_plane.py:449-557).

    The reference flags columns whose y span is <= 0.9x the maximum span as
    "abnormal", walks columns in label (x) order, and greedily merges runs of
    consecutive abnormal columns while the group's cumulative span stays
    <= the maximum span; a normal column closes the group.  Dense version:
    one lax.scan over x-sorted slots emitting each slot's group-leader slot.
    Returns leader[slot] (identity for normal/unmerged/invalid slots).
    """
    threshold = jnp.max(jnp.where(valid, span, 0.0))
    abnormal = valid & (span <= 0.9 * threshold)
    order = jnp.argsort(jnp.where(valid, mean_x, jnp.inf))

    def step(carry, slot):
        cum, leader, has_group = carry
        s = span[slot]
        v = valid[slot]
        ab = abnormal[slot]
        fits = has_group & (cum + s <= threshold)
        new_leader = jnp.where(fits, leader, slot)
        new_cum = jnp.where(fits, cum + s, s)
        emit = jnp.where(v & ab, new_leader, slot)
        # Invalid slots pass through without touching the open group.
        carry_cum = jnp.where(v, jnp.where(ab, new_cum, 0.0), cum)
        carry_leader = jnp.where(v, jnp.where(ab, new_leader, leader), leader)
        carry_has = jnp.where(v, ab, has_group)
        return (carry_cum, carry_leader, carry_has), emit

    init = (jnp.asarray(0.0, span.dtype), jnp.asarray(0, jnp.int32), jnp.asarray(False))
    _, emits = jax.lax.scan(step, init, order.astype(jnp.int32))
    return jnp.zeros((capacity,), jnp.int32).at[order].set(emits)


def _rank_by(key: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Dense rank of valid entries by key (invalid sink to the end).

    Dominance counting over the (N, N) compare matrix -- N is a label
    capacity (~24), so this is 3 vector ops in place of a stable argsort +
    scatter (chosen for the first target accelerator, where sorts were
    slow)."""
    k = jnp.where(valid, key, jnp.inf)
    n = k.shape[0]
    ar = jnp.arange(n)
    lt = (k[None, :] < k[:, None]) | (
        (k[None, :] == k[:, None]) & (ar[None, :] < ar[:, None])
    )
    return jnp.sum(lt, axis=1).astype(jnp.int32)


def detect_grid(
    image: jnp.ndarray, cfg: DetectConfig, return_debug: bool = False
):
    """Full single-image grid detection -> DetectResult (+ DetectDebug).

    image: (H, W) or (H, W, 3) uint8/float.  Jittable; vmap over a leading
    frame axis for batched detection (cfg is static).
    """
    dtype = jnp.float32 if cfg.image_dtype == "float32" else jnp.bfloat16
    gray = _to_gray(image, jnp.float32)

    # 1.-2. preprocess / binarize + line openings + joints.
    blurred = gaussian_blur_cv(gray.astype(dtype), cfg.blur_ksize)
    binary = binarize_ridges(
        blurred.astype(jnp.float32),
        cfg.ridge_sigma,
        cfg.sauvola_window,
        cfg.sauvola_k,
        cfg.sauvola_r,
        min_contrast=0.05,
    )
    # Border-margin band (_border_margin): the reference's own border ridges
    # are constant-padding artifacts that its blob ROI discards (PARITY.md,
    # known deviations); the margin is the spec here.
    mrg = _border_margin(cfg)
    rr = jnp.arange(gray.shape[0])[:, None]
    cc = jnp.arange(gray.shape[1])[None, :]
    inside = (
        (rr >= mrg) & (rr < gray.shape[0] - mrg)
        & (cc >= mrg) & (cc < gray.shape[1] - mrg)
    )
    binary = binary & inside
    h_mask = morphology.open_rect(binary, 1, cfg.line_kernel_len)
    v_mask = morphology.open_rect(binary, cfg.line_kernel_len, 1)
    joints = h_mask & v_mask
    # Statistic images + joint peaks (the box count is exact integer
    # arithmetic).
    jf = joints.astype(jnp.float32)
    joint_cnt = box_filter(jf, 11, mode="constant", normalize=False)
    joint_peak = _joint_peaks(joints, joint_cnt, cfg.joint_peak_iters)
    sat_mask, bright_center, bright_blur, joint_cx, joint_cy = (
        _stats_images(gray, jf, joint_cnt, cfg)
    )
    joint_pre = (joint_peak.astype(jnp.float32), joint_cx, joint_cy)
    # Profiling probes (cfg.stage_probe, static): return a scalar that
    # depends on everything computed so far; consecutive-stage timing diffs
    # give the per-stage cost without duplicating the pipeline in a harness.
    def _probe(*arrs):
        out = jnp.float32(0.0)
        for a in arrs:
            out = out + jnp.sum(a.astype(jnp.float32))
        return out

    if cfg.stage_probe == "preprocess":
        return _probe(binary, h_mask, v_mask, joints)
    cents, cvalid = _joint_centroids(joints, cfg, precomputed=joint_pre)
    if cfg.stage_probe == "centroids":
        return _probe(cents, cvalid)

    # 3.+5a. ROI + saturation-blob labeling share ONE batched lowres CC: the
    # detector needs exactly two quarter-res labelings per image.
    if cfg.mode == "cylinder":
        # One stacked pooling op for the saturation blob and the ROI seed
        # (bit-identical to two _pool4_pad calls).
        pooled = _pool4_pad(jnp.stack([sat_mask, h_mask | v_mask]))
        sat_small = pooled[0]
        roi_seed4 = morphology.dilate_rect(pooled[1], 9, 9)
    else:
        sat_small = _pool4_pad(sat_mask)
        roi_th = gray > cfg.roi_threshold  # type: ignore[attr-defined]
        roi_seed4 = _pool4_pad(roi_th)
    if cfg.stage_probe == "roi_seed":
        return _probe(cents, roi_seed4, sat_small)
    roi_labels, sat_labels = _cc_lowres_pair(roi_seed4, sat_small, cfg)
    if cfg.stage_probe == "roi_cc":
        return _probe(cents, roi_labels, sat_labels)

    h_img, w_img = gray.shape
    if cfg.mode == "cylinder":
        roi = _roi_cylinder_from_labels(
            roi_seed4, roi_labels, h_img, w_img,
            k=cfg.roi_blob_k,
        )
    else:
        roi = _roi_plane_from_labels(roi_th, roi_labels, cfg)  # type: ignore[arg-type]
    if cfg.stage_probe == "roi_mask":
        return _probe(cents, roi)
    bbox = _bbox_of(roi)
    if cfg.stage_probe == "roi":
        return _probe(cents, roi, bbox)

    # 4. center seed
    center, seed_radius, inside = _center_seed(
        cents, cvalid, gray, bbox, cfg, bright_img=bright_center
    )
    if cfg.stage_probe == "seed":
        return _probe(cents, center, seed_radius, inside)

    # 5. saturation carve
    mh, mv, circle_radius0, carve_domain = _saturation_carve(
        gray, h_mask, v_mask, roi, cfg,
        sat=sat_mask, sat_small=sat_small, sat_labels=sat_labels,
    )
    if cfg.stage_probe == "carve":
        return _probe(cents, inside, mh, mv, circle_radius0)

    # 6a. bridge lines
    kernel_len = jnp.asarray(cfg.bridge_kernel_base, jnp.float32) + circle_radius0
    max_kernel = cfg.bridge_kernel_base + 160
    h_exp, v_exp, bridge_angles = _bridge_pair(mh, mv, kernel_len, max_kernel, cfg)
    if cfg.stage_probe == "bridge":
        return _probe(cents, inside, h_exp, v_exp)
    if cfg.stage_probe == "bridge_state":
        # Test-only probe (tests/test_detect_oracle.py): the exact inputs of
        # the bookkeeping chain (group -> sort -> fit -> prune -> intersect
        # -> relabel -> index -> json), so an independent literal oracle can
        # replay stages 6b-6g from the same state.  h_exp/v_exp live on the
        # half-res padded canvas under the default bridge_half_res.
        return {
            "cents": cents,
            "inside": inside,
            "bbox": bbox,
            "h_exp": h_exp,
            "v_exp": v_exp,
            "circle_radius0": circle_radius0,
            "gray": gray,
        }

    # 6b. label rows/cols and assign centroids (labeling at
    # 1/label_downsample resolution -- labels are only grouping keys for the
    # centroids, and 2x2 pooling preserves component identity for line masks
    # spaced > 2 px apart)
    ds = cfg.label_downsample
    if ds == 2 and not cfg.bridge_half_res:
        hv_masks = jnp.stack([_pool2_pad(h_exp), _pool2_pad(v_exp)])
    else:
        # bridge_half_res: _bridge_pair already returned masks on the
        # half-res padded canvas; label them directly.
        hv_masks = jnp.stack([h_exp, v_exp])
    # NOTE: labeling at QUARTER resolution (one more 2x2 pool) was tried and
    # rejected: it loses grid points (24/32 on 5 of 16 bench scenes -- thin
    # lines vanish under the second pool).  Half-res is the floor for the
    # final labeling CC.
    assign_scale = ds
    h_labels = labeling.connected_components(hv_masks[0], iters=cfg.cc_iters)
    v_labels = labeling.connected_components(hv_masks[1], iters=cfg.cc_iters)
    # Pre-bridge masks on the SAME canvas as hv_masks, labeled at the full
    # cc_iters budget so bridged_components is exact.
    n_pre_components = jnp.int32(0)
    if cfg.bridge_repeats > 0:
        pre_masks = (
            jnp.stack([_pool2_pad(mh), _pool2_pad(mv)])
            if ds == 2
            else jnp.stack([mh, mv])
        )
        pre_lab = jnp.stack(
            [labeling.connected_components(pre_masks[0], iters=cfg.cc_iters),
             labeling.connected_components(pre_masks[1], iters=cfg.cc_iters)]
        )
        n_pre_components = _n_components(pre_masks, pre_lab)
    if cfg.stage_probe == "labels":
        return _probe(cents, inside, h_labels, v_labels)
    # Convergence diagnostic (exact): min-propagation labeling is at its
    # fixpoint iff no mask pixel has an 8-neighbor (within the mask) holding
    # a smaller label.  Detects the under-converged CC regime of
    # steep-diagonal scenes (PARITY.md, known deviations); feeds
    # DetectResult.stable.
    lab_pair = jnp.stack([h_labels, v_labels]).astype(jnp.int32)
    labels_converged = labeling.fixpoint_residual(lab_pair, hv_masks) == 0
    # Bridging observability (DetectResult.bridged_components): components
    # merged by line bridging = pre-bridge fragment count minus the final
    # post-bridge count (both from min-linear-index labelings on the same
    # half-res canvas, at the same cc_iters budget).  End-of-line
    # extensions -- which bridging performs on EVERY scene -- do not merge
    # components, so this is 0 exactly when no gap was closed.
    # bridge_repeats=0 leaves n_pre=0 -> clamped to 0.
    n_post_components = _n_components(hv_masks, lab_pair)
    bridged_components = jnp.maximum(n_pre_components - n_post_components, 0)
    if cfg.max_rows == cfg.max_cols:
        # Rows + cols in ONE vmapped call: _assign_labels is ~15 small
        # (P, P) reductions.  vmap over the stacked label pair is
        # numerically identical (every op is elementwise over the pair
        # axis).
        rc_of, rc_ok, _ = jax.vmap(
            lambda li: _assign_labels(
                li, cents, inside, cfg.max_rows, scale=assign_scale
            )
        )(jnp.stack([h_labels, v_labels]))
        row_of, row_ok = rc_of[0], rc_ok[0]
        col_of, col_ok = rc_of[1], rc_ok[1]
    else:
        row_of, row_ok, _ = _assign_labels(
            h_labels, cents, inside, cfg.max_rows, scale=assign_scale
        )
        col_of, col_ok, _ = _assign_labels(
            v_labels, cents, inside, cfg.max_cols, scale=assign_scale
        )
    if cfg.stage_probe == "assign":
        return _probe(cents, row_of, row_ok, col_of, col_ok)

    # 6c. per-label polynomial fits (rows + cols in one batched solve)
    (
        (row_coeffs, row_dom, row_valid, row_count),
        (col_coeffs, col_dom, col_valid, col_count),
    ) = _fit_label_polys_pair(cents, row_of, row_ok, col_of, col_ok, cfg)

    # 6c''. plane-path short-column merge (ref utils/util_plane.py:449-557):
    # fragments of one physical column that failed to bridge show up as
    # several short labels; merge consecutive short labels and refit so the
    # integer column indices (and hence stereo correspondences) stay correct.
    if cfg.merge_short_cols:
        span = jnp.where(
            col_valid,
            (col_dom[:, 1] - col_dom[:, 0])
            - 2.0 * cfg.domain_margin
            + 2.0 * cfg.merge_margin,
            0.0,
        )
        mean_x = _label_mean(cents[:, 0], col_of, col_ok, cfg.max_cols)
        leader = _merge_short_column_leaders(span, mean_x, col_valid, cfg.max_cols)
        col_of = leader[col_of]
        col_coeffs, col_dom, col_valid, col_count = _fit_label_polys(
            cents, col_of, col_ok, cfg.max_cols, cfg.poly_degree,
            cfg.domain_margin, True,
        )

    if cfg.stage_probe == "polyfit":
        return _probe(row_coeffs, row_valid, col_coeffs, col_valid, row_dom, col_dom)

    # 6c'. optional subpixel refinement of the fitted curves toward the
    # grayscale center of gravity (the reference ships this but keeps it off
    # its main path, ref :2040; enable via cfg.subpixel_refine)
    if cfg.subpixel_refine:
        from cylinder_pose_estimation_tpu.models.refine import refine_curves_cog

        row_coeffs = refine_curves_cog(
            gray, row_coeffs, row_dom, row_valid, cfg.poly_degree,
            n_samples=cfg.subpixel_samples, window=cfg.subpixel_window,
            swap_xy=False,
        )
        col_coeffs = refine_curves_cog(
            gray, col_coeffs, col_dom, col_valid, cfg.poly_degree,
            n_samples=cfg.subpixel_samples, window=cfg.subpixel_window,
            swap_xy=True,
        )

    # 6d. prune first row / last col (ref remove_label utils/util_cylinder.py:1211-1269).
    # "First"/"last" are positions in the reference's stored key order, which
    # is min-member-y sorted for BOTH rows and cols: group_points_by_label
    # hardcodes sort_rows (ref :376-394; sort_cols exists but is never called
    # on the main path).  So the dropped col is the one whose TOPMOST point
    # sits lowest in the image -- usually an arc-end column, NOT necessarily
    # the rightmost (caught by the literal bookkeeping oracle,
    # tests/test_detect_oracle.py; the pre-r5 code dropped max min-x).
    # The ordering domain is every group with >= 1 member (dummy sub-degree
    # groups included, ref create_dummy_rows_cols :401-430), hence the
    # count >= 1 occupancy mask rather than the fitted `*_valid`.
    if getattr(cfg, "drop_first_row", False):
        row_min_y = _label_extreme(cents[:, 1], row_of, row_ok, cfg.max_rows, "min")
        first = jnp.argmin(jnp.where(row_count >= 1, row_min_y, jnp.inf))
        row_valid = row_valid & (jnp.arange(cfg.max_rows) != first)
    if getattr(cfg, "drop_last_col", False):
        col_min_y = _label_extreme(cents[:, 1], col_of, col_ok, cfg.max_cols, "min")
        last = jnp.argmax(jnp.where(col_count >= 1, col_min_y, -jnp.inf))
        col_valid = col_valid & (jnp.arange(cfg.max_cols) != last)

    # 6e. intersections (ref find_and_assign_intersections_P :1106-1151)
    x0 = 0.5 * (row_dom[:, 0] + row_dom[:, 1])
    xi, yi = poly_intersection(
        row_coeffs[:, None, :],
        col_coeffs[None, :, :],
        jnp.broadcast_to(x0[:, None], (cfg.max_rows, cfg.max_cols)),
        iters=cfg.newton_iters,
    )
    tol = cfg.intersection_tol
    bx0, by0 = bbox[0].astype(jnp.float32), bbox[1].astype(jnp.float32)
    bx1 = bx0 + bbox[2].astype(jnp.float32)
    by1 = by0 + bbox[3].astype(jnp.float32)
    residual_ok = jnp.abs(xi - polyval(col_coeffs[None, :, :], yi)) < 0.5
    accept = (
        row_valid[:, None]
        & col_valid[None, :]
        & (xi >= row_dom[:, None, 0] - tol)
        & (xi <= row_dom[:, None, 1] + tol)
        & (yi >= col_dom[None, :, 0] - tol)
        & (yi <= col_dom[None, :, 1] + tol)
        # INCLUSIVE upper bound on purpose: the reference's intersection
        # gate is rect_x <= x <= rect_x + rect_w (ref
        # find_and_assign_intersections_P utils/util_cylinder.py:1139) --
        # note its centroid filter uses the EXCLUSIVE x < x + w (ref :1918);
        # _center_seed mirrors that one.  The asymmetry is the reference's.
        & (xi >= bx0) & (xi <= bx1) & (yi >= by0) & (yi <= by1)
        & residual_ok
        & jnp.isfinite(xi) & jnp.isfinite(yi)
    )

    if cfg.stage_probe == "newton":
        return _probe(xi, yi, accept)

    # 6f. relabel by position (ref clean_and_relabel :1154-1206)
    any_row = jnp.any(accept, axis=1)
    any_col = jnp.any(accept, axis=0)
    mean_y = jnp.sum(jnp.where(accept, yi, 0.0), axis=1) / jnp.maximum(
        jnp.sum(accept, axis=1), 1
    )
    mean_x = jnp.sum(jnp.where(accept, xi, 0.0), axis=0) / jnp.maximum(
        jnp.sum(accept, axis=0), 1
    )
    row_rank = _rank_by(mean_y, any_row)
    col_rank = _rank_by(mean_x, any_col)

    # 6g. center indexing (ref indexing_data :1350-1571).  The brightness
    # patch is IMAGE-ADAPTIVE in the reference -- half-size scales with the
    # saturation-circle radius so the patch mean averages over a region
    # larger than a saturated center blob (the tie-breaker when several
    # extrapolated intersections inside the blob all read 255):
    #   cylinder: max(patch_half_min, floor(cr0/5)), +5 above 10 (ref
    #   utils/util_cylinder.py:1377-1379); plane: floor(cr/4.5) (ref
    #   utils/util_plane.py:1280; floored at 1 here -- below cr=4.5 the
    #   reference's empty patch yields NaN means and a first-point center,
    #   a degenerate regime not worth reproducing).
    # The bounds follow the reference's slice [int(x-h), int(x+h)) --
    # truncation, EXCLUSIVE upper, clipped area in the divisor -- via a
    # traced-range band-matmul rectangle mean (no static tap size can
    # express a traced half; no gather either).  r5 change: the old
    # static composed-taps patch deviated on large-blob scenes (documented
    # deviation now closed; pinned by the bookkeeping oracle's literal rule).
    from cylinder_pose_estimation_tpu.ops import mxu_conv as mxc

    if cfg.mode == "plane":
        half_b = jnp.maximum(jnp.floor(circle_radius0 / 4.5), 1.0)
    else:
        half_b = jnp.maximum(
            jnp.floor(circle_radius0 / 5.0), float(cfg.patch_half_min)
        )
        half_b = jnp.where(half_b > 10.0, half_b + 5.0, half_b)
    xf = xi.reshape(-1)
    yf = yi.reshape(-1)
    x0b = jnp.clip(jnp.floor(xf - half_b), 0, gray.shape[1]).astype(jnp.int32)
    x1b = jnp.clip(jnp.floor(xf + half_b), 0, gray.shape[1]).astype(jnp.int32)
    y0b = jnp.clip(jnp.floor(yf - half_b), 0, gray.shape[0]).astype(jnp.int32)
    y1b = jnp.clip(jnp.floor(yf + half_b), 0, gray.shape[0]).astype(jnp.int32)
    bvals = mxc.range_mean_at_points(bright_blur, y0b, y1b, x0b, x1b).reshape(
        xi.shape
    )
    bright = jnp.where(accept, bvals, -jnp.inf)
    flat_ci = jnp.argmax(bright.reshape(-1))
    c_r = flat_ci // cfg.max_cols
    c_c = flat_ci % cfg.max_cols

    row_idx = row_rank - row_rank[c_r]
    col_idx = col_rank - col_rank[c_c]
    if getattr(cfg, "drop_negative_cols", False):
        accept = accept & (col_idx[None, :] >= 0)

    # ids: cylinder (x=col, y=row) ref :1497; plane (row, col) ref plane :1398
    ri = jnp.broadcast_to(row_idx[:, None], accept.shape)
    ci = jnp.broadcast_to(col_idx[None, :], accept.shape)
    if cfg.id_row_major:
        ids = jnp.stack([ri, ci], axis=-1)
    else:
        ids = jnp.stack([ci, ri], axis=-1)

    n = cfg.max_rows * cfg.max_cols
    # Invalid slots must carry FINITE placeholders, not diverged-Newton
    # nan/inf: downstream consumers mask by `valid` but may multiply the
    # raw coords by a zero mask first (0 * nan = nan).
    xy_flat = jnp.stack([xi, yi], axis=-1).reshape(n, 2)
    accept_flat = accept.reshape(n)
    # center needs the same finite-placeholder guard as xy: with zero
    # accepted intersections the argmax over an all -inf brightness picks
    # slot (0, 0), whose raw xi/yi may hold a diverged-Newton inf/nan --
    # and StreamPoseSummary ships grid.center for ok=False frames too.
    center_ok = accept[c_r, c_c]
    grid = GridPoints(
        xy=jnp.where(accept_flat[:, None], xy_flat, 0.0),
        idx=ids.reshape(n, 2).astype(jnp.int32),
        valid=accept_flat,
        center=jnp.where(
            center_ok, jnp.stack([xi[c_r, c_c], yi[c_r, c_c]]), 0.0
        ),
    )
    # Fit feasibility: the downstream curvature-seeded fit needs ~knn_k
    # well-spread points (ref utils/estCurvatures.m:6); 4 points would run LM
    # on garbage with ok=True.
    ok = jnp.sum(accept) >= cfg.min_ok_points

    # Stability fence (PARITY.md, known deviations): median |line tilt| from the grid
    # axes, from the fitted polynomials' slopes at their domain midpoints.
    # Rows are y=f(x) (tilt from horizontal), cols x=g(y) (tilt from
    # vertical); the chaotic regime is steep diagonals on BOTH families.
    def _median_tilt(coeffs, dom, valid_lab):
        mid = 0.5 * (dom[:, 0] + dom[:, 1])
        slope = polyval(polyder(coeffs), mid)
        med = jnp.nanmedian(jnp.where(valid_lab, jnp.abs(slope), jnp.nan))
        return jnp.arctan(jnp.where(jnp.isnan(med), 0.0, med))

    poly_tilt = jnp.maximum(
        _median_tilt(row_coeffs, row_dom, row_valid),
        _median_tilt(col_coeffs, col_dom, col_valid),
    )
    # The bridge stage's median component orientations measure the same
    # quantity BEFORE the fragile grid-assembly stages, so a steep scene
    # whose assembly collapsed entirely (no fitted polys) is still fenced.
    # Deviation from each base axis, wrapped into (-pi/2, pi/2].
    base = jnp.asarray([0.0, jnp.pi / 2], jnp.float32)
    dev = jnp.mod(bridge_angles - base + jnp.pi / 2, jnp.pi) - jnp.pi / 2
    bridge_tilt = jnp.max(jnp.abs(dev))
    max_line_tilt = jnp.maximum(poly_tilt, bridge_tilt)
    # Beyond ~20 deg the axis-aligned openings shred lines into short
    # axis-aligned specks: the measured tilt drops back to ~0 while the
    # cascade goes chaotic.  The tell is retention -- the fraction of
    # binarized pixels surviving the openings (legit scenes >= 0.98,
    # the chaotic window 0.0-0.35; see cfg.min_mask_retention).
    # Numerator and denominator share the same domain (inside the ROI,
    # outside the saturation carve): binarized clutter OUTSIDE the ROI or
    # inside the carved specular ellipse never had a chance to survive the
    # openings, and counting it silently dropped healthy real-world frames
    # from frame_health (round-3 advisor finding).
    retention = jnp.sum(mh | mv) / jnp.maximum(
        jnp.sum(binary & carve_domain), 1.0
    )
    stable = (
        labels_converged
        & (max_line_tilt <= cfg.max_stable_tilt)
        & (retention >= cfg.min_mask_retention)
    )

    result = DetectResult(
        grid=grid, ok=ok, roi_bbox=bbox, circle_radius0=circle_radius0,
        labels_converged=labels_converged, max_line_tilt=max_line_tilt,
        stable=stable, bridged_components=bridged_components,
    )
    if not return_debug:
        return result
    debug = DetectDebug(
        binary=binary,
        h_mask=mh,
        v_mask=mv,
        roi_mask=roi,
        h_expanded=h_exp,
        v_expanded=v_exp,
        centroids=cents,
        centroids_valid=inside,
        center_seed=center,
        row_coeffs=row_coeffs,
        col_coeffs=col_coeffs,
        row_valid=row_valid,
        col_valid=col_valid,
    )
    return result, debug


def _label_extreme(
    vals: jnp.ndarray, slot_of: jnp.ndarray, ok: jnp.ndarray, capacity: int, kind: str
) -> jnp.ndarray:
    """Per-label min/max of a per-centroid value."""
    onehot = (slot_of[None, :] == jnp.arange(capacity)[:, None]) & ok[None, :]
    if kind == "min":
        return jnp.min(jnp.where(onehot, vals[None, :], jnp.inf), axis=-1)
    return jnp.max(jnp.where(onehot, vals[None, :], -jnp.inf), axis=-1)
