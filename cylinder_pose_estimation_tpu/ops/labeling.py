"""Connected components, component statistics and centroid extraction.

Replaces cv2.connectedComponents / cv2.findContours+moments
(ref utils/util_cylinder.py:24-33 label_and_color_masks, :1818-1827 joint
centroids, largest-contour selection throughout) with dense, jit-safe
equivalents over fixed shapes:

  * labels: iterative min-label propagation.  Each round does a segmented
    min-scan along rows then columns (forward+backward), which propagates
    across an entire straight run in one step -- so convergence needs
    O(#bends) rounds, not O(component diameter).  8-connectivity is restored
    by a 3x3 min-pool between scans.  Iteration count is static (config).
  * per-component stats: either sort-based segment reduction
    (``component_stats``, any component count) or scan-order first-K
    enumeration with one-hot matmul reductions (``component_stats_first_k``,
    the hot-path form) -- scatter-style segment_sum was pathological on the
    first target accelerator and is deliberately NOT used anywhere here
    (not measured on the GPU).
  * top/first-K components -> compact (K,) slots with masks, giving the
    fixed-capacity "contour list" every downstream stage consumes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

# Sentinel label for background (kept at num_segments index, dropped later).
def _bg(hw: int) -> int:
    return hw


def _segmented_min_scan(vals: jnp.ndarray, mask: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Min-scan along an axis, restarting at mask==False boundaries.

    Associative combine on (value, reset): a∘b = (b if b.reset else min(a,b)).
    """

    def combine(a, b):
        av, ar = a
        bv, br = b
        return jnp.where(br, bv, jnp.minimum(av, bv)), ar | br

    reset = ~mask
    fwd = lax.associative_scan(combine, (vals, reset), axis=axis)[0]
    bwd = lax.associative_scan(combine, (vals, reset), axis=axis, reverse=True)[0]
    return jnp.minimum(fwd, bwd)


def connected_components(mask: jnp.ndarray, iters: int = 16) -> jnp.ndarray:
    """Label 8-connected components of a bool (H, W) mask.

    Returns int32 labels: background pixels get H*W, foreground pixels the
    minimum linear index of their component (after `iters` rounds; components
    with more than ~2*iters direction changes may stay split -- iters is
    config-static and sized for laser-grid geometry).
    """
    h, w = mask.shape
    hw = h * w
    idx = jnp.arange(hw, dtype=jnp.int32).reshape(h, w)
    big = jnp.asarray(hw, jnp.int32)
    lab = jnp.where(mask, idx, big)
    fmask = mask.astype(jnp.float32)

    def round_fn(_, lab):
        # 3x3 min-pool over foreground (8-connectivity bridging).
        labf = jnp.where(mask, lab, big).astype(jnp.float32)
        pooled = -lax.reduce_window(
            -labf, -jnp.inf, lax.max, (3, 3), (1, 1), "SAME"
        )
        lab = jnp.where(mask, jnp.minimum(lab, pooled.astype(jnp.int32)), big)
        # Long-range propagation along straight runs.
        lab = jnp.where(
            mask, _segmented_min_scan(lab, mask, axis=1), big
        )
        lab = jnp.where(
            mask, _segmented_min_scan(lab, mask, axis=0), big
        )
        return lab

    return lax.fori_loop(0, iters, round_fn, lab)


def window_extreme(
    x: jnp.ndarray, wy: int, wx: int, fill, op=jnp.minimum
) -> jnp.ndarray:
    """``op`` (jnp.minimum or jnp.maximum) over each wy x wx window of the
    last two axes, stride 1, "SAME" placement, out-of-image taps = ``fill``.

    The same result as an integer ``lax.reduce_window`` with init ``fill``,
    written as wy * wx shifted slices of a padded copy.  On an H100, XLA's
    int32 ``reduce_window`` returned wrong values inside the detector
    program (a fused 3x3 min feeding a count, a strided 2x2 min) while the
    CPU was right; the slice form is plain elementwise code.
    """
    h, w = x.shape[-2:]
    pad = [(0, 0)] * (x.ndim - 2) + [
        ((wy - 1) // 2, wy // 2), ((wx - 1) // 2, wx // 2)
    ]
    p = jnp.pad(x, pad, constant_values=fill)
    out = None
    for dy in range(wy):
        for dx in range(wx):
            tap = p[..., dy:dy + h, dx:dx + w]
            out = tap if out is None else op(out, tap)
    return out


def fixpoint_residual(labels: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Number of mask pixels with an 8-neighbor in the mask holding a
    smaller label: 0 iff min-label propagation has reached its fixpoint.
    Works on (..., H, W)."""
    big = jnp.iinfo(jnp.int32).max
    masked = jnp.where(mask, labels.astype(jnp.int32), big)
    neigh = window_extreme(masked, 3, 3, big)
    return jnp.sum(mask & (neigh < masked)).astype(jnp.int32)


class ComponentStats(NamedTuple):
    """Top-K components of a label image, fixed capacity with masks."""

    root: jnp.ndarray       # (K,) int32 root label (H*W if slot empty)
    count: jnp.ndarray      # (K,) int32 pixel count
    centroid: jnp.ndarray   # (K, 2) float (x, y)
    bbox: jnp.ndarray       # (K, 4) int32 x0, y0, x1, y1 (inclusive)
    valid: jnp.ndarray      # (K,)
    # second moments for orientation estimates (about the centroid)
    mxx: jnp.ndarray        # (K,)
    mxy: jnp.ndarray        # (K,)
    myy: jnp.ndarray        # (K,)


def _segmented_scan_sorted(vals: jnp.ndarray, boundary: jnp.ndarray, op) -> jnp.ndarray:
    """Inclusive segmented scan over a label-sorted 1-D array."""

    def combine(a, b):
        av, ar = a
        bv, br = b
        return jnp.where(br, bv, op(av, bv)), ar | br

    return lax.associative_scan(combine, (vals, boundary), axis=0)[0]


def component_stats(labels: jnp.ndarray, k: int, min_area: int = 1) -> ComponentStats:
    """Reduce a label image to its K largest components' statistics.

    Sort-based segment reduction instead of scatter, chosen for the first
    target accelerator, where scatter-style segment_sum over H*W segments
    and lax.top_k over the image were slow and full sorts and associative
    scans were not (not measured on the GPU), so everything here is sorts +
    segmented scans + gathers:

      1. argsort the flat label image (payload follows by gather);
      2. run boundaries where the sorted label changes; per-run sums via
         cumsum differences at run ends, per-run min/max via segmented scans;
      3. run lengths from consecutive run-start positions; top-K components
         selected by argsort(-length) -- another cheap sort.

    Precision caveat: per-run moment sums come from differences of a full-
    image f32 cumsum whose magnitude reaches ~4e10 for the x^2/y^2 payload
    at 480x640, so late-sorted runs carry absolute moment error up to ~2.5e3
    (~0.05 px of centroid).  Exact counts/roots/bboxes; approximate moments.
    The hot path uses component_stats_first_k, whose one-hot reductions are
    exact -- prefer it when K slots suffice.
    """
    h, w = labels.shape
    hw = h * w
    flat = labels.reshape(-1)
    i32 = jnp.int32

    order = jnp.argsort(flat)
    sl = flat[order]
    xs = (order % w).astype(jnp.float32)
    ys = (order // w).astype(jnp.float32)

    payload = jnp.stack([xs, ys, xs * xs, xs * ys, ys * ys], axis=-1)  # (HW, 5)
    csum = jnp.cumsum(payload, axis=0)

    pos = jnp.arange(hw, dtype=i32)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), sl[1:] != sl[:-1]]
    )
    # Sorted run-start positions; invalid slots park at hw.
    starts = jnp.sort(jnp.where(boundary, pos, hw))
    ends = jnp.concatenate([starts[1:], jnp.asarray([hw], i32)])
    ends = jnp.minimum(ends, hw)
    run_valid = starts < hw
    length = jnp.where(run_valid, ends - starts, 0)
    root = sl[jnp.clip(starts, 0, hw - 1)]
    length = jnp.where(root >= hw, 0, length)  # drop the background run

    # Top-K runs by length via a full sort (fast) instead of top_k (slow).
    sel = jnp.argsort(-length)[:k]
    cnt_k = length[sel]
    valid = cnt_k >= min_area
    root_k = root[sel]
    s_idx = jnp.clip(starts[sel], 0, hw - 1)
    e_idx = jnp.clip(ends[sel] - 1, 0, hw - 1)
    sums = csum[e_idx] - jnp.where(
        (s_idx > 0)[:, None], csum[jnp.maximum(s_idx - 1, 0)], 0.0
    )

    c = jnp.maximum(cnt_k.astype(jnp.float32), 1.0)
    cx = sums[:, 0] / c
    cy = sums[:, 1] / c
    mxx = sums[:, 2] / c - cx * cx
    mxy = sums[:, 3] / c - cx * cy
    myy = sums[:, 4] / c - cy * cy

    # Per-run bbox: segmented min/max scans, values at run ends.
    xmin = _segmented_scan_sorted(xs, boundary, jnp.minimum)[e_idx]
    ymin = _segmented_scan_sorted(ys, boundary, jnp.minimum)[e_idx]
    xmax = _segmented_scan_sorted(xs, boundary, jnp.maximum)[e_idx]
    ymax = _segmented_scan_sorted(ys, boundary, jnp.maximum)[e_idx]
    bbox = jnp.stack([xmin, ymin, xmax, ymax], axis=-1)
    bbox = jnp.where(valid[:, None], bbox, 0.0).astype(i32)

    return ComponentStats(
        root=jnp.where(valid, root_k, hw).astype(i32),
        count=cnt_k.astype(i32),
        centroid=jnp.stack([cx, cy], -1),
        bbox=bbox,
        valid=valid,
        mxx=mxx,
        mxy=mxy,
        myy=myy,
    )


def peak_key_shift(h: int, w: int, window: int) -> int:
    """Bit shift packing a (box-count, linear-index) peak key into int32:
    count-dominant, index tie-break.  The linear index needs
    ceil(log2(H*W)) bits (a fixed 19 only covers <= 524,288 px -- at
    768x1024 it would alias counts into indices and corrupt peaks) and the
    count needs log2(window^2) more; both fields must fit in 31 bits.
    Static per image size (used by models/detector._joint_peaks)."""
    shift = max(19, (h * w - 1).bit_length())
    if shift + (window * window).bit_length() > 31:
        raise ValueError(
            f"joint-peak key overflow: {h}x{w} image with window {window} "
            f"needs {shift + (window * window).bit_length()} bits > 31"
        )
    return shift


def prefix_rank(mask: jnp.ndarray) -> jnp.ndarray:
    """Exclusive rank of each element among the True entries of a flat bool
    mask: rank[i] = (# True in mask[:i+1]) - 1, i.e. ``cumsum(mask) - 1``.

    Implemented as TWO triangular matmuls instead of a length-n cumsum,
    chosen for the first target accelerator, where jnp.cumsum lowered to a
    ~log2(n)-deep chain of full-array passes (not measured on the GPU): a
    (rows, 128) x (128, 128) within-row prefix plus a (rows, rows)
    row-offset matmul.  Counts are integers < 2^24, so HIGHEST-precision
    f32 accumulation is exact (a reduced-precision DEFAULT product corrupts
    ranks > 256)."""
    n = mask.shape[0]
    cols = 128
    rows = -(-n // cols)
    mf = jnp.pad(mask.astype(jnp.float32), (0, rows * cols - n)).reshape(
        rows, cols
    )
    upper_incl = jnp.triu(jnp.ones((cols, cols), jnp.float32))  # j <= i
    within = jax.lax.dot_general(
        mf, upper_incl,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (rows, cols) inclusive within-row prefix counts
    tot = within[:, -1]
    # Row offsets via a cumsum over the (tiny) per-row totals: a length-rows
    # scan is a few log-depth passes over <=2.4k elements, while a triangular
    # (rows, rows) matmul would read an O(rows^2) constant from HBM.
    off = jnp.cumsum(tot) - tot  # exclusive
    rank = (within + off[:, None] - 1.0).reshape(-1)[:n]
    return rank.astype(jnp.int32)


def compact_true_indices(mask: jnp.ndarray, k: int):
    """First-k indices of True entries of a 1-D bool mask.

    Matmul-rank + one-hot matmul projection; ``jnp.nonzero(size=k)`` lowers
    to an n-sized scatter, which was slow on the first target accelerator
    (not measured on the GPU).
    Returns (idx (k,) int32, valid (k,)); invalid slots hold n.
    """
    n = mask.shape[0]
    pos = prefix_rank(mask)
    sel = (mask[:, None] & (pos[:, None] == jnp.arange(k)[None, :])).astype(
        jnp.float32
    )
    payload = jnp.stack(
        [jnp.arange(n, dtype=jnp.float32), jnp.ones((n,), jnp.float32)], -1
    )
    picked = jax.lax.dot_general(
        sel, payload,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST is mandatory: the payload carries exact linear indices up
        # to H*W (~19 bits); a DEFAULT f32 product may run in bf16 or TF32
        # (8- or 10-bit mantissa), which corrupts the slots.
        precision=jax.lax.Precision.HIGHEST,
    )
    valid = picked[:, 1] > 0.5
    return jnp.where(valid, picked[:, 0].astype(jnp.int32), n), valid


def component_stats_first_k(
    labels: jnp.ndarray,
    k: int,
    min_area: int = 1,
    compute_bbox: bool = True,
    value_shape: tuple[int, int] | None = None,
) -> ComponentStats:
    """Sort-free component stats: first K components in scan order.

    The sort-based ``component_stats`` pays ~4 sorts of H*W elements.  This
    variant instead:

      1. finds component roots (pixels whose label equals their own linear
         index) and takes the FIRST K in scan order via cumsum-rank one-hot
         compaction as a matmul (in place of jnp.nonzero's scatter
         formulation);
      2. reduces per-component sums with one (K, HW) one-hot matmul and
         bbox min/max with masked reductions over the same one-hot.

    Ordering differs from component_stats (scan order vs count-descending):
    use it where consumers are order-independent (root matching, validity
    gates) or select explicitly via argmax(count).  If a mask has more than
    K components, later (bottom-right) ones are dropped instead of the
    smallest -- acceptable where K comfortably exceeds the expected count.

    ``value_shape``: pass (vh, vw) when ``labels`` is a MIN-POOLED view of a
    label image whose VALUES are linear indices of the original (vh, vw)
    grid.  The root test then maps each value back to the pooled block that
    contains its root pixel instead of comparing values against this grid's
    own indices (which can never match after pooling).  A component is still
    found as long as its root pixel's block wasn't min-pooled with a smaller
    foreign label -- impossible for masks whose components sit further apart
    than the pool factor.  Returned ``root`` values, and the one-hot used
    for the moment sums, stay in value space, so callers can keep comparing
    them against the unpooled label image.
    """
    h, w = labels.shape
    hw = h * w
    flat = labels.reshape(-1)
    lin = jnp.arange(hw, dtype=jnp.int32)
    if value_shape is None or tuple(value_shape) == (h, w):
        is_root = (flat == lin) & (flat < hw)
    else:
        vh, vw = value_shape
        py, px = vh // h, vw // w
        vy, vx = flat // vw, flat % vw
        is_root = (
            (flat < vh * vw)
            & (vy // py == lin // w)
            & (vx // px == lin % w)
        )
    # First-K compaction: rank roots by the triangular-matmul prefix rank,
    # then project the root values out with a one-hot matmul (root linear
    # indices are < 2^24, exact in f32).  Avoids jnp.nonzero's HW-sized
    # scatter and cumsum's log-depth pass chain.
    pos = prefix_rank(is_root)
    sel = (is_root[:, None] & (pos[:, None] == jnp.arange(k)[None, :])).astype(
        jnp.float32
    )  # (HW, k)
    picked = jax.lax.dot_general(
        sel,
        jnp.stack([flat.astype(jnp.float32), jnp.ones((hw,), jnp.float32)], -1),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST is mandatory (see compact_true_indices): a DEFAULT product
        # may run in reduced precision and corrupt the exact root indices.
        precision=jax.lax.Precision.HIGHEST,
    )  # (k, 2): [root value, occupancy]
    vhw = hw if value_shape is None else value_shape[0] * value_shape[1]
    root_k = jnp.where(
        picked[:, 1] > 0.5, picked[:, 0].astype(jnp.int32), vhw
    )

    onehot = (flat[:, None] == root_k[None, :]) & (root_k[None, :] < vhw)
    xs = (lin % w).astype(jnp.float32)
    ys = (lin // w).astype(jnp.float32)
    ones = jnp.ones((hw,), jnp.float32)
    payload = jnp.stack([ones, xs, ys, xs * xs, xs * ys, ys * ys], axis=-1)
    sums = jax.lax.dot_general(
        onehot.astype(jnp.float32),
        payload,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST: coordinate payloads (x, x^2 up to ~2^19) exceed bf16's
        # mantissa; a DEFAULT product in bf16 quantizes centroids by +-2 px.
        precision=jax.lax.Precision.HIGHEST,
    )  # (k, 6)

    cnt = sums[:, 0]
    valid = cnt >= min_area
    c = jnp.maximum(cnt, 1.0)
    cx = sums[:, 1] / c
    cy = sums[:, 2] / c
    mxx = sums[:, 3] / c - cx * cx
    mxy = sums[:, 4] / c - cx * cy
    myy = sums[:, 5] / c - cy * cy

    if compute_bbox:
        big = jnp.float32(1e9)
        xmin = jnp.min(jnp.where(onehot, xs[:, None], big), axis=0)
        ymin = jnp.min(jnp.where(onehot, ys[:, None], big), axis=0)
        xmax = jnp.max(jnp.where(onehot, xs[:, None], -big), axis=0)
        ymax = jnp.max(jnp.where(onehot, ys[:, None], -big), axis=0)
        bbox = jnp.stack([xmin, ymin, xmax, ymax], axis=-1)
        bbox = jnp.where(valid[:, None], bbox, 0.0).astype(jnp.int32)
    else:
        # centroid-only consumers (e.g. joint extraction) skip the four
        # masked (HW, K) reductions the bbox costs.
        bbox = jnp.zeros((k, 4), jnp.int32)

    return ComponentStats(
        root=jnp.where(valid, root_k, vhw).astype(jnp.int32),
        count=cnt.astype(jnp.int32),
        centroid=jnp.stack([cx, cy], -1),
        bbox=bbox,
        valid=valid,
        mxx=mxx,
        mxy=mxy,
        myy=myy,
    )


def largest_component_mask(labels: jnp.ndarray, k: int = 128) -> jnp.ndarray:
    """Bool mask of the largest foreground component (cv2 'max contour').

    Counts-only version of ``component_stats_first_k`` (no moment payload):
    enumerate the first k roots in scan order, count each root's pixels with
    one (HW, k) compare + column reduction, argmax.  Correct as long as the
    image has <= k components; beyond that, later (bottom-right) components
    are invisible -- size k for the worst plausible speck count, not the
    expected blob count (the plane ROI labels a RAW threshold mask where
    every hot pixel is its own component).  The 4-sort ``component_stats``
    formulation is exact for any count but costs ~2 ms at 480x640.
    """
    h, w = labels.shape
    hw = h * w
    flat = labels.reshape(-1)
    lin = jnp.arange(hw, dtype=jnp.int32)
    is_root = (flat == lin) & (flat < hw)
    pos = prefix_rank(is_root)
    sel = (is_root[:, None] & (pos[:, None] == jnp.arange(k)[None, :])).astype(
        jnp.float32
    )
    picked = jax.lax.dot_general(
        sel,
        jnp.stack([flat.astype(jnp.float32), jnp.ones((hw,), jnp.float32)], -1),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,  # exact root indices (see above)
    )  # (k, 2): [root value, occupancy]
    root_k = jnp.where(picked[:, 1] > 0.5, picked[:, 0].astype(jnp.int32), hw)
    onehot = (flat[:, None] == root_k[None, :]) & (root_k[None, :] < hw)
    cnt = jnp.sum(onehot, axis=0)
    li = jnp.argmax(cnt)
    # Empty-mask gate: with no components every root_k slot is hw and
    # `labels == hw` would be True on all BACKGROUND pixels (the whole
    # image); demand a real root.
    return (labels == root_k[li]) & (root_k[li] < hw)


def component_orientation(stats: ComponentStats) -> jnp.ndarray:
    """Per-component dominant axis angle (radians, x-right / y-down) from the
    second central moments: 0.5 * atan2(2 mxy, mxx - myy)."""
    return 0.5 * jnp.arctan2(2.0 * stats.mxy, stats.mxx - stats.myy)


def fill_orthoconvex(mask: jnp.ndarray, rounds: int = 2) -> jnp.ndarray:
    """Row/column convex fill: fills between the per-row and per-column
    extremes, iterated.  Cheap stand-in for cv2.convexHull+drawContours
    (ref utils/util_cylinder.py:1893-1896): exact for orthogonally convex
    regions, slightly tighter than the true hull otherwise -- it feeds ROI
    masks, where the reference's +expansion margins absorb the difference."""

    def fill_axis(m, axis):
        idx = jnp.arange(m.shape[axis])
        shape = [1, 1]
        shape[axis] = m.shape[axis]
        idxb = idx.reshape(shape)
        big = m.shape[axis] + 1
        lo = jnp.min(jnp.where(m, idxb, big), axis=axis, keepdims=True)
        hi = jnp.max(jnp.where(m, idxb, -1), axis=axis, keepdims=True)
        return (idxb >= lo) & (idxb <= hi)

    out = mask
    for _ in range(rounds):
        out = fill_axis(out, 1)
        out = fill_axis(out, 0)
    return out
