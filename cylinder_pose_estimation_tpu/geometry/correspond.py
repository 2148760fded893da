"""Stereo grid-index correspondence and patch-consensus selection.

Replaces the reference's dict/loop machinery with a dense grid-index raster:

  * findGridCorrespondences (ref utils/findGridCorrespondences.m): exact
    integer-index matching becomes a scatter of both views into a (G, G)
    raster keyed by grid index, then an occupancy AND -- one pass, no loops.

  * chooseIdx patch consensus (ref utils/chooseIdx.m:29-104): the reference
    slides a patchSize x patchSize window over the index grid, triangulates
    each complete patch, keeps patches with mean reprojection error below the
    threshold, and per point keeps the min-error candidate across overlapping
    patches.  KEY SIMPLIFICATION (same math, batched shape): MATLAB triangulate's
    per-point reprojection error depends only on that point's pixel pair --
    it is identical in every patch containing the point, so "min across
    patches" is the point's own error and the whole procedure reduces to:

        1. triangulate ALL index-matched pairs once (batched DLT);
        2. patch mean error = depthwise box-sum of the per-cell error over
           the raster, divided by patchSize^2, valid only where all cells of
           the patch are occupied in both views; the raster is first
           compacted to view-1's unique present index values per axis so a
           wholly-missing row/col is bridged, exactly like the reference's
           unique()-based sliding (ref utils/chooseIdx.m:23-35);
        3. a point is selected iff >= 1 covering patch passes the threshold
           = a box-max (dilation) of the patch-pass indicator.

    The fallback to plain index matching when no patch passes
    (ref utils/chooseIdx.m:101-104) is a mask-level select.

Grid indices are integers relative to the detected center point and small
(|idx| < ~16), so a static raster of extent G = fit_config.grid_extent with
the offset chosen from the data covers every real case; out-of-raster points
are dropped and counted.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.geometry.triangulate import triangulate
from cylinder_pose_estimation_tpu.types import Correspondences, GridPoints, StereoParams


def _rasterize(
    gp: GridPoints, offset: jnp.ndarray, extent: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Project grid points onto a (G, G, 2) coord raster + (G, G) occupancy.

    Cell layout: [x_index - offset_x, y_index - offset_y].  Scatter-free: a
    (P, G) row one-hot and a (P, G, 2+1) col/payload product reduce onto the
    raster with one matmul (chosen for the first target accelerator, where
    scatters under vmap were slow; not measured on the GPU).  Duplicate
    indices (should not occur after
    relabeling) average their coords (the reference's ismember takes the
    first match -- both are degenerate).
    """
    cell = gp.idx - offset[None, :]
    inside = (
        gp.valid
        & jnp.all(cell >= 0, axis=-1)
        & jnp.all(cell < extent, axis=-1)
    )
    ar = jnp.arange(extent, dtype=jnp.int32)
    # Row one-hot over the x-index, payload = col one-hot x [xy, 1] over the
    # y-index; one (G, P) @ (P, G*3) matmul yields coord sums + counts.
    rowhot = (inside[:, None] & (cell[:, 0:1] == ar[None, :])).astype(
        gp.xy.dtype
    )  # (P, G)
    colhot = (inside[:, None] & (cell[:, 1:2] == ar[None, :])).astype(
        gp.xy.dtype
    )  # (P, G)
    payload = jnp.concatenate([gp.xy, jnp.ones_like(gp.xy[:, :1])], -1)
    # Masked slots may hold non-finite coords (e.g. diverged Newton
    # intersections with accept=False); 0 * nan = nan would poison the
    # whole reduction, so zero the payload wherever the point is excluded.
    payload = jnp.where(inside[:, None], payload, 0.0)
    b = (colhot[:, :, None] * payload[:, None, :]).reshape(
        gp.xy.shape[0], extent * 3
    )
    sums = jnp.einsum(
        "pr,pk->rk", rowhot, b, precision=jax.lax.Precision.HIGHEST
    ).reshape(extent, extent, 3)
    cnt = sums[..., 2]
    occ = cnt > 0.5
    coords = sums[..., :2] / jnp.maximum(cnt, 1.0)[..., None]
    return coords, occ


def _box_sum(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """'Valid'-mode size x size box sum of a (G, G) array via cumsum."""
    c = jnp.cumsum(jnp.cumsum(x, axis=0), axis=1)
    c = jnp.pad(c, ((1, 0), (1, 0)))
    g = x.shape[0]
    n = g - size + 1
    return (
        c[size : size + n, size : size + n]
        - c[0:n, size : size + n]
        - c[size : size + n, 0:n]
        + c[0:n, 0:n]
    )


def _anchor_max(patch_ok: jnp.ndarray, size: int, extent: int) -> jnp.ndarray:
    """Dilate an anchor-grid indicator back over its size x size footprint."""
    padded = jnp.pad(
        patch_ok.astype(jnp.float32),
        ((size - 1, size - 1), (size - 1, size - 1)),
    )
    # cell (i, j) is covered by anchors (i - size + 1 .. i, j - size + 1 .. j)
    out = jnp.zeros((extent, extent), dtype=jnp.float32)
    for di in range(size):
        for dj in range(size):
            out = jnp.maximum(out, padded[di : di + extent, dj : dj + extent])
    return out > 0


def find_grid_correspondences(
    gp1: GridPoints, gp2: GridPoints, extent: int = 32
) -> Correspondences:
    """Exact grid-index matching (ref utils/findGridCorrespondences.m).

    Output is in raster layout: M = extent^2 rows with a validity mask.
    """
    offset = _common_offset(gp1, gp2, extent)
    c1, o1 = _rasterize(gp1, offset, extent)
    c2, o2 = _rasterize(gp2, offset, extent)
    both = o1 & o2
    ix = jnp.arange(extent, dtype=jnp.int32)
    idx = jnp.stack(jnp.meshgrid(ix, ix, indexing="ij"), axis=-1) + offset
    return Correspondences(
        xy1=c1.reshape(-1, 2),
        xy2=c2.reshape(-1, 2),
        idx=idx.reshape(-1, 2),
        valid=both.reshape(-1),
        used_fallback=jnp.asarray(False),
    )


def _common_offset(gp1: GridPoints, gp2: GridPoints, extent: int) -> jnp.ndarray:
    """Data-driven raster origin: min index over both views, per axis."""
    big = jnp.iinfo(jnp.int32).max

    def mn(gp):
        return jnp.min(
            jnp.where(gp.valid[:, None], gp.idx, big), axis=0
        )

    return jnp.minimum(mn(gp1), mn(gp2)).astype(jnp.int32)


def choose_idx(
    gp1: GridPoints,
    gp2: GridPoints,
    stereo: StereoParams,
    patch_size: int = 3,
    error_threshold: float = 0.3,
    extent: int = 32,
) -> Correspondences:
    """Patch-consensus correspondence selection (ref utils/chooseIdx.m).

    See module docstring for the dense reformulation.  Returns raster-layout
    correspondences with `used_fallback` set when no patch passed and the
    plain index matching was substituted (ref utils/chooseIdx.m:101-104).
    """
    offset = _common_offset(gp1, gp2, extent)
    c1, o1 = _rasterize(gp1, offset, extent)
    c2, o2 = _rasterize(gp2, offset, extent)
    both = o1 & o2

    tri = triangulate(
        c1.reshape(-1, 2), c2.reshape(-1, 2), stereo, valid=both.reshape(-1)
    )
    err = tri.reproj_error.reshape(extent, extent)
    # Degenerate cells (occupied in both views but singular/non-finite DLT:
    # tri.valid False) must FAIL their patches, not contribute the zeroed
    # error triangulate() reports for them -- the reference sees the real,
    # large MATLAB reprojection error there and rejects the patch.
    vall = tri.valid.reshape(extent, extent)
    err = jnp.where(both & vall, err, jnp.where(both, 1e6, 0.0))

    # The reference slides patches over the *unique present* index values of
    # view 1 per axis (ref utils/chooseIdx.m:23-35, unique(gp1(:,3))/(:,4)),
    # so a wholly-missing grid row/column is bridged rather than breaking
    # every patch that spans it.  Reproduce that by compacting occupied
    # view-1 rows/cols to the front (stable permutation), box-summing on the
    # compacted raster, and scattering the selection back.
    row_present = jnp.any(o1, axis=1)
    col_present = jnp.any(o1, axis=0)
    perm_r = jnp.argsort(~row_present, stable=True)
    perm_c = jnp.argsort(~col_present, stable=True)
    both_c = both[perm_r][:, perm_c]
    err_c = err[perm_r][:, perm_c]

    occ_count = _box_sum(both_c.astype(jnp.float32), patch_size)
    err_sum = _box_sum(err_c, patch_size)
    full = occ_count >= patch_size * patch_size - 0.5
    mean_err = err_sum / (patch_size * patch_size)
    patch_ok = full & (mean_err < error_threshold)

    selected_c = _anchor_max(patch_ok, patch_size, extent) & both_c
    # Un-permute with two permutation matmuls (selected[perm_r[i], perm_c[j]]
    # = selected_c[i, j]) instead of a scatter (chosen for the first target
    # accelerator; not measured on the GPU).
    ar = jnp.arange(extent)
    p_r = (perm_r[:, None] == ar[None, :]).astype(jnp.float32)  # (G, G)
    p_c = (perm_c[:, None] == ar[None, :]).astype(jnp.float32)
    selected = (
        jnp.einsum(
            "ik,ij,jl->kl", p_r, selected_c.astype(jnp.float32), p_c,
            precision=jax.lax.Precision.HIGHEST,
        )
        > 0.5
    ) & both
    any_selected = jnp.any(selected)
    final = jnp.where(any_selected, selected, both)

    ix = jnp.arange(extent, dtype=jnp.int32)
    idx = jnp.stack(jnp.meshgrid(ix, ix, indexing="ij"), axis=-1) + offset
    return Correspondences(
        xy1=c1.reshape(-1, 2),
        xy2=c2.reshape(-1, 2),
        idx=idx.reshape(-1, 2),
        valid=final.reshape(-1),
        used_fallback=~any_selected,
    )
