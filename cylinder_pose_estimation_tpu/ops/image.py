"""Core dense image kernels: padding, separable convolution, box/Gaussian filters.

These replace the cv2 filter primitives the reference leans on
(cv2.GaussianBlur, cv2.boxFilter: ref utils/util_cylinder.py:1755-1758,
1790-1791) with XLA convolutions over fixed-shape (H, W) float arrays.
Separable 1D passes keep the FLOP count linear in kernel size, and XLA
fuses neighboring elementwise stages.

Border-mode parity: cv2's default is BORDER_REFLECT_101, its boxFilter call
sites use BORDER_REPLICATE, scipy/skimage default to constant -- all three are
provided and call sites pick the mode their reference counterpart used.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def pad2d(img: jnp.ndarray, ry: int, rx: int, mode: str) -> jnp.ndarray:
    """Pad an (H, W) image by (ry, rx) on each side.

    mode: 'reflect101' (cv2 default, edge pixel not duplicated), 'edge'
    (cv2 BORDER_REPLICATE), or 'constant' (zeros; scipy default).
    """
    if mode == "reflect101":
        return jnp.pad(img, ((ry, ry), (rx, rx)), mode="reflect")
    if mode == "edge":
        return jnp.pad(img, ((ry, ry), (rx, rx)), mode="edge")
    if mode == "constant":
        return jnp.pad(img, ((ry, ry), (rx, rx)), mode="constant")
    raise ValueError(f"unknown pad mode {mode}")


def sep_filter2d(
    img: jnp.ndarray, ky: jnp.ndarray, kx: jnp.ndarray, mode: str = "reflect101"
) -> jnp.ndarray:
    """Separable correlation: rows with kx, columns with ky (cv2.sepFilter2D).

    img: (H, W); ky: (Ky,); kx: (Kx,).  Implemented as weighted sums of
    statically shifted slices, NOT lax.conv: a 1-channel conv was slow on
    the first target accelerator, while the slice form is a single fused
    elementwise pass over the array per axis (not measured against
    lax.conv on the GPU).
    """
    ry, rx = ky.shape[0] // 2, kx.shape[0] // 2
    h, w = img.shape
    p = pad2d(img, ry, rx, mode)
    kxa = kx.astype(img.dtype)
    kya = ky.astype(img.dtype)

    # fori_loop keeps the HLO graph O(1) in tap count: a 25-tap kernel fully
    # unrolled as slices made batched compiles blow past an hour on the
    # remote compiler, while the loop compiles in seconds and each iteration
    # is one cheap fused multiply-add pass.
    def row_body(i, acc):
        sl = lax.dynamic_slice(p, (0, i), (h + 2 * ry, w))
        return acc + kxa[i] * sl

    # Carry inits derive from the input so they inherit its varying-axes
    # metadata under shard_map (a fresh zeros() literal would not).
    out = lax.fori_loop(
        0, kx.shape[0], row_body,
        jnp.zeros_like(lax.dynamic_slice(p, (0, 0), (h + 2 * ry, w))),
    )

    def col_body(j, acc):
        sl = lax.dynamic_slice(out, (j, 0), (h, w))
        return acc + kya[j] * sl

    return lax.fori_loop(
        0, ky.shape[0], col_body,
        jnp.zeros_like(lax.dynamic_slice(out, (0, 0), (h, w))),
    )


def gaussian_kernel1d_cv(ksize: int, sigma: float = 0.0) -> jnp.ndarray:
    """cv2.getGaussianKernel semantics, incl. the sigma<=0 size rule AND
    OpenCV's hardcoded small-kernel table for ksize <= 7 (the reference's
    GaussianBlur(k, 0) calls resolve to the table for its 5x5/7x7 blurs).

    Taps come from the single shared source (ops.mxu_conv.gauss_taps_cv) so
    the filters and the banded-matmul statistic images can never
    desynchronize."""
    from cylinder_pose_estimation_tpu.ops.mxu_conv import gauss_taps_cv

    return jnp.asarray(gauss_taps_cv(ksize, sigma), dtype=jnp.float32)


def gaussian_blur_cv(
    img: jnp.ndarray, ksize: int, sigma: float = 0.0, mode: str = "reflect101"
) -> jnp.ndarray:
    """cv2.GaussianBlur equivalent (square kernel, default border)."""
    k = gaussian_kernel1d_cv(ksize, sigma)
    return sep_filter2d(img, k, k, mode)


def gaussian_kernel1d_scipy(sigma: float, truncate: float = 4.0) -> jnp.ndarray:
    """scipy.ndimage.gaussian_filter's kernel: radius = round(truncate*sigma).

    Taps from the single shared source (ops.mxu_conv.gauss_taps_scipy)."""
    from cylinder_pose_estimation_tpu.ops.mxu_conv import gauss_taps_scipy

    return jnp.asarray(gauss_taps_scipy(sigma, truncate), dtype=jnp.float32)


def gaussian_blur_scipy(
    img: jnp.ndarray, sigma: float, mode: str = "constant", truncate: float = 4.0
) -> jnp.ndarray:
    """scipy/skimage-style Gaussian (used inside hessian ridge, sigma=3)."""
    k = gaussian_kernel1d_scipy(sigma, truncate)
    return sep_filter2d(img, k, k, mode)


def box_filter(
    img: jnp.ndarray, ksize: int, mode: str = "edge", normalize: bool = True
) -> jnp.ndarray:
    """cv2.boxFilter equivalent (the reference calls it with BORDER_REPLICATE
    for fast Sauvola: ref utils/util_cylinder.py:1755-1758).

    Cumulative-sum form: two cumsum passes + two subtractions regardless of
    window size (a 15x15 ones-kernel as slices would be 30 reads/pixel).
    """
    r = ksize // 2
    p = pad2d(img, r, r, mode)
    h, w = img.shape

    def box1d(x, axis, n_out):
        cs = jnp.cumsum(x, axis=axis, dtype=jnp.float32)
        zero_shape = list(x.shape)
        zero_shape[axis] = 1
        cs = jnp.concatenate([jnp.zeros(zero_shape, cs.dtype), cs], axis=axis)
        hi = lax.slice_in_dim(cs, ksize, ksize + n_out, axis=axis)
        lo = lax.slice_in_dim(cs, 0, n_out, axis=axis)
        return hi - lo

    out = box1d(p, 1, w)
    out = box1d(out, 0, h)
    if normalize:
        out = out / (ksize * ksize)
    return out.astype(img.dtype)


def gradient2d(img: jnp.ndarray):
    """np.gradient equivalent: central differences inside, one-sided at edges.

    Returns (d/drow, d/dcol) -- needed for skimage hessian parity
    (skimage.feature.hessian_matrix builds H from repeated np.gradient).
    """

    def grad_axis(x, axis):
        upper = jnp.roll(x, -1, axis)
        lower = jnp.roll(x, 1, axis)
        g = (upper - lower) * 0.5
        # one-sided at the two borders
        n = x.shape[axis]
        idx = jnp.arange(n)
        first = jnp.take(x, jnp.asarray([1]), axis) - jnp.take(x, jnp.asarray([0]), axis)
        last = jnp.take(x, jnp.asarray([n - 1]), axis) - jnp.take(x, jnp.asarray([n - 2]), axis)
        shape = [1, 1]
        shape[axis] = n
        sel = idx.reshape(shape)
        g = jnp.where(sel == 0, first, g)
        g = jnp.where(sel == n - 1, last, g)
        return g

    return grad_axis(img, 0), grad_axis(img, 1)


def bgr_to_gray(img: jnp.ndarray) -> jnp.ndarray:
    """cv2.cvtColor BGR2GRAY weights (ref loads BGR images)."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample (H, W) image at float (x, y) pixel coords (clamped)."""
    h, w = img.shape
    x = jnp.clip(x, 0.0, w - 1.0)
    y = jnp.clip(y, 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def cubic_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bicubic-convolution sample of an (H, W) image at float (x, y) pixel
    coords -- the Keys kernel with a = -0.5 (Catmull-Rom), which is what
    MATLAB's 'cubic' interpolation uses (ref utils/preProcessing.m:12-13
    undistortImage(..., 'cubic')).  Separable 4x4 tap stencil; coordinates
    clamped to the valid interior like bilinear_sample."""
    h, w = img.shape
    x = jnp.clip(x, 0.0, w - 1.0)
    y = jnp.clip(y, 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 1, w - 3)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 1, h - 3)
    fx = x - x0
    fy = y - y0

    def keys(t):
        # a = -0.5: w(t) for tap offsets (-1, 0, 1, 2) given fraction t
        a = -0.5
        t2 = t * t
        t3 = t2 * t
        w_m1 = a * (t3 - 2 * t2 + t)
        w_0 = (a + 2) * t3 - (a + 3) * t2 + 1
        w_p1 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
        w_p2 = a * (t2 - t3)
        return w_m1, w_0, w_p1, w_p2

    wx = keys(fx)
    wy = keys(fy)
    out = jnp.zeros_like(fx)
    for j, wyj in enumerate(wy):
        row = jnp.zeros_like(fx)
        for i, wxi in enumerate(wx):
            row = row + wxi * img[y0 + (j - 1), x0 + (i - 1)]
        out = out + wyj * row
    return out


def patch_mean_at(
    img_boxmean: jnp.ndarray, xy: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Gather a precomputed box-mean image at integer point locations.

    Replaces the reference's per-point np.mean(gray[y-h:y+h, x-h:x+h]) scans
    (ref utils/util_cylinder.py:1914-1917, 1437-1449): one box filter over the
    whole image + a gather in place of hundreds of dynamic slices.
    """
    h, w = img_boxmean.shape
    xi = jnp.clip(jnp.round(xy[..., 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(xy[..., 1]).astype(jnp.int32), 0, h - 1)
    vals = img_boxmean[yi, xi]
    return jnp.where(valid, vals, -jnp.inf)
