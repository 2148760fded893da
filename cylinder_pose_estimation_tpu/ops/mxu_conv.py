"""Banded-matrix separable convolutions, computed as matrix products.

A length-L 1-D correlation along the rows or columns of an (H, W) image can
be written as a dense matmul with a banded (N, N) matrix.  This form was
chosen for the first target accelerator, whose FLOPs live in a matrix unit,
as the replacement for the reference's ``cv2.boxFilter`` /
``cv2.GaussianBlur`` statistics passes (ref utils/util_cylinder.py:1914-1917,
:1962-1967, :1377-1449); it costs O(H^2 W) multiply-adds per pass against
O(L H W) for a stencil and has not been measured against one on the GPU
(ROADMAP Speed 5).  The module name keeps its first target's word for the
matrix unit.

Border semantics: ZERO padding -- the band is clipped at the matrix edge.
Call sites must either mask borders (the detector's margin band) or only
consume interior pixels.

Exactness: by default operands are cast to bf16 and accumulated in f32
(``preferred_element_type``).  A product of two bf16 values is exactly
representable in f32, so a SINGLE pass over integer-valued taps and images
with values < 256 (box/ramp filters over 0/1 masks) is EXACT.  CHAINED
passes whose intermediates exceed 256 (box sums of gray <= 255 reach ~2805)
are NOT: the second pass's bf16 cast rounds them -- use ``exact=True``
(f32 operands at HIGHEST precision) for such chains.  For Gaussian taps the
default's inexactness is the bf16 rounding of taps and operands, which
is the same on every device (a bf16 x bf16 product is exact in f32).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "band_matrix",
    "x_mat",
    "y_mat",
    "box_taps",
    "ramp_taps",
    "gauss_taps_cv",
    "gauss_taps_scipy",
    "compose_taps",
    "conv_x",
    "conv_y",
    "conv_at_points",
]


def box_taps(n: int) -> tuple:
    """All-ones box taps (un-normalized box SUM), exact in bf16."""
    return (1.0,) * n


def ramp_taps(n: int) -> tuple:
    """Centered integer ramp taps (-r .. r): correlation with these gives
    sum(x[i+t] * t), the first-moment kernel used for box centroids."""
    r = n // 2
    return tuple(float(t - r) for t in range(n))


# cv2.getGaussianKernel's hardcoded small_gaussian_tab: for sigma <= 0 and
# ksize <= 7 OpenCV returns these FIXED taps, not the sigma-formula Gaussian
# (opencv modules/imgproc/src/smooth.dispatch.cpp).  The reference's
# GaussianBlur(img, (5,5), 0) / (7,7) calls therefore use the table.
_CV_SMALL_GAUSSIAN = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


def gauss_taps_cv(ksize: int, sigma: float = 0.0) -> tuple:
    """cv2.getGaussianKernel taps as Python floats.

    Matches OpenCV's full sigma<=0 behavior: ksize <= 7 takes the hardcoded
    small-kernel table (exact binary fractions; the 0.3*((k-1)/2-1)+0.8
    formula deviates from it by up to 13% per tap), larger ksize uses the
    formula."""
    if sigma <= 0 and ksize in _CV_SMALL_GAUSSIAN:
        return _CV_SMALL_GAUSSIAN[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / k.sum()
    return tuple(float(v) for v in k)


def gauss_taps_scipy(sigma: float, truncate: float = 4.0) -> tuple:
    """scipy.ndimage.gaussian_filter1d taps (radius = int(truncate*sigma+.5))
    as Python floats -- the ONE shared source for the sigma-3 ridge filter
    (ops/image.gaussian_kernel1d_scipy derives from this, so the filters
    cannot desynchronize)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(2 * radius + 1) - radius
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / k.sum()
    return tuple(float(v) for v in k)


def compose_taps(a: tuple, b: tuple) -> tuple:
    """Taps of the composition a * b (full 1-D convolution, float64)."""
    return tuple(
        float(v) for v in np.convolve(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))
    )


@functools.lru_cache(maxsize=64)
def band_matrix(taps: tuple, n: int, exact: bool = False) -> np.ndarray:
    """(n, n) bf16 banded correlation matrix B with B[j, i] = taps[j-i+r].

    For a row-vector image row x (length n), (x @ B)[i] =
    sum_t taps[t] * x[i + t - r]  -- a centered correlation with zero
    padding.  Rounded to bf16 once here so every user of the same taps sees
    identical rounded weights.
    """
    assert len(taps) % 2 == 1, (
        "centered-correlation band matrices require ODD tap counts: for even "
        "lengths the reversed-tap y_mat anchors one element off x_mat, "
        "silently skewing y vs x"
    )
    r = len(taps) // 2
    m = np.zeros((n, n), np.float32)
    for t, v in enumerate(taps):
        off = t - r  # source index j = i + off
        d = np.arange(max(0, -off), min(n, n - off))
        m[d + off, d] = v
    return m.astype(np.float32 if exact else jnp.bfloat16)


def x_mat(taps: tuple, w: int, exact: bool = False) -> np.ndarray:
    """Right-multiplication matrix for conv_x: (img @ x_mat)."""
    return band_matrix(tuple(taps), w, exact)


def y_mat(taps: tuple, h: int, exact: bool = False) -> np.ndarray:
    """Left-multiplication matrix for conv_y: (y_mat @ img).

    Uses the reversed-tap band so a STANDARD matmul contraction (rows of
    the left operand against axis 0 of the image) realizes the centered
    correlation -- standard layouts keep Mosaic/XLA from inserting
    transposes.  For odd tap counts band(reversed)[i, j] = taps[j - i + r],
    exactly the weight conv_y needs."""
    return band_matrix(tuple(taps)[::-1], h, exact)


def conv_x(img: jnp.ndarray, bmat: jnp.ndarray, exact: bool = False) -> jnp.ndarray:
    """Correlate along the last axis (width): img (..., H, W) @ bmat (W, W).

    Default: bf16 operands, f32 accumulation (one pass).  ``exact=True``
    keeps f32 operands at HIGHEST precision -- REQUIRED for chained
    conv_y(conv_x(...)) whose intermediates exceed 256 (e.g. box sums of
    gray <= 255: first-pass sums ~2805 would be bf16-recast to 2800 by the
    second pass, flipping brightness argmaxes).  Pass x_mat(..., exact=True) with it so the
    taps are not pre-rounded."""
    if exact:
        return jax.lax.dot_general(
            img.astype(jnp.float32),
            bmat.astype(jnp.float32),
            dimension_numbers=(((img.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    return jax.lax.dot_general(
        img.astype(jnp.bfloat16),
        bmat.astype(jnp.bfloat16),
        dimension_numbers=(((img.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def conv_y(img: jnp.ndarray, amat: jnp.ndarray, exact: bool = False) -> jnp.ndarray:
    """Correlate along axis 0 (height): (amat @ img) with amat from y_mat.

    See conv_x for the ``exact`` contract."""
    if exact:
        return jax.lax.dot_general(
            amat.astype(jnp.float32),
            img.astype(jnp.float32),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    return jax.lax.dot_general(
        amat.astype(jnp.bfloat16),
        img.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def _taps_rows(idx: jnp.ndarray, taps: tuple, n: int) -> jnp.ndarray:
    """(P, n) matrix whose row p holds ``taps`` centered at column idx[p]:
    rows[p, j] = taps[j - idx[p] + r], zero outside the band -- the
    gathered-row form of band_matrix, built WITHOUT a gather (dynamic
    gathers were slow on the first target accelerator; len(taps)
    where-passes over a (P, n) iota are small).  Uniform (box) taps collapse
    to a single band compare."""
    r = len(taps) // 2
    jj = jnp.arange(n, dtype=jnp.int32)[None, :]
    off = jj - idx[:, None].astype(jnp.int32) + r
    first = taps[0]
    if all(t == first for t in taps):
        return jnp.where(
            (off >= 0) & (off < len(taps)), jnp.float32(first), 0.0
        )
    out = jnp.zeros(off.shape, jnp.float32)
    for t, v in enumerate(taps):
        out = out + jnp.where(off == t, jnp.float32(v), 0.0)
    return out


def conv_at_points(
    img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray, taps: tuple
) -> jnp.ndarray:
    """Separable centered correlation of ``img`` with ``taps`` evaluated at
    integer points (ys, xs) -- WITHOUT materializing the filtered image or
    gathering from it.

    Equivalent to conv_y(conv_x(img, x_mat(taps, W, exact=True)),
    y_mat(taps, H, exact=True)) gathered at (ys, xs), up to f32 summation
    order (HIGHEST-precision band dots either way): the filtered image +
    (P,)-gather form costs two full (H/W)-sized exact matmuls PLUS a
    dynamic gather; this per-point form is one (P, H) x (H, W) HIGHEST
    matmul and an elementwise row dot.  Zero padding at borders, like
    band_matrix.  P stays modest (hundreds), so the (P, W) intermediates
    are tiny."""
    h, w = img.shape
    u = _taps_rows(ys, taps, h)                     # (P, H)
    m = jax.lax.dot_general(
        u, img.astype(jnp.float32),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                               # (P, W)
    v = _taps_rows(xs, taps, w)                     # (P, W)
    return jnp.sum(m * v, axis=-1)


def range_mean_at_points(
    img: jnp.ndarray,
    y0: jnp.ndarray,
    y1: jnp.ndarray,
    x0: jnp.ndarray,
    x1: jnp.ndarray,
) -> jnp.ndarray:
    """Mean of ``img[y0:y1, x0:x1)`` per point, with TRACED integer bounds.

    The adaptive-patch companion of conv_at_points: rectangle sums as one
    (P, H) x (H, W) HIGHEST band-indicator matmul + an elementwise row dot
    -- no dynamic gather, and the patch size may depend on traced values
    (the reference's brightness patch scales with the saturation-circle
    radius, ref utils/util_cylinder.py:1377-1379 / utils/util_plane.py:1280,
    which a static-taps formulation cannot express).  Empty or fully
    clipped rectangles return -inf (they never win the argmax these means
    feed; the reference's np.mean of an empty slice is NaN, which loses
    max() comparisons the same way)."""
    h, w = img.shape

    def rows(lo, hi, n):
        jj = jnp.arange(n, dtype=jnp.int32)[None, :]
        return (
            (jj >= lo[:, None]) & (jj < hi[:, None])
        ).astype(jnp.float32)

    u = rows(y0, y1, h)                              # (P, H)
    m = jax.lax.dot_general(
        u, img.astype(jnp.float32),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                                # (P, W)
    v = rows(x0, x1, w)                              # (P, W)
    sums = jnp.sum(m * v, axis=-1)
    area = ((y1 - y0) * (x1 - x0)).astype(jnp.float32)
    return jnp.where(area > 0, sums / jnp.maximum(area, 1.0), -jnp.inf)
