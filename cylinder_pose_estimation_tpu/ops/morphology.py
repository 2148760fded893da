"""Binary morphology on (H, W) bool arrays: rect and oriented-line kernels.

Replaces cv2.morphologyEx / cv2.dilate / cv2.erode call sites
(ref utils/util_cylinder.py:1810-1815 joint extraction opening with 20x1/1x20
rects; :178-189 rotated-line endpoint dilation + 3x3 erosion; :2000-2004 3x3
opening) with static-shape forms:

  * rect kernels: separable min/max via lax.reduce_window -- two 1D passes;
  * oriented line kernels at a *traced* angle: logarithmic Minkowski doubling
    (a line of length 2L is the dilation of a line of length L by itself), so
    a 150-px line dilation is ~8 shift+OR steps instead of a 150-tap conv.
    Shifts use roll + wrap-masking so traced (dy, dx) offsets are fine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _window_reduce(x: jnp.ndarray, wy: int, wx: int, op: str) -> jnp.ndarray:
    init = -jnp.inf if op == "max" else jnp.inf
    fn = lax.max if op == "max" else lax.min
    return lax.reduce_window(
        x, init, fn, (wy, wx), (1, 1), "SAME"
    )


def dilate_rect(mask: jnp.ndarray, wy: int, wx: int) -> jnp.ndarray:
    """Binary dilation with a wy x wx rectangle (separable max-pool)."""
    f = mask.astype(jnp.float32)
    return _window_reduce(f, wy, wx, "max") > 0.5


def erode_rect(mask: jnp.ndarray, wy: int, wx: int) -> jnp.ndarray:
    """Binary erosion with a wy x wx rectangle.  Out-of-image = 0 (cv2
    borderValue for erode is +inf i.e. border ignored; we use the stricter
    zero border, which only affects a 1-kernel rim)."""
    f = mask.astype(jnp.float32)
    return _window_reduce(f, wy, wx, "min") > 0.5


def open_rect(mask: jnp.ndarray, wy: int, wx: int) -> jnp.ndarray:
    """Opening = erosion then dilation (cv2.MORPH_OPEN)."""
    return dilate_rect(erode_rect(mask, wy, wx), wy, wx)


def close_rect(mask: jnp.ndarray, wy: int, wx: int) -> jnp.ndarray:
    return erode_rect(dilate_rect(mask, wy, wx), wy, wx)


def shift2d(mask: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray) -> jnp.ndarray:
    """Shift a 2D array by traced integer offsets, zero-filling (no wrap).

    Positive dy shifts content down, positive dx right (like pasting the
    image at (dy, dx)).
    """
    h, w = mask.shape
    rolled = jnp.roll(mask, (dy, dx), axis=(0, 1))
    rows = jnp.arange(h)[:, None]
    cols = jnp.arange(w)[None, :]
    # After rolling by dy, rows [0, dy) (dy>0) or [h+dy, h) (dy<0) are wrapped.
    row_ok = jnp.where(dy >= 0, rows >= dy, rows < h + dy)
    col_ok = jnp.where(dx >= 0, cols >= dx, cols < w + dx)
    return jnp.where(row_ok & col_ok, rolled, jnp.zeros_like(mask))


def dilate_line(
    mask: jnp.ndarray,
    angle: jnp.ndarray,
    max_length: int,
    length: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Binary dilation with a centered line kernel at a traced angle.

    Equivalent role to the reference's create_rotated_line_kernel + cv2.dilate
    (ref utils/util_cylinder.py:57-76, 178).  Logarithmic construction: repeat
    dilating by a 2^k-step segment in both +-dir; a segment dilated by a shift
    of e <= extent+1 yields a segment of extent+e, so the doubling schedule
    (step_k = covered+1) leaves no holes.  O(log max_length) shift+OR ops.

    max_length is static (trace-time bound).  ``length`` optionally gives a
    *traced* effective kernel length <= max_length (the reference sizes its
    kernel 91 + circle_radius0 from the per-image saturation blob,
    ref :2022-2023): each doubling step is clipped to the remaining dynamic
    half-extent, so extra steps shift by 0 and become no-ops.

    angle: radians, image convention (x right, y down).
    """
    ca = jnp.cos(angle)
    sa = jnp.sin(angle)
    out = mask
    half = max(max_length // 2, 1)
    dyn_half = (
        jnp.asarray(half, jnp.float32)
        if length is None
        else jnp.clip(length.astype(jnp.float32) / 2.0, 0.0, half)
    )
    stride = 1
    covered = 0
    dyn_covered = jnp.asarray(0.0, jnp.float32)
    while covered < half:
        step = min(stride, half - covered)
        eff = jnp.clip(dyn_half - dyn_covered, 0.0, float(step))
        dy = jnp.round(sa * eff).astype(jnp.int32)
        dx = jnp.round(ca * eff).astype(jnp.int32)
        out = out | shift2d(out, dy, dx) | shift2d(out, -dy, -dx)
        covered += step
        dyn_covered = dyn_covered + eff
        stride *= 2
    return out


def directional_count(
    mask: jnp.ndarray, angle: jnp.ndarray, probe_len: int, sign: int
) -> jnp.ndarray:
    """Count of mask pixels along +-direction within probe_len steps.

    Used for endpoint detection: a mask pixel whose forward ray is empty is a
    forward endpoint (our dense stand-in for the reference's per-contour PCA
    endpoints, ref utils/util_cylinder.py:35-55).
    """
    ca = jnp.cos(angle)
    sa = jnp.sin(angle)
    f = mask.astype(jnp.float32)
    if probe_len <= 0:
        # Degenerate probe: no pixels along an empty ray.  Currently
        # unreachable from the detector (endpoint_probe_len=9 halves to
        # >= 2 under bridge_half_res) but the contract is a count image.
        return jnp.zeros_like(f)

    # Hillis-Steele doubling over the ray: C_2m = C_m + shift(C_m, -d(m))
    # covers 2m steps in log passes instead of 2m.  The far-half offsets
    # become d(m)+d(k) instead of d(m+k) (rounding is not additive), a <=1 px
    # lateral re-rasterization; grid-line angles sit near 0 / pi/2 where the
    # two agree.
    def d(m):
        dy = jnp.round(sa * m * sign).astype(jnp.int32)
        dx = jnp.round(ca * m * sign).astype(jnp.int32)
        return dy, dx

    # shifting content by (-dy, -dx) brings the pixel at +i*dir onto us
    dy1, dx1 = d(1)
    pows = {1: shift2d(f, -dy1, -dx1)}
    m = 1
    while m * 2 <= probe_len:
        dy, dx = d(m)
        pows[2 * m] = pows[m] + shift2d(pows[m], -dy, -dx)
        m *= 2
    cnt = None
    off = 0
    size = probe_len
    while size:
        p = 1 << (size.bit_length() - 1)
        if off == 0:
            part = pows[p]
        else:
            dy, dx = d(off)
            part = shift2d(pows[p], -dy, -dx)
        cnt = part if cnt is None else cnt + part
        off += p
        size -= p
    return cnt
