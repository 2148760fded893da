"""ops/labeling.connected_components against an independent oracle.

The oracle is a plain breadth-first flood fill over 8-neighbours in NumPy,
sharing nothing with the pooled segmented-scan labeling under test.  The
masks are the families the detector feeds the labeling, at the canvases it
feeds them on: half-res line masks (240x384, the bridge and final labels),
bridged lines whose joins jog a row or column, quarter-res blobs (128x256,
the ROI and saturation labelings), an empty mask, components touching the
canvas border, and the batched h/v pair the detector labels in one vmap.
The labels must match exactly: background = H*W, every foreground pixel
= the minimum linear index of its component.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cylinder_pose_estimation_tpu.config import DetectConfig
from cylinder_pose_estimation_tpu.ops.labeling import (
    connected_components,
    fixpoint_residual,
    window_extreme,
)

HALF = (240, 384)      # half-res padded canvas of a 480x640 frame
QUARTER = (128, 256)   # quarter-res padded canvas


def flood_fill_labels(mask: np.ndarray) -> np.ndarray:
    """Min-linear-index labels of the 8-connected components of ``mask``."""
    h, w = mask.shape
    out = np.full((h, w), h * w, np.int64)
    seen = np.zeros((h, w), bool)
    for y0, x0 in zip(*np.nonzero(mask)):
        if seen[y0, x0]:
            continue
        comp = []
        queue = deque([(y0, x0)])
        seen[y0, x0] = True
        while queue:
            y, x = queue.popleft()
            comp.append((y, x))
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    yy, xx = y + dy, x + dx
                    if (0 <= yy < h and 0 <= xx < w and mask[yy, xx]
                            and not seen[yy, xx]):
                        seen[yy, xx] = True
                        queue.append((yy, xx))
        ys, xs = np.array(comp).T
        out[ys, xs] = (ys * w + xs).min()
    return out


def _arc(mask, y0, x_lo, x_hi, curve, thick, slope=0.0):
    """A thick, slightly curved near-horizontal laser line."""
    cx = 0.5 * (x_lo + x_hi)
    for x in range(x_lo, x_hi):
        y = int(round(y0 + slope * (x - cx) + curve * (x - cx) ** 2))
        mask[max(y, 0):max(y + thick, 0), x] = True


def _h_lines(shape=HALF):
    m = np.zeros(shape, bool)
    for k, y0 in enumerate(range(30, shape[0] - 30, 12)):
        _arc(m, y0, 20, shape[1] - 30, curve=4e-4 * (k % 3), thick=2,
             slope=0.02 * ((k % 5) - 2))
    return m


def _v_lines(shape=HALF):
    return _h_lines((shape[1], shape[0])).T.copy()


def _bridged_lines():
    m = _h_lines()
    # cut two lines and rejoin them with bridges that jog a row and a column
    m[54:60, 150:170] = False
    for i in range(20):
        m[54 + i // 6, 150 + i] = True
    m[100:110, 200:206] = False
    m[102:106, 200:206] = True
    # and one vertical line broken into fragments, one gap left open
    m[40:200, 300:302] = True
    m[90:94, 300:302] = False
    m[150:153, 300:302] = False
    m[150:153, 301:303] = True
    return m


def _lowres_blobs():
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:QUARTER[0], 0:QUARTER[1]]
    m = np.zeros(QUARTER, bool)
    for _ in range(9):
        cy, cx = rng.uniform(5, QUARTER[0] - 5), rng.uniform(5, 160)
        ry, rx = rng.uniform(2, 14, size=2)
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    m[:, 161:] = False  # the canvas padding beyond the pooled content
    m[10:14, 100:130] = True  # a dilated union bar merging blobs
    m |= rng.random(QUARTER) < 0.01  # isolated speckle
    return m


def _border_touching():
    m = np.zeros(HALF, bool)
    m[0, :] = True                  # top row, corner to corner
    m[:, HALF[1] - 1] = True        # right column
    m[HALF[0] - 3:, 5:40] = True    # block on the bottom edge
    m[100:140, 0:3] = True          # left edge
    m[HALF[0] - 1, HALF[1] - 1] = True
    m[1, 200:230] = False           # a notch under the top row
    m[2, 199] = True                # a speck two rows under the top edge
    return m


FAMILIES = {
    "h_lines": lambda: _h_lines(),
    "v_lines": lambda: _v_lines(),
    "bridged_lines": _bridged_lines,
    "lowres_blobs": _lowres_blobs,
    "empty": lambda: np.zeros(HALF, bool),
    "border_touching": _border_touching,
}


@pytest.fixture(scope="module")
def label():
    iters = DetectConfig().cc_iters
    return jax.jit(lambda m: connected_components(m, iters=iters))


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["batched_hv_pair"])
def test_connected_components_match_flood_fill(label, family):
    if family == "batched_hv_pair":
        # the detector's final labeling: h and v masks in one vmapped call
        pair = np.stack([_h_lines(), _v_lines()])
        iters = DetectConfig().cc_iters
        got = np.asarray(jax.jit(jax.vmap(
            lambda m: connected_components(m, iters=iters)))(jnp.asarray(pair)))
        want = np.stack([flood_fill_labels(m) for m in pair])
        n_comp = sum(len(np.unique(w[w < w.size])) for w in want)
    else:
        mask = FAMILIES[family]()
        got = np.asarray(label(jnp.asarray(mask)))
        want = flood_fill_labels(mask)
        n_comp = len(np.unique(want[mask]))
    np.testing.assert_array_equal(got, want)
    if family == "empty":
        assert n_comp == 0
    else:
        assert n_comp >= 2, f"{family}: degenerate mask ({n_comp} components)"


def _residual_oracle(labels: np.ndarray, mask: np.ndarray) -> int:
    """Mask pixels with a smaller label on an in-mask 8-neighbour."""
    h, w = mask.shape
    n = 0
    for y, x in zip(*np.nonzero(mask)):
        nb = labels[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
        nm = mask[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
        n += int(nb[nm].min() < labels[y, x])
    return n


@pytest.mark.parametrize("iters", [0, 1, None])
def test_fixpoint_residual_matches_oracle(iters):
    """0 on converged labels, the exact unconverged count on partial ones,
    over the h/v pair stacked as the detector stacks it."""
    pair = np.stack([_bridged_lines(), _border_touching()])
    n_iter = DetectConfig().cc_iters if iters is None else iters
    labels = np.asarray(jax.vmap(
        lambda m: connected_components(m, iters=n_iter))(jnp.asarray(pair)))
    got = int(jax.jit(fixpoint_residual)(jnp.asarray(labels), jnp.asarray(pair)))
    want = sum(_residual_oracle(l, m) for l, m in zip(labels, pair))
    assert got == want
    assert (got == 0) == (iters is None)


def _window_oracle(x: np.ndarray, wy: int, wx: int, fill, op) -> np.ndarray:
    """Per-pixel loop: op over the in-image taps of a SAME-placed window,
    plus ``fill`` when the window reaches outside the image."""
    h, w = x.shape[-2:]
    oy, ox = (wy - 1) // 2, (wx - 1) // 2
    out = np.empty_like(x)
    for y in range(h):
        for xx in range(w):
            y0, y1 = y - oy, y - oy + wy
            x0, x1 = xx - ox, xx - ox + wx
            win = x[..., max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)]
            v = op.reduce(win.reshape(win.shape[:-2] + (-1,)), axis=-1)
            if y0 < 0 or x0 < 0 or y1 > h or x1 > w:
                v = op(v, fill)
            out[..., y, xx] = v
    return out


@pytest.mark.parametrize(
    "wy,wx,op,stacked",
    [(3, 3, "min", True), (3, 1, "max", False), (1, 3, "min", False),
     (2, 4, "max", True)],
)
def test_window_extreme_matches_oracle(wy, wx, op, stacked):
    """The slice-form window min/max the detector uses for int32 label and
    key images (3x3 fixpoint check, separable peak and lookup windows), on
    the int32 extremes as fill, against a per-pixel loop."""
    rng = np.random.default_rng(wy * 10 + wx)
    shape = (2, 9, 11) if stacked else (9, 11)
    x = rng.integers(-1000, 1000, shape).astype(np.int32)
    info = np.iinfo(np.int32)
    fill = info.max if op == "min" else info.min
    jop, nop = (jnp.minimum, np.minimum) if op == "min" else (jnp.maximum, np.maximum)
    got = np.asarray(window_extreme(jnp.asarray(x), wy, wx, fill, jop))
    np.testing.assert_array_equal(got, _window_oracle(x, wy, wx, fill, nop))


def test_flood_fill_oracle_itself():
    """The oracle on a hand-checked mask: diagonal contact joins, a one-px
    gap separates, background is H*W."""
    m = np.zeros((4, 5), bool)
    m[0, 0] = m[1, 1] = True        # diagonal neighbours: one component
    m[0, 3] = m[2, 3] = True        # one-px gap: two components
    got = flood_fill_labels(m)
    want = np.full((4, 5), 20)
    want[0, 0] = want[1, 1] = 0
    want[0, 3] = 3
    want[2, 3] = 13
    np.testing.assert_array_equal(got, want)
