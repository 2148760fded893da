"""Banded-matrix convolution helpers (ops/mxu_conv).

Exactness contract: box/ramp taps on 0/1 masks give EXACT integer results
(bf16 products of small integers accumulate exactly in f32); Gaussian taps
are bf16-rounded once so every caller sees identical values.
"""

import numpy as np
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.ops import mxu_conv as mc


def _zero_pad_corr(img, taps, axis):
    r = len(taps) // 2
    out = np.zeros_like(img, np.float64)
    for t, v in enumerate(taps):
        off = t - r
        sh = np.zeros_like(img, np.float64)
        n = img.shape[axis]
        src = slice(max(0, off), min(n, n + off))
        dst = slice(max(0, -off), min(n, n - off))
        if axis == 0:
            sh[dst, :] = img[src, :]
        else:
            sh[:, dst] = img[:, src]
        out += v * sh
    return out


def test_box_sum_exact_on_mask():
    rng = np.random.default_rng(0)
    m = rng.integers(0, 2, (48, 64)).astype(np.float32)
    taps = mc.box_taps(11)
    out = np.asarray(
        mc.conv_y(mc.conv_x(jnp.asarray(m), mc.x_mat(taps, 64)),
                  mc.y_mat(taps, 48))
    )
    ref = _zero_pad_corr(_zero_pad_corr(m, taps, 1), taps, 0)
    assert np.array_equal(out, ref)


def test_ramp_exact_both_axes():
    rng = np.random.default_rng(1)
    m = rng.integers(0, 2, (48, 64)).astype(np.float32)
    taps = mc.ramp_taps(11)
    ox = np.asarray(mc.conv_x(jnp.asarray(m), mc.x_mat(taps, 64)))
    oy = np.asarray(mc.conv_y(jnp.asarray(m), mc.y_mat(taps, 48)))
    assert np.array_equal(ox, _zero_pad_corr(m, taps, 1))
    assert np.array_equal(oy, _zero_pad_corr(m, taps, 0))


def test_first_moment_identity():
    """sum_W(j * x) == x * cnt + corr(j, ramp): the exact-integer route the
    detector uses for joint box centroids (models/detector._stats_images)."""
    rng = np.random.default_rng(2)
    m = rng.integers(0, 2, (48, 64)).astype(np.float32)
    w = 11
    bx, by = mc.x_mat(mc.box_taps(w), 64), mc.y_mat(mc.box_taps(w), 48)
    cnt = np.asarray(mc.conv_y(mc.conv_x(jnp.asarray(m), bx), by))
    tx = mc.conv_x(jnp.asarray(m), mc.x_mat(mc.ramp_taps(w), 64))
    sx = np.arange(64)[None, :] * cnt + np.asarray(mc.conv_y(tx, by))
    xx = np.arange(64)[None, :] * np.ones((48, 1))
    ref = _zero_pad_corr(_zero_pad_corr(m * xx, mc.box_taps(w), 1),
                         mc.box_taps(w), 0)
    assert np.array_equal(sx, ref)


def test_gaussian_close_to_f64():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 256, (48, 64)).astype(np.float32)
    taps = mc.gauss_taps_cv(19)
    out = np.asarray(
        mc.conv_y(mc.conv_x(jnp.asarray(g), mc.x_mat(taps, 64)),
                  mc.y_mat(taps, 48))
    )
    ref = _zero_pad_corr(_zero_pad_corr(g.astype(np.float64), taps, 1),
                         taps, 0)
    # bf16 tap + intermediate rounding: ~0.4% worst-case relative error.
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 0.01


def test_compose_taps_matches_two_pass():
    a = mc.gauss_taps_cv(7)
    b = mc.box_taps(7)
    comp = mc.compose_taps(a, b)
    assert len(comp) == 13
    x = np.zeros(41)
    x[20] = 1.0
    one = _zero_pad_corr(
        _zero_pad_corr(x[None, :], a, 1), b, 1
    )
    two = _zero_pad_corr(x[None, :], comp, 1)
    assert np.allclose(one, two, atol=1e-12)


def test_conv_at_points_matches_image_gather():
    """Per-point banded dots == full-image separable conv gathered at the
    points (same exact-mode arithmetic up to f32 summation order)."""
    import numpy as np
    import jax.numpy as jnp
    from cylinder_pose_estimation_tpu.ops import mxu_conv as mxc

    rng = np.random.default_rng(5)
    h, w = 96, 128
    img = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
    ys = jnp.asarray(rng.integers(0, h, 40), jnp.int32)
    xs = jnp.asarray(rng.integers(0, w, 40), jnp.int32)
    for taps in (mxc.box_taps(11),
                 mxc.compose_taps(mxc.gauss_taps_cv(7), mxc.box_taps(7))):
        ref_img = mxc.conv_y(
            mxc.conv_x(img, mxc.x_mat(taps, w, exact=True), exact=True),
            mxc.y_mat(taps, h, exact=True), exact=True,
        )
        ref = np.asarray(ref_img)[np.asarray(ys), np.asarray(xs)]
        got = np.asarray(mxc.conv_at_points(img, ys, xs, taps))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-2)
