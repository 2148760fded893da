"""Image-ops layer: filters, morphology, ridge/sauvola, labeling."""

import jax
import jax.numpy as jnp
import numpy as np

from cylinder_pose_estimation_tpu.ops.image import (
    bgr_to_gray,
    bilinear_sample,
    box_filter,
    gaussian_blur_cv,
    gaussian_kernel1d_cv,
    gradient2d,
    sep_filter2d,
)
from cylinder_pose_estimation_tpu.ops.labeling import (
    component_orientation,
    component_stats,
    connected_components,
    fill_orthoconvex,
    largest_component_mask,
)
from cylinder_pose_estimation_tpu.ops.morphology import (
    dilate_line,
    dilate_rect,
    directional_count,
    erode_rect,
    open_rect,
    shift2d,
)
from cylinder_pose_estimation_tpu.ops.ridge import binarize_ridges, hessian_eigenimages


def test_gaussian_kernel_cv_matches_opencv():
    # sigma <= 0, ksize <= 7: cv2.getGaussianKernel returns its hardcoded
    # small_gaussian_tab, NOT the 0.3*((k-1)/2-1)+0.8 formula.
    np.testing.assert_allclose(
        np.asarray(gaussian_kernel1d_cv(5, 0.0)),
        [0.0625, 0.25, 0.375, 0.25, 0.0625], atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(gaussian_kernel1d_cv(7, 0.0)),
        [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        atol=1e-7,
    )
    # larger ksize: the sigma formula applies.
    k = np.asarray(gaussian_kernel1d_cv(9, 0.0))
    sigma = 0.3 * ((9 - 1) * 0.5 - 1) + 0.8
    x = np.arange(9) - 4
    ref = np.exp(-x**2 / (2 * sigma**2))
    ref /= ref.sum()
    np.testing.assert_allclose(k, ref, atol=1e-6)
    # explicit sigma overrides the table even for small ksize.
    k5 = np.asarray(gaussian_kernel1d_cv(5, 1.1))
    x = np.arange(5) - 2
    ref = np.exp(-x**2 / (2 * 1.1**2))
    ref /= ref.sum()
    np.testing.assert_allclose(k5, ref, atol=1e-6)


def test_box_filter_constant_region():
    img = jnp.ones((32, 32), jnp.float32) * 7.0
    out = np.asarray(box_filter(img, 5, mode="edge"))
    np.testing.assert_allclose(out, 7.0, atol=1e-5)


def test_sep_filter_impulse():
    img = jnp.zeros((21, 21), jnp.float32).at[10, 10].set(1.0)
    k = gaussian_kernel1d_cv(5)
    out = np.asarray(sep_filter2d(img, k, k))
    kk = np.outer(np.asarray(k), np.asarray(k))
    np.testing.assert_allclose(out[8:13, 8:13], kk, atol=1e-6)
    assert abs(out.sum() - 1.0) < 1e-5


def test_gradient2d_matches_numpy():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(16, 20)).astype(np.float32)
    gr, gc = gradient2d(jnp.asarray(img))
    nr, nc = np.gradient(img)
    np.testing.assert_allclose(np.asarray(gr), nr, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gc), nc, atol=1e-5)


def test_bgr_to_gray():
    img = jnp.zeros((4, 4, 3), jnp.float32).at[..., 2].set(100.0)  # pure red
    out = np.asarray(bgr_to_gray(img))
    np.testing.assert_allclose(out, 29.9, atol=0.01)


def test_bilinear_sample():
    img = jnp.asarray(np.arange(16, dtype=np.float32).reshape(4, 4))
    v = float(bilinear_sample(img, jnp.asarray(1.5), jnp.asarray(2.0)))
    assert abs(v - (9.0 + 10.0) / 2) < 1e-5


def test_morphology_rect():
    m = jnp.zeros((16, 16), bool).at[5:8, 3:12].set(True)
    er = np.asarray(erode_rect(m, 3, 3))
    assert er[6, 5] and not er[5, 3]
    di = np.asarray(dilate_rect(m, 3, 3))
    assert di[4, 3] and di[8, 12]
    # opening removes speckle
    m2 = m.at[1, 1].set(True)
    op = np.asarray(open_rect(m2, 3, 3))
    assert not op[1, 1] and op[6, 6]


def test_horizontal_opening_keeps_horizontal_lines():
    """The joint-extraction trick (ref utils/util_cylinder.py:1805-1815)."""
    m = jnp.zeros((32, 64), bool)
    m = m.at[10, 5:60].set(True)   # horizontal line
    m = m.at[5:28, 30].set(True)   # vertical line
    h = np.asarray(open_rect(m, 1, 20))
    v = np.asarray(open_rect(m, 20, 1))
    assert h[10, 20] and not h[15, 30]
    assert v[15, 30] and not v[10, 20]
    joints = np.asarray(open_rect(m, 1, 20) & open_rect(m, 20, 1))
    # The AND of the two opened masks is exactly the crossing (the joint).
    assert joints[10, 30]
    assert joints.sum() <= 3


def test_shift2d_no_wrap():
    m = jnp.zeros((8, 8), bool).at[0, 0].set(True)
    out = np.asarray(shift2d(m, jnp.asarray(-2), jnp.asarray(-2)))
    assert not out.any()  # shifted off the edge, must not wrap
    out2 = np.asarray(shift2d(m, jnp.asarray(3), jnp.asarray(4)))
    assert out2[3, 4] and out2.sum() == 1


def test_dilate_line_bridges_gap():
    m = jnp.zeros((16, 64), bool)
    m = m.at[8, 5:20].set(True)
    m = m.at[8, 40:55].set(True)
    out = np.asarray(dilate_line(m, jnp.asarray(0.0), 50))
    assert out[8, 30]  # gap bridged along the line direction
    assert not out[12, 30]  # no perpendicular growth


def test_directional_count_endpoints():
    m = jnp.zeros((8, 32), bool).at[4, 5:25].set(True)
    fwd = np.asarray(directional_count(m, jnp.asarray(0.0), 5, +1))
    bwd = np.asarray(directional_count(m, jnp.asarray(0.0), 5, -1))
    assert fwd[4, 24] == 0  # right endpoint has empty forward ray
    assert fwd[4, 10] == 5
    assert bwd[4, 5] == 0   # left endpoint
    assert bwd[4, 10] == 5


def test_directional_count_angled_line_endpoints():
    """The log-doubling ray (re-rasterized vs a per-step loop) must still
    see a diagonal line's interior as occupied and its ends as empty."""
    import math

    n = 48
    m = np.zeros((n, n), bool)
    for t in range(8, 40):  # 45-degree 2-px-thick line
        m[t, t] = True
        m[min(t + 1, n - 1), t] = True
    ang = jnp.asarray(math.pi / 4)
    fwd = np.asarray(directional_count(jnp.asarray(m), ang, 6, +1))
    bwd = np.asarray(directional_count(jnp.asarray(m), ang, 6, -1))
    # interior pixels see a full ray both ways
    assert fwd[20, 20] >= 5 and bwd[20, 20] >= 5
    # the two ends see (near-)empty rays outward
    assert fwd[39, 39] <= 1
    assert bwd[8, 8] <= 1


def test_directional_count_steep_thin_diagonal():
    """Pin the ACCEPTED drift of the log-doubling ray on the worst case: a
    1-px-thick steep diagonal, where the composed offsets d(m)+d(off) differ
    from the per-step chain d(m+off) by <= 1 px laterally (see
    ops/morphology.py directional_count).  The contract we rely on for
    endpoint detection survives: true endpoints read (near-)empty outward
    rays, interior pixels read clearly-occupied rays, so the endpoint
    gate (count == 0) never fires mid-line."""
    import math

    n = 64
    m = np.zeros((n, n), bool)
    ang = math.atan2(2.0, 1.0)  # ~63.4 deg: steeper than the 45-deg test
    for t in range(24):  # 1-px-thick rasterized steep line from (8, 8)
        y, x = 8 + 2 * t, 8 + t
        m[y, x] = True
        m[min(y + 1, n - 1), x] = True  # 8-connected staircase riser
    fwd = np.asarray(directional_count(jnp.asarray(m), jnp.asarray(ang), 6, +1))
    bwd = np.asarray(directional_count(jnp.asarray(m), jnp.asarray(ang), 6, -1))
    on = m.nonzero()
    # No interior pixel reads a fully-empty outward ray in BOTH directions
    # (that would fabricate an isolated-speck reading mid-line).
    interior = (np.abs(on[0] - 31) < 16)
    assert (fwd[on][interior] + bwd[on][interior] > 0).all()
    # PINNED DRIFT: the re-rasterized ray alternates between the staircase
    # spine and riser, so a mid-line pixel CAN read 0 in ONE direction
    # (spine fwd=3/bwd=0, riser fwd=0/bwd=3 here) -- i.e. a one-sided
    # endpoint gate DOES fire mid-line on 1-px steep diagonals.  This is
    # the accepted deviation from the reference's per-contour PCA endpoints
    #; steep scenes are fenced by DetectResult.labels_converged
    # rather than by endpoint fidelity.
    assert fwd[30, 19] + bwd[30, 19] >= 3  # spine interior: occupied one way
    assert fwd[31, 19] + bwd[31, 19] >= 3  # riser interior: occupied one way
    # The two true ends read near-empty outward rays (<= 1 px of drift).
    assert fwd[54, 31] <= 1 and fwd[55, 31] <= 1
    assert bwd[8, 8] <= 1 and bwd[9, 8] <= 1


def test_connected_components_and_stats():
    m = np.zeros((32, 32), bool)
    m[2:6, 2:6] = True       # 16 px blob
    m[20:22, 20:30] = True   # 20 px blob
    m[10, 10] = True         # 1 px
    labels, stats = jax.jit(
        lambda mm: (lambda l: (l, component_stats(l, k=4)))(
            connected_components(mm, iters=8)
        )
    )(jnp.asarray(m))
    counts = sorted(np.asarray(stats.count)[np.asarray(stats.valid)].tolist(), reverse=True)
    assert counts == [20, 16, 1]
    big = jax.jit(largest_component_mask)(labels)
    assert np.asarray(big)[21, 25] and not np.asarray(big)[3, 3]
    # centroid of the square blob
    cent = np.asarray(stats.centroid)
    idx = np.asarray(stats.count).tolist().index(16)
    np.testing.assert_allclose(cent[idx], [3.5, 3.5], atol=1e-5)


def test_connected_components_l_shape():
    m = np.zeros((24, 24), bool)
    m[5, 5:20] = True
    m[5:20, 19] = True
    labels = np.asarray(
        jax.jit(lambda mm: connected_components(mm, iters=4))(jnp.asarray(m))
    )
    assert labels[5, 5] == labels[19, 19]  # one component despite the bend


def test_component_orientation():
    m = np.zeros((32, 32), bool)
    # diagonal line y = x
    m[np.arange(5, 25), np.arange(5, 25)] = True
    stats = jax.jit(
        lambda mm: component_stats(connected_components(mm, iters=8), k=1)
    )(jnp.asarray(m))
    ang = float(component_orientation(stats)[0])
    assert abs(np.degrees(ang) - 45.0) < 3.0


def test_fill_orthoconvex():
    m = jnp.zeros((16, 16), bool)
    m = m.at[3, 3].set(True).at[3, 12].set(True).at[12, 3].set(True).at[12, 12].set(True)
    out = np.asarray(fill_orthoconvex(m))
    assert out[7, 7]  # interior filled
    assert not out[0, 0]


def test_binarize_ridges_finds_lines():
    """Bright thin lines become True in the binary mask (ref preprocessing)."""
    img = np.full((64, 64), 20.0, np.float32)
    img[30:33, :] += 150.0  # horizontal bright line
    img[:, 40:43] += 150.0
    from cylinder_pose_estimation_tpu.ops.image import gaussian_blur_cv

    binary = np.asarray(
        jax.jit(
            lambda im: binarize_ridges(
                gaussian_blur_cv(im, 5), min_contrast=0.05
            )
        )(jnp.asarray(img))
    )
    assert binary[31, 20]
    assert binary[20, 41]
    assert not binary[10, 10]
    # side lobes of the ridge are excluded
    assert not binary[25, 20] and not binary[37, 20]
    # lines cover a small minority of the interior (borders carry the
    # constant-padding ridge artifact, same as skimage's mode='constant')
    assert binary[14:-14, 14:-14].mean() < 0.5


def test_hessian_minima_negative_on_bright_ridge():
    img = np.full((64, 64), 10.0, np.float32)
    img[32, :] = 200.0
    _, minima = jax.jit(lambda im: hessian_eigenimages(im, 3.0))(jnp.asarray(img))
    m = np.asarray(minima)
    assert m[32, 32] < 0
    assert m[32, 32] < m[10, 10]
