"""Undistortion, CLAHE, subpixel refinement, anomaly removal tests."""

import jax.numpy as jnp
import numpy as np

from cylinder_pose_estimation_tpu.ops.clahe import clahe, preprocess_stereo
from cylinder_pose_estimation_tpu.ops.remap import (
    distort_points,
    undistort_image,
    undistort_points,
)
from cylinder_pose_estimation_tpu.models.refine import (
    interval_anomaly_mask,
    refine_curves_cog,
    remove_first_last_labels,
)
from cylinder_pose_estimation_tpu.types import CameraModel
from cylinder_pose_estimation_tpu.utils.synthetic import default_stereo


def _distorting_camera():
    k = jnp.asarray([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]], jnp.float32)
    return CameraModel(
        k=k,
        radial=jnp.asarray([-0.25, 0.08, 0.0], jnp.float32),
        tangential=jnp.asarray([1e-3, -5e-4], jnp.float32),
    )


def test_undistort_points_roundtrip():
    cam = _distorting_camera()
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform([100, 100], [540, 380], size=(64, 2)), jnp.float32)
    # distort, then undistort -> identity
    k = cam.k
    xn = (pts[:, 0] - k[0, 2]) / k[0, 0]
    yn = (pts[:, 1] - k[1, 2]) / k[1, 1]
    d = distort_points(jnp.stack([xn, yn], -1), cam)
    distorted = jnp.stack([d[:, 0] * k[0, 0] + k[0, 2], d[:, 1] * k[1, 1] + k[1, 2]], -1)
    rec = undistort_points(distorted, cam, iters=12)
    np.testing.assert_allclose(np.asarray(rec), np.asarray(pts), atol=0.02)


def test_undistort_image_straightens_line():
    cam = _distorting_camera()
    # Draw a straight world line's *distorted* image, undistort, check it is
    # straight again: sample undistorted row y=150 at various x, find where
    # those points land in the distorted image.
    img = np.zeros((480, 640), np.float32)
    k = np.asarray(cam.k)
    xs = np.linspace(60, 580, 200)
    ys = np.full_like(xs, 150.0)
    xn = (xs - k[0, 2]) / k[0, 0]
    yn = (ys - k[1, 2]) / k[1, 1]
    d = np.asarray(distort_points(jnp.asarray(np.stack([xn, yn], -1), jnp.float32), cam))
    dx = d[:, 0] * k[0, 0] + k[0, 2]
    dy = d[:, 1] * k[1, 1] + k[1, 2]
    for x, y in zip(dx, dy):
        xi, yi = int(round(x)), int(round(y))
        img[max(yi - 1, 0) : yi + 2, max(xi - 1, 0) : xi + 2] = 255.0
    out = np.asarray(undistort_image(jnp.asarray(img), cam))
    rows = []
    for col in range(80, 560, 40):
        strip = out[:, col]
        if strip.max() > 50:
            rows.append(np.argmax(strip))
    rows = np.asarray(rows)
    assert rows.std() < 2.0, f"undistorted line not straight: rows={rows}"


def test_clahe_improves_local_contrast():
    rng = np.random.default_rng(1)
    img = np.full((128, 128), 50.0, np.float32)
    img[:64] += 100.0  # two brightness zones
    img += rng.normal(0, 3.0, img.shape)
    out = np.asarray(clahe(jnp.asarray(img), tiles=4, clip_limit=0.05))
    assert out.shape == img.shape
    # local contrast (std within each half) should increase
    assert out[:64].std() > img[:64].std()
    assert out.min() >= 0.0 and out.max() <= 255.0


def test_clahe_constant_image_stays_finite():
    img = np.full((128, 128), 100.0, np.float32)
    out = np.asarray(clahe(jnp.asarray(img), tiles=4, clip_limit=0.01))
    assert np.isfinite(out).all()
    assert out.std() < 1.0  # constant in, (near-)constant out


def test_clahe_clip_limits_amplification():
    # Strong clipping should pull the result toward the identity-ish mapping:
    # higher clip -> more equalization -> higher output std on a low-contrast
    # noisy image.
    rng = np.random.default_rng(2)
    img = (110.0 + rng.normal(0, 4.0, (128, 128))).astype(np.float32)
    lo = np.asarray(clahe(jnp.asarray(img), tiles=4, clip_limit=0.005))
    hi = np.asarray(clahe(jnp.asarray(img), tiles=4, clip_limit=0.2))
    assert hi.std() > lo.std()


def test_preprocess_stereo_shapes():
    stereo = default_stereo()
    img = jnp.asarray(np.random.default_rng(0).uniform(0, 255, (480, 640)), jnp.float32)
    g1, g2 = preprocess_stereo(img, img, stereo.cam1, stereo.cam2)
    assert g1.shape == (480, 640) and g2.shape == (480, 640)


def test_refine_curves_cog_recovers_shifted_line():
    # A bright horizontal line at y=40.7; a deliberately wrong fit at y=38.
    img = np.zeros((80, 120), np.float32)
    yc = 40.7
    for x in range(120):
        for dy in range(-3, 4):
            y = int(round(yc)) + dy
            img[y, x] = 200.0 * np.exp(-((y - yc) ** 2) / (2 * 1.5**2))
    coeffs = jnp.asarray([[0.0, 38.0]], jnp.float32)  # y = 38
    domain = jnp.asarray([[5.0, 115.0]], jnp.float32)
    valid = jnp.asarray([True])
    out = np.asarray(
        refine_curves_cog(jnp.asarray(img), coeffs, domain, valid, degree=1)
    )
    # refined intercept moves toward the true line (clamped steps -> partial)
    assert out[0, 1] > 38.5


def test_remove_first_last_labels():
    rv = jnp.asarray([True, True, True, True, False])
    cv = jnp.asarray([True, True, True, False, False])
    rr = jnp.asarray([0, 1, 2, 3, 4])
    cr = jnp.asarray([0, 1, 2, 3, 4])
    rv2, cv2 = remove_first_last_labels(rv, cv, rr, cr)
    assert np.asarray(rv2).tolist() == [False, True, True, False, False]
    assert np.asarray(cv2).tolist() == [False, True, False, False, False]


def test_interval_anomaly_mask():
    means = jnp.asarray([10.0, 40.0, 70.0, 100.0, 230.0, 0.0])
    valid = jnp.asarray([True, True, True, True, True, False])
    keep = np.asarray(interval_anomaly_mask(means, valid))
    assert keep[:4].all()
    assert not keep[4]  # the 230 outlier column
    assert not keep[5]


def test_clahe_matches_adapthisteq_oracle():
    """Oracle pin: ops/clahe.py vs a NumPy
    transliteration of MATLAB adapthisteq's documented algorithm
    (tests/_oracle_clahe.py: Zuiderveld clip limit, iterative excess
    redistribution, full-range 'uniform' mapping; ref
    utils/preProcessing.m:17-18).  Textured images with smooth gradients,
    a bright blob, and noise; agreement to ~1e-4 gray levels except for
    isolated bin-edge pixels where float32 vs float64 binning flips a
    256-bin index (bounded by the max tolerance)."""
    import _oracle_clahe as oc

    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:480, 0:640]
    for trial in range(3):
        img = (
            80
            + 60 * np.sin(xx / (60.0 + 20 * trial))
            + 40 * np.cos(yy / (50.0 + 15 * trial))
            + rng.normal(0, 10 + 4 * trial, (480, 640))
        )
        img += 110 * np.exp(
            -((yy - 200 - 30 * trial) ** 2 + (xx - 300) ** 2) / (2 * 70**2)
        )
        img = np.clip(img, 0, 255)
        want = oc.adapthisteq(img)
        got = np.asarray(clahe(jnp.asarray(img, jnp.float32)))
        d = np.abs(want - got)
        assert d.mean() < 0.01, d.mean()
        assert np.percentile(d, 99.9) < 0.1
        assert d.max() < 3.0, d.max()


def test_undistort_cubic_interpolates_exactly_on_smooth_field():
    """Catmull-Rom reproduces cubics: undistorting a quadratic-intensity
    field must be near-exact away from borders (sanity for the new 'cubic'
    option; bilinear shows its O(h^2) curvature error on the same field)."""
    cam = _distorting_camera()
    yy, xx = jnp.mgrid[0:240, 0:320]
    img = (0.002 * (xx - 160.0) ** 2 + 0.003 * (yy - 120.0) ** 2).astype(
        jnp.float32
    )
    out_c = undistort_image(img, cam, interp="cubic")
    # ground truth: evaluate the analytic field at the distorted source coords
    from cylinder_pose_estimation_tpu.ops.remap import distort_points

    k = cam.k
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    gx = (xx.astype(jnp.float32) - cx) / fx
    gy = (yy.astype(jnp.float32) - cy) / fy
    d = distort_points(jnp.stack([gx, gy], -1), cam)
    sx = d[..., 0] * fx + cx
    sy = d[..., 1] * fy + cy
    want = 0.002 * (sx - 160.0) ** 2 + 0.003 * (sy - 120.0) ** 2
    interior = (
        (sx > 4) & (sx < 315) & (sy > 4) & (sy < 235)
    )
    err_c = jnp.abs(out_c - want)[interior]
    assert float(err_c.max()) < 1e-3, float(err_c.max())
    out_b = undistort_image(img, cam, interp="bilinear")
    err_b = jnp.abs(out_b - want)[interior]
    assert float(err_b.max()) > 10 * float(err_c.max())  # cubic strictly better


def test_undistort_cubic_vs_bilinear_ridge_shift_bounded():
    """The measured cubic-vs-bilinear
    ridge-position deviation at strong distortion.  A Gaussian line rendered
    in DISTORTED space, undistorted both ways; subpixel ridge centers via
    center-of-gravity per column.  The committed bound documents the
    deviation scale: mean shift well under 0.05 px, max under 0.2 px --
    below the suite's 0.5 px e2e budgets but NOT below the 1e-3 px geometry
    budgets, hence the experiment path (preprocess_stereo) now defaults to
    the reference's cubic."""
    cam = _distorting_camera()
    h, w = 240, 320
    yy, xx = np.mgrid[0:h, 0:w]
    # distorted-space image whose TRUE undistorted ridge is the row y=120:
    # render the line at the distorted position of each undistorted pixel
    from cylinder_pose_estimation_tpu.ops.remap import distort_points

    k = cam.k
    fx, fy, cx, cy = (
        float(k[0, 0]),
        float(k[1, 1]),
        float(k[0, 2]),
        float(k[1, 2]),
    )
    # For a horizontal line at y0 in undistorted space, the distorted image
    # contains it along the curve y_d(x).  Build the distorted image by
    # evaluating, for every distorted pixel, its undistorted height via the
    # iterative inverse, then a Gaussian profile around y0.
    und = undistort_points(
        jnp.asarray(np.stack([xx.ravel(), yy.ravel()], -1), jnp.float32), cam
    )
    y_und = np.asarray(und)[:, 1].reshape(h, w)
    img_d = 20.0 + 180.0 * np.exp(-((y_und - 120.0) ** 2) / (2 * 1.8**2))

    outs = {}
    for interp in ("bilinear", "cubic"):
        out = np.asarray(
            undistort_image(jnp.asarray(img_d, jnp.float32), cam, interp=interp)
        )
        # subpixel ridge center per column by center of gravity over y
        band = out[108:133, :] - 20.0
        band = np.clip(band, 0, None)
        ys = np.arange(108, 133, dtype=np.float64)[:, None]
        outs[interp] = (band * ys).sum(0) / np.maximum(band.sum(0), 1e-9)
    shift = np.abs(outs["cubic"] - outs["bilinear"])[10:-10]
    err_c = np.abs(outs["cubic"] - 120.0)[10:-10]
    assert shift.mean() < 0.05, shift.mean()
    assert shift.max() < 0.2, shift.max()
    assert err_c.mean() < 0.05  # cubic lands on the true ridge
