"""Distortion-in-the-loop end-to-end tests.

Every other e2e test runs with zero distortion coefficients, making
undistortion an identity resample.  Here the sensor images are rendered
through a FORWARD-distorting camera (grid points pushed through the OpenCV
radial/tangential model, ref utils/iotool.py:33-35), then the full
undistort -> detect -> correspond -> triangulate -> fit chain must recover
the pose (ref preProcessing.m:12-13: the reference always detects on
undistorted real images).

Two regimes, two tests:

  * fast half-res: EXTREME distortion (k1=-1.2; far beyond real lenses) as a
    robustness check.  At that severity the undistort resample's local
    stretch systematically shifts ridge positions (the reference's
    cv2.undistort + detection chain shares this bias), so the assertion is
    relative: distorted ~= the zero-distortion control.
  * slow full-res: REALISTIC distortion (k1=-0.3, a strong but plausible
    lens) with absolute accuracy asserted.  Measured round 4: the axis-error
    noise floor at the detector's ~0.5 px error was ~3 deg median at the old
    9x9/r104 scene geometry -- BELOW the 2 deg assertion (the round-3 red
    test), with LM fully converged and matching fminsearch.  The fix is
    physics, not optimizer work: a longer 13-row scene (axis extent 288 mm vs
    radius 52), cfg.subpixel_refine (CoG refinement halves detection error to
    ~0.23 px), and arc-true rendering (col_stride=4 removes the chord-sagitta
    harness artifact).  Measured: control 0.75 deg, distorted 1.07 deg vs the
    2 deg bar; Monte-Carlo q90 at 0.23 px noise ~0.9 deg.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig
from cylinder_pose_estimation_tpu.models.pipeline import estimate_pose_stereo
from cylinder_pose_estimation_tpu.ops.remap import distort_points, undistort_image
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)

# Extreme coefficients for the robustness (relative) test; realistic ones for
# the absolute-accuracy test.
_EXTREME = ([-1.2, 0.5, 0.0], [3e-3, -2e-3])
_REALISTIC = ([-0.3, 0.08, 0.0], [1e-3, -5e-4])


def _distorted_stereo(h, w, coeffs=_EXTREME):
    radial, tangential = coeffs
    stereo = default_stereo(cx=w / 2.0, cy=h / 2.0, baseline=30.0)
    cam_d = stereo.cam1._replace(
        radial=jnp.asarray(radial, jnp.float32),
        tangential=jnp.asarray(tangential, jnp.float32),
    )
    return stereo._replace(cam1=cam_d, cam2=cam_d)


def _warp_pixels(xy, cam):
    """Ideal pixel coords -> distorted sensor coords (forward model)."""
    k = cam.k
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    xn = jnp.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], axis=-1)
    d = distort_points(xn, cam)
    return jnp.stack([d[..., 0] * fx + cx, d[..., 1] * fy + cy], axis=-1)


def _render_views(scene_dense, stereo, n_rows, n_cols_dense, h, w, stride,
                  distorted):
    rng = np.random.default_rng(0)
    imgs = []
    for gp, cam in ((scene_dense.gp1, stereo.cam1), (scene_dense.gp2, stereo.cam2)):
        if distorted:
            xy = _warp_pixels(gp.xy, cam)
            shift = np.linalg.norm(
                np.asarray(xy - gp.xy)[np.asarray(gp.valid)], axis=-1
            )
            # the warp must be material, or this test is the identity
            # resample it is supposed to not be
            assert shift.max() > 2.0, f"warp too small ({shift.max():.2f} px)"
        else:
            xy = gp.xy
        img = render_grid_image(
            xy, gp.valid, n_rows, n_cols_dense, h, w, col_stride=stride,
            center_flat=(n_rows // 2) * n_cols_dense + (n_cols_dense // 2),
        )
        imgs.append(
            jnp.clip(
                img.astype(jnp.float32)
                + jnp.asarray(rng.normal(0, 2.0, (h, w)), jnp.float32),
                0, 255,
            )
        )
    return imgs


def _run_chain(h, w, distorted: bool, *, coeffs=_EXTREME, n_rows=9, n_cols=9,
               stride=1, subpixel=False, **scene_kw):
    """Render (optionally through the distorting camera), run the full
    undistort -> detect -> fit chain; returns (scene, result)."""
    stereo = _distorted_stereo(h, w, coeffs)
    scene = cylinder_grid_points(
        stereo, capacity=256, n_rows=n_rows, n_cols=n_cols, **scene_kw
    )
    ncd = (n_cols - 1) * stride + 1
    dense = (
        scene
        if stride == 1
        else cylinder_grid_points(
            stereo, capacity=1024, n_rows=n_rows, n_cols=ncd, **scene_kw
        )
    )
    imgs = _render_views(dense, stereo, n_rows, ncd, h, w, stride, distorted)

    cfg = CylinderDetectConfig(height=h, width=w, subpixel_refine=subpixel)
    fit_cfg = FitConfig(cyl_radius=scene_kw["radius"])

    @jax.jit
    def run(a, b):
        if distorted:
            a = undistort_image(a, stereo.cam1)
            b = undistort_image(b, stereo.cam2)
        return estimate_pose_stereo(a, b, stereo, cfg, fit_cfg)

    return scene, run(imgs[0], imgs[1])


_HALF_RES = dict(
    origin=(0.0, -15.0, 560.0), radius=52.0, row_spacing=12.0, theta_span=2.2
)
_FULL_RES = dict(
    n_rows=13, n_cols=9, stride=4, subpixel=True, coeffs=_REALISTIC,
    origin=(0.0, -20.0, 560.0), radius=52.0, row_spacing=24.0, theta_span=2.6,
)


def _detection_errors(scene, res, n_pts=81):
    gt = {
        tuple(np.asarray(scene.gp1.idx)[i]): np.asarray(scene.gp1.xy)[i]
        for i in range(n_pts)
        if np.asarray(scene.gp1.valid)[i]
    }
    det_xy = np.asarray(res.detect1.grid.xy)
    det_idx = np.asarray(res.detect1.grid.idx)
    det_val = np.asarray(res.detect1.grid.valid)
    return [
        np.linalg.norm(det_xy[i] - gt[tuple(det_idx[i])])
        for i in range(len(det_val))
        if det_val[i] and tuple(det_idx[i]) in gt
    ]


def _axis_err_deg(res, scene):
    ax = np.asarray(res.fit.params[3:6])
    ax = ax / np.linalg.norm(ax)
    gt_ax = np.asarray(scene.cyl_params[3:6])
    gt_ax = gt_ax / np.linalg.norm(gt_ax)
    return np.degrees(np.arccos(min(1.0, abs(float(ax @ gt_ax)))))


def test_distorted_roundtrip_matches_zero_distortion_control():
    h, w = 240, 320
    scene_d, res_d = _run_chain(h, w, True, **_HALF_RES)
    scene_c, res_c = _run_chain(h, w, False, **_HALF_RES)

    for res in (res_d, res_c):
        assert bool(res.detect1.ok) and bool(res.detect2.ok)
        assert bool(res.detect1.stable)

    # detection accuracy: distorted round-trip within the suite tolerances
    # and comparable to the identity-resample control
    errs_d = _detection_errors(scene_d, res_d)
    errs_c = _detection_errors(scene_c, res_c)
    assert len(errs_d) >= 20
    assert np.median(errs_d) < 1.5 and np.max(errs_d) < 4.0
    assert np.median(errs_d) < np.median(errs_c) + 0.5

    # pose: same ballpark as the control (the absolute axis accuracy at this
    # scene scale is ~12 deg FOR THE CONTROL TOO; full-res absolute accuracy
    # is asserted in the slow test below)
    ang_d = _axis_err_deg(res_d, scene_d)
    ang_c = _axis_err_deg(res_c, scene_c)
    assert ang_d < ang_c + 3.0, (ang_d, ang_c)
    assert float(res_d.fit.mean_reproj_error) < float(
        res_c.fit.mean_reproj_error
    ) + 0.3
    np.testing.assert_allclose(
        np.asarray(res_d.fit.params[:3]),
        np.asarray(res_c.fit.params[:3]),
        atol=8.0,
    )


@pytest.mark.slow
def test_distorted_roundtrip_full_resolution_absolute():
    scene, res = _run_chain(480, 640, True, **_FULL_RES)
    assert bool(res.detect1.ok) and bool(res.detect2.ok)
    errs = _detection_errors(scene, res, n_pts=13 * 9)
    assert len(errs) >= 30
    # Max budget 5.0: the r5 reference-exact prune (min-y order, detector
    # stage 6d) keeps an arc-END column the old rule always discarded; its
    # extreme points sit where the degree-2 curve model mismatches the
    # radially-distorted arc the most (measured tail: 3.9/4.1 px on this
    # scene, median unchanged at ~0.35).  The reference's own deg-2 fit has
    # the identical model error on that column.
    assert np.median(errs) < 0.5 and np.max(errs) < 5.0
    assert _axis_err_deg(res, scene) < 2.0
    assert float(res.fit.mean_reproj_error) < 0.5
