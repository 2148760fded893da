"""Independent-scene-family validation.

Detection, fences, and the stereo fit exercised on tests/_scene_family2.py's
image-formation model -- Lorentzian / flat-top ridge profiles,
perspective-thinned line widths, multiplicative illumination, saturated
off-grid clutter, defocus, gamma speckle -- none of which the detector's
native renderer (utils/synthetic.render_grid_image) produces.  This breaks
the renderer-detector co-adaptation: every fence threshold
(min_mask_retention, max_stable_tilt) is asserted to land on the intended
side on a family it was NOT calibrated on.

Observed accuracy on this family (expected physics, not a bug): the ridge
of a Lorentzian-tailed line under an asymmetric illumination gradient sits
~0.5-0.7 px off the geometric centerline on average, up to ~2-3 px on the
dimmest thinned edge column; the matching tolerances below encode that.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import _scene_family2 as sf2

H, W = 480, 640


@pytest.fixture(scope="module")
def stereo():
    from cylinder_pose_estimation_tpu.utils.synthetic import default_stereo

    return default_stereo(cx=W / 2.0, cy=H / 2.0)


@pytest.fixture(scope="module")
def det():
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig
    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    cfg = CylinderDetectConfig(height=H, width=W)
    return jax.jit(lambda im: detect_grid(im, cfg))


def _gt_map(gp, stride=4):
    """Ground-truth {(col,row): xy} for the real (non-densified) laser cols."""
    gxy = np.asarray(gp.xy)
    gidx = np.asarray(gp.idx)
    gval = np.asarray(gp.valid)
    out = {}
    for i in range(len(gval)):
        if gval[i] and gidx[i, 0] % stride == 0:
            out[(int(gidx[i, 0]) // stride, int(gidx[i, 1]))] = gxy[i]
    return out


def _score(res, gp):
    idx = np.asarray(res.grid.idx)
    xy = np.asarray(res.grid.xy)
    valid = np.asarray(res.grid.valid)
    det_pts = {
        (int(idx[i, 0]), int(idx[i, 1])): xy[i]
        for i in range(len(valid))
        if valid[i]
    }
    gt = _gt_map(gp)
    errs = {
        k: float(np.hypot(*(p - gt[k]))) for k, p in det_pts.items() if k in gt
    }
    matched = {k: e for k, e in errs.items() if e < 2.5}
    inner = [e for k, e in matched.items() if abs(k[0]) <= 3]
    return det_pts, matched, inner


def _assert_scene_quality(res, gp):
    det_pts, matched, inner = _score(res, gp)
    assert bool(np.asarray(res.ok))
    assert bool(np.asarray(res.stable)), "fence tripped on a healthy scene"
    assert len(det_pts) >= 32, len(det_pts)
    assert len(matched) >= 30, (len(matched), len(det_pts))
    assert len(matched) / len(det_pts) >= 0.85
    assert np.mean(list(matched.values())) < 1.0
    assert inner and np.mean(inner) < 0.9


def test_lorentz_scene_detects(stereo, det):
    scene, i1, _ = sf2.indep_scene(stereo, scene_seed=1, profile="lorentz")
    _assert_scene_quality(det(jnp.asarray(i1)), scene.gp1)


def test_flattop_scene_detects(stereo, det):
    scene, i1, _ = sf2.indep_scene(stereo, scene_seed=3, profile="flattop")
    _assert_scene_quality(det(jnp.asarray(i1)), scene.gp1)


def test_center_identity_both_views(stereo, det):
    """The detected origin must be the ground-truth brightest joint in BOTH
    views -- the property stereo correspondence by integer ids depends on."""
    scene, i1, i2 = sf2.indep_scene(stereo, scene_seed=11)
    for img, gp in ((i1, scene.gp1), (i2, scene.gp2)):
        res = det(jnp.asarray(img))
        gt = _gt_map(gp)
        c = np.asarray(res.grid.center)
        assert np.hypot(*(c - gt[(0, 0)])) < 1.5


def test_steep_tilt_fence_trips(stereo, det):
    """The chaotic steep-diagonal regime must be FENCED on this family too:
    axis-aligned openings shred diagonal lines, so ok/stable must not
    report a healthy grid."""
    _, i1, _ = sf2.indep_scene(stereo, scene_seed=7, tilt=0.8)
    res = det(jnp.asarray(i1))
    assert not (bool(np.asarray(res.ok)) and bool(np.asarray(res.stable)))


def test_stereo_fit_on_indep_family(stereo):
    """Full detect -> correspond -> triangulate -> fit on the independent
    family: sub-degree axis recovery and sub-0.5 px reprojection, i.e. the
    geometry chain's accuracy does not depend on the native renderer's
    Gaussian line profile."""
    from cylinder_pose_estimation_tpu.config import (
        CylinderDetectConfig,
        FitConfig,
    )
    from cylinder_pose_estimation_tpu.models.pipeline import (
        estimate_pose_stereo,
    )

    cfg = CylinderDetectConfig(height=H, width=W)
    scene, i1, i2 = sf2.indep_scene(stereo, scene_seed=11)
    r = jax.jit(
        lambda a, b: estimate_pose_stereo(a, b, stereo, cfg, FitConfig())
    )(jnp.asarray(i1), jnp.asarray(i2))
    gt = np.asarray(scene.cyl_params)
    opt = np.asarray(r.fit.params)
    cosang = abs(
        np.dot(
            opt[3:] / np.linalg.norm(opt[3:]),
            gt[3:] / np.linalg.norm(gt[3:]),
        )
    )
    assert np.degrees(np.arccos(min(1.0, cosang))) < 0.5
    assert float(np.asarray(r.fit.mean_reproj_error)) < 0.5


@pytest.mark.slow
@pytest.mark.parametrize("seed,profile", [
    (0, "lorentz"), (2, "lorentz"), (4, "lorentz"), (6, "lorentz"),
    (8, "flattop"), (10, "flattop"), (12, "flattop"), (14, "lorentz"),
    (16, "flattop"), (18, "lorentz"),
])
def test_indep_family_sweep(stereo, det, seed, profile):
    """>= 10 scenes across both profiles, randomized pose / illumination /
    clutter: detection quality AND the fences on the intended side for every
    one (the r4 verdict's recalibration criterion)."""
    scene, i1, _ = sf2.indep_scene(stereo, scene_seed=seed, profile=profile)
    res = det(jnp.asarray(i1))
    det_pts, matched, inner = _score(res, scene.gp1)
    assert bool(np.asarray(res.ok)) and bool(np.asarray(res.stable)), seed
    assert len(det_pts) >= 30 and len(matched) / max(len(det_pts), 1) >= 0.8, (
        seed, len(det_pts), len(matched)
    )
    assert inner and np.mean(inner) < 1.0, (seed, np.mean(inner))


# ---------------------------------------------------------------------------
# plane mode on the independent family


def _plane_cfg():
    from cylinder_pose_estimation_tpu.config import PlaneDetectConfig

    return PlaneDetectConfig(height=H, width=W, roi_threshold=30.0)


@pytest.mark.parametrize("seed,profile", [(0, "lorentz"), (1, "flattop")])
def test_plane_indep_scene_detects(stereo, seed, profile):
    """Calibration-plane detection on the independent formation model: the
    full 9x9 grid recovered with sub-px mean error, fences on the healthy
    side (plane lines are straight, so the family's perspective thinning
    and illumination are the binding stressors here)."""
    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    scene, i1, _ = sf2.indep_plane_scene(stereo, scene_seed=seed, profile=profile)
    res = jax.jit(lambda im: detect_grid(im, _plane_cfg()))(jnp.asarray(i1))
    assert bool(np.asarray(res.ok)) and bool(np.asarray(res.stable))
    idx = np.asarray(res.grid.idx)
    xy = np.asarray(res.grid.xy)
    valid = np.asarray(res.grid.valid)
    det_pts = {
        (int(idx[i, 0]), int(idx[i, 1])): xy[i]
        for i in range(len(valid))
        if valid[i]
    }
    gxy = np.asarray(scene.gp1.xy)
    gidx = np.asarray(scene.gp1.idx)
    gval = np.asarray(scene.gp1.valid)
    gt = {
        (int(gidx[i, 0]), int(gidx[i, 1])): gxy[i]
        for i in range(len(gval))
        if gval[i]
    }
    errs = [
        float(np.hypot(*(p - gt[k]))) for k, p in det_pts.items() if k in gt
    ]
    matched = [e for e in errs if e < 2.5]
    assert len(det_pts) >= 75
    assert len(matched) >= 75
    assert np.mean(matched) < 0.8
