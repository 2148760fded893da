"""Multi-frame camera<->AGV registration test (ref utils/fitCylinderWPts3sAngs.m).

Ground truth construction: pick a T_Cam_AGV, compute each frame's cylinder
pose from the kinematics, synthesize surface points on each predicted
cylinder, and verify the solver recovers the transform.
"""

import jax.numpy as jnp
import numpy as np

from cylinder_pose_estimation_tpu.config import RegistrationConfig
from cylinder_pose_estimation_tpu.geometry import transforms as tf
from cylinder_pose_estimation_tpu.geometry.kinematics import t_agv_cyl
from cylinder_pose_estimation_tpu.geometry.registration import (
    fit_cylinders_with_angles,
    predicted_cylinder_poses,
    registration_residuals,
)


def _make_frames(t_cam_agv, angles, radius=45.0, n_rows=8, n_cols=9, capacity=128, seed=0):
    rng = np.random.default_rng(seed)
    t_agv_cyls = np.asarray(t_agv_cyl(angles[:, 0], angles[:, 1]))
    t_cam_cyls = np.asarray(t_cam_agv) @ t_agv_cyls
    frames = []
    valids = []
    for f in range(len(angles)):
        org = t_cam_cyls[f, :3, 3]
        x, y, z = t_cam_cyls[f, :3, 0], t_cam_cyls[f, :3, 1], t_cam_cyls[f, :3, 2]
        hs = (np.arange(n_rows) - n_rows // 2) * 13.0
        # camera-facing half: thetas around the direction closest to -z_cam
        phi = np.arctan2(-x[2], -z[2])
        thetas = phi + np.linspace(-0.7, 0.7, n_cols)
        pts = []
        for hh in hs:
            for th in thetas:
                pts.append(org + hh * y + radius * (np.cos(th) * z + np.sin(th) * x))
        pts = np.asarray(pts, np.float32)
        n = pts.shape[0]
        buf = np.zeros((capacity, 3), np.float32)
        buf[:n] = pts
        val = np.zeros(capacity, bool)
        val[:n] = True
        frames.append(buf)
        valids.append(val)
    return jnp.asarray(np.stack(frames)), jnp.asarray(np.stack(valids))


def test_registration_recovers_transform():
    gt_pose = jnp.asarray([0.2, -1.6, 0.15, 120.0, -40.0, 900.0], jnp.float32)
    t_gt = tf.vec_to_transform(gt_pose)
    angles = jnp.asarray(
        [[-0.3, 0.1], [0.0, 0.0], [0.35, -0.12], [0.6, 0.2]], jnp.float32
    )
    pts3s, valid = _make_frames(t_gt, np.asarray(angles))
    res = fit_cylinders_with_angles(pts3s, valid, angles)
    assert float(res.fval) < 1e-3
    assert float(res.fval) <= float(res.fval0) + 1e-6
    # Compare predicted cylinder axes under both transforms.
    pred_gt = np.asarray(predicted_cylinder_poses(t_gt, angles))
    pred = np.asarray(predicted_cylinder_poses(res.t_cam_agv, angles))
    for f in range(angles.shape[0]):
        # axis direction
        c = abs(float(pred[f, :3, 1] @ pred_gt[f, :3, 1]))
        assert np.degrees(np.arccos(min(c, 1.0))) < 0.1
        # origin within mm of the true axis (origin may slide along axis)
        rel = pred[f, :3, 3] - pred_gt[f, :3, 3]
        perp = rel - (rel @ pred_gt[f, :3, 1]) * pred_gt[f, :3, 1]
        assert np.linalg.norm(perp) < 0.5


def test_residuals_zero_at_ground_truth():
    gt_pose = jnp.asarray([0.0, -1.5, 0.1, 100.0, -30.0, 850.0], jnp.float32)
    t_gt = tf.vec_to_transform(gt_pose)
    angles = jnp.asarray([[-0.2, 0.05], [0.25, -0.1]], jnp.float32)
    pts3s, valid = _make_frames(t_gt, np.asarray(angles), seed=3)
    t_agv_cyls = t_agv_cyl(angles[:, 0], angles[:, 1])
    r = registration_residuals(gt_pose, t_agv_cyls, pts3s, valid, 45.0)
    assert float(jnp.max(jnp.abs(r))) < 1e-3


def test_registration_with_noise():
    gt_pose = jnp.asarray([0.1, -1.4, 0.05, 80.0, -20.0, 800.0], jnp.float32)
    t_gt = tf.vec_to_transform(gt_pose)
    angles = jnp.asarray([[-0.3, 0.0], [0.1, 0.1], [0.5, -0.15]], jnp.float32)
    pts3s, valid = _make_frames(t_gt, np.asarray(angles), seed=4)
    rng = np.random.default_rng(7)
    noisy = pts3s + jnp.asarray(rng.normal(0, 0.3, pts3s.shape), jnp.float32)
    res = fit_cylinders_with_angles(noisy, valid, angles)
    # Residual floor set by the 0.3 mm point noise.
    assert float(res.fval) < 3 * 0.3**2 * angles.shape[0]


def test_registration_masks_poisoned_frame():
    """A frame full of garbage points must not poison the solve when masked
    via frame_valid (models/pipeline.frame_health supplies the mask in the
    pipeline; here the mechanism is exercised directly).  The first frame is
    the poisoned one, so the init must also skip to the first valid frames."""
    gt_pose = jnp.asarray([0.15, -1.5, 0.1, 90.0, -25.0, 820.0], jnp.float32)
    t_gt = tf.vec_to_transform(gt_pose)
    angles = jnp.asarray(
        [[-0.25, 0.05], [0.0, 0.0], [0.3, -0.1], [0.55, 0.15]], jnp.float32
    )
    pts3s, valid = _make_frames(t_gt, np.asarray(angles), seed=5)
    rng = np.random.default_rng(11)
    garbage = jnp.asarray(
        rng.uniform(-1e4, 1e4, pts3s.shape[1:]).astype(np.float32)
    )
    poisoned = pts3s.at[0].set(garbage)
    frame_valid = jnp.asarray([False, True, True, True])
    res = fit_cylinders_with_angles(
        poisoned, valid, angles, frame_valid=frame_valid
    )
    assert float(res.fval) < 1e-3
    pred_gt = np.asarray(predicted_cylinder_poses(t_gt, angles))
    pred = np.asarray(predicted_cylinder_poses(res.t_cam_agv, angles))
    for f in range(1, angles.shape[0]):
        c = abs(float(pred[f, :3, 1] @ pred_gt[f, :3, 1]))
        assert np.degrees(np.arccos(min(c, 1.0))) < 0.1


def test_registration_frame_mask_fallback_under_two_valid():
    """With < 2 valid frames the mask is ignored (degraded fallback): the
    solve still runs over all frames instead of going singular."""
    gt_pose = jnp.asarray([0.0, -1.5, 0.1, 100.0, -30.0, 850.0], jnp.float32)
    t_gt = tf.vec_to_transform(gt_pose)
    angles = jnp.asarray([[-0.2, 0.05], [0.25, -0.1]], jnp.float32)
    pts3s, valid = _make_frames(t_gt, np.asarray(angles), seed=6)
    frame_valid = jnp.asarray([False, True])
    res = fit_cylinders_with_angles(
        pts3s, valid, angles, frame_valid=frame_valid
    )
    assert float(res.fval) < 1e-3


def test_observability_flag_narrow_vs_wide_swing():
    """RegistrationResult.well_posed: a narrow pan/tilt
    swing leaves t_cam_agv's along-axis translation gauge-flat -- the flag
    must fire there and NOT on a well-spread sweep."""
    gt_pose = jnp.asarray([0.1, -0.9, 0.05, 60.0, -30.0, 700.0], jnp.float32)
    t_gt = tf.vec_to_transform(gt_pose)

    wide = np.stack(
        [np.linspace(-0.5, 0.5, 6), np.linspace(0.15, -0.15, 6)], axis=-1
    ).astype(np.float32)
    narrow = np.stack(
        [np.linspace(-0.05, 0.05, 6), np.linspace(0.015, -0.015, 6)], axis=-1
    ).astype(np.float32)

    pts_w, val_w = _make_frames(t_gt, wide, seed=1)
    pts_n, val_n = _make_frames(t_gt, narrow, seed=2)
    res_w = fit_cylinders_with_angles(pts_w, val_w, jnp.asarray(wide))
    res_n = fit_cylinders_with_angles(pts_n, val_n, jnp.asarray(narrow))

    assert bool(res_w.well_posed), float(res_w.jtj_min_eig)
    assert not bool(res_n.well_posed), float(res_n.jtj_min_eig)
    # the diagnostic separates by an order of magnitude, not a knife edge
    assert float(res_w.jtj_min_eig) > 3.0 * float(res_n.jtj_min_eig)


def test_observability_is_scale_free():
    """jtj_min_eig must mean the same thing at any
    geometric scale (units, robot size, working distance).  Rebuild the
    wide and narrow scenes with EVERYTHING x2 -- kinematic link lengths,
    cylinder radius, grid extent, camera offset -- and require the
    eigenvalues (hence well_posed at the shipped threshold) unchanged."""
    import dataclasses

    from cylinder_pose_estimation_tpu.config import KinematicsConfig
    from cylinder_pose_estimation_tpu.geometry.kinematics import t_agv_cyl

    gt_pose = jnp.asarray([0.1, -0.9, 0.05, 60.0, -30.0, 700.0], jnp.float32)
    wide = np.stack(
        [np.linspace(-0.5, 0.5, 6), np.linspace(0.15, -0.15, 6)], axis=-1
    ).astype(np.float32)
    narrow = np.stack(
        [np.linspace(-0.05, 0.05, 6), np.linspace(0.015, -0.015, 6)], axis=-1
    ).astype(np.float32)

    def run(scale, angs):
        kin = KinematicsConfig()
        kin = dataclasses.replace(
            kin,
            **{
                f.name: getattr(kin, f.name) * scale
                for f in dataclasses.fields(kin)
                if isinstance(getattr(kin, f.name), float)
            },
        )
        cfg = RegistrationConfig(cyl_radius=45.0 * scale, kinematics=kin)
        t_gt = np.asarray(tf.vec_to_transform(gt_pose.at[3:].multiply(scale)))
        kins = np.asarray(t_agv_cyl(jnp.asarray(angs)[:, 0], jnp.asarray(angs)[:, 1], kin))
        t_cam_cyls = t_gt @ kins
        frames, valids = [], []
        for f in range(len(angs)):
            org = t_cam_cyls[f, :3, 3]
            x, y, z = t_cam_cyls[f, :3, 0], t_cam_cyls[f, :3, 1], t_cam_cyls[f, :3, 2]
            hs = (np.arange(8) - 4) * 13.0 * scale
            phi = np.arctan2(-x[2], -z[2])
            thetas = phi + np.linspace(-0.7, 0.7, 9)
            pts = [
                org + hh * y + 45.0 * scale * (np.cos(th) * z + np.sin(th) * x)
                for hh in hs
                for th in thetas
            ]
            buf = np.zeros((128, 3), np.float32)
            buf[:72] = np.asarray(pts, np.float32)
            val = np.zeros(128, bool)
            val[:72] = True
            frames.append(buf)
            valids.append(val)
        return fit_cylinders_with_angles(
            jnp.asarray(np.stack(frames)), jnp.asarray(np.stack(valids)),
            jnp.asarray(angs), cfg,
        )

    for angs, expect in ((wide, True), (narrow, False)):
        e1 = float(run(1.0, angs).jtj_min_eig)
        e2 = float(run(2.0, angs).jtj_min_eig)
        np.testing.assert_allclose(e1, e2, rtol=0.05)
        # sub-unit lever arms (the same scene expressed in meters: scale
        # 1/1000 -> RMS radius ~ 0.1) must normalize identically -- the old
        # max(lever, 1.0) clamp silently disabled the invariance there
        e3 = float(run(1.0 / 1000.0, angs).jtj_min_eig)
        # 8%: three decades of scale in f32 costs a little conditioning
        np.testing.assert_allclose(e1, e3, rtol=0.08)
        assert bool(run(1.0, angs).well_posed) is expect
        assert bool(run(2.0, angs).well_posed) is expect
        assert bool(run(1.0 / 1000.0, angs).well_posed) is expect
