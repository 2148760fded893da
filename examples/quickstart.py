"""Runnable tour of the framework's public API (CPU-friendly).

Covers the reference's full capability surface in one script
(ref exp_gridDetection.m + python_grid_detection_cylinder.py):

  1. camera / grid-point JSON contracts (ref utils/iotool.py,
     utils/createCameraDataJSON.m, make_json utils/util_cylinder.py:1674),
  2. stereo grid-point fit -> cylinder pose (ref utils/fitSingleCylinder.m),
  3. image-domain grid detection on a rendered synthetic scene
     (ref detect_grid python_grid_detection_cylinder.py:68-112),
  4. multi-frame pan/tilt camera<->AGV registration
     (ref utils/fitCylinderWPts3sAngs.m).

Run:  python examples/quickstart.py        (from the repo root)
"""

import os
import tempfile

import jax

# Host-CPU demo; drop this line to run on the GPU.
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig
from cylinder_pose_estimation_tpu.geometry import transforms as tf
from cylinder_pose_estimation_tpu.geometry.kinematics import t_agv_cyl
from cylinder_pose_estimation_tpu.geometry.registration import (
    fit_cylinders_with_angles,
)
from cylinder_pose_estimation_tpu.models import pose
from cylinder_pose_estimation_tpu.models.detector import detect_grid
from cylinder_pose_estimation_tpu.utils import io as cio
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)


def main() -> None:
    # --- 1. camera JSON contract (reference schema) ------------------------
    stereo = default_stereo()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cameras.json")
        cio.save_stereo_json(path, stereo)
        stereo = cio.load_stereo_json(path)
    print("loaded stereo rig, K1 diag:", np.diag(np.asarray(stereo.cam1.k)))

    # --- 2. stereo grid points -> cylinder pose ----------------------------
    scene = cylinder_grid_points(stereo, noise_px=0.2, seed=0)
    fit = jax.jit(
        lambda a, b: pose.fit_single_cylinder(a, b, stereo, FitConfig())
    )(scene.gp1, scene.gp2)
    axis_gt = np.asarray(scene.cyl_params[3:6])
    axis = np.array(fit.params[3:6])
    axis /= np.linalg.norm(axis)
    print(
        f"cylinder fit: axis error "
        f"{np.degrees(np.arccos(np.clip(abs(axis_gt @ axis), 0, 1))):.3f} deg, "
        f"mean reproj {float(fit.mean_reproj_error):.3f} px, "
        f"rms(dist-R) {float(jnp.sqrt(fit.fvals[0])):.3f} -> "
        f"{float(jnp.sqrt(fit.fvals[1])):.3f} mm"
    )

    # grid-point JSON round trip (the detect->geometry handoff contract)
    js = cio.grid_points_to_json(scene.gp1)
    gp = cio.grid_points_from_json(js, capacity=scene.gp1.xy.shape[0])
    print("grid JSON roundtrip:", int(gp.valid.sum()), "points")

    # --- 3. image-domain detection on a rendered scene ---------------------
    h, w = 240, 320
    st = default_stereo(cx=w / 2.0, cy=h / 2.0)
    sc = cylinder_grid_points(
        st, capacity=128, n_rows=9, n_cols=9,
        origin=(0.0, -15.0, 560.0), radius=52.0, row_spacing=12.0,
        theta_span=2.2,
    )
    img = render_grid_image(sc.gp1.xy, sc.gp1.valid, 9, 9, h, w)
    cfg = CylinderDetectConfig(height=h, width=w)
    res = jax.jit(lambda im: detect_grid(im, cfg))(img)
    print(
        "detect_grid:", int(res.grid.valid.sum()),
        "grid points, ok =", bool(res.ok),
    )

    # --- 4. multi-frame pan/tilt AGV registration --------------------------
    gt_pose = jnp.asarray([0.2, -1.6, 0.15, 120.0, -40.0, 900.0], jnp.float32)
    t_gt = tf.vec_to_transform(gt_pose)
    angles = np.asarray(
        [[-0.3, 0.1], [0.0, 0.0], [0.35, -0.12], [0.6, 0.2]], np.float32
    )
    t_acs = np.asarray(t_gt) @ np.asarray(t_agv_cyl(angles[:, 0], angles[:, 1]))
    rng = np.random.default_rng(2)
    frames, valids = [], []
    for f in range(len(angles)):
        org, x, y, z = (
            t_acs[f, :3, 3], t_acs[f, :3, 0], t_acs[f, :3, 1], t_acs[f, :3, 2]
        )
        hs = (np.arange(8) - 4) * 13.0
        phi = np.arctan2(-x[2], -z[2])
        thetas = phi + np.linspace(-0.7, 0.7, 9)
        pts = np.asarray(
            [org + hh * y + 45.0 * (np.cos(t) * z + np.sin(t) * x)
             for hh in hs for t in thetas],
            np.float32,
        ) + rng.normal(0, 0.1, (72, 3)).astype(np.float32)
        buf = np.zeros((128, 3), np.float32)
        buf[: len(pts)] = pts
        val = np.zeros(128, bool)
        val[: len(pts)] = True
        frames.append(buf)
        valids.append(val)
    reg = fit_cylinders_with_angles(
        jnp.asarray(np.stack(frames)),
        jnp.asarray(np.stack(valids)),
        jnp.asarray(angles),
    )
    t_err = np.linalg.norm(
        np.asarray(reg.t_cam_agv)[:3, 3] - np.asarray(t_gt)[:3, 3]
    )
    print(f"registration: translation error {t_err:.4f} mm")


if __name__ == "__main__":
    main()
