"""Streaming pose-serving example: long sequences with bounded device memory.

The 10k-frame configuration (BASELINE.md config 5; the reference's serial
per-image loop in python_grid_detection_cylinder.py:32) as a deployment
recipe: frames arrive as a (N, H, W) uint8 source too large for HBM, and
``estimate_poses_stream`` pushes fixed-size chunks through ONE compiled
detect→fit step with a three-deep pipeline — an uploader thread stages chunk
k+1's H2D while chunk k computes and chunk k-1's results materialize — and
``compact=True`` reduces each chunk on device to a ~200 B/frame
StreamPoseSummary before readback.

Run:  python examples/streaming_serving.py      (from the repo root)
"""

import time

import jax

# Host-CPU demo; drop this line to run on the GPU.
jax.config.update("jax_platforms", "cpu")

import numpy as np

from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig
from cylinder_pose_estimation_tpu.models.pipeline import estimate_poses_stream
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)

H, W = 192, 256
N_FRAMES = 12
CHUNK = 4

# --- a synthetic "camera feed": unique scenes rendered to uint8 frames ----
# (geometry mirrors tests/test_parallel._frames: the cylinder stays fully
# visible in both miniature views, so every frame detects)
stereo = default_stereo(cx=W / 2.0, cy=H / 2.0, baseline=30.0)
render = jax.jit(render_grid_image, static_argnums=(2, 3, 4, 5))
frames1, frames2 = [], []
rng = np.random.default_rng(0)
for k in range(N_FRAMES):
    scene = cylinder_grid_points(
        stereo, origin=(3.0 * (k % 5) - 6.0, -8.0, 360.0), radius=55.0,
        row_spacing=7.0, theta_span=1.1, capacity=128, seed=k,
    )
    for gp, out in ((scene.gp1, frames1), (scene.gp2, frames2)):
        img = np.asarray(render(gp.xy, gp.valid, 9, 9, H, W), np.float32)
        img += rng.normal(0, 2.0, (H, W)).astype(np.float32)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
imgs1 = np.stack(frames1)
imgs2 = np.stack(frames2)
print(f"feed: {N_FRAMES} stereo frames, {imgs1.nbytes * 2 / 1e6:.1f} MB uint8")

# --- stream them through the compiled step ---------------------------------
cfg = CylinderDetectConfig(height=H, width=W, cc_iters=8, min_ok_points=5)
fit_cfg = FitConfig(cyl_radius=55.0)

t0 = time.perf_counter()
summary = estimate_poses_stream(
    imgs1, imgs2, stereo, cfg, fit_cfg,
    chunk=CHUNK, compact=True, overlap=True,
)
dt = time.perf_counter() - t0

ok = np.asarray(summary.ok)
healthy = np.asarray(summary.healthy)
err = np.asarray(summary.mean_reproj_error)
print(f"streamed {N_FRAMES} frames in {dt:.1f} s "
      f"(first call includes compile; steady state reuses the cached step)")
print(f"ok {int(ok.sum())}/{N_FRAMES}, healthy {int(healthy.sum())}, "
      f"median reproj {np.median(err[ok]):.3f} px")
for i in range(N_FRAMES):
    org = np.asarray(summary.params)[i, :3]
    print(f"  frame {i:2d}: ok={bool(ok[i])!s:5} "
          f"origin=({org[0]:7.1f}, {org[1]:7.1f}, {org[2]:7.1f}) mm "
          f"reproj={err[i]:.3f} px")

# A second stream over new frames reuses the compiled step (no re-trace):
t0 = time.perf_counter()
estimate_poses_stream(
    imgs1[:CHUNK], imgs2[:CHUNK], stereo, cfg, fit_cfg,
    chunk=CHUNK, compact=True, overlap=True,
)
print(f"warm re-invocation: {time.perf_counter() - t0:.2f} s")
