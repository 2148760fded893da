"""Command-line drivers mirroring the reference's entry points.

  detect-folder  -- the python_grid_detection_{cylinder,plane}.py batch driver
                    (ref python_grid_detection_cylinder.py:12-64): walk an
                    image folder, undistort by 'L'/'R' in the filename, run
                    grid detection, write "<name>_arc.png" overlays and an
                    aggregate processed_images_data.json.  Same-shape frames
                    run as chunked BATCHED jitted programs (ceil(N/chunk)
                    device calls) instead of the reference's serial loop.
  experiment     -- the exp_gridDetection.m pipeline (ref exp_gridDetection.m):
                    enumerate stereo basenames, parse pan/tilt angles from
                    filenames, detect + fit per frame, then multi-frame
                    camera<->AGV registration; prints the reference's
                    per-image "average error = a -> b mm" lines
                    (ref utils/fitSingleCylinder.m:28).

Image I/O is host-side PIL (the optional ``images`` extra); everything
numeric is the jitted pipeline.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import List, Optional, Tuple

import numpy as np


def _progress(it, desc: str):
    """tqdm when present (the reference uses tqdm / a vendored MATLAB
    ProgressBar: ref python_grid_detection_cylinder.py:32,
    utils/ProgressBar.m); plain passthrough otherwise."""
    try:
        from tqdm import tqdm

        return tqdm(it, desc=desc)
    except ImportError:  # pragma: no cover
        return it


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit(
            "image I/O needs Pillow, which is not installed: "
            "pip install 'cylinder-pose-estimation-tpu[images]'"
        ) from e
    return Image


def load_image(path: str) -> np.ndarray:
    Image = _pil_image()
    return np.asarray(Image.open(path).convert("L"), np.float32)


def save_image(path: str, arr: np.ndarray) -> None:
    Image = _pil_image()
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path)


def parse_img_info(name: str) -> Optional[Tuple[float, float]]:
    """Parse '<pan><tilt>' degree pairs from a basename
    (ref utils/parseImgInfo.m:16-30, regex ^(-?\\d+)(-?\\d+)$).

    The regex is inherently ambiguous for unsigned multi-digit pans: the
    first group is greedy, so '1010' parses as (101, 0), not (10, 10).
    This matches the reference's behavior exactly; its datasets only use
    signed or single-digit-tilt names ('10-20', '-15-5') where the split
    is unambiguous."""
    m = re.match(r"^(-?\d+)(-?\d+)$", name)
    if not m:
        return None
    return float(m.group(1)), float(m.group(2))


def unique_basenames(folder: str) -> List[str]:
    """Basenames of '*L.png' images (ref utils/getUniqueName.m:1-21)."""
    names = []
    for f in sorted(os.listdir(folder)):
        if f.endswith("L.png"):
            names.append(f[:-5])
    return names


def _batched_detect_runner(stereo, cfg):
    """One jitted chunk program: vmapped undistort + detect over a frame
    axis.  Module-level so tests can count device calls by wrapping it."""
    import jax
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.models.detector import detect_grid
    from cylinder_pose_estimation_tpu.ops.remap import undistort_image

    @jax.jit
    def run(imgs, is_left):
        def one(img, il):
            cam = jax.tree.map(
                lambda a, b: jnp.where(il, a, b), stereo.cam1, stereo.cam2
            )
            und = undistort_image(img, cam)
            return detect_grid(und, cfg), und

        return jax.vmap(one)(imgs, is_left)

    return run


def cmd_detect_folder(args) -> None:
    """Batch detection: frames run as chunked BATCHED jitted programs --
    N same-shape images execute in ceil(N/chunk) device calls (the final
    chunk is padded to the chunk size so every call hits the same compiled
    executable), beating the reference's serial per-image loop
    (ref python_grid_detection_cylinder.py:32).  Host-side I/O failures stay
    per-image isolated (ref plane driver :58-62); a device failure falls
    back to marking the whole chunk."""
    import jax

    from cylinder_pose_estimation_tpu.config import (
        CylinderDetectConfig,
        PlaneDetectConfig,
    )
    from cylinder_pose_estimation_tpu.utils.io import (
        grid_points_to_json,
        load_stereo_json,
    )
    from cylinder_pose_estimation_tpu.utils.viz import overlay_detection

    stereo = load_stereo_json(args.camera_json)
    files = [
        f
        for f in sorted(os.listdir(args.input))
        if f.lower().endswith((".png", ".jpg", ".bmp"))
    ]
    if not files:
        print("no images found")
        return
    os.makedirs(args.output, exist_ok=True)
    chunk = max(1, int(getattr(args, "chunk", 16)))

    results = {}
    # Load host-side with per-image isolation, group by image shape (one
    # compiled program per distinct shape).
    groups: dict = {}
    for f in files:
        try:
            img = load_image(os.path.join(args.input, f))
        except Exception as e:
            results[f] = {"error": str(e)}
            continue
        groups.setdefault(img.shape, []).append((f, img))

    cfg_cls = CylinderDetectConfig if args.mode == "cylinder" else PlaneDetectConfig
    for (h, w), items in groups.items():
        cfg = cfg_cls(height=h, width=w)
        run = _batched_detect_runner(stereo, cfg)
        for start in _progress(
            range(0, len(items), chunk), f"detect {h}x{w}"
        ):
            part = items[start : start + chunk]
            n = len(part)
            imgs = np.stack(
                [im for _, im in part]
                + [np.zeros((h, w), np.float32)] * (chunk - n)
            )
            # 'L'/'R' in filename selects the camera (ref :36-41)
            is_left = np.asarray(
                ["L" in os.path.splitext(f)[0] for f, _ in part]
                + [True] * (chunk - n)
            )
            try:
                res, und = run(imgs, is_left)
                grids = jax.tree.map(np.asarray, res.grid)
                und = np.asarray(und)
            except Exception as e:  # device-level failure: mark the chunk
                for f, _ in part:
                    results[f] = {"error": str(e)}
                continue
            for i, (f, _) in enumerate(part):
                try:
                    gp = jax.tree.map(lambda x: x[i], grids)
                    results[f] = json.loads(grid_points_to_json(gp))
                    base = os.path.splitext(f)[0]
                    overlay_detection(
                        und[i], gp,
                        path=os.path.join(args.output, base + "_arc.png"),
                    )
                except Exception as e:
                    results[f] = {"error": str(e)}
    out_json = os.path.join(args.output, "processed_images_data.json")
    with open(out_json, "w") as fp:
        json.dump(results, fp, indent=2)
    print("wrote", out_json)


def cmd_experiment(args) -> None:
    import jax
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.config import (
        CylinderDetectConfig,
        FitConfig,
        RegistrationConfig,
    )
    from cylinder_pose_estimation_tpu.models.pipeline import (
        estimate_poses_batch,
        preprocess_stereo_batch,
        register_sequence,
    )
    from cylinder_pose_estimation_tpu.ops.remap import undistort_image
    from cylinder_pose_estimation_tpu.utils.io import load_stereo_json
    from cylinder_pose_estimation_tpu.utils.viz import plot_fvals

    stereo = load_stereo_json(args.camera_json)
    names = unique_basenames(args.input)
    if len(names) < 2:
        print("need >= 2 stereo pairs")
        return
    angles = []
    imgs1, imgs2 = [], []
    used_names = []
    for n in names:
        info = parse_img_info(n)
        if info is None:
            continue
        imgs1.append(load_image(os.path.join(args.input, n + "L.png")))
        imgs2.append(load_image(os.path.join(args.input, n + "R.png")))
        angles.append([np.deg2rad(info[0]), np.deg2rad(info[1])])
        used_names.append(n)
    h, w = imgs1[0].shape
    cfg = CylinderDetectConfig(height=h, width=w)
    fit_cfg = FitConfig(cyl_radius=args.radius)
    reg_cfg = RegistrationConfig(cyl_radius=args.radius)

    @jax.jit
    def run(a, b, angs):
        if args.no_clahe:
            # undistort-only (skip the reference's adapthisteq equalization)
            a = jax.vmap(lambda x: undistort_image(x, stereo.cam1))(a)
            b = jax.vmap(lambda x: undistort_image(x, stereo.cam2))(b)
        else:
            # full stereo preprocessing (ref utils/preProcessing.m:4-21):
            # undistort + adaptive histogram equalization, both views
            a, b = preprocess_stereo_batch(a, b, stereo)
        batch = estimate_poses_batch(a, b, stereo, cfg, fit_cfg)
        reg = register_sequence(batch, angs, reg_cfg)
        return batch, reg

    batch, reg = run(
        jnp.asarray(np.stack(imgs1)),
        jnp.asarray(np.stack(imgs2)),
        jnp.asarray(np.asarray(angles, np.float32)),
    )
    fvals = np.asarray(batch.fit.fvals)
    for i, n in enumerate(used_names):
        # ref utils/fitSingleCylinder.m:28 print format
        print(
            f"{i + 1}-th image [{n}]: average error = "
            f"{np.sqrt(fvals[i, 0]):.6g} -> {np.sqrt(fvals[i, 1]):.6g} mm"
        )
    print(f"registration fval: {float(reg.fval0):.6g} -> {float(reg.fval):.6g}")
    print("T_Cam_AGV =\n", np.asarray(reg.t_cam_agv))
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        plot_fvals(fvals, os.path.join(args.output, "fvals.png"))
        np.save(os.path.join(args.output, "T_cam_agv.npy"), np.asarray(reg.t_cam_agv))
        print("wrote", args.output)


def cmd_undistort_folder(args) -> None:
    """Standalone folder undistorter (ref utils/iotool.py:41-72
    process_images_in_folder): undistort every image by the camera picked
    from the 'L'/'R' filename convention and write '<name>_undistorted.png'."""
    import jax
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.ops.remap import undistort_image
    from cylinder_pose_estimation_tpu.utils.io import load_stereo_json

    stereo = load_stereo_json(args.camera_json)
    os.makedirs(args.output, exist_ok=True)
    files = [
        f
        for f in sorted(os.listdir(args.input))
        if f.lower().endswith((".png", ".jpg", ".bmp"))
    ]

    und = {
        True: jax.jit(lambda x: undistort_image(x, stereo.cam1)),
        False: jax.jit(lambda x: undistort_image(x, stereo.cam2)),
    }
    for f in _progress(files, "undistort"):
        img = load_image(os.path.join(args.input, f))
        is_left = "L" in os.path.splitext(f)[0]
        out = np.asarray(und[is_left](jnp.asarray(img)))
        base = os.path.splitext(f)[0]
        save_image(os.path.join(args.output, base + "_undistorted.png"), out)
    print("wrote", len(files), "images to", args.output)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="cylpose", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    u = sub.add_parser("undistort-folder", help="undistort a folder of images")
    u.add_argument("--camera-json", required=True)
    u.add_argument("--input", required=True)
    u.add_argument("--output", required=True)
    u.set_defaults(fn=cmd_undistort_folder)

    d = sub.add_parser("detect-folder", help="batch grid detection over a folder")
    d.add_argument("--camera-json", required=True)
    d.add_argument("--input", required=True)
    d.add_argument("--output", required=True)
    d.add_argument("--mode", choices=["cylinder", "plane"], default="cylinder")
    d.add_argument(
        "--chunk", type=int, default=16,
        help="frames per batched device call (padded to a fixed shape)",
    )
    d.set_defaults(fn=cmd_detect_folder)

    e = sub.add_parser("experiment", help="full stereo pose + AGV registration")
    e.add_argument("--camera-json", required=True)
    e.add_argument("--input", required=True)
    e.add_argument("--output", default=None)
    e.add_argument("--radius", type=float, default=45.0)
    e.add_argument(
        "--no-clahe",
        action="store_true",
        help="skip adaptive histogram equalization (ref preProcessing.m does it)",
    )
    e.set_defaults(fn=cmd_experiment)

    args = p.parse_args(argv)
    # Persist compiled executables across CLI invocations: the chunked
    # detect program takes minutes to compile cold, and every repeat run
    # with the same image shape is then instant.
    from cylinder_pose_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
