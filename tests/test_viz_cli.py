"""Visualization + CLI driver smoke tests (host-side, synthetic data)."""

import json
import os

import jax.numpy as jnp
import numpy as np

from cylinder_pose_estimation_tpu import cli
from cylinder_pose_estimation_tpu.utils import viz
from cylinder_pose_estimation_tpu.utils.io import save_stereo_json
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)


# Half-resolution canvas: the CLI derives the detect config from the image
# shape, so the driver plumbing is identical to full-res while each CPU
# detect costs ~4x less (full-res end-to-end coverage lives in
# test_detector.test_cylinder_detection_full_resolution, marked slow).
H, W = 240, 320


def _scene():
    # baseline 30 mm: the default 100 mm disparity (~170 px at this K/z)
    # pushes most of the right view's grid off the half-res canvas.
    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0, baseline=30.0)
    return stereo, cylinder_grid_points(
        stereo, capacity=128, origin=(0.0, -15.0, 560.0), radius=70.0,
        row_spacing=18.0, theta_span=2.0,
    )


def test_cylinder_mesh_points_on_surface():
    _, scene = _scene()
    xs, ys, zs = viz.cylinder_mesh(np.asarray(scene.cyl_params), scene.radius)
    pts = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    from cylinder_pose_estimation_tpu.geometry.cylinder import dist_points_to_line

    d = np.asarray(
        dist_points_to_line(
            jnp.asarray(pts, jnp.float32), scene.cyl_params[:3], scene.cyl_params[3:6]
        )
    )
    np.testing.assert_allclose(d, scene.radius, atol=1e-2)


def test_viz_figures_render(tmp_path):
    stereo, scene = _scene()
    p = str(tmp_path)
    viz.plot_reprojection_errors(
        np.full(32, 0.2), np.ones(32, bool), path=os.path.join(p, "re.png")
    )
    viz.visualize_cylinder_fitting(
        np.asarray(scene.pts3), np.asarray(scene.valid),
        np.asarray(scene.cyl_params), np.asarray(scene.cyl_params), scene.radius,
        path=os.path.join(p, "fit.png"),
    )
    viz.plot_fvals(np.asarray([[900.0, 60.0], [800.0, 50.0]]), path=os.path.join(p, "fv.png"))
    viz.plot_cylinders_3d([np.asarray(scene.cyl_params)], scene.radius, path=os.path.join(p, "c3.png"))
    img = render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W)
    viz.overlay_detection(np.asarray(img), scene.gp1, path=os.path.join(p, "ov.png"))
    for f in ("re.png", "fit.png", "fv.png", "c3.png", "ov.png"):
        assert os.path.getsize(os.path.join(p, f)) > 1000


def test_viz_aux_helpers_render(tmp_path):
    _, scene = _scene()
    p = str(tmp_path)
    pts3 = np.asarray(scene.pts3)[np.asarray(scene.valid)]
    cp = np.asarray(scene.cyl_params, np.float64)
    line = np.stack([cp[:3] - 50 * cp[3:6], cp[:3] + 50 * cp[3:6]])
    t = np.eye(4)
    t[:3, 3] = [10.0, -5.0, 3.0]
    fig = viz.plot_transformed_data(
        pts3, line, t, radius=scene.radius, path=os.path.join(p, "tr.png")
    )
    viz.visualize_3d_points(pts3, path=os.path.join(p, "p3.png"))
    for f in ("tr.png", "p3.png"):
        assert os.path.getsize(os.path.join(p, f)) > 1000
    fig2 = viz.plot_fvals(np.asarray([[900.0, 60.0]]))
    viz.figresize(fig2, (800, 500))
    assert tuple(np.round(fig2.get_size_inches() * fig2.dpi)) == (800, 500)

    xs = [np.zeros((2, 2)) + i for i in range(4)]
    info = viz.structure_cyl_info([2, 0], xs, xs, xs)
    assert len(info) == 2 and float(info[0]["X"][0, 0]) == 2.0
    assert viz.find_matching_idx(
        ["/a/b/10-20L.png", "/a/b/frameR.png", "c/00L.png"],
        {"10-20L", "00L"},
    ) == [0, 2]


def test_parse_img_info():
    assert cli.parse_img_info("10-20") == (10.0, -20.0)
    assert cli.parse_img_info("-15-5") == (-15.0, -5.0)
    assert cli.parse_img_info("00") == (0.0, 0.0)
    assert cli.parse_img_info("frame1") is None
    # Greedy-first-group ambiguity, documented + matching the reference:
    # unsigned multi-digit pairs split as (all-but-last, last).
    assert cli.parse_img_info("1010") == (101.0, 0.0)


def test_cli_detect_folder(tmp_path):
    stereo, scene = _scene()
    cam_json = str(tmp_path / "cameras.json")
    save_stereo_json(cam_json, stereo)
    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    for side, gp in (("L", scene.gp1), ("R", scene.gp2)):
        img = render_grid_image(gp.xy, gp.valid, 9, 9, H, W)
        cli.save_image(str(in_dir / f"00{side}.png"), np.asarray(img))
    cli.main([
        "detect-folder", "--camera-json", cam_json,
        "--input", str(in_dir), "--output", str(out_dir), "--mode", "cylinder",
    ])
    data = json.load(open(out_dir / "processed_images_data.json"))
    assert set(data) == {"00L.png", "00R.png"}
    for v in data.values():
        assert "points" in v and len(v["points"]) >= 10
    assert (out_dir / "00L_arc.png").exists()


def test_cli_experiment(tmp_path):
    stereo, _ = _scene()
    cam_json = str(tmp_path / "cameras.json")
    save_stereo_json(cam_json, stereo)
    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    # two frames at pan/tilt (0,0) and (5,-3) degrees; reuse the same scene
    # geometry per frame (kinematic consistency isn't asserted here -- the
    # smoke test checks the driver plumbing end to end).
    for name in ("00", "5-3"):
        scene = _scene()[1]
        for side, gp in (("L", scene.gp1), ("R", scene.gp2)):
            img = render_grid_image(gp.xy, gp.valid, 9, 9, H, W)
            cli.save_image(str(in_dir / f"{name}{side}.png"), np.asarray(img))
    cli.main([
        "experiment", "--camera-json", cam_json,
        "--input", str(in_dir), "--output", str(out_dir), "--radius", "70",
    ])
    assert (out_dir / "T_cam_agv.npy").exists()
    assert (out_dir / "fvals.png").exists()


def test_cli_detect_folder_batches_chunks(tmp_path, monkeypatch):
    """N same-shape images must execute in
    ceil(N/chunk) device calls through the batched runner, with per-image
    JSON identical to the unbatched contract."""
    stereo, scene = _scene()
    cam_json = str(tmp_path / "cameras.json")
    save_stereo_json(cam_json, stereo)
    in_dir = tmp_path / "in"
    out_dir = tmp_path / "out"
    in_dir.mkdir()
    n_imgs = 5
    for i in range(n_imgs):
        side = "L" if i % 2 == 0 else "R"
        gp = scene.gp1 if side == "L" else scene.gp2
        img = render_grid_image(gp.xy, gp.valid, 9, 9, H, W)
        cli.save_image(str(in_dir / f"{i:02d}{side}.png"), np.asarray(img))

    calls = []
    orig = cli._batched_detect_runner

    def counting(stereo_, cfg_):
        run = orig(stereo_, cfg_)

        def wrapped(imgs, is_left):
            calls.append(imgs.shape[0])
            return run(imgs, is_left)

        return wrapped

    monkeypatch.setattr(cli, "_batched_detect_runner", counting)
    cli.main([
        "detect-folder", "--camera-json", cam_json,
        "--input", str(in_dir), "--output", str(out_dir),
        "--mode", "cylinder", "--chunk", "2",
    ])
    # ceil(5/2) = 3 device calls, each padded to the chunk size
    assert calls == [2, 2, 2]
    data = json.load(open(out_dir / "processed_images_data.json"))
    assert len(data) == n_imgs
    for f, v in data.items():
        assert "points" in v and len(v["points"]) >= 10, (f, v)
        assert (out_dir / (os.path.splitext(f)[0] + "_arc.png")).exists()
