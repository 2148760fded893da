"""Detection front-end on rendered synthetic laser-grid images.

Ground truth comes from utils/synthetic: known cylinder pose -> projected grid
-> rendered image.  The detector must recover the grid points (pixel accuracy)
and their center-relative integer indices (exactly), mirroring SURVEY.md §4's
golden-strategy: synthesize from the geometry the reference itself defines.

Most tests run at 240x320 (CPU-friendly; every code path is resolution
independent); one full-resolution 480x640 end-to-end test is marked `slow`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, PlaneDetectConfig
from tests._util import run_detect as detect_grid
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    plane_grid_points,
    render_grid_image,
)

H, W = 240, 320
N_ROWS = N_COLS = 9


def _cylinder_image(noise=2.0, seed=0, saturate=False, h=H, w=W):
    stereo = default_stereo(cx=w / 2.0, cy=h / 2.0)
    scale = h / 240.0  # scene fills the same frame fraction at any res
    scene = cylinder_grid_points(
        stereo, capacity=128, n_rows=N_ROWS, n_cols=N_COLS,
        origin=(0.0, -15.0 * scale, 560.0), radius=52.0 * scale,
        row_spacing=12.0 * scale, theta_span=2.2,
    )
    img = render_grid_image(
        scene.gp1.xy, scene.gp1.valid, N_ROWS, N_COLS, h, w,
        saturate_center=saturate,
    )
    if noise > 0:
        rng = np.random.default_rng(seed)
        img = jnp.clip(
            img.astype(jnp.float32) + jnp.asarray(rng.normal(0, noise, (h, w)), jnp.float32),
            0, 255,
        )
    return scene, img


def _gt_map(gp, n):
    """(x_index, y_index) -> (x, y) for the first n GT points."""
    idx = np.asarray(gp.idx)[:n]
    xy = np.asarray(gp.xy)[:n]
    return {tuple(idx[i]): xy[i] for i in range(n)}


def _check_detection(scene, res, min_points):
    det_idx = np.asarray(res.grid.idx)
    det_xy = np.asarray(res.grid.xy)
    det_valid = np.asarray(res.grid.valid)
    gt = _gt_map(scene.gp1, N_ROWS * N_COLS)

    n_det = det_valid.sum()
    assert n_det >= min_points

    matched = 0
    errs = []
    for i in range(len(det_valid)):
        if not det_valid[i]:
            continue
        key = tuple(det_idx[i])
        assert key in gt, f"detected id {key} not in ground truth"
        errs.append(np.linalg.norm(det_xy[i] - gt[key]))
        matched += 1
    errs = np.asarray(errs)
    assert matched == n_det
    assert np.median(errs) < 1.5, f"median err {np.median(errs)}"
    assert errs.max() < 4.0, f"max err {errs.max()}"


def test_cylinder_detection_recovers_grid():
    scene, img = _cylinder_image()
    cfg = CylinderDetectConfig(height=H, width=W)
    res = detect_grid(img, cfg)
    assert bool(res.ok)
    # cylinder path drops first row, last col and negative cols: 9x9 grid,
    # center (4,4) -> >= 8 rows x 4 cols survive.
    _check_detection(scene, res, min_points=20)


@pytest.mark.slow
def test_cylinder_detection_full_resolution():
    """Full 480x640 end-to-end (the round-1 default size, kept as the one
    full-res regression; everything else runs at 240x320 for suite speed)."""
    scene, img = _cylinder_image(h=480, w=640)
    cfg = CylinderDetectConfig(height=480, width=640)
    res = detect_grid(img, cfg)
    assert bool(res.ok)
    _check_detection(scene, res, min_points=20)


def test_cylinder_detection_drops_negative_cols():
    scene, img = _cylinder_image()
    cfg = CylinderDetectConfig(height=H, width=W)
    res = detect_grid(img, cfg)
    det_idx = np.asarray(res.grid.idx)[np.asarray(res.grid.valid)]
    assert (det_idx[:, 0] >= 0).all()  # x_index = col index


def test_plane_detection_recovers_grid():
    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0)
    scene = plane_grid_points(stereo, capacity=256, n_rows=9, n_cols=9, spacing=23.0)
    img = render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W)
    rng = np.random.default_rng(3)
    img = jnp.clip(
        img.astype(jnp.float32) + jnp.asarray(rng.normal(0, 2.0, (H, W)), jnp.float32),
        0, 255,
    )
    cfg = PlaneDetectConfig(height=H, width=W, roi_threshold=30.0)
    res = detect_grid(img, cfg)
    assert bool(res.ok)
    det_idx = np.asarray(res.grid.idx)
    det_xy = np.asarray(res.grid.xy)
    det_valid = np.asarray(res.grid.valid)
    # plane ids are (row, col): invert for the GT map which stores (row, col)
    gt = _gt_map(scene.gp1, 81)
    matched, errs = 0, []
    for i in range(len(det_valid)):
        if not det_valid[i]:
            continue
        key = tuple(det_idx[i])
        if key in gt:
            errs.append(np.linalg.norm(det_xy[i] - gt[key]))
            matched += 1
    assert matched >= 50
    assert np.median(errs) < 1.5


def test_detection_jits_and_vmaps():
    scene, img = _cylinder_image()
    cfg = CylinderDetectConfig(height=H, width=W)
    fn = jax.jit(lambda im: detect_grid(im, cfg).grid.valid)
    single = np.asarray(fn(img))
    batch = jnp.stack([img, img])
    fnb = jax.jit(jax.vmap(lambda im: detect_grid(im, cfg).grid.valid))
    both = np.asarray(fnb(batch))
    np.testing.assert_array_equal(both[0], single)
    np.testing.assert_array_equal(both[1], single)


def test_detection_survives_blank_image():
    cfg = CylinderDetectConfig(height=H, width=W)
    img = jnp.full((H, W), 20.0, jnp.float32)
    res = detect_grid(img, cfg)
    assert not bool(res.ok)
    assert np.isfinite(np.asarray(res.grid.xy)[np.asarray(res.grid.valid)]).all()


def test_detection_with_subpixel_refinement():
    """Subpixel refinement (off in the reference main path) must not degrade
    detection and should keep median error at least as good."""
    scene, img = _cylinder_image()
    base = CylinderDetectConfig(height=H, width=W)
    refined = dataclasses.replace(base, subpixel_refine=True)
    gt = _gt_map(scene.gp1, N_ROWS * N_COLS)

    def errs_of(cfg):
        res = detect_grid(img, cfg)
        det_idx = np.asarray(res.grid.idx)
        det_xy = np.asarray(res.grid.xy)
        det_valid = np.asarray(res.grid.valid)
        errs = [
            np.linalg.norm(det_xy[i] - gt[tuple(det_idx[i])])
            for i in range(len(det_valid))
            if det_valid[i] and tuple(det_idx[i]) in gt
        ]
        return np.asarray(errs), det_valid.sum()

    e0, n0 = errs_of(base)
    e1, n1 = errs_of(refined)
    assert n1 >= n0 - 4
    assert np.median(e1) < np.median(e0) + 0.3


def test_stage_probe_truncations_trace():
    """cfg.stage_probe truncates detect_grid to a scalar probe at every
    named stage (profiling contract; see config.DetectConfig.stage_probe)."""
    from cylinder_pose_estimation_tpu.models.detector import detect_grid as dg

    img = jax.ShapeDtypeStruct((480, 640), jnp.float32)
    for st in ("preprocess", "centroids", "roi", "seed", "carve", "bridge",
               "labels", "assign", "polyfit", "newton"):
        cfg = CylinderDetectConfig(stage_probe=st)
        out = jax.eval_shape(lambda im, cfg=cfg: dg(im, cfg), img)
        assert out.shape == () and out.dtype == jnp.float32, st


def test_plane_randomized_backend_agreement():
    """Randomized plane scenes (grid sizes 7-9, spacings 18-23): every
    detected id lies on the rendered lattice at its ground-truth position
    (sub-pixel bulk, bounded worst case) -- the plane-mode counterpart of
    the cylinder sweep."""
    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0)
    cfg = PlaneDetectConfig(height=H, width=W, roi_threshold=30.0)

    for seed in range(4):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(7, 10))
        sp = float(rng.uniform(18, 23))
        scene = plane_grid_points(stereo, capacity=256, n_rows=n, n_cols=n,
                                  spacing=sp)
        img = np.asarray(
            render_grid_image(scene.gp1.xy, scene.gp1.valid, n, n, H, W),
            np.float32,
        )
        img = np.clip(
            img + rng.normal(0, 2.0, (H, W)).astype(np.float32), 0, 255
        )
        res = detect_grid(jnp.asarray(img), cfg)
        gt = _gt_map(scene.gp1, n * n)
        idx = np.asarray(res.grid.idx)
        xy = np.asarray(res.grid.xy)
        valid = np.asarray(res.grid.valid)
        keys = [tuple(int(q) for q in idx[i]) for i in range(len(valid)) if valid[i]]
        assert len(keys) >= 40, (seed, len(keys))
        assert all(k in gt for k in keys), (seed, [k for k in keys if k not in gt])
        errs = np.asarray([
            np.linalg.norm(xy[i] - gt[tuple(int(q) for q in idx[i])])
            for i in range(len(valid)) if valid[i]
        ])
        assert np.median(errs) < 1.0, (seed, np.median(errs))
        assert errs.max() < 3.0, (seed, errs.max())
