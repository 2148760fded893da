"""chip_smoke.py's CPU-checkable parts: it refuses a machine without a GPU
before any phase, and its GPU-vs-CPU parity checker holds the contract
(equal ok and stable flags and grid-id sets, |d reprojection| <= 1e-3
px)."""

import numpy as np
import pytest

import chip_smoke
from cylinder_pose_estimation_tpu.models.pipeline import StereoPoseResult
from cylinder_pose_estimation_tpu.types import (
    CylinderFitResult,
    DetectResult,
    GridPoints,
)


def _detect(xy, idx, valid, ok):
    f = xy.shape[0]
    z = np.zeros((f,), np.float32)
    return DetectResult(
        grid=GridPoints(xy=xy, idx=idx, valid=valid,
                        center=np.zeros((f, 2), np.float32)),
        ok=ok, roi_bbox=np.zeros((f, 4), np.int32), circle_radius0=z,
        labels_converged=np.ones((f,), bool), max_line_tilt=z,
        stable=np.ones((f,), bool), bridged_components=np.zeros((f,), np.int32),
    )


def _result(reproj=(0.12, 0.15), shift_xy=0.0):
    """Two frames, four grid points per view, both frames ok."""
    f, p = 2, 4
    idx = np.tile(np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.int32), (f, 1, 1))
    xy = np.tile(np.array([[10.0, 20.0], [30.0, 20.0], [10.0, 40.0],
                           [30.0, 40.0]], np.float32), (f, 1, 1)) + shift_xy
    valid = np.ones((f, p), bool)
    ok = np.ones((f,), bool)
    params = np.tile(np.array([0.0, -40.0, 560.0, 0.05, 1.0, 0.02],
                              np.float32), (f, 1))
    fit = CylinderFitResult(
        params0=params, params=params, fvals=np.zeros((f, 2), np.float32),
        t_cam_cyl=np.tile(np.eye(4, dtype=np.float32), (f, 1, 1)),
        mean_reproj_error=np.asarray(reproj, np.float32),
        points3=np.zeros((f, p, 3), np.float32),
        points_valid=np.ones((f, p), bool),
    )
    det = _detect(xy, idx, valid, ok)
    return StereoPoseResult(detect1=det, detect2=det, fit=fit)


def test_refuses_cpu_backend_before_any_phase(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "GPU" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_parity_accepts_identical_results():
    problems, report = chip_smoke.compare_results(_result(), _result())
    assert problems == []
    assert report["frames_compared"] == 2
    assert report["max_abs_d_reproj_px"] == 0.0
    assert report["max_abs_d_xy_px"] == 0.0


def test_parity_refuses_changed_id_set():
    gpu = _result()
    idx = np.array(gpu.detect2.grid.idx)
    idx[1, 3] = [2, 1]
    gpu = gpu._replace(detect2=gpu.detect2._replace(
        grid=gpu.detect2.grid._replace(idx=idx)))
    problems, _ = chip_smoke.compare_results(gpu, _result())
    assert len(problems) == 1 and "detect2 frame 1 id set" in problems[0]


def test_parity_refuses_changed_stable_flag():
    gpu = _result()
    stable = np.array(gpu.detect1.stable)
    stable[0] = False
    gpu = gpu._replace(detect1=gpu.detect1._replace(stable=stable))
    problems, _ = chip_smoke.compare_results(gpu, _result())
    assert len(problems) == 1 and "detect1 stable flags differ" in problems[0]


def test_parity_refuses_reprojection_delta_over_tolerance():
    # 2e-4 px moves nothing; 2e-3 px on frame 1 breaks the 1e-3 px bar
    problems, report = chip_smoke.compare_results(
        _result(reproj=(0.1202, 0.152)), _result(reproj=(0.12, 0.15)))
    assert len(problems) == 1 and problems[0].startswith("frame 1:")
    assert report["max_abs_d_reproj_px"] == pytest.approx(2e-3, rel=1e-3)
