"""Golden-fixture regression gate: the detector's
detected grid points + fit params on 6 committed bench-family scenes.

The fixture (tests/fixtures/golden_scenes.json, regenerate with
``python tests/make_golden.py``) pins the CURRENT behavior of the full
preprocess -> detect -> correspond -> triangulate -> fit chain; any silent
change to detection semantics (id assignment, subpixel coordinates, fit
numerics) fails here with a readable per-scene diff.

Tolerances: ids must match EXACTLY (a changed id set means different
detection logic); coordinates to 0.05 px and fit params to 0.05 (mm-scale)
so benign cross-host float32 churn passes while real regressions fail.
"""

from __future__ import annotations

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_scenes.json")

N_CHEAP = 2  # scenes re-run in the default suite; all 6 under -m slow


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def results(golden):
    from __graft_entry__ import _example_pair
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu.models.pipeline import estimate_pose_stereo

    n = sum(1 for s in golden["scenes"] if isinstance(s["scene"], int))
    stereo, (i1, i2) = _example_pair(480, 640, n_frames=n)
    cfg = CylinderDetectConfig(height=480, width=640)
    fn = jax.jit(lambda a, b: estimate_pose_stereo(a, b, stereo, cfg, FitConfig()))

    def run(s):
        return fn(jnp.asarray(i1[s]), jnp.asarray(i2[s]))

    return run


def _records(grid):
    xy = np.asarray(grid.xy, np.float64)
    idx = np.asarray(grid.idx)
    valid = np.asarray(grid.valid)
    return {
        (int(idx[i, 0]), int(idx[i, 1])): (float(xy[i, 0]), float(xy[i, 1]))
        for i in range(len(valid))
        if valid[i]
    }


def _check_scene(res, want):
    for view, det in (("view1", res.detect1), ("view2", res.detect2)):
        got = _records(det.grid)
        want_map = {tuple(r["id"]): (r["x"], r["y"]) for r in want[view]}
        assert set(got) == set(want_map), (
            f"{view} id set changed: +{set(got) - set(want_map)} "
            f"-{set(want_map) - set(got)}"
        )
        for k, (x, y) in want_map.items():
            gx, gy = got[k]
            assert abs(gx - x) < 0.05 and abs(gy - y) < 0.05, (
                f"{view} point {k}: ({gx:.4f},{gy:.4f}) vs golden ({x},{y})"
            )
    np.testing.assert_allclose(
        np.asarray(res.fit.params), np.asarray(want["fit_params"]), atol=0.05
    )
    assert abs(float(res.fit.mean_reproj_error) - want["mean_reproj_px"]) < 0.01


@pytest.mark.parametrize("s", range(N_CHEAP))
def test_golden_scene(results, golden, s):
    _check_scene(results(s), golden["scenes"][s])


@pytest.mark.slow
@pytest.mark.parametrize("s", range(N_CHEAP, 6))
def test_golden_scene_slow(results, golden, s):
    _check_scene(results(s), golden["scenes"][s])


@pytest.mark.slow
def test_golden_gap_scene(golden):
    """The BRIDGED golden scene (scene 0 + the generator's fixed dropout
    band): pins the full ridge -> carve -> bridge -> label -> intersect
    chain across an actual line gap against committed values.  The 6 clean
    golden scenes never bridge (bridged_components 0)."""
    from __graft_entry__ import _example_pair
    from tests.make_golden import apply_gap
    from cylinder_pose_estimation_tpu.config import (
        CylinderDetectConfig, FitConfig,
    )
    from cylinder_pose_estimation_tpu.models.pipeline import (
        estimate_pose_stereo,
    )

    want = next(s for s in golden["scenes"] if s["scene"] == "gap0")
    stereo, (i1, i2) = _example_pair(480, 640, n_frames=1)
    cfg = CylinderDetectConfig(height=480, width=640)
    res = jax.jit(
        lambda a, b: estimate_pose_stereo(a, b, stereo, cfg, FitConfig())
    )(jnp.asarray(apply_gap(i1[0])), jnp.asarray(apply_gap(i2[0])))
    _check_scene(res, want)
    nb = int(res.detect1.bridged_components) + int(res.detect2.bridged_components)
    assert nb == want["bridged_components"], (nb, want["bridged_components"])
