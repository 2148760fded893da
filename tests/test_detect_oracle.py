"""End-to-end detection BOOKKEEPING oracle tests.

The literal reference chain (tests/_oracle_detect.py: scipy.ndimage label ->
group/min-y sort -> polyfit -> remove_label -> scipy-root intersections ->
clean_and_relabel -> indexing_data -> make_json) is replayed from the repo
detector's OWN post-bridge state (the ``bridge_state`` probe: bridged masks,
centroids, ROI bbox, gray, circle_radius0) and compared id-for-id against
the detector's final output.  This pins the half of detection that golden
fixtures could only pin against themselves: a silent id-convention, sorting,
or pruning deviation now fails against an independent transliteration of
/root/reference/utils/util_cylinder.py instead of being re-pinned as golden.

This suite caught a real one on first run: the pre-r5 detector dropped the
max-min-x (rightmost) column, but the reference's "last col" is last in
min-member-Y order (group_points_by_label hardcodes sort_rows for both
sides, ref :376-394), which on the bench scenes is an arc-end column on the
NEGATIVE side -- the old code discarded a full valid column (32 -> 40 pts).

The mutation tests prove the comparison has teeth: seeded bugs in the
pruning config, the id order, and the positional relabel each make it fail.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import _oracle_detect as od

H, W = 480, 640


def _upsample2(small, h, w):
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    s = np.asarray(small)[:h2, :w2]
    return np.repeat(np.repeat(s, 2, axis=0), 2, axis=1)[:h, :w]


@pytest.fixture(scope="module")
def scenes():
    from __graft_entry__ import _example_pair

    _, (i1, i2) = _example_pair(H, W, n_frames=3)
    out = [i1[s] for s in range(3)] + [i2[0]]
    # the rendered line-gap stress scene: bridging is ACTIVE, so the chain
    # is compared in the regime where fragments merge (bench scenes never
    # bridge).
    from test_detector_hardening import _gapped_scene

    out.append(np.asarray(_gapped_scene(seed=5)[0]))
    return out


def _run_repo_and_oracle(img, cfg):
    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    res = jax.jit(lambda im: detect_grid(im, cfg))(jnp.asarray(img, jnp.float32))
    cfg_probe = dataclasses.replace(cfg, stage_probe="bridge_state")
    st = jax.jit(lambda im: detect_grid(im, cfg_probe))(
        jnp.asarray(img, jnp.float32)
    )
    cents = np.asarray(st["cents"])
    inside = np.asarray(st["inside"])
    js, dbg = od.detect_bookkeeping(
        _upsample2(st["h_exp"], H, W),
        _upsample2(st["v_exp"], H, W),
        cents[inside],
        np.asarray(st["bbox"]),
        np.asarray(st["gray"]),
        float(np.asarray(st["circle_radius0"])),
        degree=cfg.poly_degree,
        prune=cfg.drop_first_row or cfg.drop_last_col,
    )
    xy = np.asarray(res.grid.xy)
    idx = np.asarray(res.grid.idx)
    valid = np.asarray(res.grid.valid)
    repo = {
        (int(idx[i, 0]), int(idx[i, 1])): (float(xy[i, 0]), float(xy[i, 1]))
        for i in range(len(valid))
        if valid[i]
    }
    center = np.asarray(res.grid.center)
    if js is None:
        return repo, center, None, None
    data = json.loads(js)
    oracle = {tuple(p["id"]): (p["x"], p["y"]) for p in data["points"]}
    return repo, center, oracle, np.asarray(data["center_point"], float)


def _assert_match(repo, center, oracle, ocenter, tol=0.05):
    assert oracle is not None and repo, "one side produced no points"
    assert set(repo) == set(oracle), (
        f"id sets differ: only-repo {sorted(set(repo) - set(oracle))} "
        f"only-oracle {sorted(set(oracle) - set(repo))}"
    )
    for k in repo:
        dx = abs(repo[k][0] - oracle[k][0])
        dy = abs(repo[k][1] - oracle[k][1])
        assert dx < tol and dy < tol, f"{k}: {repo[k]} vs {oracle[k]}"
    assert np.all(np.abs(center - ocenter) < tol), (center, ocenter)


def _cfg(**kw):
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig

    return CylinderDetectConfig(height=H, width=W, **kw)


def test_bookkeeping_matches_oracle_bench_scene(scenes):
    repo, center, oracle, ocenter = _run_repo_and_oracle(scenes[0], _cfg())
    assert len(repo) >= 30
    _assert_match(repo, center, oracle, ocenter)


@pytest.mark.slow
@pytest.mark.parametrize("i", [1, 2, 3])
def test_bookkeeping_matches_oracle_more_scenes(scenes, i):
    repo, center, oracle, ocenter = _run_repo_and_oracle(scenes[i], _cfg())
    _assert_match(repo, center, oracle, ocenter)


def test_bookkeeping_matches_oracle_gap_scene(scenes):
    """Bridged regime: fragments merged by the bridge stage flow through the
    same bookkeeping; the oracle labels the repo's own bridged masks, so the
    comparison isolates grouping->indexing even when bridging fired."""
    repo, center, oracle, ocenter = _run_repo_and_oracle(scenes[4], _cfg())
    assert len(repo) >= 20
    _assert_match(repo, center, oracle, ocenter)


# ---------------------------------------------------------------------------
# mutation checks: the suite must FAIL for seeded bookkeeping bugs


def _mismatch(repo, center, oracle, ocenter):
    try:
        _assert_match(repo, center, oracle, ocenter)
    except AssertionError:
        return True
    return False


@pytest.mark.slow
def test_mutation_pruning_config_fails(scenes):
    """Seeded bug: disable the first-row prune -> extra row ids appear and
    every row index shifts; the oracle (which prunes) must disagree."""
    cfg = _cfg(drop_first_row=False)
    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    res = jax.jit(lambda im: detect_grid(im, cfg))(
        jnp.asarray(scenes[0], jnp.float32)
    )
    repo_mut = {
        (int(i0), int(i1))
        for (i0, i1), v in zip(
            np.asarray(res.grid.idx).tolist(), np.asarray(res.grid.valid)
        )
        if v
    }
    repo, center, oracle, ocenter = _run_repo_and_oracle(scenes[0], _cfg())
    assert set(repo) == set(oracle)  # healthy baseline
    assert repo_mut != set(oracle), "pruning mutation was not detected"


@pytest.mark.slow
def test_mutation_id_order_fails(scenes):
    """Seeded bug: flip the (col,row) id convention to (row,col)."""
    cfg = _cfg(id_row_major=True)
    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    res = jax.jit(lambda im: detect_grid(im, cfg))(
        jnp.asarray(scenes[0], jnp.float32)
    )
    repo_mut = {
        (int(i0), int(i1))
        for (i0, i1), v in zip(
            np.asarray(res.grid.idx).tolist(), np.asarray(res.grid.valid)
        )
        if v
    }
    _, _, oracle, _ = _run_repo_and_oracle(scenes[0], _cfg())
    assert repo_mut != set(oracle), "id-order mutation was not detected"


@pytest.mark.slow
def test_mutation_rank_by_fails(scenes, monkeypatch):
    """Seeded bug in the positional relabel (_rank_by, stage 6f): reverse the
    rank order.  Column indices flip sign relative to the center, so the
    oracle comparison must detect it."""
    import cylinder_pose_estimation_tpu.models.detector as det

    orig = det._rank_by

    def bad_rank(vals, valid):
        r = orig(vals, valid)
        n = jnp.sum(valid.astype(jnp.int32))
        return jnp.where(valid, n - 1 - r, r)

    monkeypatch.setattr(det, "_rank_by", bad_rank)
    res = jax.jit(lambda im: det.detect_grid(im, _cfg()))(
        jnp.asarray(scenes[0], jnp.float32)
    )
    repo_mut = {
        (int(i0), int(i1))
        for (i0, i1), v in zip(
            np.asarray(res.grid.idx).tolist(), np.asarray(res.grid.valid)
        )
        if v
    }
    monkeypatch.undo()
    _, _, oracle, _ = _run_repo_and_oracle(scenes[0], _cfg())
    assert repo_mut != set(oracle), "_rank_by mutation was not detected"


# ---------------------------------------------------------------------------
# plane path (ref utils/util_plane.py: degree 1, abnormal-column merge, no
# remove_label, (row, col) ids, no remove_minus_labels)


def _plane_img(gap_col=None):
    from cylinder_pose_estimation_tpu.utils.synthetic import (
        default_stereo,
        plane_grid_points,
        render_grid_image,
    )

    h, w = 240, 320
    stereo = default_stereo(cx=w / 2.0, cy=h / 2.0)
    scene = plane_grid_points(
        stereo, capacity=256, n_rows=9, n_cols=9, spacing=23.0
    )
    img = render_grid_image(
        scene.gp1.xy, scene.gp1.valid, 9, 9, h, w, saturate_center=True
    )
    img = np.asarray(img, np.float32)
    rng = np.random.default_rng(3)
    img = img + rng.normal(0, 2.0, (h, w)).astype(np.float32)
    if gap_col is not None:
        # damp a horizontal band across one column region to fragment it
        gxy = np.asarray(scene.gp1.xy).reshape(-1, 2)
        x0 = float(gxy[4 * 9 + gap_col, 0])
        img[60:72, int(x0) - 3 : int(x0) + 4] *= 0.05
    return scene, np.clip(img, 0, 255)


def _run_plane(img, cfg):
    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    h, w = img.shape
    res = jax.jit(lambda im: detect_grid(im, cfg))(jnp.asarray(img))
    st = jax.jit(
        lambda im: detect_grid(
            im, dataclasses.replace(cfg, stage_probe="bridge_state")
        )
    )(jnp.asarray(img))
    cents = np.asarray(st["cents"])
    inside = np.asarray(st["inside"])
    up = (lambda s: _upsample2(s, h, w)) if cfg.label_downsample == 2 else np.asarray
    js, dbg = od.detect_bookkeeping(
        up(st["h_exp"]),
        up(st["v_exp"]),
        cents[inside],
        np.asarray(st["bbox"]),
        np.asarray(st["gray"]),
        float(np.asarray(st["circle_radius0"])),
        degree=cfg.poly_degree,
        prune=False,
        mode="plane",
    )
    xy = np.asarray(res.grid.xy)
    idx = np.asarray(res.grid.idx)
    valid = np.asarray(res.grid.valid)
    repo = {
        (int(idx[i, 0]), int(idx[i, 1])): (float(xy[i, 0]), float(xy[i, 1]))
        for i in range(len(valid))
        if valid[i]
    }
    if js is None:
        return repo, None
    oracle = {
        tuple(p["id"]): (p["x"], p["y"]) for p in json.loads(js)["points"]
    }
    return repo, oracle


def test_plane_bookkeeping_matches_oracle():
    """Plane-path bookkeeping vs the literal util_plane.py chain: degree-1
    fits with the abnormal-column merge, (row, col) ids, no pruning.
    Tolerance note: the repo's 3x3-tolerant float-centroid label lookup can
    include one borderline member (near the saturation carve) that the
    reference's exact integer lookup drops, perturbing one degree-1 poly by
    well under a pixel -- id sets must still be EXACTLY equal."""
    from cylinder_pose_estimation_tpu.config import PlaneDetectConfig

    _, img = _plane_img()
    cfg = PlaneDetectConfig(height=240, width=320, roi_threshold=30.0)
    repo, oracle = _run_plane(img, cfg)
    assert oracle is not None and len(repo) >= 50
    assert set(repo) == set(oracle), (
        sorted(set(repo) - set(oracle)),
        sorted(set(oracle) - set(repo)),
    )
    diffs = sorted(
        np.hypot(
            repo[k][0] - oracle[k][0], repo[k][1] - oracle[k][1]
        )
        for k in repo
    )
    assert diffs[len(diffs) // 2] < 0.01
    assert diffs[-1] < 1.0


@pytest.mark.slow
def test_plane_bookkeeping_oracle_with_fragmented_column():
    """A damped band fragments one physical column: the reference's
    abnormal-column MERGE (util_plane.py:449-557) and the repo's
    _merge_short_column_leaders must make the same structural decision, or
    ids diverge and this comparison fails."""
    from cylinder_pose_estimation_tpu.config import PlaneDetectConfig

    _, img = _plane_img(gap_col=2)
    cfg = PlaneDetectConfig(height=240, width=320, roi_threshold=30.0)
    repo, oracle = _run_plane(img, cfg)
    assert oracle is not None and len(repo) >= 40
    assert set(repo) == set(oracle), (
        sorted(set(repo) - set(oracle)),
        sorted(set(oracle) - set(repo)),
    )


@pytest.mark.slow
def test_bookkeeping_oracle_randomized_sweep(scenes):
    """Randomized scene family vs the literal bookkeeping chain: rotated /
    rescaled grids with dropout damage (the same tame-regime generator as
    the backend-agreement sweep).  Every scene where the detector reports a
    usable grid must match the oracle id-for-id; positions to 0.05 px."""
    from cylinder_pose_estimation_tpu.utils.synthetic import render_grid_image

    checked = 0
    for seed in range(8):
        rng = np.random.default_rng(2000 + seed)
        tilt = rng.uniform(-8, 8)
        n = int(rng.integers(7, 10))
        spacing = min(rng.uniform(28, 42), (H / 2.0 - 60) / ((n - 1) / 2.0 * 1.2))
        t = np.radians(tilt)
        r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        ij = np.mgrid[0:n, 0:n].astype(np.float64) - (n - 1) / 2.0
        local = np.stack([ij[1], ij[0]], axis=-1).reshape(-1, 2) * spacing
        xy = local @ r.T + np.array([W / 2.0, H / 2.0])
        img = np.asarray(
            render_grid_image(
                jnp.asarray(xy, jnp.float32), jnp.ones(n * n, bool), n, n, H, W
            ),
            np.float32,
        )
        img = np.clip(img + rng.normal(0, 2.0, (H, W)), 0, 255)
        repo, center, oracle, ocenter = _run_repo_and_oracle(img, _cfg())
        if len(repo) < 12 or oracle is None:
            continue
        _assert_match(repo, center, oracle, ocenter)
        checked += 1
    assert checked >= 5, checked


@pytest.mark.slow
@pytest.mark.parametrize("rad", [30.0, 45.0])
def test_adaptive_brightness_patch_big_blob(scenes, rad):
    """Large saturated center blob: the brightness patch half-size scales
    with the saturation radius (ref :1377-1379; r5 closed this deviation --
    the old STATIC patch read 255 at every extrapolated intersection inside
    the blob and tie-broke arbitrarily).  At cr0 ~ 29 (half 5) the adaptive
    mean still singles out the true center; at cr0 ~ 44 even the
    reference's rule re-centers one column over -- either way the repo must
    match the literal chain id-for-id, center included."""
    from cylinder_pose_estimation_tpu.utils.synthetic import (
        cylinder_grid_points,
        default_stereo,
        render_grid_image,
    )

    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0)
    scene = cylinder_grid_points(
        stereo, origin=(0.0, -40.0, 560.0), radius=70.0, row_spacing=18.0,
        theta_span=2.0, capacity=128, seed=0,
    )
    img = np.asarray(
        render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W),
        np.float32,
    )
    cx_, cy_ = np.asarray(scene.gp1.xy)[4 * 9 + 4]
    yy, xx = np.mgrid[0:H, 0:W]
    img[(yy - cy_) ** 2 + (xx - cx_) ** 2 < rad * rad] = 255.0
    rng = np.random.default_rng(1)
    img = np.clip(img + rng.normal(0, 2.0, (H, W)), 0, 255)

    repo, center, oracle, ocenter = _run_repo_and_oracle(img, _cfg())
    assert len(repo) >= 30
    assert set(repo) == set(oracle), (
        sorted(set(repo) - set(oracle)), sorted(set(oracle) - set(repo))
    )
    # Positions: compared only for rows/cols whose curves do NOT cross the
    # carve boundary.  A centroid on the carve edge can pass the repo's
    # 3x3-tolerant float-centroid label lookup while the reference's exact
    # integer lookup drops it (documented design difference,
    # tests/_oracle_detect.py header); that one member perturbs its WHOLE
    # degree-2 curve, so every intersection on the affected row/col shifts
    # a little (up to ~4 px inside the blob).  Ids and the center choice
    # must still agree everywhere.
    k_excl = int(np.ceil((rad + 20.0) / 30.0))  # ~30 px grid pitch
    for k in repo:
        if abs(k[0]) <= k_excl or abs(k[1]) <= k_excl:
            continue
        dx = abs(repo[k][0] - oracle[k][0])
        dy = abs(repo[k][1] - oracle[k][1])
        assert dx < 0.05 and dy < 0.05, (k, repo[k], oracle[k])
    assert np.all(np.abs(center - ocenter) < 0.05), (center, ocenter)
    if rad <= 30.0:
        # the clear-win regime: the adaptive mean singles out the true center
        assert np.hypot(*(center - np.array([cx_, cy_]))) < 2.0
