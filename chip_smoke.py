#!/usr/bin/env python3
"""Smoke test of the detect->pose path on an NVIDIA GPU.

Drives the system's public entry points once, at the reference's frame size
(480x640 stereo pairs), in ONE process that holds the card:

  device      platform, device kind and count; anything but a GPU exits 1
  batch       estimate_poses_batch, B=16 unique scenes: compile seconds,
              compiled.memory_analysis(), ok frames, points per view, frames/s
  parity      the same 16 frames through the same function on the host CPU:
              same ok and stable flags and grid-id sets, |d reproj| <= 1e-3 px
  stream      estimate_poses_stream(compact=True) over 1,024 uint8 frames
  experiment  full_experiment over a 128-frame pan/tilt sweep, its
              registration re-run on the CPU from the GPU's fit outputs

With ``--four-cards`` it runs only the sharded phase instead: the stream on a
4-card frame mesh against one card, and parallel.jit_sharded_pipeline against
an unsharded full_experiment.

Each phase prints one JSON line; every line that carries a number names the
card and its power limit.  The last line is exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.  Any
failed check raises, so the script exits non-zero and prints no such line.

    python chip_smoke.py
    python chip_smoke.py --four-cards
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

HEIGHT, WIDTH = 480, 640
BATCH = 16
STREAM_FRAMES = 1024
CHUNK = 64
SWEEP_FRAMES = 128

# Parity bar (BASELINE.json: reprojection within 1e-3 px of the CPU path).
# Ids and ok flags are integer decisions: any difference is a different
# detection, so they must match exactly.  Point positions and the fitted
# axis are reported, not gated: they feed the reprojection error, which is
# the contract's quantity.
REPROJ_TOL_PX = 1e-3
# Registration re-run on the CPU from the GPU's own fit outputs: the two
# solves see identical inputs, so only float reduction order differs.  80 LM
# iterations from the same starts land on the same minimum to f32 noise:
# 1e-3 per rotation entry (~0.06 deg) and 0.1 mm per translation entry.
REG_ROT_TOL = 1e-3
REG_TRANS_TOL_MM = 0.1


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def emit(phase: str, card: dict | None, **fields) -> None:
    line = {"phase": phase}
    if card is not None:
        line.update(card)
    line.update(fields)
    print(json.dumps(line), flush=True)


def _ids(grid, f: int) -> set:
    idx = np.asarray(grid.idx[f])
    valid = np.asarray(grid.valid[f])
    return {(int(i), int(j)) for (i, j), v in zip(idx, valid) if v}


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def compare_results(gpu, cpu, reproj_tol: float = REPROJ_TOL_PX):
    """Compare two StereoPoseResult batches frame by frame.

    Returns (problems, report): ``problems`` lists every broken rule (empty
    when the two agree), ``report`` the largest deltas.  Rules: equal ok
    and stable flags per view (``stable`` decides which frames feed the
    registration), equal grid-id sets per view, and for frames ok on both
    sides |d mean_reproj_error| <= reproj_tol.
    """
    problems = []
    n = int(np.asarray(cpu.fit.mean_reproj_error).shape[0])
    max_dxy = 0.0
    for view in ("detect1", "detect2"):
        dg, dc = getattr(gpu, view), getattr(cpu, view)
        ok_g, ok_c = np.asarray(dg.ok), np.asarray(dc.ok)
        if not np.array_equal(ok_g, ok_c):
            problems.append(f"{view} ok flags differ: {ok_g} vs {ok_c}")
        st_g, st_c = np.asarray(dg.stable), np.asarray(dc.stable)
        if not np.array_equal(st_g, st_c):
            problems.append(f"{view} stable flags differ: {st_g} vs {st_c}")
        for f in range(n):
            ig, ic = _ids(dg.grid, f), _ids(dc.grid, f)
            if ig != ic:
                problems.append(
                    f"{view} frame {f} id set differs: +{sorted(ig - ic)} "
                    f"-{sorted(ic - ig)}"
                )
                continue
            xg = {k: p for k, p in zip(map(tuple, np.asarray(dg.grid.idx[f]).tolist()),
                                       np.asarray(dg.grid.xy[f]))}
            xc = {k: p for k, p in zip(map(tuple, np.asarray(dc.grid.idx[f]).tolist()),
                                       np.asarray(dc.grid.xy[f]))}
            for k in ic:
                max_dxy = max(max_dxy, float(np.max(np.abs(xg[k] - xc[k]))))
    both_ok = (
        np.asarray(gpu.detect1.ok) & np.asarray(gpu.detect2.ok)
        & np.asarray(cpu.detect1.ok) & np.asarray(cpu.detect2.ok)
    )
    d_reproj = np.abs(
        np.asarray(gpu.fit.mean_reproj_error, np.float64)
        - np.asarray(cpu.fit.mean_reproj_error, np.float64)
    )
    for f in np.flatnonzero(both_ok):
        if not d_reproj[f] <= reproj_tol:
            problems.append(
                f"frame {f}: |d reproj| {d_reproj[f]:.3g} px > {reproj_tol} px"
            )
    cosang = np.abs(np.sum(
        _unit(np.asarray(gpu.fit.params)[:, 3:6])
        * _unit(np.asarray(cpu.fit.params)[:, 3:6]), axis=-1,
    ))
    ang = np.degrees(np.arccos(np.clip(cosang[both_ok], 0.0, 1.0)))
    report = {
        "frames_compared": int(both_ok.sum()),
        "max_abs_d_reproj_px": float(d_reproj[both_ok].max()) if both_ok.any() else None,
        "max_abs_d_xy_px": max_dxy,
        "max_axis_angle_diff_deg": float(ang.max()) if ang.size else None,
    }
    return problems, report


def _check(problems, phase: str) -> None:
    if problems:
        raise SmokeFailure(f"{phase}: " + "; ".join(problems))


def _memory_analysis(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def _finite_leaves(tree) -> list[str]:
    """Paths of float leaves holding a non-finite value."""
    import jax

    bad = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating) and not np.all(np.isfinite(a)):
            bad.append(jax.tree_util.keystr(path))
    return bad


def _uint8_pool(i1, i2):
    return (np.clip(i1, 0, 255).astype(np.uint8),
            np.clip(i2, 0, 255).astype(np.uint8))


def run_one_card(card: dict, gpu) -> None:
    import jax

    from __graft_entry__ import _example_pair, _sweep_pair
    from bench_stream import _TiledFrames
    from cylinder_pose_estimation_tpu.config import (
        CylinderDetectConfig,
        FitConfig,
        RegistrationConfig,
    )
    from cylinder_pose_estimation_tpu.models.pipeline import (
        estimate_poses_batch,
        estimate_poses_stream,
        frame_health,
        full_experiment,
        register_sequence,
    )

    cfg = CylinderDetectConfig(height=HEIGHT, width=WIDTH)
    fit_cfg = FitConfig()
    reg_cfg = RegistrationConfig()
    cpu = jax.devices("cpu")[0]

    # --- batch ------------------------------------------------------------
    # Pans cycled over the in-frame range 0..12 (as bench_stream does), so
    # every scene is detectable and each is unique.
    pans = [i % 13 for i in range(BATCH)]
    stereo, (i1, i2) = _example_pair(HEIGHT, WIDTH, n_frames=BATCH, pans=pans)
    batch_fn = jax.jit(
        lambda a, b: estimate_poses_batch(a, b, stereo, cfg, fit_cfg)
    )
    d1, d2 = jax.device_put((i1, i2), gpu)
    t0 = time.perf_counter()
    compiled = batch_fn.lower(d1, d2).compile()
    compile_s = time.perf_counter() - t0
    res = jax.block_until_ready(compiled(d1, d2))
    reps = 20
    t0 = time.perf_counter()
    outs = [compiled(d1, d2) for _ in range(reps)]
    jax.block_until_ready(outs)
    fps = BATCH * reps / (time.perf_counter() - t0)
    res = jax.tree.map(np.asarray, res)
    ok = res.detect1.ok & res.detect2.ok
    pts = np.concatenate([res.detect1.grid.valid.sum(-1),
                          res.detect2.grid.valid.sum(-1)])
    emit("batch", card, frames=BATCH, height=HEIGHT, width=WIDTH,
         compile_s=compile_s, memory_analysis=_memory_analysis(compiled),
         ok_frames=int(ok.sum()), points_per_view_min=int(pts.min()),
         points_per_view_max=int(pts.max()), frames_per_s=fps,
         median_reproj_px=float(np.median(res.fit.mean_reproj_error)))
    _check([] if ok.all() else [f"ok frames {int(ok.sum())}/{BATCH}"], "batch")
    _check([f"non-finite {p}" for p in _finite_leaves(res.fit)], "batch")

    # --- parity -----------------------------------------------------------
    # Every batch frame: a device fault can hit one scene in sixteen.
    res_cpu = jax.tree.map(np.asarray, batch_fn(*jax.device_put((i1, i2), cpu)))
    problems, report = compare_results(res, res_cpu)
    emit("parity", card, frames=BATCH, reproj_tol_px=REPROJ_TOL_PX, **report)
    _check(problems, "parity")

    # --- stream -----------------------------------------------------------
    p1, p2 = _uint8_pool(i1, i2)
    estimate_poses_stream(  # compile the chunk step (not timed)
        p1[:1], p2[:1], stereo, cfg, fit_cfg, chunk=CHUNK, compact=True
    )
    s1 = _TiledFrames(p1, STREAM_FRAMES)
    s2 = _TiledFrames(p2, STREAM_FRAMES)
    t0 = time.perf_counter()
    summ = estimate_poses_stream(
        s1, s2, stereo, cfg, fit_cfg, chunk=CHUNK, compact=True
    )
    wall = time.perf_counter() - t0
    ok = np.asarray(summ.ok)
    stats = gpu.memory_stats() or {}
    emit("stream", card, frames=STREAM_FRAMES, chunk=CHUNK, dtype="uint8",
         frames_per_s=STREAM_FRAMES / wall, wall_s=wall,
         ok_frames=int(ok.sum()),
         median_reproj_px=float(np.median(summ.mean_reproj_error[ok]))
         if ok.any() else None,
         peak_bytes_in_use=int(stats.get("peak_bytes_in_use", -1)))
    _check([] if ok.all() else [f"ok frames {int(ok.sum())}/{STREAM_FRAMES}"],
           "stream")
    _check([f"non-finite {p}" for p in _finite_leaves(
        jax.tree.map(lambda x: x[ok], summ))], "stream")

    # --- experiment -------------------------------------------------------
    st_s, (e1, e2), angles, t_gt = _sweep_pair(HEIGHT, WIDTH, SWEEP_FRAMES)
    exp_fn = jax.jit(
        lambda a, b, g: full_experiment(a, b, g, st_s, cfg, fit_cfg, reg_cfg)
    )
    args = jax.device_put((e1, e2, angles), gpu)
    t0 = time.perf_counter()
    exp_compiled = exp_fn.lower(*args).compile()
    exp_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch, reg = jax.block_until_ready(exp_compiled(*args))
    exp_s = time.perf_counter() - t0
    batch = jax.tree.map(np.asarray, batch)
    reg = jax.tree.map(np.asarray, reg)
    reg_cpu = jax.tree.map(np.asarray, jax.jit(
        lambda b, g: register_sequence(b, g, reg_cfg)
    )(jax.device_put(batch, cpu), jax.device_put(angles, cpu)))
    d_rot = float(np.max(np.abs(reg.t_cam_agv[:3, :3] - reg_cpu.t_cam_agv[:3, :3])))
    d_trans = float(np.max(np.abs(reg.t_cam_agv[:3, 3] - reg_cpu.t_cam_agv[:3, 3])))
    gt_trans = float(np.linalg.norm(reg.t_cam_agv[:3, 3] - t_gt[:3, 3]))
    ok = batch.detect1.ok & batch.detect2.ok
    healthy = int(np.asarray(frame_health(batch, reg_cfg)).sum())
    emit("experiment", card, frames=SWEEP_FRAMES, compile_s=exp_compile_s,
         run_s=exp_s, ok_frames=int(ok.sum()),
         healthy_frames=healthy,
         jtj_min_eig=float(reg.jtj_min_eig),
         well_posed_gpu=bool(reg.well_posed), well_posed_cpu=bool(reg_cpu.well_posed),
         reg_d_rot_max=d_rot, reg_d_trans_max_mm=d_trans,
         reg_rot_tol=REG_ROT_TOL, reg_trans_tol_mm=REG_TRANS_TOL_MM,
         t_cam_agv_err_vs_truth_mm=gt_trans)
    problems = [f"non-finite {p}" for p in _finite_leaves((batch.fit, reg))]
    # The sweep stays inside the detector's stable band (tilt <= ~0.2 rad),
    # so every frame must reach the registration.
    if healthy != SWEEP_FRAMES:
        problems.append(f"healthy frames {healthy}/{SWEEP_FRAMES}")
    if bool(reg.well_posed) != bool(reg_cpu.well_posed):
        problems.append("well_posed differs between GPU and CPU registration")
    if not d_rot <= REG_ROT_TOL:
        problems.append(f"T_cam_agv rotation differs by {d_rot:.3g}")
    if not d_trans <= REG_TRANS_TOL_MM:
        problems.append(f"T_cam_agv translation differs by {d_trans:.3g} mm")
    _check(problems, "experiment")


def run_four_cards(card: dict, devs) -> None:
    import jax

    from __graft_entry__ import _example_pair, _sweep_pair
    from bench_stream import _TiledFrames
    from cylinder_pose_estimation_tpu.config import (
        CylinderDetectConfig,
        FitConfig,
        RegistrationConfig,
    )
    from cylinder_pose_estimation_tpu.models.pipeline import (
        _stream_step,
        estimate_poses_stream,
        full_experiment,
    )
    from cylinder_pose_estimation_tpu.parallel.mesh import (
        frame_sharding,
        make_mesh,
    )
    from cylinder_pose_estimation_tpu.parallel.sharding import (
        jit_sharded_pipeline,
    )

    cfg = CylinderDetectConfig(height=HEIGHT, width=WIDTH)
    fit_cfg = FitConfig()
    reg_cfg = RegistrationConfig()
    mesh = make_mesh(devs)

    # --- sharded stream vs one card ---------------------------------------
    pans = [i % 13 for i in range(BATCH)]
    stereo, (i1, i2) = _example_pair(HEIGHT, WIDTH, n_frames=BATCH, pans=pans)
    p1, p2 = _uint8_pool(i1, i2)
    n = 4 * CHUNK
    s1, s2 = _TiledFrames(p1, n), _TiledFrames(p2, n)
    # Placement: one chunk through the sharded step lands one quarter of the
    # frames on each of the four cards.
    step = _stream_step(stereo, cfg, fit_cfg, reg_cfg, True, mesh)
    fs = frame_sharding(mesh)
    out = step(jax.device_put(s1[0:CHUNK], fs), jax.device_put(s2[0:CHUNK], fs))
    shards = out.ok.addressable_shards
    placement = sorted(str(s.device) for s in shards)
    problems = []
    if len({s.device for s in shards}) != len(devs) or any(
        s.data.shape[0] != CHUNK // len(devs) for s in shards
    ):
        problems.append(f"chunk not split over the cards: {placement}")
    t0 = time.perf_counter()
    sharded = estimate_poses_stream(s1, s2, stereo, cfg, fit_cfg, chunk=CHUNK,
                                    compact=True, mesh=mesh)
    wall_sh = time.perf_counter() - t0
    with jax.default_device(devs[0]):
        single = estimate_poses_stream(s1, s2, stereo, cfg, fit_cfg,
                                       chunk=CHUNK, compact=True)
    ok_s, ok_1 = np.asarray(sharded.ok), np.asarray(single.ok)
    if not np.array_equal(ok_s, ok_1):
        problems.append("sharded and one-card stream ok flags differ")
    both = ok_s & ok_1
    cos = np.abs(np.sum(_unit(sharded.params[:, 3:6]) * _unit(single.params[:, 3:6]), -1))
    min_cos = float(cos[both].min()) if both.any() else None
    if both.any() and not min_cos > 0.9999:
        problems.append(f"axis directions disagree (min |cos| {min_cos})")
    if not ok_s.all():
        problems.append(f"ok frames {int(ok_s.sum())}/{n}")
    emit("four_cards_stream", card, frames=n, chunk=CHUNK, cards=len(devs),
         placement=placement, sharded_frames_per_s=n / wall_sh,
         ok_frames=int(ok_s.sum()), min_abs_cos_axis=min_cos,
         max_abs_d_reproj_px=float(np.max(np.abs(
             sharded.mean_reproj_error[both] - single.mean_reproj_error[both])))
         if both.any() else None)
    _check(problems, "four_cards_stream")

    # --- jit_sharded_pipeline (registration all-gather) vs unsharded -----
    st_s, (e1, e2), angles, _ = _sweep_pair(HEIGHT, WIDTH, SWEEP_FRAMES)
    fn = jit_sharded_pipeline(mesh, st_s, cfg, fit_cfg, reg_cfg)
    batch_sh, reg_sh = jax.block_until_ready(fn(e1, e2, angles))
    reg_devs = sorted(str(d) for d in reg_sh.t_cam_agv.sharding.device_set)
    with jax.default_device(devs[0]):
        batch_1, reg_1 = jax.jit(
            lambda a, b, g: full_experiment(a, b, g, st_s, cfg, fit_cfg, reg_cfg)
        )(e1, e2, angles)
    batch_sh, reg_sh, batch_1, reg_1 = jax.tree.map(
        np.asarray, (batch_sh, reg_sh, batch_1, reg_1))
    problems = []
    ok_sh = batch_sh.detect1.ok & batch_sh.detect2.ok
    ok_1 = batch_1.detect1.ok & batch_1.detect2.ok
    if not np.array_equal(ok_sh, ok_1):
        problems.append("sharded and unsharded ok flags differ")
    both = ok_sh & ok_1
    cos = np.abs(np.sum(_unit(batch_sh.fit.params[:, 3:6])
                        * _unit(batch_1.fit.params[:, 3:6]), -1))
    min_cos = float(cos[both].min()) if both.any() else None
    if both.any() and not min_cos > 0.9999:
        problems.append(f"per-frame axes disagree (min |cos| {min_cos})")
    d_rot = float(np.max(np.abs(reg_sh.t_cam_agv[:3, :3] - reg_1.t_cam_agv[:3, :3])))
    d_trans = float(np.max(np.abs(reg_sh.t_cam_agv[:3, 3] - reg_1.t_cam_agv[:3, 3])))
    if bool(reg_sh.well_posed) != bool(reg_1.well_posed):
        problems.append("well_posed differs")
    if not d_rot <= REG_ROT_TOL:
        problems.append(f"T_cam_agv rotation differs by {d_rot:.3g}")
    if not d_trans <= REG_TRANS_TOL_MM:
        problems.append(f"T_cam_agv translation differs by {d_trans:.3g} mm")
    problems += [f"non-finite {p}" for p in _finite_leaves((batch_sh.fit, reg_sh))]
    emit("four_cards_experiment", card, frames=SWEEP_FRAMES, cards=len(devs),
         registration_devices=reg_devs, ok_frames=int(ok_sh.sum()),
         min_abs_cos_axis=min_cos, reg_d_rot_max=d_rot,
         reg_d_trans_max_mm=d_trans, well_posed=bool(reg_sh.well_posed))
    _check(problems, "four_cards_experiment")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    # Import the package before any phase, so a checkout without it fails
    # before printing anything.
    import jax

    from cylinder_pose_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from cylinder_pose_estimation_tpu.utils.profiling import (
        card_info,
        device_record,
        require_gpu,
    )

    devs = require_gpu(n_cards)
    enable_compile_cache()
    cards = card_info()
    for line in cards[:n_cards]:
        print(line, flush=True)
    rec = device_record(devs, cards[0])
    card = {"card": rec["card"], "power_limit": rec["power_limit"]}
    d0 = devs[0]
    emit("device", card, platform=d0.platform, device_kind=d0.device_kind,
         count=len(devs))
    if args.four_cards:
        run_four_cards(card, devs)
    else:
        run_one_card(card, d0)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
