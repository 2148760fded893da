"""10k-frame streaming benchmark (BASELINE.md config 5).

Drives models.pipeline.estimate_poses_stream over 10,000 synthetic 480x640
stereo frames on one GPU with bounded device memory (chunk-sized slices
through one compiled step) and prints one JSON line per run, then a summary:

  {"metric": "stream_frames_per_sec_10k", "value": ..., "unit": "frames/s",
   "n_frames": 10000, "chunk": 64, "peak_bytes_in_use": ..., "device": ...}

Frames are a 64-scene unique pool tiled to N with a per-frame brightness
perturbation; transfers ship uint8 (the camera wire format) and the wall
clock covers the FULL host loop -- H2D, compute, D2H readback -- i.e.
steady-state streaming serving, not a device-only kernel time.

Needs an NVIDIA GPU: with none it exits non-zero.

Usage: python bench_stream.py [--frames 10000] [--chunk 64] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np


class _TiledFrames:
    """Virtual (N, H, W) uint8 array: a unique-scene pool tiled to N frames
    with a deterministic per-frame brightness offset (breaks input-identity
    caching; detection is insensitive to a +0..6 gray offset).

    Frame i is pool[i % P] + (i % 7), which is periodic with period
    lcm(7, P) -- so ONE (period, H, W) arrangement is precomputed
    (saturating add in int16: the renderer clips the center blob at exactly
    255, so a uint8 add would wrap saturated pixels to 0..5 and corrupt the
    brightest-joint origin -- round-3 advisor finding) and __getitem__
    serves chunks as zero-copy contiguous views (a modular take only when a
    chunk straddles the period boundary), so host-side slicing stays out of
    the measured loop's way."""

    N_OFFSETS = 7

    def __init__(self, pool: np.ndarray, n: int):
        self.n = n
        p = len(pool)
        period = p * self.N_OFFSETS // math.gcd(p, self.N_OFFSETS)
        idx = np.arange(period)
        wide = pool[idx % p].astype(np.int16) + (idx % self.N_OFFSETS)[
            :, None, None
        ].astype(np.int16)
        self.arrangement = np.clip(wide, 0, 255).astype(np.uint8)

    @property
    def shape(self):
        return (self.n,) + self.arrangement.shape[1:]

    def __getitem__(self, sl):
        start, stop, _ = sl.indices(self.n)
        ln = stop - start
        per = len(self.arrangement)
        s0 = start % per
        if s0 + ln <= per:
            return self.arrangement[s0 : s0 + ln]  # zero-copy view
        # Wrapped chunk (possibly spanning multiple periods when ln > per,
        # e.g. small --pool with the default chunk): modular take is exact
        # for any ln; the straight-slice fast path above keeps the common
        # case zero-copy.
        out = np.take(self.arrangement, np.arange(s0, s0 + ln) % per, axis=0)
        assert len(out) == ln
        return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10000)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--runs", type=int, default=3,
                    help="repetitions; the summary reports min/median/max")
    ap.add_argument("--out", default=None,
                    help="also write the summary to this JSON file")
    args = ap.parse_args()

    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu.models.pipeline import estimate_poses_stream
    from cylinder_pose_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from cylinder_pose_estimation_tpu.utils.profiling import (
        card_info,
        device_record,
        require_gpu,
    )

    devs = require_gpu()
    enable_compile_cache()
    device = device_record(devs, card_info()[0])

    from __graft_entry__ import _example_pair

    height, width = 480, 640
    # Cycle pans over the in-frame range 0..12 (the cylinder exits the
    # 640-px frame above pan ~12); frames stay unique via per-frame grid
    # seeds + noise draws.  A linear pan sweep made 51/64 pool scenes
    # undetectable by construction (round-4 stream320 run: 65/320 ok).
    pans = [i % 13 for i in range(args.pool)]
    stereo, (i1, i2) = _example_pair(height, width, n_frames=args.pool, pans=pans)
    pool1 = np.clip(i1, 0, 255).astype(np.uint8)
    pool2 = np.clip(i2, 0, 255).astype(np.uint8)

    cfg = CylinderDetectConfig(height=height, width=width)
    fit_cfg = FitConfig()

    imgs1 = _TiledFrames(pool1, args.frames)
    imgs2 = _TiledFrames(pool2, args.frames)

    # Warm the compile on one chunk-shaped call (not counted).  Slice the
    # pool first: _TiledFrames precomputes brightness variants of its WHOLE
    # pool, and the warm call only ever reads frames [0, chunk).
    warm1 = _TiledFrames(pool1[: args.chunk], args.chunk)
    warm2 = _TiledFrames(pool2[: args.chunk], args.chunk)
    estimate_poses_stream(
        warm1, warm2, stereo, cfg, fit_cfg, chunk=args.chunk, compact=True
    )

    def one_run():
        t0 = time.perf_counter()
        res = estimate_poses_stream(
            imgs1, imgs2, stereo, cfg, fit_cfg, chunk=args.chunk, compact=True
        )
        dt = time.perf_counter() - t0

        ok = np.asarray(res.ok)
        n_ok = int(ok.sum())
        errs = np.asarray(res.mean_reproj_error)
        # None (JSON null), not NaN: json.dump would emit the non-standard
        # token `NaN` and break strict consumers of the output
        reproj = float(np.median(errs[ok])) if n_ok else None
        return {
            "fps": args.frames / dt,
            "wall_s": dt,
            "ok_frames": n_ok,
            "median_reproj_px": reproj,
        }

    runs = []
    for r in range(max(1, args.runs)):
        runs.append(one_run())
        print(json.dumps({"run": r, **runs[-1], "device": device}))

    stats = devs[0].memory_stats() or {}
    fpss = sorted(x["fps"] for x in runs)
    out = {
        "metric": "stream_frames_per_sec_10k",
        "value": float(np.median(fpss)),
        "unit": "frames/s",
        "fps_min": fpss[0],
        "fps_max": fpss[-1],
        "n_frames": args.frames,
        "chunk": args.chunk,
        "runs": runs,
        "ok_frames": runs[-1]["ok_frames"],
        "median_reproj_px": runs[-1]["median_reproj_px"],
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "device": device,
        "note": (
            "full host loop wall clock: uint8 H2D + batched detect->fit "
            "compute + host readback per chunk; three-deep pipeline "
            "(uploader thread || compute+async D2H || materialize); device "
            "memory O(chunk).  value = MEDIAN fps over runs[]."
        ),
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
