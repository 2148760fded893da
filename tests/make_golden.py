"""Regenerate tests/fixtures/golden_scenes.json.

Runs the detection + fit path on CPU over the bench scene
family (__graft_entry__._example_pair, 6 frames) and records detected grid
points (ids + subpixel coords, both views), fit params, and reprojection
error per scene.  The committed file is the PINNED reference behavior:
tests/test_golden_fixtures.py re-runs the same path and compares, so any
silent change to the detection or geometry chain fails CI.

Usage (from the repo root):  python tests/make_golden.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from cylinder_pose_estimation_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache(min_compile_secs=0.0)

import numpy as np
import jax.numpy as jnp

N_SCENES = 6
HEIGHT, WIDTH = 480, 640

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_scenes.json")


def scene_images():
    from __graft_entry__ import _example_pair

    stereo, (i1, i2) = _example_pair(HEIGHT, WIDTH, n_frames=N_SCENES)
    return stereo, i1, i2


# Fixed dropout band for the bridged golden scene: crosses one horizontal
# and one vertical laser line of scene 0 near mid-frame; smooth-tapered
# edges (a hard rectangle would manufacture step-edge ridges).
GAP = (232, 250, 290, 320)  # y0, y1, x0, x1


def apply_gap(img: np.ndarray) -> np.ndarray:
    y0, y1, x0, x1 = GAP
    yy = np.arange(img.shape[0], dtype=np.float32)[:, None]
    xx = np.arange(img.shape[1], dtype=np.float32)[None, :]

    def edge(v, lo, hi):
        return 1.0 / (1.0 + np.exp(-(v - lo) / 1.5)) *                1.0 / (1.0 + np.exp((v - hi) / 1.5))

    atten = 1.0 - 0.97 * edge(yy, y0, y1) * edge(xx, x0, x1)
    return np.clip(np.asarray(img, np.float32) * atten, 0, 255)


def grid_to_records(grid) -> list[dict]:
    xy = np.asarray(grid.xy, np.float64)
    idx = np.asarray(grid.idx)
    valid = np.asarray(grid.valid)
    recs = [
        {"id": [int(idx[i, 0]), int(idx[i, 1])],
         "x": round(float(xy[i, 0]), 4), "y": round(float(xy[i, 1]), 4)}
        for i in range(len(valid)) if valid[i]
    ]
    recs.sort(key=lambda r: tuple(r["id"]))
    return recs


def main() -> None:
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu.models.pipeline import estimate_pose_stereo

    stereo, i1, i2 = scene_images()
    cfg = CylinderDetectConfig(height=HEIGHT, width=WIDTH)
    fit_cfg = FitConfig()
    fn = jax.jit(lambda a, b: estimate_pose_stereo(a, b, stereo, cfg, fit_cfg))

    scenes = []
    for s in range(N_SCENES):
        res = fn(jnp.asarray(i1[s]), jnp.asarray(i2[s]))
        scenes.append(
            {
                "scene": s,
                "view1": grid_to_records(res.detect1.grid),
                "view2": grid_to_records(res.detect2.grid),
                "center1": [round(float(v), 4) for v in np.asarray(res.detect1.grid.center)],
                "fit_params": [round(float(v), 5) for v in np.asarray(res.fit.params)],
                "fvals": [round(float(v), 4) for v in np.asarray(res.fit.fvals)],
                "mean_reproj_px": round(float(res.fit.mean_reproj_error), 5),
            }
        )
        print(f"scene {s}: {len(scenes[-1]['view1'])} pts view1, "
              f"reproj {scenes[-1]['mean_reproj_px']} px")

    # Bridged scene: scene 0 with the fixed dropout band -- pins the
    # BRIDGING path (ridge -> carve -> bridge -> label -> intersect across
    # a line gap) against committed values; the 6 clean scenes never bridge
    # (bridged_components 0), which made them vacuous for it.
    ga = jnp.asarray(apply_gap(i1[0]))
    gb = jnp.asarray(apply_gap(i2[0]))
    name = "gap0"
    res = fn(ga, gb)
    nb = (int(res.detect1.bridged_components)
          + int(res.detect2.bridged_components))
    scenes.append(
        {
            "scene": name,
            "view1": grid_to_records(res.detect1.grid),
            "view2": grid_to_records(res.detect2.grid),
            "center1": [round(float(v), 4) for v in np.asarray(res.detect1.grid.center)],
            "fit_params": [round(float(v), 5) for v in np.asarray(res.fit.params)],
            "fvals": [round(float(v), 4) for v in np.asarray(res.fit.fvals)],
            "mean_reproj_px": round(float(res.fit.mean_reproj_error), 5),
            "bridged_components": nb,
        }
    )
    print(f"scene {name}: {len(scenes[-1]['view1'])} pts view1, "
          f"bridged_components {nb}, "
          f"reproj {scenes[-1]['mean_reproj_px']} px")
    assert nb > 0, "gap scene must actually bridge -- adjust GAP"

    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "w") as f:
        json.dump(
            {
                "generator": "tests/make_golden.py",
                "path": "XLA, CPU, float32",
                "scene_family": "__graft_entry__._example_pair(480, 640, n_frames=6)",
                "scenes": scenes,
            },
            f,
            indent=1,
        )
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
