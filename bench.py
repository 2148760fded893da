"""Benchmark: end-to-end grid-detect -> cylinder-pose throughput on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "stages", "device"}.
The reference itself publishes no numbers (its per-stage comment "time 17.4"
suggests tens of ms per stage on CPU, i.e. low-double-digit frames/s at best).

The measured unit of work is the reference's full per-frame pipeline
(ref exp_gridDetection.m:55-81): TWO 480x640 grid detections (left+right view,
each: Gaussian -> Hessian ridge -> Sauvola -> morphology -> connected
components -> bridging -> polyfit -> intersections -> indexing), stereo
patch-consensus correspondence, batched DLT triangulation, curvature-seeded
LM cylinder fit with priors.

Measurement protocol:
  * 16 UNIQUE rendered scenes (distinct cylinder poses), not tiled copies;
  * inputs are staged on-device once (input pipelines are not the metric);
  * every repetition perturbs the images with a fresh scalar;
  * repetitions run INSIDE one jit via lax.scan with a carry data
    dependency, and timing is synced by materializing outputs on the host;
  * the "stages" dict reports the detect-only ms/frame (both views) via an
    IN-SITU truncate-the-tail probe: estimate_poses_batch(probe="detect")
    returns from the SAME source path right after the shared (2F,) detect
    vmap, so the detect subgraph of both timed programs is byte-identical
    and fit = end_to_end - detect isolates exactly the correspond ->
    triangulate -> fit tail.  Both programs force their complete output
    pytree into the carry (every leaf), so XLA cannot dead-code-eliminate
    part of either program.

Needs an NVIDIA GPU: with none it exits non-zero.  Every result carries the
platform, device kind, device count, card name and power limit.
"""

import json
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig, FitConfig
    from cylinder_pose_estimation_tpu.models.pipeline import estimate_poses_batch
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
    batch = 16
    stereo, (i1, i2) = _example_pair(height, width, n_frames=batch)
    d1 = jax.device_put(jnp.asarray(i1))
    d2 = jax.device_put(jnp.asarray(i2))
    jax.block_until_ready((d1, d2))

    detect_cfg = CylinderDetectConfig(height=height, width=width)
    fit_cfg = FitConfig()

    def _force(tree):
        """Reduce EVERY leaf to a scalar so nothing in the program is DCE'd."""
        return sum(
            jnp.sum(leaf.astype(jnp.float32)) for leaf in jax.tree.leaves(tree)
        )

    def step(a, b, k):
        res = estimate_poses_batch(a + k, b + k, stereo, detect_cfg, fit_cfg)
        return _force(res)

    def step_detect(a, b, k):
        # IN-SITU truncation: the SAME estimate_poses_batch
        # source path, cut right after the shared (2F,) detect vmap via the
        # static probe -- not a separately reconstructed detect program.  The
        # detect subgraph is byte-identical between the two timed programs,
        # so e2e - detect isolates exactly the correspond->triangulate->fit
        # tail (plus the forcing of the fit leaves).
        det = estimate_poses_batch(
            a + k, b + k, stereo, detect_cfg, fit_cfg, probe="detect"
        )
        return _force(det)

    # 64 in-jit repetitions amortize the per-call dispatch + readback over
    # K*batch frames; every rep sees a fresh scalar perturbation.
    reps = 64

    def timed(body, n_calls=3):
        @jax.jit
        def run(k0):
            def rep(carry, i):
                v = body(d1, d2, k0 + 1e-6 * i.astype(jnp.float32) + 1e-9 * carry)
                return carry + v, ()
            out, _ = jax.lax.scan(rep, jnp.float32(0.0), jnp.arange(reps))
            return out

        np.asarray(run(jnp.float32(1e-7)))  # warmup / compile
        ks = [jax.device_put(jnp.float32(1e-4 * (i + 1))) for i in range(n_calls)]
        jax.block_until_ready(ks)
        t0 = time.perf_counter()
        outs = [run(k) for k in ks]
        for o in outs:
            np.asarray(o)
        dt = time.perf_counter() - t0
        return dt / (batch * reps * n_calls)  # seconds per frame

    spf = timed(step)
    spf_detect = timed(step_detect)
    fps = 1.0 / spf
    print(
        json.dumps(
            {
                "metric": "frames_per_sec_detect_to_pose_480x640",
                "value": fps,
                "unit": "frames/s",
                "stages": {
                    "detect_ms_per_frame_2views": spf_detect * 1e3,
                    "fit_ms_per_frame": (spf - spf_detect) * 1e3,
                    "end_to_end_ms_per_frame": spf * 1e3,
                    "method": (
                        "in-situ: the detect probe is the e2e program "
                        "truncated after the shared (2F,) detect vmap "
                        "(estimate_poses_batch(probe='detect')); both "
                        "programs force their FULL output pytree, so "
                        "fit = e2e - detect isolates the correspond->"
                        "triangulate->fit tail over a byte-identical "
                        "detect subgraph"
                    ),
                },
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
