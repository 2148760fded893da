"""End-to-end pipelines: stereo images in, cylinder pose out; batched frames.

The batched equivalent of the reference's two drivers:
  * exp_gridDetection.m's per-frame loop (preprocess -> detect both views ->
    fitSingleCylinder; ref exp_gridDetection.m:55-81) becomes
    ``estimate_pose_stereo`` -- one jitted program per stereo pair -- and
    ``estimate_poses_batch`` -- the same vmapped over a frame axis, so
    thousands of frames run as one XLA computation instead of a serial
    Python/MATLAB loop (SURVEY.md §2 concurrency note).
  * the closing multi-frame AGV registration (ref exp_gridDetection.m:87)
    becomes ``register_sequence``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.config import (
    DetectConfig,
    FitConfig,
    RegistrationConfig,
)
from cylinder_pose_estimation_tpu.geometry.registration import (
    fit_cylinders_with_angles,
)
from cylinder_pose_estimation_tpu.models.detector import detect_grid
from cylinder_pose_estimation_tpu.models.pose import fit_single_cylinder
from cylinder_pose_estimation_tpu.types import (
    CylinderFitResult,
    DetectResult,
    RegistrationResult,
    StereoParams,
)


class StereoPoseResult(NamedTuple):
    detect1: DetectResult
    detect2: DetectResult
    fit: CylinderFitResult


def preprocess_stereo_batch(
    images1: jnp.ndarray,
    images2: jnp.ndarray,
    stereo: StereoParams,
    tiles: int = 8,
    clip_limit: float = 0.01,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched stereo preprocessing: undistort + adaptive histogram
    equalization for both views (ref utils/preProcessing.m:4-21, MATLAB
    adapthisteq defaults 8x8 tiles / 0.01 clip)."""
    from cylinder_pose_estimation_tpu.ops.clahe import preprocess_stereo

    return jax.vmap(
        lambda a, b: preprocess_stereo(
            a, b, stereo.cam1, stereo.cam2, tiles=tiles, clip_limit=clip_limit
        )
    )(images1, images2)


def estimate_pose_stereo(
    image1: jnp.ndarray,
    image2: jnp.ndarray,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
) -> StereoPoseResult:
    """detect both views -> correspond -> triangulate -> fit (one frame).

    Mirrors ref exp_gridDetection.m:58-81 / utils/fitSingleCylinder.m without
    the MATLAB<->Python bridge: one traced program, no host round-trips.
    """
    d1 = detect_grid(image1, detect_cfg)
    d2 = detect_grid(image2, detect_cfg)
    fit = fit_single_cylinder(d1.grid, d2.grid, stereo, fit_cfg)
    return StereoPoseResult(detect1=d1, detect2=d2, fit=fit)


def estimate_poses_batch(
    images1: jnp.ndarray,
    images2: jnp.ndarray,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    probe: str | None = None,
) -> StereoPoseResult:
    """Batched estimate_pose_stereo over a leading frame axis.

    Both views are detected in ONE (2F,)-batch vmap rather than two (F,)
    calls, so each op of the detector's long chain of small ops carries
    twice the data (numerically identical -- vmap is elementwise over
    frames).

    ``probe="detect"`` (static) truncates the program right after the shared
    (2F,) detect vmap and returns that stacked DetectResult: the bench's
    in-situ stage split times THIS truncation against the full program, so
    the subtraction isolates the correspond->triangulate->fit tail over a
    byte-identical detect subgraph."""
    f = images1.shape[0]
    both = jnp.concatenate([images1, images2], axis=0)
    det = jax.vmap(lambda im: detect_grid(im, detect_cfg))(both)
    if probe == "detect":
        return det
    d1 = jax.tree.map(lambda x: x[:f], det)
    d2 = jax.tree.map(lambda x: x[f:], det)
    fit = jax.vmap(lambda a, b: fit_single_cylinder(a, b, stereo, fit_cfg))(
        d1.grid, d2.grid
    )
    return StereoPoseResult(detect1=d1, detect2=d2, fit=fit)


class StreamPoseSummary(NamedTuple):
    """Compact per-frame serving output for the streaming pipeline.

    The full StereoPoseResult is ~28 KB/frame of grid slots + triangulated
    points; this summary is ~200 B/frame: what a pose-serving deployment
    actually returns, and all that crosses the device->host link.
    """

    params0: jnp.ndarray            # (F, 6)
    params: jnp.ndarray             # (F, 6)
    fvals: jnp.ndarray              # (F, 2)
    t_cam_cyl: jnp.ndarray          # (F, 4, 4)
    mean_reproj_error: jnp.ndarray  # (F,)
    n_points: jnp.ndarray           # (F,) int32 triangulated points in fit
    ok: jnp.ndarray                 # (F,) both views detected a usable grid
    stable: jnp.ndarray             # (F,) both views stable
    bridged_components: jnp.ndarray # (F,) int32 fragments merged by line
                                    # bridging, summed over both views --
                                    # backends are exact-equal when 0;
                                    # gap-bridged frames deserve reduced
                                    # trust
    healthy: jnp.ndarray            # (F,) pipeline.frame_health mask
    center1: jnp.ndarray            # (F, 2) view-1 grid origin
    center2: jnp.ndarray            # (F, 2)


def _summarize_batch(
    batch: StereoPoseResult, reg_cfg: RegistrationConfig
) -> StreamPoseSummary:
    fit = batch.fit
    return StreamPoseSummary(
        params0=fit.params0,
        params=fit.params,
        fvals=fit.fvals,
        t_cam_cyl=fit.t_cam_cyl,
        mean_reproj_error=fit.mean_reproj_error,
        n_points=jnp.sum(fit.points_valid.astype(jnp.int32), axis=-1),
        ok=batch.detect1.ok & batch.detect2.ok,
        stable=batch.detect1.stable & batch.detect2.stable,
        bridged_components=(batch.detect1.bridged_components
                            + batch.detect2.bridged_components),
        healthy=frame_health(batch, reg_cfg),
        center1=batch.detect1.grid.center,
        center2=batch.detect2.grid.center,
    )


_STREAM_STEP_CACHE: dict = {}


def _stream_step(stereo, detect_cfg, fit_cfg, reg_cfg, compact, mesh=None):
    """One compiled chunk step, cached across estimate_poses_stream calls.

    Rebuilding ``jax.jit`` per call would retrace + re-lower the whole
    detect->fit graph (~10 s) on every stream invocation even when the
    persistent compile cache serves the binary — so a warmup call would not
    warm a later timed call.  Stereo stays a CLOSED-OVER constant (keyed by
    content) rather than a traced argument: as a jit constant it is
    constant-folded exactly like a plain ``jax.jit(estimate_poses_batch)``
    closure, keeping the "numerically identical to one batch call" contract
    bit-exact (a traced stereo changed LM fit params at the 1e-1 level on
    gauge directions).

    No donate_argnums: the uint8 image inputs can never alias the small
    float outputs, so donation would only emit "unusable buffer" warnings.
    """
    import numpy as np

    fp = tuple(
        (np.asarray(leaf).tobytes(), np.asarray(leaf).shape,
         str(np.asarray(leaf).dtype))
        for leaf in jax.tree.leaves(stereo)
    )
    # reg_cfg only reaches the program through _summarize_batch's
    # frame_health call, so compact=False programs are byte-identical
    # across reg_cfg values -- keep them one cache entry.
    key = (detect_cfg, fit_cfg, reg_cfg if compact else None, compact, fp,
           mesh)
    step = _STREAM_STEP_CACHE.get(key)
    if step is None:
        while len(_STREAM_STEP_CACHE) >= 16:
            # evict the oldest entry (insertion order), not the whole cache
            _STREAM_STEP_CACHE.pop(next(iter(_STREAM_STEP_CACHE)))

        def _step(a, b):
            batch = estimate_poses_batch(a, b, stereo, detect_cfg, fit_cfg)
            return _summarize_batch(batch, reg_cfg) if compact else batch

        if mesh is None:
            step = jax.jit(_step)
        else:
            # Multi-chip serving: shard each chunk's frame axis over the
            # mesh (GSPMD -- the detect->fit chain is embarrassingly
            # frame-parallel, so XLA inserts no collectives; every output
            # leaf is frame-leading and comes back frame-sharded).
            from cylinder_pose_estimation_tpu.parallel.mesh import (
                frame_sharding,
            )

            fs = frame_sharding(mesh)
            step = jax.jit(_step, in_shardings=(fs, fs), out_shardings=fs)
        _STREAM_STEP_CACHE[key] = step
    return step


def estimate_poses_stream(
    images1,
    images2,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    chunk: int = 64,
    compact: bool = False,
    overlap: bool = True,
    reg_cfg: RegistrationConfig = RegistrationConfig(),
    mesh=None,
):
    """Bounded-device-memory estimate_poses_batch for long sequences.

    The 10k-frame end-to-end config (BASELINE.md) cannot hold all frames in
    HBM at once (10k x 480x640 f32 x 2 views = ~25 GB), so this streams
    fixed-size ``chunk`` slices through ONE compiled step (the tail is padded
    by repeating the last frame so shapes stay static -- no recompile) and
    device memory stays O(chunk) -- with ``overlap=True`` (the default) the
    constant is ~3x: chunk k+1's uint8 inputs are staged by the uploader
    thread while chunk k computes and chunk k-1's output pytree awaits
    readback.  Size ``chunk`` to HBM accordingly; ``overlap=False`` restores
    true single-chunk residency.  Numerically identical to one big
    estimate_poses_batch call (vmap is elementwise over frames).

    ``compact=True`` reduces each chunk ON DEVICE to a StreamPoseSummary
    (~200 B/frame) before readback -- the serving configuration; the default
    returns the full StereoPoseResult pytree (grid slots + 3D points) for
    offline analysis, at ~28 KB/frame of D2H.

    ``overlap=True`` pipelines the host loop three-deep: a dedicated uploader
    thread runs chunk k+1's host slicing + H2D staging while the main thread
    dispatches chunk k's compute, starts its readback with
    ``copy_to_host_async``, and materializes chunk k-1.  The thread matters
    because ``jax.device_put`` can block its calling thread for the staging
    copy, so in a single thread host prep and upload would serialize with
    compute.  Steady-state wall per chunk is max(upload, prep, compute +
    readback).  Chunks go to the calling thread's ``jax.default_device``
    (or the mesh), resolved before the uploader thread starts: the default
    device is thread-local.

    ``mesh`` (optional ``jax.sharding.Mesh``): multi-chip serving -- each
    chunk's frame axis is sharded over the mesh (GSPMD; the detect->fit
    chain is embarrassingly frame-parallel so XLA inserts no collectives)
    and results come back frame-sharded before the host gather.  ``chunk``
    must be divisible by ``mesh.size``.  Numerics are unchanged: frame k's
    result never depends on which device computed it (pinned by
    tests/test_parallel.py::test_stream_sharded_matches_batch on the
    8-device CPU mesh).

    images1/images2: (N, H, W) arrays (numpy / memmap accepted).  Returns a
    StreamPoseSummary / StereoPoseResult of host numpy arrays with the
    padding dropped.
    """
    import numpy as np

    n = images1.shape[0]
    if n == 0:
        raise ValueError("estimate_poses_stream needs at least one frame")

    if mesh is not None and chunk % mesh.size != 0:
        raise ValueError(
            f"chunk ({chunk}) must be divisible by the mesh size "
            f"({mesh.size}) for frame-axis sharding"
        )
    step = _stream_step(stereo, detect_cfg, fit_cfg, reg_cfg, compact, mesh)
    if mesh is not None:
        from cylinder_pose_estimation_tpu.parallel.mesh import frame_sharding

        in_sharding = frame_sharding(mesh)
    else:
        in_sharding = jax.sharding.SingleDeviceSharding(_caller_device())

    def _load(s):
        e = min(s + chunk, n)
        a = np.asarray(images1[s:e])
        b = np.asarray(images2[s:e])
        pad = chunk - (e - s)
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            b = np.concatenate([b, np.repeat(b[-1:], pad, axis=0)])
        return a, b, e - s

    def _upload(s):
        a, b, live = _load(s)
        da, db = jax.device_put((a, b), in_sharding)
        return da, db, live

    starts = list(range(0, n, chunk))
    outs = []
    pending = None  # (device result with async D2H started, live length)

    if overlap:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(_upload, starts[0])
            for i, s in enumerate(starts):
                da, db, live = fut.result()
                if i + 1 < len(starts):
                    fut = ex.submit(_upload, starts[i + 1])
                r = step(da, db)
                # start chunk k's D2H immediately; materialize chunk k-1
                # while chunk k computes and chunk k+1 uploads
                jax.tree.map(lambda x: x.copy_to_host_async(), r)
                if pending is not None:
                    pr, plive = pending
                    outs.append(
                        jax.tree.map(lambda x: np.asarray(x)[:plive], pr)
                    )
                pending = (r, live)
    else:
        for s in starts:
            da, db, live = _upload(s)
            r = step(da, db)
            outs.append(jax.tree.map(lambda x: np.asarray(x)[:live], r))

    if pending is not None:
        pr, plive = pending
        outs.append(jax.tree.map(lambda x: np.asarray(x)[:plive], pr))
    return jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *outs)


def _caller_device():
    """The calling thread's default device (``jax.default_device`` is
    thread-local, so a worker thread would see the process default)."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.local_devices()[0]
    if isinstance(dev, str):
        return jax.local_devices(backend=dev)[0]
    return dev


def frame_health(
    batch: StereoPoseResult,
    reg_cfg: RegistrationConfig = RegistrationConfig(),
) -> jnp.ndarray:
    """(F,) mask of frames whose detection + fit are trustworthy.

    A frame is healthy when both views detected a usable grid, enough points
    triangulated, the fit stayed finite, and the surviving correspondences
    reproject well.  The reference has no notion of this -- a failed frame
    feeds garbage into fitCylinderWPts3sAngs' objective (ref :82-94); here
    failures are explicit masks that survive vmap (SURVEY.md §5)."""
    fit = batch.fit
    n_pts = jnp.sum(fit.points_valid, axis=-1)
    finite = jnp.all(jnp.isfinite(fit.params), axis=-1)
    return (
        batch.detect1.ok
        & batch.detect2.ok
        & batch.detect1.stable
        & batch.detect2.stable
        & (n_pts >= reg_cfg.min_frame_points)
        & finite
        & (fit.mean_reproj_error <= reg_cfg.max_frame_reproj_px)
    )


def register_sequence(
    batch: StereoPoseResult,
    angles: jnp.ndarray,
    reg_cfg: RegistrationConfig = RegistrationConfig(),
) -> RegistrationResult:
    """Multi-frame camera<->AGV registration from a batched pose result
    (ref exp_gridDetection.m:87 fitCylinderWPts3sAngs), with unhealthy
    frames masked out of the objective (degraded-mode handling beyond the
    reference; falls back to all frames if < 2 are healthy)."""
    return fit_cylinders_with_angles(
        batch.fit.points3,
        batch.fit.points_valid,
        angles,
        reg_cfg,
        frame_valid=frame_health(batch, reg_cfg),
    )


def full_experiment(
    images1: jnp.ndarray,
    images2: jnp.ndarray,
    angles: jnp.ndarray,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    reg_cfg: RegistrationConfig = RegistrationConfig(),
    preprocess: bool = False,
) -> Tuple[StereoPoseResult, RegistrationResult]:
    """The whole exp_gridDetection.m equivalent as one jittable function:
    F stereo pairs + pan/tilt angles -> per-frame poses + T_Cam_AGV.

    ``preprocess=True`` runs the reference's stereo preprocessing first
    (undistort + adapthisteq, ref utils/preProcessing.m:4-21); pass False for
    images that are already undistorted/equalized.
    """
    if preprocess:
        images1, images2 = preprocess_stereo_batch(images1, images2, stereo)
    batch = estimate_poses_batch(images1, images2, stereo, detect_cfg, fit_cfg)
    reg = register_sequence(batch, angles, reg_cfg)
    return batch, reg
