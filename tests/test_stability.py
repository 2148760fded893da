"""DetectResult.stable: the fence around the documented steep-diagonal
chaotic regime (PARITY.md, known deviations).

On >= ~30 deg diagonal grids the detection cascade is chaotic -- small
numeric differences change the labels -- so instead of pretending parity
there, the detector flags the frame (labels unconverged OR
median line tilt beyond cfg.max_stable_tilt) and pipeline.frame_health
masks it out of multi-frame registration."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from cylinder_pose_estimation_tpu.config import CylinderDetectConfig
from cylinder_pose_estimation_tpu.utils.synthetic import (
    cylinder_grid_points,
    default_stereo,
    render_grid_image,
)
from tests._util import run_detect as detect_grid

H, W = 240, 320


def _tilted_grid_image(angle_deg: float, n=9, spacing=22.0):
    """Planar n x n lattice rotated by angle_deg in image space, rendered
    with the standard line renderer (row-major grid points)."""
    t = np.radians(angle_deg)
    r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    ij = np.mgrid[0:n, 0:n].astype(np.float64) - (n - 1) / 2.0
    local = np.stack([ij[1], ij[0]], axis=-1).reshape(-1, 2) * spacing
    xy = local @ r.T + np.array([W / 2.0, H / 2.0])
    xy = jnp.asarray(xy, jnp.float32)
    valid = jnp.ones(n * n, bool)
    img = render_grid_image(xy, valid, n, n, H, W)
    rng = np.random.default_rng(0)
    return jnp.clip(
        img.astype(jnp.float32)
        + jnp.asarray(rng.normal(0, 2.0, (H, W)), jnp.float32),
        0,
        255,
    )


def test_steep_diagonal_grid_is_flagged_unstable():
    """>= 30 deg diagonal: the 20-px axis-aligned
    openings shred the lines entirely -- retention ~0 fences the frame (and
    detection also collapses to ok=False)."""
    img = _tilted_grid_image(32.0)
    cfg = CylinderDetectConfig(height=H, width=W)
    res = detect_grid(img, cfg)
    assert not bool(res.stable)


def test_chaotic_window_flagged_while_ok():
    """The REAL hazard: at ~26 deg detection still returns
    a plausible grid (ok=True) but the mask retention has collapsed -- the
    regime where backends disagree chaotically.  stable must be False while
    ok is True, so only the stability fence saves the frame."""
    img = _tilted_grid_image(26.0)
    cfg = CylinderDetectConfig(height=H, width=W)
    res = detect_grid(img, cfg)
    assert bool(res.ok)  # detection "works"...
    assert not bool(res.stable)  # ...but the frame is fenced


def test_moderate_tilt_measured_accurately():
    """Within the survivable band the tilt diagnostic tracks the true grid
    angle (14 deg = 0.244 rad) -- the number a deployment can log/alert on."""
    img = _tilted_grid_image(14.0)
    cfg = CylinderDetectConfig(height=H, width=W)
    res = detect_grid(img, cfg)
    assert 0.15 < float(res.max_line_tilt) < 0.33, float(res.max_line_tilt)


def test_19deg_sits_stably_inside_the_fence():
    """A 19 deg scene (measured tilt 0.322 vs the 0.35
    fence) must land -- and STAY, across noise reseeds -- on the stable side.
    The tilt diagnostic is a median over all fitted lines, so +-2 px pixel
    noise moves it by < 1e-3 rad (measured: 0.322 on every seed)."""
    cfg = CylinderDetectConfig(height=H, width=W)
    tilts = []
    for seed in range(4):
        t = np.radians(19.0)
        r = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        ij = np.mgrid[0:9, 0:9].astype(np.float64) - 4.0
        local = np.stack([ij[1], ij[0]], axis=-1).reshape(-1, 2) * 22.0
        xy = jnp.asarray(local @ r.T + np.array([W / 2.0, H / 2.0]), jnp.float32)
        img = render_grid_image(xy, jnp.ones(81, bool), 9, 9, H, W)
        rng = np.random.default_rng(seed)
        img = jnp.clip(
            img.astype(jnp.float32)
            + jnp.asarray(rng.normal(0, 2.0, (H, W)), jnp.float32), 0, 255,
        )
        res = detect_grid(img, cfg)
        assert bool(res.stable), (seed, float(res.max_line_tilt))
        tilts.append(float(res.max_line_tilt))
    # the measurement itself must be reseed-stable, not just under the fence
    assert max(tilts) - min(tilts) < 5e-3, tilts
    assert max(tilts) < cfg.max_stable_tilt - 0.01, tilts


def test_retention_fence_ignores_out_of_domain_binary():
    """Round-3 advisor: the retention denominator must share the numerator's
    domain (inside ROI, outside the saturation carve).  Scenes with (a)
    binarized speck clutter away from the grid and (b) a saturated specular
    blob carving out real line pixels must stay stable -- their line
    retention is unchanged; only out-of-domain binary mass differs."""
    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0)
    scene = cylinder_grid_points(
        stereo, capacity=128, n_rows=9, n_cols=9,
        origin=(0.0, -15.0, 560.0), radius=52.0,
        row_spacing=12.0, theta_span=2.2,
    )
    cfg = CylinderDetectConfig(height=H, width=W)
    base = np.asarray(
        render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W)
    ).astype(np.float32)
    rng = np.random.default_rng(1)

    clutter = base.copy()
    for cx_, cy_ in ((25, 25), (295, 25), (25, 215), (295, 215), (40, 120)):
        for _ in range(40):
            x = int(np.clip(cx_ + rng.normal(0, 9), 0, W - 1))
            y = int(np.clip(cy_ + rng.normal(0, 9), 0, H - 1))
            clutter[max(0, y - 1): y + 2, max(0, x - 1): x + 2] = 200.0

    saturated = np.asarray(
        render_grid_image(
            scene.gp1.xy, scene.gp1.valid, 9, 9, H, W, saturate_center=True
        )
    ).astype(np.float32)

    for name, img in (("clutter", clutter), ("saturated", saturated)):
        noisy = jnp.clip(
            jnp.asarray(img)
            + jnp.asarray(rng.normal(0, 2.0, (H, W)), jnp.float32), 0, 255,
        )
        res = detect_grid(noisy, cfg)
        assert bool(res.ok), name
        assert bool(res.stable), name
        assert int(np.asarray(res.grid.valid).sum()) >= 20, name


def test_axis_aligned_grid_is_stable():
    img = _tilted_grid_image(0.0)
    cfg = CylinderDetectConfig(height=H, width=W)
    res = detect_grid(img, cfg)
    assert float(res.max_line_tilt) < 0.2, float(res.max_line_tilt)
    assert bool(res.labels_converged)
    assert bool(res.stable)


def test_bench_family_scene_is_stable():
    """The validated regime (the 16-scene A/B gate population) must NOT be
    flagged -- the fence must not eat good frames."""
    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0)
    scene = cylinder_grid_points(
        stereo, capacity=128, n_rows=9, n_cols=9,
        origin=(0.0, -15.0, 560.0), radius=52.0,
        row_spacing=12.0, theta_span=2.2,
    )
    img = render_grid_image(scene.gp1.xy, scene.gp1.valid, 9, 9, H, W)
    rng = np.random.default_rng(1)
    img = jnp.clip(
        img.astype(jnp.float32)
        + jnp.asarray(rng.normal(0, 2.0, (H, W)), jnp.float32),
        0,
        255,
    )
    cfg = CylinderDetectConfig(height=H, width=W)
    res = detect_grid(img, cfg)
    assert bool(res.ok)
    assert bool(res.labels_converged)
    assert bool(res.stable), float(res.max_line_tilt)


def test_frame_health_masks_unstable_frames():
    """frame_health must drop a frame whose detection is flagged unstable
    even when its fit came back finite."""
    import jax

    from cylinder_pose_estimation_tpu.config import FitConfig
    from cylinder_pose_estimation_tpu.models.pipeline import (
        estimate_poses_batch,
        frame_health,
    )

    stereo = default_stereo(cx=W / 2.0, cy=H / 2.0)
    good = _tilted_grid_image(0.0)
    bad = _tilted_grid_image(26.0)  # chaotic window: ok=True, stable=False (26 deg)
    i1 = jnp.stack([good, bad])
    i2 = jnp.stack([good, bad])
    cfg = CylinderDetectConfig(height=H, width=W)
    batch = jax.jit(
        lambda a, b: estimate_poses_batch(a, b, stereo, cfg, FitConfig())
    )(i1, i2)
    health = np.asarray(frame_health(batch))
    stable = np.asarray(batch.detect1.stable)
    assert not stable[1]
    assert not health[1]
