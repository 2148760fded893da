"""Independent scene family: a SECOND image-formation model for detection e2e.

Every end-to-end image the detector had ever seen came
from utils/synthetic.render_grid_image (constant-width Gaussian-profile tubes
+ additive Gaussian noise), so detector and test scenes shared generative
assumptions, and every fence threshold was calibrated on that one family.

This renderer shares only the GEOMETRY helpers (projected grid points /
ground-truth ids); the image formation is deliberately different on every
axis the reference's real camera imagery varies on
(ref utils/util_cylinder.py:1839-1848 CLAHE-era texture, utils/preProcessing.m):

- ridge profile:   Lorentzian ``g/(1+(d/w)^2)`` or flat-top ``g*exp(-(d/w)^4)``
                   instead of Gaussian
- line width:      perspective-thinned per segment, ``w = w0 * z_ref / z(t)``
                   from the true 3D depth of the grid points
- illumination:    smooth multiplicative low-frequency field (lateral falloff)
- clutter:         off-grid specular plateau blobs (some saturated)
- optics:          mild defocus (small separable blur of the formed image)
- noise:           multiplicative gamma speckle (non-Gaussian), plus shot-like
                   sqrt-scaled perturbation

Pure NumPy, host-side, no JAX -- independent of the package's rendering and
compute stack.
"""

from __future__ import annotations

import numpy as np


def _blur_sep(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img
    r = max(1, int(3 * sigma))
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(t**2) / (2 * sigma * sigma))
    k /= k.sum()
    p = np.pad(img, r, mode="reflect")
    from scipy.ndimage import convolve1d

    p = convolve1d(p, k, axis=0, mode="nearest")
    p = convolve1d(p, k, axis=1, mode="nearest")
    return p[r:-r, r:-r]


def _splat_segment(canvas, a, b, wa, wb, ga, gb, profile):
    """Max-accumulate one line segment's profile into its local bbox patch."""
    h, w_img = canvas.shape
    pad = 14.0
    x0 = int(max(0, np.floor(min(a[0], b[0]) - pad)))
    x1 = int(min(w_img, np.ceil(max(a[0], b[0]) + pad) + 1))
    y0 = int(max(0, np.floor(min(a[1], b[1]) - pad)))
    y1 = int(min(h, np.ceil(max(a[1], b[1]) + pad) + 1))
    if x0 >= x1 or y0 >= y1:
        return
    xx = np.arange(x0, x1, dtype=np.float64)[None, :]
    yy = np.arange(y0, y1, dtype=np.float64)[:, None]
    ab = (b[0] - a[0], b[1] - a[1])
    ab2 = max(ab[0] * ab[0] + ab[1] * ab[1], 1e-9)
    px = xx - a[0]
    py = yy - a[1]
    t = np.clip((px * ab[0] + py * ab[1]) / ab2, 0.0, 1.0)
    dx = px - t * ab[0]
    dy = py - t * ab[1]
    d = np.sqrt(dx * dx + dy * dy)
    wloc = wa + t * (wb - wa)
    gloc = ga + t * (gb - ga)
    if profile == "lorentz":
        resp = gloc / (1.0 + (d / wloc) ** 2)
    elif profile == "flattop":
        resp = gloc * np.exp(-((d / (1.6 * wloc)) ** 4))
    else:
        raise ValueError(profile)
    np.maximum(canvas[y0:y1, x0:x1], resp, out=canvas[y0:y1, x0:x1])


def render_indep(
    gp_xy: np.ndarray,
    depths: np.ndarray,
    n_rows: int,
    n_cols: int,
    height: int,
    width: int,
    *,
    profile: str = "lorentz",
    base_width: float = 1.7,
    line_gain: float = 165.0,
    background: float = 16.0,
    center_flat: int | None = None,
    center_gain: float = 120.0,
    illum_amp: float = 0.30,
    illum_freq=(0.7, 1.3),
    illum_phase: float = 0.0,
    n_blobs: int = 2,
    blob_saturate: bool = True,
    defocus_sigma: float = 0.8,
    speckle_k: float = 350.0,
    col_stride: int = 1,
    seed: int = 0,
) -> np.ndarray:
    """Render an (H, W) uint8 stereo laser-grid image with the independent
    formation model.  gp_xy: (n_rows*n_cols, 2) projected grid points in
    row-major order; depths: matching (n_rows*n_cols,) camera-frame z.

    ``col_stride``: like utils/synthetic.render_grid_image -- the grid is
    column-densified; row polylines use every column sample, column curves
    and the center only every ``col_stride``-th column.
    """
    rng = np.random.default_rng(seed)
    pts = np.asarray(gp_xy, np.float64)[: n_rows * n_cols].reshape(
        n_rows, n_cols, 2
    )
    z = np.asarray(depths, np.float64)[: n_rows * n_cols].reshape(
        n_rows, n_cols
    )
    z_ref = float(np.median(z))
    wpt = base_width * (z_ref / np.maximum(z, 1.0))
    gpt = line_gain * (z_ref / np.maximum(z, 1.0)) ** 2

    canvas = np.zeros((height, width), np.float64)
    for r in range(n_rows):
        for c in range(n_cols - 1):
            _splat_segment(
                canvas, pts[r, c], pts[r, c + 1], wpt[r, c], wpt[r, c + 1],
                gpt[r, c], gpt[r, c + 1], profile,
            )
    for c in range(0, n_cols, col_stride):
        for r in range(n_rows - 1):
            _splat_segment(
                canvas, pts[r, c], pts[r + 1, c], wpt[r, c], wpt[r + 1, c],
                gpt[r, c], gpt[r + 1, c], profile,
            )

    if center_flat is None:
        center_flat = (n_rows // 2) * n_cols + (n_cols // 2)
    cx, cy = np.asarray(gp_xy, np.float64)[center_flat]
    xx = np.arange(width, dtype=np.float64)[None, :]
    yy = np.arange(height, dtype=np.float64)[:, None]

    img = background + canvas

    # Smooth multiplicative illumination field (low-frequency lateral
    # falloff, like a real laser projector + lens vignetting).
    fx, fy = illum_freq
    field = 1.0 + illum_amp * np.sin(
        2 * np.pi * (fx * xx / width + fy * yy / height) + illum_phase
    )
    img = img * (0.75 * field + 0.25)

    # Off-grid specular blobs: plateau discs outside the grid bbox.
    gx0, gx1 = pts[..., 0].min(), pts[..., 0].max()
    gy0, gy1 = pts[..., 1].min(), pts[..., 1].max()
    for _ in range(n_blobs):
        for _try in range(50):
            bx = rng.uniform(20, width - 20)
            by = rng.uniform(20, height - 20)
            if not (gx0 - 30 < bx < gx1 + 30 and gy0 - 30 < by < gy1 + 30):
                break
        rad = rng.uniform(8, 16)
        d2 = (xx - bx) ** 2 + (yy - by) ** 2
        level = 255.0 if blob_saturate else rng.uniform(180, 230)
        img = np.where(d2 < rad * rad, level, img)
        img = img + 25.0 * np.exp(-d2 / (2 * (1.2 * rad) ** 2))

    # Brightest joint = the ground-truth center (the detector's origin rule,
    # ref utils/util_cylinder.py:1350-1571): a flat-top boost blob, applied
    # AFTER illumination/clutter -- the center beam of a real projector is
    # distinctly brighter regardless of vignetting, and the ids are defined
    # relative to the brightest joint, so this property must hold by
    # construction for the ground truth to be meaningful.
    d2c = (xx - cx) ** 2 + (yy - cy) ** 2
    img = img + center_gain * np.exp(-(d2c**2) / (2.0 * 4.5**4))

    img = _blur_sep(img, defocus_sigma)

    # Multiplicative gamma speckle (non-Gaussian) + shot-like noise.
    img = img * rng.gamma(speckle_k, 1.0 / speckle_k, img.shape)
    img = img + rng.standard_normal(img.shape) * 0.15 * np.sqrt(
        np.maximum(img, 0.0)
    )
    return np.clip(img, 0, 255).astype(np.uint8)


def indep_scene(
    stereo,
    scene_seed: int = 0,
    height: int = 480,
    width: int = 640,
    profile: str = "lorentz",
    tilt: float = 0.05,
    **render_kw,
):
    """Build one independent-family stereo scene: geometry via the package's
    ground-truth generator (geometry is shared; image FORMATION is not),
    images via render_indep.  Returns (scene, img1, img2) with images as
    float32 arrays in [0, 255].

    ``tilt``: x-component of the cylinder axis direction -- 0.05 is the
    healthy near-vertical regime; ~0.7 produces the steep-diagonal chaotic
    regime the stability fence exists for.
    """
    import jax
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.geometry import transforms
    from cylinder_pose_estimation_tpu.utils.synthetic import (
        cylinder_grid_points,
    )

    rng = np.random.default_rng(scene_seed)
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        stride = 4
        n_rows, n_cols = 9, 9
        scene = cylinder_grid_points(
            stereo,
            origin=(
                float(rng.uniform(-35, 35)),
                float(rng.uniform(-55, -25)),
                float(rng.uniform(520, 620)),
            ),
            direction=(tilt, 1.0, float(rng.uniform(-0.04, 0.04))),
            radius=70.0,
            row_spacing=float(rng.uniform(16.0, 20.0)),
            theta_span=2.0,
            n_rows=n_rows,
            n_cols=(n_cols - 1) * stride + 1,
            center_rc=(n_rows // 2, ((n_cols - 1) * stride + 1) // 2),
            capacity=512,
            seed=scene_seed,
        )
        nc_dense = (n_cols - 1) * stride + 1
        n_dense = n_rows * nc_dense
        pts3 = np.asarray(scene.pts3)[:n_dense]
        # per-view depths: z in each camera frame
        z1 = pts3[:, 2]
        p2 = np.asarray(
            transforms.transform_points(
                jnp.asarray(stereo.t_c2_c1)[None], jnp.asarray(pts3)[None]
            )[0]
        )
        z2 = p2[:, 2]

    imgs = []
    for gp, z in ((scene.gp1, z1), (scene.gp2, z2)):
        img = render_indep(
            np.asarray(gp.xy),
            z,
            n_rows,
            nc_dense,
            height,
            width,
            profile=profile,
            col_stride=stride,
            center_flat=(n_rows // 2) * nc_dense + nc_dense // 2,
            illum_phase=float(rng.uniform(0, 2 * np.pi)),
            seed=scene_seed * 2 + len(imgs),
            **render_kw,
        )
        imgs.append(np.asarray(img, np.float32))
    return scene, imgs[0], imgs[1]


def indep_plane_scene(
    stereo,
    scene_seed: int = 0,
    height: int = 480,
    width: int = 640,
    profile: str = "lorentz",
    **render_kw,
):
    """Plane-mode independent-family scene: a tilted calibration plane with
    the same second image-formation model (plane lines project straight, so
    no column densification is needed).  Returns (scene, img1, img2)."""
    import jax
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.geometry import transforms
    from cylinder_pose_estimation_tpu.utils.synthetic import plane_grid_points

    rng = np.random.default_rng(scene_seed)
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        n_rows, n_cols = 9, 9
        scene = plane_grid_points(
            stereo,
            origin=(
                float(rng.uniform(-20, 20)),
                float(rng.uniform(-15, 15)),
                float(rng.uniform(620, 760)),
            ),
            normal=(
                float(rng.uniform(-0.1, 0.1)),
                float(rng.uniform(-0.12, 0.0)),
                -1.0,
            ),
            n_rows=n_rows,
            n_cols=n_cols,
            spacing=float(rng.uniform(16.0, 20.0)),
            capacity=256,
            seed=scene_seed,
        )
        n = n_rows * n_cols
        pts3 = np.asarray(scene.pts3)[:n]
        z1 = pts3[:, 2]
        z2 = np.asarray(
            transforms.transform_points(
                jnp.asarray(stereo.t_c2_c1)[None], jnp.asarray(pts3)[None]
            )[0]
        )[:, 2]

    imgs = []
    for gp, z in ((scene.gp1, z1), (scene.gp2, z2)):
        img = render_indep(
            np.asarray(gp.xy),
            z,
            n_rows,
            n_cols,
            height,
            width,
            profile=profile,
            col_stride=1,
            center_flat=(n_rows // 2) * n_cols + n_cols // 2,
            illum_phase=float(rng.uniform(0, 2 * np.pi)),
            seed=scene_seed * 2 + 100 + len(imgs),
            **render_kw,
        )
        imgs.append(np.asarray(img, np.float32))
    return scene, imgs[0], imgs[1]
