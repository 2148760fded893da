"""No float32 matrix product in the numeric chain runs at default precision.

On an NVIDIA GPU a float32 dot at default precision may run in TF32 (about
three decimal digits), which moves triangulated points and reprojection
errors far beyond the 1e-3 px parity contract; the CPU suite cannot see that
numerically.  So every numeric dot pins its precision (ops/linalg.mm,
Precision.HIGHEST), and these tests walk the traced programs to prove it.
Tracing only: nothing is compiled or run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cylinder_pose_estimation_tpu.config import (
    CylinderDetectConfig,
    FitConfig,
    RegistrationConfig,
)
from cylinder_pose_estimation_tpu.types import GridPoints

_DEFAULT = (None, jax.lax.Precision.DEFAULT)


def _sub_jaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _default_precision_f32_dots(jaxpr):
    """Source lines of float32 dot_generals whose precision is DEFAULT."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dtypes = {v.aval.dtype for v in eqn.invars}
            prec = eqn.params.get("precision")
            precs = prec if isinstance(prec, tuple) else (prec,)
            if jnp.dtype(jnp.float32) in dtypes and all(p in _DEFAULT for p in precs):
                found.append(str(eqn.source_info.traceback).splitlines()[-1:])
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                found += _default_precision_f32_dots(sub)
    return found


def _grid_points(n=64):
    return GridPoints(
        xy=jnp.zeros((n, 2), jnp.float32),
        idx=jnp.zeros((n, 2), jnp.int32),
        valid=jnp.zeros((n,), bool),
        center=jnp.zeros((2,), jnp.float32),
    )


def test_fit_single_cylinder_pins_precision(stereo):
    from cylinder_pose_estimation_tpu.models.pose import fit_single_cylinder

    gp = _grid_points()
    jaxpr = jax.make_jaxpr(
        lambda a, b: fit_single_cylinder(a, b, stereo, FitConfig())
    )(gp, gp)
    assert _default_precision_f32_dots(jaxpr.jaxpr) == []


def test_register_sequence_pins_precision():
    from cylinder_pose_estimation_tpu.geometry.registration import (
        fit_cylinders_with_angles,
    )

    f, n = 4, 32
    jaxpr = jax.make_jaxpr(
        lambda p, v, a, fv: fit_cylinders_with_angles(
            p, v, a, RegistrationConfig(), frame_valid=fv
        )
    )(
        jnp.zeros((f, n, 3), jnp.float32), jnp.ones((f, n), bool),
        jnp.zeros((f, 2), jnp.float32), jnp.ones((f,), bool),
    )
    assert _default_precision_f32_dots(jaxpr.jaxpr) == []


def test_detect_grid_pins_precision():
    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    cfg = CylinderDetectConfig(height=96, width=128)
    jaxpr = jax.make_jaxpr(lambda im: detect_grid(im, cfg))(
        jnp.zeros((96, 128), jnp.float32)
    )
    assert _default_precision_f32_dots(jaxpr.jaxpr) == []


def test_walk_finds_a_default_precision_dot():
    """The walker itself: an unpinned f32 product inside a scan is found."""

    def body(c, x):
        return c, x @ x

    jaxpr = jax.make_jaxpr(lambda xs: jax.lax.scan(body, 0.0, xs))(
        jnp.zeros((2, 3, 3), jnp.float32)
    )
    assert len(_default_precision_f32_dots(jaxpr.jaxpr)) == 1
    pinned = jax.make_jaxpr(
        lambda x: jnp.matmul(x, x, precision=jax.lax.Precision.HIGHEST)
    )(np.zeros((3, 3), np.float32))
    assert _default_precision_f32_dots(pinned.jaxpr) == []
