"""Test configuration: force an 8-device virtual CPU mesh.

Must run before any jax backend initialization.  Tests run on the host CPU
with 8 virtual devices so sharding tests exercise real multi-device code
paths; the GPU path is checked by chip_smoke.py on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from cylinder_pose_estimation_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

# The suite is compile-bound: persist compiled executables so repeat runs
# and repeat configs are fast.
enable_compile_cache(min_compile_secs=0.0)


@pytest.fixture(scope="session")
def stereo():
    from cylinder_pose_estimation_tpu.utils.synthetic import default_stereo

    return default_stereo()
