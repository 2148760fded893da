"""Persistent compilation cache location for the entry points.

The detect->pose program takes minutes to compile cold, so the CLI, the
benchmarks, the on-card smoke test and the test suite keep compiled
executables across processes.  JAX's cache key includes the directory, so
the directory must not move between runs.
"""

from __future__ import annotations

import os

import jax

# Inside the checkout (listed in .gitignore): the directory that holds the
# package.  Entries for different backends share it; the key includes the
# platform.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing.  Otherwise the cache goes to ``DEFAULT_DIR`` and programs
    that compiled in at least ``min_compile_secs`` are stored.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return DEFAULT_DIR
