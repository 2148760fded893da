"""The entry points' persistent compilation cache: JAX_COMPILATION_CACHE_DIR
wins and nothing is set in code; otherwise a fixed directory inside the
checkout, listed in .gitignore."""

import os

import jax

from cylinder_pose_estimation_tpu.utils import compile_cache

_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _snapshot():
    return {k: getattr(jax.config, k) for k in _KEYS}


def _restore(saved):
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_variable_set_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    saved = _snapshot()
    try:
        jax.config.update("jax_compilation_cache_dir", "sentinel-dir")
        assert compile_cache.enable_compile_cache(2.5) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == "sentinel-dir"
        assert jax.config.jax_persistent_cache_min_compile_time_secs == (
            saved["jax_persistent_cache_min_compile_time_secs"])
    finally:
        _restore(saved)


def test_env_variable_unset_uses_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    saved = _snapshot()
    try:
        path = compile_cache.enable_compile_cache(2.5)
        assert path == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == path
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.5
    finally:
        _restore(saved)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == root
    with open(os.path.join(root, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()
