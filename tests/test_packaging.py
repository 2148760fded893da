"""Packaging / public-API surface tests.

The framework is pip-installable (pyproject.toml); the versioned public API
is the package root's ``__all__``.  These tests pin that surface so a rename
or a dropped export is a visible break, not a silent one.
"""

import cylinder_pose_estimation_tpu as cpe


def test_version():
    assert isinstance(cpe.__version__, str) and cpe.__version__


def test_public_api_exports_resolve():
    for name in cpe.__all__:
        assert getattr(cpe, name) is not None, name


def test_flagship_entry_points_are_callables():
    assert callable(cpe.detect_grid)
    assert callable(cpe.fit_single_cylinder)
    assert callable(cpe.estimate_pose_stereo)
    assert callable(cpe.estimate_poses_batch)
    assert callable(cpe.estimate_poses_stream)
    assert callable(cpe.full_experiment)
    assert callable(cpe.register_sequence)


def test_io_contracts_exported():
    assert callable(cpe.io.load_stereo_json)
    assert callable(cpe.io.save_stereo_json)
    assert callable(cpe.io.grid_points_to_json)
    assert callable(cpe.io.grid_points_from_json)


def test_cli_main_importable():
    from cylinder_pose_estimation_tpu.cli import main

    assert callable(main)
