"""Native C++ loader vs the numpy loader (oracle pattern #2).

Mirrors the reference's plyParseTests: loader output compared field-by-field
against an independent implementation (numpy parser here; external plyfile
fixtures there, ``tests/plyParseTests.cpp:66-103``).
"""

import numpy as np
import pytest

from openglgaussiansplattingrenderer_jax.io import native, ply as ply_io


@pytest.fixture(scope="module")
def lib_available():
    if not native.available():
        pytest.skip("native loader not built and make failed")


def test_native_matches_numpy(tmp_path, rng, lib_available):
    n = 1234
    scene = ply_io.make_synthetic_scene(n, seed=77)
    path = str(tmp_path / "scene.ply")
    ply_io.save_ply(path, scene["means"], scene["quats"], scene["scales"],
                    scene["opacities"], scene["colors"])
    got = native.load_splats(path)
    assert got is not None
    want = ply_io.activate(ply_io.load_ply(path))
    for k in ["means", "colors", "opacities", "scales"]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(np.abs(np.sum(got["quats"] * want["quats"],
                                             axis=1)), 1.0, atol=1e-5)
    assert got["sh_rest"].shape == (n, 45)
    np.testing.assert_allclose(got["sh_rest"], want["sh_rest"], atol=1e-6)


def test_native_reference_fixture(lib_available, single_item_ply):
    got = native.load_splats(single_item_ply)
    assert got is not None
    want = ply_io.single_splat_scene()
    np.testing.assert_allclose(got["means"], want["means"], atol=1e-6)
    np.testing.assert_allclose(got["scales"], want["scales"], rtol=1e-5)
    np.testing.assert_allclose(got["opacities"], want["opacities"], rtol=1e-5)


def test_native_missing_file(lib_available):
    with pytest.raises(FileNotFoundError):
        native.load_splats("/nonexistent/scene.ply")


def test_load_splats_dispatch(tmp_path):
    """io.ply.load_splats uses the native path when available and must give
    the same result either way."""
    scene = ply_io.make_synthetic_scene(50, seed=5)
    path = str(tmp_path / "s.ply")
    ply_io.save_ply(path, scene["means"], scene["quats"], scene["scales"],
                    scene["opacities"], scene["colors"])
    out = ply_io.load_splats(path)
    np.testing.assert_allclose(out["means"], scene["means"], atol=1e-6)
