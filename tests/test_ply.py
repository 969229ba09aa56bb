"""PLY loader tests.

Oracle pattern #2 from SURVEY.md section 4: fixture comparisons. The checked-in
reference scene ``testSingleItem.ply`` (written by the reference's
``tests/plyFileGenerator.py``) is the analytic fixture.
"""

import numpy as np
import pytest

from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops.transforms import SH_C0

def test_roundtrip(tmp_path, rng):
    n = 37
    means = rng.normal(size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = np.exp(rng.uniform(-2, 0, size=(n, 3))).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, size=n).astype(np.float32)
    colors = rng.uniform(10, 240, size=(n, 3)).astype(np.float32)
    path = str(tmp_path / "scene.ply")
    ply_io.save_ply(path, means, quats, scales, opac, colors)

    raw = ply_io.load_ply(path)
    assert len(raw) == n
    assert raw.f_rest.shape == (n, 45)
    act = ply_io.activate(raw)
    np.testing.assert_allclose(act["means"], means, atol=1e-6)
    np.testing.assert_allclose(act["scales"], scales, rtol=1e-5)
    np.testing.assert_allclose(act["opacities"], opac, rtol=1e-4)
    np.testing.assert_allclose(act["colors"], colors, rtol=1e-4)
    np.testing.assert_allclose(np.abs(np.sum(act["quats"] * quats, axis=1)), 1.0,
                               atol=1e-5)


def test_reference_single_splat_fixture(single_item_ply):
    """Parse the single-splat scene and check the analytic values from the
    reference's ``tests/plyFileGenerator.py:251-265``."""
    act = ply_io.activate(ply_io.load_ply(single_item_ply))
    want = ply_io.single_splat_scene()
    np.testing.assert_allclose(act["means"], want["means"], atol=1e-6)
    np.testing.assert_allclose(act["scales"], want["scales"], rtol=1e-5)
    np.testing.assert_allclose(act["opacities"], want["opacities"], rtol=1e-5)
    np.testing.assert_allclose(act["colors"], want["colors"], rtol=1e-5)
    np.testing.assert_allclose(np.abs(act["quats"]), np.abs(want["quats"]), atol=1e-5)
    # colour activation: (0.5 + SH_C0 * 1.0) * 255 (white f_dc = 1)
    assert np.isclose(act["colors"][0, 0], (0.5 + SH_C0) * 255.0, rtol=1e-5)


def test_header_parse_rejects_ascii(tmp_path):
    p = tmp_path / "bad.ply"
    p.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\nend_header\n")
    with pytest.raises(ValueError):
        ply_io.load_ply(str(p))


def test_synthetic_scene_shapes():
    s = ply_io.make_synthetic_scene(100, seed=3)
    assert s["means"].shape == (100, 3)
    assert np.all(s["opacities"] > 0) and np.all(s["opacities"] < 1)
    np.testing.assert_allclose(np.linalg.norm(s["quats"], axis=1), 1.0, atol=1e-5)
