"""Reference-facade parity: the ``Splats`` class API at the reference's
exact defaults (1024x512 target, main.cpp camera pose, gpuRender signature).
"""

import numpy as np

from openglgaussiansplattingrenderer_jax import Camera, RenderConfig, Splats
from openglgaussiansplattingrenderer_jax.camera import default_camera
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.render import camera_args

CFG = RenderConfig(use_pallas=False, chunk=32, max_per_tile=256,
                   dup_capacity_factor=24.0)


def _ply(tmp_path, n=60, seed=3):
    s = ply_io.make_synthetic_scene(n, seed=seed, extent=2.0)
    p = str(tmp_path / "scene.ply")
    ply_io.save_ply(p, s["means"], s["quats"], s["scales"], s["opacities"],
                    s["colors"])
    return p


def test_gpu_render_signature(tmp_path):
    """The reference call chain: main.cpp:62-64 passes view, dims, focals,
    swapped tanfovs and P*V into gpuRender."""
    splats = Splats(_ply(tmp_path), 256, 128, cfg=CFG)
    cam = Camera(0.0, 0.0, -5.0, width=256, height=128)
    img = splats.gpu_render(
        cam.get_view_matrix(), 256, 128, cam.get_focal_x(), cam.get_focal_y(),
        cam.get_tan_fovy(), cam.get_tan_fovx(), cam.get_vp_matrix())
    assert img.shape == (128, 256, 4)
    assert splats.last_stats["overflow"] == 0
    # must equal the camera-object path exactly
    img2 = splats.render_camera(cam)
    np.testing.assert_allclose(img, img2, atol=1e-6)


def test_default_resolution_vs_golden(tmp_path):
    """End-to-end at the reference's 1024x512 default with its hard-coded
    camera pose (main.cpp:40-45), JAX pipeline vs numpy golden."""
    splats = Splats(_ply(tmp_path, n=40, seed=8), 1024, 512, cfg=CFG)
    cam = default_camera()
    # place the scene in front of that camera pose
    a = camera_args(cam)
    img = splats.render_camera(cam)
    gold = splats.cpu_render(a["view"], 1024, 512, a["focal_x"], a["focal_y"],
                             a["tan_fovx"], a["tan_fovy"], a["vp"],
                             save_path=None)
    assert img.shape == gold.shape == (512, 1024, 4)
    np.testing.assert_allclose(img, gold, atol=4e-3)


def test_display_requires_render(tmp_path):
    splats = Splats(_ply(tmp_path), 64, 64, cfg=CFG)
    import pytest

    with pytest.raises(RuntimeError):
        splats.display("/tmp/nope.png")


def test_facade_autotune_capacity(single_item_ply):
    """Splats.autotune_capacity pins cfg.capacity_records to the measured
    record count (+ margin, quantized) and the subsequent render fits with
    zero overflow."""
    from openglgaussiansplattingrenderer_jax import Camera, RenderConfig, Splats

    cfg = RenderConfig(use_pallas=False, dup_capacity_factor=256.0,
                       max_per_tile=256, chunk=64)
    s = Splats(single_item_ply, 128, 128, cfg=cfg)
    cam = Camera(0, 0, -3.0, width=128, height=128)
    s.autotune_capacity(cam)
    assert s.cfg.capacity_records is not None
    assert s.cfg.capacity_records < 256 * 64  # far below the blanket factor
    img = s.render_camera(cam)
    assert int(s.last_stats["overflow"]) == 0
    assert img.max() > 0.01


def test_render_config_validates_engine_typos():
    """depth_key/sort_payload typos fail loudly at construction instead of
    silently selecting another mode."""
    import pytest

    from openglgaussiansplattingrenderer_jax.config import RenderConfig

    with pytest.raises(ValueError, match="sort_payload"):
        RenderConfig(sort_payload="Q16")
    with pytest.raises(ValueError, match="depth_key"):
        RenderConfig(depth_key="packed ")
    RenderConfig(sort_payload="q16", depth_key="packed")  # valid combos


def test_facade_inference_mode(single_item_ply):
    """Splats(..., inference=True) renders through the q16 packed-payload
    sort and stays within the documented error budget of the exact path."""
    import numpy as np

    from openglgaussiansplattingrenderer_jax.camera import Camera
    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.splats import Splats

    cfg = RenderConfig(chunk=32, dup_capacity_factor=256.0)
    s_f = Splats(single_item_ply, 128, 128, cfg=cfg)
    s_q = Splats(single_item_ply, 128, 128, cfg=cfg,
                 inference=True)
    assert s_q.cfg.sort_payload == "q16"
    assert s_q.cfg.depth_key == "packed"
    cam = Camera(0, 0, -3.0, width=128, height=128)
    img_f = s_f.render_camera(cam)
    img_q = s_q.render_camera(cam)
    assert int(s_q.last_stats["overflow"]) == 0
    err = float(np.abs(np.asarray(img_q)[..., :3]
                       - np.asarray(img_f)[..., :3]).max())
    assert err < 2e-3
    assert np.asarray(img_q).max() > 0.01
