"""Posed-image dataset ingestion (io/dataset.py): transforms.json round
trip, camera-convention consistency with the Camera class, and fitting
straight from loaded bundles."""

import numpy as np
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.camera import Camera, perspective
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import dataset as ds
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.io.png import save_png
from openglgaussiansplattingrenderer_jax.render import render_arrays
from openglgaussiansplattingrenderer_jax.train import TrainConfig, fit_scene

CFG = RenderConfig(use_pallas=False, chunk=32, max_per_tile=256,
                   dup_capacity_factor=32.0)
W = H = 64


def _bundle_args(b):
    return (jnp.asarray(b["view"]), jnp.asarray(b["vp"]), b["focal_x"],
            b["focal_y"], b["tan_fovx"], b["tan_fovy"])


def test_bundle_from_c2w_matches_camera():
    """inv(view) -> bundle must reproduce the Camera's own matrices and the
    correct (sign-flipped, see io/dataset.py docstring) tan-fov values."""
    cam = Camera(1.5, 0.3, -5.0, width=W, height=H)
    cam.set_rotation(-10.0, 25.0, 0.0)
    c2w = np.linalg.inv(cam.get_view_matrix().astype(np.float64))
    b = ds.bundle_from_c2w(c2w, W, H, fl_x=cam.get_focal_x(),
                           fl_y=cam.get_focal_y())
    np.testing.assert_allclose(b["view"], cam.get_view_matrix(), atol=2e-5)
    np.testing.assert_allclose(b["vp"], cam.get_vp_matrix(), atol=2e-4)
    assert np.isclose(float(b["focal_x"]), cam.get_focal_x())
    assert np.isclose(float(b["tan_fovx"]), -cam.tan_fovx_correct(),
                      rtol=1e-6)
    assert np.isclose(float(b["tan_fovy"]), -cam.tan_fovy_correct(),
                      rtol=1e-6)


def test_bundle_render_matches_camera_render():
    """A dataset bundle of the same pose renders (near-)identically to the
    Camera path: only the EWA clamp constant differs (the dataset uses the
    standard 1.3 tan-fov bound, the Camera keeps the reference's quirk
    value), which is invisible for in-frustum scenes."""
    scene = ply_io.make_synthetic_scene(60, seed=3, extent=1.2)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    from openglgaussiansplattingrenderer_jax.render import camera_args
    a = camera_args(cam)
    img_cam, _ = render_arrays(params, jnp.asarray(a["view"]),
                               jnp.asarray(a["vp"]), a["focal_x"],
                               a["focal_y"], a["tan_fovx"], a["tan_fovy"],
                               W, H, CFG)
    c2w = np.linalg.inv(cam.get_view_matrix().astype(np.float64))
    b = ds.bundle_from_c2w(c2w, W, H, fl_x=cam.get_focal_x(),
                           fl_y=cam.get_focal_y())
    img_ds, _ = render_arrays(params, *_bundle_args(b), W, H, CFG)
    np.testing.assert_allclose(np.asarray(img_ds), np.asarray(img_cam),
                               atol=1e-3)


def test_transforms_json_roundtrip_and_fit(tmp_path):
    scene = ply_io.make_synthetic_scene(40, seed=7, extent=1.2)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}

    bundles, names = [], []
    for i, (x, ry) in enumerate([(0.0, 0.0), (1.0, -15.0)]):
        cam = Camera(x, 0.0, -4.0, width=W, height=H)
        cam.set_rotation(0.0, ry, 0.0)
        c2w = np.linalg.inv(cam.get_view_matrix().astype(np.float64))
        b = ds.bundle_from_c2w(c2w, W, H, fl_x=cam.get_focal_x(),
                               fl_y=cam.get_focal_y())
        img, _ = render_arrays(params, *_bundle_args(b), W, H, CFG)
        name = f"frame_{i}.png"
        save_png(str(tmp_path / name), np.asarray(img[..., :3]))
        bundles.append(b)
        names.append(name)
    ds.save_transforms(str(tmp_path / "transforms.json"), bundles, names)

    loaded, images = ds.load_transforms(str(tmp_path / "transforms.json"))
    assert len(loaded) == 2 and all(im is not None for im in images)
    for b, lb in zip(bundles, loaded):
        np.testing.assert_allclose(lb["view"], b["view"], atol=1e-5)
        np.testing.assert_allclose(lb["vp"], b["vp"], atol=1e-4)
    # loaded image == the render it came from, up to u8 quantisation
    img0, _ = render_arrays(params, *_bundle_args(loaded[0]), W, H, CFG)
    assert np.abs(images[0] - np.asarray(img0[..., :3])).max() <= 1.5 / 255

    # fitting straight from the loaded dataset (bundle dicts as cameras)
    start = {k: np.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(0)
    start["colors"] = np.clip(
        start["colors"] + rng.normal(0, 50, start["colors"].shape),
        0, 255).astype(np.float32)
    tc = TrainConfig(steps=25, lambda_dssim=0.0)
    fitted, hist = fit_scene(start, images, loaded, CFG, tc, verbose=False,
                             log_every=12)
    assert hist[-1]["loss"] < hist[0]["loss"], hist
