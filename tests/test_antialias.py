"""Anti-aliased (opacity compensation) mode -- capability beyond the
reference (its +0.3 dilation, preprocess.glsl:126-128, brightens sub-pixel
splats; cfg.antialiased rescales opacity by sqrt(det_before/det_after) so
the integrated contribution is dilation-invariant). Off by default.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax import golden
from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays

W = H = 128


def _args(cam):
    a = camera_args(cam)
    return (jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H)


def _render(scene, cfg, cam):
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    img, stats = render_arrays(params, *_args(cam), cfg)
    return np.asarray(img), stats


def _cfg(**kw):
    base = dict(tile_px=32, use_pallas=True, chunk=64,
                dup_capacity_factor=16.0)
    base.update(kw)
    return RenderConfig.for_resolution(W, H, **base)


def test_aa_three_way_parity():
    """Pallas == jnp oracle == numpy golden with antialiased on."""
    scene = ply_io.make_synthetic_scene(600, seed=3, extent=2.5)
    cam = Camera(0.0, 0.0, -6.0, width=W, height=H)
    cfg_p = _cfg(antialiased=True)
    cfg_j = dataclasses.replace(cfg_p, use_pallas=False, max_per_tile=512)
    img_p, _ = _render(scene, cfg_p, cam)
    img_j, _ = _render(scene, cfg_j, cam)
    np.testing.assert_allclose(img_p, img_j, atol=1e-4)

    a = camera_args(cam)
    gparams = {
        "means": np.asarray(scene["means"]),
        "cov6": np.asarray(build_covariance(
            jnp.asarray(scene["scales"]), jnp.asarray(scene["quats"]))),
        "opacities": np.asarray(scene["opacities"]),
        "colors": np.asarray(scene["colors"]),
    }
    img_g, _ = golden.golden_render(
        gparams, a["view"], a["vp"], a["focal_x"], a["focal_y"],
        a["tan_fovx"], a["tan_fovy"], W, H,
        dataclasses.replace(cfg_j, tight_rect=False))
    np.testing.assert_allclose(img_j[..., :3], img_g[..., :3], atol=4e-3)


def test_aa_dims_subpixel_splats_only():
    """A sub-pixel splat's rendered peak drops sharply under AA; a large
    splat (det >> dilation^2) is nearly unchanged."""
    cam = Camera(0.0, 0.0, -3.0, width=W, height=H)
    base = ply_io.make_synthetic_scene(1, seed=0, extent=0.0)
    base["means"] = np.array([[0.0, 0.0, 0.0]], np.float32)
    base["opacities"] = np.array([0.9], np.float32)
    cfg_on = _cfg(antialiased=True, use_pallas=False, max_per_tile=256)
    cfg_off = dataclasses.replace(cfg_on, antialiased=False)

    tiny = dict(base, scales=np.full((1, 3), 1e-4, np.float32))
    img_on, _ = _render(tiny, cfg_on, cam)
    img_off, _ = _render(tiny, cfg_off, cam)
    # dilation dominates a sub-pixel footprint: compensation ~ det ratio -> 0
    assert img_on[..., :3].max() < 0.2 * img_off[..., :3].max()

    big = dict(base, scales=np.full((1, 3), 0.5, np.float32))
    img_on, _ = _render(big, cfg_on, cam)
    img_off, _ = _render(big, cfg_off, cam)
    assert abs(img_on[..., :3].max() - img_off[..., :3].max()) < 0.05


def test_aa_differentiable():
    scene = ply_io.make_synthetic_scene(60, seed=4, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    cfg = _cfg(antialiased=True, use_pallas=False, max_per_tile=256)
    args = _args(cam)

    def loss(p):
        img, _ = render_arrays(p, *args, cfg)
        return jnp.mean(img[..., :3] ** 2)

    g = jax.grad(loss)(params)
    for k, v in g.items():
        assert bool(jnp.all(jnp.isfinite(v))), k
    # compensation couples opacity to scale: scales must receive gradient
    # through the new factor too
    assert float(jnp.abs(g["scales"]).max()) > 0.0
