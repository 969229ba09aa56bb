"""Spherical-harmonic view-dependent colour (capability beyond the reference:
it parses the 45 f_rest coefficients and discards them, Splats.cpp:301-302)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops import transforms
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays

BASE = RenderConfig(use_pallas=False, chunk=32, max_per_tile=256,
                    dup_capacity_factor=32.0)


def test_degree0_equals_dc():
    dc = jnp.asarray(np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32))
    sh = jnp.asarray(np.random.default_rng(1).normal(size=(10, 45)).astype(np.float32))
    dirs = jnp.asarray(np.tile([[0.0, 0.0, 1.0]], (10, 1)).astype(np.float32))
    c0 = transforms.eval_sh(dc, sh, dirs, degree=0)
    np.testing.assert_allclose(np.asarray(c0),
                               np.asarray(transforms.dc_to_color(dc)), rtol=1e-6)


def test_degree1_analytic():
    """Single degree-1 z coefficient: c = (0.5 + C0*dc + C1*z*sh_z) * 255."""
    dc = jnp.zeros((1, 3))
    sh = jnp.zeros((1, 45))
    # channel-major f_rest layout: channel ch, coeff k at index ch*15 + k;
    # coeff index 1 is the degree-1 z term
    sh = sh.at[0, 0 * 15 + 1].set(1.0)     # red channel, z coefficient
    for z in (1.0, -1.0, 0.5):
        d = jnp.asarray([[0.0, 0.0, z]])
        c = np.asarray(transforms.eval_sh(dc, sh, d, degree=1))
        want_r = (0.5 + transforms.SH_C1 * z) * 255.0
        assert np.isclose(c[0, 0], want_r, rtol=1e-5), (z, c)
        assert np.isclose(c[0, 1], 127.5, rtol=1e-5)  # green untouched


def test_render_view_dependence():
    """A splat with a strong degree-1 coefficient must change colour when
    rendered from opposite sides; degree 0 must not."""
    scene = ply_io.single_splat_scene()
    sh = np.zeros((1, 45), np.float32)
    sh[0, 0 * 15 + 1] = 1.2   # red varies with view z
    scene["sh_rest"] = sh

    cfg_sh = dataclasses.replace(BASE, dup_capacity_factor=256.0, sh_degree=3)
    cfg_dc = dataclasses.replace(BASE, dup_capacity_factor=256.0, sh_degree=0)

    def render(cam, cfg):
        a = camera_args(cam)
        params = {k: jnp.asarray(v) for k, v in scene.items()}
        img, _ = render_arrays(params, jnp.asarray(a["view"]), jnp.asarray(a["vp"]),
                               a["focal_x"], a["focal_y"], a["tan_fovx"],
                               a["tan_fovy"], 64, 64, cfg)
        return np.asarray(img)

    front = Camera(0.0, 0.0, -3.0, width=64, height=64)
    back = Camera(0.0, 0.0, 3.0, width=64, height=64)
    back.set_rotation(0.0, 180.0, 0.0)

    f_sh, b_sh = render(front, cfg_sh), render(back, cfg_sh)
    f_dc, b_dc = render(front, cfg_dc), render(back, cfg_dc)
    # both views must show the splat
    assert f_sh[..., 3].max() > 0.3 and b_sh[..., 3].max() > 0.3
    red_f = f_sh[..., 0].max()
    red_b = b_sh[..., 0].max()
    assert abs(red_f - red_b) > 0.2, (red_f, red_b)
    np.testing.assert_allclose(f_dc[..., 0].max(), b_dc[..., 0].max(), atol=0.02)


def test_sh_gradients_flow():
    scene = ply_io.make_synthetic_scene(15, seed=3, extent=1.0)
    rng = np.random.default_rng(2)
    scene["sh_rest"] = rng.normal(0, 0.2, (15, 45)).astype(np.float32)
    cfg = dataclasses.replace(BASE, sh_degree=2)
    cam = Camera(0.0, 0.0, -4.0, width=64, height=64)
    a = camera_args(cam)
    params = {k: jnp.asarray(v) for k, v in scene.items()}

    def loss(p):
        img, _ = render_arrays(p, jnp.asarray(a["view"]), jnp.asarray(a["vp"]),
                               a["focal_x"], a["focal_y"], a["tan_fovx"],
                               a["tan_fovy"], 64, 64, cfg)
        return jnp.mean(img[..., :3] ** 2)

    g = jax.grad(loss)(params)
    assert np.abs(np.asarray(g["sh_rest"])).max() > 0
    assert np.all(np.isfinite(np.asarray(g["sh_rest"])))


def test_fastpath_sh_matches_oracle():
    scene = ply_io.make_synthetic_scene(40, seed=5, extent=1.5)
    scene["sh_rest"] = np.random.default_rng(4).normal(
        0, 0.3, (40, 45)).astype(np.float32)
    cfg_j = dataclasses.replace(BASE, sh_degree=3, chunk=64, max_per_tile=512)
    cfg_p = dataclasses.replace(cfg_j, use_pallas=True)
    cam = Camera(0.0, 0.0, -4.0, width=64, height=64)
    a = camera_args(cam)
    params = {k: jnp.asarray(v) for k, v in scene.items()}

    def render(cfg):
        img, _ = render_arrays(params, jnp.asarray(a["view"]), jnp.asarray(a["vp"]),
                               a["focal_x"], a["focal_y"], a["tan_fovx"],
                               a["tan_fovy"], 64, 64, cfg)
        return np.asarray(img)

    np.testing.assert_allclose(render(cfg_p), render(cfg_j), atol=2e-5)
