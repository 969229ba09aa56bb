"""Expected-depth rendering (render.render_depth) -- capability beyond the
reference (it renders RGB only, draw.glsl:141-142). Depth rides the normal
colour pipeline (weights are linear in colour), so it must agree between the
Pallas fast path and the jnp oracle, match the analytic value on a single
splat, and stay differentiable.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.render import camera_args, render_depth
from openglgaussiansplattingrenderer_jax.splats import Splats

W = H = 128


def _args(cam):
    a = camera_args(cam)
    return (jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H)


def _cfgs(**kw):
    cfg_p = RenderConfig.for_resolution(
        W, H, tile_px=32, use_pallas=True, chunk=64,
        dup_capacity_factor=16.0, **kw)
    cfg_j = dataclasses.replace(cfg_p, use_pallas=False, max_per_tile=512)
    return cfg_p, cfg_j


def test_depth_pallas_matches_oracle():
    scene = ply_io.make_synthetic_scene(800, seed=5, extent=2.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -6.0, width=W, height=H)
    cfg_p, cfg_j = _cfgs()
    d_p, a_p, _ = render_depth(params, *_args(cam), cfg_p)
    d_j, a_j, _ = render_depth(params, *_args(cam), cfg_j)
    np.testing.assert_allclose(np.asarray(d_p), np.asarray(d_j), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_j), atol=1e-5)


def test_depth_single_splat_analytic():
    """One splat: every covered pixel's normalized expected depth equals the
    splat's own depth value exactly (sum w*d / sum w == d)."""
    scene = ply_io.make_synthetic_scene(1, seed=0, extent=0.0)
    scene["means"] = np.array([[0.0, 0.0, 0.0]], np.float32)
    scene["opacities"] = np.array([0.9], np.float32)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -3.0, width=W, height=H)
    _, cfg_j = _cfgs()

    for mode in ("ndc", "view"):
        depth, alpha, _ = render_depth(params, *_args(cam), cfg_j, mode=mode)
        depth, alpha = np.asarray(depth), np.asarray(alpha)
        covered = alpha > 1e-3
        assert covered.sum() > 50
        vals = depth[covered]
        # all covered pixels agree, and with the splat's actual depth
        assert np.ptp(vals) < 1e-4, (mode, float(np.ptp(vals)))
        view = np.asarray(camera_args(cam)["view"], np.float32)
        vp = np.asarray(camera_args(cam)["vp"], np.float32)
        p = (vp if mode == "ndc" else view) @ np.array([0, 0, 0, 1], np.float32)
        expect = (p[2] / p[3] + 1) / 2 if mode == "ndc" else p[2]
        np.testing.assert_allclose(vals.mean(), expect, atol=1e-4)


def test_depth_ordering_two_splats():
    """The nearer of two stacked opaque splats dominates the blended depth."""
    scene = ply_io.make_synthetic_scene(2, seed=0, extent=0.0)
    scene["means"] = np.array([[0, 0, -1.0], [0, 0, 1.0]], np.float32)
    scene["opacities"] = np.array([0.95, 0.95], np.float32)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    _, cfg_j = _cfgs()
    depth, alpha, _ = render_depth(params, *_args(cam), cfg_j, mode="ndc")
    depth, alpha = np.asarray(depth), np.asarray(alpha)
    c = depth[H // 2, W // 2]
    view, vp = camera_args(cam)["view"], camera_args(cam)["vp"]
    z = lambda m: float(((np.asarray(vp, np.float32)
                          @ np.array([*m, 1], np.float32))[2]
                         / (np.asarray(vp, np.float32)
                            @ np.array([*m, 1], np.float32))[3] + 1) / 2)
    # The reference camera's R*T(+pos) view quirk decides which world z is
    # nearer; take it from the NDC values (the sorter's own order) instead
    # of assuming.
    z_a, z_b = z([0, 0, -1.0]), z([0, 0, 1.0])
    z_near, z_far = min(z_a, z_b), max(z_a, z_b)
    # blended depth sits between the two, much closer to the near splat
    assert z_near - 1e-5 <= c <= z_far
    assert abs(c - z_near) < 0.25 * (z_far - z_near)


def test_depth_differentiable():
    scene = ply_io.make_synthetic_scene(50, seed=11, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    _, cfg_j = _cfgs()
    args = _args(cam)

    def loss(p):
        depth, alpha, _ = render_depth(p, *args, cfg_j, normalize=False)
        return jnp.mean(depth ** 2)

    g = jax.grad(loss)(params)
    for k, v in g.items():
        assert bool(jnp.all(jnp.isfinite(v))), k
    assert float(jnp.abs(g["means"]).max()) > 0.0


def test_depth_facade(single_item_ply):
    s = Splats(single_item_ply, W, H,
               cfg=RenderConfig(use_pallas=False, dup_capacity_factor=256.0,
                                max_per_tile=256, chunk=64))
    cam = Camera(0, 0, -3.0, width=W, height=H)
    depth, alpha = s.render_depth_camera(cam)
    assert depth.shape == (H, W) and alpha.shape == (H, W)
    assert alpha.max() > 0.5
    assert np.isfinite(depth).all()
