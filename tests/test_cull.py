"""Ellipse-reachability cull (expand kernel): output-exactness + effect.

The reference bins every tile of a splat's 3-sigma AABB
(``shaders/preprocess.glsl`` tile loop) and relies on ``draw.glsl``'s
per-pixel alpha cutoff; our expand kernel culls records that cannot reach
alpha_min anywhere in their tile. These tests assert the cull (a) actually
removes records on realistic scenes and (b) never changes the rendered
image or the gradients vs the non-culling oracle path -- including on
adversarial anisotropic and near-cutoff-opacity scenes where a wrong
(non-conservative) rect minimum would drop a contributing record.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays

W = H = 256


def _cfgs(**kw):
    cfg_p = RenderConfig.for_resolution(
        W, H, tile_px=32, use_pallas=True, chunk=128,
        dup_capacity_factor=16.0, **kw)
    cfg_j = dataclasses.replace(cfg_p, use_pallas=False, max_per_tile=1024)
    return cfg_p, cfg_j


def _render(scene, cfg, grad=False):
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -6.0, width=W, height=H)
    a = camera_args(cam)
    args = (jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H)

    if grad:
        def loss(p):
            img, _ = render_arrays(p, *args, cfg)
            return jnp.mean(img[..., :3] ** 2)

        return jax.grad(loss)(params)
    img, stats = render_arrays(params, *args, cfg)
    return np.asarray(img), stats


def test_cull_removes_records_and_is_output_exact():
    # tight_rect=False: measure the per-record kernel cull against the
    # reference's full 3-sigma-square allocation (with tight_rect on, most
    # unreachable tiles are never allocated, so there is little left to cull).
    scene = ply_io.make_synthetic_scene(3000, seed=21, extent=2.5)
    cfg_p, cfg_j = _cfgs(tight_rect=False)
    img_p, stats = _render(scene, cfg_p)
    img_j, _ = _render(scene, cfg_j)
    culled = int(stats["culled_unreachable"])
    total = int(stats["num_records"])
    assert culled > 0.1 * total, (culled, total)
    np.testing.assert_allclose(img_p, img_j, atol=1e-4)


def test_tight_rect_shrinks_allocation_output_exact():
    """tight_rect performs the same cull at allocation time: fewer records
    ever exist, and the image matches both the loose-rect Pallas path and
    the jnp oracle exactly."""
    scene = ply_io.make_synthetic_scene(3000, seed=21, extent=2.5)
    cfg_tight, cfg_j = _cfgs()
    cfg_loose = dataclasses.replace(cfg_tight, tight_rect=False)
    img_t, stats_t = _render(scene, cfg_tight)
    img_l, stats_l = _render(scene, cfg_loose)
    img_j, _ = _render(scene, cfg_j)
    assert int(stats_t["num_records"]) < int(stats_l["num_records"])
    np.testing.assert_allclose(img_t, img_l, atol=1e-5)
    np.testing.assert_allclose(img_t, img_j, atol=1e-4)


def test_cull_exact_on_anisotropic_scene():
    """Elongated splats: AABB corner tiles + strong conic cross terms --
    the regime where a sloppy rect minimum would mis-cull."""
    rng = np.random.default_rng(9)
    n = 400
    scene = ply_io.make_synthetic_scene(n, seed=9, extent=2.0)
    scales = np.stack([
        rng.uniform(-2.5, -1.5, n),     # long axis
        rng.uniform(-5.5, -4.5, n),     # thin axis
        rng.uniform(-4.0, -3.0, n),
    ], axis=1).astype(np.float32)
    scene["scales"] = scales
    # op ~ 0.18: the 3-sigma AABB then exceeds the alpha-reachable radius
    # sqrt(2 ln(op/alpha_min)) sigma ~ 2.8 sigma, so corner tiles can cull
    # (op > ~0.35 makes every AABB tile reachable -- nothing would cull)
    scene["opacities"] = np.full(n, -1.5, np.float32)
    cfg_p, cfg_j = _cfgs(tight_rect=False)
    img_p, stats = _render(scene, cfg_p)
    img_j, _ = _render(scene, cfg_j)
    assert int(stats["culled_unreachable"]) > 0
    np.testing.assert_allclose(img_p, img_j, atol=1e-4)


def test_cull_exact_near_alpha_cutoff():
    """Opacities just above alpha_min: nearly every pair is borderline, so
    the conservative margin is what keeps the cull output-exact."""
    n = 300
    scene = ply_io.make_synthetic_scene(n, seed=13, extent=2.0)
    # activation is sigmoid(raw); alpha_min = 1/255 -> raw ~ logit(0.006)
    scene["opacities"] = np.full(n, -5.1, np.float32)
    cfg_p, cfg_j = _cfgs(tight_rect=False)
    img_p, stats = _render(scene, cfg_p)
    img_j, _ = _render(scene, cfg_j)
    # near the cutoff almost everything is unreachable
    assert int(stats["culled_unreachable"]) > 0.5 * int(stats["num_records"])
    np.testing.assert_allclose(img_p, img_j, atol=1e-4)


@pytest.mark.slow
def test_cull_grad_parity():
    scene = ply_io.make_synthetic_scene(500, seed=17, extent=2.5)
    cfg_p, cfg_j = _cfgs()
    g_p = _render(scene, cfg_p, grad=True)
    g_j = _render(scene, cfg_j, grad=True)
    for k in g_p:
        gp, gj = np.asarray(g_p[k]), np.asarray(g_j[k])
        scale = np.abs(gj).max() + 1e-12
        assert np.abs(gp - gj).max() / scale < 1e-3, k
