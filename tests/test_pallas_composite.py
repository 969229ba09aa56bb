"""Pallas (Triton) fused compositor vs the jnp compositor.

On the CPU the kernels run in the interpreter; the ``gpu`` test runs them
compiled. Forward images and full parameter gradients must match; the jnp
path's autodiff is the gradient oracle for the kernels' analytic backward.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops import fastpath
from openglgaussiansplattingrenderer_jax.ops.compositing import composite_tiles_jnp
from openglgaussiansplattingrenderer_jax.ops.pallas import composite as pc
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays

BASE = RenderConfig(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)


def _run(scene, cam, cfg, width, height, grad=False, target=None):
    args = camera_args(cam)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}

    def fwd(p):
        img, stats = render_arrays(
            p, jnp.asarray(args["view"]), jnp.asarray(args["vp"]),
            args["focal_x"], args["focal_y"], args["tan_fovx"], args["tan_fovy"],
            width, height, cfg,
        )
        return img, stats

    if not grad:
        img, stats = fwd(params)
        return np.asarray(img), stats

    def loss(p):
        img, _ = fwd(p)
        return jnp.mean((img[..., :3] - target) ** 2) + 0.1 * jnp.mean(img[..., 3])

    val, grads = jax.value_and_grad(loss)(params)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("seed,n,w,h", [(3, 150, 128, 128), (9, 400, 128, 64)])
def test_pallas_forward_matches_jnp(seed, n, w, h):
    scene = ply_io.make_synthetic_scene(n, seed=seed, extent=2.0)
    cam = Camera(0.0, 0.0, -6.0, width=w, height=h)
    cfg_j = dataclasses.replace(BASE, use_pallas=False)
    cfg_p = dataclasses.replace(BASE, use_pallas=True)
    img_j, stats_j = _run(scene, cam, cfg_j, w, h)
    img_p, stats_p = _run(scene, cam, cfg_p, w, h)
    assert int(stats_j["overflow"]) == 0 and int(stats_j["dropped_by_cap"]) == 0
    np.testing.assert_allclose(img_p, img_j, atol=2e-5)


def test_pallas_forward_single_splat():
    scene = ply_io.single_splat_scene()
    cam = Camera(0.0, 0.0, -3.0, width=256, height=256)
    cfg_j = RenderConfig(use_pallas=False, max_per_tile=256, chunk=64,
                         dup_capacity_factor=256.0)
    cfg_p = dataclasses.replace(cfg_j, use_pallas=True)
    img_j, _ = _run(scene, cam, cfg_j, 256, 256)
    img_p, _ = _run(scene, cam, cfg_p, 256, 256)
    assert img_p[..., 3].max() > 0.5
    np.testing.assert_allclose(img_p, img_j, atol=2e-5)


def test_pallas_backward_matches_jnp_autodiff():
    w = h = 64
    scene = ply_io.make_synthetic_scene(60, seed=21, extent=1.5)
    scene["opacities"] = np.clip(scene["opacities"], 0.2, 0.8)
    cam = Camera(0.0, 0.0, -5.0, width=w, height=h)
    target = jnp.full((h, w, 3), 0.2)
    cfg_j = dataclasses.replace(BASE, use_pallas=False)
    cfg_p = dataclasses.replace(BASE, use_pallas=True)
    loss_j, g_j = _run(scene, cam, cfg_j, w, h, grad=True, target=target)
    loss_p, g_p = _run(scene, cam, cfg_p, w, h, grad=True, target=target)
    assert np.isclose(loss_p, loss_j, rtol=1e-5)
    for k in g_j:
        np.testing.assert_allclose(
            g_p[k], g_j[k], rtol=2e-3, atol=1e-6,
            err_msg=f"gradient mismatch for {k}")


def test_pallas_backward_saturated_scene():
    """Heavy overdraw: the early-exit path and saturation masks in backward."""
    w = h = 32
    scene = ply_io.make_synthetic_scene(120, seed=4, extent=0.4)
    scene["opacities"] = np.full(120, 0.95, np.float32)  # saturate fast
    scene["scales"] = np.full((120, 3), 0.15, np.float32)
    cam = Camera(0.0, 0.0, -2.0, width=w, height=h)
    target = jnp.zeros((h, w, 3))
    # Big-splat overdraw: ~64 tiles/splat. Capacity must cover the expansion:
    # under overflow the two paths drop different records by design (array
    # order vs depth order; see ops/fastpath.py docstring).
    cfg_j = dataclasses.replace(BASE, use_pallas=False, max_per_tile=2048,
                                dup_capacity_factor=80.0)
    cfg_p = dataclasses.replace(BASE, use_pallas=True, dup_capacity_factor=80.0)
    img_p, stats_p = _run(scene, cam, cfg_p, w, h)
    assert int(stats_p["overflow"]) == 0
    loss_j, g_j = _run(scene, cam, cfg_j, w, h, grad=True, target=target)
    loss_p, g_p = _run(scene, cam, cfg_p, w, h, grad=True, target=target)
    assert np.isclose(loss_p, loss_j, rtol=1e-4)
    for k in g_j:
        np.testing.assert_allclose(
            g_p[k], g_j[k], rtol=5e-3, atol=2e-6,
            err_msg=f"gradient mismatch for {k}")


def _sorted(scene, cam, cfg, w, h):
    args = camera_args(cam)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    return fastpath.sort_records(
        params, jnp.asarray(args["view"]), jnp.asarray(args["vp"]),
        args["focal_x"], args["focal_y"], args["tan_fovx"], args["tan_fovy"],
        w, h, cfg)


@pytest.mark.parametrize("chunk,block_pixels,w,h,gx,gy", [
    (16, 256, 64, 64, 16, 16),   # 4x4-px tiles: one 16-pixel block
    (32, 64, 96, 96, 4, 4),      # 24x24 tiles: 576 px padded to 1024
    (8, 128, 100, 60, 5, 3),     # 20x20 tiles, uneven image
])
def test_kernel_shapes_match_jnp(chunk, block_pixels, w, h, gx, gy):
    """The wrapper's pixel padding, pixel blocks and record chunks: forward
    tiles and record cotangents equal the jnp compositor's on the same
    sorted records."""
    scene = ply_io.make_synthetic_scene(120, seed=11, extent=1.5)
    scene["opacities"] = np.clip(scene["opacities"], 0.2, 0.9)
    cam = Camera(0.0, 0.0, -5.0, width=w, height=h)
    cfg = RenderConfig(grid_x=gx, grid_y=gy, chunk=chunk, max_per_tile=2048,
                       dup_capacity_factor=64.0)
    sf2, bounds, info = _sorted(scene, cam, cfg, w, h)
    assert int(info["total_all"]) <= cfg.capacity(120)
    tiles = jnp.arange(cfg.num_tiles, dtype=jnp.int32)
    ct = jax.random.normal(jax.random.PRNGKey(1),
                           composite_tiles_jnp(sf2, bounds, w, h, cfg).shape)

    def tri(s):
        return pc.composite_tiles(s, bounds, tiles, w, h, cfg, chunk=chunk,
                                  block_pixels=block_pixels)

    def ref(s):
        return composite_tiles_jnp(s, bounds, w, h, cfg)

    np.testing.assert_allclose(np.asarray(tri(sf2)), np.asarray(ref(sf2)),
                               atol=1e-3)
    g_t = jax.grad(lambda s: jnp.vdot(tri(s), ct))(sf2)
    g_j = jax.grad(lambda s: jnp.vdot(ref(s), ct))(sf2)
    for k, (a, b) in enumerate(zip(g_t, g_j)):
        scale = np.abs(np.asarray(b)).max() + 1e-12
        assert np.abs(np.asarray(a) - np.asarray(b)).max() / scale < 1e-4, k


def test_kernel_chunk_is_its_own():
    """cfg.chunk sets the jnp compositor's scan step only: the kernel streams
    records in chunks of pc.CHUNK whatever it says."""
    w = h = 64
    scene = ply_io.make_synthetic_scene(80, seed=5, extent=1.5)
    cam = Camera(0.0, 0.0, -5.0, width=w, height=h)
    cfg = RenderConfig(grid_x=4, grid_y=4, chunk=8, dup_capacity_factor=32.0)
    sf2, bounds, _ = _sorted(scene, cam, cfg, w, h)
    tiles = jnp.arange(cfg.num_tiles, dtype=jnp.int32)
    got = [np.asarray(pc.composite_tiles(sf2, bounds, tiles, w, h,
                                         dataclasses.replace(cfg, chunk=c)))
           for c in (8, 256)]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(
        got[0], np.asarray(pc.composite_tiles(sf2, bounds, tiles, w, h, cfg,
                                              chunk=pc.CHUNK)))
    assert RenderConfig().chunk == 256 and pc.CHUNK == 32


def test_pixel_blocks_and_chunk_rule():
    assert [pc.next_pow2(x) for x in (1, 2, 3, 16, 17, 576)] == \
        [1, 2, 4, 16, 32, 1024]
    assert pc.pixel_blocks(32, 32, 256) == (1024, 256, 4)
    assert pc.pixel_blocks(4, 4, 256) == (16, 16, 1)
    assert pc.pixel_blocks(24, 24, 200) == (1024, 256, 4)
    for bad in (0, 12, 48):
        with pytest.raises(ValueError, match="power-of-two"):
            pc.check_chunk(bad)
    pc.check_chunk(1)
    pc.check_chunk(64)


@pytest.mark.gpu
def test_compiled_kernel_matches_jnp_on_gpu(gpu):
    """The compiled Triton kernels (not the interpreter) against the jnp
    compositor, forward and record cotangents."""
    w = h = 128
    scene = ply_io.make_synthetic_scene(2000, seed=2, extent=2.0)
    cam = Camera(0.0, 0.0, -6.0, width=w, height=h)
    cfg = RenderConfig.for_resolution(w, h, tile_px=32, max_per_tile=4096,
                                      dup_capacity_factor=24.0)
    sf2, bounds, _ = jax.jit(lambda: _sorted(scene, cam, cfg, w, h))()
    tiles = jnp.arange(cfg.num_tiles, dtype=jnp.int32)
    with jax.default_matmul_precision("highest"):
        ref = composite_tiles_jnp(sf2, bounds, w, h, cfg)
    got = pc.composite_tiles(sf2, bounds, tiles, w, h, cfg)
    # colour-scale units: 0.255 is 1e-3 of the image range
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=0.255)


def test_no_hoist_depth_sort_matches_hoisted():
    """cfg.hoist_depth_sort=False (single lexicographic (tile, depth) record
    sort, no N-sized depth pre-sort) must reproduce the round-2 two-sort
    design exactly -- image AND gradients -- under zero overflow. Exactness
    holds because stable sorts resolve (tile, depth) ties to original splat
    order in both designs."""
    w = h = 96
    scene = ply_io.make_clustered_scene(500, seed=21, extent=2.0)
    cam = Camera(0.0, 0.0, -6.0, width=w, height=h)
    target = np.zeros((h, w, 3), np.float32)

    cfg_h = dataclasses.replace(BASE, use_pallas=True, hoist_depth_sort=True)
    cfg_n = dataclasses.replace(BASE, use_pallas=True, hoist_depth_sort=False)
    img_h, stats_h = _run(scene, cam, cfg_h, w, h)
    img_n, stats_n = _run(scene, cam, cfg_n, w, h)
    assert int(stats_h["overflow"]) == 0
    assert int(stats_n["num_records"]) == int(stats_h["num_records"])
    np.testing.assert_array_equal(img_n, img_h)

    loss_h, g_h = _run(scene, cam, cfg_h, w, h, grad=True, target=target)
    loss_n, g_n = _run(scene, cam, cfg_n, w, h, grad=True, target=target)
    assert np.isclose(loss_n, loss_h, rtol=1e-6)
    for k in g_h:
        np.testing.assert_allclose(g_n[k], g_h[k], rtol=1e-6, atol=1e-9,
                                   err_msg=f"gradient mismatch for {k}")


def test_packed_depth_key_matches_pair_mode():
    """depth_key="packed" (single u32 tile<<22|qdepth key) must reproduce
    the exact "pair" mode wherever same-tile depths don't collide within a
    2^-22 bucket -- which a random continuous scene never does."""
    w = h = 96
    scene = ply_io.make_clustered_scene(600, seed=13, extent=2.0)
    cam = Camera(0.0, 0.0, -6.0, width=w, height=h)
    cfg_pair = dataclasses.replace(BASE, use_pallas=True,
                                   hoist_depth_sort=False, depth_key="pair")
    cfg_pack = dataclasses.replace(cfg_pair, depth_key="packed")
    img_a, stats_a = _run(scene, cam, cfg_pair, w, h)
    img_b, stats_b = _run(scene, cam, cfg_pack, w, h)
    assert int(stats_a["overflow"]) == 0
    assert int(stats_b["binned_records"]) == int(stats_a["binned_records"])
    np.testing.assert_array_equal(img_b, img_a)

    # gradients ride the same sorted layout: also identical
    target = np.zeros((h, w, 3), np.float32)
    loss_a, g_a = _run(scene, cam, cfg_pair, w, h, grad=True, target=target)
    loss_b, g_b = _run(scene, cam, cfg_pack, w, h, grad=True, target=target)
    assert np.isclose(loss_b, loss_a, rtol=1e-6)
    for k in g_a:
        np.testing.assert_allclose(g_b[k], g_a[k], rtol=1e-6, atol=1e-9)
