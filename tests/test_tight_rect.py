"""cfg.tight_rect: opacity-aware ellipse-AABB tile rectangles.

The reference bins every tile of the 3-sigma bounding square
(``shaders/preprocess.glsl:139-149``) and relies on ``draw.glsl:118-126``'s
per-pixel ``alpha >= alpha_min`` cutoff. The set of pixels that can pass
that cutoff is the ellipse d^T conic d <= 2 ln(opacity/alpha_min), whose
axis-aligned half-extents are sqrt(2L * Sigma2D_xx/yy); a tile strictly
outside that AABB contains no blendable pixel, so never allocating its
record is image-exact -- it only shrinks the record sort / capacity.

Tests: (a) the tightening only shrinks rectangles and does shrink them on
realistic scenes, (b) the safety property by brute force -- every pixel
that can pass the alpha test still lies in a tile of the tight rectangle,
(c) images and gradients unchanged (to float-reassociation noise: removal
shifts later records' lane positions) on the oracle and Pallas paths,
(d) opacity below alpha_min allocates nothing.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops import projection
from openglgaussiansplattingrenderer_jax.ops.compositing import padded_dims
from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays

W = H = 128


def _scene(n=200, seed=3):
    """Anisotropic splats with an opacity spread reaching below alpha_min."""
    rng = np.random.default_rng(seed)
    scene = ply_io.make_synthetic_scene(n, seed=seed, extent=2.0)
    scene["scales"] = np.exp(np.stack([
        rng.uniform(-2.2, -1.2, n),          # long axis
        rng.uniform(-4.5, -3.5, n),          # thin axis
        rng.uniform(-3.5, -2.5, n),
    ], axis=1)).astype(np.float32)
    scene["opacities"] = rng.uniform(0.002, 0.9, n).astype(np.float32)
    return scene


def _prep(scene, cfg, width=W, height=H):
    cam = Camera(0.0, 0.0, -6.0, width=width, height=height)
    a = camera_args(cam)
    return projection.preprocess(
        jnp.asarray(scene["means"]),
        build_covariance(jnp.asarray(scene["scales"]), jnp.asarray(scene["quats"])),
        jnp.asarray(scene["opacities"]),
        jnp.asarray(a["view"]), jnp.asarray(a["vp"]), width, height,
        a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"], cfg)


def test_rect_shrinks_and_covers_all_blendable_pixels():
    scene = _scene()
    cfg_t = RenderConfig.for_resolution(W, H, tile_px=16, tight_rect=True)
    cfg_l = dataclasses.replace(cfg_t, tight_rect=False)
    pt = {k: np.asarray(v) for k, v in _prep(scene, cfg_t).items()}
    pl_ = {k: np.asarray(v) for k, v in _prep(scene, cfg_l).items()}

    # (a) subset: tight rect inside loose rect, counts only shrink
    live = pt["counts"] > 0
    assert np.all(pt["tile_min"][live] >= pl_["tile_min"][live])
    tmax_t = pt["tile_min"] + pt["tile_ext"]
    tmax_l = pl_["tile_min"] + pl_["tile_ext"]
    assert np.all(tmax_t[live] <= tmax_l[live])
    assert np.all(pt["counts"] <= pl_["counts"])
    assert int(pt["counts"].sum()) < int(pl_["counts"].sum())  # does shrink

    # (b) safety, brute force: every pixel that can pass the alpha test is in
    # a tile of the tight rect (tiles = the compositor's padded-pitch blocks)
    wp, hp = padded_dims(W, H, cfg_t)
    pw, ph = wp // cfg_t.grid_x, hp // cfg_t.grid_y
    px, py = np.meshgrid(np.arange(wp, dtype=np.float32),
                         np.arange(hp, dtype=np.float32))
    for i in range(len(scene["means"])):
        if not pt["valid"][i]:
            continue
        dx = px - pt["mean2d"][i, 0]
        dy = py - pt["mean2d"][i, 1]
        ca, cb, cc = pt["conic"][i]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = np.minimum(cfg_t.alpha_max,
                           np.exp(power) * scene["opacities"][i])
        ys, xs = np.nonzero((power <= 0.0) & (alpha >= cfg_t.alpha_min))
        if len(ys) == 0:
            continue
        assert pt["counts"][i] > 0, i   # blendable pixels => allocated
        tx = xs // pw
        ty = ys // ph
        x0, y0 = pt["tile_min"][i]
        ex, ey = pt["tile_ext"][i]
        assert tx.min() >= x0 and tx.max() < x0 + ex, i
        assert ty.min() >= y0 and ty.max() < y0 + ey, i


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


def test_image_and_grads_exact_oracle_path():
    scene = _scene(n=300, seed=11)
    cfg_t = RenderConfig.for_resolution(
        W, H, tile_px=16, use_pallas=False, max_per_tile=2048,
        dup_capacity_factor=24.0, tight_rect=True)
    cfg_l = dataclasses.replace(cfg_t, tight_rect=False)
    img_t, st = _render(scene, cfg_t)
    img_l, sl = _render(scene, cfg_l)
    assert int(st["overflow"]) == 0 and int(sl["overflow"]) == 0
    assert int(st["num_records"]) < int(sl["num_records"])
    # dropped records contribute alpha == 0 exactly; removal shifts later
    # records' lane/slot positions, so sums reassociate at the ~1e-7 level
    # (same class as tests/test_cull.py) -- no semantic difference
    np.testing.assert_allclose(img_t, img_l, atol=1e-4)
    gt = _render(scene, cfg_t, grad=True)
    gl = _render(scene, cfg_l, grad=True)
    for k in gt:
        a, b = np.asarray(gt[k]), np.asarray(gl[k])
        scale = np.abs(b).max() + 1e-12
        assert np.abs(a - b).max() / scale < 1e-3, k


def test_image_exact_pallas_path():
    scene = _scene(n=300, seed=12)
    cfg_t = RenderConfig.for_resolution(
        W, H, tile_px=32, use_pallas=True, chunk=128,
        dup_capacity_factor=24.0, tight_rect=True)
    cfg_l = dataclasses.replace(cfg_t, tight_rect=False)
    img_t, st = _render(scene, cfg_t)
    img_l, sl = _render(scene, cfg_l)
    assert int(st["overflow"]) == 0 and int(sl["overflow"]) == 0
    assert int(st["num_records"]) < int(sl["num_records"])
    np.testing.assert_allclose(img_t, img_l, atol=1e-4)


def test_opacity_below_cutoff_allocates_nothing():
    scene = _scene(n=50, seed=5)
    # all below alpha_min = 1/255 ~ 0.00392: nothing can ever blend
    scene["opacities"] = np.full(50, 0.003, np.float32)
    cfg_t = RenderConfig.for_resolution(W, H, tile_px=16, tight_rect=True)
    prep = _prep(scene, cfg_t)
    assert int(jnp.sum(prep["counts"])) == 0
