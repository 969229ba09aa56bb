"""End-to-end render vs the golden numpy pipeline (oracle pattern #1).

The JAX pipeline (vectorized jnp, parallel masked compositing, pair-key sort)
must agree with the golden pipeline (literal GLSL math, Python-loop
duplication, sequential blending, packed-float-key sort) to float tolerance --
the same CPU-vs-GPU buffer assertion strategy as ``Splats.cpp:783-843``
(tolerance 0.01 there).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openglgaussiansplattingrenderer_jax import golden
from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays
from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance


def _render_both(scene, cam, cfg, width, height):
    args = camera_args(cam)
    params = {
        "means": jnp.asarray(scene["means"]),
        "scales": jnp.asarray(scene["scales"]),
        "quats": jnp.asarray(scene["quats"]),
        "opacities": jnp.asarray(scene["opacities"]),
        "colors": jnp.asarray(scene["colors"]),
    }
    img_jax, stats = render_arrays(
        params, jnp.asarray(args["view"]), jnp.asarray(args["vp"]),
        args["focal_x"], args["focal_y"], args["tan_fovx"], args["tan_fovy"],
        width, height, cfg,
    )
    gparams = {
        "means": scene["means"],
        "cov6": np.asarray(build_covariance(scene["scales"], scene["quats"])),
        "opacities": scene["opacities"], "colors": scene["colors"],
    }
    img_gold, dbg = golden.golden_render(
        gparams, args["view"], args["vp"], args["focal_x"], args["focal_y"],
        args["tan_fovx"], args["tan_fovy"], width, height, cfg,
    )
    return np.asarray(img_jax), stats, img_gold, dbg


@pytest.fixture(scope="module")
def cfg():
    # Generous record capacity: synthetic test splats overlap many 8px tiles.
    return RenderConfig(use_pallas=False, max_per_tile=1024, chunk=64,
                        dup_capacity_factor=24.0)


def test_single_splat_256(cfg):
    """Milestone A scene: testSingleItem.ply at 256x256 (the reference fixture).

    The splat's 222px radius overlaps all 256 tiles, so capacity must cover
    the full grid (the reference would cap duplicates at numSplats=1 here,
    blanking 254 tiles -- a quirk we do not replicate; QUIRKS.md)."""
    scene = ply_io.single_splat_scene()
    cam = Camera(0.0, 0.0, -3.0, width=256, height=256)
    cfg1 = RenderConfig(use_pallas=False, max_per_tile=256, chunk=64,
                        dup_capacity_factor=256.0)
    img_jax, stats, img_gold, _ = _render_both(scene, cam, cfg1, 256, 256)
    assert img_jax.shape == (256, 256, 4)
    # the splat must actually be visible
    assert img_gold[..., 3].max() > 0.5
    np.testing.assert_allclose(img_jax, img_gold, atol=1e-3)
    # white splat: channels equal, brightest at the projected centre (128,128)
    ys, xs = np.nonzero(img_gold[..., 3] > 0.1)
    np.testing.assert_allclose(img_gold[ys, xs, 0], img_gold[ys, xs, 1], atol=1e-6)
    c = img_gold[..., 3]
    peak = np.unravel_index(np.argmax(c), c.shape)
    assert abs(peak[0] - 128) <= 1 and abs(peak[1] - 128) <= 1


def test_red_splat_anisotropy(cfg):
    """The generator's red anisotropic Gaussian (plyFileGenerator.py:251-265)."""
    scene = ply_io.red_splat_scene()
    cam = Camera(0.0, 0.0, -3.0, width=256, height=256)
    cfg1 = RenderConfig(use_pallas=False, max_per_tile=256, chunk=64,
                        dup_capacity_factor=256.0)
    img_jax, stats, img_gold, _ = _render_both(scene, cam, cfg1, 256, 256)
    np.testing.assert_allclose(img_jax, img_gold, atol=1e-3)
    # red channel vs green: exactly the DC activation ratio
    # (0.5 + SH_C0)/(0.5) since f_dc = (1, 0, 0) and the 0.5 offset is grey.
    ys, xs = np.nonzero(img_gold[..., 3] > 0.1)
    ratio = img_gold[ys, xs, 0].mean() / img_gold[ys, xs, 1].mean()
    assert np.isclose(ratio, (0.5 + 0.28209479177387814) / 0.5, rtol=0.01)


def test_random_scene_128(cfg, rng):
    scene = ply_io.make_synthetic_scene(300, seed=7, extent=2.0)
    cam = Camera(0.0, 0.0, -6.0, width=128, height=128)
    img_jax, stats, img_gold, dbg = _render_both(scene, cam, cfg, 128, 128)
    assert int(stats["overflow"]) == 0
    assert int(stats["dropped_by_cap"]) == 0
    np.testing.assert_allclose(img_jax, img_gold, atol=2e-3)


def test_nontrivial_camera(cfg):
    scene = ply_io.make_synthetic_scene(200, seed=11, extent=2.0)
    cam = Camera(1.0, 0.5, -5.0, width=128, height=64)
    cam.rotate_down(10.0)
    cam.rotate_right(15.0)
    cam.update()
    img_jax, stats, img_gold, _ = _render_both(scene, cam, cfg, 128, 64)
    np.testing.assert_allclose(img_jax, img_gold, atol=2e-3)


def test_stats_consistency(cfg):
    # Reference-rect mode: record/bin statistics must match the golden
    # replica exactly. (tight_rect shrinks allocation image-exactly but
    # intentionally changes these counts; its exactness is covered by
    # tests/test_tight_rect.py and by every image-parity test above, which
    # all run with the tight_rect default.)
    import dataclasses

    cfg = dataclasses.replace(cfg, tight_rect=False)
    scene = ply_io.make_synthetic_scene(500, seed=13, extent=3.0)
    cam = Camera(0.0, 0.0, -8.0, width=128, height=128)
    img_jax, stats, img_gold, dbg = _render_both(scene, cam, cfg, 128, 128)
    n_records_gold = len(dbg["sorted_sids"])
    assert int(stats["num_records"]) == n_records_gold
    assert int(stats["num_visible"]) == int(np.sum(dbg["valid"]))
    assert int(stats["num_culled"]) == int(np.sum(dbg["culled"]))
    assert int(stats["max_bin"]) == int(np.max(np.diff(dbg["bounds"])))
