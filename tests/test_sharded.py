"""Multi-device sharded pipeline on the 8-device virtual CPU mesh.

Checks the capability the reference lacks entirely (SURVEY.md section 2.4):
sharded render must equal the single-device render exactly, and sharded
gradients must equal single-device gradients -- including the segment-sum
identity for splats duplicated across tiles owned by different devices.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.parallel import sharded
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays

CFG = RenderConfig(use_pallas=False, chunk=32, max_per_tile=512,
                   dup_capacity_factor=16.0)
W = H = 64


def _setup(n, seed=3):
    scene = ply_io.make_synthetic_scene(n, seed=seed, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    args = camera_args(cam)
    return params, args


def _single_device_image(params, args):
    img, _ = render_arrays(
        params, jnp.asarray(args["view"]), jnp.asarray(args["vp"]),
        args["focal_x"], args["focal_y"], args["tan_fovx"], args["tan_fovy"],
        W, H, CFG)
    return img


@pytest.mark.slow
@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_render_matches_single(ndev):
    params, args = _setup(96)
    mesh = sharded.make_mesh(ndev)
    img_s = sharded.render_sharded(
        params, args["view"], args["vp"], args["focal_x"], args["focal_y"],
        args["tan_fovx"], args["tan_fovy"], W, H, CFG, mesh)
    img_1 = _single_device_image(params, args)
    np.testing.assert_allclose(np.asarray(img_s), np.asarray(img_1), atol=1e-5)


@pytest.mark.slow
def test_sharded_grads_match_single():
    params, args = _setup(64, seed=9)
    mesh = sharded.make_mesh(8)
    target = jnp.full((H, W, 3), 0.15)

    def loss_sharded(p):
        img = sharded.render_sharded(
            p, args["view"], args["vp"], args["focal_x"], args["focal_y"],
            args["tan_fovx"], args["tan_fovy"], W, H, CFG, mesh)
        return jnp.mean((img[..., :3] - target) ** 2)

    def loss_single(p):
        return jnp.mean((_single_device_image(p, args)[..., :3] - target) ** 2)

    g_s = jax.grad(loss_sharded)(params)
    g_1 = jax.grad(loss_single)(params)
    for k in g_1:
        np.testing.assert_allclose(
            np.asarray(g_s[k]), np.asarray(g_1[k]), rtol=1e-4, atol=1e-7,
            err_msg=f"sharded gradient mismatch for {k}")


def test_dryrun_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_pad_scene_for_mesh():
    params, _ = _setup(13)
    padded = sharded.pad_scene_for_mesh(params, 8)
    assert padded["means"].shape[0] == 16
    assert np.all(np.asarray(padded["opacities"][13:]) == 0.0)
