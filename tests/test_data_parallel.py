"""View-parallel (data-parallel) training on the virtual CPU mesh.

The gate: a dp step over B views must equal B sequential single-device
gradient evaluations averaged into one optimizer update (same loss_fn, same
optimizer) -- data parallelism must not change the mathematics, only the
wall-clock. psum reassociation makes this allclose, not bitwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.parallel import data_parallel as dp
from openglgaussiansplattingrenderer_jax.render import render_arrays
from openglgaussiansplattingrenderer_jax.train import losses
from openglgaussiansplattingrenderer_jax.train.trainer import (
    TrainConfig,
    camera_bundles,
    make_optimizer,
    params_from_raw,
    raw_from_params,
)

W = H = 32
CFG = RenderConfig(grid_x=2, grid_y=2, chunk=32, dup_capacity_factor=8.0,
                   max_per_tile=256)
TC = TrainConfig(lambda_dssim=0.2)


def _setup(n=48, n_views=4, seed=5):
    scene = ply_io.make_synthetic_scene(n, seed=seed, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    raw = raw_from_params(params)
    cams = [Camera(0.4 * i - 0.6, 0.2, -4.0 - 0.3 * i, width=W, height=H)
            for i in range(n_views)]
    bundles = camera_bundles(cams)
    rng = np.random.default_rng(seed + 1)
    targets = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
               for _ in range(n_views)]
    return raw, targets, bundles


def _reference_update(raw, targets, bundles, param_keys):
    """B sequential grad evals -> mean grad -> one optimizer update."""
    def loss_of(raw, target, b):
        img, _ = render_arrays(params_from_raw(raw), *b, W, H, CFG)
        return losses.gs_loss(img[..., :3], target, TC.lambda_dssim)

    grads = None
    loss_sum = 0.0
    for t, b in zip(targets, bundles):
        l, g = jax.value_and_grad(loss_of)(raw, jnp.asarray(t), b)
        grads = g if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, g)
        loss_sum += float(l)
    grads = jax.tree_util.tree_map(lambda x: x / len(targets), grads)
    optimizer = make_optimizer(TC, keys=param_keys)
    opt_state = optimizer.init(raw)
    updates, opt_state = optimizer.update(grads, opt_state, raw)
    return optax.apply_updates(raw, updates), loss_sum / len(targets)


@pytest.mark.parametrize("ndev,batch", [(4, 4), (4, 8)])
def test_dp_step_matches_sequential_mean(ndev, batch):
    raw, targets, bundles = _setup(n_views=batch)
    keys = tuple(sorted(raw.keys()))
    mesh = dp.make_mesh(ndev)
    step = dp.make_dp_train_step(CFG, TC, W, H, mesh, batch=batch,
                                 param_keys=keys)
    opt_state = step.init(raw)
    args = dp.stack_view_batch(targets, bundles)
    raw_dp, _, loss_dp, psnr_dp = step(raw, opt_state, *args)

    raw_ref, loss_ref = _reference_update(raw, targets, bundles, keys)
    assert abs(float(loss_dp) - loss_ref) < 1e-5
    for k in raw_ref:
        np.testing.assert_allclose(
            np.asarray(raw_dp[k]), np.asarray(raw_ref[k]),
            rtol=2e-4, atol=1e-6, err_msg=f"dp update mismatch for {k}")


def test_dp_grad_norms_sum_over_views():
    batch = 4
    raw, targets, bundles = _setup(n_views=batch)
    keys = tuple(sorted(raw.keys()))
    mesh = dp.make_mesh(4)
    step = dp.make_dp_train_step(CFG, TC, W, H, mesh, batch=batch,
                                 param_keys=keys, with_grad_norms=True)
    opt_state = step.init(raw)
    args = dp.stack_view_batch(targets, bundles)
    _, _, _, _, gnorm, seen = step(raw, opt_state, *args)
    assert gnorm.shape == (raw["means"].shape[0],)
    assert bool(jnp.all(jnp.isfinite(gnorm)))
    assert float(jnp.max(gnorm)) > 0.0
    # seen counts views-with-contribution, bounded by the batch size
    assert seen.shape == gnorm.shape
    assert float(jnp.max(seen)) <= batch
    np.testing.assert_array_equal(np.asarray(seen > 0),
                                  np.asarray(gnorm > 0))

    # the batch statistic is the sum of per-view screen-grad norms
    def one_view(t, b):
        def f(raw, shift):
            params = params_from_raw(raw)
            params["shift2d"] = shift
            img, _ = render_arrays(params, *b, W, H, CFG)
            return losses.gs_loss(img[..., :3], jnp.asarray(t),
                                  TC.lambda_dssim)
        shift = jnp.zeros((raw["means"].shape[0], 2), jnp.float32)
        gs = jax.grad(f, argnums=1)(raw, shift)
        return jnp.linalg.norm(gs * jnp.array([W / 2.0, H / 2.0]), axis=-1)

    expect = sum(one_view(t, b) for t, b in zip(targets, bundles))
    np.testing.assert_allclose(np.asarray(gnorm), np.asarray(expect),
                               rtol=2e-4, atol=1e-7)


@pytest.mark.slow
def test_dp_training_converges():
    # a few dp steps on consistent targets reduce the loss
    raw, _, bundles = _setup(n=64, n_views=4, seed=11)
    keys = tuple(sorted(raw.keys()))
    # targets = renders of a perturbed copy (self-consistent problem)
    gt = {k: v for k, v in raw.items()}
    targets = [np.asarray(render_arrays(params_from_raw(gt), *b, W, H,
                                        CFG)[0][..., :3])
               for b in bundles]
    rng = np.random.default_rng(0)
    raw0 = dict(raw)
    raw0["means"] = raw["means"] + 0.01 * jnp.asarray(
        rng.standard_normal(raw["means"].shape), jnp.float32)
    mesh = dp.make_mesh(4)
    step = dp.make_dp_train_step(CFG, TC, W, H, mesh, batch=4,
                                 param_keys=keys)
    opt_state = step.init(raw0)
    args = dp.stack_view_batch(targets, bundles)
    r, s = raw0, opt_state
    first = last = None
    for i in range(8):
        r, s, loss, _ = step(r, s, *args)
        first = first if first is not None else float(loss)
        last = float(loss)
    assert last < first


def test_dp_adc_parity_with_single_device():
    """--data-parallel + adaptive density control: a 2-device dp+ADC run
    must equal the 1-device run (batch=2 keeps every cross-view reduction
    a commutative 2-term sum)."""
    from openglgaussiansplattingrenderer_jax.camera import Camera
    from openglgaussiansplattingrenderer_jax.train import densify as dn
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        TrainConfig as TCfg, camera_bundles,
    )
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.render import render_arrays

    scene = ply_io.make_synthetic_scene(20, seed=11, extent=1.2)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    full = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cams = [Camera(0.4 * i - 0.2, 0.2, -4.0, width=W, height=H)
            for i in range(2)]
    bundles = camera_bundles(cams)
    targets = [np.asarray(render_arrays(full, *b, W, H, CFG)[0][..., :3])
               for b in bundles]
    start = {k: np.asarray(v)[:6] for k, v in full.items()}

    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6,
                          scene_extent=1.2, start_step=0, interval=3,
                          stop_step=8)
    tc = TCfg(steps=8, lambda_dssim=0.0, lr_means=3e-3)

    p2, alive2, _ = dp.fit_scene_dp(
        start, targets, cams, CFG, tc, mesh=dp.make_mesh(2), batch=2,
        dc=dc, seed=5, verbose=False)
    p1, alive1, _ = dp.fit_scene_dp(
        start, targets, cams, CFG, tc, mesh=dp.make_mesh(1), batch=2,
        dc=dc, seed=5, verbose=False)

    np.testing.assert_array_equal(np.asarray(alive2), np.asarray(alive1))
    assert int(jnp.sum(alive2)) > 6, "densification never allocated"
    for k in p1:
        np.testing.assert_allclose(
            np.asarray(p2[k]), np.asarray(p1[k]),
            rtol=2e-4, atol=1e-6, err_msg=f"dp+ADC diverged on {k}")


def test_dp_adc_kill_and_resume_matches(tmp_path):
    """A dp+ADC run checkpointed at step 4 and resumed replays the
    uninterrupted 8-step run exactly (replicated state + densify state +
    RNG round-trip through the npz)."""
    from openglgaussiansplattingrenderer_jax.camera import Camera
    from openglgaussiansplattingrenderer_jax.train import densify as dn
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        TrainConfig as TCfg, camera_bundles,
    )
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.render import render_arrays

    scene = ply_io.make_synthetic_scene(20, seed=11, extent=1.2)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    full = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cams = [Camera(0.4 * i - 0.2, 0.2, -4.0, width=W, height=H)
            for i in range(2)]
    bundles = camera_bundles(cams)
    targets = [np.asarray(render_arrays(full, *b, W, H, CFG)[0][..., :3])
               for b in bundles]
    start = {k: np.asarray(v)[:6] for k, v in full.items()}
    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6,
                          scene_extent=1.2, start_step=0, interval=3,
                          stop_step=8)
    tc = TCfg(steps=8, lambda_dssim=0.0, lr_means=3e-3)
    mesh = dp.make_mesh(2)

    ref, alive_ref, _ = dp.fit_scene_dp(
        start, targets, cams, CFG, tc, mesh=mesh, batch=2, dc=dc, seed=5,
        verbose=False)
    mid = str(tmp_path / "dp.ckpt.npz")
    tc4 = TCfg(steps=4, lambda_dssim=0.0, lr_means=3e-3)
    dp.fit_scene_dp(start, targets, cams, CFG, tc4, mesh=mesh, batch=2,
                    dc=dc, seed=5, verbose=False, save_every=4,
                    checkpoint_path=mid)
    res, alive_res, _ = dp.fit_scene_dp(
        start, targets, cams, CFG, tc, mesh=mesh, batch=2, dc=dc, seed=5,
        verbose=False, resume=mid)
    np.testing.assert_array_equal(np.asarray(alive_ref),
                                  np.asarray(alive_res))
    for k in ref:
        np.testing.assert_array_equal(
            np.asarray(ref[k]), np.asarray(res[k]),
            err_msg=f"dp resume diverged on {k}")
