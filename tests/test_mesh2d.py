"""2-D (view x splat) mesh training on the virtual CPU mesh.

The gate, composing the two 1-D gates: a 2-D step over a batch of B views
with splat-sharded rendering must equal B sequential single-device fast-path
gradient evaluations averaged into one optimizer update. The view axis must
not change the mathematics (data_parallel's gate) and the splat axis must
not either (fast_sharded's gate) -- together, neither may.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops.fastpath import render_fast
from openglgaussiansplattingrenderer_jax.parallel import mesh2d
from openglgaussiansplattingrenderer_jax.parallel.sharded import (
    pad_scene_for_mesh,
)
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
TC = TrainConfig()


def _setup(n=48, n_views=4, seed=7):
    scene = ply_io.make_synthetic_scene(n, seed=seed, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    params = pad_scene_for_mesh(params, 4)
    raw = raw_from_params(params)
    cams = [Camera(0.4 * i - 0.6, 0.2, -4.0 - 0.3 * i, width=W, height=H)
            for i in range(n_views)]
    bundles = camera_bundles(cams)
    rng = np.random.default_rng(seed + 1)
    targets = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
               for _ in range(n_views)]
    return raw, targets, bundles


def _stack_args(targets, bundles, cfg):
    tgt = jnp.stack([jnp.asarray(mesh2d.tile_target(t, W, H, cfg)[0])
                     for t in targets])
    view = jnp.stack([b[0] for b in bundles])
    vp = jnp.stack([b[1] for b in bundles])
    sc = [jnp.stack([jnp.asarray(b[i], jnp.float32) for b in bundles])
          for i in (2, 3, 4, 5)]
    return (tgt, view, vp, *sc)


def _reference_update(raw, targets, bundles, param_keys,
                      lambda_dssim=TC.lambda_dssim):
    """B sequential single-device fast-path grads -> mean -> one update,
    on the SAME 3DGS objective the 2-D mesh trains (gs_loss)."""
    from openglgaussiansplattingrenderer_jax.train import losses

    def loss_of(raw, target, b):
        img, _ = render_fast(params_from_raw(raw), *b, W, H, CFG)
        return losses.gs_loss(img[..., :3], target, lambda_dssim)

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


def test_halo_padded_ssim_equals_full_image_ssim():
    """The distributed SSIM machinery (border-strip halos + padded-tile
    windowing + centre-pixel mask) must reproduce losses.ssim on the full
    image exactly: sum of masked window values / (H-10)(W-10)C == the
    single-chip VALID-window mean."""
    from openglgaussiansplattingrenderer_jax.train import losses

    rng = np.random.default_rng(5)
    h = w = 32
    gx = gy = 2
    ph, pw = h // gy, w // gx
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    ref = float(losses.ssim(jnp.asarray(a), jnp.asarray(b)))

    def tiles_of(x):
        return jnp.asarray(
            x.reshape(gy, ph, gx, pw, 3).transpose(0, 2, 1, 3, 4)
            .reshape(gy * gx, ph, pw, 3))

    ta, tb = tiles_of(a), tiles_of(b)
    all_tiles = jnp.arange(gy * gx, dtype=jnp.int32)
    pa = mesh2d._padded_tiles(ta, mesh2d._tile_strips(ta), all_tiles,
                             gx, gy, lambda t: t)
    pb = mesh2d._padded_tiles(tb, mesh2d._tile_strips(tb), all_tiles,
                             gx, gy, lambda t: t)
    m = mesh2d._window_mask(all_tiles, gx, ph, pw, w, h)
    smap = losses.ssim_map(pa, pb)
    got = float(jnp.sum(smap * m[..., None])
                / ((h - 10) * (w - 10) * 3))
    assert float(jnp.sum(m)) == (h - 10) * (w - 10)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_tile_target_roundtrip():
    """tile_target's layout must invert assemble_image's exactly."""
    rng = np.random.default_rng(0)
    target = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    tiles, mask = mesh2d.tile_target(target, W, H, CFG)
    gx, gy = CFG.grid_x, CFG.grid_y
    ph, pw = H // gy, W // gx
    back = (tiles.reshape(gy, gx, ph, pw, 3)
            .transpose(0, 2, 1, 3, 4).reshape(H, W, 3))
    np.testing.assert_array_equal(back, target)
    np.testing.assert_array_equal(mask, np.ones((gy * gx, ph * pw)))


@pytest.mark.parametrize("dv,ds,batch", [(2, 4, 2)])
def test_2d_step_matches_sequential_mean(dv, ds, batch):
    raw, targets, bundles = _setup(n_views=batch)
    keys = tuple(sorted(raw.keys()))
    mesh = mesh2d.make_mesh2d(dv, ds)
    step = mesh2d.make_2d_train_step(CFG, TC, W, H, mesh, batch=batch,
                                     param_keys=keys)
    raw_sharded = mesh2d.shard_raw_2d(raw, mesh)
    opt_state = step.init(raw_sharded)
    args = _stack_args(targets, bundles, CFG)
    raw_2d, _, loss_2d, psnr, over = step(raw_sharded, opt_state, *args)

    assert int(over) == 0
    assert np.isfinite(float(psnr))
    raw_ref, loss_ref = _reference_update(raw, targets, bundles, keys)
    assert abs(float(loss_2d) - loss_ref) < 1e-5
    for k in raw_ref:
        np.testing.assert_allclose(
            np.asarray(raw_2d[k]), np.asarray(raw_ref[k]),
            rtol=2e-4, atol=1e-6, err_msg=f"2d update mismatch for {k}")


def test_2d_gs_loss_nondivisible_resolution():
    """34x34 on a 2x2 grid: tiles pad to 18px, the window mask must keep
    exactly the (H-10)(W-10) VALID windows of the TRUE image -- halo
    strips at the grid edge contain pad pixels no valid window reaches."""
    w = h = 34
    cfg = RenderConfig(grid_x=2, grid_y=2, chunk=32,
                       dup_capacity_factor=8.0, max_per_tile=256)
    scene = ply_io.make_synthetic_scene(48, seed=3, extent=1.5)
    params = pad_scene_for_mesh(
        {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}, 4)
    raw = raw_from_params(params)
    keys = tuple(sorted(raw.keys()))
    cams = [Camera(0.2 * i - 0.1, 0.1, -4.0, width=w, height=h)
            for i in range(2)]
    bundles = camera_bundles(cams)
    rng = np.random.default_rng(2)
    targets = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
               for _ in range(2)]

    from openglgaussiansplattingrenderer_jax.train import losses

    def loss_of(raw, target, b):
        img, _ = render_fast(params_from_raw(raw), *b, w, h, cfg)
        return losses.gs_loss(img[..., :3], target, TC.lambda_dssim)

    l_ref = float(np.mean([jax.jit(loss_of)(raw, jnp.asarray(t), b)
                           for t, b in zip(targets, bundles)]))

    mesh = mesh2d.make_mesh2d(2, 4)
    step = mesh2d.make_2d_train_step(cfg, TC, w, h, mesh, batch=2,
                                     param_keys=keys)
    raw_s = mesh2d.shard_raw_2d(raw, mesh)
    opt = step.init(raw_s)
    tgt = jnp.stack([jnp.asarray(mesh2d.tile_target(t, w, h, cfg)[0])
                     for t in targets])
    view = jnp.stack([b[0] for b in bundles])
    vp = jnp.stack([b[1] for b in bundles])
    sc = [jnp.stack([jnp.asarray(b[i], jnp.float32) for b in bundles])
          for i in (2, 3, 4, 5)]
    _, _, loss_2d, _, over = step(raw_s, opt, tgt, view, vp, *sc)
    assert int(over) == 0
    assert abs(float(loss_2d) - l_ref) < 1e-5, (float(loss_2d), l_ref)


@pytest.mark.slow
def test_2d_step_multi_view_per_row():
    """batch > dv: each view-row renders batch//dv views sequentially."""
    dv, ds, batch = 2, 4, 4
    raw, targets, bundles = _setup(n_views=batch)
    keys = tuple(sorted(raw.keys()))
    mesh = mesh2d.make_mesh2d(dv, ds)
    step = mesh2d.make_2d_train_step(CFG, TC, W, H, mesh, batch=batch,
                                     param_keys=keys)
    raw_sharded = mesh2d.shard_raw_2d(raw, mesh)
    opt_state = step.init(raw_sharded)
    args = _stack_args(targets, bundles, CFG)
    raw_2d, _, loss_2d, _, over = step(raw_sharded, opt_state, *args)

    assert int(over) == 0
    raw_ref, loss_ref = _reference_update(raw, targets, bundles, keys)
    assert abs(float(loss_2d) - loss_ref) < 1e-5
    for k in raw_ref:
        np.testing.assert_allclose(
            np.asarray(raw_2d[k]), np.asarray(raw_ref[k]),
            rtol=2e-4, atol=1e-6, err_msg=f"2d update mismatch for {k}")


def test_2d_loss_decreases_over_steps():
    """A few 2-D steps on consistent targets reduce the loss."""
    dv, ds, batch = 2, 4, 2
    raw, _, bundles = _setup(n_views=batch, seed=11)
    # render the initial scene as the target of a slightly perturbed start
    targets = []
    for b in bundles:
        img, _ = render_fast(params_from_raw(raw), *b, W, H, CFG)
        targets.append(np.asarray(img[..., :3]))
    key = jax.random.PRNGKey(0)
    raw = dict(raw)
    # colors live in 0..255 units (ref Splats.cpp:295): perturb visibly
    raw["colors"] = raw["colors"] + 60.0 * jax.random.normal(
        key, raw["colors"].shape)

    keys = tuple(sorted(raw.keys()))
    mesh = mesh2d.make_mesh2d(dv, ds)
    step = mesh2d.make_2d_train_step(CFG, TC, W, H, mesh, batch=batch,
                                     param_keys=keys)
    raw_s = mesh2d.shard_raw_2d(raw, mesh)
    opt_state = step.init(raw_s)
    args = _stack_args(targets, bundles, CFG)
    losses = []
    # the gs objective's L1 term descends linearly (MSE descended
    # quadratically), so give Adam a few more steps than the r4 version
    for _ in range(30):
        raw_s, opt_state, loss, _, _ = step(raw_s, opt_state, *args)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


def test_2d_adc_parity_with_1x1_mesh():
    """--mesh2d + adaptive density control: a 2x4 (view x splat) run must
    equal the same run on a 1x1 mesh. densify_and_prune runs as the same
    global program on sharded state (GSPMD), stats ride the per-view shift
    trick, and resharding is deterministic -- so only 2-term-commutative
    view sums separate the two runs."""
    from openglgaussiansplattingrenderer_jax.train import densify as dn

    scene = ply_io.make_synthetic_scene(20, seed=11, extent=1.2)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    full = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cams = [Camera(0.4 * i - 0.2, 0.2, -4.0, width=W, height=H)
            for i in range(2)]
    bundles = camera_bundles(cams)
    targets = []
    for b in bundles:
        img, _ = render_fast(full, *b, W, H, CFG)
        targets.append(np.asarray(img[..., :3]))
    start = {k: np.asarray(v)[:6] for k, v in full.items()}

    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6,
                          scene_extent=1.2, start_step=0, interval=3,
                          stop_step=8)
    tc = TrainConfig(steps=8, lambda_dssim=0.0, lr_means=3e-3)

    p24, alive24, h24 = mesh2d.fit_scene_2d(
        start, targets, cams, CFG, tc, mesh=mesh2d.make_mesh2d(2, 4),
        batch=2, dc=dc, seed=5, verbose=False)
    p11, alive11, h11 = mesh2d.fit_scene_2d(
        start, targets, cams, CFG, tc, mesh=mesh2d.make_mesh2d(1, 1),
        batch=2, dc=dc, seed=5, verbose=False)

    np.testing.assert_array_equal(np.asarray(alive24), np.asarray(alive11))
    assert int(jnp.sum(alive24)) > 6, "densification never allocated"
    for k in p11:
        np.testing.assert_allclose(
            np.asarray(p24[k]), np.asarray(p11[k]),
            rtol=2e-4, atol=1e-6, err_msg=f"2d+ADC diverged on {k}")


def test_2d_adc_kill_and_resume_matches(tmp_path):
    """A mesh2d+ADC run checkpointed at step 4 (sharded state gathered to
    one npz) and resumed (re-placed P(splat)) replays the uninterrupted
    8-step run exactly."""
    from openglgaussiansplattingrenderer_jax.train import densify as dn

    scene = ply_io.make_synthetic_scene(20, seed=11, extent=1.2)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    full = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cams = [Camera(0.4 * i - 0.2, 0.2, -4.0, width=W, height=H)
            for i in range(2)]
    bundles = camera_bundles(cams)
    targets = []
    for b in bundles:
        img, _ = render_fast(full, *b, W, H, CFG)
        targets.append(np.asarray(img[..., :3]))
    start = {k: np.asarray(v)[:6] for k, v in full.items()}
    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6,
                          scene_extent=1.2, start_step=0, interval=3,
                          stop_step=8)
    tc = TrainConfig(steps=8, lambda_dssim=0.0, lr_means=3e-3)
    mesh = mesh2d.make_mesh2d(2, 4)

    ref, alive_ref, _ = mesh2d.fit_scene_2d(
        start, targets, cams, CFG, tc, mesh=mesh, batch=2, dc=dc, seed=5,
        verbose=False)
    mid = str(tmp_path / "m2.ckpt.npz")
    tc4 = TrainConfig(steps=4, lambda_dssim=0.0, lr_means=3e-3)
    mesh2d.fit_scene_2d(start, targets, cams, CFG, tc4, mesh=mesh, batch=2,
                        dc=dc, seed=5, verbose=False, save_every=4,
                        checkpoint_path=mid)
    res, alive_res, _ = mesh2d.fit_scene_2d(
        start, targets, cams, CFG, tc, mesh=mesh, batch=2, dc=dc, seed=5,
        verbose=False, resume=mid)
    np.testing.assert_array_equal(np.asarray(alive_ref),
                                  np.asarray(alive_res))
    for k in ref:
        np.testing.assert_array_equal(
            np.asarray(ref[k]), np.asarray(res[k]),
            err_msg=f"mesh2d resume diverged on {k}")
