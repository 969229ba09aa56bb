"""Trainer smoke + convergence tests (capability the reference lacks)."""

import numpy as np
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.render import render_stats
from openglgaussiansplattingrenderer_jax.train import (
    TrainConfig, fit_scene, losses, trainer,
)

CFG = RenderConfig(use_pallas=False, chunk=32, max_per_tile=256,
                   dup_capacity_factor=32.0)


def test_losses_basic():
    a = jnp.zeros((32, 32, 3))
    b = jnp.ones((32, 32, 3)) * 0.5
    assert float(losses.l1(a, a)) == 0.0
    assert float(losses.l2(a, b)) > 0
    assert 0.99 < float(losses.ssim(b, b)) <= 1.0
    assert float(losses.dssim(b, b)) < 1e-5
    assert float(losses.psnr(a, a)) > 100


def test_raw_roundtrip(rng):
    scene = ply_io.make_synthetic_scene(20, seed=1)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    back = trainer.params_from_raw(trainer.raw_from_params(params))
    for k in params:
        np.testing.assert_allclose(np.asarray(back[k]), np.asarray(params[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_fit_recovers_color():
    """Perturb colours of a small scene; fitting to the clean render must
    improve PSNR substantially."""
    w = h = 64
    scene = ply_io.make_synthetic_scene(25, seed=6, extent=1.2)
    scene["opacities"] = np.clip(scene["opacities"], 0.4, 0.9)
    cam = Camera(0.0, 0.0, -4.0, width=w, height=h)
    clean = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    target, _ = render_stats(clean, cam, CFG)
    target = target[..., :3]

    noisy = dict(scene)
    rngg = np.random.default_rng(0)
    noisy["colors"] = np.clip(
        scene["colors"] + rngg.normal(0, 60, scene["colors"].shape), 5, 250
    ).astype(np.float32)
    start = {k: jnp.asarray(v) for k, v in noisy.items() if k != "sh_rest"}

    img0, _ = render_stats(start, cam, CFG)
    psnr0 = float(losses.psnr(img0[..., :3], target))

    tc = TrainConfig(steps=60, lambda_dssim=0.0)
    fitted, hist = fit_scene(start, [np.asarray(target)], [cam], CFG, tc,
                             verbose=False, log_every=20)
    img1, _ = render_stats(fitted, cam, CFG)
    psnr1 = float(losses.psnr(img1[..., :3], target))
    assert psnr1 > psnr0 + 3.0, f"psnr {psnr0} -> {psnr1}"
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_checkpoint_roundtrip(tmp_path):
    scene = ply_io.make_synthetic_scene(10, seed=2)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    raw = trainer.raw_from_params(params)
    path = str(tmp_path / "ckpt.npz")
    trainer.save_checkpoint(path, raw, step=7)
    raw2, step = trainer.load_checkpoint(path)
    assert step == 7
    for k in raw:
        np.testing.assert_allclose(np.asarray(raw[k]), raw2[k], atol=1e-7)


def test_fit_trains_sh_coefficients():
    """View-dependent SH coefficients (sh_rest) ride the raw pytree and
    receive gradients when rendering with sh_degree > 0: zeroing a target
    scene's SH and fitting against two views must move sh_rest off zero
    and improve the loss."""
    import dataclasses

    w = h = 64
    cfg = dataclasses.replace(CFG, sh_degree=2)
    rngg = np.random.default_rng(3)
    scene = ply_io.make_synthetic_scene(20, seed=13, extent=1.0)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    scene["sh_rest"] = rngg.normal(0, 0.35, scene["sh_rest"].shape).astype(
        np.float32)
    full = {k: jnp.asarray(v) for k, v in scene.items()}

    cams = [Camera(0.0, 0.0, -4.0, width=w, height=h),
            Camera(1.5, 0.0, -3.6, width=w, height=h)]
    cams[1].set_rotation(0.0, -20.0, 0.0)
    targets = []
    from openglgaussiansplattingrenderer_jax.render import render_stats as rs
    for cam in cams:
        img, _ = rs(full, cam, cfg)
        targets.append(np.asarray(img[..., :3]))
    # the two views must actually see different colours (SH is in play)
    assert np.abs(targets[0] - targets[1]).max() > 0.01

    start = dict(scene)
    start["sh_rest"] = np.zeros_like(scene["sh_rest"])
    tc = TrainConfig(steps=40, lambda_dssim=0.0, lr_colors=2.0)
    fitted, hist = fit_scene(start, targets, cams, cfg, tc, verbose=False,
                             log_every=20)
    assert "sh_rest" in fitted
    assert float(np.abs(np.asarray(fitted["sh_rest"])).max()) > 1e-4, \
        "sh_rest never received gradient"
    assert hist[-1]["loss"] < hist[0]["loss"], hist


def test_position_lr_decay_schedule():
    """lr_means_final enables the 3DGS exponential position-LR decay: with
    constant unit gradients Adam's step magnitude tracks the LR, so the
    means step must shrink toward lr_means_final while a constant-LR tensor
    (colors) stays put."""
    import jax
    import optax
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        TrainConfig, make_optimizer,
    )

    tc = TrainConfig(lr_means=1e-2, lr_means_final=1e-4,
                     lr_means_decay_steps=50, lr_colors=1e-2)
    opt = make_optimizer(tc)
    raw = {
        "means": jnp.zeros((4, 3)),
        "log_scales": jnp.zeros((4, 3)),
        "quats": jnp.zeros((4, 4)),
        "logit_opacities": jnp.zeros((4,)),
        "colors": jnp.zeros((4, 3)),
    }
    grads = jax.tree.map(jnp.ones_like, raw)
    state = opt.init(raw)
    steps_means, steps_colors = [], []
    for _ in range(60):
        updates, state = opt.update(grads, state, raw)
        raw = optax.apply_updates(raw, updates)
        steps_means.append(float(jnp.abs(updates["means"]).max()))
        steps_colors.append(float(jnp.abs(updates["colors"]).max()))
    # early step ~ lr_means, late step ~ lr_means_final
    assert steps_means[1] > 3e-3, steps_means[1]
    assert steps_means[-1] < 3e-4, steps_means[-1]
    # colors LR is constant: step magnitude unchanged
    assert abs(steps_colors[-1] - steps_colors[1]) < 1e-4


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    """A run checkpointed at step K and resumed from that file replays the
    uninterrupted run exactly (params + optimizer moments round-trip)."""
    w = h = 64
    scene = ply_io.make_synthetic_scene(20, seed=11, extent=1.2)
    cam = Camera(0.0, 0.0, -4.0, width=w, height=h)
    clean = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    target, _ = render_stats(clean, cam, CFG)
    target = np.asarray(target[..., :3])

    start = dict(scene)
    start["colors"] = np.clip(scene["colors"] + 30.0, 0, 255)
    start = {k: jnp.asarray(v) for k, v in start.items() if k != "sh_rest"}
    tc = TrainConfig(steps=8, lambda_dssim=0.0)
    ckpt = str(tmp_path / "fit.ckpt.npz")

    # uninterrupted run (also writes checkpoints, exercising save_every)
    ref, _ = fit_scene(start, [target], [cam], CFG, tc, verbose=False,
                       save_every=4, checkpoint_path=ckpt)
    # the "kill": re-load the step-4 snapshot and replay steps 4..8
    mid = str(tmp_path / "mid.ckpt.npz")
    _, step8, extras8 = trainer.load_checkpoint_full(ckpt)
    assert step8 == 8 and "opt_leaves" in extras8
    # final checkpoint is step 8; re-create the step-4 one by a fresh
    # truncated run with the same save cadence
    tc4 = TrainConfig(steps=4, lambda_dssim=0.0)
    fit_scene(start, [target], [cam], CFG, tc4, verbose=False,
              save_every=4, checkpoint_path=mid)
    _, s4 = trainer.load_checkpoint(mid)
    assert s4 == 4
    resumed, _ = fit_scene(start, [target], [cam], CFG, tc, verbose=False,
                           resume=mid)
    for k in ref:
        np.testing.assert_array_equal(
            np.asarray(ref[k]), np.asarray(resumed[k]),
            err_msg=f"resume diverged on {k}")


def test_checkpoint_opt_leaves_order_past_ten(tmp_path):
    """Optimizer leaves save as o_0..o_N; restoring must order them
    numerically (o_2 < o_10), which lexicographic sorting would break."""
    import jax

    raw = {f"k{i}": jnp.arange(3, dtype=jnp.float32) + i for i in range(4)}
    leaves = [jnp.full((2,), float(i)) for i in range(13)]  # > 10 leaves
    treedef = jax.tree_util.tree_structure(leaves)
    opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    path = str(tmp_path / "c.npz")
    trainer.save_checkpoint(path, raw, step=3, opt_state=opt_state)
    _, step, extras = trainer.load_checkpoint_full(path)
    assert step == 3
    got = extras["opt_leaves"]
    assert len(got) == 13
    for i, leaf in enumerate(got):
        np.testing.assert_array_equal(leaf, np.full((2,), float(i)))
    restored = trainer.restore_opt_state(opt_state, got)
    for a, b in zip(jax.tree_util.tree_leaves(restored), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
