"""Adaptive density control (train/densify.py): static-capacity clone /
split / prune semantics, optimizer-moment hygiene, and an end-to-end
adaptive fit. Capability the reference lacks entirely (it renders a fixed
set); semantics follow Kerbl et al. sec. 5.2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.render import render_stats
from openglgaussiansplattingrenderer_jax.train import (
    TrainConfig, losses, trainer,
)
from openglgaussiansplattingrenderer_jax.train import densify as dn

CFG = RenderConfig(use_pallas=False, chunk=32, max_per_tile=256,
                   dup_capacity_factor=32.0)


def _raw_scene(n, seed=3, **kw):
    scene = ply_io.make_synthetic_scene(n, seed=seed, **kw)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    return trainer.raw_from_params(params), params


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pad_renders_identically(use_pallas):
    """Dead (padding) rows must contribute nothing to the image -- on BOTH
    paths: the jnp oracle and the Pallas pipeline whose expand-time
    reachability cull the dead-row parking design relies on (parked rows
    sit below the 1/255 alpha cutoff, so the cull must drop them)."""
    cfg = dataclasses.replace(CFG, use_pallas=use_pallas)
    raw, params = _raw_scene(12)
    padded, alive = dn.pad_to_capacity(raw, 32)
    assert int(jnp.sum(alive)) == 12
    cam = Camera(0.0, 0.0, -4.0, width=64, height=64)
    img0, stats0 = render_stats(params, cam, cfg)
    img1, stats1 = render_stats(trainer.params_from_raw(padded), cam, cfg)
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               atol=1e-5)
    if use_pallas:
        # Parked rows contribute zero compositable records. With tight_rect
        # (the default) they are never even ALLOCATED (opacity < alpha_min
        # -> zero-tile rect); with the reference rect they are allocated and
        # must die in the expand kernel's reachability cull instead. Assert
        # both mechanisms.
        live0 = int(stats0["num_records"]) - int(stats0["culled_unreachable"])
        live1 = int(stats1["num_records"]) - int(stats1["culled_unreachable"])
        assert live1 == live0, (stats0, stats1)
        cfg_loose = dataclasses.replace(cfg, tight_rect=False)
        img2, stats2 = render_stats(trainer.params_from_raw(padded),
                                    cam, cfg_loose)
        np.testing.assert_allclose(np.asarray(img2), np.asarray(img0),
                                   atol=1e-5)
        _, stats0l = render_stats(params, cam, cfg_loose)
        extra = int(stats2["culled_unreachable"]) - int(
            stats0l["culled_unreachable"])
        assert extra >= 20, (stats0l, stats2)


def _dc(**kw):
    base = dict(capacity=32, grad_threshold=0.5, percent_dense=0.01,
                scene_extent=1.0, min_opacity=0.005)
    base.update(kw)
    return dn.DensifyConfig(**base)


def test_prune_kills_transparent():
    raw, _ = _raw_scene(8)
    raw["logit_opacities"] = raw["logit_opacities"].at[3].set(
        trainer.inverse_sigmoid(jnp.float32(0.001)))
    padded, alive = dn.pad_to_capacity(raw, 16)
    accum = jnp.zeros((16,))
    seen = jnp.zeros((16,))
    out, alive2, changed, stats = dn.densify_and_prune(
        padded, alive, accum, seen, jax.random.PRNGKey(0), _dc(capacity=16))
    assert int(stats["pruned"]) == 1
    assert not bool(alive2[3])
    assert bool(changed[3])
    # parked: tiny opacity + tiny scale -> culled by the pipeline
    assert float(out["logit_opacities"][3]) == dn.DEAD_LOGIT
    assert int(stats["alive"]) == 7


def test_clone_copies_into_free_slots():
    raw, _ = _raw_scene(8, log_scale_range=(-6.0, -5.0))  # tiny -> clone
    padded, alive = dn.pad_to_capacity(raw, 16)
    accum = jnp.zeros((16,)).at[jnp.array([2, 5])].set(10.0)
    seen = jnp.ones((16,))
    out, alive2, changed, stats = dn.densify_and_prune(
        padded, alive, accum, seen, jax.random.PRNGKey(0),
        _dc(capacity=16, scene_extent=100.0))   # huge extent -> never split
    assert int(stats["cloned"]) == 2 and int(stats["split"]) == 0
    assert int(jnp.sum(alive2)) == 10
    # strongest candidates fill the first free slots, verbatim copies
    new_rows = np.where(np.asarray(alive2) & ~np.asarray(alive))[0]
    assert list(new_rows) == [8, 9]
    src = {2, 5}
    for r in new_rows:
        matched = [s for s in src
                   if np.allclose(np.asarray(out["means"][r]),
                                  np.asarray(padded["means"][s]))]
        assert matched, f"clone row {r} matches no candidate"
        src.remove(matched[0])
        assert bool(changed[r])


def test_split_shrinks_and_samples():
    raw, _ = _raw_scene(8, log_scale_range=(-1.0, -0.5))  # big -> split
    padded, alive = dn.pad_to_capacity(raw, 16)
    accum = jnp.zeros((16,)).at[4].set(10.0)
    seen = jnp.ones((16,))
    dc = _dc(capacity=16, scene_extent=1.0)
    out, alive2, changed, stats = dn.densify_and_prune(
        padded, alive, accum, seen, jax.random.PRNGKey(1), dc)
    assert int(stats["split"]) == 1 and int(stats["cloned"]) == 0
    new_row = int(np.where(np.asarray(alive2) & ~np.asarray(alive))[0][0])
    shrink = np.log(dc.split_factor)
    np.testing.assert_allclose(
        np.asarray(out["log_scales"][new_row]),
        np.asarray(padded["log_scales"][4]) - shrink, rtol=1e-6)
    # the allocated original is resampled + shrunk in place
    np.testing.assert_allclose(
        np.asarray(out["log_scales"][4]),
        np.asarray(padded["log_scales"][4]) - shrink, rtol=1e-6)
    assert bool(changed[4]) and bool(changed[new_row])
    # both children sample the parent's density: within 5 sigma of the mean
    sig = float(np.max(np.exp(np.asarray(padded["log_scales"][4]))))
    for r in (4, new_row):
        d = np.linalg.norm(np.asarray(out["means"][r])
                           - np.asarray(padded["means"][4]))
        assert d < 5.0 * sig
    # children differ from each other (independent draws)
    assert not np.allclose(np.asarray(out["means"][4]),
                           np.asarray(out["means"][new_row]))


def test_capacity_limit_prefers_strongest():
    raw, _ = _raw_scene(14, log_scale_range=(-6.0, -5.0))
    padded, alive = dn.pad_to_capacity(raw, 16)   # only 2 free slots
    accum = jnp.zeros((16,)).at[jnp.array([1, 3, 6, 9])].set(
        jnp.array([5.0, 20.0, 10.0, 1.0]))
    seen = jnp.ones((16,))
    out, alive2, changed, stats = dn.densify_and_prune(
        padded, alive, accum, seen, jax.random.PRNGKey(0),
        _dc(capacity=16, grad_threshold=0.5, scene_extent=100.0))
    assert int(jnp.sum(alive2)) == 16                 # full, no overflow
    assert int(stats["cloned"]) == 2
    new_rows = np.where(np.asarray(alive2) & ~np.asarray(alive))[0]
    got = {tuple(np.round(np.asarray(out["means"][r]), 5)) for r in new_rows}
    want = {tuple(np.round(np.asarray(padded["means"][s]), 5))
            for s in (3, 6)}                          # strongest two grads
    assert got == want


def test_reset_rows_zeroes_moments():
    raw, _ = _raw_scene(6)
    padded, alive = dn.pad_to_capacity(raw, 8)
    opt = trainer.make_optimizer(TrainConfig())
    state = opt.init(padded)
    # fabricate nonzero moments via one update
    g = jax.tree.map(lambda x: jnp.ones_like(x) * 0.1, padded)
    _, state = opt.update(g, state, padded)
    changed = jnp.zeros((8,), bool).at[2].set(True)
    state2 = dn.reset_rows(state, changed)
    leaves = [l for l in jax.tree.leaves(state2)
              if hasattr(l, "ndim") and l.ndim >= 1 and l.shape[0] == 8]
    assert leaves, "expected capacity-shaped moment leaves"
    for l in leaves:
        assert float(jnp.max(jnp.abs(l[2]))) == 0.0
        assert float(jnp.max(jnp.abs(l[1]))) > 0.0


def test_accumulate_counts_only_visible():
    accum = jnp.zeros((4,))
    seen = jnp.zeros((4,))
    # the (N,) per-splat grad norm metric (trainer densify_grad_norm)
    gnorm = jnp.array([1.0, 0.0, 5.0, 1.7])
    alive = jnp.array([True, True, True, False])
    accum, seen = dn.accumulate_grad_stats(accum, seen, gnorm, alive)
    np.testing.assert_allclose(np.asarray(accum), [1.0, 0.0, 5.0, 0.0])
    np.testing.assert_allclose(np.asarray(seen), [1, 0, 1, 0])


def test_accumulate_rejects_unnormed_grads():
    """Passing the raw (N, 3) grad matrix instead of its per-splat norm
    must fail loudly: jnp.linalg.norm(x, axis=-1) on a 1-D array would
    silently produce a scalar that broadcasts to every splat (advisor r4
    medium finding)."""
    with pytest.raises(ValueError, match="grad norm"):
        dn.accumulate_grad_stats(jnp.zeros((4,)), jnp.zeros((4,)),
                                 jnp.ones((4, 3)), jnp.ones((4,), bool))


def test_accumulate_matches_batched():
    """B sequential accumulate_grad_stats calls == one batched call with
    the summed norms / seen counts (the dp/mesh2d ADC contract)."""
    rng = np.random.default_rng(3)
    alive = jnp.array([True, True, False, True])
    norms = [jnp.asarray(rng.uniform(0, 1, 4).astype(np.float32)
                         * (rng.uniform(0, 1, 4) > 0.3))
             for _ in range(3)]
    a_seq = jnp.zeros((4,))
    s_seq = jnp.zeros((4,))
    for g in norms:
        a_seq, s_seq = dn.accumulate_grad_stats(a_seq, s_seq, g, alive)
    gsum = sum(jnp.where(g > 0, g, 0.0) for g in norms)
    sinc = sum((g > 0).astype(jnp.float32) for g in norms)
    a_b, s_b = dn.accumulate_grad_stats_batched(
        jnp.zeros((4,)), jnp.zeros((4,)), gsum, sinc, alive)
    np.testing.assert_allclose(np.asarray(a_seq), np.asarray(a_b),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(s_seq), np.asarray(s_b))


def test_fit_adaptive_end_to_end():
    """Start under-parameterised, densify during the fit: the live set must
    grow and the fit must improve on the starting PSNR."""
    w = h = 64
    scene = ply_io.make_synthetic_scene(20, seed=11, extent=1.2)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    cam = Camera(0.0, 0.0, -4.0, width=w, height=h)
    full = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    target, _ = render_stats(full, cam, CFG)
    target = np.asarray(target[..., :3])

    start = {k: np.asarray(v)[:6] for k, v in full.items()}
    img0, _ = render_stats({k: jnp.asarray(v) for k, v in start.items()},
                           cam, CFG)
    psnr0 = float(losses.psnr(img0[..., :3], jnp.asarray(target)))

    # densify early (stop at 100), then let the optimiser settle; measured
    # (CPU, deterministic seeds): start 29.42 dB, plain fit 29.62 dB,
    # adaptive 30.17 dB with the live set grown 6 -> 24
    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6,
                          scene_extent=1.2, start_step=0, interval=30,
                          stop_step=100)
    tc = TrainConfig(steps=150, lambda_dssim=0.0, lr_means=3e-3,
                     lr_scales=2e-2, lr_opacities=1e-1, lr_colors=2.0)
    fitted, alive, hist = dn.fit_scene_adaptive(
        start, [target], [cam], CFG, dc, tc=tc, verbose=False, log_every=75)
    assert int(jnp.sum(alive)) > 6, "densification never allocated"
    imgf, _ = render_stats(
        {k: jnp.asarray(v) for k, v in fitted.items()}, cam, CFG)
    psnrf = float(losses.psnr(imgf[..., :3], jnp.asarray(target)))
    assert psnrf > psnr0 + 0.4, (psnr0, psnrf)
    # compaction round-trip keeps only live rows
    compact = dn.compact_params(fitted, alive)
    assert compact["means"].shape[0] == int(jnp.sum(alive))


def test_checkpoint_roundtrip_with_densify_state(tmp_path):
    """Adaptive-training state (alive mask + grad accumulators) rides the
    npz checkpoint as extras and round-trips exactly."""
    raw, _ = _raw_scene(6)
    padded, alive = dn.pad_to_capacity(raw, 8)
    accum = jnp.arange(8, dtype=jnp.float32) * 0.5
    seen = jnp.ones((8,), jnp.float32)
    p = str(tmp_path / "ck.npz")
    trainer.save_checkpoint(p, padded, step=17, alive=alive,
                            grad_accum=accum, seen_count=seen)
    # legacy loader: params + step only, extras invisible
    raw2, step = trainer.load_checkpoint(p)
    assert step == 17 and set(raw2) == set(padded)
    np.testing.assert_array_equal(raw2["means"], np.asarray(padded["means"]))
    # full loader: extras back, exact
    raw3, step3, extras = trainer.load_checkpoint_full(p)
    assert step3 == 17
    np.testing.assert_array_equal(extras["alive"], np.asarray(alive))
    np.testing.assert_array_equal(extras["grad_accum"], np.asarray(accum))
    np.testing.assert_array_equal(extras["seen_count"], np.asarray(seen))


def test_reset_opacity_clamps_and_wipes_moments():
    import optax

    raw, _ = _raw_scene(8)
    padded, alive = dn.pad_to_capacity(raw, 16)
    padded["logit_opacities"] = padded["logit_opacities"].at[:8].set(2.0)

    out = dn.reset_opacity(padded, ceiling=0.01)
    op = np.asarray(trainer.params_from_raw(out)["opacities"])
    assert (op[:8] <= 0.01 + 1e-6).all()
    # dead rows stay dead (far below the ceiling already)
    assert (op[8:] < 1e-6).all()
    # other tensors untouched
    np.testing.assert_array_equal(np.asarray(out["means"]),
                                  np.asarray(padded["means"]))

    tc = trainer.TrainConfig()
    opt = trainer.make_optimizer(tc)
    state = opt.init(padded)
    g = jax.tree.map(jnp.ones_like, padded)
    _, state = opt.update(g, state, padded)
    state2 = dn.reset_opacity_moments(state, 16)

    leaves = jax.tree_util.tree_leaves_with_path(state2)
    touched = wiped = 0
    for path, leaf in leaves:
        in_op = any(getattr(p, "key", None) == "logit_opacities"
                    for p in path)
        if not (hasattr(leaf, "ndim") and leaf.ndim >= 1
                and leaf.shape[0] == 16):
            continue
        if in_op:
            wiped += 1
            assert float(jnp.abs(leaf).max()) == 0.0
        else:
            touched += 1
            assert float(jnp.abs(leaf).max()) > 0.0  # moments survive
    assert wiped >= 2 and touched >= 2  # Adam mu+nu per tensor


def test_adaptive_fit_with_opacity_reset():
    """End-to-end: a reset on the final iteration leaves every opacity at
    or below the ceiling, and the fit still runs to completion."""
    raw, params = _raw_scene(10, seed=5, extent=1.0)
    cam = Camera(0.0, 0.0, -4.0, width=64, height=64)
    img, _ = render_stats(params, cam, CFG)
    target = np.asarray(img[..., :3])

    tc = trainer.TrainConfig(steps=21, lambda_dssim=0.0)
    dc = dn.DensifyConfig(capacity=16, grad_threshold=1e9,  # no densify
                          scene_extent=1.0, start_step=1000,
                          opacity_reset_interval=20)
    fitted, alive, hist = dn.fit_scene_adaptive(
        params, [target], [cam], CFG, dc, tc=tc, verbose=False,
        log_every=10)
    op = np.asarray(fitted["opacities"])[np.asarray(alive)]
    assert (op <= 0.01 + 1e-6).all(), op.max()


def test_adaptive_kill_and_resume_matches(tmp_path):
    """A densify-mode checkpoint taken between densify events resumes to
    the exact uninterrupted trajectory (params + optimizer + alive mask +
    grad accumulators + RNG key all round-trip)."""
    w = h = 64
    scene = ply_io.make_synthetic_scene(20, seed=11, extent=1.2)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    cam = Camera(0.0, 0.0, -4.0, width=w, height=h)
    full = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    target, _ = render_stats(full, cam, CFG)
    target = np.asarray(target[..., :3])
    start = {k: np.asarray(v)[:6] for k, v in full.items()}

    # densify fires at step 6 (interval 6, start 0) -- AFTER the step-4
    # checkpoint, so the resumed run must replay the event identically
    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6,
                          scene_extent=1.2, start_step=0, interval=6,
                          stop_step=10)
    tc = TrainConfig(steps=10, lambda_dssim=0.0, lr_means=3e-3)
    ref, alive_ref, _ = dn.fit_scene_adaptive(
        start, [target], [cam], CFG, dc, tc=tc, seed=3, verbose=False)

    mid = str(tmp_path / "ad.ckpt.npz")
    tc4 = TrainConfig(steps=4, lambda_dssim=0.0, lr_means=3e-3)
    dn.fit_scene_adaptive(start, [target], [cam], CFG, dc, tc=tc4, seed=3,
                          verbose=False, save_every=4, checkpoint_path=mid)
    res, alive_res, _ = dn.fit_scene_adaptive(
        start, [target], [cam], CFG, dc, tc=tc, seed=3, verbose=False,
        resume=mid)
    np.testing.assert_array_equal(np.asarray(alive_ref),
                                  np.asarray(alive_res))
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), np.asarray(res[k]),
                                      err_msg=f"adaptive resume diverged on {k}")
