"""Gradient correctness (capability the reference lacks; BASELINE.json north star).

Checks jax.grad of an image loss against central finite differences. The
pipeline has step discontinuities (frustum cull, tile assignment, the 1/255
alpha cutoff and 0.99 saturation mask), so the test scene keeps splats well
inside the frustum with mid-range alphas where the loss is locally smooth.
"""

import numpy as np
import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays

CFG = RenderConfig(use_pallas=False, max_per_tile=512, chunk=64)
W = H = 64


def _scene_and_args():
    scene = ply_io.make_synthetic_scene(20, seed=5, extent=1.0)
    # soften opacities away from the cutoffs
    scene["opacities"] = np.clip(scene["opacities"], 0.3, 0.7)
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    args = camera_args(cam)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    return params, args


def _loss_fn(params, args, target):
    img, _ = render_arrays(
        params, jnp.asarray(args["view"]), jnp.asarray(args["vp"]),
        args["focal_x"], args["focal_y"], args["tan_fovx"], args["tan_fovy"],
        W, H, CFG,
    )
    return jnp.mean((img[..., :3] - target) ** 2)


def test_grad_runs_and_is_finite():
    params, args = _scene_and_args()
    target = jnp.zeros((H, W, 3))
    grads = jax.grad(_loss_fn)(params, args, target)
    for k, g in grads.items():
        assert np.all(np.isfinite(np.asarray(g))), k
    # colour gradient must be nonzero for visible splats
    assert np.abs(np.asarray(grads["colors"])).max() > 0


def test_grad_matches_finite_differences():
    """Directional-derivative check per parameter tensor.

    Single-entry probes are unreliable here: the pipeline has genuine step
    discontinuities (the 1/255 alpha cutoff, 3-sigma tile boundary crossings,
    the 0.99 saturation mask), so a probe that lands on a step measures the
    step, not the gradient. A random direction over the whole tensor averages
    the steps out; we require agreement on the directional derivative.
    """
    params, args = _scene_and_args()
    target = jnp.full((H, W, 3), 0.1)
    loss = lambda p: _loss_fn(p, args, target)
    grads = jax.grad(loss)(params)

    rng = np.random.default_rng(0)
    f64 = {k: np.asarray(v, np.float64) for k, v in params.items()}
    for key, eps in [("colors", 1e-1), ("opacities", 1e-3), ("means", 1e-3),
                     ("scales", 1e-3), ("quats", 1e-3)]:
        g = np.asarray(grads[key], np.float64)
        errs = []
        for probe in range(5):
            d = rng.normal(size=g.shape)
            d /= np.linalg.norm(d)
            want = float(np.sum(g * d))
            pert_p = {k: v.copy() for k, v in f64.items()}
            pert_m = {k: v.copy() for k, v in f64.items()}
            pert_p[key] = pert_p[key] + eps * d
            pert_m[key] = pert_m[key] - eps * d
            lp = float(loss({k: jnp.asarray(v, jnp.float32) for k, v in pert_p.items()}))
            lm = float(loss({k: jnp.asarray(v, jnp.float32) for k, v in pert_m.items()}))
            fd = (lp - lm) / (2 * eps)
            denom = max(abs(want), abs(fd), 1e-6)
            errs.append(abs(fd - want) / denom)
        errs = np.sort(errs)
        # median of 5 probes must agree within 15%
        assert errs[2] < 0.15, f"{key}: rel errs {errs}"


def test_grad_matches_finite_differences_tight_10k():
    """Tight directional FD check at 10k splats (VERDICT r1 item #10).

    Probes along the gradient direction itself with eps sized so the loss
    delta (~1e-3) towers over f32 loss resolution; at this scale the step
    discontinuities average out and autodiff must match central differences
    within 5% on every parameter tensor (the baseline_eval config-3 gate,
    now in-suite and CPU-runnable).
    """
    import jax

    w = h = 256
    cfg = RenderConfig.for_resolution(w, h, tile_px=32, use_pallas=False,
                                      max_per_tile=1024, chunk=128,
                                      dup_capacity_factor=8.0)
    scene = ply_io.make_synthetic_scene(10_000, seed=11, extent=3.0,
                                        log_scale_range=(-5.0, -3.0))
    cam = Camera(0.0, 0.0, -8.0, width=w, height=h)
    args = camera_args(cam)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    target = jnp.zeros((h, w, 3))

    def loss_fn(p):
        img, _ = render_arrays(
            p, jnp.asarray(args["view"]), jnp.asarray(args["vp"]),
            args["focal_x"], args["focal_y"], args["tan_fovx"],
            args["tan_fovy"], w, h, cfg)
        return jnp.mean((img[..., :3] - target) ** 2)

    grads = jax.jit(jax.grad(loss_fn))(params)
    loss_jit = jax.jit(loss_fn)
    worst = {}
    for key in ("colors", "means", "scales", "opacities", "quats"):
        g = np.asarray(grads[key], np.float64)
        gn = np.linalg.norm(g)
        d = (g / max(gn, 1e-30)).astype(np.float32)
        eps = float(np.clip(5e-4 / max(gn, 1e-12), 1e-4, 50.0))
        pp = dict(params)
        pp[key] = params[key] + eps * d
        lp = float(loss_jit(pp))
        pp[key] = params[key] - eps * d
        lm = float(loss_jit(pp))
        fd = (lp - lm) / (2 * eps)
        worst[key] = abs(fd - gn) / max(abs(gn), abs(fd), 1e-12)
    assert max(worst.values()) < 0.05, f"directional FD rel errs: {worst}"
