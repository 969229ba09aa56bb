"""Splat-fitting trainer (optax) -- the differentiable capability the
reference lacks (BASELINE.json north star: gradients to position / scale /
rotation / opacity / colour).

Parameters are optimised in *raw* (pre-activation) space like standard 3DGS
training: log-scales, logit-opacity, unnormalised quaternions, raw colours --
so the optimiser is unconstrained and activations stay in range. Checkpoints
are plain npz pytrees (SURVEY.md section 5, checkpoint row).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.render import render_arrays
from openglgaussiansplattingrenderer_jax.train import losses
from openglgaussiansplattingrenderer_jax.ops.transforms import (
    inverse_sigmoid,
    sigmoid,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_means: float = 1.6e-4
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_colors: float = 2.5e-1      # colours live in 0..255 space
    lambda_dssim: float = 0.2
    steps: int = 200
    # Standard 3DGS position-LR schedule (Kerbl et al. train.py): exponential
    # log-interp decay from lr_means down to lr_means_final over
    # lr_means_decay_steps, both scaled by the caller via scene extent.
    # lr_means_final=None keeps the constant LR (round-1 behaviour).
    lr_means_final: Optional[float] = None
    lr_means_decay_steps: Optional[int] = None


def raw_from_params(params: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """Activated parameters -> unconstrained optimisation space.

    ``sh_rest`` (the 45 view-dependent SH coefficients, already linear)
    rides along when present so it trains too (render with
    ``cfg.sh_degree > 0``)."""
    raw = {
        "means": jnp.asarray(params["means"]),
        "log_scales": jnp.log(jnp.maximum(jnp.asarray(params["scales"]), 1e-30)),
        "quats": jnp.asarray(params["quats"]),
        "logit_opacities": inverse_sigmoid(
            jnp.clip(jnp.asarray(params["opacities"]), 1e-6, 1.0 - 1e-6)),
        "colors": jnp.asarray(params["colors"]),
    }
    if params.get("sh_rest") is not None:
        raw["sh_rest"] = jnp.asarray(params["sh_rest"])
    return raw


def params_from_raw(raw: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """Unconstrained space -> activated render parameters (differentiable)."""
    quats = raw["quats"]
    quats = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True)
    params = {
        "means": raw["means"],
        "scales": jnp.exp(raw["log_scales"]),
        "quats": quats,
        "opacities": sigmoid(raw["logit_opacities"]),
        "colors": raw["colors"],
    }
    if "sh_rest" in raw:
        params["sh_rest"] = raw["sh_rest"]
    return params


@dataclasses.dataclass
class TrainState:
    raw: Dict[str, jnp.ndarray]
    opt_state: optax.OptState
    step: int = 0


def make_optimizer(tc: TrainConfig,
                   keys=("means", "log_scales", "quats", "logit_opacities",
                         "colors")) -> optax.GradientTransformation:
    """Per-tensor Adam. ``keys`` must match the raw pytree (pass
    ``raw.keys()`` when it carries ``sh_rest``). SH coefficients use
    lr_colors / 20, the standard 3DGS ratio for the rest bands."""
    lr_means = tc.lr_means
    if tc.lr_means_final is not None:
        # log-linear interpolation lr(t) = exp(lerp(ln lr0, ln lr1, t/T)),
        # exactly 3DGS's get_expon_lr_func shape.
        steps = tc.lr_means_decay_steps or tc.steps

        def lr_means(count):
            t = jnp.clip(count / steps, 0.0, 1.0)
            return jnp.exp((1.0 - t) * jnp.log(tc.lr_means)
                           + t * jnp.log(tc.lr_means_final))

    lrs = {
        "means": lr_means,
        "log_scales": tc.lr_scales,
        "quats": tc.lr_quats,
        "logit_opacities": tc.lr_opacities,
        "colors": tc.lr_colors,
        "sh_rest": tc.lr_colors / 20.0,
    }
    keys = tuple(keys)
    return optax.multi_transform(
        {k: optax.adam(lrs[k]) for k in keys},
        {k: k for k in keys},
    )


def make_train_step(cfg: RenderConfig, tc: TrainConfig, width: int,
                    height: int,
                    loss_fn: Optional[Callable] = None,
                    with_grad_norms: bool = False,
                    grad_stat: str = "screen",
                    param_keys=None) -> Callable:
    """Jitted (state, target, camera args) -> (state, metrics) step.

    ``with_grad_norms`` adds a per-splat ``densify_grad_norm`` (N,) array to
    the metrics -- the selection statistic for adaptive density control
    (train/densify.py). ``grad_stat`` picks it:

    - ``"screen"`` (default): the SCREEN-space positional gradient, exactly
      3DGS's statistic (graphdeco gaussian_renderer: the grad of a zero
      ``viewspace_point_tensor`` added to the rasterized means2D). Computed
      here as the grad w.r.t. a zero per-splat shift injected after
      preprocess, scaled by (W/2, H/2) so the units are NDC -- resolution-
      independent, matching graphdeco's threshold calibration (2e-4).
    - ``"world"``: the 3D dL/d means norm (rounds 1-2 behaviour; ranking
      correlates with screen-space at Spearman rho ~ 0.81 / top-10%
      overlap ~ 0.6 on a deep scene -- tests/test_densify_trigger.py).

    ``param_keys`` must name the raw pytree's keys when they differ from
    the default five (e.g. ``sh_rest`` training).
    """
    if grad_stat not in ("screen", "world"):
        raise ValueError(f"unknown grad_stat {grad_stat!r}")
    optimizer = (make_optimizer(tc) if param_keys is None
                 else make_optimizer(tc, keys=param_keys))
    screen = with_grad_norms and grad_stat == "screen"

    def loss_of(raw, shift2d, target, view, vp, fx, fy, tfx, tfy):
        params = params_from_raw(raw)
        if shift2d is not None:
            params["shift2d"] = shift2d
        img, _ = render_arrays(params, view, vp, fx, fy, tfx, tfy,
                               width, height, cfg)
        pred = img[..., :3]
        if loss_fn is not None:
            return loss_fn(pred, target), pred
        return losses.gs_loss(pred, target, tc.lambda_dssim), pred

    @jax.jit
    def step(raw, opt_state, target, view, vp, fx, fy, tfx, tfy):
        if screen:
            shift = jnp.zeros((raw["means"].shape[0], 2), jnp.float32)
            (loss, pred), (grads, gshift) = jax.value_and_grad(
                loss_of, argnums=(0, 1), has_aux=True)(
                raw, shift, target, view, vp, fx, fy, tfx, tfy)
            # pixel-grads scaled to NDC units (x_ndc = 2 x_px / W)
            gnorm = jnp.linalg.norm(
                gshift * jnp.array([width / 2.0, height / 2.0]), axis=-1)
        else:
            (loss, pred), grads = jax.value_and_grad(
                loss_of, has_aux=True)(
                raw, None, target, view, vp, fx, fy, tfx, tfy)
            gnorm = (jnp.linalg.norm(grads["means"], axis=-1)
                     if with_grad_norms else None)
        updates, opt_state = optimizer.update(grads, opt_state, raw)
        raw = optax.apply_updates(raw, updates)
        return raw, opt_state, loss, losses.psnr(pred, target), gnorm

    def run(state: TrainState, target, view, vp, fx, fy, tfx, tfy
            ) -> Tuple[TrainState, Dict[str, float]]:
        raw, opt_state, loss, p, gnorm = step(
            state.raw, state.opt_state, target, view, vp, fx, fy, tfx, tfy)
        metrics = {"loss": loss, "psnr": p}
        if with_grad_norms:
            metrics["densify_grad_norm"] = gnorm
        return TrainState(raw, opt_state, state.step + 1), metrics

    run.init = lambda raw: TrainState(raw, optimizer.init(raw), 0)
    run.step = step   # the jitted step, for lowering and memory analysis
    return run


def camera_dims(cam) -> Tuple[int, int]:
    """(width, height) of a Camera or an ``io.dataset`` bundle dict."""
    if isinstance(cam, dict):
        return int(cam["width"]), int(cam["height"])
    return cam.width, cam.height


def camera_bundles(cameras):
    """Per-camera jitted-step argument tuples (view, vp, focals, tanfovs) --
    shared by ``fit_scene`` and ``densify.fit_scene_adaptive`` so the
    argument-order quirks live in one place. Each entry is a ``Camera`` or
    an ``io.dataset`` bundle dict (posed-image datasets)."""
    from openglgaussiansplattingrenderer_jax.render import camera_args

    bundles = []
    for cam in cameras:
        a = cam if isinstance(cam, dict) else camera_args(cam)
        bundles.append((jnp.asarray(a["view"]), jnp.asarray(a["vp"]),
                        a["focal_x"], a["focal_y"], a["tan_fovx"],
                        a["tan_fovy"]))
    return bundles


def fit_scene(params: Dict[str, jnp.ndarray], targets, cameras,
              cfg: RenderConfig, tc: Optional[TrainConfig] = None,
              width: Optional[int] = None, height: Optional[int] = None,
              log_every: int = 50, verbose: bool = True,
              save_every: int = 0, checkpoint_path: Optional[str] = None,
              resume: Optional[str] = None):
    """Fit splat parameters to (target image, camera) pairs.

    targets: list of (H, W, 3) arrays; cameras: list of Camera. Returns
    (activated params, history).

    ``save_every``/``checkpoint_path`` write a full-state npz (raw params +
    optimizer moments + step) every N steps; ``resume`` restores one and
    continues from its step -- the resumed run replays the exact step
    sequence, so it matches an uninterrupted run bit-for-bit
    (tests/test_train_cli.py kill-and-resume test).
    """
    tc = tc or TrainConfig()
    width = width or camera_dims(cameras[0])[0]
    height = height or camera_dims(cameras[0])[1]
    raw = raw_from_params(params)
    step = make_train_step(cfg, tc, width, height,
                           param_keys=tuple(sorted(raw.keys())))
    state = step.init(raw)
    start_step = 0
    if resume:
        r_raw, start_step, extras = load_checkpoint_full(resume)
        check_resume_shapes(raw, r_raw, resume)
        opt = (restore_opt_state(state.opt_state, extras["opt_leaves"])
               if "opt_leaves" in extras else state.opt_state)
        state = TrainState({k: jnp.asarray(v) for k, v in r_raw.items()},
                           opt, start_step)
        if verbose:
            print(f"resumed {resume} at step {start_step}")
    cam_bundles = camera_bundles(cameras)
    targets = [jnp.asarray(t, jnp.float32) for t in targets]

    history = []
    for i in range(start_step, tc.steps):
        j = i % len(targets)
        state, metrics = step(state, targets[j], *cam_bundles[j])
        if (i % log_every == 0 or i == tc.steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            if verbose:
                print(f"step {i}: loss {m['loss']:.5f} psnr {m['psnr']:.2f}")
        if (save_every and checkpoint_path
                and ((i + 1) % save_every == 0 or i == tc.steps - 1)):
            save_checkpoint(checkpoint_path, state.raw, step=i + 1,
                            opt_state=state.opt_state)
    return params_from_raw(state.raw), history


def save_checkpoint(path: str, raw: Dict[str, jnp.ndarray], step: int = 0,
                    opt_state=None, **extras) -> None:
    """npz pytree checkpoint. ``extras`` holds any additional arrays --
    e.g. adaptive-density state (``alive``, ``grad_accum``, ``seen_count``)
    -- namespaced with an ``x_`` prefix so they never collide with
    parameter names. ``opt_state`` (any optax state pytree) is flattened
    to leaves ``o_<i>``; restore with ``restore_opt_state`` against a
    freshly-initialised state of the same optimizer.

    Written atomically (tmp file + rename) so a kill mid-save never leaves
    a truncated checkpoint behind.
    """
    opt = {}
    if opt_state is not None:
        leaves = jax.tree_util.tree_leaves(opt_state)
        opt = {f"o_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    import os

    tmp = path + ".tmp.npz"  # np.savez appends .npz to other suffixes anyway
    np.savez(tmp, step=step,
             **{k: np.asarray(v) for k, v in raw.items()},
             **opt,
             **{f"x_{k}": np.asarray(v) for k, v in extras.items()})
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def restore_opt_state(template, opt_leaves):
    """Rebuild an optax state from checkpointed leaves: ``template`` is
    ``optimizer.init(raw)`` for the SAME optimizer config; the leaves were
    saved in ``jax.tree_util.tree_leaves`` order."""
    treedef = jax.tree_util.tree_structure(template)
    t_leaves = jax.tree_util.tree_leaves(template)
    if len(t_leaves) != len(opt_leaves):
        raise ValueError(
            f"checkpointed optimizer state has {len(opt_leaves)} leaves, "
            f"this optimizer wants {len(t_leaves)} -- was it saved with a "
            "different optimizer config or parameter set?")
    for i, (v, t) in enumerate(zip(opt_leaves, t_leaves)):
        if np.shape(v) != jnp.shape(t):
            raise ValueError(
                f"checkpointed optimizer leaf {i} has shape "
                f"{np.shape(v)}, this run wants {jnp.shape(t)} -- was the "
                "checkpoint saved at a different capacity / densify "
                "configuration or parameter set?")
    leaves = [jnp.asarray(v, t.dtype) for v, t in zip(opt_leaves, t_leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def check_resume_shapes(current_raw, loaded_raw, resume: str) -> None:
    """Fail fast with a clear message when a resume checkpoint's parameter
    shapes don't match the run being resumed (wrong capacity, different
    scene, or an ADC run resumed from a non-ADC checkpoint)."""
    missing = set(current_raw) - set(loaded_raw)
    if missing:
        raise ValueError(
            f"resume checkpoint {resume!r} is missing parameters "
            f"{sorted(missing)} this run trains")
    extra = set(loaded_raw) - set(current_raw)
    if extra:
        raise ValueError(
            f"resume checkpoint {resume!r} carries parameters "
            f"{sorted(extra)} this run does not train -- resuming would "
            "silently drop them (was the checkpoint saved with sh_rest / "
            "a different parameter set?)")
    for k, v in current_raw.items():
        if np.shape(loaded_raw[k]) != jnp.shape(v):
            raise ValueError(
                f"resume checkpoint {resume!r}: parameter {k!r} has shape "
                f"{np.shape(loaded_raw[k])}, this run wants "
                f"{jnp.shape(v)} -- wrong capacity / densify "
                "configuration / scene?")


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """Returns (raw params, step); extras are ignored (see
    ``load_checkpoint_full``)."""
    raw, step, _ = load_checkpoint_full(path)
    return raw, step


def load_checkpoint_full(
    path: str,
) -> Tuple[Dict[str, np.ndarray], int, Dict[str, np.ndarray]]:
    """Returns (raw params, step, extras) -- extras as saved via
    ``save_checkpoint(..., name=array)``, prefix stripped. Checkpointed
    optimizer leaves (``o_<i>``) land in extras as ``opt_leaves`` (a list
    in saved order) for ``restore_opt_state``."""
    import os

    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    z = np.load(path)
    raw = {k: z[k] for k in z.files
           if k != "step" and not k.startswith(("x_", "o_"))}
    extras = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    okeys = sorted((k for k in z.files if k.startswith("o_")),
                   key=lambda k: int(k[2:]))
    if okeys:
        extras["opt_leaves"] = [z[k] for k in okeys]
    return raw, int(z["step"]), extras
