"""View-parallel (data-parallel) training: views sharded, grads psum'd.

The splat-sharded fast path (``parallel/fast_sharded.py``) scales a SINGLE
frame across chips. Production 3DGS training more commonly scales the other
axis: a BATCH of training views per optimizer step, one (or more) views per
chip with the splat parameters replicated. Each chip renders its views with
the unmodified single-device fast path -- all Pallas kernels, zero
cross-chip traffic inside the frame -- computes its local loss gradients,
and one ``pmean`` synchronizes the update. Per-device work is a full
forward+backward (hundreds of ms at real scale) against one ~60 MB gradient
all-reduce, the classic compute-bound data-parallel regime.

Composable with the splat-sharded path over a 2-D mesh in principle (views
x splats); this module keeps the 1-D view axis -- the configuration that
matches how 3DGS training is actually scaled in practice (batch size =
chip count, e.g. Grendel-GS's data-parallel axis).

The reference is strictly single-GPU and has no training at all
(SURVEY.md section 2.4); this layer is north-star capability on top.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.parallel.sharded import (
    AXIS,
    make_mesh,
    shard_map,
)
from openglgaussiansplattingrenderer_jax.render import render_arrays
from openglgaussiansplattingrenderer_jax.train import losses
from openglgaussiansplattingrenderer_jax.train.trainer import (
    TrainConfig,
    make_optimizer,
    params_from_raw,
)

__all__ = ["make_mesh", "stack_view_batch", "make_dp_train_step",
           "replicate_tree", "fit_scene_dp"]


def stack_view_batch(targets, bundles) -> Tuple[jnp.ndarray, ...]:
    """(targets list, camera_bundles list) -> batched step arguments.

    Returns (targets (B,H,W,3), view (B,4,4), vp (B,4,4), fx, fy, tfx, tfy
    each (B,)) ready for ``make_dp_train_step``'s batch axis. ``bundles``
    are ``trainer.camera_bundles`` tuples.
    """
    t = jnp.stack([jnp.asarray(x, jnp.float32) for x in targets])
    view = jnp.stack([jnp.asarray(b[0], jnp.float32) for b in bundles])
    vp = jnp.stack([jnp.asarray(b[1], jnp.float32) for b in bundles])
    sc = [jnp.stack([jnp.asarray(b[i], jnp.float32) for b in bundles])
          for i in (2, 3, 4, 5)]
    return (t, view, vp, *sc)


def replicate_tree(tree, mesh):
    """Place a pytree fully replicated over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


def make_dp_train_step(cfg: RenderConfig, tc: TrainConfig, width: int,
                       height: int, mesh, *, batch: int,
                       axis: str = AXIS,
                       param_keys=None,
                       with_grad_norms: bool = False):
    """Jitted data-parallel train step over a ``batch`` of views.

    ``batch`` must be a multiple of the mesh size; each chip renders
    ``batch // ndev`` views sequentially (static unroll) and contributes
    mean-of-local gradients to one ``pmean``. The optimizer update then
    runs identically on every chip (raw params and Adam state stay
    replicated -- no broadcast needed).

    Step signature: ``(raw, opt_state, targets (B,H,W,3), view (B,4,4),
    vp (B,4,4), fx, fy, tfx, tfy (B,)) -> (raw, opt_state, loss, psnr
    [, densify_grad_norm])``. Loss/psnr are batch means. With
    ``with_grad_norms``, the per-splat screen-space densification statistic
    (see trainer.make_train_step) is SUMMED over the batch's views --
    one dp step counts as ``batch`` view-iterations toward the
    densification accumulators, exactly like ``batch`` sequential steps --
    and a matching ``seen`` count (in how many of the batch's views each
    splat was visible) is returned alongside, so adaptive density control
    normalises by view-iterations exactly as the sequential loop does.
    """
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if batch % ndev:
        raise ValueError(f"batch {batch} not a multiple of mesh size {ndev}")
    local_bs = batch // ndev
    optimizer = (make_optimizer(tc) if param_keys is None
                 else make_optimizer(tc, keys=param_keys))

    def loss_of(raw, shift2d, target, view, vp, fx, fy, tfx, tfy):
        params = params_from_raw(raw)
        if shift2d is not None:
            params["shift2d"] = shift2d
        img, _ = render_arrays(params, view, vp, fx, fy, tfx, tfy,
                               width, height, cfg)
        pred = img[..., :3]
        return losses.gs_loss(pred, target, tc.lambda_dssim), pred

    def body(raw, opt_state, targets, view, vp, fx, fy, tfx, tfy):
        # local leading axis: (local_bs, ...) views owned by this chip
        n = raw["means"].shape[0]
        grads = None
        gnorm = jnp.zeros((n,), jnp.float32)
        seen = jnp.zeros((n,), jnp.float32)
        loss_acc = 0.0
        psnr_acc = 0.0
        for j in range(local_bs):
            args = (targets[j], view[j], vp[j], fx[j], fy[j], tfx[j], tfy[j])
            if with_grad_norms:
                shift = jnp.zeros((n, 2), jnp.float32)
                (loss, pred), (g, gshift) = jax.value_and_grad(
                    loss_of, argnums=(0, 1), has_aux=True)(raw, shift, *args)
                nrm = jnp.linalg.norm(
                    gshift * jnp.array([width / 2.0, height / 2.0]), axis=-1)
                gnorm = gnorm + nrm
                seen = seen + (nrm > 0.0)
            else:
                (loss, pred), g = jax.value_and_grad(
                    loss_of, has_aux=True)(raw, None, *args)
            grads = g if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, g)
            loss_acc = loss_acc + loss
            psnr_acc = psnr_acc + losses.psnr(pred, targets[j])
        grads = jax.tree_util.tree_map(lambda x: x / local_bs, grads)
        # one all-reduce syncs the batch-mean gradient
        grads = jax.lax.pmean(grads, axis)
        loss_m = jax.lax.pmean(loss_acc / local_bs, axis)
        psnr_m = jax.lax.pmean(psnr_acc / local_bs, axis)
        updates, opt_state = optimizer.update(grads, opt_state, raw)
        raw = optax.apply_updates(raw, updates)
        if with_grad_norms:
            # densification statistic: SUM of per-view norms (batch view-
            # iterations), like sequential 3DGS accumulation; seen = in how
            # many views this splat contributed pixels
            gnorm = jax.lax.psum(gnorm, axis)
            seen = jax.lax.psum(seen, axis)
            return raw, opt_state, loss_m, psnr_m, gnorm, seen
        return raw, opt_state, loss_m, psnr_m

    rep, shd = P(), P(axis)
    n_out = 6 if with_grad_norms else 4
    step = jax.jit(shard_map(
        body, mesh,
        in_specs=(rep, rep, shd, shd, shd, shd, shd, shd, shd),
        out_specs=(rep,) * n_out))

    step.init = lambda raw: optimizer.init(raw)
    return step


def fit_scene_dp(params: Dict[str, jnp.ndarray], targets, cameras,
                 cfg: RenderConfig, tc: Optional[TrainConfig] = None,
                 *, mesh=None, batch: Optional[int] = None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 dc=None, seed: int = 0,
                 save_every: int = 0, checkpoint_path: Optional[str] = None,
                 resume: Optional[str] = None,
                 log_every: int = 50, verbose: bool = True):
    """``trainer.fit_scene`` with view-parallel batching.

    Each optimizer step consumes ``batch`` views (default: one per mesh
    device), cycling through the view list; ``tc.steps`` optimizer steps
    therefore see ``steps * batch`` view-iterations. Returns (activated
    params, history) like ``fit_scene``.

    ``dc`` (a ``train.densify.DensifyConfig``) composes adaptive density
    control with the view-parallel axis: parameters are padded to
    ``dc.capacity`` (replicated), the train step additionally returns the
    batch-summed screen-space statistic + per-view seen counts (psum'd over
    the mesh), and ``densify_and_prune`` runs as the identical single-stream
    program on the replicated state every ``dc.interval`` optimizer steps --
    a batch-B interval therefore spans B x interval view-iterations. A
    dp+ADC run on D devices equals the same run on 1 device to float
    tolerance (tests/test_data_parallel.py). With ``dc`` the return is
    (params at capacity, alive mask, history) like ``fit_scene_adaptive``.

    ``save_every``/``checkpoint_path``/``resume`` as in
    ``trainer.fit_scene``: the replicated state round-trips through the
    same npz format (one host copy), so a killed multi-device fit resumes
    exactly -- including the densify state when ``dc`` is set.
    """
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        camera_bundles,
        camera_dims,
        raw_from_params,
    )

    tc = tc or TrainConfig()
    mesh = mesh if mesh is not None else make_mesh()
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    batch = batch or ndev
    width = width or camera_dims(cameras[0])[0]
    height = height or camera_dims(cameras[0])[1]

    raw = raw_from_params(params)
    alive = grad_accum = seen_count = key = None
    if dc is not None:
        from openglgaussiansplattingrenderer_jax.train import densify as dn

        raw, alive = dn.pad_to_capacity(raw, dc.capacity)
        grad_accum = jnp.zeros((dc.capacity,), jnp.float32)
        seen_count = jnp.zeros((dc.capacity,), jnp.float32)
        key = jax.random.PRNGKey(seed)
    raw = replicate_tree(raw, mesh)
    step = make_dp_train_step(cfg, tc, width, height, mesh, batch=batch,
                              param_keys=tuple(sorted(raw.keys())),
                              with_grad_norms=dc is not None)
    opt_state = step.init(raw)
    start_step = 0
    if resume:
        from openglgaussiansplattingrenderer_jax.train.trainer import (
            check_resume_shapes,
            load_checkpoint_full,
            restore_opt_state,
        )

        r_raw, start_step, extras = load_checkpoint_full(resume)
        check_resume_shapes(raw, r_raw, resume)
        raw = replicate_tree(
            {k: jnp.asarray(v) for k, v in r_raw.items()}, mesh)
        if "opt_leaves" in extras:
            opt_state = replicate_tree(
                restore_opt_state(opt_state, extras["opt_leaves"]), mesh)
        if dc is not None:
            if "alive" not in extras:
                raise ValueError(
                    f"resume checkpoint {resume!r} carries no densify "
                    "state (alive/grad_accum/...) -- was it saved from a "
                    "run without adaptive density control?")
            alive = jnp.asarray(extras["alive"])
            grad_accum = jnp.asarray(extras["grad_accum"])
            seen_count = jnp.asarray(extras["seen_count"])
            key = jnp.asarray(extras["rng_key"])
        if verbose:
            print(f"resumed {resume} at step {start_step}")
    bundles = camera_bundles(cameras)
    targets = [np.asarray(t, np.float32) for t in targets]

    history = []
    nv = len(targets)
    for i in range(start_step, tc.steps):
        sel = [(i * batch + j) % nv for j in range(batch)]
        args = stack_view_batch([targets[s] for s in sel],
                                [bundles[s] for s in sel])
        if dc is None:
            raw, opt_state, loss, p = step(raw, opt_state, *args)
        else:
            from openglgaussiansplattingrenderer_jax.train import densify as dn

            raw, opt_state, loss, p, gnorm, seen = step(
                raw, opt_state, *args)
            grad_accum, seen_count = dn.accumulate_grad_stats_batched(
                grad_accum, seen_count, gnorm, seen, alive)
            if (dc.start_step <= i < dc.stop_step and i > 0
                    and i % dc.interval == 0):
                key, sub = jax.random.split(key)
                raw, alive, changed, dstats = dn.densify_and_prune(
                    raw, alive, grad_accum, seen_count, sub, dc)
                opt_state = dn.reset_rows(opt_state, changed)
                # deterministic replacement: state stays mesh-replicated
                raw = replicate_tree(raw, mesh)
                opt_state = replicate_tree(opt_state, mesh)
                alive = jnp.asarray(alive)
                grad_accum = jnp.zeros_like(grad_accum)
                seen_count = jnp.zeros_like(seen_count)
                if verbose:
                    d = {k: int(v) for k, v in dstats.items()}
                    print(f"step {i}: densify {d}")
            if (dc.opacity_reset_interval and i > 0 and i < dc.stop_step
                    and i % dc.opacity_reset_interval == 0):
                raw = replicate_tree(
                    dn.reset_opacity(raw, dc.opacity_reset_ceiling), mesh)
                opt_state = replicate_tree(
                    dn.reset_opacity_moments(opt_state, dc.capacity), mesh)
        if i % log_every == 0 or i == tc.steps - 1:
            m = {"loss": float(loss), "psnr": float(p)}
            if dc is not None:
                m["alive"] = int(jnp.sum(alive))
            history.append({"step": i, **m})
            if verbose:
                print(f"step {i}: loss {m['loss']:.5f} "
                      f"psnr {m['psnr']:.2f} (batch {batch})")
        if (save_every and checkpoint_path
                and ((i + 1) % save_every == 0 or i == tc.steps - 1)):
            from openglgaussiansplattingrenderer_jax.train.trainer import (
                save_checkpoint,
            )

            extras = {}
            if dc is not None:
                extras = dict(alive=alive, grad_accum=grad_accum,
                              seen_count=seen_count, rng_key=key)
            save_checkpoint(checkpoint_path,
                            {k: np.asarray(v) for k, v in raw.items()},
                            step=i + 1, opt_state=opt_state, **extras)
    if dc is not None:
        return params_from_raw(raw), alive, history
    return params_from_raw(raw), history
