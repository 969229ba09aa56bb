"""Adaptive density control (densify / split / prune) under static shapes.

The reference renders a fixed splat set (no training at all); real 3DGS
training grows and shrinks the set during optimisation (Kerbl et al. sec.
5.2: clone under-reconstructed small Gaussians, split over-reconstructed
large ones, prune transparent ones). GPU implementations realloc tensors
per densify step -- under jit that would retrace and recompile the whole
pipeline every interval. Instead everything here is **capacity-static**:

- parameters are allocated once at ``capacity`` rows; a boolean ``alive``
  row mask tracks the live set;
- dead rows carry ``logit_opacity = DEAD_LOGIT`` and ``log_scales =
  DEAD_LOG_SCALE`` so the renderer culls them for ~free (alpha ~ 2e-9 is
  below the 1/255 cutoff, so the expand kernel's reachability cull drops
  their records before the sort and the compositor);
- clone/split allocate into dead slots via rank-matching (k-th strongest
  candidate -> k-th free slot), all inside one jitted function -- no
  host syncs, no shape changes, no recompiles.

Selection statistic (``DensifyConfig.statistic``): the accumulated,
visibility-normalised L2 norm of the positional gradient, in one of two
spaces. ``"screen"`` (default) is exactly the original 3DGS statistic --
graphdeco's ``viewspace_point_tensor`` trick, i.e. the gradient of a zero
shift added to the rasterized means2D, in resolution-independent NDC
units (trainer.make_train_step grad_stat). ``"world"`` is the 3D
dL/d means norm (rounds 1-2 behaviour). The two RANKINGS correlate but
are not identical -- measured Spearman rho ~ 0.81 with ~60% top-decile
overlap on a deep scene (tests/test_densify_trigger.py) -- which is why
the 3DGS-faithful screen statistic is the default; the threshold then
carries graphdeco's own calibration (2e-4).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.ops.transforms import (
    inverse_sigmoid,
    quat_to_rotmat,
)

DEAD_LOGIT = -20.0        # sigmoid(-20) ~ 2e-9 << 1/255 -> culled at expand
DEAD_LOG_SCALE = -20.0    # radius ~ 0 -> at most one (culled) record


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    capacity: int                     # static row count (>= initial splats)
    grad_threshold: float = 2e-4      # accumulated positional-grad trigger
    statistic: str = "screen"         # "screen" (3DGS-exact) | "world"
    percent_dense: float = 0.01       # split if max scale > this * extent
    scene_extent: float = 1.0         # world-space scene radius
    min_opacity: float = 0.005        # prune below this (3DGS default)
    split_factor: float = 1.6         # new scales = old / split_factor
    start_step: int = 50
    stop_step: int = 1_000_000
    interval: int = 100               # densify every N steps
    # Periodic opacity reset (3DGS train.py: every 3000 steps, clamp all
    # opacities to <= reset ceiling and wipe the opacity optimizer moments)
    # -- kills floaters the pruning pass would otherwise keep forever.
    # 0 disables (default; the short fits in tests don't need it).
    opacity_reset_interval: int = 0
    opacity_reset_ceiling: float = 0.01


def pad_to_capacity(
    raw: Dict[str, jnp.ndarray], capacity: int
) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
    """Pad raw (pre-activation) parameters to ``capacity`` rows.

    Returns (padded raw, alive mask). Dead rows are parked with tiny
    opacity/scale (see module docstring) and identity quaternions.
    """
    n = raw["means"].shape[0]
    if n > capacity:
        raise ValueError(f"{n} splats exceed densify capacity {capacity}")
    pad = capacity - n

    def pad_rows(x, fill):
        tail = jnp.full((pad,) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([x, tail], axis=0)

    quat_tail = jnp.zeros((pad, 4), raw["quats"].dtype).at[:, 0].set(1.0)
    padded = {
        "means": pad_rows(raw["means"], 0.0),
        "log_scales": pad_rows(raw["log_scales"], DEAD_LOG_SCALE),
        "quats": jnp.concatenate([raw["quats"], quat_tail], axis=0),
        "logit_opacities": pad_rows(raw["logit_opacities"], DEAD_LOGIT),
        "colors": pad_rows(raw["colors"], 0.0),
    }
    if "sh_rest" in raw:
        padded["sh_rest"] = pad_rows(raw["sh_rest"], 0.0)
    alive = jnp.arange(capacity) < n
    return padded, alive


def reset_opacity(raw: Dict[str, jnp.ndarray],
                  ceiling: float = 0.01) -> Dict[str, jnp.ndarray]:
    """Clamp every row's opacity to <= ceiling (3DGS's periodic reset).
    Dead rows sit at DEAD_LOGIT far below any sensible ceiling, so the
    clamp is a no-op for them."""
    cap_logit = inverse_sigmoid(jnp.float32(ceiling))
    lo = raw["logit_opacities"]
    return dict(raw, logit_opacities=jnp.minimum(lo, cap_logit))


def reset_opacity_moments(opt_state, capacity: int):
    """Zero the optimizer moments of the ``logit_opacities`` tensor (the
    original replaces the opacity optimizer state wholesale after a reset
    -- stale Adam moments would immediately push opacities back up)."""
    def f(path, leaf):
        in_op = any(getattr(p, "key", None) == "logit_opacities"
                    for p in path)
        if (in_op and hasattr(leaf, "ndim") and leaf.ndim >= 1
                and leaf.shape[0] == capacity):
            return jnp.zeros_like(leaf)
        return leaf

    return jax.tree_util.tree_map_with_path(f, opt_state)


def _rank_index(mask: jnp.ndarray, order_key: jnp.ndarray) -> jnp.ndarray:
    """Indices of ``mask``'s True rows, strongest ``order_key`` first, as a
    full-capacity array (rows past the True count are junk -- callers gate
    on the count). Static-shape replacement for ``nonzero``."""
    key = jnp.where(mask, order_key, jnp.inf)
    return jnp.argsort(key, stable=True)


def reset_rows(opt_state, changed: jnp.ndarray):
    """Zero optimizer moment rows for changed slots (new/rewritten splats
    must not inherit stale Adam moments). Leaves whose leading axis matches
    the capacity are masked; scalars (Adam step counts) pass through."""
    cap = changed.shape[0]

    def f(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == cap:
            m = changed.reshape((cap,) + (1,) * (leaf.ndim - 1))
            return jnp.where(m, jnp.zeros_like(leaf), leaf)
        return leaf

    return jax.tree.map(f, opt_state)


@functools.partial(jax.jit, static_argnames=("dc",))
def densify_and_prune(
    raw: Dict[str, jnp.ndarray],
    alive: jnp.ndarray,
    grad_accum: jnp.ndarray,
    seen_count: jnp.ndarray,
    key: jax.Array,
    dc: DensifyConfig,
) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray]]:
    """One adaptive-density step. Fully jitted, static shapes throughout.

    Returns (new raw, new alive, changed-row mask, stats). ``changed`` rows
    must have their optimizer moments reset (``reset_rows``) and the caller
    zeroes the gradient accumulators.
    """
    cap = alive.shape[0]
    opacities = jax.nn.sigmoid(raw["logit_opacities"])
    scales = jnp.exp(raw["log_scales"])

    # -- prune: transparent splats die; their slots free up immediately ----
    keep = alive & (opacities >= dc.min_opacity)
    pruned = jnp.sum(alive & ~keep)
    alive = keep

    # -- candidates: visible often enough, average grad above threshold ----
    avg_grad = grad_accum / jnp.maximum(seen_count, 1.0)
    cand = alive & (seen_count > 0) & (avg_grad > dc.grad_threshold)
    is_split = cand & (jnp.max(scales, axis=-1)
                       > dc.percent_dense * dc.scene_extent)

    # -- rank-match candidates to free slots -------------------------------
    n_cand = jnp.sum(cand)
    n_free = jnp.sum(~alive)
    n_new = jnp.minimum(n_cand, n_free)
    src_by_rank = _rank_index(cand, -avg_grad)          # strongest first
    dst_by_rank = _rank_index(~alive, jnp.arange(cap, dtype=jnp.float32))
    use = jnp.arange(cap) < n_new

    # per-slot source index: identity, then dst[r] <- src[r] for used ranks
    source = jnp.arange(cap, dtype=jnp.int32)
    source = source.at[dst_by_rank].set(
        jnp.where(use, src_by_rank.astype(jnp.int32),
                  dst_by_rank.astype(jnp.int32)))
    is_new = jnp.zeros((cap,), bool).at[dst_by_rank].set(use)
    # split originals whose second sample actually found a slot get
    # resampled/shrunk in place; unallocated candidates stay untouched
    orig_resampled = jnp.zeros((cap,), bool).at[src_by_rank].set(
        use & is_split[src_by_rank])

    gathered = {k: v[source] for k, v in raw.items()}
    new_is_split = is_split[source]

    # -- split sampling: x ~ N(mean, R S^2 R^T), scales / split_factor -----
    # (Kerbl et al. 5.2; both children sample the parent's density.)
    normals = jax.random.normal(key, (cap, 3), raw["means"].dtype)
    rot = quat_to_rotmat(gathered["quats"]
                         / jnp.linalg.norm(gathered["quats"], axis=-1,
                                           keepdims=True))
    # precision: a float32 product may otherwise run in TF32 on the GPU and
    # move the samples away from the CPU's
    offs = jnp.einsum("nij,nj->ni",
                      rot, normals * jnp.exp(gathered["log_scales"]),
                      precision="highest")
    shrink = jnp.log(jnp.asarray(dc.split_factor, raw["log_scales"].dtype))

    def choose(base, sampled, mask):
        return jnp.where(mask.reshape((cap,) + (1,) * (base.ndim - 1)),
                         sampled, base)

    sampled_means = gathered["means"] + offs
    sampled_log_scales = gathered["log_scales"] - shrink
    out = dict(gathered)
    # new slots: clones copy verbatim; splits take a sample + shrink
    out["means"] = choose(gathered["means"], sampled_means,
                          is_new & new_is_split)
    out["log_scales"] = choose(gathered["log_scales"], sampled_log_scales,
                               is_new & new_is_split)
    # in-place resample of allocated split originals (their own fresh draw)
    key2 = jax.random.fold_in(key, 1)
    normals2 = jax.random.normal(key2, (cap, 3), raw["means"].dtype)
    offs2 = jnp.einsum("nij,nj->ni",
                       rot, normals2 * jnp.exp(gathered["log_scales"]),
                       precision="highest")
    out["means"] = choose(out["means"], gathered["means"] + offs2,
                          orig_resampled)
    out["log_scales"] = choose(out["log_scales"], sampled_log_scales,
                               orig_resampled)

    # park rows that are dead after pruning (and not newly allocated)
    dead = ~(alive | is_new)
    out["logit_opacities"] = jnp.where(dead, DEAD_LOGIT,
                                       out["logit_opacities"])
    out["log_scales"] = choose(out["log_scales"],
                               jnp.full_like(out["log_scales"],
                                             DEAD_LOG_SCALE), dead)

    alive = alive | is_new
    changed = is_new | orig_resampled | dead
    stats = {"pruned": pruned, "cloned": jnp.sum(is_new & ~new_is_split),
             "split": jnp.sum(is_new & new_is_split),
             "alive": jnp.sum(alive)}
    return out, alive, changed, stats


def accumulate_grad_stats(
    grad_accum: jnp.ndarray,
    seen_count: jnp.ndarray,
    gnorm: jnp.ndarray,
    alive: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fold one step's per-splat positional-gradient NORM (the (N,)
    ``densify_grad_norm`` metric from ``trainer.make_train_step``) into the
    densify statistics. A splat counts as *seen* when its gradient is
    nonzero (culled / off-screen splats receive exactly-zero grads from the
    pipeline). Matches ``accumulate_grad_stats_batched`` with a batch of
    one: a B-step sequential loop and one batched step advance the
    accumulators identically."""
    if gnorm.ndim != 1:
        raise ValueError(
            f"accumulate_grad_stats takes the per-splat (N,) grad norm, "
            f"got shape {gnorm.shape} -- pass the densify_grad_norm metric")
    seen = alive & (gnorm > 0.0)
    return grad_accum + jnp.where(seen, gnorm, 0.0), seen_count + seen


def accumulate_grad_stats_batched(
    grad_accum: jnp.ndarray,
    seen_count: jnp.ndarray,
    gnorm_sum: jnp.ndarray,
    seen_inc: jnp.ndarray,
    alive: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fold one BATCHED step's statistics in: ``gnorm_sum`` is the sum of
    per-view screen-grad norms over the batch and ``seen_inc`` the count of
    views each splat contributed to -- a batch-B step advances the
    accumulators exactly like B sequential view-iterations (the parallel
    train steps return both, e.g. ``make_dp_train_step``
    ``with_grad_norms``)."""
    live = alive.astype(jnp.float32)
    return grad_accum + gnorm_sum * live, seen_count + seen_inc * live


def fit_scene_adaptive(params, targets, cameras, cfg, dc: DensifyConfig,
                       tc=None, width=None, height=None, seed: int = 0,
                       log_every: int = 50, verbose: bool = True,
                       save_every: int = 0, checkpoint_path=None,
                       resume=None):
    """``trainer.fit_scene`` with adaptive density control.

    Starts from ``params`` (any count <= dc.capacity), densifies/prunes on
    ``dc.interval`` inside [start_step, stop_step). Returns (activated
    params at full capacity, alive mask, history). The render pipeline
    never sees a shape change -- one compiled program serves the whole run.

    ``save_every``/``checkpoint_path``/``resume`` as in
    ``trainer.fit_scene``; checkpoints additionally carry the densify
    state (``alive``, ``grad_accum``, ``seen_count``) and the RNG key, so
    a resumed run replays the uninterrupted one exactly.
    """
    from openglgaussiansplattingrenderer_jax.train import trainer

    tc = tc or trainer.TrainConfig()
    width = width or trainer.camera_dims(cameras[0])[0]
    height = height or trainer.camera_dims(cameras[0])[1]
    raw, alive = pad_to_capacity(trainer.raw_from_params(params), dc.capacity)
    step = trainer.make_train_step(cfg, tc, width, height,
                                   with_grad_norms=True,
                                   grad_stat=dc.statistic,
                                   param_keys=tuple(sorted(raw.keys())))
    state = step.init(raw)
    grad_accum = jnp.zeros((dc.capacity,), jnp.float32)
    seen_count = jnp.zeros((dc.capacity,), jnp.float32)
    key = jax.random.PRNGKey(seed)
    start_step = 0
    if resume:
        r_raw, start_step, extras = trainer.load_checkpoint_full(resume)
        trainer.check_resume_shapes(raw, r_raw, resume)
        opt = (trainer.restore_opt_state(state.opt_state,
                                         extras["opt_leaves"])
               if "opt_leaves" in extras else state.opt_state)
        state = trainer.TrainState(
            {k: jnp.asarray(v) for k, v in r_raw.items()}, opt, start_step)
        if "alive" not in extras:
            raise ValueError(
                f"resume checkpoint {resume!r} carries no densify state "
                "(alive/grad_accum/...) -- was it saved from a run "
                "without adaptive density control?")
        alive = jnp.asarray(extras["alive"])
        grad_accum = jnp.asarray(extras["grad_accum"])
        seen_count = jnp.asarray(extras["seen_count"])
        key = jnp.asarray(extras["rng_key"])
        if verbose:
            print(f"resumed {resume} at step {start_step} "
                  f"(alive {int(jnp.sum(alive))})")

    cam_bundles = trainer.camera_bundles(cameras)
    targets = [jnp.asarray(t, jnp.float32) for t in targets]

    import time as _time

    t0 = _time.time()
    history = []
    for i in range(start_step, tc.steps):
        j = i % len(targets)
        state, metrics = step(state, targets[j], *cam_bundles[j])
        grad_accum, seen_count = accumulate_grad_stats(
            grad_accum, seen_count, metrics["densify_grad_norm"], alive)

        if (dc.start_step <= i < dc.stop_step and i > 0
                and i % dc.interval == 0):
            key, sub = jax.random.split(key)
            new_raw, alive, changed, dstats = densify_and_prune(
                state.raw, alive, grad_accum, seen_count, sub, dc)
            state = trainer.TrainState(
                new_raw, reset_rows(state.opt_state, changed), state.step)
            grad_accum = jnp.zeros_like(grad_accum)
            seen_count = jnp.zeros_like(seen_count)
            if verbose:
                d = {k: int(v) for k, v in dstats.items()}
                print(f"step {i}: densify {d}")

        if (dc.opacity_reset_interval and i > 0 and i < dc.stop_step
                and i % dc.opacity_reset_interval == 0):
            state = trainer.TrainState(
                reset_opacity(state.raw, dc.opacity_reset_ceiling),
                reset_opacity_moments(state.opt_state, dc.capacity),
                state.step)
            if verbose:
                print(f"step {i}: opacity reset (<= "
                      f"{dc.opacity_reset_ceiling})")

        if i % log_every == 0 or i == tc.steps - 1:
            # float(...) fences the async dispatch, so wall_s is honest
            m = {"loss": float(metrics["loss"]),
                 "psnr": float(metrics["psnr"]),
                 "alive": int(jnp.sum(alive))}
            history.append({"step": i, **m,
                            "wall_s": round(_time.time() - t0, 3)})
            if verbose:
                print(f"step {i}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                      f"alive {m['alive']}")

        if (save_every and checkpoint_path
                and ((i + 1) % save_every == 0 or i == tc.steps - 1)):
            trainer.save_checkpoint(
                checkpoint_path, state.raw, step=i + 1,
                opt_state=state.opt_state, alive=alive,
                grad_accum=grad_accum, seen_count=seen_count, rng_key=key)

    return trainer.params_from_raw(state.raw), alive, history


def compact_params(params: Dict[str, jnp.ndarray], alive) -> Dict[str, jnp.ndarray]:
    """Host-side: drop dead rows (for PLY export / hand-off). Not jittable."""
    import numpy as np

    mask = np.asarray(alive)
    return {k: np.asarray(v)[mask] for k, v in params.items()}
