"""2-D mesh training: views x splats, both parallel axes composed.

``parallel/fast_sharded.py`` scales ONE frame across chips (splat-sharded
preprocess/expand, ragged all-to-all by tile owner, per-chip composite).
``parallel/data_parallel.py`` scales a BATCH of views (replicated params,
one pmean). Production 3DGS training at pod scale needs both at once:
splat counts that exceed one chip's HBM *and* multi-view batches. This
module runs the splat-sharded render under a 2-D
``Mesh(("view", "splat"))``:

- splat parameters are sharded over the ``splat`` axis and replicated over
  the ``view`` axis; each view-row of ``ds`` chips renders its own views
  with the unmodified ``_fast_shard_fn`` body (its collectives name only
  the ``splat`` axis, so the all-to-all exchange and stat psums stay
  row-local traffic),
- the loss is the full 3DGS objective (1-lambda)*L1 + lambda*D-SSIM
  (``losses.gs_loss``), computed per owned tile -- no chip ever assembles
  a full image. L1 is per-pixel and therefore tile-local; D-SSIM's 11x11
  window needs a 5-px halo of neighbouring tiles' pixels, exchanged as
  border strips via one ``all_gather`` of O(tiles * border) pixels (tiny
  next to the record exchange): each owner assembles halo-padded tiles,
  evaluates the shared ``losses.ssim_map`` windowed statistics on them,
  and masks to the windows whose centre pixel it owns. One ``psum`` over
  BOTH axes yields the replicated batch loss,
- the backward pass needs no hand-written cross-row sync: ``raw`` enters
  ``shard_map`` replicated over ``view``, so its cotangents are psummed
  over the view axis by the shard_map transpose itself; the optimizer
  update then runs on ``P("splat")``-sharded grads.

The reference is strictly single-GPU (SURVEY.md section 2.4); this layer is
north-star scaling capability with no reference counterpart.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops.compositing import padded_dims
from openglgaussiansplattingrenderer_jax.ops import records as rk
from openglgaussiansplattingrenderer_jax.parallel.fast_sharded import (
    _fast_shard_fn,
    exchange_capacity,
)
from openglgaussiansplattingrenderer_jax.parallel.sharded import shard_map
from openglgaussiansplattingrenderer_jax.train import losses
from openglgaussiansplattingrenderer_jax.train.trainer import (
    TrainConfig,
    make_optimizer,
    params_from_raw,
)

VIEW_AXIS = "view"
SPLAT_AXIS = "splat"

# D-SSIM's 11x11 window reaches 5 px past a tile's edge: the halo width of
# neighbouring tiles' pixels each owner gathers before windowing.
HALO = 5

__all__ = ["make_mesh2d", "tile_target", "shard_raw_2d",
           "make_2d_train_step", "fit_scene_2d", "VIEW_AXIS", "SPLAT_AXIS"]


def _padded_tiles(center, strips, my_tiles, gx, gy, row_of):
    """Assemble halo-padded tiles (tpd, ph+2h, pw+2h, C) for the owned tile
    subset from border strips of ALL tiles.

    ``center``: (tpd, ph, pw, C) owned tiles' pixels. ``strips`` =
    (tops, bots, lefts, rights): (rows, h, pw, C) / (rows, ph, h, C) strips
    of every tile, in whatever row layout the caller holds them (global
    tile order for the replicated target; owner-major ``all_gather`` order
    for the prediction) -- ``row_of`` maps a global tile id array to that
    layout's row index. Out-of-grid halos are zero-filled; the window mask
    (``_window_mask``) excludes every window that could touch them, so the
    fill value never reaches the loss.
    """
    tops, bots, lefts, rights = strips
    h = tops.shape[1]
    ty, tx = my_tiles // gx, my_tiles % gx

    def nbr(strip, dy, dx, sl=None):
        ny, nx = ty + dy, tx + dx
        ok = (ny >= 0) & (ny < gy) & (nx >= 0) & (nx < gx)
        t2 = jnp.clip(ny, 0, gy - 1) * gx + jnp.clip(nx, 0, gx - 1)
        s = strip[row_of(t2)]
        if sl is not None:
            s = s[:, :, sl]
        return jnp.where(ok[:, None, None, None], s, 0.0)

    top = jnp.concatenate([nbr(bots, -1, -1, slice(-h, None)),
                           nbr(bots, -1, 0),
                           nbr(bots, -1, 1, slice(None, h))], axis=2)
    bot = jnp.concatenate([nbr(tops, 1, -1, slice(-h, None)),
                           nbr(tops, 1, 0),
                           nbr(tops, 1, 1, slice(None, h))], axis=2)
    mid = jnp.concatenate([nbr(rights, 0, -1), center, nbr(lefts, 0, 1)],
                          axis=2)
    return jnp.concatenate([top, mid, bot], axis=1)


def _tile_strips(tiles4):
    """(T, ph, pw, C) -> the four HALO-wide border strips."""
    return (tiles4[:, :HALO], tiles4[:, -HALO:],
            tiles4[:, :, :HALO], tiles4[:, :, -HALO:])


def _window_mask(my_tiles, gx, ph, pw, width, height):
    """(tpd, ph, pw) mask of SSIM windows whose centre pixel this chip owns
    and whose 11x11 extent stays inside the TRUE image -- summed over all
    tiles it selects exactly the (height-10) x (width-10) VALID windows the
    single-chip ``losses.ssim`` means over (pad pixels beyond width/height
    and zero-filled out-of-grid halos are never reached)."""
    h = HALO
    ty, tx = my_tiles // gx, my_tiles % gx
    gy_pix = ty[:, None] * ph + jnp.arange(ph, dtype=jnp.int32)[None, :]
    gx_pix = tx[:, None] * pw + jnp.arange(pw, dtype=jnp.int32)[None, :]
    okr = (gy_pix >= h) & (gy_pix < height - h)
    okc = (gx_pix >= h) & (gx_pix < width - h)
    return (okr[:, :, None] & okc[:, None, :]).astype(jnp.float32)


def make_mesh2d(dv: int, ds: int) -> Mesh:
    """(dv x ds) mesh: axis 0 = view batch, axis 1 = splat shard."""
    devices = np.asarray(jax.devices()[: dv * ds]).reshape(dv, ds)
    return Mesh(devices, (VIEW_AXIS, SPLAT_AXIS))


def tile_target(target, width: int, height: int, cfg: RenderConfig
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) target -> ((T, P, 3) tiles, (T, P) valid-pixel mask).

    Tile order matches ``compositing.assemble_image``'s layout (tile
    t = ty * grid_x + tx); the mask zeroes the pad pixels the compositor
    renders but ``assemble_image`` crops.
    """
    wp, hp = padded_dims(width, height, cfg)
    gx, gy = cfg.grid_x, cfg.grid_y
    pw, ph = wp // gx, hp // gy
    t = np.zeros((hp, wp, 3), np.float32)
    t[:height, :width] = np.asarray(target, np.float32)
    m = np.zeros((hp, wp), np.float32)
    m[:height, :width] = 1.0
    tiles = t.reshape(gy, ph, gx, pw, 3).transpose(0, 2, 1, 3, 4)
    mask = m.reshape(gy, ph, gx, pw).transpose(0, 2, 1, 3)
    return (tiles.reshape(gy * gx, ph * pw, 3),
            mask.reshape(gy * gx, ph * pw))


def shard_raw_2d(raw, mesh: Mesh):
    """Place a raw-param pytree P(splat)-sharded, view-replicated."""
    sharding = NamedSharding(mesh, P(SPLAT_AXIS))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), raw)


def make_2d_train_step(cfg: RenderConfig, tc: TrainConfig, width: int,
                       height: int, mesh: Mesh, *, batch: Optional[int] = None,
                       param_keys=None, exch_factor: float = 2.0,
                       with_grad_norms: bool = False):
    """Jitted train step on the (view x splat) mesh.

    ``batch`` views per optimizer step (default: one per view-row; must be
    a multiple of ``dv`` -- each row renders ``batch // dv`` views
    sequentially). The loss is the batch mean of the per-view 3DGS
    objective (1-lambda)*L1 + lambda*D-SSIM (``losses.gs_loss``), the same
    objective the single-chip and data-parallel paths train: L1 is scored
    per owned tile; D-SSIM runs on halo-padded tiles after a border-strip
    ``all_gather`` (see the module docstring). ``tc.lambda_dssim = 0``
    skips the halo exchange entirely (pure L1).

    Step signature::

        step(raw, opt_state,
             tgt_tiles (B, T, P, 3), view (B, 4, 4), vp (B, 4, 4),
             fx, fy, tfx, tfy (B,))
        -> (raw, opt_state, loss, psnr, overflow)

    ``raw`` leaves must be splat-axis divisible by ``ds``
    (``pad_scene_for_mesh``) and placed with ``shard_raw_2d``; targets come
    from ``tile_target``. A nonzero ``overflow`` means records were dropped
    (exchange buckets or local capacity) -- see
    ``fast_sharded.warn_on_sharded_overflow``.

    ``with_grad_norms`` appends (gnorm_sum (N,), seen (N,)) to the step
    outputs: the screen-space densification statistic (the zero-shift
    trick, ``trainer.make_train_step``) computed with a PER-VIEW shift
    sharded over both axes -- per-view norms are taken before the batch
    sum, so a batch-B step advances the densify accumulators exactly like
    B sequential view-iterations.
    """
    dv = mesh.shape[VIEW_AXIS]
    ds = mesh.shape[SPLAT_AXIS]
    batch = batch or dv
    if batch % dv:
        raise ValueError(f"batch {batch} not a multiple of view rows {dv}")
    local_bs = batch // dv
    if cfg.num_tiles % ds:
        raise ValueError(
            f"{cfg.num_tiles} tiles not divisible by {ds} splat shards")
    tpd = cfg.num_tiles // ds
    optimizer = (make_optimizer(tc) if param_keys is None
                 else make_optimizer(tc, keys=param_keys))
    _, mask_np = tile_target(np.zeros((height, width, 3), np.float32),
                             width, height, cfg)
    npix_valid = float(mask_np.sum())
    bg = np.asarray(cfg.background, np.float32)
    wp, hp = padded_dims(width, height, cfg)
    pw, ph = wp // cfg.grid_x, hp // cfg.grid_y
    use_dssim = bool(tc.lambda_dssim)
    if use_dssim and min(ph, pw) < HALO:
        raise ValueError(
            f"D-SSIM on the 2-D mesh needs tiles >= {HALO} px "
            f"(got {pw}x{ph}); use tc.lambda_dssim=0 or a coarser grid")
    if use_dssim and (height <= 2 * HALO or width <= 2 * HALO):
        raise ValueError(
            f"D-SSIM needs images > {2 * HALO} px, got {width}x{height}")

    def loss_body(raw_local, shift_local, tgt, view, vp, fx, fy, tfx, tfy,
                  mask):
        # raw_local: (n/ds, ...) leaves; shift_local: (local_bs, n/ds, 2)
        # per-view zero shifts (densify statistic) or None; tgt:
        # (local_bs, T, P, 3) this row's views; mask: (T, P) replicated
        n_local = raw_local["means"].shape[0]
        cap_exch = exchange_capacity(cfg, n_local, ds, exch_factor)
        params_local = params_from_raw(raw_local)
        d = jax.lax.axis_index(SPLAT_AXIS)
        my_tiles = d + ds * jnp.arange(tpd, dtype=jnp.int32)
        m_own = jnp.take(mask, my_tiles, axis=0)            # (tpd, P)
        if use_dssim:
            m_win = _window_mask(my_tiles, cfg.grid_x, ph, pw,
                                 width, height)             # (tpd, ph, pw)

        se_views, l1_views, ssim_views = [], [], []
        over = jnp.int32(0)
        for j in range(local_bs):
            if shift_local is not None:
                params_local = dict(params_local,
                                    shift2d=shift_local[j])
            tiled, ov, _, _ = _fast_shard_fn(
                params_local, view[j], vp[j], fx[j], fy[j], tfx[j], tfy[j],
                width=width, height=height, cfg=cfg, axis=SPLAT_AXIS,
                ndev=ds, tiles_per_dev=tpd, cap_exch=cap_exch)
            # per-owned-tile final rgb, exactly assemble_image's math
            rgb = (tiled[:, :, 0:3] / cfg.color_scale
                   + tiled[:, :, 3:4] * jnp.asarray(bg)[None, None, :])
            tgt_own = jnp.take(tgt[j], my_tiles, axis=0)    # (tpd, P, 3)
            se_views.append(
                jnp.sum(((rgb - tgt_own) ** 2) * m_own[..., None]))
            l1_views.append(
                jnp.sum(jnp.abs(rgb - tgt_own) * m_own[..., None]))
            if use_dssim:
                # halo exchange: all_gather the 5-px border strips of every
                # owned tile (O(tiles * border) pixels -- tiny next to the
                # record exchange), assemble halo-padded tiles, window them
                rgb4 = rgb.reshape(tpd, ph, pw, 3)
                pstrips = tuple(
                    jax.lax.all_gather(s, SPLAT_AXIS, axis=0, tiled=True)
                    for s in _tile_strips(rgb4))
                pred_pad = _padded_tiles(
                    rgb4, pstrips, my_tiles, cfg.grid_x, cfg.grid_y,
                    lambda t2: (t2 % ds) * tpd + t2 // ds)
                tgt4 = tgt[j].reshape(cfg.num_tiles, ph, pw, 3)
                tgt_pad = _padded_tiles(
                    tgt4[my_tiles], _tile_strips(tgt4), my_tiles,
                    cfg.grid_x, cfg.grid_y, lambda t2: t2)
                smap = losses.ssim_map(pred_pad, tgt_pad)
                ssim_views.append(jnp.sum(smap * m_win[..., None]))
            over = over + ov[0]
        # one psum over BOTH axes -> replicated batch sums / overflow
        se_views = jax.lax.psum(jnp.stack(se_views), SPLAT_AXIS)
        l1_v = jax.lax.psum(jnp.stack(l1_views), SPLAT_AXIS)
        l1_mean = (jax.lax.psum(jnp.sum(l1_v), VIEW_AXIS)
                   / (batch * npix_valid * 3.0))
        if use_dssim:
            ssim_v = jax.lax.psum(jnp.stack(ssim_views), SPLAT_AXIS)
            nwin = float((height - 2 * HALO) * (width - 2 * HALO) * 3)
            ssim_mean = (jax.lax.psum(jnp.sum(ssim_v), VIEW_AXIS)
                         / (batch * nwin))
            loss = ((1.0 - tc.lambda_dssim) * l1_mean
                    + tc.lambda_dssim * (1.0 - ssim_mean) / 2.0)
        else:
            loss = l1_mean
        over = jax.lax.psum(over, VIEW_AXIS)  # ov already splat-psummed
        # mean of per-view PSNRs, matching fit_scene / data_parallel's
        # history metric (NOT -10 log10 of the batch-mean MSE)
        mse_views = jax.lax.stop_gradient(se_views) / (npix_valid * 3.0)
        psnr = jax.lax.pmean(
            jnp.mean(-10.0 * jnp.log10(jnp.maximum(mse_views, 1e-12))),
            VIEW_AXIS)
        return loss, (over, psnr)

    view_specs = (P(VIEW_AXIS),) * 7
    if with_grad_norms:
        smapped = shard_map(
            loss_body, mesh,
            in_specs=(P(SPLAT_AXIS), P(VIEW_AXIS, SPLAT_AXIS)) + view_specs
            + (P(),),
            out_specs=(P(), (P(), P())))
    else:
        smapped = shard_map(
            lambda raw, *a: loss_body(raw, None, *a), mesh,
            in_specs=(P(SPLAT_AXIS),) + view_specs + (P(),),
            out_specs=(P(), (P(), P())))

    mask_j = jnp.asarray(mask_np)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(raw, opt_state, tgt, view, vp, fx, fy, tfx, tfy):
        if with_grad_norms:
            n = raw["means"].shape[0]
            shift = jnp.zeros((batch, n, 2), jnp.float32)

            def loss_fn(raw, shift):
                return smapped(raw, shift, tgt, view, vp, fx, fy, tfx,
                               tfy, mask_j)

            (loss, (over, psnr)), (grads, gshift) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True)(raw, shift)
            # per-view screen-grad norms in NDC units, then the batch sum
            # (+ seen counts) -- B view-iterations of the 3DGS statistic
            nrm = jnp.linalg.norm(
                gshift * jnp.array([width / 2.0, height / 2.0]), axis=-1)
            gnorm = jnp.sum(nrm, axis=0)
            seen = jnp.sum((nrm > 0.0).astype(jnp.float32), axis=0)
        else:
            def loss_fn(raw):
                return smapped(raw, tgt, view, vp, fx, fy, tfx, tfy,
                               mask_j)

            (loss, (over, psnr)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(raw)
        # raw enters shard_map replicated over the view axis, so grads are
        # SUMMED over view rows by the transpose; the loss already divides
        # by the full batch, making this the batch-mean gradient.
        updates, opt_state = optimizer.update(grads, opt_state, raw)
        raw = jax.tree_util.tree_map(lambda a, u: a + u, raw, updates)
        if with_grad_norms:
            return raw, opt_state, loss, psnr, over, gnorm, seen
        return raw, opt_state, loss, psnr, over

    step.init = lambda raw: jax.jit(optimizer.init)(raw)
    return step


def _place_state_2d(opt_state, mesh: Mesh, capacity: int):
    """Deterministically re-place an optimizer state after a densify step:
    capacity-leading leaves P(splat)-sharded, everything else (Adam step
    counters etc.) replicated."""
    shd = NamedSharding(mesh, P(SPLAT_AXIS))
    rep = NamedSharding(mesh, P())

    def f(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 \
                and leaf.shape[0] == capacity:
            return jax.device_put(leaf, shd)
        return jax.device_put(leaf, rep)

    return jax.tree_util.tree_map(f, opt_state)


def fit_scene_2d(params, targets, cameras, cfg: RenderConfig,
                 tc: Optional[TrainConfig] = None, *, mesh: Mesh,
                 batch: Optional[int] = None, width: Optional[int] = None,
                 height: Optional[int] = None, exch_factor: float = 2.0,
                 dc=None, seed: int = 0,
                 save_every: int = 0, checkpoint_path: Optional[str] = None,
                 resume: Optional[str] = None,
                 log_every: int = 50, verbose: bool = True):
    """``trainer.fit_scene`` on the (view x splat) mesh.

    Splat parameters are padded to the splat-axis size and sharded; each
    optimizer step consumes ``batch`` views (default: one per view row),
    cycling through the view list. Returns (activated params, history)
    like ``fit_scene``; nonzero step overflow raises a warning through
    ``fast_sharded.warn_on_sharded_overflow``.

    ``dc`` (a ``train.densify.DensifyConfig``) composes adaptive density
    control with BOTH parallel axes: parameters live at ``dc.capacity``
    rows (rounded up to a multiple of ``ds``), P(splat)-sharded; the train
    step returns the per-view screen statistic (sharded shift trick, see
    ``make_2d_train_step``); ``densify_and_prune`` -- pure jnp over
    capacity-sized arrays -- runs under plain jit on the SHARDED state, so
    GSPMD computes the exact global single-stream semantics (global
    candidate ranking, global free-slot matching) and the result is
    deterministically re-placed P(splat). A 2-D+ADC run on a dv x ds mesh
    equals the same run on a 1x1 mesh to float tolerance
    (tests/test_mesh2d.py). With ``dc`` the return is (params at capacity,
    alive mask, history).

    ``save_every``/``checkpoint_path``/``resume`` as in
    ``trainer.fit_scene``: checkpoints gather the sharded state to one
    host npz; resume re-places it P(splat)-sharded, so a killed
    multi-chip fit continues exactly (incl. densify state under ``dc``).
    """
    from openglgaussiansplattingrenderer_jax.parallel.fast_sharded import (
        warn_on_sharded_overflow,
    )
    from openglgaussiansplattingrenderer_jax.parallel.sharded import (
        pad_scene_for_mesh,
    )
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        camera_bundles,
        camera_dims,
        raw_from_params,
    )

    tc = tc or TrainConfig()
    dv = mesh.shape[VIEW_AXIS]
    ds = mesh.shape[SPLAT_AXIS]
    batch = batch or dv
    width = width or camera_dims(cameras[0])[0]
    height = height or camera_dims(cameras[0])[1]

    n_orig = params["means"].shape[0]
    alive = grad_accum = seen_count = key = None
    if dc is not None:
        import dataclasses

        from openglgaussiansplattingrenderer_jax.train import densify as dn

        cap = -(-dc.capacity // ds) * ds
        if cap != dc.capacity:
            dc = dataclasses.replace(dc, capacity=cap)
        raw, alive = dn.pad_to_capacity(
            raw_from_params({k: jnp.asarray(v) for k, v in params.items()}),
            cap)
        raw = shard_raw_2d(raw, mesh)
        shd = NamedSharding(mesh, P(SPLAT_AXIS))
        alive = jax.device_put(alive, shd)
        grad_accum = jax.device_put(jnp.zeros((cap,), jnp.float32), shd)
        seen_count = jax.device_put(jnp.zeros((cap,), jnp.float32), shd)
        key = jax.random.PRNGKey(seed)
    else:
        params = pad_scene_for_mesh(
            {k: jnp.asarray(v) for k, v in params.items()}, ds)
        raw = shard_raw_2d(raw_from_params(params), mesh)
    step = make_2d_train_step(cfg, tc, width, height, mesh, batch=batch,
                              param_keys=tuple(sorted(raw.keys())),
                              exch_factor=exch_factor,
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
        raw = shard_raw_2d({k: jnp.asarray(v) for k, v in r_raw.items()},
                           mesh)
        cap_rows = raw["means"].shape[0]
        if "opt_leaves" in extras:
            opt_state = _place_state_2d(
                restore_opt_state(opt_state, extras["opt_leaves"]),
                mesh, cap_rows)
        if dc is not None:
            if "alive" not in extras:
                raise ValueError(
                    f"resume checkpoint {resume!r} carries no densify "
                    "state (alive/grad_accum/...) -- was it saved from a "
                    "run without adaptive density control?")
            shd = NamedSharding(mesh, P(SPLAT_AXIS))
            alive = jax.device_put(jnp.asarray(extras["alive"]), shd)
            grad_accum = jax.device_put(
                jnp.asarray(extras["grad_accum"]), shd)
            seen_count = jax.device_put(
                jnp.asarray(extras["seen_count"]), shd)
            key = jnp.asarray(extras["rng_key"])
        if verbose:
            print(f"resumed {resume} at step {start_step}")
    bundles = camera_bundles(cameras)
    tgt_tiles = [jnp.asarray(tile_target(t, width, height, cfg)[0])
                 for t in targets]

    history = []
    nv = len(targets)
    for i in range(start_step, tc.steps):
        sel = [(i * batch + j) % nv for j in range(batch)]
        tgt = jnp.stack([tgt_tiles[s] for s in sel])
        bsel = [bundles[s] for s in sel]
        view = jnp.stack([b[0] for b in bsel])
        vp = jnp.stack([b[1] for b in bsel])
        sc = [jnp.stack([jnp.asarray(b[j], jnp.float32) for b in bsel])
              for j in (2, 3, 4, 5)]
        if dc is None:
            raw, opt_state, loss, p, over = step(raw, opt_state, tgt, view,
                                                 vp, *sc)
        else:
            from openglgaussiansplattingrenderer_jax.train import densify as dn

            raw, opt_state, loss, p, over, gnorm, seen = step(
                raw, opt_state, tgt, view, vp, *sc)
            grad_accum, seen_count = dn.accumulate_grad_stats_batched(
                grad_accum, seen_count, gnorm, seen, alive)
            if (dc.start_step <= i < dc.stop_step and i > 0
                    and i % dc.interval == 0):
                key, sub = jax.random.split(key)
                raw, alive, changed, dstats = dn.densify_and_prune(
                    raw, alive, grad_accum, seen_count, sub, dc)
                opt_state = dn.reset_rows(opt_state, changed)
                # deterministic reshard after clone/split/prune
                raw = shard_raw_2d(raw, mesh)
                opt_state = _place_state_2d(opt_state, mesh, dc.capacity)
                shd = NamedSharding(mesh, P(SPLAT_AXIS))
                alive = jax.device_put(alive, shd)
                grad_accum = jax.device_put(
                    jnp.zeros((dc.capacity,), jnp.float32), shd)
                seen_count = jax.device_put(
                    jnp.zeros((dc.capacity,), jnp.float32), shd)
                if verbose:
                    d = {k: int(v) for k, v in dstats.items()}
                    print(f"step {i}: densify {d}")
            if (dc.opacity_reset_interval and i > 0 and i < dc.stop_step
                    and i % dc.opacity_reset_interval == 0):
                raw = shard_raw_2d(
                    dn.reset_opacity(raw, dc.opacity_reset_ceiling), mesh)
                opt_state = _place_state_2d(
                    dn.reset_opacity_moments(opt_state, dc.capacity),
                    mesh, dc.capacity)
        if i % log_every == 0 or i == tc.steps - 1:
            m = {"loss": float(loss), "psnr": float(p),
                 "overflow": int(over)}
            if dc is not None:
                m["alive"] = int(jnp.sum(alive))
            warn_on_sharded_overflow({"overflow": m["overflow"]},
                                     exch_factor, ds)
            history.append({"step": i, **m})
            if verbose:
                print(f"step {i}: loss {m['loss']:.5f} "
                      f"psnr {m['psnr']:.2f} (batch {batch}, "
                      f"mesh {dv}x{ds})")
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
    fitted = params_from_raw(raw)
    if dc is not None:
        return fitted, alive, history
    # strip the splat-axis padding (degenerate far-away splats) added above
    return {k: v[:n_orig] for k, v in fitted.items()}, history
