"""Multi-device fast path: the fast pipeline under shard_map with a ragged
all-to-all record exchange.

Replaces round 1's correctness prototype (``parallel/sharded.py``: all-gather
of every record to every chip + a replicated global sort) with the scaling
design SURVEY.md section 5 prescribes (long-context row):

- **splat-sharded preprocess + expand**: each device runs the fast path's
  preprocess and duplicate expansion on its N/D splats, producing
  duplicate records that carry (9 fields, tile id, view depth).
- **ragged all-to-all by tile owner**: tiles are owned round-robin
  (``owner(t) = t % D`` -- balances dense screen regions across devices).
  Each device packs its records into fixed-capacity per-destination buckets
  with ONE row-keyed ``lax.sort`` against padding rows (rank-within-
  destination via mask cumsums; record order preserved, see the packing
  comment in ``_fast_shard_fn``), then exchanges one ``lax.all_to_all``.
  Bucket capacity is static (``exch_factor`` x
  the mean); overflowing records are dropped farthest-first per destination
  (the same depth-ordered overflow policy as the single-device fast path)
  and counted in ``stats["overflow"]``.
- **owner-side merge + Pallas composite**: the receiving device merges the
  D streams with one (tile, depth) lexicographic payload sort of its
  O(C/D) records, then runs the *same* fused compositor as the
  single-device path -- the compositor takes per-tile pixel origins, so a
  device composites its non-contiguous round-robin tile subset directly.
- **backward**: everything above is differentiable -- the all_to_all
  transposes to the reverse all_to_all, bucket packing is a gather (its
  transpose scatter-adds cotangents), and the sorts re-sort cotangents via
  their custom VJPs. A splat duplicated across tiles owned by different
  chips receives the exact sum of its contributions (SURVEY.md hard part #5).
- **q16 inference mode** (``cfg.sort_payload="q16"``, r5): the 9 fields
  travel the bucket sort, the exchange and the merge packed into 5 u32
  words (``_q16_route``; the single-device q16 quantizer + the packed-u32
  merge key) -- per-device sort operands 13 -> 8 / 12 -> 6 and exchanged
  bytes 7/11 of the f32 path. Inference-only: its backward raises.

Per-device sort/composite work is O(C/D) (records ride at most two local
sorts of ~(1+exch_factor)·C/D rows), vs O(C) for the all-gather design in
``parallel/sharded.py``.

The reference is strictly single-GPU (SURVEY.md section 2.4); this layer is
the capability the north star adds on top.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops import fastpath
from openglgaussiansplattingrenderer_jax.ops.compositing import assemble_image
from openglgaussiansplattingrenderer_jax.ops.pallas.composite import composite_tiles
from openglgaussiansplattingrenderer_jax.ops import records as rk
from openglgaussiansplattingrenderer_jax.parallel.sharded import (
    AXIS,
    make_mesh,
    pad_scene_for_mesh,
    shard_map,
    shard_params,
)

__all__ = ["render_fast_sharded", "train_step_fast_sharded", "make_mesh",
           "pad_scene_for_mesh", "shard_params", "exchange_capacity"]


def exchange_capacity(cfg: RenderConfig, n_local: int, ndev: int,
                      exch_factor: float = 2.0) -> int:
    """Static per-destination bucket capacity for the record exchange.

    ``exch_factor`` multiplies the mean per-destination share of a chip's
    local record capacity; ``exch_factor >= ndev`` guarantees zero drops
    (worst case: every local record destined to one chip).
    """
    cap_local = cfg.capacity(n_local)
    return rk.round_up(max(int(cap_local * exch_factor / ndev), 128), 128)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8, 9, 10, 11))
def _q16_route(fields9, tile, depth, rkey, pkey, rows, num_tiles, ndev,
               tiles_per_dev, axis, wp, hp):
    """The q16 bucket-sort -> all-to-all -> owner-merge region, one guarded
    function (f32 fields in, (sf2, bounds) out). The 9 fields travel as 5
    u32 words (records.q16_pack layout, bitcast to f32 so every exchange
    column shares one dtype); the owner merge sorts ONE u32 key =
    lt * 2^22 + 22-bit depth -- exactly the single-chip
    ``depth_key="packed"`` quantization. Inference-only: the backward
    raises (round/clip are flat a.e.; a silent zero-gradient would be a
    trap, see records.q16_unpack's block comment)."""
    words = tuple(
        jax.lax.bitcast_convert_type(w, jnp.float32)
        for w in rk._q16_pack(fields9, wp, hp))
    cols = words + (tile, depth)                         # 7 columns
    pad0 = jnp.zeros(rows, jnp.float32)
    pad_cols = (pad0,) * 5 + (jnp.full(rows, jnp.float32(num_tiles)), pad0)
    comb_key = jnp.concatenate([rkey, pkey])
    comb = tuple(jnp.concatenate([f, pf])
                 for f, pf in zip(cols, pad_cols))
    out = jax.lax.sort((comb_key,) + comb, num_keys=1, is_stable=True)
    packed = jnp.stack([f[0:rows] for f in out[1:]], axis=1)   # (rows, 7)

    recv = jax.lax.all_to_all(packed, axis, split_axis=0, concat_axis=0,
                              tiled=True)                # (rows, 7)

    gtile = recv[:, 5].astype(jnp.int32)
    lt = jnp.where(gtile < num_tiles, gtile // ndev, tiles_per_dev)
    qd = jnp.minimum(
        (jnp.clip(recv[:, 6], 0.0, 1.0) * (1 << 22)).astype(jnp.uint32),
        jnp.uint32((1 << 22) - 1))
    mkey = lt.astype(jnp.uint32) * jnp.uint32(1 << 22) + qd
    wcols = tuple(jax.lax.bitcast_convert_type(recv[:, i], jnp.uint32)
                  for i in range(5))
    out2 = jax.lax.sort((mkey,) + wcols, num_keys=1, is_stable=True)
    sf2 = rk._q16_unpack(out2[1:], wp, hp)
    bounds_l = jnp.searchsorted(
        out2[0], jnp.arange(tiles_per_dev + 1,
                            dtype=jnp.uint32) * jnp.uint32(1 << 22),
        side="left").astype(jnp.int32)
    return tuple(sf2), bounds_l


def _q16r_fwd(fields9, tile, depth, rkey, pkey, rows, num_tiles, ndev,
              tiles_per_dev, axis, wp, hp):
    return _q16_route(fields9, tile, depth, rkey, pkey, rows, num_tiles,
                      ndev, tiles_per_dev, axis, wp, hp), None


def _q16r_bwd(rows, num_tiles, ndev, tiles_per_dev, axis, wp, hp, res, g):
    raise NotImplementedError(
        "sort_payload='q16' is an inference-only precision mode: the "
        "quantized sharded record exchange has no useful gradient. Train "
        "with sort_payload='f32'.")


_q16_route.defvjp(_q16r_fwd, _q16r_bwd)


def _fast_shard_fn(params_local, view, vp, focal_x, focal_y, tan_fovx,
                   tan_fovy, *, width, height, cfg: RenderConfig, axis: str,
                   ndev: int, tiles_per_dev: int, cap_exch: int):
    """Per-device body run under shard_map. Returns (tiled, stats...)."""
    d = jax.lax.axis_index(axis)
    num_tiles = cfg.num_tiles

    # ---- preprocess + expand on the local splat shard, with depth --------
    rec, info = fastpath.expand_depth_records(
        params_local, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
        width, height, cfg, with_depth=True)
    cap_local = rec["tile"].shape[0]

    # ---- destination bucketing -------------------------------------------
    # Goal: packed[e*cap_exch + j] = the j-th local record destined to
    # device e (record order preserved), zero/sentinel rows past each
    # bucket's count. Packing is a SORT: key every record by its bucket
    # row, key ``rows`` padding records by the complementary rows, one
    # ``lax.sort`` of (cap_local + rows) elements lays the buckets out
    # exactly. Rank-within-destination comes from ``ndev`` mask cumsums on
    # the UNSORTED records.
    tile_i = rec["tile"]
    tile = tile_i.astype(jnp.float32)                   # exact below 2^24
    # invalid records carry tile == num_tiles; num_tiles % ndev would alias
    # them onto a real device, so send them to sentinel destination ndev
    dest = jnp.where(tile_i < num_tiles, tile_i % ndev, ndev)
    q16 = cfg.sort_payload == "q16"
    fields11 = tuple(rec["fields"]) + (tile, rec["depth"])  # + tile, depth

    off = jnp.zeros(cap_local, jnp.int32)               # rank within dest
    cnt_l = []
    for e_dst in range(ndev):
        m = (dest == e_dst).astype(jnp.int32)
        c = jnp.cumsum(m)
        off = jnp.where(m == 1, c - 1, off)
        cnt_l.append(c[-1])
    cnt_d = jnp.stack(cnt_l)                            # (ndev,) per-dest

    rows = ndev * cap_exch
    i_rec = jnp.arange(cap_local, dtype=jnp.int32)
    in_cap = (dest < ndev) & (off < cap_exch)           # overflow drops
    # every key in [0, rows) occurs exactly once across records + padding;
    # dropped/invalid records and excess padding get unique sentinels > rows
    rkey = jnp.where(in_cap, dest * cap_exch + off, rows + i_rec)
    p = jnp.arange(rows, dtype=jnp.int32)
    pj = p % cap_exch
    fill = (jnp.broadcast_to(jnp.minimum(cnt_d, cap_exch)[:, None],
                             (ndev, cap_exch)).reshape(rows) + pj)
    pkey = jnp.where(fill < cap_exch,
                     (p // cap_exch) * cap_exch + fill,
                     rows + cap_local + p)
    if q16:
        # q16 inference mode (config.sort_payload docs): the 9 float fields
        # ride the bucket sort, the exchange AND the owner-side merge
        # packed into 5 u32 words -- sort operands drop 13 -> 8 (pack) /
        # 12 -> 6 (merge), the all-to-all moves 7 columns instead of 11.
        # One custom_vjp spans the whole quantized region (f32 fields in,
        # f32 sorted fields out) so differentiating raises instead of
        # silently zeroing gradients behind the int bitcasts.
        from openglgaussiansplattingrenderer_jax.ops.compositing import (
            padded_dims,
        )

        wp_q, hp_q = padded_dims(width, height, cfg)
        sf2, bounds_l = _q16_route(
            fields11[:rk.NUM_FIELDS], tile, fields11[-1], rkey, pkey,
            rows, num_tiles, ndev, tiles_per_dev, axis, wp_q, hp_q)
    else:
        # padding rows: zero fields, sentinel tile so owners sort them last
        pad0 = jnp.zeros(rows, jnp.float32)
        pad_fields = (pad0,) * rk.NUM_FIELDS + (
            jnp.full(rows, jnp.float32(num_tiles)), pad0)
        comb_key = jnp.concatenate([rkey, pkey])
        comb_fields = tuple(jnp.concatenate([f, pf])
                            for f, pf in zip(fields11, pad_fields))
        _, _, sf_pack = rk.sort_with_payload(comb_key, comb_fields)
        packed = jnp.stack([f[0:rows] for f in sf_pack], axis=1)  # (rows, 11)

        # ---- the exchange (all-to-all; transpose = reverse a2a) -----------
        recv = jax.lax.all_to_all(packed, axis, split_axis=0, concat_axis=0,
                                  tiled=True)           # (rows, 11)

        # ---- owner-side (tile, depth) merge of the D streams -------------
        gtile = recv[:, rk.NUM_FIELDS].astype(jnp.int32)
        # owned tiles are g = lt*ndev + d; local index lt = g // ndev
        lt = jnp.where(gtile < num_tiles, gtile // ndev, tiles_per_dev)
        depth = recv[:, rk.NUM_FIELDS + 1]
        fields9 = tuple(recv[:, i] for i in range(rk.NUM_FIELDS))
        (lt_s, _), _, sf2 = rk.sort_multi_with_payload((lt, depth), fields9)
        bounds_l = jnp.searchsorted(
            lt_s, jnp.arange(tiles_per_dev + 1, dtype=jnp.int32),
            side="left").astype(jnp.int32)

    # ---- fused composite on the owned tile subset -------------------------
    my_tiles = d + ndev * jnp.arange(tiles_per_dev, dtype=jnp.int32)
    tiled = composite_tiles(sf2, bounds_l, my_tiles, width, height, cfg)

    # ---- stats (psum -> replicated scalars) ------------------------------
    local_over = info["total_all"] - info["total"]
    bucket_over = jnp.sum(jnp.maximum(cnt_d - cap_exch, 0))
    overflow = jax.lax.psum(jnp.maximum(local_over, 0) + bucket_over, axis)
    num_records = jax.lax.psum(info["total"], axis)
    exchanged = jax.lax.psum(jnp.sum(cnt_d), axis)
    return tiled, overflow[None], num_records[None], exchanged[None]


def render_fast_sharded(params, view, vp, focal_x, focal_y, tan_fovx,
                        tan_fovy, width: int, height: int, cfg: RenderConfig,
                        mesh, axis: str = AXIS, exch_factor: float = 2.0
                        ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Multi-device fast render. Returns ((H, W, 4) image, stats).

    ``params`` leaves must be shardable on axis 0 by the mesh size (use
    ``pad_scene_for_mesh``). ``exch_factor`` sizes the per-destination
    exchange buckets (see ``exchange_capacity``); pass ``exch_factor=ndev``
    for a zero-drop guarantee at ndev x the exchange memory.
    """
    ndev = mesh.shape[axis]
    n = params["means"].shape[0]
    if n % ndev:
        raise ValueError(f"{n} splats not divisible by {ndev} devices; "
                         "use pad_scene_for_mesh")
    if cfg.num_tiles % ndev:
        raise ValueError(f"{cfg.num_tiles} tiles not divisible by {ndev} devices")
    tpd = cfg.num_tiles // ndev
    cap_exch = exchange_capacity(cfg, n // ndev, ndev, exch_factor)

    fn = shard_map(
        functools.partial(
            _fast_shard_fn, width=width, height=height, cfg=cfg, axis=axis,
            ndev=ndev, tiles_per_dev=tpd, cap_exch=cap_exch),
        mesh=mesh,
        in_specs=(jax.sharding.PartitionSpec(axis),) + (jax.sharding.PartitionSpec(),) * 6,
        out_specs=(jax.sharding.PartitionSpec(axis),) * 4,
    )
    tiled, overflow, num_records, exchanged = fn(
        params, jnp.asarray(view), jnp.asarray(vp), jnp.float32(focal_x),
        jnp.float32(focal_y), jnp.float32(tan_fovx), jnp.float32(tan_fovy))

    # stacked order is (owner d, local lt) -> global tile lt*ndev + d;
    # un-permute to global tile order for assembly
    g = np.arange(cfg.num_tiles)
    perm = (g % ndev) * tpd + g // ndev
    tiled = tiled[perm]
    image = assemble_image(tiled[:, :, 0:3], tiled[:, :, 3], width, height,
                           cfg)
    stats = {"overflow": overflow[0], "num_records": num_records[0],
             "exchanged_records": exchanged[0]}
    return image, stats


def train_step_fast_sharded(raw, opt_state, target, view, vp, focal_x,
                            focal_y, tan_fovx, tan_fovy, *, width: int,
                            height: int, cfg: RenderConfig, mesh, optimizer,
                            axis: str = AXIS, exch_factor: float = 2.0,
                            lambda_dssim: float = 0.2):
    """One jittable sharded training step on the fast path.

    Like ``train/trainer.py`` and ``parallel.sharded.sharded_train_step``,
    optimisation happens in raw (pre-activation) space so updates cannot push
    activations out of range; ``raw`` is a ``trainer.raw_from_params`` pytree
    sharded over the mesh.

    The loss is the 3DGS objective (1-lambda)*L1 + lambda*D-SSIM
    (``losses.gs_loss``, the same objective the single-chip trainer
    defaults to): the render's tile outputs are assembled into the global
    (GSPMD-sharded) image outside ``shard_map``, so the windowed SSIM conv
    compiles with XLA's own halo exchange. ``lambda_dssim=0`` gives pure
    L1. (The 2-D view x splat path, ``parallel/mesh2d.py``, keeps the loss
    inside ``shard_map`` with an explicit border-strip halo exchange.)

    Returns ``(raw, opt_state, loss, stats)``. ``stats["overflow"]`` counts
    records this step dropped (local capacity + exchange buckets combined);
    a nonzero value means the loss was computed on an incomplete render --
    check it (or pass it to ``warn_on_sharded_overflow``), and raise
    ``exch_factor`` (``= ndev`` guarantees zero exchange drops) or the
    capacity when it fires.
    """
    from openglgaussiansplattingrenderer_jax.train import losses
    from openglgaussiansplattingrenderer_jax.train.trainer import params_from_raw

    def loss_fn(raw):
        img, stats = render_fast_sharded(
            params_from_raw(raw), view, vp, focal_x, focal_y, tan_fovx,
            tan_fovy, width, height, cfg, mesh, axis, exch_factor)
        return losses.gs_loss(img[..., :3], target, lambda_dssim), stats

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(raw)
    updates, opt_state = optimizer.update(grads, opt_state, raw)
    raw = jax.tree.map(lambda a, u: a + u, raw, updates)
    return raw, opt_state, loss, stats


def warn_on_sharded_overflow(stats, exch_factor: float, ndev: int) -> int:
    """Warn when a sharded step dropped records (cf. ``Splats._warn_on_overflow``).

    The single-device facade warns on overflow (``splats.py``); sharded
    training must too -- with the default ``exch_factor < ndev`` a skewed
    scene can overflow an exchange bucket and silently train on an
    incomplete render. Call once per logging interval with the step's
    ``stats``; returns the overflow count.
    """
    ov = int(stats.get("overflow", 0))
    if ov > 0:
        import warnings

        warnings.warn(
            f"sharded step dropped {ov} records (exchange buckets or local "
            f"capacity; exch_factor={exch_factor}): the render is missing "
            f"the farthest duplicates -- raise exch_factor (= {ndev} "
            "guarantees zero exchange drops) or the record capacity",
            RuntimeWarning, stacklevel=2)
    return ov
