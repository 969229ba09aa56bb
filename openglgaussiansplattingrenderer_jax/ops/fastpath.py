"""Production render pipeline: payload sorts + XLA expand + fused Triton
composite.

Stage map:

  preprocess (jnp elementwise)
    -> [optional] sort splats by depth, fields as payloads   [lax.sort, N]
    -> cumsum duplicate counts                              [jnp, N]
    -> expand duplicates: searchsorted + gather, with the
       ellipse-reachability cull (ops/records.py)           [jnp, C]
    -> sort records by (tile, depth), fields as payloads    [lax.sort, C]
    -> fused composite fwd/bwd straight off the sorted
       layout (ops/pallas/composite.py)                     [Pallas, tiles]

The jnp pipeline in ``render.py`` / ``ops/binning.py`` is the oracle.
Everything is differentiable: the sorts re-sort cotangents, the expand's
gather transposes to a per-splat segment-sum, the compositor carries an
analytic backward, preprocess is plain jnp.

Overflow policy: when the scene needs more than ``capacity`` records, the
tail is dropped in record order (depth order with ``hoist_depth_sort``,
splat order without), unlike the oracle path which drops in array order;
both report ``stats["overflow"]``. Under zero overflow the two paths agree.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Tuple

import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops import projection
from openglgaussiansplattingrenderer_jax.ops import records as rk
from openglgaussiansplattingrenderer_jax.ops.compositing import assemble_image, padded_dims
from openglgaussiansplattingrenderer_jax.ops.pallas import composite as pc
from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance


def expand_depth_records(
    params: Dict[str, jnp.ndarray],
    view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
    width: int, height: int, cfg: RenderConfig,
    *,
    with_depth: bool = False,
):
    """Preprocess, optional depth sort of splats, duplicate expansion.

    Returns (rec, info): ``rec`` is ``records.expand_records``'s dict (9
    fields, tile id -- ``num_tiles`` for invalid rows -- and, with
    ``with_depth`` or without the hoisted depth sort, each record's view
    depth, the sort key of the record sort and of the sharded path's
    owner-side merge); ``info`` carries prep/total/total_all for stats.
    """
    n = params["means"].shape[0]
    cov6 = params.get("cov6")
    if cov6 is None:
        cov6 = build_covariance(params["scales"], params["quats"])
    prep = projection.preprocess(
        params["means"], cov6, params["opacities"], view, vp,
        width, height, focal_x, focal_y, tan_fovx, tan_fovy, cfg)
    from openglgaussiansplattingrenderer_jax.render import effective_colors

    colors = effective_colors(params, view, cfg)
    capacity = cfg.capacity(n)

    # With cfg.hoist_depth_sort=False the N-sized depth sort is skipped:
    # records carry their depth and the C-sized record sort becomes
    # lexicographic (tile, depth) instead.
    hoist = cfg.hoist_depth_sort
    with_depth = with_depth or not hoist
    # optional zero "shift" added to the composited mean2d only (not the
    # binning rects) -- its gradient is the SCREEN-space positional gradient
    # 3DGS densification selects on (graphdeco's viewspace_point_tensor
    # trick); see train/trainer.py grad_stat="screen"
    mean2d = prep["mean2d"]
    if "shift2d" in params:
        mean2d = mean2d + params["shift2d"]
    cols = (
        mean2d[:, 0], mean2d[:, 1],
        prep["conic"][:, 0], prep["conic"][:, 1], prep["conic"][:, 2],
        prep["opacity"], colors[:, 0], colors[:, 1], colors[:, 2],
        prep["tile_min"][:, 0].astype(jnp.float32),
        prep["tile_min"][:, 1].astype(jnp.float32),
        prep["tile_ext"][:, 0].astype(jnp.float32),
        prep["counts"].astype(jnp.float32),
    )
    if hoist:
        key = jnp.where(prep["valid"], prep["depth"], jnp.float32(jnp.inf))
        sk, _, cols = rk.sort_with_payload(key, cols)
        depth = jnp.where(jnp.isfinite(sk), sk, 0.0)
    else:
        depth = jnp.where(prep["valid"], prep["depth"], jnp.float32(0.0))

    wp, hp = padded_dims(width, height, cfg)
    rec = rk.expand_records(cols, depth if with_depth else None, capacity,
                            cfg, wp // cfg.grid_x, hp // cfg.grid_y)
    info = {"prep": prep, "total": rec["total"],
            "total_all": rec["total_all"]}
    return rec, info


def sort_records(
    params: Dict[str, jnp.ndarray],
    view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
    width: int, height: int, cfg: RenderConfig,
):
    """Every stage before the compositor. Returns (sf2, bounds, info): the
    9 (tile, depth)-sorted record fields, the (T+1,) per-tile ranges over
    them, and ``expand_depth_records``'s info."""
    rec, info = expand_depth_records(
        params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
        width, height, cfg)
    t = cfg.num_tiles

    tile_key = rec["tile"]
    rec_fields = rec["fields"]
    if cfg.sort_payload == "q16" and (cfg.hoist_depth_sort
                                      or cfg.depth_key != "packed"):
        raise ValueError(
            "sort_payload='q16' packs the single-key record sort: it needs "
            "depth_key='packed' with hoist_depth_sort=False")
    if cfg.hoist_depth_sort:
        # records arrive depth-ordered, so a stable single-key tile sort
        # suffices
        sk2, _, sf2 = rk.sort_with_payload(tile_key, rec_fields)
        tile_bnd = jnp.arange(t + 1, dtype=jnp.int32)
    elif cfg.depth_key == "packed":
        # single u32 key = tile * 2^22 + 22-bit-quantized ndc depth -- the
        # reference's own packed-key design (preprocess.glsl:154) with FAR
        # more depth precision (its float key keeps ~14 mantissa bits at
        # hundreds of tiles; this keeps 22 at any tile count <= 512).
        # One key operand instead of two; blend order can differ from the
        # exact "pair" mode only when two same-tile records quantize to the
        # same 2^-22 depth bucket (ties then break by splat order, stable).
        if t > 512:
            raise ValueError("depth_key='packed' needs num_tiles <= 512")
        q = jnp.uint32(1 << 22)
        qd = jnp.minimum(
            (jnp.clip(rec["depth"], 0.0, 1.0) * (1 << 22)).astype(jnp.uint32),
            q - 1)
        key = tile_key.astype(jnp.uint32) * q + qd
        # PROFILING-ONLY knob: carry just the first k payload fields
        # through the record sort, the rest bypass UNSORTED -- images are
        # WRONG for k < 9; identical shapes/compute elsewhere, isolating
        # the sort's in-pipeline operand-count cost. Unset = full payload
        # sort.
        prof_k = int(os.environ.get("GS_PROF_SORT_PAYLOADS", "-1"))
        if prof_k >= 0:
            warnings.warn(
                f"GS_PROF_SORT_PAYLOADS={prof_k} is set: only the first "
                f"{prof_k} of 9 record fields ride the sort -- rendered "
                "images are WRONG (profiling-only knob; unset it for "
                "correct output)", RuntimeWarning, stacklevel=2)
            sk2, _, sfk = rk.sort_with_payload(key, rec_fields[:prof_k])
            sf2 = tuple(sfk) + rec_fields[prof_k:]
        elif cfg.sort_payload == "q16":
            # inference precision mode: 9 fields packed to 5 u32 sort
            # lanes (records.sort_records_q16); 11 -> 6 sort operands
            wp_q, hp_q = padded_dims(width, height, cfg)
            sk2, sf2 = rk.sort_records_q16(key, rec_fields, wp_q, hp_q)
        else:
            sk2, _, sf2 = rk.sort_with_payload(key, rec_fields)
        tile_bnd = jnp.arange(t + 1, dtype=jnp.uint32) * q
    else:
        # no hoisted depth sort: lexicographic (tile, record depth) pair
        (sk2, _), _, sf2 = rk.sort_multi_with_payload(
            (tile_key, rec["depth"]), rec_fields)
        tile_bnd = jnp.arange(t + 1, dtype=jnp.int32)

    bounds = jnp.searchsorted(sk2, tile_bnd, side="left").astype(jnp.int32)
    return sf2, bounds, info


def render_fast(
    params: Dict[str, jnp.ndarray],
    view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
    width: int, height: int, cfg: RenderConfig,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Fast differentiable render. Returns ((H, W, 4) image, stats)."""
    sf2, bounds, info = sort_records(
        params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
        width, height, cfg)
    prep, total, total_all = info["prep"], info["total"], info["total_all"]
    n = params["means"].shape[0]
    capacity = cfg.capacity(n)
    t = cfg.num_tiles

    # ---- fused composite straight off the sorted layout ------------------
    tiled = pc.composite_tiles(sf2, bounds, jnp.arange(t, dtype=jnp.int32),
                               width, height, cfg)
    counts_t = bounds[1:] - bounds[:-1]
    image = assemble_image(tiled[:, :, 0:3], tiled[:, :, 3], width, height, cfg)

    num_visible = jnp.sum(prep["valid"])
    stats = {
        "num_splats": jnp.int32(n),
        "num_visible": num_visible,
        "num_culled": jnp.sum(prep["culled"]),
        "num_records": total,
        "num_duplicates": total - num_visible,
        "overflow": jnp.maximum(total_all - capacity, 0),
        "max_bin": jnp.max(counts_t),
        "mean_bin": jnp.mean(counts_t.astype(jnp.float32)),
        "binned_records": bounds[-1],
        # records whose Gaussian cannot reach alpha_min anywhere in their
        # tile, marked invalid by the expand's reachability cull
        "culled_unreachable": total - bounds[-1],
    }
    return image, stats
