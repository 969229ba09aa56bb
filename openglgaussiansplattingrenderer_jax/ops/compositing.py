"""Depth-ordered tile compositing, differentiable jnp formulation.

Vectorized re-expression of ``shaders/draw.glsl``: the reference walks each
tile's sorted splat range in 1024-splat shared-memory batches with per-pixel
sequential front-to-back blending and an early break at accumulated alpha
>= 0.99. Sequential blending is hostile to wide SIMD, so this formulation
converts it into *parallel* ops with identical semantics:

  T_k (transmittance before splat k) = prod_{j<k} (1 - alpha_j)
                                     = exp(cumsum_exclusive(log1p(-alpha)))
  include splat k  iff  T_k > 1 - saturation        [the 0.99 early-break]
  rgb  = sum_k color_k * alpha_k * T_k * include_k
  out_alpha = 1 - prod_k (1 - alpha_k * include_k)

The include mask evaluated on the *unmasked* prefix product is exactly the
reference's "break after the splat that crosses 0.99" semantics (proof: once
the prefix product drops below the threshold it can only shrink, so the first
crossing freezes the masked product; see tests/test_compositing.py for the
sequential-vs-parallel equivalence check). The cumsum runs along the splat
axis, pixels ride the vector lanes -- everything is elementwise, cumsum or
a reduction.

This module is the jittable, autodiff-differentiable oracle and fallback; the
production path is the fused Pallas kernel in ``ops/pallas/composite.py``,
which streams ragged per-tile ranges without the static per-tile cap.

Divergence from the reference GPU kernel, by design: draw.glsl's cooperative
batch loader evaluates all 1024 shared-memory slots even when the tile range
is shorter, blending records belonging to the *next* tiles into this tile
(draw.glsl:94-134). The CPU golden path loops exactly [start, end); we follow
the CPU semantics. Recorded in QUIRKS.md.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.config import RenderConfig


def padded_dims(width: int, height: int, cfg: RenderConfig) -> Tuple[int, int]:
    """Pad the image so tiles have integer pixel size (static shapes).

    For resolutions divisible by the grid (including the reference default
    1024x512 / 16) this is the identity and pixel->tile mapping matches the
    reference exactly.
    """
    wp = -(-width // cfg.grid_x) * cfg.grid_x
    hp = -(-height // cfg.grid_y) * cfg.grid_y
    return wp, hp


def tile_pixel_coords(width: int, height: int, cfg: RenderConfig):
    """Pixel-centre coordinates per tile, flattened: (T, P) x and y."""
    wp, hp = padded_dims(width, height, cfg)
    pw, ph = wp // cfg.grid_x, hp // cfg.grid_y
    gx, gy = cfg.grid_x, cfg.grid_y
    tx = jnp.arange(gx, dtype=jnp.float32) * pw          # (gx,)
    ty = jnp.arange(gy, dtype=jnp.float32) * ph          # (gy,)
    lx = jnp.arange(pw, dtype=jnp.float32)
    ly = jnp.arange(ph, dtype=jnp.float32)
    # per-tile pixel grid, flattened row-major (y outer, x inner) like the
    # reference's gl_GlobalInvocationID layout
    px = (tx[:, None, None] + lx[None, None, :]) + jnp.zeros((1, ph, 1))  # (gx, ph, pw)
    py = (ty[:, None, None] + ly[None, :, None]) + jnp.zeros((1, 1, pw))  # (gy, ph, pw)
    # tiles ordered tileIndex = tileY * grid_x + tileX (preprocess.glsl:153)
    pxs = jnp.broadcast_to(px[None, :, :, :], (gy, gx, ph, pw)).reshape(-1, ph * pw)
    pys = jnp.broadcast_to(py[:, None, :, :], (gy, gx, ph, pw)).reshape(-1, ph * pw)
    return pxs, pys


def gather_records(prep: Dict[str, jnp.ndarray], colors: jnp.ndarray,
                   sorted_sid: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """Gather per-splat attributes into sorted record order.

    The analogue of draw.glsl's double indirection
    ``splatKeys[indices[i]]`` (draw.glsl:97-102); under autodiff the
    transpose of this gather is the per-splat segment-sum of duplicated
    records' gradients (SURVEY.md hard part #5).
    """
    return {
        "mean2d": prep["mean2d"][sorted_sid],
        "conic": prep["conic"][sorted_sid],
        "color": colors[sorted_sid],
        "opacity": prep["opacity"][sorted_sid],
    }


def composite(
    records: Dict[str, jnp.ndarray],   # sorted (C, ...) record fields
    tile_bounds: jnp.ndarray,          # (T+1,) int32
    width: int,
    height: int,
    cfg: RenderConfig,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Composite sorted records into an (H, W, 4) float image in [0, 1]."""
    pxs, pys = tile_pixel_coords(width, height, cfg)     # (T, P)
    rgb, trans = composite_ranges(
        records, tile_bounds[:-1], tile_bounds[1:], pxs, pys, cfg)
    image = assemble_image(rgb, trans, width, height, cfg)
    per_tile = tile_bounds[1:] - tile_bounds[:-1]
    nchunks = -(-cfg.max_per_tile // cfg.chunk)
    aux = {
        "dropped_by_cap": jnp.sum(jnp.maximum(per_tile - nchunks * cfg.chunk, 0)),
        "final_transmittance": trans,
    }
    return image, aux


def composite_ranges(
    records: Dict[str, jnp.ndarray],
    starts: jnp.ndarray,               # (T_local,) record range starts
    ends: jnp.ndarray,                 # (T_local,)
    pxs: jnp.ndarray,                  # (T_local, P) pixel x coords
    pys: jnp.ndarray,                  # (T_local, P)
    cfg: RenderConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Core compositor over an arbitrary set of tiles (e.g. one shard's
    stripe under ``shard_map``). Returns ((T_local, P, 3) rgb premultiplied
    in colour-scale units, (T_local, P) transmittance)."""
    capacity = records["mean2d"].shape[0]
    num_tiles = pxs.shape[0]
    chunk = cfg.chunk
    nchunks = -(-cfg.max_per_tile // chunk)
    p = pxs.shape[1]
    lane = jnp.arange(chunk, dtype=jnp.int32)

    mean2d = records["mean2d"]
    conic = records["conic"]
    color = records["color"]
    opacity = records["opacity"]

    thresh = jnp.float32(1.0 - cfg.saturation)

    def body(carry, k):
        rgb, trans = carry                               # (T, P, 3), (T, P)
        idx = starts[:, None] + k * chunk + lane[None, :]          # (T, chunk)
        in_range = idx < ends[:, None]
        idx_c = jnp.clip(idx, 0, capacity - 1)
        mx = mean2d[idx_c, 0]
        my = mean2d[idx_c, 1]
        ca = conic[idx_c, 0]
        cb = conic[idx_c, 1]
        cc = conic[idx_c, 2]
        op = opacity[idx_c]
        col = color[idx_c]                               # (T, chunk, 3)

        dx = pxs[:, None, :] - mx[:, :, None]            # (T, chunk, P)
        dy = pys[:, None, :] - my[:, :, None]
        power = (-0.5 * (ca[:, :, None] * dx * dx + cc[:, :, None] * dy * dy)
                 - cb[:, :, None] * dx * dy)             # draw.glsl:115-116
        alpha = jnp.minimum(cfg.alpha_max, jnp.exp(power) * op[:, :, None])
        keep = in_range[:, :, None] & (power <= 0.0) & (alpha >= cfg.alpha_min)
        alpha = jnp.where(keep, alpha, 0.0)

        lg = jnp.log1p(-alpha)                           # (T, chunk, P)
        cum = jnp.cumsum(lg, axis=1)
        s_excl = trans[:, None, :] * jnp.exp(cum - lg)   # transmittance before k
        include = s_excl > thresh                        # 0.99-saturation mask
        wgt = alpha * s_excl * jnp.where(include, 1.0, 0.0)
        rgb = rgb + jnp.einsum("tkp,tkc->tpc", wgt, col, precision="highest")
        trans = trans * jnp.exp(jnp.sum(jnp.where(include, lg, 0.0), axis=1))
        return (rgb, trans), None

    # Derive the scan init from `starts` so it inherits any shard_map
    # device-varying axis (vma) -- a plain zeros/ones init is "unvarying" and
    # the scan carry type check rejects it under shard_map.
    zero_like_tiles = 0.0 * starts.astype(jnp.float32)
    rgb0 = jnp.zeros((num_tiles, p, 3), jnp.float32) + zero_like_tiles[:, None, None]
    trans0 = jnp.ones((num_tiles, p), jnp.float32) + zero_like_tiles[:, None]
    # remat the step: autodiff then keeps only the (T, P) carries per step,
    # not every (T, chunk, P) intermediate (which outgrows device memory at
    # a few thousand records per tile)
    (rgb, trans), _ = jax.lax.scan(
        jax.checkpoint(body), (rgb0, trans0),
        jnp.arange(nchunks, dtype=jnp.int32))
    return rgb, trans


def composite_tiles_jnp(fields, bounds: jnp.ndarray, width: int,
                        height: int, cfg: RenderConfig) -> jnp.ndarray:
    """The jnp compositor over the fast path's 9 sorted field arrays, in the
    Pallas compositor's output layout: (T, P, 4) [rgb in colour-scale
    units, transmittance]. Records past ``cfg.max_per_tile`` in a tile are
    dropped."""
    mx, my, ca, cb, cc, op, r, g, b = fields
    records = {"mean2d": jnp.stack([mx, my], axis=1),
               "conic": jnp.stack([ca, cb, cc], axis=1),
               "opacity": op, "color": jnp.stack([r, g, b], axis=1)}
    pxs, pys = tile_pixel_coords(width, height, cfg)
    rgb, trans = composite_ranges(records, bounds[:-1], bounds[1:], pxs, pys,
                                  cfg)
    return jnp.concatenate([rgb, trans[..., None]], axis=-1)


def assemble_image(rgb_tiled: jnp.ndarray, trans_tiled: jnp.ndarray,
                   width: int, height: int, cfg: RenderConfig) -> jnp.ndarray:
    """(T, P, 3) tiled rgb + (T, P) transmittance -> (H, W, 4) in [0, 1].

    Applies the final /color_scale (draw.glsl:141) and composites the
    configured background behind the splats.
    """
    wp, hp = padded_dims(width, height, cfg)
    pw, ph = wp // cfg.grid_x, hp // cfg.grid_y
    gx, gy = cfg.grid_x, cfg.grid_y
    rgb = rgb_tiled / cfg.color_scale
    bg = jnp.asarray(cfg.background, jnp.float32)
    rgb = rgb + trans_tiled[..., None] * bg[None, None, :]
    out_alpha = 1.0 - trans_tiled
    tiled = jnp.concatenate([rgb, out_alpha[..., None]], axis=-1)  # (T, P, 4)
    img = tiled.reshape(gy, gx, ph, pw, 4).transpose(0, 2, 1, 3, 4).reshape(hp, wp, 4)
    return img[:height, :width, :]
