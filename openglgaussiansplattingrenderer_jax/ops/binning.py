"""Static-shape tile binning with splat duplication.

This replaces three reference components with host-sync-free, statically
shaped JAX code (SURVEY.md section 7, hard part #1):

- the atomic-counter duplicate allocator in ``shaders/preprocess.glsl:157-189``
  plus its per-frame device->host readback (``src/Splats.cpp:579-583``)
- the 256-bin histogram ``shaders/countBins.glsl``
- the Hillis-Steele prefix scan ``shaders/prefixBins.glsl``

Design: each visible splat overlaps ``counts[i]`` tiles (its duplicate count,
computed in preprocess). Instead of scattering through an atomic counter, we
take the *gather* formulation: record r in a capacity-C padded array belongs to
splat ``s(r) = searchsorted(cumsum(counts), r, 'right')`` with duplicate slot
``j = r - offset[s]``; its tile id follows arithmetically from the splat's tile
range. No scatter, no atomics, no host sync; overflow beyond C is dropped and
reported as a metric (the reference instead clamps duplicates at numSplats,
``preprocess.glsl:163-167``).

Per-tile [start, end) ranges come from a vectorized ``searchsorted`` over the
sorted tile ids -- the countBins/prefixBins pair collapses into one op.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops import sorting


def expand_records(
    counts: jnp.ndarray,     # (N,) int32 tiles overlapped per splat
    tile_min: jnp.ndarray,   # (N, 2) int32
    tile_ext: jnp.ndarray,   # (N, 2) int32
    depth: jnp.ndarray,      # (N,) float32
    cfg: RenderConfig,
    capacity: int,
) -> Dict[str, jnp.ndarray]:
    """Expand per-splat tile ranges into a capacity-padded record array.

    Returns dict with (C,)-shaped ``splat_id``, ``tile``, ``depth``, ``valid``
    and scalar ``total`` / ``overflow`` stats.
    """
    n = counts.shape[0]
    cum = jnp.cumsum(counts)                     # inclusive
    total = cum[-1]
    r = jnp.arange(capacity, dtype=jnp.int32)
    s = jnp.searchsorted(cum, r, side="right").astype(jnp.int32)
    s = jnp.minimum(s, n - 1)
    offset = cum[s] - counts[s]                  # exclusive offset of splat s
    j = r - offset                               # duplicate slot within splat
    valid = r < total

    ext_x = tile_ext[s, 0]
    tx = tile_min[s, 0] + j % jnp.maximum(ext_x, 1)
    ty = tile_min[s, 1] + j // jnp.maximum(ext_x, 1)
    tile = ty * cfg.grid_x + tx
    tile = jnp.where(valid, tile, cfg.num_tiles).astype(jnp.int32)

    return {
        "splat_id": jnp.where(valid, s, 0).astype(jnp.int32),
        "tile": tile,
        "depth": jnp.where(valid, depth[s], jnp.float32(jnp.inf)),
        "valid": valid,
        "total": total,
        "overflow": jnp.maximum(total - capacity, 0),
    }


def sort_and_bin(
    records: Dict[str, jnp.ndarray], cfg: RenderConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Depth-sort records within tiles and build per-tile ranges.

    Returns (sorted_splat_id (C,), tile_bounds (T+1,)) where records of tile t
    occupy ``[tile_bounds[t], tile_bounds[t+1])`` in the sorted order -- the
    same contract as the reference's inclusive-scanned bins buffer read by
    ``draw.glsl:82-89``.
    """
    if cfg.depth_key == "reference":
        sorted_tile, sorted_sid = sorting.sort_by_float_key(
            records["tile"], records["depth"], records["splat_id"]
        )
    else:
        sorted_tile, sorted_sid = sorting.sort_by_tile_depth(
            records["tile"], records["depth"], records["splat_id"]
        )
    bounds = jnp.searchsorted(
        sorted_tile, jnp.arange(cfg.num_tiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    return sorted_sid, bounds


def bin_stats(tile_bounds: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """Per-frame binning stats the reference prints (``Splats.cpp:766,957-963``)."""
    per_tile = tile_bounds[1:] - tile_bounds[:-1]
    return {
        "max_bin": jnp.max(per_tile),
        "mean_bin": jnp.mean(per_tile.astype(jnp.float32)),
        "binned_records": tile_bounds[-1],
    }
