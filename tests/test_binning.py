"""Static-shape duplication/binning tests vs. a Python-loop oracle."""

import numpy as np
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops import binning


def _loop_expand(counts, tile_min, tile_ext, depth, gx):
    """The reference's per-splat duplication loop (preprocess.glsl:171-189),
    row-major over the overlapped tile rectangle."""
    recs = []
    for i in range(len(counts)):
        if counts[i] == 0:
            continue
        for j in range(counts[i]):
            tx = tile_min[i, 0] + j % tile_ext[i, 0]
            ty = tile_min[i, 1] + j // tile_ext[i, 0]
            recs.append((i, ty * gx + tx, depth[i]))
    return recs


def _random_prep(rng, n, gx=16, gy=16):
    tmin = np.stack([rng.integers(0, gx, n), rng.integers(0, gy, n)], axis=1).astype(np.int32)
    ext = np.stack(
        [np.minimum(rng.integers(1, 4, n), gx - tmin[:, 0]),
         np.minimum(rng.integers(1, 4, n), gy - tmin[:, 1])], axis=1
    ).astype(np.int32)
    counts = (ext[:, 0] * ext[:, 1]).astype(np.int32)
    culled = rng.random(n) < 0.2
    counts[culled] = 0
    depth = rng.random(n).astype(np.float32)
    return counts, tmin, ext, depth


def test_expand_matches_loop(rng):
    cfg = RenderConfig(dup_capacity_factor=6.0)  # enough for avg ~4 tiles/splat
    n = 200
    counts, tmin, ext, depth = _random_prep(rng, n)
    capacity = cfg.capacity(n)
    recs = binning.expand_records(jnp.asarray(counts), jnp.asarray(tmin),
                                  jnp.asarray(ext), jnp.asarray(depth), cfg, capacity)
    want = _loop_expand(counts, tmin, ext, depth, cfg.grid_x)
    total = int(recs["total"])
    assert total == len(want)
    assert total <= capacity
    got = list(zip(np.asarray(recs["splat_id"])[:total],
                   np.asarray(recs["tile"])[:total],
                   np.asarray(recs["depth"])[:total]))
    assert [(int(a), int(b)) for a, b, _ in got] == [(a, b) for a, b, _ in want]
    np.testing.assert_allclose([d for _, _, d in got], [d for _, _, d in want])
    # padding is flagged invalid with the sentinel tile
    pad_tiles = np.asarray(recs["tile"])[total:]
    assert np.all(pad_tiles == cfg.num_tiles)
    assert int(recs["overflow"]) == 0


def test_overflow_is_dropped_and_counted(rng):
    cfg = RenderConfig(dup_capacity_factor=1.0, chunk=16)
    n = 64
    counts, tmin, ext, depth = _random_prep(rng, n)
    counts = np.maximum(counts, 1).astype(np.int32)  # force records
    capacity = cfg.capacity(n)
    recs = binning.expand_records(jnp.asarray(counts), jnp.asarray(tmin),
                                  jnp.asarray(ext), jnp.asarray(depth), cfg, capacity)
    total = int(np.sum(counts))
    assert int(recs["overflow"]) == max(total - capacity, 0)
    assert recs["tile"].shape == (capacity,)


def test_sort_and_bin_ranges(rng):
    cfg = RenderConfig(dup_capacity_factor=8.0)
    n = 500
    counts, tmin, ext, depth = _random_prep(rng, n)
    capacity = cfg.capacity(n)
    recs = binning.expand_records(jnp.asarray(counts), jnp.asarray(tmin),
                                  jnp.asarray(ext), jnp.asarray(depth), cfg, capacity)
    sorted_sid, bounds = binning.sort_and_bin(recs, cfg)
    bounds = np.asarray(bounds)
    sorted_sid = np.asarray(sorted_sid)
    total = int(recs["total"])
    assert bounds[0] == 0 and bounds[-1] == total
    assert np.all(np.diff(bounds) >= 0)
    # within each tile range, depths must be non-decreasing and tiles correct
    want = _loop_expand(counts, tmin, ext, depth, cfg.grid_x)
    by_tile = {}
    for sid, tile, d in want:
        by_tile.setdefault(tile, []).append((d, sid))
    for t in range(cfg.num_tiles):
        seg = sorted_sid[bounds[t]:bounds[t + 1]]
        depths = depth[seg]
        assert np.all(np.diff(depths) >= 0), f"tile {t} not depth sorted"
        assert sorted(seg.tolist()) == sorted(s for _, s in by_tile.get(t, []))


def test_reference_key_mode_matches_pair_mode():
    """The packed-float-key sort (parity mode) groups identically when depths
    fit the float budget. Depths are kept away from 1.0: the reference's
    tile + z key genuinely rounds z ~ 0.9999999 into the NEXT tile at large
    tile indices (QUIRKS.md), which is the flaw the pair mode fixes."""
    rng = np.random.default_rng(42)
    n = 300
    counts, tmin, ext, depth = _random_prep(rng, n)
    depth = (depth * 0.9).astype(np.float32)
    cfg_pair = RenderConfig(depth_key="pair", dup_capacity_factor=8.0)
    cfg_ref = RenderConfig(depth_key="reference", dup_capacity_factor=8.0)
    capacity = cfg_pair.capacity(n)
    args = (jnp.asarray(counts), jnp.asarray(tmin), jnp.asarray(ext),
            jnp.asarray(depth))
    recs = binning.expand_records(*args, cfg_pair, capacity)
    sid_a, bounds_a = binning.sort_and_bin(recs, cfg_pair)
    sid_b, bounds_b = binning.sort_and_bin(recs, cfg_ref)
    np.testing.assert_array_equal(np.asarray(bounds_a), np.asarray(bounds_b))
    ba = np.asarray(bounds_a)
    for t in range(cfg_pair.num_tiles):
        seg_a = np.sort(np.asarray(sid_a)[ba[t]:ba[t + 1]])
        seg_b = np.sort(np.asarray(sid_b)[ba[t]:ba[t + 1]])
        np.testing.assert_array_equal(seg_a, seg_b)
