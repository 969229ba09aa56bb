"""Measure how lax.sort cost scales with batching at record scale.

Hypothesis behind a "banded" record-sort design: XLA's sort is a
merge/bitonic-style network whose pass count grows ~log^2(n) in the sorted
axis length, and batch dimensions sort independently -- so pre-partitioning
C records into K independent bands (shape (K, C/K), sorted along the last
axis) should cut the pass count by ~(log(C)/log(C/K))^2 while moving the
same bytes per pass. If measurement confirms it, the expand can emit
records already partitioned by tile-row band (per-band cumsums; each band's
records stay splat-major) and the big sort becomes a batched sort.

Also probes: operand-count scaling (key-only vs +12 payloads) and the
2-key lexicographic variant (the no-hoist fast path).

    python scripts/sort_shape_probe.py       # PROBE_C=<records>

Every time ends in ``block_until_ready``; one JSON line on stdout.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

C = int(os.environ.get("PROBE_C", str(6 * 1024 * 1024)))  # flagship capacity
NUM_PAYLOADS = 10   # 9 fields + source idx
ITERS = 10
REPEATS = 3
KS = (1, 4, 8, 16, 32)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}; C={C}")

    rng = np.random.default_rng(0)
    tile_np = rng.integers(0, 512, C, dtype=np.int32)
    depth_np = rng.random(C, dtype=np.float32)
    key = jnp.asarray(tile_np)
    depth = jnp.asarray(depth_np)
    fields = tuple(jnp.asarray(rng.standard_normal(C, dtype=np.float32))
                   for _ in range(NUM_PAYLOADS))

    def time_fn(fn, *args):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        compile_s = time.perf_counter() - t0
        results = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                out = fn(*args)
            jax.block_until_ready(out)
            results.append((time.perf_counter() - t0) / ITERS * 1000)
        return float(np.median(results)), compile_s

    results = {"device_kind": jax.devices()[0].device_kind, "c": C}
    for k_b in KS:
        shape = (k_b, C // k_b)

        def sort_batched(key, depth, fields, shape=shape):
            ops = (key.reshape(shape), depth.reshape(shape)) + tuple(
                f.reshape(shape) for f in fields)
            out = lax.sort(ops, dimension=1, num_keys=2, is_stable=True)
            return out

        ms, comp = time_fn(jax.jit(sort_batched), key, depth, fields)
        log(f"batched K={k_b:3d} {shape}: {ms:8.2f} ms  (compile {comp:.0f}s)")
        results[f"sort2key_12ops_K{k_b}"] = ms

    # operand scaling at K=1: key-only, key+idx, 1-key full payload
    def sort_key_only(key, depth):
        return lax.sort((key, depth), num_keys=2, is_stable=True)

    ms, comp = time_fn(jax.jit(sort_key_only), key, depth)
    log(f"2-key no payload: {ms:8.2f} ms (compile {comp:.0f}s)")
    results["sort2key_0ops"] = ms

    def sort_1key(key, depth, fields):
        out = lax.sort((key, depth) + fields, num_keys=1, is_stable=True)
        return out

    ms, comp = time_fn(jax.jit(sort_1key), key, depth, fields)
    log(f"1-key 12 ops:     {ms:8.2f} ms (compile {comp:.0f}s)")
    results["sort1key_12ops"] = ms

    print(json.dumps(results))


if __name__ == "__main__":
    main()
