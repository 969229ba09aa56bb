"""Measure record-sort alternatives on the device: payload sort vs
sort + gather.

The record sort (reference's radix sort role, `sort.cpp:158-197`) currently
runs as one 11-operand ``lax.sort`` (key + source idx + 9 payload fields):
every merge pass moves ~44 B/record. Alternative: sort only (key, iota)
(8 B/record through the sort) and then apply the permutation with one XLA
gather per field. Whether the device's gathers beat the payload traffic
is an empirical question -- this script measures both on the 1M-splat
1080p scene's record count.

    python scripts/sort2_experiment.py        # SORT2_C=<records>

Every time ends in ``block_until_ready``.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# 1M-splat 1080p record capacity (tight-rect, 2.5x 1M)
C = int(os.environ.get("SORT2_C", "2500096"))
NUM_FIELDS = 9
NUM_TILES = 2040
ITERS = int(os.environ.get("SORT2_ITERS", "20"))
REPEATS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}")

    rng = np.random.default_rng(0)
    key = jnp.asarray(rng.integers(0, NUM_TILES + 1, C, dtype=np.int32))
    fields = tuple(jnp.asarray(rng.standard_normal(C, dtype=np.float32))
                   for _ in range(NUM_FIELDS))

    def time_fn(fn, *args):
        jax.block_until_ready(fn(*args))
        results = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                out = fn(*args)
            jax.block_until_ready(out)
            results.append((time.perf_counter() - t0) / ITERS * 1000)
        return float(np.median(results))

    @jax.jit
    def payload_sort(key, fields):
        idx = jnp.arange(C, dtype=jnp.int32)
        out = jax.lax.sort((key, idx) + fields, num_keys=1, is_stable=True)
        return out

    @jax.jit
    def sort_then_gather(key, fields):
        idx = jnp.arange(C, dtype=jnp.int32)
        sk, si = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
        sf = tuple(jnp.take(f, si, axis=0) for f in fields)
        return (sk, si) + sf

    @jax.jit
    def sort_only(key):
        idx = jnp.arange(C, dtype=jnp.int32)
        return jax.lax.sort((key, idx), num_keys=1, is_stable=True)

    ms_payload = time_fn(payload_sort, key, fields)
    log(f"11-operand payload sort: {ms_payload:8.3f} ms")
    ms_sg = time_fn(sort_then_gather, key, fields)
    log(f"2-op sort + 9 gathers:   {ms_sg:8.3f} ms")
    ms_s = time_fn(sort_only, key)
    log(f"2-op sort alone:         {ms_s:8.3f} ms")

    # parity
    a = payload_sort(key, fields)
    b = sort_then_gather(key, fields)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    log("parity: exact")
    print(json.dumps({"device_kind": jax.devices()[0].device_kind,
                      "records": C, "payload_sort_ms": ms_payload,
                      "sort_then_gather_ms": ms_sg, "sort_only_ms": ms_s}))


if __name__ == "__main__":
    main()
