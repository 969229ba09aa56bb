"""Does lax.sort run faster on already-sorted input? (No -- proof.)

The temporal-coherence idea (reuse last frame's record order for small
camera deltas) only helps if a nearly-sorted input is cheaper to sort.
`lax.sort` lowers to a data-independent comparison network, so the answer
should be an exact "no"; this probe pins it with device numbers at the
flagship record count so the idea is never retried blind.

    python scripts/sorted_input_probe.py       # PROBE_C=<records>

Every time ends in ``block_until_ready``.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

C = int(os.environ.get("PROBE_C", str(6_291_456)))
ITERS = 10


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    print(f"device: {jax.devices()[0]}; C={C}", file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    key_rand = jnp.asarray(rng.integers(0, 1 << 31, C).astype(np.uint32))
    key_sorted = jnp.sort(key_rand)
    # nearly-sorted: sorted with 1% random swaps (the temporal-delta case)
    nk = C // 100
    idx = rng.choice(C, 2 * nk, replace=False)
    ks = np.asarray(key_sorted).copy()
    ks[idx[:nk]], ks[idx[nk:]] = ks[idx[nk:]], ks[idx[:nk]].copy()
    key_near = jnp.asarray(ks)
    payloads = tuple(jnp.asarray(rng.standard_normal(C).astype(np.float32))
                     for _ in range(9))

    fn = jax.jit(lambda k, p: jax.lax.sort((k,) + p, num_keys=1,
                                           is_stable=True))

    def timeit(k):
        jax.block_until_ready(fn(k, payloads))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                out = fn(k, payloads)
            jax.block_until_ready(out)
            ts.append((time.perf_counter() - t0) / ITERS * 1000)
        return float(np.median(ts))

    res = {"device_kind": jax.devices()[0].device_kind, "c": C,
           "random_ms": timeit(key_rand),
           "nearly_sorted_ms": timeit(key_near),
           "sorted_ms": timeit(key_sorted)}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
