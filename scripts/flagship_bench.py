"""Flagship benchmark with its pipeline options open: the reference's own
operating point, bike-big.ply's 3,616,103 splats (reference
``tests/plyParseTests.cpp:69``) at its default 1024x512
(``include/Camera.h:55,62``), on two scene statistics:

- **uniform**: a uniform-random cloud, near-uniform tile occupancy;
- **clustered**: ``make_clustered_scene``'s Zipf-weighted Gaussian-mixture
  layout with lognormal splat sizes -- the heavy-tailed occupancy real SfM
  captures show (max_bin >> mean_bin), stressing the saturation early exit
  and load balance.

``bench.py`` measures this point with the production options; this script
lets the tile size, the depth pre-sort, the depth key and the payload
precision vary (environment below), and optionally times forward+backward.
Capacity is autotuned per scene and one bucket is shared by both. Every
time ends in ``block_until_ready``.

    FLAGSHIP_DEPTH_KEY=packed FLAGSHIP_BWD=1 python scripts/flagship_bench.py
"""

import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_SPLATS = int(os.environ.get("FLAGSHIP_SPLATS", "3616103"))
WIDTH = int(os.environ.get("FLAGSHIP_W", "1024"))
HEIGHT = int(os.environ.get("FLAGSHIP_H", "512"))
ITERS = int(os.environ.get("FLAGSHIP_ITERS", "20"))
REPEATS = 3
TILE_PX = int(os.environ.get("FLAGSHIP_TILE_PX", "32"))
WITH_BWD = bool(int(os.environ.get("FLAGSHIP_BWD", "0")))
HOIST = bool(int(os.environ.get("FLAGSHIP_HOIST", "0")))
DEPTH_KEY = os.environ.get("FLAGSHIP_DEPTH_KEY", "pair")
# "q16" = the packed-payload inference mode (needs DEPTH_KEY=packed)
SORT_PAYLOAD = os.environ.get("FLAGSHIP_SORT_PAYLOAD", "f32")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_ms(fn):
    import jax

    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn()
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / ITERS * 1000)
    return float(np.median(times))


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.render import (
        autotune_capacity, render_arrays)
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}")

    cam = scenes.camera_tuple(scenes.camera(WIDTH, HEIGHT))
    base = RenderConfig.for_resolution(WIDTH, HEIGHT, tile_px=TILE_PX,
                                       hoist_depth_sort=HOIST,
                                       depth_key=DEPTH_KEY,
                                       sort_payload=SORT_PAYLOAD)
    log(f"grid {base.grid_x}x{base.grid_y} ({base.num_tiles} tiles)")

    # ---- probe record counts, share one capacity bucket across scenes ----
    params_by_scene = {k: scenes.to_params(scenes.flagship_scene(k, NUM_SPLATS))
                       for k in ("uniform", "clustered")}
    caps = {k: autotune_capacity(p, *cam, WIDTH, HEIGHT, base).capacity_records
            for k, p in params_by_scene.items()}
    log(f"autotuned capacities {caps}")
    cap = max(caps.values())
    cfg = dataclasses.replace(base, capacity_records=cap)

    fwd = jax.jit(functools.partial(render_arrays, width=WIDTH, height=HEIGHT,
                                    cfg=cfg))

    def loss(p):
        img, _ = render_arrays(p, *cam, WIDTH, HEIGHT, cfg)
        return jnp.mean(img[..., :3] ** 2)

    fb = jax.jit(jax.value_and_grad(loss))

    results = {}
    for name, params in params_by_scene.items():
        t0 = time.perf_counter()
        img, stats = jax.block_until_ready(fwd(params, *cam))
        st = {k: np.asarray(v).tolist() for k, v in stats.items()}
        log(f"{name}: fwd compile+run {time.perf_counter() - t0:.1f}s; "
            f"stats {st}")
        assert int(stats["overflow"]) == 0, f"{name}: capacity overflow"
        fwd_ms = median_ms(lambda: fwd(params, *cam))
        out = {"scene": name, "fwd_ms": fwd_ms, "fps": 1000 / fwd_ms,
               "capacity": cap, "records": st["num_records"],
               "binned": st["binned_records"], "max_bin": st["max_bin"],
               "mean_bin": st["mean_bin"]}
        if WITH_BWD:
            t0 = time.perf_counter()
            jax.block_until_ready(fb(params))
            log(f"{name}: fwd+bwd compile+run {time.perf_counter() - t0:.1f}s")
            out["fwdbwd_ms"] = median_ms(lambda: fb(params))
        log(f"{name}: fwd {fwd_ms:.3f} ms ({1000 / fwd_ms:.3f} fps)")
        results[name] = out
        print(json.dumps(out), flush=True)

    # headline: the worse of the two scene statistics
    worst = min(results.values(), key=lambda r: r["fps"])
    print(json.dumps({"metric": f"fps_flagship_{WIDTH}x{HEIGHT}_fwd",
                      "value": worst["fps"], "unit": "fps",
                      "vs_baseline": worst["fps"] / 30.0,
                      "device_kind": jax.devices()[0].device_kind}),
          flush=True)


if __name__ == "__main__":
    main()
