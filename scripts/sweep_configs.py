"""Device sweep of the pipeline's tile size.

Pairs composited = records x tile pixels; records grow as tiles shrink
(duplication) while per-record work falls, and a tile whose pixel count is
not a power of two pads the compositor's pixel blocks (24-px tiles: 576
pixels padded to 1024). Each config is timed as the two real programs
(fwd, fwd+bwd) at the 1M-splat 1080p scene. The compositor kernel's own
shape (record chunk, pixel block, warps) is swept by
``compositor_bench.py --sweep``.

    python scripts/sweep_configs.py

Every time ends in ``block_until_ready``; one JSON line per config.
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_SPLATS = int(os.environ.get("SWEEP_SPLATS", "1000000"))
WIDTH = int(os.environ.get("SWEEP_W", "1920"))
HEIGHT = int(os.environ.get("SWEEP_H", "1080"))
ITERS = int(os.environ.get("SWEEP_ITERS", "10"))

CONFIGS = [
    # (tile_px, dup_capacity_factor)
    (32, 4.0),   # the production grid
    (24, 5.0),
    (16, 6.0),
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.render import render_arrays
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}")

    params = scenes.to_params(scenes.train_scene(NUM_SPLATS))
    cam = scenes.camera_tuple(scenes.camera(WIDTH, HEIGHT))

    def timed_ms(fn):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        log(f"  compile+run {time.perf_counter() - t0:.0f}s")
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn()
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / ITERS * 1000, out

    results = []
    for tile_px, dupf in CONFIGS:
        cfg = RenderConfig.for_resolution(WIDTH, HEIGHT, tile_px=tile_px,
                                          dup_capacity_factor=dupf)
        log(f"--- tile {tile_px}, dup {dupf}: grid {cfg.grid_x}x{cfg.grid_y}, "
            f"capacity {cfg.capacity(NUM_SPLATS)}")
        fwd = jax.jit(functools.partial(render_arrays, width=WIDTH,
                                        height=HEIGHT, cfg=cfg))
        fwd_ms, (_, stats) = timed_ms(lambda: fwd(params, *cam))

        def loss(p, cfg=cfg):
            img, _ = render_arrays(p, *cam, WIDTH, HEIGHT, cfg)
            return jnp.mean(img[..., :3] ** 2)

        fb = jax.jit(jax.value_and_grad(loss))
        fb_ms, _ = timed_ms(lambda: fb(params))
        log(f"  => fwd {fwd_ms:.3f} ms, fwd+bwd {fb_ms:.3f} ms")
        results.append({"device_kind": jax.devices()[0].device_kind,
                        "tile_px": tile_px, "dup": dupf,
                        "records": int(stats["num_records"]),
                        "overflow": int(stats["overflow"]),
                        "max_bin": int(stats["max_bin"]),
                        "fwd_ms": fwd_ms, "fwdbwd_ms": fb_ms})
        print(json.dumps(results[-1]), flush=True)


if __name__ == "__main__":
    main()
