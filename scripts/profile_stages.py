"""Per-stage timing of the fast path on the device.

Each stage is measured as a complete compiled program that runs the pipeline
up to and including that stage (prefix timing), so stage cost =
prefix[k] - prefix[k-1] and the costs sum to the measured frame:

  prep      projection.preprocess + colours
  expand    + optional depth sort, cumsum, duplicate expand and cull
  sort      + the (tile, depth) record sort and the per-tile bounds
  composite + the fused compositor (the whole ``render_fast``)

The compositor is also timed alone on the sorted records (forward and
forward+backward), and the whole pipeline forward+backward. With
``PROF_BWD_STAGES=1`` the backward is attributed the same way, from
``value_and_grad`` of each prefix's output. Every time ends in
``block_until_ready``.

    python scripts/profile_stages.py                 # 1M splats, 1920x1080
    PROF_SPLATS=3616103 PROF_W=1024 PROF_H=512 PROF_SCENE=uniform \\
        PROF_DEPTH_KEY=packed python scripts/profile_stages.py   # flagship

Prints the table to stderr and one JSON line to stdout.
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_SPLATS = int(os.environ.get("PROF_SPLATS", "1000000"))
WIDTH = int(os.environ.get("PROF_W", "1920"))
HEIGHT = int(os.environ.get("PROF_H", "1080"))
ITERS = int(os.environ.get("PROF_ITERS", "20"))
REPEATS = 3
TILE_PX = int(os.environ.get("PROF_TILE_PX", "32"))
SCENE = os.environ.get("PROF_SCENE", "bench")      # bench|uniform|clustered
SKIP_BWD = bool(int(os.environ.get("PROF_SKIP_BWD", "0")))
BWD_STAGES = bool(int(os.environ.get("PROF_BWD_STAGES", "0")))
DEPTH_KEY = os.environ.get("PROF_DEPTH_KEY", "pair")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_fn(fn, *args):
    """Median over REPEATS of the mean per-iteration time of ITERS calls."""
    import jax

    out = jax.block_until_ready(fn(*args))        # compile + warm
    results = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn(*args)
        jax.block_until_ready(out)
        results.append((time.perf_counter() - t0) / ITERS * 1000)
    return float(np.median(results)), out


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.ops import fastpath, projection
    from openglgaussiansplattingrenderer_jax.ops.pallas import composite as pc
    from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance
    from openglgaussiansplattingrenderer_jax.render import (
        autotune_capacity, effective_colors)
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}")

    if SCENE == "bench":
        scene = scenes.train_scene(NUM_SPLATS)
    else:
        scene = scenes.flagship_scene(SCENE, NUM_SPLATS)
    params = scenes.to_params(scene)
    cam = scenes.camera_tuple(scenes.camera(WIDTH, HEIGHT))
    cfg = autotune_capacity(params, *cam, WIDTH, HEIGHT,
                            RenderConfig.for_resolution(
                                WIDTH, HEIGHT, tile_px=TILE_PX,
                                depth_key=DEPTH_KEY))
    static = dict(width=WIDTH, height=HEIGHT, cfg=cfg)

    def prep(p, *c):
        cov6 = build_covariance(p["scales"], p["quats"])
        pr = projection.preprocess(p["means"], cov6, p["opacities"], c[0],
                                   c[1], WIDTH, HEIGHT, *c[2:], cfg)
        return pr, effective_colors(p, c[0], cfg)

    prefixes = {
        "prep": prep,
        "expand": functools.partial(fastpath.expand_depth_records, **static),
        "sort": functools.partial(fastpath.sort_records, **static),
        "composite": functools.partial(fastpath.render_fast, **static),
    }
    prefix_ms = {}
    for name, fn in prefixes.items():
        t0 = time.perf_counter()
        prefix_ms[name], _ = time_fn(jax.jit(fn), params, *cam)
        log(f"prefix[{name:9s}] = {prefix_ms[name]:8.3f} ms   (compile+measure "
            f"{time.perf_counter() - t0:.0f}s)")

    log("\n--- stage costs (prefix differences) ---")
    table, prev = {}, 0.0
    for name, ms in prefix_ms.items():
        table[name] = ms - prev
        prev = ms
        log(f"{name:10s} {table[name]:8.3f} ms")

    # --- the compositor alone (fwd and fwd+bwd) ---------------------------
    sf2, bounds, _ = jax.jit(prefixes["sort"])(params, *cam)
    tiles = jnp.arange(cfg.num_tiles, dtype=jnp.int32)

    def comp(fields):
        return pc.composite_tiles(fields, bounds, tiles, WIDTH, HEIGHT, cfg)

    ms_fwd, _ = time_fn(jax.jit(comp), sf2)
    log(f"composite fwd (alone)        = {ms_fwd:8.3f} ms")

    ms_fb = ms_full_fb = None
    if not SKIP_BWD:
        comp_fb = jax.jit(jax.value_and_grad(
            lambda f: jnp.sum(comp(f)[:, :, 0:3] ** 2)))
        ms_fb, _ = time_fn(comp_fb, sf2)
        log(f"composite fwd+bwd (alone)    = {ms_fb:8.3f} ms "
            f"(bwd ~ {ms_fb - ms_fwd:.3f} ms)")

        def loss(p):
            img, _ = fastpath.render_fast(p, *cam, **static)
            return jnp.mean(img[..., :3] ** 2)

        ms_full_fb, _ = time_fn(jax.jit(jax.value_and_grad(loss)), params)
        log(f"full fwd+bwd                 = {ms_full_fb:8.3f} ms")

    # --- backward attribution by fwd+bwd prefix timing --------------------
    # grad(sum(prefix_k output)) runs stages 1..k forward and their
    # transposes; bwd cost of stage k = (fwd+bwd prefix difference) - (fwd
    # prefix difference). Integer outputs (tile ids, counts) carry no
    # gradient and are left out of the sums.
    bwd_table = {}
    if BWD_STAGES and not SKIP_BWD:
        log("\n--- backward prefixes (value_and_grad of stage sums) ---")

        def float_sum(tree):
            return sum(jnp.sum(x.astype(jnp.float32) ** 2)
                       for x in jax.tree.leaves(tree)
                       if jnp.issubdtype(x.dtype, jnp.floating))

        fb_prefix = {}
        for name, fn in prefixes.items():
            out_of = (lambda f: lambda p: float_sum(f(p, *cam)[0]))(fn)
            if name == "composite":
                out_of = loss
            t0 = time.perf_counter()
            fb_prefix[name], _ = time_fn(
                jax.jit(jax.value_and_grad(out_of)), params)
            log(f"fwd+bwd prefix[{name:9s}] = {fb_prefix[name]:8.3f} ms   "
                f"(compile+measure {time.perf_counter() - t0:.0f}s)")
        log("\n--- backward-only stage costs ---")
        prev_fb = prev_fw = 0.0
        for name in prefixes:
            dfb = fb_prefix[name] - prev_fb
            dfw = prefix_ms[name] - prev_fw
            prev_fb, prev_fw = fb_prefix[name], prefix_ms[name]
            bwd_table[name] = dfb - dfw
            log(f"{name:10s} bwd {dfb - dfw:8.3f} ms (fwd {dfw:.3f})")

    print(json.dumps({
        "device_kind": jax.devices()[0].device_kind,
        "splats": NUM_SPLATS, "width": WIDTH, "height": HEIGHT,
        "scene": SCENE, "depth_key": DEPTH_KEY,
        "prefix_ms": prefix_ms,
        "stage_ms": table,
        "composite_fwd_ms": ms_fwd,
        "composite_fwdbwd_ms": ms_fb,
        "full_fwdbwd_ms": ms_full_fb,
        "bwd_stage_ms": bwd_table,
    }))


if __name__ == "__main__":
    main()
