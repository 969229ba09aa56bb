"""Triton compositor vs the jnp compositor, and the Triton kernel's shape sweep.

On the flagship scenes (3,616,103 splats, 1024x512, 32-px tiles) the records
are built and sorted once; then the two compositors run on the same sorted
records. The jnp compositor's ``max_per_tile`` is raised to the frame's
``max_bin`` so it drops nothing. Times are forward and forward+backward,
each the mean of ``--iters`` runs ended by ``block_until_ready``.

    python scripts/compositor_bench.py [--sweep] [--out FILE]

Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (chunk, block_pixels, num_warps, num_stages)
SWEEP = [
    (16, 256, 4, 1), (32, 256, 4, 1), (32, 256, 8, 1), (64, 256, 8, 1),
    (32, 128, 4, 1), (32, 512, 8, 1), (64, 128, 4, 1), (16, 512, 8, 1),
    (32, 256, 8, 3),
]


def gpu_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def max_abs(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def timed(fn, iters):
    import jax

    out = jax.block_until_ready(fn())        # warm (and compile)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1000.0, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/compositor_bench.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.ops import fastpath
    from openglgaussiansplattingrenderer_jax.ops.compositing import composite_tiles_jnp
    from openglgaussiansplattingrenderer_jax.ops.pallas import composite as pc
    from openglgaussiansplattingrenderer_jax.render import autotune_capacity
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    n, w, h, iters = scenes.FLAG_SPLATS, scenes.FLAG_W, scenes.FLAG_H, args.iters
    card = gpu_name()
    print(f"device {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"card {card}", flush=True)

    cam = scenes.camera_tuple(scenes.camera(w, h))
    result = {"card": card, "device_kind": dev.device_kind, "scenes": {}}
    for kind in ("uniform", "clustered"):
        params = scenes.to_params(scenes.flagship_scene(kind, n))
        cfg = autotune_capacity(params, *cam, w, h,
                                scenes.config(w, h, depth_key="packed"))
        sf2, bounds, _ = jax.jit(functools.partial(
            fastpath.sort_records, width=w, height=h, cfg=cfg))(params, *cam)
        counts = np.asarray(bounds[1:] - bounds[:-1])
        max_bin = int(counts.max())
        tiles = jnp.arange(cfg.num_tiles, dtype=jnp.int32)
        ct = jax.random.normal(jax.random.PRNGKey(0),
                               (cfg.num_tiles, (w // cfg.grid_x) * (h // cfg.grid_y), 4))
        rec = {"records": int(bounds[-1]), "max_bin": max_bin,
               "mean_bin": float(counts.mean()), "capacity": cfg.capacity(n)}
        print(f"{kind}: {rec}", flush=True)

        def tri(**kern):
            f = jax.jit(lambda s: pc.composite_tiles(s, bounds, tiles, w, h,
                                                     cfg, **kern))
            fb = jax.jit(jax.grad(lambda s: jnp.vdot(
                pc.composite_tiles(s, bounds, tiles, w, h, cfg, **kern), ct)))
            return f, fb

        f_t, fb_t = tri()
        ms_f, out_t = timed(lambda: f_t(sf2), iters)
        rec["triton_fwd_ms"] = ms_f
        if kind == "uniform":
            ms_fb, g_t = timed(lambda: fb_t(sf2), iters)
            rec["triton_fwdbwd_ms"] = ms_fb
            # the jnp compositor, capped at this frame's max_bin: drops nothing
            cfg_j = dataclasses.replace(
                cfg, max_per_tile=-(-max_bin // cfg.chunk) * cfg.chunk)
            with jax.default_matmul_precision("highest"):
                f_j = jax.jit(lambda s: composite_tiles_jnp(s, bounds, w, h, cfg_j))
                fb_j = jax.jit(jax.grad(lambda s: jnp.vdot(
                    composite_tiles_jnp(s, bounds, w, h, cfg_j), ct)))
                ms_jf, out_j = timed(lambda: f_j(sf2), max(1, iters // 2))
                ms_jfb, g_j = timed(lambda: fb_j(sf2), max(1, iters // 2))
            rec.update(jnp_fwd_ms=ms_jf, jnp_fwdbwd_ms=ms_jfb,
                       fwd_max_abs=max_abs(out_t, out_j),
                       px_over_1e3=int((np.abs(np.asarray(out_t) - np.asarray(out_j))
                                        .max(axis=-1) > 255e-3).sum()))
            rec["grad_max_rel"] = max(
                max_abs(a, b) / (float(np.abs(np.asarray(b)).max()) + 1e-30)
                for a, b in zip(g_t, g_j))
        if args.sweep:
            rows = []
            for chunk, pb, nw, ns in SWEEP:
                f_k, fb_k = tri(chunk=chunk, block_pixels=pb, num_warps=nw,
                                num_stages=ns)
                row = {"chunk": chunk, "block_pixels": pb, "num_warps": nw,
                       "num_stages": ns}
                row["fwd_ms"], _ = timed(lambda: f_k(sf2), iters)
                if kind == "uniform":
                    row["fwdbwd_ms"], _ = timed(lambda: fb_k(sf2), iters)
                print(f"  sweep {kind} {row}", flush=True)
                rows.append(row)
            rec["sweep"] = rows
        print(f"{kind}: {rec}", flush=True)
        result["scenes"][kind] = rec

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
