"""Capture a ``jax.profiler`` device trace of the fast path.

Compiles and warms the forward (and with ``TRACE_BWD=1`` the
forward+backward) outside the trace, prints the untraced wall time per
frame, then traces ``TRACE_ITERS`` frames into a TensorBoard/Perfetto
loadable directory (``TRACE_DIR``, default ``chiprun_out/trace`` in the
checkout). E.g. the flagship operating point, forward and backward:

    TRACE_SPLATS=3616103 TRACE_W=1024 TRACE_H=512 TRACE_DEPTH_KEY=packed \\
        TRACE_BWD=1 python scripts/trace_profile.py

``profile_stages.py`` attributes the same frame to pipeline stages by
prefix timing, without a trace.
"""

import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NUM_SPLATS = int(os.environ.get("TRACE_SPLATS", "1000000"))
WIDTH = int(os.environ.get("TRACE_W", "1920"))
HEIGHT = int(os.environ.get("TRACE_H", "1080"))
DEPTH_KEY = os.environ.get("TRACE_DEPTH_KEY", "pair")
SORT_PAYLOAD = os.environ.get("TRACE_SORT_PAYLOAD", "f32")
WITH_BWD = bool(int(os.environ.get("TRACE_BWD", "0")))
TRACE_DIR = os.environ.get("TRACE_DIR", os.path.join(ROOT, "chiprun_out",
                                                     "trace"))
ITERS = int(os.environ.get("TRACE_ITERS", "3"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.render import (
        autotune_capacity, render_arrays)
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}")

    # the flagship's uniform scene at capture scale, else the 1080p scene
    if NUM_SPLATS > 2_000_000:
        scene = scenes.flagship_scene("uniform", NUM_SPLATS)
    else:
        scene = scenes.train_scene(NUM_SPLATS)
    params = scenes.to_params(scene)
    cam = scenes.camera_tuple(scenes.camera(WIDTH, HEIGHT))
    cfg = autotune_capacity(params, *cam, WIDTH, HEIGHT, scenes.config(
        WIDTH, HEIGHT, depth_key=DEPTH_KEY, sort_payload=SORT_PAYLOAD))
    log(f"autotuned capacity {cfg.capacity_records}")

    fwd = jax.jit(functools.partial(render_arrays, width=WIDTH, height=HEIGHT,
                                    cfg=cfg))

    def run_traced(fn, label):
        jax.block_until_ready(fn())     # compile + warm outside the trace
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn()
        jax.block_until_ready(out)
        wall = (time.perf_counter() - t0) / ITERS * 1000
        trace_dir = os.path.join(TRACE_DIR, label)
        with jax.profiler.trace(trace_dir):
            for _ in range(ITERS):
                out = fn()
            jax.block_until_ready(out)
        log(f"[{label}] untraced wall {wall:.3f} ms/frame; trace in "
            f"{trace_dir}")
        return {"wall_ms": wall, "trace_dir": trace_dir}

    results = {"device_kind": jax.devices()[0].device_kind,
               "config": {"splats": NUM_SPLATS, "w": WIDTH, "h": HEIGHT,
                          "depth_key": DEPTH_KEY,
                          "sort_payload": SORT_PAYLOAD}}
    results["fwd"] = run_traced(lambda: fwd(params, *cam)[0], "fwd")
    if WITH_BWD:
        def loss(p):
            img, _ = render_arrays(p, *cam, WIDTH, HEIGHT, cfg)
            return jnp.mean(img[..., :3] ** 2)

        fb = jax.jit(jax.value_and_grad(loss))
        results["fwdbwd"] = run_traced(lambda: fb(params)[1], "fwdbwd")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
