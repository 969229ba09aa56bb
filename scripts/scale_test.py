"""Real-capture-scale validation: bike-big.ply's splat count, end to end.

The reference's flagship capture is bike-big.ply with 3,616,103 splats
(reference ``tests/plyParseTests.cpp:69``). This script generates a
synthetic scene with the same splat count, round-trips it through the PLY
writer and the native C++ loader (mmap + multithreaded activation), and
renders 1080p forward and forward+backward on the device -- probing
capacity and memory headroom at real-capture scale.

    python scripts/scale_test.py       # SCALE_SPLATS=6000000 for ~6M

The PLY is written to a temporary directory and removed afterwards. Every
time ends in ``block_until_ready``; one JSON line on stdout.
"""

import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# bike-big.ply's count by default; SCALE_SPLATS=6000000 approximates the
# reference README's recommended bicycle capture (~6M splats)
NUM_SPLATS = int(os.environ.get("SCALE_SPLATS", "3616103"))
WIDTH = int(os.environ.get("SCALE_W", "1920"))
HEIGHT = int(os.environ.get("SCALE_H", "1080"))
ITERS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed_ms(fn):
    import jax

    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / ITERS * 1000, out


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.io import native
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.render import render_arrays
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}")

    # ---- write + load through the native path ----------------------------
    scene = scenes.flagship_scene("uniform", NUM_SPLATS)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene.ply")
        t0 = time.perf_counter()
        ply_io.save_ply(path, scene["means"], scene["quats"], scene["scales"],
                        scene["opacities"], scene["colors"])
        log(f"wrote {os.path.getsize(path) / 1e6:.0f} MB PLY in "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        params_np = native.load_splats(path, 255.0)
        load_s = time.perf_counter() - t0
    n = params_np["means"].shape[0]
    assert n == NUM_SPLATS, n
    log(f"native loader: {n} splats in {load_s:.3f}s "
        f"({n / load_s / 1e6:.3f} Msplat/s)")

    cfg = scenes.config(WIDTH, HEIGHT, dup_capacity_factor=2.2)
    log(f"capacity {cfg.capacity(n)} records")
    params = scenes.to_params(params_np)
    cam = scenes.camera_tuple(scenes.camera(WIDTH, HEIGHT))

    fwd = jax.jit(functools.partial(render_arrays, width=WIDTH,
                                    height=HEIGHT, cfg=cfg))
    t0 = time.perf_counter()
    img, stats = jax.block_until_ready(fwd(params, *cam))
    log(f"fwd compile+run {time.perf_counter() - t0:.1f}s; stats "
        f"{ {k: np.asarray(v).tolist() for k, v in stats.items()} }")
    overflow = int(stats["overflow"])
    fwd_ms, _ = timed_ms(lambda: fwd(params, *cam))

    def loss(p):
        img, _ = render_arrays(p, *cam, WIDTH, HEIGHT, cfg)
        return jnp.mean(img[..., :3] ** 2)

    fb = jax.jit(jax.value_and_grad(loss))
    t0 = time.perf_counter()
    l, _ = jax.block_until_ready(fb(params))
    log(f"fwd+bwd compile+run {time.perf_counter() - t0:.1f}s; loss "
        f"{float(l):.6f}")
    fb_ms, (_, grads) = timed_ms(lambda: fb(params))

    finite = all(bool(jnp.all(jnp.isfinite(v))) for v in grads.values())
    log(f"fwd {fwd_ms:.3f} ms/frame ({1000 / fwd_ms:.3f} fps), fwd+bwd "
        f"{fb_ms:.3f} ms/frame, grads finite: {finite}, overflow {overflow}")
    print(json.dumps({
        "device_kind": jax.devices()[0].device_kind,
        "num_splats": n, "native_load_s": load_s,
        "fwd_ms": fwd_ms, "fwdbwd_ms": fb_ms,
        "fwd_fps": 1000 / fwd_ms, "overflow": overflow,
        "grads_finite": finite,
    }))


if __name__ == "__main__":
    main()
