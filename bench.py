"""Headline benchmark. Prints ONE JSON line; details go to stderr.

The reference's own operating point: bike-big.ply's 3,616,103 splats
(reference ``tests/plyParseTests.cpp:69``) at its default 1024x512
(``include/Camera.h:55,62``), forward-only fps, on the WORSE of two scene
statistics (a uniform cloud and a clustered, heavy-tailed one that models
real SfM captures). vs_baseline = fps / 30: 1.0 means the card matches the
interactive-30fps bar on the reference's flagship scene.

Also reported: msplats_fwdbwd_1080p, million splat-renders/s through the
full differentiable pipeline (forward + analytic backward + gradients) on
the 1M-splat 1920x1080 scene -- the training-oriented number.

Needs a GPU; every time ends in ``block_until_ready``.
"""

import dataclasses
import functools
import json
import subprocess
import sys
import time

BASELINE_FPS = 30.0               # interactive bar at the flagship point
BASELINE_MSPLAT_S = 3.616103 * 30.0
ITERS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, iters=ITERS):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1000.0, out


def main():
    import jax
    import jax.numpy as jnp

    from chip_smoke import FWD_BAD_FRACTION, FWD_MAX_ABS, image_diff
    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.render import autotune_capacity, render_arrays
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    enable_compile_cache()

    # ---- on-device correctness gate (before any timing) ------------------
    # The compiled kernels against the jnp oracle pipeline on the SAME
    # device, held to chip_smoke.py's limits: a handful of
    # saturation-borderline pixels may flip (QUIRKS.md), a miscompile would
    # not.
    g = scenes.GATE_W
    gcam = scenes.camera_tuple(scenes.camera(g, g, z=-6.0))
    gparams = scenes.to_params(scenes.gate_scene())
    gcfg = scenes.config(g, g, dup_capacity_factor=8.0, max_per_tile=2048)
    gimg, _ = jax.jit(functools.partial(
        render_arrays, width=g, height=g, cfg=gcfg))(gparams, *gcam)
    jimg, jstats = jax.jit(functools.partial(
        render_arrays, width=g, height=g,
        cfg=dataclasses.replace(gcfg, use_pallas=False)))(gparams, *gcam)
    assert int(jstats["dropped_by_cap"]) == 0, "gate scene exceeds oracle cap"
    gate_diff, gate_bad = image_diff(gimg, jimg)
    log(f"correctness gate: max abs diff {gate_diff:.2e} (limit "
        f"{FWD_MAX_ABS:.0e}), share of px > 1e-3 {gate_bad:.2e} (limit "
        f"{FWD_BAD_FRACTION:.0e})")
    assert gate_diff <= FWD_MAX_ABS and gate_bad <= FWD_BAD_FRACTION, (
        gate_diff, gate_bad)

    # ---- 1M splats at 1080p: forward, and forward + backward -------------
    w, h = scenes.TRAIN_W, scenes.TRAIN_H
    cam = scenes.camera_tuple(scenes.camera(w, h))
    params = scenes.to_params(scenes.train_scene())
    cfg = autotune_capacity(params, *cam, w, h, scenes.config(w, h))
    fwd = jax.jit(functools.partial(render_arrays, width=w, height=h,
                                    cfg=cfg))

    @jax.jit
    def fwdbwd(p):
        def loss(p):
            img, _ = render_arrays(p, *cam, w, h, cfg)
            return jnp.mean(img[..., :3] ** 2)
        return jax.value_and_grad(loss)(p)

    fwd_ms, (_, stats) = timed(lambda: fwd(params, *cam))
    assert int(stats["overflow"]) == 0, "1080p capacity overflow"
    fb_ms, (_, grads) = timed(lambda: fwdbwd(params))
    finite = all(bool(jnp.all(jnp.isfinite(v))) for v in grads.values())
    assert finite, "non-finite gradients"
    log(f"1080p: fwd {fwd_ms:.3f} ms, fwd+bwd {fb_ms:.3f} ms ({card})")
    msplat_s = scenes.TRAIN_SPLATS / 1e6 * (1000.0 / fb_ms)

    # ---- flagship: the reference's own operating point, fwd-only ---------
    # depth_key="packed": one u32 tile||22-bit-depth key on the record sort
    # -- at least the reference's own packed float key's precision
    # (preprocess.glsl:154); the gate above runs the exact "pair" mode.
    fw, fh = scenes.FLAG_W, scenes.FLAG_H
    fcam = scenes.camera_tuple(scenes.camera(fw, fh))
    fcfg0 = scenes.config(fw, fh, depth_key="packed")
    fparams = {k: scenes.to_params(scenes.flagship_scene(k))
               for k in ("uniform", "clustered")}
    fcap = max(autotune_capacity(p, *fcam, fw, fh, fcfg0).capacity_records
               for p in fparams.values())
    fcfg = scenes.with_capacity(fcfg0, fcap)
    ffwd = jax.jit(functools.partial(render_arrays, width=fw, height=fh,
                                     cfg=fcfg))
    fq = jax.jit(functools.partial(
        render_arrays, width=fw, height=fh,
        cfg=dataclasses.replace(fcfg, sort_payload="q16")))
    flag_fps, q_fps, q_err = {}, {}, 0.0
    for name, p in fparams.items():
        ms, (img, st) = timed(lambda: ffwd(p, *fcam))
        assert int(st["overflow"]) == 0, f"flagship {name} overflow"
        flag_fps[name] = 1000.0 / ms
        qms, (qimg, _) = timed(lambda: fq(p, *fcam))
        err = float(jnp.max(jnp.abs(qimg[..., :3] - img[..., :3])))
        assert err < 0.01, f"q16 {name} image error {err}"
        q_err = max(q_err, err)
        q_fps[name] = 1000.0 / qms
        log(f"flagship {name}: {ms:.3f} ms/frame, q16 {qms:.3f} ms/frame "
            f"(err {err:.2e}), records {int(st['num_records'])}, max_bin "
            f"{int(st['max_bin'])} ({card})")

    def floss(p):
        img, _ = render_arrays(p, *fcam, fw, fh, fcfg)
        return jnp.mean(img[..., :3] ** 2)

    ffb = jax.jit(jax.value_and_grad(floss))
    flag_fb_ms, _ = timed(lambda: ffb(fparams["uniform"]))
    log(f"flagship uniform fwd+bwd: {flag_fb_ms:.3f} ms/step ({card})")

    flag = min(flag_fps.values())   # the worse statistics
    print(json.dumps({
        "metric": "fps_flagship_1024x512_fwd",
        "value": flag,
        "unit": "fps",
        "vs_baseline": flag / BASELINE_FPS,
        "flagship_fps_uniform": flag_fps["uniform"],
        "flagship_fps_clustered": flag_fps["clustered"],
        "msplats_fwdbwd_1080p": msplat_s,
        "msplats_fwdbwd_1080p_vs_proxy": msplat_s / BASELINE_MSPLAT_S,
        "flagship_fwdbwd_ms": flag_fb_ms,
        "flagship_fps_inference": min(q_fps.values()),
        "inference_img_err_vs_f32": q_err,
        "card": card,
        "device": device,
    }))


if __name__ == "__main__":
    main()
