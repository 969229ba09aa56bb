"""Three baseline checks of the renderer on the available device.

  1. The reference's single-Gaussian fixture (``testSingleItem.ply``'s
     values, ``io.ply.single_splat_scene``) at 256x256 against the numpy
     golden pipeline (``golden.py``), held to the reference's own CPU/GPU
     tolerance of 1e-2.
  2. A synthetic 10k-splat scene, forward only, 512x512: frame time.
  3. A synthetic 100k-splat scene at 512x512: forward+backward time, and
     the gradient of each parameter tensor against a central finite
     difference along its own direction.

    python scripts/baseline_eval.py

Every time ends in ``block_until_ready``. Prints one line per check and a
JSON summary as the last line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed_ms(fn, iters):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1000, out


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import golden, scenes
    from openglgaussiansplattingrenderer_jax.camera import Camera
    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance
    from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    summary = {"device_kind": dev.device_kind, "platform": dev.platform}

    def forward(params, cam, cfg, w, h):
        c = scenes.camera_tuple(cam)
        fwd = jax.jit(lambda p: render_arrays(p, *c, w, h, cfg))
        ms, (img, stats) = timed_ms(lambda: fwd(params), 10)
        return np.asarray(img), stats, ms

    # ---- 1: single splat vs golden --------------------------------------
    scene = ply_io.single_splat_scene()
    cam = Camera(0.0, 0.0, -3.0, width=256, height=256)
    cfg1 = RenderConfig(dup_capacity_factor=256.0)
    img, _, ms = forward(scenes.to_params(scene), cam, cfg1, 256, 256)
    a = camera_args(cam)
    gparams = {"means": scene["means"],
               "cov6": np.asarray(build_covariance(scene["scales"],
                                                   scene["quats"])),
               "opacities": scene["opacities"], "colors": scene["colors"]}
    gold, _ = golden.golden_render(gparams, a["view"], a["vp"], a["focal_x"],
                                   a["focal_y"], a["tan_fovx"], a["tan_fovy"],
                                   256, 256, cfg1)
    diff = float(np.abs(img - gold).max())
    summary["single_splat_vs_golden_max_abs"] = diff
    summary["single_splat_ms"] = ms
    print(f"1: single splat vs golden max abs {diff:.3e} (limit 1e-2), "
          f"{ms:.3f} ms/frame", flush=True)
    assert diff < 1e-2, diff

    # ---- 2: 10k splats forward, 512x512 ---------------------------------
    cam = Camera(0.0, 0.0, -6.0, width=512, height=512)
    cfg2 = RenderConfig(dup_capacity_factor=16.0)
    _, stats, ms = forward(scenes.to_params(scenes.gate_scene()), cam, cfg2,
                           512, 512)
    assert int(stats["overflow"]) == 0
    summary["splats10k_512_fwd_ms"] = ms
    print(f"2: 10k splats 512x512 forward {ms:.3f} ms/frame, records "
          f"{int(stats['num_records'])}", flush=True)

    # ---- 3: 100k splats fwd+bwd + finite-difference check ---------------
    scene = ply_io.make_synthetic_scene(100_000, seed=11, extent=3.0,
                                        log_scale_range=(-5.0, -3.0))
    params = scenes.to_params(scene)
    c = scenes.camera_tuple(Camera(0.0, 0.0, -8.0, width=512, height=512))
    cfg3 = scenes.config(512, 512, dup_capacity_factor=12.0)
    target = jnp.zeros((512, 512, 3))

    def loss_fn(p):
        img, _ = render_arrays(p, *c, 512, 512, cfg3)
        return jnp.mean((img[..., :3] - target) ** 2)

    vgrad = jax.jit(jax.value_and_grad(loss_fn))
    fb_ms, (_, grads) = timed_ms(lambda: vgrad(params), 5)
    summary["splats100k_512_fwdbwd_ms"] = fb_ms
    print(f"3: 100k splats 512x512 forward+backward {fb_ms:.3f} ms",
          flush=True)

    loss_jit = jax.jit(loss_fn)
    fd_rel = {}
    # Probe along the gradient direction with eps sized so the loss delta
    # (~1e-3) towers over float32 loss resolution (~1e-8); central
    # differences are exact for the quadratic colour terms and dominate the
    # step-discontinuity noise elsewhere at this scale.
    for key in ("colors", "means", "scales", "opacities", "quats"):
        g = np.asarray(grads[key], np.float64)
        gn = np.linalg.norm(g)
        d = (g / max(gn, 1e-30)).astype(np.float32)
        eps = float(np.clip(5e-4 / max(gn, 1e-12), 1e-4, 50.0))
        lp = float(loss_jit(dict(params, **{key: params[key] + eps * d})))
        lm = float(loss_jit(dict(params, **{key: params[key] - eps * d})))
        fd = (lp - lm) / (2 * eps)
        fd_rel[key] = abs(fd - gn) / max(abs(gn), abs(fd), 1e-12)
        print(f"3: finite difference {key}: autodiff {gn:.4e}, fd {fd:.4e}, "
              f"eps {eps:.2e}, rel {fd_rel[key]:.3e}", flush=True)
    summary["fd_rel_err"] = fd_rel
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
