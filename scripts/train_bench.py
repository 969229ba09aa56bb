"""Training-throughput benchmark: steps/s + PSNR-vs-step on one device.

Measures the actual training loop (adaptive density control on) end to end:

1. Ground truth: a clustered synthetic scene (real-capture statistics)
   rendered from V cameras on a circle -- the fitting targets.
2. Init: an SfM-like subsample of the GT means (jittered positions,
   nearest-neighbor scales, 0.1 opacity, gray colors) at CAP/8 splats.
3. Fit with ``densify.fit_scene_adaptive`` (clone/split/prune at static
   capacity CAP) for STEPS steps; every history entry carries wall-clock,
   so steps/s per segment and PSNR-vs-step come from one run.

Points: TRAIN_CAP=100000 (default) and TRAIN_CAP=1000000 cover the
"100k-1M splats" range on the 512x512 view set.

    python scripts/train_bench.py            # or TRAIN_CAP=1000000 ...

Prints progress to stderr and one JSON line to stdout.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAP = int(os.environ.get("TRAIN_CAP", "100000"))
GT_SPLATS = int(os.environ.get("TRAIN_GT", str(max(CAP, 50000))))
W = H = int(os.environ.get("TRAIN_RES", "512"))
VIEWS = int(os.environ.get("TRAIN_VIEWS", "12"))
STEPS = int(os.environ.get("TRAIN_STEPS", "600"))
LOG_EVERY = int(os.environ.get("TRAIN_LOG_EVERY", "50"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}; CAP={CAP} GT={GT_SPLATS} "
        f"res={W}x{H} views={VIEWS} steps={STEPS}")

    from openglgaussiansplattingrenderer_jax.camera import Camera
    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.io.colmap import init_params_from_points
    from openglgaussiansplattingrenderer_jax.train import densify, losses, trainer
    import importlib

    R = importlib.import_module("openglgaussiansplattingrenderer_jax.render")

    # ---- ground truth + targets -------------------------------------------
    gt = ply_io.make_clustered_scene(GT_SPLATS, seed=3, extent=2.0)
    gt_params = {k: jnp.asarray(v) for k, v in gt.items() if k != "sh_rest"}
    # duplication factor must cover the densified cloud; autotune on GT and
    # add headroom for the splats training grows
    cams = [Camera(float(3.5 * np.sin(a)), 0.6, float(-3.5 * np.cos(a)),
                   width=W, height=H)
            for a in np.linspace(0, 2 * np.pi, VIEWS, endpoint=False)]
    for c, a in zip(cams, np.linspace(0, 360, VIEWS, endpoint=False)):
        c.rotate_right(float(a))   # face the origin from the circle
    base = RenderConfig.for_resolution(W, H, tile_px=32)
    a0 = R.camera_args(cams[0])
    cfg = R.autotune_capacity(
        gt_params, a0["view"], a0["vp"], a0["focal_x"], a0["focal_y"],
        a0["tan_fovx"], a0["tan_fovy"], W, H, base, margin=1.6)
    # capacity must hold the TRAINING cloud at CAP rows, not the GT cloud
    import dataclasses

    cap_records = max(cfg.capacity_records,
                      R.quantize_capacity(int(CAP * 2.5)))
    cfg = dataclasses.replace(cfg, capacity_records=cap_records)
    log(f"render capacity {cfg.capacity_records} records")

    targets = []
    t0 = time.perf_counter()
    for c in cams:
        img, stats = R.render_stats(gt_params, c, cfg, W, H)
        targets.append(np.asarray(img)[..., :3])
        assert int(stats["overflow"]) == 0
    log(f"rendered {VIEWS} GT views in {time.perf_counter() - t0:.1f}s "
        f"(compile included); mean luma {np.mean(targets):.4f}")

    # ---- SfM-like init ------------------------------------------------------
    rng = np.random.default_rng(0)
    n0 = max(CAP // 8, 1000)
    idx = rng.choice(GT_SPLATS, n0, replace=False)
    pts = np.asarray(gt["means"])[idx] + rng.normal(0, 0.02, (n0, 3))
    init = init_params_from_points(
        pts.astype(np.float32),
        np.full((n0, 3), 128.0, np.float32), opacity=0.1)

    dc = densify.DensifyConfig(
        capacity=CAP, scene_extent=2.0, start_step=100,
        stop_step=int(STEPS * 0.8), interval=100,
        opacity_reset_interval=0)
    tc = trainer.TrainConfig(steps=STEPS, lr_means=2e-4,
                             lr_means_final=2e-6,
                             lr_means_decay_steps=STEPS)

    t0 = time.perf_counter()
    fitted, alive, history = densify.fit_scene_adaptive(
        init, targets, cams, cfg, dc, tc=tc, width=W, height=H,
        log_every=LOG_EVERY, verbose=True)
    total_s = time.perf_counter() - t0

    # steps/s from the last history segment (past all compiles/densify JITs)
    seg = [h for h in history if h["step"] >= STEPS // 2]
    steps_s = ((seg[-1]["step"] - seg[0]["step"])
               / max(seg[-1]["wall_s"] - seg[0]["wall_s"], 1e-9))

    # held-out quality: a new camera pose not in the training set
    hold = Camera(0.0, 1.4, -3.3, width=W, height=H)
    hold.rotate_right(23.0)
    hold.rotate_down(20.0)
    gt_img, _ = R.render_stats(gt_params, hold, cfg, W, H)
    fit_img, _ = R.render_stats(fitted, hold, cfg, W, H)
    holdout_psnr = float(losses.psnr(jnp.asarray(np.asarray(fit_img)[..., :3]),
                                     jnp.asarray(np.asarray(gt_img)[..., :3])))

    out = {
        "cap": CAP, "gt_splats": GT_SPLATS, "res": f"{W}x{H}",
        "views": VIEWS, "steps": STEPS,
        "device_kind": jax.devices()[0].device_kind,
        "steps_per_s": steps_s,
        "ms_per_step": 1000.0 / steps_s,
        "total_s": total_s,
        "final_alive": int(history[-1]["alive"]),
        "final_train_psnr": history[-1]["psnr"],
        "holdout_psnr": holdout_psnr,
        "psnr_curve": [{"step": h["step"], "psnr": h["psnr"],
                        "alive": h["alive"],
                        "wall_s": h["wall_s"]} for h in history],
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
