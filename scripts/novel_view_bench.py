"""Novel-view quality benchmark: many-view ADC training, holdout PSNR curve.

``train_bench.py``'s few synthetic views measure training throughput, not
novel-view generalisation (a dozen views overfit). This benchmark trains on
a dense view set and reports what a user of the framework cares about:
PSNR and SSIM on poses the optimiser never saw.

Setup:
  1. GT: a clustered synthetic scene (real-capture tile statistics),
     rendered from NV poses on two interleaved rings (two heights, facing
     the origin). Every HOLDOUT_EVERY-th pose is held out -- default
     72 poses = 64 train + 8 holdout.
  2. Init: SfM-like subsample at CAP/8 (jittered GT means, gray colors).
  3. Train with adaptive density control to CAP in SEGMENT-step chunks,
     checkpoint/resume between chunks (exact-replay resume,
     tests/test_densify.py::test_adaptive_kill_and_resume_matches), and
     evaluate the 8 holdout poses after each chunk -> the holdout curve.
  4. Artifact: GT | fit image grid over 4 holdout poses (``NV_GRID``).

    python scripts/novel_view_bench.py       # NV_* environment below

The checkpoint and the grid go to ``chiprun_out/`` in the checkout unless
``NV_CKPT`` / ``NV_GRID`` say otherwise. One JSON line on stdout.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CAP = int(os.environ.get("NV_CAP", "1000000"))
GT_SPLATS = int(os.environ.get("NV_GT", "500000"))
W = H = int(os.environ.get("NV_RES", "512"))
NPOSES = int(os.environ.get("NV_POSES", "72"))
HOLDOUT_EVERY = int(os.environ.get("NV_HOLDOUT_EVERY", "9"))
STEPS = int(os.environ.get("NV_STEPS", "3000"))
SEGMENT = int(os.environ.get("NV_SEGMENT", "500"))
# densify trigger threshold (graphdeco's 2e-4 default); 1e-4 grows more
# splats on this scene
GRAD_THRESHOLD = float(os.environ.get("NV_GRAD_THRESHOLD", "2e-4"))
CKPT = os.environ.get("NV_CKPT",
                      os.path.join(ROOT, "chiprun_out", "novel_view.ckpt.npz"))
GRID_PNG = os.environ.get("NV_GRID",
                          os.path.join(ROOT, "chiprun_out", "novel_view_grid.png"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_poses(n, w, h):
    """Two interleaved rings (heights 0.6 / 1.3) of origin-facing cameras."""
    from openglgaussiansplattingrenderer_jax.camera import Camera

    cams = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        hgt, rad, tilt = (0.6, 3.5, 8.0) if i % 2 == 0 else (1.3, 3.8, 17.0)
        c = Camera(float(rad * np.sin(a)), hgt, float(-rad * np.cos(a)),
                   width=w, height=h)
        c.rotate_right(float(np.degrees(a)))
        c.rotate_down(tilt)
        cams.append(c)
    return cams


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    os.makedirs(os.path.dirname(os.path.abspath(CKPT)), exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(GRID_PNG)), exist_ok=True)
    log(f"device: {jax.devices()[0]}; CAP={CAP} GT={GT_SPLATS} "
        f"res={W}x{H} poses={NPOSES} steps={STEPS} segment={SEGMENT}")

    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.io.colmap import (
        init_params_from_points,
    )
    from openglgaussiansplattingrenderer_jax.io.png import save_png, to_uint8
    from openglgaussiansplattingrenderer_jax.train import (
        densify, losses, trainer,
    )
    import importlib

    R = importlib.import_module("openglgaussiansplattingrenderer_jax.render")

    gt = ply_io.make_clustered_scene(GT_SPLATS, seed=3, extent=2.0)
    # NV_GT_COLORS=correlated replaces the generator's UNCORRELATED random
    # colors with a smooth low-frequency positional color field (sums of
    # sinusoids over the splat means): real captures have correlated
    # texture, and this tells whether the renderer or the speckle scene
    # limits the holdout PSNR.
    if os.environ.get("NV_GT_COLORS", "random") == "correlated":
        m = np.asarray(gt["means"])
        phase = [np.sin(1.3 * m[:, 0] + 0.7 * m[:, 1]),
                 np.sin(0.9 * m[:, 1] - 1.1 * m[:, 2] + 2.0),
                 np.sin(1.7 * m[:, 2] + 0.5 * m[:, 0] + 4.0)]
        gt["colors"] = np.stack(
            [(0.5 + 0.5 * p) * 255.0 for p in phase],
            axis=1).astype(np.float32)
        log("GT colors: correlated low-frequency positional field")
    gt_params = {k: jnp.asarray(v) for k, v in gt.items() if k != "sh_rest"}
    cams = make_poses(NPOSES, W, H)
    hold_idx = set(range(0, NPOSES, HOLDOUT_EVERY))
    train_cams = [c for i, c in enumerate(cams) if i not in hold_idx]
    hold_cams = [c for i, c in enumerate(cams) if i in hold_idx]
    log(f"{len(train_cams)} train poses, {len(hold_cams)} holdout poses")

    base = RenderConfig.for_resolution(W, H, tile_px=32)
    a0 = R.camera_args(cams[0])
    cfg = R.autotune_capacity(
        gt_params, a0["view"], a0["vp"], a0["focal_x"], a0["focal_y"],
        a0["tan_fovx"], a0["tan_fovy"], W, H, base, margin=1.6)
    cap_records = max(cfg.capacity_records,
                      R.quantize_capacity(int(CAP * 2.5)))
    cfg = dataclasses.replace(cfg, capacity_records=cap_records)
    log(f"render capacity {cfg.capacity_records} records")

    t0 = time.perf_counter()
    tgt_train, tgt_hold = [], []
    for i, c in enumerate(cams):
        img, stats = R.render_stats(gt_params, c, cfg, W, H)
        arr = np.asarray(img)[..., :3]
        assert int(stats["overflow"]) == 0
        (tgt_hold if i in hold_idx else tgt_train).append(arr)
    log(f"rendered {NPOSES} GT views in {time.perf_counter() - t0:.1f}s")

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
        grad_threshold=GRAD_THRESHOLD,
        opacity_reset_interval=int(os.environ.get("NV_OPACITY_RESET", "0")))
    tc_full = trainer.TrainConfig(steps=STEPS, lr_means=2e-4,
                                  lr_means_final=2e-6,
                                  lr_means_decay_steps=STEPS)

    def holdout_eval(params):
        """Per-pose (PSNR, SSIM). SSIM matters on correlated-texture GT:
        PSNR punishes coherent errors on smooth color fields much harder
        than speckle, so the two GT families are not PSNR-comparable."""
        ps, ss = [], []
        for c, t in zip(hold_cams, tgt_hold):
            img, _ = R.render_stats(params, c, cfg, W, H)
            pred = jnp.asarray(np.asarray(img)[..., :3])
            ps.append(float(losses.psnr(pred, jnp.asarray(t))))
            ss.append(float(losses.ssim(pred, jnp.asarray(t))))
        return ps, ss

    curve = []
    t_train0 = time.perf_counter()
    resume = None
    fitted = alive = None
    history_all = []
    for boundary in range(SEGMENT, STEPS + 1, SEGMENT):
        tc = dataclasses.replace(tc_full, steps=boundary)
        fitted, alive, hist = densify.fit_scene_adaptive(
            init, tgt_train, train_cams, cfg, dc, tc=tc, width=W, height=H,
            log_every=100, verbose=True, save_every=SEGMENT,
            checkpoint_path=CKPT, resume=resume)
        resume = CKPT
        history_all += hist
        hp, hs = holdout_eval(fitted)
        train_psnr = hist[-1]["psnr"] if hist else float("nan")
        curve.append({"step": boundary,
                      "train_psnr": train_psnr,
                      "holdout_psnr_mean": float(np.mean(hp)),
                      "holdout_psnr_min": float(np.min(hp)),
                      "holdout_ssim_mean": float(np.mean(hs)),
                      "holdout_ssim_min": float(np.min(hs)),
                      "alive": hist[-1]["alive"] if hist else None,
                      "wall_s": time.perf_counter() - t_train0})
        log(f"segment to {boundary}: train {train_psnr:.2f} dB, "
            f"holdout {np.mean(hp):.2f} dB (min {np.min(hp):.2f}), "
            f"ssim {np.mean(hs):.4f}")

    # ---- artifact: GT | fit grid over 4 holdout poses ---------------------
    rows = []
    for c, t in list(zip(hold_cams, tgt_hold))[:4]:
        img, _ = R.render_stats(fitted, c, cfg, W, H)
        rows.append(np.concatenate([t, np.asarray(img)[..., :3]], axis=1))
    save_png(GRID_PNG, to_uint8(np.concatenate(rows, axis=0)))
    log(f"wrote {GRID_PNG}")

    final = curve[-1]
    out = {
        "device_kind": jax.devices()[0].device_kind,
        "cap": CAP, "gt_splats": GT_SPLATS, "res": f"{W}x{H}",
        "train_views": len(train_cams), "holdout_views": len(hold_cams),
        "steps": STEPS,
        "final_train_psnr": final["train_psnr"],
        "final_holdout_psnr": final["holdout_psnr_mean"],
        "final_holdout_ssim": final.get("holdout_ssim_mean"),
        "generalisation_gap_db": (final["train_psnr"]
                                  - final["holdout_psnr_mean"]),
        "final_alive": final["alive"],
        "total_train_s": final["wall_s"],
        "curve": curve,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
