"""Re-evaluate a novel_view_bench checkpoint's holdout poses (PSNR + SSIM).

Reconstructs the exact GT protocol (same seeds / pose rings / holdout
interleave as scripts/novel_view_bench.py) and scores a finished run's
checkpoint on the 8 holdout poses, pose by pose.

    NV_CKPT=chiprun_out/novel_view.ckpt.npz python scripts/nv_holdout_eval.py

Env mirrors novel_view_bench: NV_GT, NV_CAP, NV_RES, NV_POSES,
NV_HOLDOUT_EVERY, NV_GT_COLORS, NV_CKPT (same default).
"""

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from novel_view_bench import CKPT, make_poses  # noqa: E402

CAP = int(os.environ.get("NV_CAP", "1000000"))
GT_SPLATS = int(os.environ.get("NV_GT", "500000"))
W = H = int(os.environ.get("NV_RES", "512"))
NPOSES = int(os.environ.get("NV_POSES", "72"))
HOLDOUT_EVERY = int(os.environ.get("NV_HOLDOUT_EVERY", "9"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}; ckpt={CKPT}")

    import importlib

    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.train import losses, trainer

    R = importlib.import_module("openglgaussiansplattingrenderer_jax.render")

    gt = ply_io.make_clustered_scene(GT_SPLATS, seed=3, extent=2.0)
    if os.environ.get("NV_GT_COLORS", "random") == "correlated":
        m = np.asarray(gt["means"])
        phase = [np.sin(1.3 * m[:, 0] + 0.7 * m[:, 1]),
                 np.sin(0.9 * m[:, 1] - 1.1 * m[:, 2] + 2.0),
                 np.sin(1.7 * m[:, 2] + 0.5 * m[:, 0] + 4.0)]
        gt["colors"] = np.stack(
            [(0.5 + 0.5 * p) * 255.0 for p in phase],
            axis=1).astype(np.float32)
    gt_params = {k: jnp.asarray(v) for k, v in gt.items() if k != "sh_rest"}
    cams = make_poses(NPOSES, W, H)
    hold_idx = sorted(set(range(0, NPOSES, HOLDOUT_EVERY)))
    hold_cams = [cams[i] for i in hold_idx]

    base = RenderConfig.for_resolution(W, H, tile_px=32)
    a0 = R.camera_args(cams[0])
    cfg = R.autotune_capacity(
        gt_params, a0["view"], a0["vp"], a0["focal_x"], a0["focal_y"],
        a0["tan_fovx"], a0["tan_fovy"], W, H, base, margin=1.6)
    cap_records = max(cfg.capacity_records,
                      R.quantize_capacity(int(CAP * 2.5)))
    cfg = dataclasses.replace(cfg, capacity_records=cap_records)

    raw, step, extras = trainer.load_checkpoint_full(CKPT)
    params = trainer.params_from_raw(
        {k: jnp.asarray(v) for k, v in raw.items()})
    alive = int(np.sum(extras["alive"])) if "alive" in extras else None
    log(f"checkpoint step {step}, alive {alive}")

    rows = []
    for i, c in zip(hold_idx, hold_cams):
        gt_img, _ = R.render_stats(gt_params, c, cfg, W, H)
        t = jnp.asarray(np.asarray(gt_img)[..., :3])
        img, _ = R.render_stats(params, c, cfg, W, H)
        pred = jnp.asarray(np.asarray(img)[..., :3])
        rows.append({"pose": i,
                     "psnr": float(losses.psnr(pred, t)),
                     "ssim": float(losses.ssim(pred, t))})
        log(rows[-1])

    print(json.dumps({
        "ckpt": CKPT, "step": step, "alive": alive,
        "holdout_psnr_mean": float(np.mean([r["psnr"] for r in rows])),
        "holdout_ssim_mean": float(np.mean([r["ssim"] for r in rows])),
        "per_pose": rows,
    }))


if __name__ == "__main__":
    main()
