#!/usr/bin/env python
"""Training CLI -- fit a splat scene to rendered target views.

The reference is a forward-only renderer; this drives the framework's
differentiable capability end-to-end from the command line: load a 3DGS
PLY, render target views on an orbit, re-fit a (smaller / randomised)
splat set to those views -- optionally growing it with adaptive density
control -- and write the fitted scene back out as a PLY plus a
target-vs-fit comparison PNG and a JSON loss/PSNR history.

Examples:
  python scripts/train_cli.py scene.ply -o fitted.ply --steps 300
  python scripts/train_cli.py scene.ply --init subset --init-count 500 \
      --densify --capacity 2000 --platform cpu --no-pallas
"""

import argparse
import json
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene", help="target 3DGS PLY file, a NeRF-style "
                    "transforms.json posed-image dataset (fit from images, "
                    "random init), or a COLMAP workspace/model directory "
                    "(fit from images, SfM point-cloud init)")
    ap.add_argument("--init-extent", type=float, default=2.0,
                    help="dataset mode: radius of the random init cloud")
    ap.add_argument("-o", "--output", default="fitted.ply")
    ap.add_argument("--out-png", default="fit_compare.png",
                    help="side-by-side target | fitted render of view 0")
    ap.add_argument("--history", default="fit_history.json")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--views", type=int, default=6,
                    help="number of orbit target views")
    ap.add_argument("--orbit-radius", type=float, default=5.0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--init", choices=["subset", "noise"], default="subset",
                    help="fit from a random subset of the target splats, or "
                         "from subset positions with perturbed appearance")
    ap.add_argument("--init-count", type=int, default=0,
                    help="initial splat count (0 = target count / 4)")
    ap.add_argument("--densify", action="store_true",
                    help="enable adaptive density control")
    ap.add_argument("--data-parallel", type=int, default=0, metavar="NDEV",
                    help="view-parallel training over NDEV devices (one "
                    "view per device per step; params replicated, grads "
                    "pmean-synced). 0 = off; requires NDEV <= device "
                    "count; composes with --densify")
    ap.add_argument("--mesh2d", default="", metavar="DVxDS",
                    help="2-D mesh training, e.g. 2x4: DV view rows x DS "
                    "splat shards (params splat-sharded, batch of DV views "
                    "per step). Mutually exclusive with --data-parallel; "
                    "composes with --densify")
    ap.add_argument("--capacity", type=int, default=0,
                    help="densify capacity (0 = 4x init count)")
    ap.add_argument("--densify-interval", type=int, default=100)
    ap.add_argument("--densify-start", type=int, default=50,
                    help="first step eligible for densification")
    ap.add_argument("--grad-threshold", type=float, default=2e-4)
    ap.add_argument("--opacity-reset-interval", type=int, default=0,
                    help="3DGS periodic opacity reset every N steps "
                         "(0 = off; the paper uses 3000)")
    ap.add_argument("--lambda-dssim", type=float, default=0.2)
    ap.add_argument("--antialiased", action="store_true",
                    help="train with opacity compensation (anti-aliased "
                         "mode); render the result with --antialiased too")
    ap.add_argument("--lr-means-final", type=float, default=0.0,
                    help="enable the 3DGS exponential position-LR decay "
                         "down to this value (0 = constant LR)")
    ap.add_argument("--lr-decay-steps", type=int, default=0,
                    help="position-LR decay horizon (default: --steps)")
    ap.add_argument("--lr-scale", type=float, default=1.0,
                    help="multiplier on all default learning rates")
    ap.add_argument("--sh-degree", type=int, default=0,
                    help="render/train view-dependent SH up to this degree")
    ap.add_argument("--tile-px", type=int, default=32)
    ap.add_argument("--capacity-factor", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--no-pallas", action="store_true")
    ap.add_argument("--bf16-grads", action="store_true",
                    help="pack cotangent pairs to bf16 through the record-"
                    "sort backward (GS_BWD_SORT=bf16): measured -21 ms on "
                    "the flagship backward; gradients round to bf16 before "
                    "the per-splat sum (Adam-safe, not bit-equal to f32)")
    ap.add_argument("--save-every", type=int, default=0, metavar="N",
                    help="write a full-state checkpoint (params + optimizer "
                    "+ densify state) every N steps; 0 = off")
    ap.add_argument("--ckpt", default="", metavar="PATH",
                    help="checkpoint path (default: <output>.ckpt.npz)")
    ap.add_argument("--resume", default="", metavar="PATH",
                    help="resume training from a checkpoint written by "
                    "--save-every; replays the uninterrupted run exactly")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--platform", default="auto",
                    choices=["auto", "cpu", "gpu"])
    args = ap.parse_args()

    if args.mesh2d and args.data_parallel:
        print("FATAL: --mesh2d is mutually exclusive with --data-parallel",
              file=sys.stderr)
        sys.exit(1)
    mesh2d_dims = None
    if args.mesh2d:
        try:
            dv, ds = (int(x) for x in args.mesh2d.lower().split("x"))
            if dv < 1 or ds < 1:
                raise ValueError
            mesh2d_dims = (dv, ds)
        except ValueError:
            print(f"FATAL: --mesh2d wants DVxDS with positive dims "
                  f"(e.g. 2x4), got {args.mesh2d!r}", file=sys.stderr)
            sys.exit(1)

    # multi-device modes on CPU: provision virtual devices before the
    # backend initializes (XLA_FLAGS is read lazily at CPU-client creation)
    need_dev = max(args.data_parallel,
                   mesh2d_dims[0] * mesh2d_dims[1] if mesh2d_dims else 0)
    if need_dev > 1 and args.platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={need_dev}"
            ).strip()

    if args.platform != "auto":
        import jax

        jax.config.update("jax_platforms", args.platform)

    if args.bf16_grads:
        # must land before any train step is traced (the flag binds at
        # trace time -- ops/records.py BWD_COT_PACK)
        from openglgaussiansplattingrenderer_jax.ops import records as _rk

        _rk.BWD_COT_PACK = "bf16"

    import numpy as np
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import RenderConfig
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.io.png import save_png
    from openglgaussiansplattingrenderer_jax.render import render_stats
    from openglgaussiansplattingrenderer_jax.train import (
        DensifyConfig, TrainConfig, fit_scene, fit_scene_adaptive, losses,
    )
    from openglgaussiansplattingrenderer_jax.train import densify as dn
    from openglgaussiansplattingrenderer_jax.viewer.offline import orbit_cameras

    cfg = RenderConfig.for_resolution(
        args.width, args.height, tile_px=args.tile_px,
        use_pallas=not args.no_pallas, chunk=args.chunk,
        dup_capacity_factor=args.capacity_factor,
        sh_degree=args.sh_degree, antialiased=args.antialiased)

    rng = np.random.default_rng(args.seed)
    if os.path.isdir(args.scene):
        # COLMAP workspace: <dir>/sparse/0 model + <dir>/images, or the
        # model directory itself. Init from the SfM point cloud (3DGS
        # sec. 4). Pass --width/--height matching the capture resolution.
        from openglgaussiansplattingrenderer_jax.io import colmap as colmap_io

        sparse = args.scene
        if not any(os.path.exists(os.path.join(sparse, "cameras" + e))
                   for e in (".bin", ".txt")):
            sparse = os.path.join(args.scene, "sparse", "0")
        cams, images, points = colmap_io.load_colmap(sparse)
        pairs = [(c, im) for c, im in zip(cams, images) if im is not None]
        if not pairs:
            print("FATAL: COLMAP model has no readable images",
                  file=sys.stderr)
            sys.exit(1)
        cams = [c for c, _ in pairs]
        targets = [np.asarray(im, np.float32) for _, im in pairs]
        start = colmap_io.init_params_from_points(
            points["xyz"], points["rgb"],
            max_points=args.init_count or None, seed=args.seed)
        if args.sh_degree > 0:
            start["sh_rest"] = np.zeros((len(start["means"]), 45),
                                        np.float32)
        extent = float(np.abs(start["means"]
                              - start["means"].mean(0)).max()) or 1.0
        print(f"COLMAP: {len(cams)} posed images, "
              f"{len(start['means'])} SfM seed points", file=sys.stderr)
    elif args.scene.endswith(".json"):
        # posed-image dataset: fit from the images, random init cloud
        from openglgaussiansplattingrenderer_jax.io import dataset as ds_io

        cams, images = ds_io.load_transforms(args.scene)
        pairs = [(c, im) for c, im in zip(cams, images) if im is not None]
        if not pairs:
            print("FATAL: dataset has no readable images", file=sys.stderr)
            sys.exit(1)
        cams = [c for c, _ in pairs]
        targets = [np.asarray(im, np.float32) for _, im in pairs]
        extent = args.init_extent
        n0 = args.init_count or 512
        start = {
            "means": rng.normal(0.0, extent / 2.0, (n0, 3)).astype(np.float32),
            "scales": np.full((n0, 3), extent / 30.0, np.float32),
            "quats": np.tile(np.array([1.0, 0, 0, 0], np.float32), (n0, 1)),
            "opacities": np.full(n0, 0.3, np.float32),
            "colors": np.full((n0, 3), 128.0, np.float32),
        }
        if args.sh_degree > 0:
            start["sh_rest"] = np.zeros((n0, 45), np.float32)
        print(f"dataset: {len(cams)} posed images, init {n0} random splats",
              file=sys.stderr)
    else:
        scene = ply_io.load_splats(args.scene)
        keep_sh = args.sh_degree > 0
        target_params = {k: jnp.asarray(v) for k, v in scene.items()
                         if keep_sh or k != "sh_rest"}
        n = int(target_params["means"].shape[0])
        center = np.asarray(target_params["means"]).mean(axis=0)
        extent = float(np.abs(np.asarray(target_params["means"])
                              - center).max())
        print(f"target: {n} splats, extent {extent:.2f}", file=sys.stderr)

        cams = orbit_cameras(center, args.orbit_radius, args.views,
                             width=args.width, height=args.height)
        targets = []
        for cam in cams:
            img, stats = render_stats(target_params, cam, cfg)
            if int(stats["overflow"]) > 0:
                print(f"WARNING: target render overflow "
                      f"{int(stats['overflow'])} -- raise "
                      f"--capacity-factor", file=sys.stderr)
            targets.append(np.asarray(img[..., :3]))

        n0 = args.init_count or max(8, n // 4)
        idx = rng.choice(n, size=min(n0, n), replace=False)
        start = {k: np.asarray(v)[idx] for k, v in target_params.items()}
        if args.init == "noise":
            start["colors"] = np.clip(
                start["colors"] + rng.normal(0, 40, start["colors"].shape),
                0, 255).astype(np.float32)
            start["opacities"] = np.full(len(idx), 0.5, np.float32)

    tc = TrainConfig(
        steps=args.steps, lambda_dssim=args.lambda_dssim,
        lr_means=1.6e-4 * args.lr_scale, lr_scales=5e-3 * args.lr_scale,
        lr_quats=1e-3 * args.lr_scale, lr_opacities=5e-2 * args.lr_scale,
        lr_colors=2.5e-1 * args.lr_scale,
        lr_means_final=(args.lr_means_final * args.lr_scale
                        if args.lr_means_final > 0 else None),
        lr_means_decay_steps=args.lr_decay_steps or None)

    dc = None
    if args.densify:
        capacity = args.capacity or 4 * start["means"].shape[0]
        dc = DensifyConfig(capacity=capacity,
                           grad_threshold=args.grad_threshold,
                           scene_extent=extent,
                           interval=args.densify_interval,
                           start_step=args.densify_start,
                           stop_step=int(args.steps * 0.8),
                           opacity_reset_interval=args.opacity_reset_interval)

    if args.mesh2d:
        import jax

        from openglgaussiansplattingrenderer_jax.parallel import mesh2d

        dv, ds = mesh2d_dims
        if dv * ds > len(jax.devices()):
            print(f"FATAL: --mesh2d {dv}x{ds} needs {dv * ds} devices, "
                  f"have {len(jax.devices())}", file=sys.stderr)
            sys.exit(1)
        out = mesh2d.fit_scene_2d(
            start, targets, cams, cfg, tc, mesh=mesh2d.make_mesh2d(dv, ds),
            width=args.width, height=args.height, dc=dc, seed=args.seed,
            save_every=args.save_every,
            checkpoint_path=args.ckpt or args.output + ".ckpt.npz",
            resume=args.resume or None,
            log_every=args.log_every)
        if dc is not None:
            fitted, alive, hist = out
            out_params = dn.compact_params(fitted, alive)
        else:
            fitted, hist = out
            out_params = {k: np.asarray(v) for k, v in fitted.items()}
        fitted_render = {k: jnp.asarray(v) for k, v in fitted.items()}
    elif args.data_parallel:
        import jax

        from openglgaussiansplattingrenderer_jax.parallel import (
            data_parallel as dp,
        )

        ndev = args.data_parallel
        if ndev > len(jax.devices()):
            print(f"FATAL: --data-parallel {ndev} > "
                  f"{len(jax.devices())} devices", file=sys.stderr)
            sys.exit(1)
        out = dp.fit_scene_dp(
            start, targets, cams, cfg, tc, mesh=dp.make_mesh(ndev),
            width=args.width, height=args.height, dc=dc, seed=args.seed,
            save_every=args.save_every,
            checkpoint_path=args.ckpt or args.output + ".ckpt.npz",
            resume=args.resume or None,
            log_every=args.log_every)
        if dc is not None:
            fitted, alive, hist = out
            out_params = dn.compact_params(fitted, alive)
        else:
            fitted, hist = out
            out_params = {k: np.asarray(v) for k, v in fitted.items()}
        fitted_render = {k: jnp.asarray(v) for k, v in fitted.items()}
    elif args.densify:
        fitted, alive, hist = fit_scene_adaptive(
            start, targets, cams, cfg, dc, tc=tc, seed=args.seed,
            log_every=args.log_every,
            save_every=args.save_every,
            checkpoint_path=args.ckpt or args.output + ".ckpt.npz",
            resume=args.resume or None)
        out_params = dn.compact_params(fitted, alive)
        fitted_render = {k: jnp.asarray(v) for k, v in fitted.items()}
    else:
        fitted, hist = fit_scene(start, targets, cams, cfg, tc,
                                 log_every=args.log_every,
                                 save_every=args.save_every,
                                 checkpoint_path=(args.ckpt
                                                  or args.output
                                                  + ".ckpt.npz"),
                                 resume=args.resume or None)
        out_params = {k: np.asarray(v) for k, v in fitted.items()}
        fitted_render = fitted

    ply_io.save_ply(args.output, out_params["means"], out_params["quats"],
                    out_params["scales"], out_params["opacities"],
                    out_params["colors"],
                    sh_rest=out_params.get("sh_rest"))
    print(f"wrote {args.output} ({out_params['means'].shape[0]} splats)",
          file=sys.stderr)

    if isinstance(cams[0], dict):
        from openglgaussiansplattingrenderer_jax.render import render_arrays

        b = cams[0]
        img, _ = render_arrays(
            fitted_render, jnp.asarray(b["view"]), jnp.asarray(b["vp"]),
            b["focal_x"], b["focal_y"], b["tan_fovx"], b["tan_fovy"],
            int(b["width"]), int(b["height"]), cfg)
    else:
        img, _ = render_stats(fitted_render, cams[0], cfg)
    fit0 = np.asarray(img[..., :3])
    psnr = float(losses.psnr(jnp.asarray(fit0), jnp.asarray(targets[0])))
    save_png(args.out_png, np.concatenate([targets[0], fit0], axis=1))
    with open(args.history, "w") as f:
        json.dump({"history": hist, "final_psnr_view0": psnr,
                   "splats": int(out_params["means"].shape[0])}, f, indent=1)
    print(f"view-0 PSNR {psnr:.2f} dB; wrote {args.out_png}, {args.history}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
