#!/usr/bin/env python
"""Render CLI -- the reference app (``main.cpp``) as a headless command.

Where the reference hard-codes its scene path, camera pose and resolution in
source ("currently needs recompiled to change the file", README.md:10-12),
everything here is a flag with the reference's value as the default.

Examples:
  python scripts/render_cli.py scene.ply -o out.png
  python scripts/render_cli.py scene.ply --orbit 24 --out-dir frames/
  python scripts/render_cli.py scene.ply --golden -o gold.png   # numpy oracle
"""

import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene", help="3DGS PLY file")
    ap.add_argument("-o", "--output", default="render.png")
    ap.add_argument("--width", type=int, default=1024)   # Camera.h:55
    ap.add_argument("--height", type=int, default=512)   # Camera.h:62
    ap.add_argument("--pos", type=float, nargs=3, default=[5.0, 0.5, -4.0],
                    help="camera position (reference pose, main.cpp:40)")
    ap.add_argument("--rot", type=float, nargs=3, default=[-20.0, 40.0, 0.0],
                    help="camera euler rotation deg (main.cpp:42-44)")
    ap.add_argument("--fovy", type=float, default=60.0)
    ap.add_argument("--tile-px", type=int, default=0,
                    help="tile pixel size (0 = reference 16x16 grid)")
    ap.add_argument("--capacity-factor", type=float, default=8.0)
    ap.add_argument("--autotune", action="store_true",
                    help="pin record capacity to the measured count for "
                         "the initial camera (render.autotune_capacity)")
    ap.add_argument("--depth-key", default="pair",
                    choices=["pair", "packed", "reference"],
                    help="record sort key: exact f32 pair (default), packed "
                         "u32 tile|22-bit depth (faster; >= reference "
                         "precision), or the reference's lossy float key")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--q16", action="store_true",
                    help="q16 inference precision: record-sort payloads "
                         "packed to 5 u32 lanes (~20%% faster at capture "
                         "scale; image error gated < 0.01 vs f32 in the "
                         "bench -- config.sort_payload docs). Implies "
                         "--depth-key packed")
    ap.add_argument("--no-pallas", action="store_true",
                    help="use the XLA oracle pipeline")
    ap.add_argument("--golden", action="store_true",
                    help="render with the numpy golden pipeline (cpuRender)")
    ap.add_argument("--antialiased", action="store_true",
                    help="opacity-compensated (anti-aliased) mode for scenes "
                         "trained with dilation compensation")
    ap.add_argument("--depth", action="store_true",
                    help="render an expected-depth map (normalized to [0,1] "
                         "over covered pixels) instead of RGB")
    ap.add_argument("--orbit", type=int, default=0,
                    help="render an N-frame orbit instead of one frame")
    ap.add_argument("--out-dir", default="frames")
    ap.add_argument("--orbit-radius", type=float, default=5.0)
    ap.add_argument("--stats", action="store_true", help="print frame stats")
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu", "gpu"],
                    help="force a JAX platform (default: JAX's own choice)")
    args = ap.parse_args()

    if args.platform != "auto":
        import jax

        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    from openglgaussiansplattingrenderer_jax import Camera, RenderConfig, Splats
    from openglgaussiansplattingrenderer_jax.render import camera_args
    from openglgaussiansplattingrenderer_jax.viewer import offline

    kw = dict(use_pallas=not args.no_pallas,
              dup_capacity_factor=args.capacity_factor, chunk=args.chunk,
              antialiased=args.antialiased, depth_key=args.depth_key)
    if args.q16:
        kw.update(sort_payload="q16", depth_key="packed")
    if args.tile_px > 0:
        cfg = RenderConfig.for_resolution(args.width, args.height,
                                          tile_px=args.tile_px, **kw)
    else:
        cfg = RenderConfig(**kw)

    splats = Splats(args.scene, args.width, args.height, cfg=cfg)
    print(f"loaded {splats.num_splats} splats from {args.scene}")

    cam = Camera(*args.pos, width=args.width, height=args.height,
                 fovy=args.fovy)
    cam.set_rotation(*args.rot)

    if args.autotune:
        splats.autotune_capacity(cam)
        cfg = splats.cfg
        print(f"autotuned capacity: {cfg.capacity_records} records")

    if args.orbit > 0:
        summary = offline.render_orbit(
            splats.scene, args.out_dir, radius=args.orbit_radius,
            num_frames=args.orbit, cfg=cfg, width=args.width,
            height=args.height)
        print("orbit:", summary)
        return

    if args.depth:
        from openglgaussiansplattingrenderer_jax.io.png import save_png

        depth, alpha = splats.render_depth_camera(cam)
        covered = alpha > 1e-3
        if covered.any():
            lo, hi = depth[covered].min(), depth[covered].max()
            depth = np.where(covered, (depth - lo) / max(hi - lo, 1e-12), 0.0)
        save_png(args.output, np.repeat(depth[..., None], 3, axis=-1)
                 .astype(np.float32))
    elif args.golden:
        a = camera_args(cam)
        img = splats.cpu_render(a["view"], args.width, args.height,
                                a["focal_x"], a["focal_y"], a["tan_fovx"],
                                a["tan_fovy"], a["vp"], save_path=args.output)
    else:
        img = splats.render_camera(cam)
        splats.display(args.output)
    print(f"wrote {args.output}")
    if args.stats and splats.last_stats:
        for k, v in sorted(splats.last_stats.items()):
            print(f"  {k}: {np.asarray(v).tolist()}")


if __name__ == "__main__":
    main()
