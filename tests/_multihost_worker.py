"""Worker process for the 2-process multi-host smoke test.

Launched by ``tests/test_multihost.py`` as ``python _multihost_worker.py
<rank> <port> <outdir>``. Each process owns 2 virtual CPU devices; the two
processes coordinate over localhost, form a 4-device global mesh, and render
the same scene with host-local parameter shards. Rank 0 writes the image.
"""

import os
import sys


def main() -> None:
    rank, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from openglgaussiansplattingrenderer_jax.parallel import multihost

    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank)
    assert multihost.process_count() == 2
    assert len(jax.devices()) == 4, jax.devices()

    import functools

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from openglgaussiansplattingrenderer_jax.camera import Camera
    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.parallel import fast_sharded
    from openglgaussiansplattingrenderer_jax.render import camera_args

    cfg = RenderConfig(chunk=32, dup_capacity_factor=16.0)
    width = height = 64
    scene = ply_io.make_synthetic_scene(64, seed=11, extent=1.5)
    scene = {k: np.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    # each host loads only its own half of the (mesh-divisible) scene
    n = scene["means"].shape[0]
    lo, hi = rank * n // 2, (rank + 1) * n // 2
    local = {k: v[lo:hi] for k, v in scene.items()}

    mesh = multihost.global_mesh()
    params = multihost.host_local_params(local, mesh)
    cam = Camera(0.0, 0.0, -4.0, width=width, height=height)
    args = camera_args(cam)

    def f(params, view, vp, fx, fy, tfx, tfy):
        img, stats = fast_sharded.render_fast_sharded(
            params, view, vp, fx, fy, tfx, tfy, width, height, cfg, mesh)
        return img, stats["overflow"]

    fj = jax.jit(f, out_shardings=(NamedSharding(mesh, P()),
                                   NamedSharding(mesh, P())))
    img, overflow = fj(
        params, jnp.asarray(args["view"]), jnp.asarray(args["vp"]),
        jnp.float32(args["focal_x"]), jnp.float32(args["focal_y"]),
        jnp.float32(args["tan_fovx"]), jnp.float32(args["tan_fovy"]))
    img = np.asarray(img)
    assert np.all(np.isfinite(img))

    # ---- one 2-D (view x splat) TRAIN step across the process boundary --
    # view rows = processes, splat shards = each process's local devices;
    # the record-exchange all-to-all stays inside a process row, the
    # view-axis grad psum crosses hosts. The test compares this loss to a
    # single-process 2x2 mesh2d step on the same data.
    from jax.sharding import Mesh

    from openglgaussiansplattingrenderer_jax.parallel import mesh2d
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        TrainConfig,
        raw_from_params,
    )

    m2 = Mesh(np.array(jax.devices()).reshape(2, 2),
              (mesh2d.VIEW_AXIS, mesh2d.SPLAT_AXIS))
    full = {k: np.asarray(v) for k, v in scene.items()}
    raw_np = {k: np.asarray(v) for k, v in raw_from_params(full).items()}

    def put(x, spec):
        sh = NamedSharding(m2, spec)
        return jax.make_array_from_process_local_data(sh, np.asarray(x),
                                                      np.shape(x))

    raw2 = {k: put(v, P(mesh2d.SPLAT_AXIS)) for k, v in raw_np.items()}
    tc = TrainConfig(lambda_dssim=0.0)
    step2 = mesh2d.make_2d_train_step(cfg, tc, width, height, m2, batch=2,
                                      param_keys=tuple(sorted(raw2.keys())))
    opt2 = step2.init(raw2)
    rng = np.random.default_rng(5)
    tgt_np = np.stack([
        mesh2d.tile_target(rng.uniform(0, 1, (height, width, 3))
                           .astype(np.float32), width, height, cfg)[0]
        for _ in range(2)])
    cam2 = Camera(0.3, 0.1, -4.2, width=width, height=height)
    a2 = camera_args(cam2)
    vvp = [(args, a2)[j] for j in range(2)]
    tgt = put(tgt_np, P(mesh2d.VIEW_AXIS))
    view2 = put(np.stack([np.asarray(b["view"], np.float32) for b in vvp]),
                P(mesh2d.VIEW_AXIS))
    vp2 = put(np.stack([np.asarray(b["vp"], np.float32) for b in vvp]),
              P(mesh2d.VIEW_AXIS))
    sc2 = [put(np.stack([np.float32(b[k]) for b in vvp]),
               P(mesh2d.VIEW_AXIS))
           for k in ("focal_x", "focal_y", "tan_fovx", "tan_fovy")]
    raw2, opt2, loss2, psnr2, over2 = step2(raw2, opt2, tgt, view2, vp2,
                                            *sc2)
    loss2 = float(np.asarray(loss2))
    assert np.isfinite(loss2) and int(np.asarray(over2)) == 0

    # ---- ADC + checkpoint/resume ACROSS the process boundary ------------
    # (VERDICT r4 next #10): a with_grad_norms 2-D step -> global
    # densify_and_prune on the process-spanning sharded state (GSPMD) ->
    # checkpoint gathered to one host npz -> resume re-placed -> one more
    # step. The test replays the identical sequence on a single-process
    # 2x2 mesh and compares the final loss + alive mask.
    from jax.experimental import multihost_utils

    from openglgaussiansplattingrenderer_jax.train import densify as dn
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        load_checkpoint_full,
        save_checkpoint,
    )

    cap = raw_np["means"].shape[0]
    dc = dn.DensifyConfig(capacity=cap, grad_threshold=1e-9,
                          scene_extent=1.5, start_step=0, interval=1)
    stepd = mesh2d.make_2d_train_step(
        cfg, tc, width, height, m2, batch=2,
        param_keys=tuple(sorted(raw_np.keys())), with_grad_norms=True)
    rawd = {k: put(v, P(mesh2d.SPLAT_AXIS)) for k, v in raw_np.items()}
    optd = stepd.init(rawd)
    tgtd = put(tgt_np, P(mesh2d.VIEW_AXIS))
    rawd, optd, lossd, _, overd, gnorm, seen = stepd(
        rawd, optd, tgtd, view2, vp2, *sc2)
    assert int(np.asarray(overd)) == 0

    rep = NamedSharding(m2, P())
    alive = jax.jit(lambda: jnp.ones((cap,), bool),
                    out_shardings=rep)()
    zeros = jax.jit(lambda: jnp.zeros((cap,), jnp.float32),
                    out_shardings=rep)()
    ga, sc_cnt = jax.jit(dn.accumulate_grad_stats_batched)(
        zeros, zeros, gnorm, seen, alive)
    rawd, alive, changed, dstats = dn.densify_and_prune(
        rawd, alive, ga, sc_cnt, jax.random.PRNGKey(0), dc)
    optd = jax.jit(dn.reset_rows)(optd, changed)

    # checkpoint: gather the process-spanning state to host, rank 0 saves
    raw_host = multihost_utils.process_allgather(rawd, tiled=True)
    opt_host = multihost_utils.process_allgather(optd, tiled=True)
    alive_host = np.asarray(
        multihost_utils.process_allgather(alive, tiled=True))
    ckpt = os.path.join(outdir, "mh_adc.ckpt.npz")
    if rank == 0:
        save_checkpoint(ckpt, {k: np.asarray(v) for k, v in
                               raw_host.items()},
                        step=1, opt_state=opt_host, alive=alive_host)
    multihost_utils.sync_global_devices("mh_adc_ckpt_saved")

    # resume: every process loads the npz and re-places it on the
    # process-spanning mesh (capacity-leading leaves P(splat), rest
    # replicated), then runs one more step
    r_raw, r_step, extras = load_checkpoint_full(ckpt)
    assert r_step == 1 and "alive" in extras
    raw_r = {k: put(np.asarray(v), P(mesh2d.SPLAT_AXIS))
             for k, v in r_raw.items()}
    opt_template = stepd.init(raw_r)
    t_leaves = jax.tree_util.tree_leaves(opt_template)
    treedef = jax.tree_util.tree_structure(opt_template)
    leaves = []
    for v, t in zip(extras["opt_leaves"], t_leaves):
        v = np.asarray(v).astype(t.dtype)
        if v.ndim >= 1 and v.shape[0] == cap:
            leaves.append(put(v, P(mesh2d.SPLAT_AXIS)))
        else:
            leaves.append(put(v, P()))
    opt_r = jax.tree_util.tree_unflatten(treedef, leaves)
    raw_f, opt_f, loss_f, _, over_f, _, _ = stepd(
        raw_r, opt_r, tgtd, view2, vp2, *sc2)
    loss_f = float(np.asarray(loss_f))
    assert np.isfinite(loss_f) and int(np.asarray(over_f)) == 0

    if rank == 0:
        np.save(os.path.join(outdir, "mh_adc_loss.npy"),
                np.asarray(loss_f, np.float64))
        np.save(os.path.join(outdir, "mh_adc_alive.npy"), alive_host)

    if rank == 0:
        np.save(os.path.join(outdir, "mh_img.npy"), img)
        np.save(os.path.join(outdir, "mh_loss2d.npy"),
                np.asarray(loss2, np.float64))
        with open(os.path.join(outdir, f"ok{rank}"), "w") as fh:
            fh.write(f"overflow={int(overflow)}\n")
    else:
        with open(os.path.join(outdir, f"ok{rank}"), "w") as fh:
            fh.write("ok\n")
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
