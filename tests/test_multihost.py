"""Two-process multi-host smoke test (CPU backend, localhost coordinator).

Meshes that span hosts need a process-spanning mesh; this test validates
the complete multi-process code path on one machine: ``jax.distributed.initialize`` over localhost, a global mesh
spanning 2 processes x 2 virtual devices, host-local scene loading, and the
sharded fast-path render producing the same image as a single process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # append, not replace: keep whatever else the environment put there
    env["PYTHONPATH"] = repo + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(rank), str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=780)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    assert (tmp_path / "ok0").exists() and (tmp_path / "ok1").exists()

    img_mh = np.load(tmp_path / "mh_img.npy")

    # single-process reference
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax.camera import Camera
    from openglgaussiansplattingrenderer_jax.config import RenderConfig
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.ops.fastpath import render_fast
    from openglgaussiansplattingrenderer_jax.render import camera_args

    cfg = RenderConfig(chunk=32, dup_capacity_factor=16.0)
    scene = ply_io.make_synthetic_scene(64, seed=11, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=64, height=64)
    args = camera_args(cam)
    img_1, _ = render_fast(
        params, jnp.asarray(args["view"]), jnp.asarray(args["vp"]),
        args["focal_x"], args["focal_y"], args["tan_fovx"], args["tan_fovy"],
        64, 64, cfg)
    np.testing.assert_allclose(img_mh, np.asarray(img_1), atol=1e-5)

    # the workers also ran one 2-D (view x splat) TRAIN step with view
    # rows on DIFFERENT PROCESSES; its loss must match a single-process
    # 2x2 mesh2d step on identical data
    loss_mh = float(np.load(tmp_path / "mh_loss2d.npy"))
    from openglgaussiansplattingrenderer_jax.parallel import mesh2d
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        TrainConfig, raw_from_params,
    )

    m2 = mesh2d.make_mesh2d(2, 2)
    raw = raw_from_params(params)
    raw2 = mesh2d.shard_raw_2d(raw, m2)
    step2 = mesh2d.make_2d_train_step(
        cfg, TrainConfig(lambda_dssim=0.0), 64, 64, m2, batch=2,
        param_keys=tuple(sorted(raw.keys())))
    opt2 = step2.init(raw2)
    rng = np.random.default_rng(5)
    tgt = jnp.asarray(np.stack([
        mesh2d.tile_target(rng.uniform(0, 1, (64, 64, 3))
                           .astype(np.float32), 64, 64, cfg)[0]
        for _ in range(2)]))
    cam2 = Camera(0.3, 0.1, -4.2, width=64, height=64)
    a2 = camera_args(cam2)
    vvp = (args, a2)
    view2 = jnp.stack([jnp.asarray(b["view"], jnp.float32) for b in vvp])
    vp2 = jnp.stack([jnp.asarray(b["vp"], jnp.float32) for b in vvp])
    sc2 = [jnp.asarray([np.float32(b[k]) for b in vvp])
           for k in ("focal_x", "focal_y", "tan_fovx", "tan_fovy")]
    _, _, loss_1, _, over_1 = step2(raw2, opt2, tgt, view2, vp2, *sc2)
    assert int(over_1) == 0
    np.testing.assert_allclose(loss_mh, float(loss_1), rtol=1e-6, atol=1e-8)

    # ---- ADC + checkpoint/resume across processes (r5 stretch) ---------
    # The workers also ran: with_grad_norms step -> global densify_and_prune
    # on the process-spanning sharded state -> checkpoint gathered to npz ->
    # resume re-placed -> one more step. Replay the identical sequence on
    # the single-process 2x2 mesh; the alive mask must match exactly and
    # the post-resume loss to float tolerance.
    import jax

    from openglgaussiansplattingrenderer_jax.train import densify as dn
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        load_checkpoint_full,
        restore_opt_state,
        save_checkpoint,
    )

    loss_mh_adc = float(np.load(tmp_path / "mh_adc_loss.npy"))
    alive_mh = np.load(tmp_path / "mh_adc_alive.npy")

    cap = 64
    dc = dn.DensifyConfig(capacity=cap, grad_threshold=1e-9,
                          scene_extent=1.5, start_step=0, interval=1)
    tc = TrainConfig(lambda_dssim=0.0)
    stepd = mesh2d.make_2d_train_step(
        cfg, tc, 64, 64, m2, batch=2,
        param_keys=tuple(sorted(raw.keys())), with_grad_norms=True)
    rawd = mesh2d.shard_raw_2d(raw, m2)
    optd = stepd.init(rawd)
    rawd, optd, _, _, ovd, gnorm, seen = stepd(rawd, optd, tgt, view2, vp2,
                                               *sc2)
    assert int(ovd) == 0
    alive = jnp.ones((cap,), bool)
    ga, sc_cnt = dn.accumulate_grad_stats_batched(
        jnp.zeros((cap,)), jnp.zeros((cap,)), gnorm, seen, alive)
    rawd, alive, changed, _ = dn.densify_and_prune(
        rawd, alive, ga, sc_cnt, jax.random.PRNGKey(0), dc)
    optd = dn.reset_rows(optd, changed)
    np.testing.assert_array_equal(alive_mh, np.asarray(alive),
                                  err_msg="multihost ADC alive mask "
                                  "diverged from single-process")

    ck = str(tmp_path / "sp_adc.ckpt.npz")
    save_checkpoint(ck, {k: np.asarray(v) for k, v in rawd.items()},
                    step=1, opt_state=optd, alive=np.asarray(alive))
    r_raw, _, extras = load_checkpoint_full(ck)
    raw_r = mesh2d.shard_raw_2d(
        {k: jnp.asarray(v) for k, v in r_raw.items()}, m2)
    opt_r = restore_opt_state(stepd.init(raw_r), extras["opt_leaves"])
    _, _, loss_f, _, ov2, _, _ = stepd(raw_r, opt_r, tgt, view2, vp2, *sc2)
    assert int(ov2) == 0
    np.testing.assert_allclose(loss_mh_adc, float(loss_f), rtol=1e-6,
                               atol=1e-8,
                               err_msg="multihost ADC+resume loss diverged")
