"""Smoke run of the render and training path on one GPU.

    python chip_smoke.py               # one card: phases (a)-(e)
    python chip_smoke.py --multi-gpu   # four cards: the sharded phase only

Phases on one card, each fatal on failure:

  (a) device: a GPU, its name and power limit;
  (b) compositor parity: the compiled Triton compositor against the jnp
      compositor on the uniform flagship frame (3,616,103 splats,
      1024x512), and the full pipeline's gradients against autodiff
      through the jnp pipeline on the 10k-splat gate scene;
  (c) forward at full width: both flagship scenes through ``render_arrays``
      with autotuned capacity, the q16 inference mode against f32, and the
      ``Splats`` facade on a PLY written from a seeded scene;
  (d) training: a few optimizer steps on 1M splats at 1920x1080;
  (e) compiled memory of the forward and of the training step, and the
      device's peak memory.

With ``--multi-gpu`` (four cards): the splat-sharded render at 1M splats,
one data-parallel step and one 2x2 (view x splat) mesh step, each against
its single-card counterpart.

The last line of standard output is one JSON object; it is printed only
when every phase passed. The phases take their sizes as an argument, so the
test suite drives them on the CPU at a tiny size (``tests/test_chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

# Parity limits, in image units (colours in [0, 1]). The two compositors
# evaluate the same expressions, but the card rounds exp/log1p/cumsum in
# another order than XLA's fusions: a pixel whose transmittance lands within
# ulps of the 0.99 saturation threshold can include or drop the records
# behind it (QUIRKS.md), moving that pixel by one record's contribution.
# The limits keep the envelope the earlier device gate allowed (5e-3, and
# 10 pixels of a 512x512 frame); the card's measured parity is far inside
# it (PERF.md).
FWD_MAX_ABS = 5e-3           # largest single-pixel flip
FWD_BAD_FRACTION = 4e-5      # share of pixels off by more than 1e-3
GRAD_REL_L2 = 2e-3           # ||g - g_ref|| / ||g_ref|| per parameter
Q16_MAX_ABS = 1e-2           # the reference's CPU-vs-GPU tolerance
SHARD_MAX_ABS = 5e-3         # multi-card render vs one card
STEP_REL_L2 = 1e-2           # multi-card update vs one card


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, iters):
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1000.0, out


def rel_l2(a, b):
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def image_diff(a, b):
    """(max abs, share of pixels off by more than 1e-3) of two images."""
    import numpy as np

    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float((d.max(axis=-1) > 1e-3).mean())


@dataclasses.dataclass(frozen=True)
class Sizes:
    flag_n: int
    flag_w: int
    flag_h: int
    gate_n: int
    gate_wh: int
    train_n: int
    train_w: int
    train_h: int
    shard_n: int
    iters: int


FULL = Sizes(3_616_103, 1024, 512, 10_000, 512, 1_000_000, 1920, 1080,
             1_000_000, 5)


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_parity(sz, card):
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.ops import fastpath
    from openglgaussiansplattingrenderer_jax.ops.compositing import (
        assemble_image, composite_tiles_jnp)
    from openglgaussiansplattingrenderer_jax.ops.pallas import composite as pc
    from openglgaussiansplattingrenderer_jax.render import (
        autotune_capacity, render_arrays)

    # (b1) Triton vs jnp compositor on the uniform flagship frame
    w, h = sz.flag_w, sz.flag_h
    cam = scenes.camera_tuple(scenes.camera(w, h))
    params = scenes.to_params(scenes.flagship_scene("uniform", sz.flag_n))
    cfg = autotune_capacity(params, *cam, w, h,
                            scenes.config(w, h, depth_key="packed"))
    sf2, bounds, info = jax.jit(functools.partial(
        fastpath.sort_records, width=w, height=h, cfg=cfg))(params, *cam)
    check(int(info["total_all"]) <= cfg.capacity(sz.flag_n), "flagship overflow")
    max_bin = int(jnp.max(bounds[1:] - bounds[:-1]))
    cfg_j = dataclasses.replace(
        cfg, max_per_tile=-(-max_bin // cfg.chunk) * cfg.chunk)
    tiles = jnp.arange(cfg.num_tiles, dtype=jnp.int32)

    def img(tiled):
        return assemble_image(tiled[:, :, 0:3], tiled[:, :, 3], w, h, cfg)

    t_ms, tri = timed(jax.jit(lambda: img(pc.composite_tiles(
        sf2, bounds, tiles, w, h, cfg))), sz.iters)
    with jax.default_matmul_precision("highest"):
        j_ms, ref = timed(jax.jit(lambda: img(composite_tiles_jnp(
            sf2, bounds, w, h, cfg_j))), 1)
    mx, bad = image_diff(tri, ref)
    log(f"(b) flagship uniform compositor: records {int(bounds[-1])}, "
        f"max_bin {max_bin}; Triton {t_ms:.3f} ms, jnp {j_ms:.3f} ms "
        f"({card})")
    log(f"(b) flagship forward parity: max abs {mx:.3e} (limit "
        f"{FWD_MAX_ABS:.0e}), px > 1e-3 {bad:.3e} (limit "
        f"{FWD_BAD_FRACTION:.0e})")
    check(mx <= FWD_MAX_ABS and bad <= FWD_BAD_FRACTION,
          "Triton forward diverges from the jnp compositor")

    # (b2) full-pipeline gradients on the gate scene vs jnp autodiff
    g = sz.gate_wh
    gcam = scenes.camera_tuple(scenes.camera(g, g, z=-6.0))
    gparams = scenes.to_params(scenes.gate_scene(sz.gate_n))
    gcfg = scenes.config(g, g, dup_capacity_factor=8.0, max_per_tile=2048)
    target = jnp.full((g, g, 3), 0.25, jnp.float32)

    def loss_stats(cfg_):
        def loss(p):
            im, st = render_arrays(p, *gcam, g, g, cfg_)
            return jnp.mean((im[..., :3] - target) ** 2), (im, st)
        return jax.jit(jax.value_and_grad(loss, has_aux=True))

    (l_t, (im_t, st_t)), gr_t = loss_stats(gcfg)(gparams)
    with jax.default_matmul_precision("highest"):
        (l_j, (im_j, st_j)), gr_j = loss_stats(
            dataclasses.replace(gcfg, use_pallas=False))(gparams)
    check(int(st_j["dropped_by_cap"]) == 0 and int(st_t["overflow"]) == 0,
          "gate scene exceeds a capacity")
    mx, bad = image_diff(im_t, im_j)
    log(f"(b) gate forward parity: max abs {mx:.3e} (limit "
        f"{FWD_MAX_ABS:.0e}), px > 1e-3 {bad:.3e} (limit "
        f"{FWD_BAD_FRACTION:.0e})")
    check(mx <= FWD_MAX_ABS and bad <= FWD_BAD_FRACTION,
          "gate forward diverges")
    rels = {k: rel_l2(gr_t[k], gr_j[k]) for k in gr_j}
    log(f"(b) gate gradient parity (||g - g_ref|| / ||g_ref||, limit "
        f"{GRAD_REL_L2:.0e}): " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in rels.items())
        + f"; loss {float(l_t):.6e} vs {float(l_j):.6e}")
    check(max(rels.values()) <= GRAD_REL_L2, "gradients diverge")


def phase_forward(sz, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from openglgaussiansplattingrenderer_jax import Splats, scenes
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.render import (
        autotune_capacity, render_arrays)

    w, h = sz.flag_w, sz.flag_h
    cam = scenes.camera_tuple(scenes.camera(w, h))
    cfg0 = scenes.config(w, h, depth_key="packed")
    mem = None
    for kind in ("uniform", "clustered"):
        params = scenes.to_params(scenes.flagship_scene(kind, sz.flag_n))
        cfg = autotune_capacity(params, *cam, w, h, cfg0)
        fwd = jax.jit(functools.partial(render_arrays, width=w, height=h,
                                        cfg=cfg))
        if mem is None:
            mem = fwd.lower(params, *cam).compile().memory_analysis()
        ms, (im, st) = timed(lambda: fwd(params, *cam), sz.iters)
        check(int(st["overflow"]) == 0, f"flagship {kind} overflow")
        check(bool(jnp.all(jnp.isfinite(im))), f"flagship {kind} not finite")
        log(f"(c) flagship {kind}: {ms:.3f} ms/frame, records "
            f"{int(st['num_records'])}, max_bin {int(st['max_bin'])}, "
            f"overflow 0 ({card})")
        qfwd = jax.jit(functools.partial(
            render_arrays, width=w, height=h,
            cfg=dataclasses.replace(cfg, sort_payload="q16")))
        qms, (qim, qst) = timed(lambda: qfwd(params, *cam), sz.iters)
        err = float(jnp.max(jnp.abs(qim[..., :3] - im[..., :3])))
        log(f"(c) flagship {kind} q16: {qms:.3f} ms/frame, image error vs "
            f"f32 {err:.3e} (limit {Q16_MAX_ABS:.0e}) ({card})")
        check(int(qst["overflow"]) == 0 and err < Q16_MAX_ABS,
              f"q16 {kind} error {err}")
    log(f"(e) flagship forward compiled memory: {mem}")

    # the Splats facade on a PLY written from a seeded scene
    g = sz.gate_wh
    s = scenes.gate_scene(sz.gate_n)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene.ply")
        ply_io.save_ply(path, s["means"], s["quats"], s["scales"],
                        s["opacities"], s["colors"])
        splats = Splats(path, g, g, cfg=scenes.config(g, g,
                                                      dup_capacity_factor=8.0))
        im = np.asarray(splats.render_camera(scenes.camera(g, g, z=-6.0)))
    check(np.isfinite(im).all() and im[..., 3].max() > 0.1,
          "facade render empty or not finite")
    check(int(splats.last_stats["overflow"]) == 0, "facade overflow")
    log(f"(c) Splats facade: {splats.num_splats} splats from PLY, "
        f"{g}x{g}, alpha max {im[..., 3].max():.3f}")


def phase_train(sz, card):
    import jax
    import jax.numpy as jnp

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.render import (
        autotune_capacity, render_arrays)
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        TrainConfig, make_train_step, raw_from_params)

    w, h = sz.train_w, sz.train_h
    cam = scenes.camera_tuple(scenes.camera(w, h))
    params = scenes.to_params(scenes.train_scene(sz.train_n))
    cfg = autotune_capacity(params, *cam, w, h, scenes.config(w, h))
    target, _ = jax.jit(functools.partial(
        render_arrays, width=w, height=h, cfg=cfg))(params, *cam)
    target = target[..., :3]
    # train a perturbed copy back towards the scene's own render
    start = dict(params, colors=params["colors"] * 0.8)
    run = make_train_step(cfg, TrainConfig(), w, h)
    state = run.init(raw_from_params(start))
    mem = run.step.lower(state.raw, state.opt_state, target, *cam
                         ).compile().memory_analysis()
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        state, m = run(state, target, *cam)
        loss = float(m["loss"])          # waits for the step
        dt = (time.perf_counter() - t0) * 1000.0
        check(jnp.isfinite(loss), f"training loss not finite at step {i}")
        for k, v in state.raw.items():
            check(bool(jnp.all(jnp.isfinite(v))),
                  f"non-finite update of {k} at step {i}")
        losses.append(loss)
        log(f"(d) train step {i}: loss {loss:.6f}, {dt:.3f} ms "
            f"({'compile+run' if i == 0 else 'run'}; {card})")
    log(f"(d) {sz.train_n} splats at {w}x{h}: losses {losses}")
    log(f"(e) train step compiled memory: {mem}")


def single_card(sz, card):
    phase_parity(sz, card)
    phase_forward(sz, card)
    phase_train(sz, card)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def multi_card(sz, card, ndev=4):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from openglgaussiansplattingrenderer_jax import scenes
    from openglgaussiansplattingrenderer_jax.camera import Camera
    from openglgaussiansplattingrenderer_jax.parallel import (
        data_parallel as dp, fast_sharded, mesh2d, sharded)
    from openglgaussiansplattingrenderer_jax.render import (
        autotune_capacity, render_arrays)
    from openglgaussiansplattingrenderer_jax.train import losses
    from openglgaussiansplattingrenderer_jax.train.trainer import (
        TrainConfig, camera_bundles, make_optimizer, params_from_raw,
        raw_from_params)

    check(len(jax.devices()) >= ndev, f"needs {ndev} devices")
    devs = jax.devices()[:ndev]
    w, h = sz.flag_w, sz.flag_h
    cam = scenes.camera_tuple(scenes.camera(w, h))
    params = sharded.pad_scene_for_mesh(
        scenes.to_params(scenes.flagship_scene("uniform", sz.shard_n)), ndev)
    n = params["means"].shape[0]
    cams = [Camera(0.3 * i - 0.45, 0.1, -8.0 - 0.2 * i, width=w, height=h)
            for i in range(ndev)]
    bundles = camera_bundles(cams)
    # one capacity that holds every view's records: no view drops any
    cfg0 = scenes.config(w, h)
    cfg = scenes.with_capacity(cfg0, max(
        autotune_capacity(params, *c, w, h, cfg0).capacity_records
        for c in [cam] + bundles))

    # the splat-sharded render vs one card
    mesh = sharded.make_mesh(ndev)
    check(len(set(mesh.devices.flat)) == ndev, "mesh repeats a device")
    p_sh = sharded.shard_params(params, mesh)
    check(all(len(v.sharding.device_set) == ndev for v in p_sh.values()),
          "splats not spread over every card")
    render_sh = jax.jit(functools.partial(
        fast_sharded.render_fast_sharded, width=w, height=h, cfg=cfg,
        mesh=mesh, exch_factor=float(ndev)))
    ms_sh, (im_sh, st_sh) = timed(lambda: render_sh(p_sh, *cam), sz.iters)
    check(int(st_sh["overflow"]) == 0, "sharded render dropped records")
    p_one = jax.device_put(params, devs[0])
    render_one = jax.jit(functools.partial(render_arrays, width=w, height=h,
                                           cfg=cfg))
    ms_one, (im_one, _) = timed(lambda: render_one(p_one, *cam), sz.iters)
    mx, bad = image_diff(im_sh, im_one)
    log(f"sharded render, {n} splats {w}x{h} on {ndev} cards: {ms_sh:.3f} "
        f"ms vs one card {ms_one:.3f} ms ({card}); max abs {mx:.3e} "
        f"(limit {SHARD_MAX_ABS:.0e}), px > 1e-3 {bad:.3e}")
    check(mx <= SHARD_MAX_ABS and bad <= FWD_BAD_FRACTION,
          "sharded render differs from one card")

    # one data-parallel step and one 2x2 mesh step vs one card
    tc = TrainConfig()
    raw = raw_from_params(params)
    keys = tuple(sorted(raw.keys()))
    targets = [np.asarray(render_one(p_one, *b)[0][..., :3]) * 0.9
               for b in bundles]

    def reference(batch, cfg_):
        def loss_of(raw, t, b):
            im, _ = render_arrays(params_from_raw(raw), *b, w, h, cfg_)
            return losses.gs_loss(im[..., :3], t, tc.lambda_dssim)

        vg = jax.jit(jax.value_and_grad(loss_of))
        raw1 = jax.device_put(raw, devs[0])
        grads, ls = None, []
        for t, b in zip(targets[:batch], bundles[:batch]):
            l, gr = vg(raw1, jnp.asarray(t), b)
            ls.append(float(l))
            grads = gr if grads is None else jax.tree.map(jnp.add, grads, gr)
        grads = jax.tree.map(lambda x: x / batch, grads)
        opt = make_optimizer(tc, keys=keys)
        upd, _ = opt.update(grads, opt.init(raw1), raw1)
        return optax.apply_updates(raw1, upd), float(np.mean(ls))

    def compare(name, got, loss, batch, cfg_):
        want, loss_ref = reference(batch, cfg_)
        rels = {k: rel_l2(np.asarray(got[k]) - np.asarray(raw[k]),
                          np.asarray(want[k]) - np.asarray(raw[k]))
                for k in keys}
        log(f"{name}: loss {loss:.6e} vs one card {loss_ref:.6e}; update "
            f"||d - d_ref|| / ||d_ref|| (limit {STEP_REL_L2:.0e}): "
            + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
        check(abs(loss - loss_ref) <= 1e-4 * abs(loss_ref) + 1e-7,
              f"{name} loss differs")
        check(max(rels.values()) <= STEP_REL_L2, f"{name} update differs")

    dstep = dp.make_dp_train_step(cfg, tc, w, h, mesh, batch=ndev,
                                  param_keys=keys)
    raw_rep = dp.replicate_tree(raw, mesh)
    t0 = time.perf_counter()
    raw_dp, _, loss_dp, _ = dstep(raw_rep, dstep.init(raw_rep),
                                  *dp.stack_view_batch(targets, bundles))
    loss_dp = float(loss_dp)
    log(f"data-parallel step ({ndev} views, {ndev} cards): compile+run "
        f"{(time.perf_counter() - t0) * 1000.0:.3f} ms ({card})")
    compare("data-parallel step", raw_dp, loss_dp, ndev, cfg)

    dv, ds = 2, ndev // 2
    m2 = mesh2d.make_mesh2d(dv, ds)
    check(len(set(m2.devices.flat)) == ndev, "2-D mesh repeats a device")
    step2 = mesh2d.make_2d_train_step(cfg, tc, w, h, m2, batch=dv,
                                      param_keys=keys)
    raw2 = mesh2d.shard_raw_2d(raw, m2)
    tgt = jnp.stack([jnp.asarray(mesh2d.tile_target(t, w, h, cfg)[0])
                     for t in targets[:dv]])
    view = jnp.stack([b[0] for b in bundles[:dv]])
    vp = jnp.stack([b[1] for b in bundles[:dv]])
    sc = [jnp.stack([jnp.asarray(b[i], jnp.float32) for b in bundles[:dv]])
          for i in (2, 3, 4, 5)]
    t0 = time.perf_counter()
    raw_2d, _, loss_2d, _, over = step2(raw2, step2.init(raw2), tgt, view,
                                        vp, *sc)
    loss_2d = float(loss_2d)
    log(f"2x2 mesh step ({dv} views): compile+run "
        f"{(time.perf_counter() - t0) * 1000.0:.3f} ms ({card})")
    check(int(over) == 0, "2x2 mesh step dropped records")
    compare("2x2 mesh step", raw_2d, loss_2d, dv, cfg)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()
    ndev = 4 if args.multi_gpu else 1

    import jax

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"no GPU: JAX found {dev.platform}")
    check(len(jax.devices()) >= ndev, f"needs {ndev} GPUs")
    card = card_line()
    log(f"(a) device {dev.platform} {dev.device_kind} x{len(jax.devices())}, "
        f"jax {jax.__version__}")
    log(f"(a) card: {card}")

    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache

    enable_compile_cache()
    if args.multi_gpu:
        multi_card(FULL, card, ndev)
        used = [d.memory_stats()["peak_bytes_in_use"]
                for d in jax.devices()[:ndev]]
        log(f"peak bytes in use per card: {used}")
        check(min(used) > 0.25 * max(used), "work not spread over the cards")
    else:
        single_card(FULL, card)
        log(f"(e) peak_bytes_in_use "
            f"{dev.memory_stats()['peak_bytes_in_use']}")
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
