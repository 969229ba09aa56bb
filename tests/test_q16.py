"""The q16 inference precision mode: 9 record fields packed to 5 u32 sort
lanes (ops/records.sort_records_q16, cfg.sort_payload="q16").

Gate: the reference's own CPU-vs-GPU assertions run at an absolute
tolerance of 0.01 (reference src/Splats.cpp:783-843) -- it never
demanded bit-exactness of its two pipelines. The q16 image must stay well
inside that bound against the exact f32 path; the f32 path and the bench
oracle gate stay untouched.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops.fastpath import render_fast
from openglgaussiansplattingrenderer_jax.ops import records as rk
from openglgaussiansplattingrenderer_jax.render import camera_args

W = H = 64
CFG_F32 = RenderConfig(chunk=32, dup_capacity_factor=8.0,
                       depth_key="packed")
CFG_Q16 = dataclasses.replace(CFG_F32, sort_payload="q16")


def test_pack_unpack_error_bounds():
    rng = np.random.default_rng(0)
    n = 4096
    wp = hp = 1024
    mx = jnp.asarray(rng.uniform(-wp, 2 * wp, n).astype(np.float32))
    my = jnp.asarray(rng.uniform(-hp, 2 * hp, n).astype(np.float32))
    conic = [jnp.asarray(
        (rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(-4, 0.5, n))
        .astype(np.float32)) for _ in range(3)]
    op = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    col = [jnp.asarray(rng.uniform(0, 255, n).astype(np.float32))
           for _ in range(3)]
    fields = (mx, my, *conic, op, *col)
    out = rk._q16_unpack(rk._q16_pack(fields, wp, hp), wp, hp)
    # positions: 24-bit fixed over a 3*wp range (the f32 scale arithmetic
    # itself costs up to ~2 extra LSB at the top of the range, hence 3x)
    step = 3.0 * wp / (2 ** 24 - 1)
    assert float(jnp.max(jnp.abs(out[0] - mx))) <= 3 * step
    assert float(jnp.max(jnp.abs(out[1] - my))) <= 3 * step
    # conics/colours: f16 relative (2^-11 rounding)
    for i in (2, 3, 4, 6, 7, 8):
        rel = jnp.abs(out[i] - fields[i]) / jnp.maximum(
            jnp.abs(fields[i]), 1e-4)
        assert float(jnp.max(rel)) <= 2 ** -10
    # opacity: 16-bit fixed over [0, 1]
    assert float(jnp.max(jnp.abs(out[5] - op))) <= 1.0 / 65535.0


def test_q16_sort_orders_like_f32():
    """The packed sort must produce the same record ORDER (same stable
    single-key sort); only field values quantize."""
    rng = np.random.default_rng(1)
    n = 512
    key = jnp.asarray(rng.integers(0, 50, n).astype(np.uint32))
    fields = tuple(jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
                   for _ in range(rk.NUM_FIELDS))
    sk_q, sf_q = rk.sort_records_q16(key, fields, 64, 64)
    sk_f, _, sf_f = rk.sort_with_payload(key.astype(jnp.int32), fields)
    np.testing.assert_array_equal(np.asarray(sk_q).astype(np.int64),
                                  np.asarray(sk_f).astype(np.int64))
    for a, b in zip(sf_q, sf_f):
        # order identical; values quantized within the budget
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3)


def test_q16_image_inside_reference_tolerance():
    """End-to-end: the q16 render differs from the exact f32 render, but by
    far less than the reference's own 0.01 CPU-vs-GPU tolerance."""
    scene = ply_io.make_synthetic_scene(512, seed=7, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    a = camera_args(cam)
    args = (jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H)
    img_f, stats_f = render_fast(params, *args, CFG_F32)
    img_q, stats_q = render_fast(params, *args, CFG_Q16)
    assert int(stats_f["overflow"]) == 0
    assert int(stats_q["num_records"]) == int(stats_f["num_records"])
    err = float(jnp.max(jnp.abs(img_q[..., :3] - img_f[..., :3])))
    assert err < 2e-3, f"q16 image error {err} breaches the budget"
    # the mode genuinely quantizes (it is not silently running f32)
    assert err > 0.0
    assert float(jnp.max(img_f[..., :3])) > 0.05, "scene rendered empty"


def test_q16_requires_packed_single_key():
    scene = ply_io.make_synthetic_scene(64, seed=3, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    a = camera_args(cam)
    args = (jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H)
    with pytest.raises(ValueError, match="q16"):
        render_fast(params, *args,
                    dataclasses.replace(CFG_Q16, depth_key="pair"))
    with pytest.raises(ValueError, match="q16"):
        render_fast(params, *args,
                    dataclasses.replace(CFG_Q16, hoist_depth_sort=True))
    with pytest.raises(ValueError, match="sort_payload"):
        RenderConfig(sort_payload="bf16")


def test_q16_backward_raises():
    """Differentiating the q16 pipeline must fail loudly, not silently
    return zero gradients."""
    scene = ply_io.make_synthetic_scene(64, seed=3, extent=1.5)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cam = Camera(0.0, 0.0, -4.0, width=W, height=H)
    a = camera_args(cam)

    def loss(p):
        img, _ = render_fast(
            p, jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H, CFG_Q16)
        return jnp.mean(img[..., :3])

    with pytest.raises(NotImplementedError, match="inference-only"):
        jax.grad(loss)(params)
