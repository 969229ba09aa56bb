"""End-to-end differentiable render pipeline.

The JAX equivalent of ``Splats::gpuRender`` (``src/Splats.cpp:587-597``):

    preprocess -> computeBins -> sort -> glFinish -> draw

becomes a single jitted dataflow graph

    preprocess -> expand_records -> lax.sort -> gather -> composite

with no per-frame host sync (the reference maps an atomic counter back to the
host every frame, ``Splats.cpp:579-583``) and no explicit barriers (XLA
dataflow ordering replaces glMemoryBarrier/glFinish).

Gradients: everything is jnp + gathers, so ``jax.grad`` of any image loss
yields gradients to means / scales / quats / opacities / colors. Duplicated
records' gradients are segment-summed per splat by the gather transpose.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops import binning, compositing, projection
from openglgaussiansplattingrenderer_jax.ops.transforms import (
    build_covariance,
    camera_center_from_view,
    color_to_dc,
    eval_sh,
)


def effective_colors(params, view, cfg: RenderConfig):
    """View-dependent colour when cfg.sh_degree > 0 and SH coeffs present.

    Capability beyond the reference (it discards f_rest); degree 0 reduces
    exactly to the DC colours stored in params["colors"].
    """
    sh_rest = params.get("sh_rest")
    if cfg.sh_degree <= 0 or sh_rest is None:
        return params["colors"]
    center = camera_center_from_view(view)
    d = params["means"] - center[None, :]
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    dc = color_to_dc(params["colors"], cfg.color_scale)
    return eval_sh(dc, sh_rest, d, cfg.sh_degree, cfg.color_scale)


def render_arrays(
    params: Dict[str, jnp.ndarray],
    view: jnp.ndarray,
    vp: jnp.ndarray,
    focal_x,
    focal_y,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    cfg: RenderConfig,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Render a splat parameter dict to an (H, W, 4) image plus stats.

    ``params`` needs means (N,3), scales (N,3), quats (N,4), opacities (N,),
    colors (N,3); a precomputed packed ``cov6`` (N,6) may be supplied instead
    of scales/quats (matching the reference's load-time covariance precompute,
    ``src/Splats.cpp:414-438``).
    """
    if cfg.use_pallas:
        # no fallback: a platform without the compiled kernels (or their
        # CPU interpreter) raises instead of rendering somewhere slower
        from openglgaussiansplattingrenderer_jax.ops import fastpath

        return fastpath.render_fast(params, view, vp, focal_x, focal_y,
                                    tan_fovx, tan_fovy, width, height, cfg)

    n = params["means"].shape[0]
    cov6 = params.get("cov6")
    if cov6 is None:
        cov6 = build_covariance(params["scales"], params["quats"])

    prep = projection.preprocess(
        params["means"], cov6, params["opacities"], view, vp,
        width, height, focal_x, focal_y, tan_fovx, tan_fovy, cfg,
    )
    capacity = cfg.capacity(n)
    recs = binning.expand_records(
        prep["counts"], prep["tile_min"], prep["tile_ext"], prep["depth"],
        cfg, capacity,
    )
    sorted_sid, bounds = binning.sort_and_bin(recs, cfg)
    if "shift2d" in params:
        # zero shift whose gradient is the screen-space positional gradient
        # (densification statistic); composited mean2d only, like the fast
        # path and graphdeco's viewspace_point_tensor
        prep = dict(prep)
        prep["mean2d"] = prep["mean2d"] + params["shift2d"]
    gathered = compositing.gather_records(prep, effective_colors(params, view, cfg),
                                          sorted_sid)

    image, aux = compositing.composite(gathered, bounds, width, height, cfg)

    num_visible = jnp.sum(prep["valid"])
    stats = {
        "num_splats": jnp.int32(n),
        "num_visible": num_visible,
        "num_culled": jnp.sum(prep["culled"]),
        "num_records": recs["total"],
        "num_duplicates": recs["total"] - num_visible,
        "overflow": recs["overflow"],
        **binning.bin_stats(bounds),
        **{k: v for k, v in aux.items() if k != "final_transmittance"},
    }
    return image, stats


@functools.partial(jax.jit, static_argnames=("width", "height", "cfg"))
def _render_jit(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                width, height, cfg):
    return render_arrays(params, view, vp, focal_x, focal_y, tan_fovx,
                         tan_fovy, width, height, cfg)


def render_stats(scene, camera, cfg: Optional[RenderConfig] = None,
                 width: Optional[int] = None, height: Optional[int] = None):
    """Render a scene from a Camera; returns (image, stats). Jit-cached."""
    cfg = cfg or RenderConfig()
    width = width or camera.width
    height = height or camera.height
    params = scene if isinstance(scene, dict) else scene.params()
    view = jnp.asarray(camera.get_view_matrix())
    vp = jnp.asarray(camera.get_vp_matrix())
    # Argument order quirk kept from the reference app (main.cpp:62-64):
    # tan_fov_x receives getTanFovy() and vice versa.
    return _render_jit(
        params, view, vp,
        jnp.float32(camera.get_focal_x()), jnp.float32(camera.get_focal_y()),
        jnp.float32(camera.get_tan_fovy()), jnp.float32(camera.get_tan_fovx()),
        width, height, cfg,
    )


def render(scene, camera, cfg: Optional[RenderConfig] = None,
           width: Optional[int] = None, height: Optional[int] = None):
    """Render a scene from a Camera; returns the (H, W, 4) image."""
    image, _ = render_stats(scene, camera, cfg, width, height)
    return image


def render_depth(
    params: Dict[str, jnp.ndarray],
    view: jnp.ndarray,
    vp: jnp.ndarray,
    focal_x,
    focal_y,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    cfg: RenderConfig,
    mode: str = "ndc",
    normalize: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Expected-depth map (H, W) plus coverage/alpha map (H, W).

    Capability beyond the reference (it renders RGB only): the alpha-blend
    weights w_k = alpha_k * T_k are linear in colour, so rendering with each
    splat's colour replaced by its depth yields the expected depth
    E[d] = sum_k w_k d_k through the SAME pipeline (Pallas fast path
    included) with bitwise-identical weights to the RGB render -- no new
    kernel, exact by construction.

    mode="ndc": d = the [0, 1]-mapped NDC z the sorter orders by
    (preprocess.glsl:91-94). mode="view": the view-space z coordinate
    (sign follows the reference camera convention, Camera.cpp:57-65).
    normalize=True divides by accumulated alpha (expected depth given a
    hit); pixels with zero coverage return 0. Differentiable like the
    colour render.
    """
    f32 = jnp.float32
    means = params["means"].astype(f32)
    mat = (vp if mode == "ndc" else view).astype(f32)
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    p2 = mx * mat[2, 0] + my * mat[2, 1] + mz * mat[2, 2] + mat[2, 3]
    if mode == "ndc":
        p3 = mx * mat[3, 0] + my * mat[3, 1] + mz * mat[3, 2] + mat[3, 3]
        d = (p2 / jnp.maximum(p3, cfg.w_eps) + 1.0) * 0.5
    elif mode == "view":
        d = p2
    else:
        raise ValueError(f"unknown depth mode {mode!r}")

    import dataclasses

    params_d = {k: v for k, v in params.items() if k != "sh_rest"}
    params_d["colors"] = jnp.broadcast_to(
        (d * cfg.color_scale)[:, None], (means.shape[0], 3))
    cfg_d = dataclasses.replace(cfg, sh_degree=0, background=(0.0, 0.0, 0.0))
    img, stats = render_arrays(params_d, view, vp, focal_x, focal_y,
                               tan_fovx, tan_fovy, width, height, cfg_d)
    depth = img[..., 0]
    alpha = img[..., 3]
    if normalize:
        depth = jnp.where(alpha > 0.0, depth / jnp.maximum(alpha, 1e-12), 0.0)
    return depth, alpha, stats


@functools.partial(jax.jit, static_argnames=("width", "height", "cfg"))
def count_records(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                  width, height, cfg):
    """Exact record count this scene/camera would allocate (N-sized, cheap).

    Runs only the elementwise preprocess (EWA + cull + tile-rect counts) and
    sums the per-splat duplicate counts -- no sort, no expand, no composite.
    """
    cov6 = params.get("cov6")
    if cov6 is None:
        cov6 = build_covariance(params["scales"], params["quats"])
    prep = projection.preprocess(
        params["means"], cov6, params["opacities"], view, vp,
        width, height, focal_x, focal_y, tan_fovx, tan_fovy, cfg)
    # int32 sum: record counts are bounded by the 2^24 exact-f32 index range
    # the fast path asserts, far below int32 overflow
    return jnp.sum(prep["counts"].astype(jnp.int32))


def quantize_capacity(records: int, margin: float = 1.1,
                      steps_per_octave: int = 8) -> int:
    """Round ``records * margin`` up to a log-quantized capacity bucket.

    Quantizing (~9% steps at the default) bounds the number of distinct
    compiled programs a moving camera can trigger while keeping the sort
    length within ``margin * (1 + 1/steps)`` of the true record count.
    """
    cap = max(int(records * margin), 1024)
    # step = 2^floor(log2(cap)) / steps_per_octave, floored at 128
    log_steps = steps_per_octave.bit_length() - 1
    step = max(1 << max(cap.bit_length() - 1 - log_steps, 0), 128)
    return -(-cap // step) * step


def autotune_capacity(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                      width: int, height: int, cfg: RenderConfig,
                      margin: float = 1.1) -> RenderConfig:
    """Config with ``capacity_records`` pinned to the measured record count.

    Capacity is the length of the record sort and the expand -- the
    first-order cost knob of the fast path (ARCHITECTURE.md). The reference
    learns its true duplicate count with a per-frame atomic-counter readback
    (``src/Splats.cpp:579-583``); here the count costs one cheap N-sized
    program + one host scalar fetch at TUNING time only -- rendering stays
    sync-free, and the quantized bucket absorbs camera motion (re-tune on
    large viewpoint changes; overflow stats report when the margin is
    breached -- overflowing records drop farthest-first, exactly the
    reference's clamp behaviour at its 2x capacity, Splats.cpp:582).
    """
    import dataclasses

    total = int(count_records(params, jnp.asarray(view), jnp.asarray(vp),
                              jnp.float32(focal_x), jnp.float32(focal_y),
                              jnp.float32(tan_fovx), jnp.float32(tan_fovy),
                              width, height, cfg))
    return dataclasses.replace(
        cfg, capacity_records=quantize_capacity(total, margin))


def render_loss(params, target, view, vp, focal_x, focal_y, tan_fovx,
                tan_fovy, width: int, height: int, cfg: RenderConfig):
    """L2 image loss -- convenience for gradient tests and fitting."""
    image, _ = render_arrays(params, view, vp, focal_x, focal_y, tan_fovx,
                             tan_fovy, width, height, cfg)
    return jnp.mean((image[..., :3] - target) ** 2)


def camera_args(camera) -> Dict[str, np.ndarray]:
    """Camera -> the argument bundle gpuRender receives (main.cpp:62-64)."""
    return {
        "view": np.asarray(camera.get_view_matrix()),
        "vp": np.asarray(camera.get_vp_matrix()),
        "focal_x": np.float32(camera.get_focal_x()),
        "focal_y": np.float32(camera.get_focal_y()),
        "tan_fovx": np.float32(camera.get_tan_fovy()),  # reference arg swap
        "tan_fovy": np.float32(camera.get_tan_fovx()),
    }
