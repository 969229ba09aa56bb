"""Golden CPU reference pipeline (numpy, sequential semantics).

Independent replica of the reference's CPU validation renderer
(``Splats::cpuRender``, ``src/Splats.cpp:599-1188``) used as the correctness
oracle for the JAX pipeline -- the same role cpuRender plays for the GL
pipeline (oracle pattern #1, SURVEY.md section 4).

Deliberately written differently from the production path:
- projection follows the GLSL literally with explicit per-splat matrix
  products T = W^T J, cov2d = T^T Sigma^T T (``shaders/preprocess.glsl:104-128``)
  rather than the fused quadratic-form formulation;
- duplication is a Python loop appending (tile, depth, splat) records exactly
  like the shader's per-splat loop (``preprocess.glsl:157-189``), with no
  capacity cap;
- compositing is per-tile *sequential* front-to-back blending with the
  per-pixel early break after crossing 0.99 accumulated alpha
  (``draw.glsl:109-134`` / ``Splats.cpp:978-1023``), validating the parallel
  masked formulation in ``ops/compositing.py``.

Reference quirks intentionally NOT replicated (recorded in QUIRKS.md):
- the CPU path's fmax(15, tileMax) bug (``Splats.cpp:727,729``) -- we follow
  the correct GPU shader (``preprocess.glsl:147,149``);
- draw.glsl's overrun of shared-memory batches past the tile range end;
- the 2x-numSplats duplicate cap and its skipped slot (``preprocess.glsl:167``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from openglgaussiansplattingrenderer_jax.config import RenderConfig


def golden_preprocess(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                      width, height, cfg: RenderConfig) -> Dict[str, np.ndarray]:
    """Per-splat projection, literal GLSL translation in float32 numpy."""
    f32 = np.float32
    means = params["means"].astype(f32)
    cov6 = params["cov6"].astype(f32)
    opac = params["opacities"].astype(f32)
    n = means.shape[0]
    view = view.astype(f32)
    vp = vp.astype(f32)

    means4 = np.concatenate([means, np.ones((n, 1), f32)], axis=1)
    p = means4 @ vp.T
    w = np.maximum(p[:, 3], f32(cfg.w_eps))
    ndc = p / w[:, None]
    culled = (np.abs(ndc[:, 0]) > 1.0) | (np.abs(ndc[:, 1]) > 1.0)
    sxy = (ndc[:, :2] + 1.0) * 0.5 * np.array([width, height], f32)
    z01 = (ndc[:, 2] + 1.0) * 0.5

    t = (means4 @ view.T)[:, :3]
    limx = f32(-cfg.fov_margin * tan_fovx)
    limy = f32(-cfg.fov_margin * tan_fovy)
    tx = np.minimum(limx, np.maximum(-limx, t[:, 0] / t[:, 2])) * t[:, 2]
    ty = np.minimum(limy, np.maximum(-limy, t[:, 1] / t[:, 2])) * t[:, 2]
    tz = t[:, 2]

    # Literal J as the GLSL mat3 (column-major constructor -> math matrix):
    # J = [[fx/tz, 0, 0], [0, fy/tz, 0], [-fx tx/tz^2, -fy ty/tz^2, 0]]
    j = np.zeros((n, 3, 3), f32)
    j[:, 0, 0] = focal_x / tz
    j[:, 1, 1] = focal_y / tz
    j[:, 2, 0] = -(focal_x * tx) / (tz * tz)
    j[:, 2, 1] = -(focal_y * ty) / (tz * tz)

    w3 = view[:3, :3]
    sig = np.zeros((n, 3, 3), f32)
    a, b, c, d, e, f = (cov6[:, i] for i in range(6))
    sig[:, 0, 0], sig[:, 0, 1], sig[:, 0, 2] = a, b, c
    sig[:, 1, 0], sig[:, 1, 1], sig[:, 1, 2] = b, d, e
    sig[:, 2, 0], sig[:, 2, 1], sig[:, 2, 2] = c, e, f

    # T = transpose(viewMatrix3) * Jacobian;  cov2D = T^T * Sigma^T * T
    tmat = np.einsum("ji,njk->nik", w3, j)  # W^T @ J per splat
    cov2d = np.einsum("nji,njk,nkl->nil", tmat, np.transpose(sig, (0, 2, 1)), tmat)
    a2 = cov2d[:, 0, 0] + f32(cfg.dilation)
    b2 = cov2d[:, 0, 1]
    c2 = cov2d[:, 1, 1] + f32(cfg.dilation)

    det = a2 * c2 - b2 * b2
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = np.where(det != 0, 1.0 / det, 0.0).astype(f32)
    conic = np.stack([c2 * inv_det, -b2 * inv_det, a2 * inv_det], axis=1)
    mid = 0.5 * (a2 + c2)
    with np.errstate(invalid="ignore"):
        lam = mid + np.sqrt(np.maximum(f32(cfg.eig_floor), mid * mid - det))
        radius = np.ceil(cfg.radius_sigma * np.sqrt(np.maximum(lam, 0.0))).astype(f32)
    valid = ~culled & (det != 0) & np.isfinite(det) & np.isfinite(sxy).all(axis=1)

    if cfg.antialiased:
        # Opacity compensation, mirroring ops/projection.py (cfg.antialiased)
        det_nodil = (a2 - f32(cfg.dilation)) * (c2 - f32(cfg.dilation)) - b2 * b2
        comp = np.sqrt(np.maximum(det_nodil, f32(1e-30)) /
                       np.maximum(det, f32(1e-30)))
        opac = opac * np.where(valid, comp, f32(1.0))

    return {
        "mean2d": sxy, "conic": conic, "depth": z01, "radius": radius,
        "opacity": opac, "valid": valid, "culled": culled,
    }


def golden_bin_and_sort(prep, width, height, cfg: RenderConfig):
    """Duplicate into overlapped tiles + stable sort by the packed float key."""
    tile_w, tile_h = cfg.tile_size(width, height)
    gx, gy = cfg.grid_x, cfg.grid_y
    tiles, depths, sids = [], [], []
    mean2d, radius, depth = prep["mean2d"], prep["radius"], prep["depth"]
    for i in np.nonzero(prep["valid"])[0]:
        x, y = mean2d[i]
        r = radius[i]
        tminx = min(max(0, int((x - r) / tile_w)), gx - 1)
        tmaxx = max(min(gx - 1, int((x + r) / tile_w)), 0)
        tminy = min(max(0, int((y - r) / tile_h)), gy - 1)
        tmaxy = max(min(gy - 1, int((y + r) / tile_h)), 0)
        for tyy in range(tminy, tmaxy + 1):
            for txx in range(tminx, tmaxx + 1):
                tiles.append(tyy * gx + txx)
                depths.append(depth[i])
                sids.append(i)
    tiles = np.asarray(tiles, np.int32)
    depths = np.asarray(depths, np.float32)
    sids = np.asarray(sids, np.int64)
    # Packed float key = tileIndex + ndc_z (preprocess.glsl:154), stable sort.
    key = tiles.astype(np.float32) + depths
    order = np.argsort(key, kind="stable")
    tiles, sids = tiles[order], sids[order]
    bounds = np.searchsorted(tiles, np.arange(cfg.num_tiles + 1), side="left")
    return sids, tiles, bounds


def golden_composite(prep, colors, sids, bounds, width, height,
                     cfg: RenderConfig) -> np.ndarray:
    """Sequential front-to-back per-tile blending (draw.glsl semantics)."""
    f32 = np.float32
    from openglgaussiansplattingrenderer_jax.ops.compositing import padded_dims

    wp, hp = padded_dims(width, height, cfg)
    pw, ph = wp // cfg.grid_x, hp // cfg.grid_y
    rgb = np.zeros((hp, wp, 3), f32)
    acc = np.zeros((hp, wp), f32)
    mean2d, conic, opac = prep["mean2d"], prep["conic"], prep["opacity"]

    for tile in range(cfg.num_tiles):
        start, end = bounds[tile], bounds[tile + 1]
        if start == end:
            continue
        tyy, txx = divmod(tile, cfg.grid_x)
        xs = np.arange(txx * pw, (txx + 1) * pw, dtype=f32)
        ys = np.arange(tyy * ph, (tyy + 1) * ph, dtype=f32)
        px, py = np.meshgrid(xs, ys)               # (ph, pw)
        t_rgb = rgb[tyy * ph:(tyy + 1) * ph, txx * pw:(txx + 1) * pw]
        t_acc = acc[tyy * ph:(tyy + 1) * ph, txx * pw:(txx + 1) * pw]
        done = np.zeros_like(t_acc, dtype=bool)
        for rec in range(start, end):
            i = sids[rec]
            dx = px - mean2d[i, 0]
            dy = py - mean2d[i, 1]
            ca, cb, cc = conic[i]
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = np.minimum(f32(cfg.alpha_max), np.exp(power) * opac[i])
            keep = (~done) & (power <= 0.0) & (alpha >= f32(cfg.alpha_min))
            blend = np.where(keep, alpha * (1.0 - t_acc), 0.0).astype(f32)
            t_rgb += blend[:, :, None] * colors[i][None, None, :]
            t_acc += blend
            done |= t_acc >= f32(cfg.saturation)
            if done.all():
                break
    out = np.concatenate([rgb / f32(cfg.color_scale), acc[:, :, None]], axis=2)
    bg = np.asarray(cfg.background, f32)
    out[:, :, :3] += (1.0 - acc[:, :, None]) * bg[None, None, :]
    return out[:height, :width]


def golden_render(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                  width, height, cfg: Optional[RenderConfig] = None
                  ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Full golden pipeline. Returns ((H, W, 4) image in [0, 1], debug dict)."""
    cfg = cfg or RenderConfig()
    if "cov6" not in params:
        from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance

        params = dict(params)
        params["cov6"] = np.asarray(build_covariance(params["scales"], params["quats"]))
    prep = golden_preprocess(params, np.asarray(view), np.asarray(vp),
                             focal_x, focal_y, tan_fovx, tan_fovy,
                             width, height, cfg)
    sids, tiles, bounds = golden_bin_and_sort(prep, width, height, cfg)
    image = golden_composite(prep, params["colors"].astype(np.float32),
                             sids, bounds, width, height, cfg)
    debug = {**prep, "sorted_sids": sids, "sorted_tiles": tiles, "bounds": bounds}
    return image, debug
