"""EWA screen-space projection ("preprocess"), vectorized jnp.

JAX equivalent of ``shaders/preprocess.glsl`` (dispatched per-splat with
workgroup size 1 in the reference, ``src/Splats.cpp:576``): a pure map over
splats, expressed as fused elementwise jnp ops over (N,) arrays so XLA tiles it
onto the VPU. Differentiable end-to-end; the data-dependent duplication is
deferred to ``ops/binning.py`` (the reference uses an atomic counter + host
readback, ``preprocess.glsl:157-189`` + ``Splats.cpp:579-583``).

Math (verified against a literal glm/GLSL emulation in
``tests/test_projection.py``):

- p = VP @ mean, p /= max(p.w, 1e-4)                     (preprocess.glsl:77-78)
- frustum cull: |ndc.x| > 1 or |ndc.y| > 1               (preprocess.glsl:80-89)
- screen: s = (ndc + 1)/2 * (W, H), z01 = (ndc.z + 1)/2  (preprocess.glsl:91-94)
- view-space t with the 1.3*tanFov clamp                 (preprocess.glsl:110-116)
- cov2d = U Sigma U^T + dilation*I with U = J @ View3x3,
  J the 2x3 EWA Jacobian; the reference's transposed-glm formulation
  transpose(T)*transpose(Sigma)*T reduces to exactly this (preprocess.glsl:118-128)
- conic = inverse(cov2d) packed (A, B, C) s.t.
  power = -0.5(A dx^2 + C dy^2) - B dx dy                (preprocess.glsl:130-136)
- radius = ceil(3*sqrt(lambda_max)) via closed-form eigenvalues
                                                         (preprocess.glsl:139-142)
- tile range [tmin, tmax] clamped to the 16x16 grid      (preprocess.glsl:143-149);
  with ``cfg.tight_rect`` the reference's 3-sigma square is intersected with
  the opacity-aware {alpha >= alpha_min} ellipse AABB -- image-exact (see
  the inline note), it only stops allocating records the reference's own
  per-pixel cutoff would skip
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops.transforms import covariance_quadratic_form


def preprocess(
    means: jnp.ndarray,       # (N, 3)
    cov6: jnp.ndarray,        # (N, 6) packed 3D covariance
    opacities: jnp.ndarray,   # (N,)
    view: jnp.ndarray,        # (4, 4)
    vp: jnp.ndarray,          # (4, 4) projection @ view
    width: int,
    height: int,
    focal_x,
    focal_y,
    tan_fovx,
    tan_fovy,
    cfg: RenderConfig,
) -> Dict[str, jnp.ndarray]:
    """Project all splats to screen space. Returns per-splat arrays."""
    f32 = jnp.float32
    means = means.astype(f32)

    # --- projection of the mean (preprocess.glsl:77-94) -------------------
    # Explicit elementwise mat4 application: a (N,4)@(4,4) matmul gains
    # nothing at K=4 and a reduced-precision default matmul (TF32 on the
    # GPU) drifts centres by fractions of a pixel; elementwise f32 is exact.
    def apply_mat4(mat):
        mat = mat.astype(f32)
        mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
        return [mx * mat[j, 0] + my * mat[j, 1] + mz * mat[j, 2] + mat[j, 3]
                for j in range(4)]

    p0, p1, p2, p3 = apply_mat4(vp)
    w = jnp.maximum(p3, cfg.w_eps)
    ndc = jnp.stack([p0 / w, p1 / w, p2 / w], axis=1)
    culled = (jnp.abs(ndc[:, 0]) > 1.0) | (jnp.abs(ndc[:, 1]) > 1.0)
    sx = (ndc[:, 0] + 1.0) * 0.5 * width
    sy = (ndc[:, 1] + 1.0) * 0.5 * height
    z01 = (ndc[:, 2] + 1.0) * 0.5

    # --- view-space position with fov clamp (preprocess.glsl:110-116) -----
    t0, t1, t2, _ = apply_mat4(view)
    t = jnp.stack([t0, t1, t2], axis=1)
    tz = t[:, 2]
    # Reference quirk kept verbatim: limx = -margin * tanFov and the clamp is
    # written min(limx, max(-limx, x)). With the reference Camera's
    # degrees-as-radians tan values this acts as a wide symmetric clamp.
    limx = jnp.asarray(-cfg.fov_margin * tan_fovx, f32)
    limy = jnp.asarray(-cfg.fov_margin * tan_fovy, f32)
    txtz = t[:, 0] / tz
    tytz = t[:, 1] / tz
    tx = jnp.minimum(limx, jnp.maximum(-limx, txtz)) * tz
    ty = jnp.minimum(limy, jnp.maximum(-limy, tytz)) * tz

    # --- EWA 2D covariance (preprocess.glsl:118-128) ----------------------
    v3 = view[:3, :3].astype(f32)
    inv_tz = 1.0 / tz
    # Rows of U = J @ View3: U0 = fx/tz * V[0,:] - fx*tx/tz^2 * V[2,:]
    fx = jnp.asarray(focal_x, f32)
    fy = jnp.asarray(focal_y, f32)
    u0 = (fx * inv_tz)[:, None] * v3[0, :][None, :] - (
        fx * tx * inv_tz * inv_tz
    )[:, None] * v3[2, :][None, :]
    u1 = (fy * inv_tz)[:, None] * v3[1, :][None, :] - (
        fy * ty * inv_tz * inv_tz
    )[:, None] * v3[2, :][None, :]
    a2d = covariance_quadratic_form(cov6, u0, u0) + cfg.dilation
    b2d = covariance_quadratic_form(cov6, u0, u1)
    c2d = covariance_quadratic_form(cov6, u1, u1) + cfg.dilation

    det = a2d * c2d - b2d * b2d
    # Reference bails out on det == 0 (preprocess.glsl:131-134); we also fold
    # non-finite math (splat at the camera plane) into the cull mask.
    degenerate = (det == 0.0) | ~jnp.isfinite(det) | ~jnp.isfinite(sx) | ~jnp.isfinite(sy)
    valid = ~culled & ~degenerate
    safe_det = jnp.where(det == 0.0, 1.0, det)
    inv_det = 1.0 / safe_det
    conic = jnp.stack([c2d * inv_det, -b2d * inv_det, a2d * inv_det], axis=1)

    opacities = opacities.astype(f32)
    if cfg.antialiased:
        # Opacity compensation (cfg.antialiased): the +dilation*I above
        # inflates every Gaussian's footprint; scaling opacity by
        # sqrt(det_before / det_after) keeps its integrated contribution
        # invariant. Differentiable; downstream (tight_rect ellipse, record
        # cull, compositor) all consume the compensated opacity.
        det_nodil = ((a2d - cfg.dilation) * (c2d - cfg.dilation)
                     - b2d * b2d)
        comp = jnp.sqrt(jnp.maximum(det_nodil, 1e-30) /
                        jnp.maximum(det, 1e-30))
        opacities = opacities * jnp.where(valid, comp, 1.0)

    # --- bounding radius via eigenvalues (preprocess.glsl:139-142) --------
    mid = 0.5 * (a2d + c2d)
    lam_max = mid + jnp.sqrt(jnp.maximum(cfg.eig_floor, mid * mid - det))
    radius = jnp.ceil(cfg.radius_sigma * jnp.sqrt(jnp.maximum(lam_max, 0.0)))

    # --- tile range (preprocess.glsl:143-153) -----------------------------
    gx, gy = cfg.grid_x, cfg.grid_y
    if cfg.int_tile_size:
        # Reference-quirk replication mode (preprocess.glsl:143 integer
        # division); like the reference, the rect divisor then disagrees
        # with the draw tiling when width % grid != 0.
        tile_w, tile_h = cfg.tile_size(width, height)
    else:
        # The divisor MUST be the compositor's actual padded tile pitch
        # (ops/compositing.padded_dims): every path assigns pixels to tiles
        # in integer pw/ph blocks, so a rect computed against the unpadded
        # width/grid pitch drifts for high tile indices when the resolution
        # is not grid-divisible (e.g. 1080/34 = 31.76 vs a 32 px pitch) and
        # can skip a tile that still contains reachable pixels. Identity at
        # grid-divisible resolutions, including the reference's 1024x512/16.
        from openglgaussiansplattingrenderer_jax.ops.compositing import padded_dims

        wp_t, hp_t = padded_dims(width, height, cfg)
        tile_w, tile_h = wp_t / gx, hp_t / gy
    reach = valid
    if cfg.tight_rect:
        # Opacity-aware ellipse AABB (cfg.tight_rect): the set a pixel must
        # lie in to pass draw.glsl:118-126's alpha >= alpha_min test is the
        # ellipse d^T Q d <= 2L with Q = conic and L = ln(opacity/alpha_min);
        # since Q^{-1} is the (dilated) 2D covariance, its axis-aligned
        # half-extents are rx = sqrt(2L*Sigma_xx), ry = sqrt(2L*Sigma_yy).
        # Intersecting the reference's 3-sigma square with this AABB removes
        # only tiles whose every pixel the reference itself would skip --
        # image-exact, but the records are never allocated (the per-record
        # reachability cull in ops/pallas/records.py still runs; it is
        # strictly stronger, this is its O(1)-per-splat allocation-time
        # counterpart). A splat with opacity < alpha_min reaches nothing
        # anywhere and allocates zero records. The 1e-3 px inflation keeps
        # f32-borderline alpha == alpha_min pixels inside the rectangle.
        lam = jnp.log(jnp.maximum(opacities.astype(f32), 1e-30)
                      / cfg.alpha_min)
        two_l = 2.0 * jnp.maximum(lam, 0.0)
        rx = jnp.minimum(radius, jnp.sqrt(two_l * jnp.maximum(a2d, 0.0)) + 1e-3)
        ry = jnp.minimum(radius, jnp.sqrt(two_l * jnp.maximum(c2d, 0.0)) + 1e-3)
        rx = jax.lax.stop_gradient(rx)
        ry = jax.lax.stop_gradient(ry)
        reach = valid & (opacities.astype(f32) >= cfg.alpha_min)
    else:
        rx = ry = radius
    # GLSL int() truncates toward zero; the subsequent clamps make trunc vs
    # floor indistinguishable for in-range splats.
    tmin_x = jnp.clip(((sx - rx) / tile_w).astype(jnp.int32), 0, gx - 1)
    tmax_x = jnp.clip(((sx + rx) / tile_w).astype(jnp.int32), 0, gx - 1)
    tmin_y = jnp.clip(((sy - ry) / tile_h).astype(jnp.int32), 0, gy - 1)
    tmax_y = jnp.clip(((sy + ry) / tile_h).astype(jnp.int32), 0, gy - 1)
    ext_x = tmax_x - tmin_x + 1
    ext_y = tmax_y - tmin_y + 1
    counts = jnp.where(reach, ext_x * ext_y, 0).astype(jnp.int32)

    mean2d = jnp.stack([sx, sy], axis=1)
    return {
        "mean2d": mean2d,            # (N, 2) pixel coords
        "conic": conic,              # (N, 3) (A, B, C)
        "opacity": opacities.astype(f32),
        "depth": z01,                # (N,) ndc z mapped to [0, 1] in-frustum
        "radius": radius,            # (N,)
        "tile_min": jnp.stack([tmin_x, tmin_y], axis=1),  # (N, 2) int32
        "tile_ext": jnp.stack([ext_x, ext_y], axis=1),    # (N, 2) int32
        "counts": counts,            # (N,) tiles overlapped (0 if culled)
        "valid": valid,              # (N,) bool
        "culled": culled,            # (N,) bool (frustum cull only)
    }
