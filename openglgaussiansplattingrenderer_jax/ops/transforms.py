"""Differentiable splat-parameter transforms (jnp, fully vectorized).

JAX equivalents of the reference's CPU-side per-splat loops:

- activation transforms applied at PLY load (ref ``src/Splats.cpp:275-331``):
  colour = (0.5 + SH_C0 * f_dc) * 255, opacity = sigmoid, scale = exp,
  quaternion normalised
- quaternion + scale -> 3D covariance, 6-float symmetric packing
  (ref ``src/Splats.cpp:414-479``: M = S*R^T in glm storage, Sigma = M^T*M,
  i.e. mathematically Sigma = R diag(s)^2 R^T)

The packed covariance layout is the row-major upper triangle
(xx, xy, xz, yy, yz, zz), matching the reference's
``cov[0][0], cov[0][1], cov[0][2], cov[1][1], cov[1][2], cov[2][2]``
(``src/Splats.cpp:430-435``).
"""

from __future__ import annotations

import jax.numpy as jnp

# From graphdeco-inria/diff-gaussian-rasterization, cited by the reference at
# src/Splats.cpp:274-275.
SH_C0 = 0.28209479177387814


def sigmoid(x):
    return 1.0 / (1.0 + jnp.exp(-x))


def inverse_sigmoid(y):
    return jnp.log(y) - jnp.log1p(-y)


def dc_to_color(f_dc, color_scale: float = 255.0):
    """DC spherical-harmonic coefficient -> view-independent colour.

    Ref ``src/Splats.cpp:295``: c = (0.5 + SH_C0 * f_dc) * 255.
    """
    return (0.5 + SH_C0 * f_dc) * color_scale


def color_to_dc(c, color_scale: float = 255.0):
    return (c / color_scale - 0.5) / SH_C0


def normalize_quat(q, eps: float = 0.0):
    """Normalise (N, 4) quaternions stored (w, x, y, z) (ref ``Splats.cpp:324-329``)."""
    n = jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True) + eps)
    return q / n


def quat_to_rotmat(q):
    """(N, 4) wxyz quaternions -> (N, 3, 3) rotation matrices.

    Matches the matrix built at ``src/Splats.cpp:454-458`` (interpreted in
    math row/column convention; the glm storage there holds R^T, and the
    subsequent Sigma = M^T M works out to R S^2 R^T -- see module docstring).
    """
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], axis=-1)
    row1 = jnp.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], axis=-1)
    row2 = jnp.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def build_covariance(scales, quats):
    """(N, 3) scales + (N, 4) wxyz quats -> (N, 6) packed Sigma = R S^2 R^T.

    Packed layout (xx, xy, xz, yy, yz, zz); ref ``src/Splats.cpp:440-479``.
    Written as explicit elementwise products: batched 3x3 matmuls/einsums
    gain nothing from a matrix unit, may run at reduced precision (TF32 on
    the GPU), and fused elementwise f32 is exact.
    """
    r, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    sx, sy, sz = scales[..., 0], scales[..., 1], scales[..., 2]
    # rows of R (see quat_to_rotmat), columns scaled by s -> m[i][k]
    m = [
        [(1 - 2 * (y * y + z * z)) * sx, 2 * (x * y - r * z) * sy, 2 * (x * z + r * y) * sz],
        [2 * (x * y + r * z) * sx, (1 - 2 * (x * x + z * z)) * sy, 2 * (y * z - r * x) * sz],
        [2 * (x * z - r * y) * sx, 2 * (y * z + r * x) * sy, (1 - 2 * (x * x + y * y)) * sz],
    ]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    return jnp.stack(
        [dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)],
        axis=-1,
    )


def unpack_covariance(cov6):
    """(N, 6) packed -> (N, 3, 3) symmetric matrices."""
    a, b, c, d, e, f = (cov6[..., i] for i in range(6))
    return jnp.stack(
        [jnp.stack([a, b, c], axis=-1),
         jnp.stack([b, d, e], axis=-1),
         jnp.stack([c, e, f], axis=-1)],
        axis=-2,
    )


def covariance_quadratic_form(cov6, u, v):
    """u^T Sigma v for packed (..., 6) covariances and (..., 3) vectors.

    Cheaper than materialising (N, 3, 3): 6 multiplies + cross terms.
    """
    a, b, c, d, e, f = (cov6[..., i] for i in range(6))
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return (a * u0 * v0 + d * u1 * v1 + f * u2 * v2
            + b * (u0 * v1 + u1 * v0)
            + c * (u0 * v2 + u2 * v0)
            + e * (u1 * v2 + u2 * v1))


# ---------------------------------------------------------------------------
# Spherical harmonics (view-dependent colour)
# ---------------------------------------------------------------------------
# The reference reads the 45 f_rest coefficients and discards them
# (src/Splats.cpp:301-302) -- its colour is DC-only. We keep them (like its
# Python tooling, tests/plyFileGenerator.py:119-127) and evaluate the full
# degree-3 basis, matching graphdeco-inria/diff-gaussian-rasterization's
# constants. Linear in the coefficients, so gradients flow for free.

SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def eval_sh(dc, sh_rest, dirs, degree: int, color_scale: float = 255.0):
    """Evaluate view-dependent colour from SH coefficients.

    dc (N, 3): the f_dc coefficients; sh_rest (N, 45): f_rest in the 3DGS
    PLY channel-major layout (15 coeffs x 3 channels, channel outer --
    tests/plyFileGenerator.py:125-127); dirs (N, 3): unit view directions
    (splat centre minus camera centre). Returns (N, 3) colour in
    [0, color_scale] convention: (0.5 + SH(dir)) * color_scale, degree 0
    reducing exactly to the reference's DC formula (src/Splats.cpp:295).
    """
    c = SH_C0 * dc
    if degree >= 1:
        sh = sh_rest.reshape(sh_rest.shape[0], 3, -1)    # (N, 3, 15) ch-major
        sh = jnp.swapaxes(sh, 1, 2)                      # (N, 15, 3)
        x = dirs[:, 0:1]
        y = dirs[:, 1:2]
        z = dirs[:, 2:3]
        c = c - SH_C1 * y * sh[:, 0] + SH_C1 * z * sh[:, 1] - SH_C1 * x * sh[:, 2]
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            c = (c + SH_C2[0] * xy * sh[:, 3]
                 + SH_C2[1] * yz * sh[:, 4]
                 + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 5]
                 + SH_C2[3] * xz * sh[:, 6]
                 + SH_C2[4] * (xx - yy) * sh[:, 7])
        if degree >= 3:
            c = (c + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 8]
                 + SH_C3[1] * xy * z * sh[:, 9]
                 + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 10]
                 + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 11]
                 + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 12]
                 + SH_C3[5] * z * (xx - yy) * sh[:, 13]
                 + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 14])
    return (0.5 + c) * color_scale


def camera_center_from_view(view):
    """World-space camera centre of a view matrix [R|t]: -R^T t.

    With the reference's +position translation quirk (Camera.cpp:63-64) this
    equals -position.
    """
    r = view[:3, :3]
    t = view[:3, 3]
    return -jnp.matmul(r.T, t, precision="highest")
