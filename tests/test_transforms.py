"""Covariance/activation transform tests.

Oracle: explicit R S^2 R^T per splat and an eigendecomposition round trip,
mirroring the reference's ``tests/CovarianceToAnglesAndScales.py`` check.
"""

import numpy as np

from openglgaussiansplattingrenderer_jax.ops import transforms


def _random_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def test_quat_to_rotmat_orthonormal(rng):
    q = _random_quats(rng, 64)
    r = np.asarray(transforms.quat_to_rotmat(q))
    eye = np.einsum("nij,nkj->nik", r, r)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)


def test_quat_identity():
    r = np.asarray(transforms.quat_to_rotmat(np.array([[1.0, 0, 0, 0]], np.float32)))
    np.testing.assert_allclose(r[0], np.eye(3), atol=1e-7)


def test_build_covariance_matches_explicit(rng):
    n = 128
    q = _random_quats(rng, n)
    s = np.exp(rng.uniform(-2, 1, size=(n, 3))).astype(np.float32)
    cov6 = np.asarray(transforms.build_covariance(s, q))
    r = np.asarray(transforms.quat_to_rotmat(q))
    explicit = np.einsum("nij,nj,nkj->nik", r, (s * s).astype(np.float64), r)
    packed = np.stack(
        [explicit[:, 0, 0], explicit[:, 0, 1], explicit[:, 0, 2],
         explicit[:, 1, 1], explicit[:, 1, 2], explicit[:, 2, 2]], axis=1)
    np.testing.assert_allclose(cov6, packed, rtol=1e-4, atol=1e-5)


def test_covariance_eigen_roundtrip(rng):
    """Eigendecomposition recovers the squared scales (CovarianceToAnglesAndScales)."""
    q = _random_quats(rng, 16)
    s = np.array([[0.5, 0.1, 0.2]], np.float32).repeat(16, axis=0)
    cov = np.asarray(transforms.unpack_covariance(transforms.build_covariance(s, q)))
    w = np.linalg.eigvalsh(cov)
    np.testing.assert_allclose(np.sort(w, axis=1), np.sort(s * s, axis=1),
                               rtol=1e-3, atol=1e-5)


def test_quadratic_form_matches_dense(rng):
    n = 32
    cov6 = np.asarray(
        transforms.build_covariance(
            np.exp(rng.uniform(-1, 1, (n, 3))).astype(np.float32), _random_quats(rng, n))
    )
    u = rng.normal(size=(n, 3)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    dense = np.asarray(transforms.unpack_covariance(cov6))
    want = np.einsum("ni,nij,nj->n", u, dense, v)
    got = np.asarray(transforms.covariance_quadratic_form(cov6, u, v))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_activation_roundtrip(rng):
    c = rng.uniform(1.0, 250.0, size=(10, 3)).astype(np.float32)
    back = transforms.dc_to_color(np.asarray(transforms.color_to_dc(c)))
    np.testing.assert_allclose(back, c, rtol=1e-5)
    o = rng.uniform(0.01, 0.99, size=10).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(transforms.sigmoid(transforms.inverse_sigmoid(o))), o, rtol=1e-5)
