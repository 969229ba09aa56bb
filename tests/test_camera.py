"""Camera convention tests vs. a literal glm emulation (``src/Camera.cpp``)."""

import math

import numpy as np

from openglgaussiansplattingrenderer_jax.camera import Camera, default_camera, perspective


def _glm_rotate(angle_rad, axis):
    """glm::rotate(mat4(1), angle, axis) for unit axes, column-vector math."""
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    x, y, z = axis
    # Rodrigues for unit axis
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], dtype=np.float64)
    r = np.eye(3) + s * k + (1 - c) * (k @ k)
    m = np.eye(4)
    m[:3, :3] = r
    return m


def test_view_matrix_matches_glm_emulation():
    cam = Camera(5.0, 0.5, -4.0)
    cam.rotate_down(20.0)
    cam.rotate_right(40.0)
    cam.update()
    rx = _glm_rotate(math.radians(cam.rotation[0]), (1, 0, 0))
    ry = _glm_rotate(math.radians(cam.rotation[1]), (0, 1, 0))
    rz = _glm_rotate(math.radians(cam.rotation[2]), (0, 0, 1))
    rot = rx @ ry @ rz
    trans = np.eye(4)
    trans[:3, 3] = cam.position  # glm::translate keeps +position (ref quirk)
    want = rot @ trans
    np.testing.assert_allclose(cam.get_view_matrix(), want, atol=1e-6)


def test_projection_matrix_is_glm_perspective():
    p = perspective(math.radians(60.0), 2.0, 0.1, 10000.0)
    t = math.tan(math.radians(30.0))
    assert np.isclose(p[0, 0], 1 / (2 * t))
    assert np.isclose(p[1, 1], 1 / t)
    assert np.isclose(p[3, 2], -1.0)
    assert np.isclose(p[2, 2], -(10000.0 + 0.1) / (10000.0 - 0.1))
    assert np.isclose(p[2, 3], -(2 * 10000.0 * 0.1) / (10000.0 - 0.1))
    # A point on the near plane maps to ndc z = -1, far plane to +1.
    near_pt = p @ np.array([0, 0, -0.1, 1.0])
    far_pt = p @ np.array([0, 0, -10000.0, 1.0])
    assert np.isclose(near_pt[2] / near_pt[3], -1.0, atol=1e-5)
    assert np.isclose(far_pt[2] / far_pt[3], 1.0, atol=1e-5)


def test_reference_tanfov_quirk():
    """Camera.cpp:199-212 evaluates tan(fovy/2) with fovy in degrees."""
    cam = Camera(0, 0, 0)  # fovy=60, 1024x512
    assert np.isclose(cam.get_tan_fovy(), math.tan(30.0))  # tan(30 rad) ~ -6.4053
    assert np.isclose(cam.get_tan_fovx(), math.tan(30.0) * 2.0)
    assert cam.get_tan_fovy() < 0  # the quirk's signature
    assert np.isclose(cam.tan_fovy_correct(), math.tan(math.radians(30.0)))


def test_focal_lengths():
    cam = Camera(0, 0, 0)
    t = math.tan(math.radians(30.0))
    assert np.isclose(cam.get_focal_x(), 1024 / (2 * t))
    assert np.isclose(cam.get_focal_y(), 512 / (2 * t))


def test_movement_directions():
    cam = Camera(0, 0, 0)
    cam.move_forward(1.0)  # identity rotation: forward = row 2 of I = +z
    np.testing.assert_allclose(cam.position, [0, 0, 1], atol=1e-6)
    cam = Camera(0, 0, 0)
    cam.move_left(2.0)
    np.testing.assert_allclose(cam.position, [2, 0, 0], atol=1e-6)
    cam = Camera(0, 0, 0)
    cam.move_up(3.0)
    np.testing.assert_allclose(cam.position, [0, 3, 0], atol=1e-6)


def test_default_camera_pose():
    cam = default_camera()
    np.testing.assert_allclose(cam.position, [5.0, 0.5, -4.0])
    np.testing.assert_allclose(cam.rotation, [-20.0, 40.0, 0.0])
    assert cam.width == 1024 and cam.height == 512
