"""Interactive HTTP viewer: drive the reference's key loop over HTTP."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from openglgaussiansplattingrenderer_jax import Camera, RenderConfig, Splats
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.viewer import interactive

CFG = RenderConfig(use_pallas=False, chunk=32, max_per_tile=128,
                   dup_capacity_factor=24.0)


@pytest.fixture()
def server(tmp_path):
    s = ply_io.make_synthetic_scene(30, seed=2, extent=1.5)
    p = str(tmp_path / "scene.ply")
    ply_io.save_ply(p, s["means"], s["quats"], s["scales"], s["opacities"],
                    s["colors"])
    splats = Splats(p, 64, 64, cfg=CFG)
    cam = Camera(0.0, 0.0, -4.0, width=64, height=64)
    srv = interactive.make_server(splats, cam, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, cam
    srv.shutdown()


def _get(srv, path):
    port = srv.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
        return r.read(), dict(r.headers)


def test_index_page(server):
    srv, _ = server
    body, headers = _get(srv, "/")
    assert b"gsplat-jax" in body and b"keydown" in body


def test_frame_and_movement(server):
    srv, cam = server
    png, headers = _get(srv, "/frame")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    stats = json.loads(headers["X-Stats"])
    assert stats["pos"] == [0.0, 0.0, -4.0]

    # W key: move_forward(0.1) along rotation row 2 (= +z at identity)
    _, headers = _get(srv, "/frame?key=w")
    stats = json.loads(headers["X-Stats"])
    assert stats["pos"] == [0.0, 0.0, -3.9]
    np.testing.assert_allclose(cam.position, [0.0, 0.0, -3.9], atol=1e-6)

    # arrow right: rotate_right(1 degree)
    _, headers = _get(srv, "/frame?key=right")
    stats = json.loads(headers["X-Stats"])
    assert stats["rot"][1] == 1.0


def test_golden_key(server):
    srv, _ = server
    png, headers = _get(srv, "/frame?key=c")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert json.loads(headers["X-Stats"])["path"] == "golden"


def test_live_stream_delivers_frames_and_fps(server):
    """/stream is a continuous multipart/x-mixed-replace loop: queued /key
    presses apply between frames and the server measures delivered fps."""
    srv, cam = server
    srv.stream_max_frames = 4      # test hook: bounded stream
    _get(srv, "/key?key=w")        # queued before the stream starts

    body, headers = _get(srv, "/stream")
    assert "multipart/x-mixed-replace" in headers["Content-Type"]
    parts = body.split(b"--gsframe\r\n")
    frames = [p for p in parts if p.strip()]
    assert len(frames) == 4
    for p in frames:
        head, _, payload = p.partition(b"\r\n\r\n")
        assert (b"image/jpeg" in head) or (b"image/png" in head)
        magic_ok = (payload[:2] == b"\xff\xd8"          # JPEG SOI
                    or payload[:8] == b"\x89PNG\r\n\x1a\n")
        assert magic_ok, head

    # the queued W applied on the first streamed frame
    np.testing.assert_allclose(cam.position, [0.0, 0.0, -3.9], atol=1e-6)

    stats_body, _ = _get(srv, "/stats")
    stats = json.loads(stats_body)
    assert stats["stream_frames"] == 4
    assert stats["stream_fps"] > 0
    assert "num_records" in stats


def test_live_page(server):
    srv, _ = server
    body, _ = _get(srv, "/live")
    assert b"/stream" in body and b"keydown" in body
