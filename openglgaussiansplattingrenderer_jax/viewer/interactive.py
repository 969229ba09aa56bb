"""Interactive browser viewer: the reference's GLFW window, over HTTP.

The reference app is interactive — WASD/space/shift move, arrows rotate,
ESC quits, C triggers the CPU render (``main.cpp:52-89``,
``Camera::getInput``, ``Camera.cpp:77-119``). A headless accelerator host has no display, so
this serves the same loop to a browser: an HTML page captures key presses
and fetches re-rendered PNG frames; the server applies the reference's exact
movement steps (0.1 units, 1 degree) to the same Camera.

Two modes:

- ``/`` — request-response: one PNG per key press (round-2 behaviour).
- ``/live`` — the reference's continuous render loop: ``/stream`` serves a
  multipart/x-mixed-replace (MJPEG) stream that re-renders continuously;
  key presses land via ``/key`` and take effect on the next frame; the
  server measures real delivered fps (EWMA over frame gaps, the analogue
  of the reference's per-frame ``GL_TIMESTAMP`` prints, main.cpp:60-77)
  and reports it at ``/stats`` and in the page overlay.

Usage:
    python -m openglgaussiansplattingrenderer_jax.viewer.interactive scene.ply
then open http://localhost:8000/ (or /live for the streamed mode).
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

PAGE = b"""<!doctype html>
<html><head><title>gsplat-jax viewer</title><style>
body { background:#111; color:#ccc; font-family:monospace; text-align:center }
img { image-rendering:pixelated; border:1px solid #333 }
</style></head><body>
<h3>gsplat-jax interactive viewer</h3>
<div>WASD move &middot; space/shift up/down &middot; arrows rotate &middot;
C = golden render &middot; stats below</div>
<img id="v" width="75%">
<pre id="s"></pre>
<script>
let busy = false;
async function frame(key) {
  if (busy) return; busy = true;
  const r = await fetch('/frame' + (key ? '?key=' + key : ''));
  const meta = JSON.parse(r.headers.get('x-stats') || '{}');
  document.getElementById('s').textContent = JSON.stringify(meta);
  const blob = await r.blob();
  document.getElementById('v').src = URL.createObjectURL(blob);
  busy = false;
}
document.addEventListener('keydown', (e) => {
  const map = {'w':'w','a':'a','s':'s','d':'d',' ':'space','Shift':'shift',
               'ArrowLeft':'left','ArrowRight':'right','ArrowUp':'up',
               'ArrowDown':'down','c':'c'};
  if (map[e.key] !== undefined) { e.preventDefault(); frame(map[e.key]); }
});
frame();
</script></body></html>"""

LIVE_PAGE = b"""<!doctype html>
<html><head><title>gsplat-jax live viewer</title><style>
body { background:#111; color:#ccc; font-family:monospace; text-align:center }
img { image-rendering:pixelated; border:1px solid #333 }
</style></head><body>
<h3>gsplat-jax live viewer (streamed)</h3>
<div>WASD move &middot; space/shift up/down &middot; arrows rotate &middot;
measured fps + stats below</div>
<img id="v" src="/stream" width="75%">
<pre id="s"></pre>
<script>
document.addEventListener('keydown', (e) => {
  const map = {'w':'w','a':'a','s':'s','d':'d',' ':'space','Shift':'shift',
               'ArrowLeft':'left','ArrowRight':'right','ArrowUp':'up',
               'ArrowDown':'down'};
  if (map[e.key] !== undefined) {
    e.preventDefault(); fetch('/key?key=' + map[e.key]);
  }
});
setInterval(async () => {
  const r = await fetch('/stats');
  document.getElementById('s').textContent =
      JSON.stringify(await r.json());
}, 500);
</script></body></html>"""


class ViewerState:
    def __init__(self, splats, camera):
        self.splats = splats
        self.camera = camera
        self.lock = threading.Lock()
        self.pending: list = []        # queued /key presses for the stream
        self.stream_fps = 0.0          # EWMA of delivered stream frame rate
        self.stream_frames = 0
        self.last_stats_json: dict = {}

    def apply_key(self, key: Optional[str]) -> None:
        """Reference key handling (Camera::getInput, Camera.cpp:77-119)."""
        cam = self.camera
        if key == "w":
            cam.move_forward(0.1)
        elif key == "s":
            cam.move_backward(0.1)
        elif key == "a":
            cam.move_left(0.1)
        elif key == "d":
            cam.move_right(0.1)
        elif key == "space":
            cam.move_up(0.1)
        elif key == "shift":
            cam.move_down(0.1)
        elif key == "left":
            cam.rotate_left(1.0)
        elif key == "right":
            cam.rotate_right(1.0)
        elif key == "up":
            cam.rotate_up(1.0)
        elif key == "down":
            cam.rotate_down(1.0)

    def render_png(self, key: Optional[str]):
        from openglgaussiansplattingrenderer_jax.io.png import to_uint8
        from openglgaussiansplattingrenderer_jax.render import camera_args

        with self.lock:
            self.apply_key(key)
            if key == "c":
                # the reference's C key: run the CPU/golden render
                a = camera_args(self.camera)
                img = self.splats.cpu_render(
                    a["view"], self.camera.width, self.camera.height,
                    a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"],
                    a["vp"], save_path=None)
                stats = {"path": "golden"}
            else:
                img = self.splats.render_camera(self.camera)
                stats = {k: np.asarray(v).tolist()
                         for k, v in (self.splats.last_stats or {}).items()}
            stats["pos"] = [round(float(v), 3) for v in self.camera.position]
            stats["rot"] = [round(float(v), 1) for v in self.camera.rotation]

        return _encode(img, "PNG"), stats

    def render_stream_frame(self):
        """One frame of the continuous loop: apply queued keys, render,
        JPEG-encode (falls back to PNG without PIL). Returns
        (bytes, content_type)."""
        import time

        with self.lock:
            keys, self.pending = self.pending, []
            for k in keys:
                self.apply_key(k)
            # stats only every 10th frame: every device->host fetch is a
            # full round trip, and the ~11 per-frame stat scalars can cost
            # more than the render itself (see Splats.render_camera_u8)
            img = self.splats.render_camera_u8(
                self.camera, fetch_stats=(self.stream_frames % 10 == 0))
            # delivered fps = gap between consecutive frames (render +
            # encode + socket write of the previous one) -- what the
            # browser actually sees
            now = time.perf_counter()
            last = getattr(self, "_last_frame_t", None)
            self._last_frame_t = now
            self.stream_frames += 1
            if last is not None:
                inst = 1.0 / max(now - last, 1e-6)
                self.stream_fps = (inst if self.stream_frames == 2
                                   else 0.9 * self.stream_fps + 0.1 * inst)
            stats = {k: np.asarray(v).tolist()
                     for k, v in (self.splats.last_stats or {}).items()}
            stats["pos"] = [round(float(v), 3)
                            for v in self.camera.position]
            stats["stream_fps"] = round(self.stream_fps, 2)
            stats["stream_frames"] = self.stream_frames
            self.last_stats_json = stats
        try:
            from PIL import Image  # noqa: F401

            return _encode(img, "JPEG"), "image/jpeg"
        except ImportError:  # pragma: no cover
            return _encode(img, "PNG"), "image/png"


def _encode(img, fmt: str) -> bytes:
    from openglgaussiansplattingrenderer_jax.io.png import to_uint8

    arr = to_uint8(np.asarray(img)[..., :3])
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, fmt)
        return buf.getvalue()
    except ImportError:  # pragma: no cover
        import tempfile

        from openglgaussiansplattingrenderer_jax.io.png import save_png

        with tempfile.NamedTemporaryFile(suffix=".png") as f:
            save_png(f.name, arr)
            return open(f.name, "rb").read()


def make_server(splats, camera, port: int = 8000) -> ThreadingHTTPServer:
    state = ViewerState(splats, camera)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(PAGE)
            elif url.path == "/frame":
                key = parse_qs(url.query).get("key", [None])[0]
                png, stats = state.render_png(key)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Stats", json.dumps(stats))
                self.end_headers()
                self.wfile.write(png)
            elif url.path == "/live":
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(LIVE_PAGE)
            elif url.path == "/key":
                key = parse_qs(url.query).get("key", [None])[0]
                if key:
                    with state.lock:
                        state.pending.append(key)
                self.send_response(204)
                self.end_headers()
            elif url.path == "/stats":
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps(state.last_stats_json).encode())
            elif url.path == "/stream":
                # continuous multipart/x-mixed-replace render loop -- the
                # reference's while(!glfwWindowShouldClose) frame loop
                # (main.cpp:52-89), ended by the client disconnecting
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=gsframe")
                self.end_headers()
                max_frames = getattr(server, "stream_max_frames", None)
                n = 0
                try:
                    while max_frames is None or n < max_frames:
                        frame, ctype = state.render_stream_frame()
                        self.wfile.write(b"--gsframe\r\n")
                        self.wfile.write(
                            f"Content-Type: {ctype}\r\n"
                            f"Content-Length: {len(frame)}\r\n\r\n"
                            .encode())
                        self.wfile.write(frame)
                        self.wfile.write(b"\r\n")
                        n += 1
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_response(404)
                self.end_headers()

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.state = state
    return server


def main():  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu", "gpu"])
    ap.add_argument("--no-autotune", action="store_true",
                    help="skip the startup capacity autotune probe")
    args = ap.parse_args()
    if args.platform != "auto":
        import jax

        jax.config.update("jax_platforms", args.platform)

    from openglgaussiansplattingrenderer_jax import Splats
    from openglgaussiansplattingrenderer_jax.camera import default_camera

    splats = Splats(args.scene, args.width, args.height)
    cam = default_camera(args.width, args.height)
    if not args.no_autotune:
        # pin record capacity to the start pose's measured count (+margin);
        # a camera move that overflows it shows up in stats["overflow"]
        splats.autotune_capacity(cam)
    server = make_server(splats, cam, args.port)
    print(f"viewing {args.scene} at http://localhost:{args.port}/ "
          "(request-response; /live streams continuously with measured fps)")
    server.serve_forever()


if __name__ == "__main__":
    main()
