"""Measured streamed-viewer fps.

Starts the interactive viewer server on the device with a 100k-splat
synthetic scene (capacity autotuned on startup, as `viewer.interactive
main()` does), pulls N frames from the continuous `/stream` loop over
HTTP, and reports the server-measured delivered fps from `/stats` -- the
analogue of the reference's per-frame GL_TIMESTAMP prints
(main.cpp:60-77), but measured at the delivery boundary. The server
listens on a free localhost port for the run only.

    python scripts/viewer_fps_bench.py        # VIEWER_* environment below
"""

import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_SPLATS = int(os.environ.get("VIEWER_SPLATS", "100000"))
W = int(os.environ.get("VIEWER_W", "1024"))
H = int(os.environ.get("VIEWER_H", "512"))
FRAMES = int(os.environ.get("VIEWER_FRAMES", "60"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from openglgaussiansplattingrenderer_jax import Camera, Splats
    from openglgaussiansplattingrenderer_jax.io import ply as ply_io
    from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache
    from openglgaussiansplattingrenderer_jax.viewer import interactive

    enable_compile_cache()
    log(f"device: {jax.devices()[0]}")

    sc = ply_io.make_synthetic_scene(NUM_SPLATS, seed=5, extent=2.5)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene.ply")
        ply_io.save_ply(path, sc["means"], sc["quats"], sc["scales"],
                        sc["opacities"], sc["colors"])
        splats = Splats(path, W, H)
    cam = Camera(0.0, 0.0, -6.0, width=W, height=H)
    splats.autotune_capacity(cam)
    log(f"capacity autotuned: {splats.cfg.capacity_records} records")

    # ---- render-bound fps: the device render + u8 host fetch alone (each
    # call returns a host array, so it waits for the device) -- no JPEG
    # encode, no socket. The stream below additionally pays encode + HTTP.
    splats.render_camera_u8(cam, fetch_stats=False)   # compile + warm
    t0 = time.perf_counter()
    n_r = 30
    for _ in range(n_r):
        splats.render_camera_u8(cam, fetch_stats=False)
    render_ms = (time.perf_counter() - t0) / n_r * 1000
    log(f"render-only (device render + u8 fetch): {render_ms:.1f} ms/frame "
        f"({1000 / render_ms:.2f} fps)")

    srv = interactive.make_server(splats, cam, port=0)
    srv.stream_max_frames = FRAMES
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]

    # warm the compile with one /frame request, then pull the stream
    urllib.request.urlopen(f"http://127.0.0.1:{port}/frame",
                           timeout=600).read()
    # a queued key exercises the movement path inside the stream loop too
    urllib.request.urlopen(f"http://127.0.0.1:{port}/key?key=d",
                           timeout=30).read()
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/stream",
                                  timeout=600).read()
    n_frames = body.count(b"--gsframe")
    stats = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=30).read())
    srv.shutdown()
    srv.server_close()

    print(json.dumps({
        "device_kind": jax.devices()[0].device_kind,
        "splats": NUM_SPLATS, "res": f"{W}x{H}",
        "frames_delivered": n_frames,
        "stream_fps": stats["stream_fps"],
        "render_only_ms": render_ms,
        "render_only_fps": 1000 / render_ms,
        "records": stats.get("num_records"),
        "capacity": splats.cfg.capacity_records,
    }), flush=True)


if __name__ == "__main__":
    main()
