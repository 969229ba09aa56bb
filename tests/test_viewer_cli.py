"""Offline viewer and CLI smoke tests (the display-path analogue)."""

import os
import subprocess
import sys

import numpy as np

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.splats import SplatScene
from openglgaussiansplattingrenderer_jax.viewer import offline

CFG = RenderConfig(use_pallas=False, chunk=32, max_per_tile=128,
                   dup_capacity_factor=32.0)


def _scene_file(tmp_path, n=40):
    s = ply_io.make_synthetic_scene(n, seed=9, extent=1.5)
    p = str(tmp_path / "scene.ply")
    ply_io.save_ply(p, s["means"], s["quats"], s["scales"], s["opacities"],
                    s["colors"])
    return p


def test_orbit_renders_frames(tmp_path):
    scene = SplatScene.from_ply(_scene_file(tmp_path))
    out = str(tmp_path / "frames")
    summary = offline.render_orbit(scene, out, radius=4.0, num_frames=3,
                                   cfg=CFG, width=64, height=64, verbose=False)
    files = sorted(os.listdir(out))
    assert files == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    assert summary["frames"] == 3 and summary["mean_ms"] > 0


def test_render_cli_single_frame(tmp_path):
    scene = _scene_file(tmp_path)
    out = str(tmp_path / "out.png")
    r = subprocess.run(
        [sys.executable, "scripts/render_cli.py", scene, "-o", out,
         "--width", "64", "--height", "64", "--pos", "0", "0", "-4",
         "--rot", "0", "0", "0", "--no-pallas", "--chunk", "32",
         "--capacity-factor", "32", "--stats", "--platform", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
    assert "loaded 40 splats" in r.stdout
    assert "num_records" in r.stdout


def test_render_cli_q16(tmp_path):
    """--q16 routes through the packed-payload inference sort (Pallas path
    in interpret mode on CPU) and still writes a frame."""
    scene = _scene_file(tmp_path)
    out = str(tmp_path / "out_q16.png")
    r = subprocess.run(
        [sys.executable, "scripts/render_cli.py", scene, "-o", out,
         "--width", "64", "--height", "64", "--pos", "0", "0", "-4",
         "--rot", "0", "0", "0", "--q16", "--chunk", "32",
         "--capacity-factor", "32", "--stats", "--platform", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
    assert "num_records" in r.stdout


def test_render_cli_golden(tmp_path):
    scene = _scene_file(tmp_path, n=10)
    out = str(tmp_path / "gold.png")
    r = subprocess.run(
        [sys.executable, "scripts/render_cli.py", scene, "-o", out, "--golden",
         "--width", "64", "--height", "64", "--pos", "0", "0", "-4",
         "--rot", "0", "0", "0", "--platform", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
