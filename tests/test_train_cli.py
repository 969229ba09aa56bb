"""Training CLI smoke test: fit-to-target with densification from the
command line, PLY out, comparison PNG, history JSON."""

import json
import os
import subprocess
import sys

from openglgaussiansplattingrenderer_jax.io import ply as ply_io

import numpy as np
import pytest


@pytest.mark.slow
def test_train_cli_data_parallel(tmp_path):
    s = ply_io.make_synthetic_scene(40, seed=9, extent=1.2)
    s["opacities"] = np.clip(s["opacities"], 0.5, 0.9)
    scene = str(tmp_path / "target.ply")
    ply_io.save_ply(scene, s["means"], s["quats"], s["scales"],
                    s["opacities"], s["colors"])
    out_ply = str(tmp_path / "fitted.ply")
    out_hist = str(tmp_path / "hist.json")
    r = subprocess.run(
        [sys.executable, "scripts/train_cli.py", scene, "-o", out_ply,
         "--out-png", str(tmp_path / "cmp.png"), "--history", out_hist,
         "--platform", "cpu", "--no-pallas", "--width", "64", "--height",
         "64", "--views", "4", "--orbit-radius", "4.0", "--steps", "20",
         "--init-count", "10", "--chunk", "32", "--capacity-factor", "32",
         "--log-every", "10", "--data-parallel", "4"],
        capture_output=True, text=True, timeout=560,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    hist = json.load(open(out_hist))
    assert np.isfinite(hist["final_psnr_view0"])
    back = ply_io.load_splats(out_ply)
    assert back["means"].shape[0] == 10

    # --data-parallel composes with --densify since r4 (ADC on the mesh)
    out_ply2 = str(tmp_path / "fitted_adc.ply")
    out_hist2 = str(tmp_path / "hist_adc.json")
    r2 = subprocess.run(
        [sys.executable, "scripts/train_cli.py", scene, "-o", out_ply2,
         "--out-png", str(tmp_path / "cmp2.png"), "--history", out_hist2,
         "--platform", "cpu", "--no-pallas", "--width", "64", "--height",
         "64", "--views", "4", "--orbit-radius", "4.0", "--steps", "20",
         "--init-count", "10", "--chunk", "32", "--capacity-factor", "32",
         "--log-every", "10", "--data-parallel", "2", "--densify",
         "--capacity", "24", "--densify-interval", "8",
         "--densify-start", "2", "--grad-threshold", "1e-6"],
        capture_output=True, text=True, timeout=560,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r2.returncode == 0, r2.stderr[-2000:]
    hist2 = json.load(open(out_hist2))
    assert hist2["splats"] > 10, "dp densification never grew the set"


@pytest.mark.slow
def test_train_cli_mesh2d(tmp_path):
    s = ply_io.make_synthetic_scene(40, seed=9, extent=1.2)
    s["opacities"] = np.clip(s["opacities"], 0.5, 0.9)
    scene = str(tmp_path / "target.ply")
    ply_io.save_ply(scene, s["means"], s["quats"], s["scales"],
                    s["opacities"], s["colors"])
    out_ply = str(tmp_path / "fitted.ply")
    out_hist = str(tmp_path / "hist.json")
    r = subprocess.run(
        [sys.executable, "scripts/train_cli.py", scene, "-o", out_ply,
         "--out-png", str(tmp_path / "cmp.png"), "--history", out_hist,
         "--platform", "cpu", "--no-pallas", "--width", "64", "--height",
         "64", "--views", "4", "--orbit-radius", "4.0", "--steps", "20",
         "--init-count", "10", "--chunk", "32", "--capacity-factor", "32",
         "--log-every", "10", "--mesh2d", "2x2"],
        capture_output=True, text=True, timeout=560,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    hist = json.load(open(out_hist))
    assert np.isfinite(hist["final_psnr_view0"])
    # splat-axis padding must not leak into the exported PLY
    back = ply_io.load_splats(out_ply)
    assert back["means"].shape[0] == 10

    # --mesh2d composes with --densify since r4 (sharded-global ADC)
    out_ply2 = str(tmp_path / "fitted_adc.ply")
    out_hist2 = str(tmp_path / "hist_adc.json")
    r2 = subprocess.run(
        [sys.executable, "scripts/train_cli.py", scene, "-o", out_ply2,
         "--out-png", str(tmp_path / "cmp2.png"), "--history", out_hist2,
         "--platform", "cpu", "--no-pallas", "--width", "64", "--height",
         "64", "--views", "4", "--orbit-radius", "4.0", "--steps", "20",
         "--init-count", "10", "--chunk", "32", "--capacity-factor", "32",
         "--log-every", "10", "--mesh2d", "2x2", "--densify",
         "--capacity", "24", "--densify-interval", "8",
         "--densify-start", "2", "--grad-threshold", "1e-6"],
        capture_output=True, text=True, timeout=560,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r2.returncode == 0, r2.stderr[-2000:]
    hist2 = json.load(open(out_hist2))
    assert hist2["splats"] > 10, "mesh2d densification never grew the set"

    # malformed / non-positive mesh specs must be refused
    for bad in ("nonsense", "0x4", "-2x4"):
        r3 = subprocess.run(
            [sys.executable, "scripts/train_cli.py", scene, "-o", out_ply,
             "--mesh2d", bad],
            capture_output=True, text=True, timeout=120,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert r3.returncode != 0, bad
        assert "DVxDS" in r3.stderr, bad


@pytest.mark.slow
def test_train_cli_densify_roundtrip(tmp_path):
    s = ply_io.make_synthetic_scene(40, seed=9, extent=1.2)
    s["opacities"] = np.clip(s["opacities"], 0.5, 0.9)
    scene = str(tmp_path / "target.ply")
    ply_io.save_ply(scene, s["means"], s["quats"], s["scales"],
                    s["opacities"], s["colors"])
    out_ply = str(tmp_path / "fitted.ply")
    out_png = str(tmp_path / "cmp.png")
    out_hist = str(tmp_path / "hist.json")
    r = subprocess.run(
        [sys.executable, "scripts/train_cli.py", scene, "-o", out_ply,
         "--out-png", out_png, "--history", out_hist,
         "--platform", "cpu", "--no-pallas", "--width", "64", "--height",
         "64", "--views", "2", "--orbit-radius", "4.0", "--steps", "40",
         "--init-count", "10", "--densify", "--capacity", "24",
         "--densify-interval", "15", "--densify-start", "5",
         "--grad-threshold", "1e-6", "--bf16-grads",
         "--chunk", "32", "--capacity-factor", "32", "--log-every", "20"],
        capture_output=True, text=True, timeout=560,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    for f in (out_ply, out_png, out_hist):
        assert os.path.exists(f), f
    hist = json.load(open(out_hist))
    assert hist["splats"] > 10, "densification never grew the set"
    assert np.isfinite(hist["final_psnr_view0"])
    # the written PLY loads back through the normal loader
    back = ply_io.load_splats(out_ply)
    assert back["means"].shape[0] == hist["splats"]
