"""Offline viewer: render camera paths to PNG sequences.

The display path for a headless accelerator host -- what the reference's GLFW window
+ textured-quad present (``main.cpp:52-89``, ``Splats::display``) becomes
when there is no screen attached to the accelerator. The fly-camera motion
API (``Camera.cpp:121-179``) drives the paths.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import png as png_io
from openglgaussiansplattingrenderer_jax.render import render_stats
from openglgaussiansplattingrenderer_jax.utils.timing import FrameTimer


def orbit_cameras(center, radius: float, num_frames: int,
                  height_offset: float = 0.5, width: int = 1024,
                  height: int = 512, fovy: float = 60.0) -> List[Camera]:
    """Cameras orbiting ``center`` and yawing to face it each frame."""
    cams = []
    cx, cy, cz = (float(v) for v in center)
    for i in range(num_frames):
        a = 2.0 * math.pi * i / num_frames
        x = cx + radius * math.sin(a)
        z = cz - radius * math.cos(a)
        cam = Camera(x, cy + height_offset, z, width=width, height=height,
                     fovy=fovy)
        # yaw so the +z camera axis (its forward, Camera.cpp:121-126) points
        # at the centre; the view convention keeps +position so we orbit the
        # mirrored pose the reference's controls would reach
        cam.set_rotation(0.0, math.degrees(a), 0.0)
        cams.append(cam)
    return cams


def render_frame(scene, camera: Camera, cfg: Optional[RenderConfig] = None,
                 path: Optional[str] = None) -> np.ndarray:
    """Render one frame; optionally save PNG. Returns (H, W, 4) float."""
    image, _ = render_stats(scene, camera, cfg)
    img = np.asarray(image)
    if path:
        png_io.save_png(path, img[..., :3])
    return img


def render_orbit(scene, out_dir: str, center=(0.0, 0.0, 0.0),
                 radius: float = 5.0, num_frames: int = 24,
                 cfg: Optional[RenderConfig] = None, width: int = 512,
                 height: int = 512, verbose: bool = True) -> dict:
    """Render an orbit sequence to ``out_dir/frame_%04d.png``; returns
    frame-timing summary (the reference prints per-frame ms each loop)."""
    os.makedirs(out_dir, exist_ok=True)
    cams = orbit_cameras(center, radius, num_frames, width=width, height=height)
    timer = FrameTimer()
    for i, cam in enumerate(cams):
        timer.start()
        image, _ = render_stats(scene, cam, cfg)
        ms = timer.stop(image)
        png_io.save_png(os.path.join(out_dir, f"frame_{i:04d}.png"),
                        np.asarray(image)[..., :3])
        if verbose:
            print(f"frame {i}: {ms:.1f} ms")
    return timer.summary()
