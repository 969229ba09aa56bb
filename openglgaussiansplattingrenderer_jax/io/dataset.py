"""Posed-image dataset ingestion (NeRF-style ``transforms.json``).

The reference renders pre-trained PLY scenes only; training (the north-star
addition) wants (image, camera) pairs. This module turns the de-facto
standard ``transforms.json`` layout -- ``camera_angle_x`` or per-frame
``fl_x``/``fl_y`` intrinsics plus OpenGL-convention camera-to-world
``transform_matrix`` per frame -- into the camera argument bundles
``trainer.fit_scene`` / ``densify.fit_scene_adaptive`` consume.

Conventions (important):
- ``transform_matrix`` is camera-to-world with the OpenGL camera frame
  (x right, y up, camera looks down -z) -- the original NeRF/Blender
  convention. The renderer's view matrices are world-to-camera in the same
  frame (visible points have negative view z; see ``camera.py``), so
  ``view = inv(c2w)``.
- The EWA clamp in ``ops/projection.py`` keeps the reference's expression
  ``min(limx, max(-limx, x))`` with ``limx = -1.3 * tan_fov`` verbatim
  (``preprocess.glsl:110-116`` parity). It only behaves as a clamp when the
  tan-fov argument is NEGATIVE (the reference's degrees-as-radians Camera
  quirk produces tan(30 rad) = -6.4 for the default 60-degree fov). Bundles
  built here therefore pass ``-tan(fov/2)``: through the verbatim quirk
  expression this recovers exactly the standard 3DGS symmetric
  1.3-tan-fov clamp.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from openglgaussiansplattingrenderer_jax.camera import perspective
from openglgaussiansplattingrenderer_jax.io.png import load_png


def bundle_from_c2w(
    c2w: np.ndarray,
    width: int,
    height: int,
    fl_x: Optional[float] = None,
    fl_y: Optional[float] = None,
    camera_angle_x: Optional[float] = None,
    near: float = 0.1,
    far: float = 10000.0,
) -> Dict[str, np.ndarray]:
    """One (4,4) OpenGL camera-to-world matrix + intrinsics -> the render
    argument bundle {view, vp, focal_x, focal_y, tan_fovx, tan_fovy}.

    Intrinsics: pass focal lengths in pixels (``fl_x``/``fl_y``) or the
    NeRF ``camera_angle_x`` (horizontal fov, radians).
    """
    if fl_x is None:
        if camera_angle_x is None:
            raise ValueError("need fl_x or camera_angle_x")
        fl_x = width / (2.0 * math.tan(camera_angle_x / 2.0))
    if fl_y is None:
        fl_y = fl_x
    c2w = np.asarray(c2w, np.float64).reshape(4, 4)
    view = np.linalg.inv(c2w).astype(np.float32)
    fovy = 2.0 * math.atan(height / (2.0 * fl_y))
    proj = perspective(fovy, width / height, near, far)
    tan_x = width / (2.0 * fl_x)
    tan_y = height / (2.0 * fl_y)
    return {
        "view": view,
        "vp": (proj @ view).astype(np.float32),
        "focal_x": np.float32(fl_x),
        "focal_y": np.float32(fl_y),
        # negative: see module docstring (verbatim-quirk clamp expression)
        "tan_fovx": np.float32(-tan_x),
        "tan_fovy": np.float32(-tan_y),
        "width": int(width),
        "height": int(height),
    }


def load_transforms(
    path: str,
    image_dir: Optional[str] = None,
    load_images: bool = True,
) -> Tuple[List[Dict[str, np.ndarray]], List[Optional[np.ndarray]]]:
    """Load a ``transforms.json`` dataset.

    Returns (bundles, images): per frame, the camera bundle and the target
    image as float32 (H, W, 3) in [0, 1] (alpha dropped; None when
    ``load_images`` is False or the file is missing). ``image_dir``
    defaults to the json's directory; NeRF ``file_path`` entries without an
    extension get ``.png``.
    """
    with open(path) as f:
        meta = json.load(f)
    base = image_dir or os.path.dirname(os.path.abspath(path))
    w = meta.get("w")
    h = meta.get("h")
    bundles, images = [], []
    for fr in meta["frames"]:
        img = None
        fp = fr.get("file_path", "")
        if load_images and fp:
            p = os.path.join(base, fp)
            if not os.path.splitext(p)[1]:
                p += ".png"
            if os.path.exists(p):
                arr = load_png(p)              # float32 (H, W, C) in [0, 1]
                img = arr[..., :3]
        fw = int(fr.get("w", w or (img.shape[1] if img is not None else 0)))
        fh = int(fr.get("h", h or (img.shape[0] if img is not None else 0)))
        if not fw or not fh:
            raise ValueError(f"frame {fp!r}: no resolution in json or image")
        bundles.append(bundle_from_c2w(
            np.asarray(fr["transform_matrix"], np.float64), fw, fh,
            fl_x=fr.get("fl_x", meta.get("fl_x")),
            fl_y=fr.get("fl_y", meta.get("fl_y")),
            camera_angle_x=fr.get("camera_angle_x",
                                  meta.get("camera_angle_x"))))
        images.append(img)
    return bundles, images


def save_transforms(path: str, bundles: List[Dict[str, np.ndarray]],
                    file_paths: List[str]) -> None:
    """Write a ``transforms.json`` for bundles (tests / dataset export)."""
    frames = []
    for b, fp in zip(bundles, file_paths):
        c2w = np.linalg.inv(np.asarray(b["view"], np.float64))
        frames.append({
            "file_path": fp,
            "transform_matrix": c2w.tolist(),
            "fl_x": float(b["focal_x"]),
            "fl_y": float(b["focal_y"]),
            "w": int(b["width"]),
            "h": int(b["height"]),
        })
    with open(path, "w") as f:
        json.dump({"frames": frames}, f, indent=1)
