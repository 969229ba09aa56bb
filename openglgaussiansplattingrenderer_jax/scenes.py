"""The seeded synthetic scenes the benchmark and the on-card checks render.

- flagship: bike-big.ply's splat count (3,616,103, reference
  ``tests/plyParseTests.cpp:69``) at the reference's default 1024x512
  (``include/Camera.h:55,62``), in two statistics: a uniform cloud and a
  clustered, heavy-tailed one that models real SfM captures.
- train: 1M splats at 1920x1080, sized so a splat covers ~2-4 tiles.
- gate: 10k splats at 512x512, small enough for the jnp compositor's
  autodiff (the gradient oracle).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.render import camera_args

FLAG_SPLATS = 3_616_103
FLAG_W, FLAG_H = 1024, 512
TRAIN_SPLATS = 1_000_000
TRAIN_W, TRAIN_H = 1920, 1080
GATE_SPLATS = 10_000
GATE_W = GATE_H = 512


def to_params(scene) -> Dict[str, jnp.ndarray]:
    return {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}


def flagship_scene(kind: str, n: int = FLAG_SPLATS):
    if kind == "uniform":
        return ply_io.make_synthetic_scene(n, seed=99, extent=3.0,
                                           log_scale_range=(-5.8, -3.6))
    if kind == "clustered":
        return ply_io.make_clustered_scene(n, seed=7, extent=3.0)
    raise ValueError(f"unknown flagship scene {kind!r}")


def train_scene(n: int = TRAIN_SPLATS):
    return ply_io.make_synthetic_scene(n, seed=42, extent=3.0,
                                       log_scale_range=(-5.5, -3.2))


def gate_scene(n: int = GATE_SPLATS):
    return ply_io.make_synthetic_scene(n, seed=7, extent=2.5)


def camera(width: int, height: int, z: float = -8.0) -> Camera:
    return Camera(0.0, 0.0, z, width=width, height=height)


def camera_tuple(cam: Camera) -> Tuple:
    """(view, vp, focal_x, focal_y, tan_fovx, tan_fovy) device arguments of
    ``render.render_arrays``."""
    a = camera_args(cam)
    return (jnp.asarray(a["view"]), jnp.asarray(a["vp"]),
            jnp.float32(a["focal_x"]), jnp.float32(a["focal_y"]),
            jnp.float32(a["tan_fovx"]), jnp.float32(a["tan_fovy"]))


def config(width: int, height: int, **overrides) -> RenderConfig:
    """32-px tiles, the production grid."""
    return RenderConfig.for_resolution(width, height, tile_px=32, **overrides)


def with_capacity(cfg: RenderConfig, capacity: int) -> RenderConfig:
    return dataclasses.replace(cfg, capacity_records=int(capacity))

