"""Differentiable 3D Gaussian Splatting renderer in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of
``thomas-chernaik/OpenGLGaussianSplattingRenderer`` (C++17 + OpenGL 4.6 compute
shaders), re-designed for an accelerator (an H100 GPU; tests run on the CPU):

- PLY 3DGS scene loading with activation transforms (ref ``src/Splats.cpp:174-344``)
- quaternion/scale -> 3D covariance (ref ``src/Splats.cpp:414-479``)
- EWA screen-space projection to conics + frustum cull (ref ``shaders/preprocess.glsl``)
- static-shape tile binning with splat duplication (ref ``shaders/preprocess.glsl:157-189``,
  ``shaders/countBins.glsl``, ``shaders/prefixBins.glsl`` -- atomics replaced by
  cumsum + gather, no per-frame host sync)
- depth sort (ref ``src/sort.cpp`` + sort shaders -> ``jax.lax.sort``)
- depth-ordered tile-parallel alpha compositing (ref ``shaders/draw.glsl`` ->
  fused Pallas tile kernel, compiled through Triton, with an analytic
  backward pass)
- CPU golden pipeline for validation (ref ``src/Splats.cpp:599-1188``)
- plus what the reference lacks: gradients to every splat parameter and
  multi-device sharding over a ``jax.sharding.Mesh``.
"""

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.splats import SplatScene, Splats
from openglgaussiansplattingrenderer_jax.render import (
    render,
    render_depth,
    render_stats,
)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "SplatScene",
    "Splats",
    "render",
    "render_depth",
    "render_stats",
    "__version__",
]
