"""Short import alias for openglgaussiansplattingrenderer_jax."""

from openglgaussiansplattingrenderer_jax import *  # noqa: F401,F403
from openglgaussiansplattingrenderer_jax import (  # noqa: F401
    camera, config, golden, render, splats,
)
from openglgaussiansplattingrenderer_jax import io, ops  # noqa: F401
