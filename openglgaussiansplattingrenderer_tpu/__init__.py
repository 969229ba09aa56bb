"""Former name of ``openglgaussiansplattingrenderer_jax``: importing it, or
any of its submodules, returns that package's modules."""

from openglgaussiansplattingrenderer_jax.utils.alias import install

install(__name__, "openglgaussiansplattingrenderer_jax")
