"""Former name of the ``gsplat_jax`` short alias."""

from openglgaussiansplattingrenderer_jax.utils.alias import install

install(__name__, "gsplat_jax")
