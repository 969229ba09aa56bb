from openglgaussiansplattingrenderer_jax.ops import transforms, projection, binning, sorting, compositing  # noqa: F401
