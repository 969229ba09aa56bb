from openglgaussiansplattingrenderer_jax.ops.pallas import composite  # noqa: F401
