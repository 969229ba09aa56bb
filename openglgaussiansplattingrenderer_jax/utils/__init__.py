from openglgaussiansplattingrenderer_jax.utils.timing import (  # noqa: F401
    FrameTimer,
    time_stages,
)
