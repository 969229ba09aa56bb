from openglgaussiansplattingrenderer_jax.viewer.offline import (  # noqa: F401
    orbit_cameras,
    render_orbit,
    render_frame,
)
from openglgaussiansplattingrenderer_jax.viewer import interactive  # noqa: F401
