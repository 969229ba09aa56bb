from openglgaussiansplattingrenderer_jax.parallel.sharded import (  # noqa: F401
    make_mesh,
    pad_scene_for_mesh,
    render_sharded,
    sharded_train_step,
)
from openglgaussiansplattingrenderer_jax.parallel.mesh2d import (  # noqa: F401
    make_2d_train_step,
    make_mesh2d,
)
