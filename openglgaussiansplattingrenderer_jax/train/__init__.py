from openglgaussiansplattingrenderer_jax.train.trainer import (  # noqa: F401
    TrainConfig,
    TrainState,
    fit_scene,
    make_train_step,
)
from openglgaussiansplattingrenderer_jax.train import losses  # noqa: F401
from openglgaussiansplattingrenderer_jax.train.densify import (  # noqa: F401
    DensifyConfig,
    densify_and_prune,
    fit_scene_adaptive,
)
