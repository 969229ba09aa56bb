"""Where the program runs: the one platform decision and the compile cache.

The Pallas kernels run compiled through Triton on a GPU and in the Pallas
interpreter on the CPU (which is how the test suite drives them). There is
no third option and no fallback: on any other platform, or when the GPU is
missing, the kernels refuse to run instead of continuing somewhere slower.
"""

from __future__ import annotations

import os

import jax

# The checkout's root: the compile cache lives beside the package.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def pallas_interpret(platform: str | None = None) -> bool:
    """True when Pallas kernels must run in the interpreter.

    ``cpu`` -> interpreter (tests only); ``gpu`` -> compiled Triton; any
    other platform raises. ``platform`` defaults to JAX's default device.
    """
    platform = platform or jax.devices()[0].platform
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"the Pallas kernels run compiled on 'gpu' or interpreted on 'cpu'; "
        f"platform {platform!r} has neither")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
    sets nothing. Otherwise the cache is ``.jax_cache/`` in the checkout (a
    fixed path: the path is part of the cache key). Returns the directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR
