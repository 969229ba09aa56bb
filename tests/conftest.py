"""Test harness config: the CPU with 8 virtual devices.

Multi-device code is exercised on an XLA-simulated 8-device host mesh
(SURVEY.md section 5, race detection row); the Pallas kernels run in the
interpreter there. Tests marked ``gpu`` need the card and skip without it;
on a GPU machine run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

# XLA_FLAGS is read lazily at CPU-client creation, so this still applies.
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from openglgaussiansplattingrenderer_jax.io import ply as ply_io  # noqa: E402
from openglgaussiansplattingrenderer_jax.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_sessionstart(session):
    if jax.default_backend() == "cpu":
        assert jax.device_count() == 8, "tests expect 8 virtual CPU devices"


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The GPU, for tests of the compiled kernels; skips without one."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu -m gpu")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def single_item_ply(tmp_path_factory):
    """The reference's single-Gaussian fixture ``testSingleItem.ply``,
    written from its analytic values (``io.ply.single_splat_scene``)."""
    s = ply_io.single_splat_scene()
    path = str(tmp_path_factory.mktemp("ply") / "testSingleItem.ply")
    ply_io.save_ply(path, s["means"], s["quats"], s["scales"],
                    s["opacities"], s["colors"])
    return path
