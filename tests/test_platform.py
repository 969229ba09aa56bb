"""The one platform decision and the compile-cache helper."""

import jax
import pytest

from openglgaussiansplattingrenderer_jax.utils import platform


@pytest.mark.parametrize("name,interpret", [("cpu", True), ("gpu", False)])
def test_pallas_interpret_per_platform(name, interpret):
    assert platform.pallas_interpret(name) is interpret


@pytest.mark.parametrize("name", ["rocm", "metal"])
def test_pallas_interpret_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match=name):
        platform.pallas_interpret(name)


def test_pallas_interpret_defaults_to_the_device():
    assert platform.pallas_interpret() is (jax.devices()[0].platform == "cpu")


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert platform.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_env_unset(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = platform.enable_compile_cache()
    assert got == platform.CACHE_DIR
    assert got.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
