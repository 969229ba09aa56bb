"""The package's former import names resolve to the package's own modules."""

import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the top-level packages that only install an alias
ALIASES = sorted(
    p.name for p in ROOT.iterdir()
    if (p / "__init__.py").is_file()
    and "utils.alias import install" in (p / "__init__.py").read_text())
PACKAGE = "openglgaussiansplattingrenderer_jax"


def test_both_former_names_are_kept():
    assert len(ALIASES) == 2


@pytest.mark.parametrize("old", ALIASES)
def test_alias_is_the_package(old):
    mod = importlib.import_module(old)
    assert mod is importlib.import_module(mod.__name__)
    assert mod.__name__ in (PACKAGE, "gsplat_jax")
    pkg = importlib.import_module(PACKAGE)
    assert mod.RenderConfig is pkg.RenderConfig
    assert mod.Splats is pkg.Splats


def test_alias_submodules_are_the_package_modules():
    old = next(a for a in ALIASES
               if importlib.import_module(a).__name__ == PACKAGE)
    for sub in ("ops.fastpath", "ops.pallas.composite", "parallel.sharded",
                "train.trainer"):
        got = importlib.import_module(f"{old}.{sub}")
        want = importlib.import_module(f"{PACKAGE}.{sub}")
        assert got is want
        assert got.__spec__.name == f"{PACKAGE}.{sub}"
    fastpath = importlib.import_module(f"{old}.ops.fastpath")
    assert fastpath.render_fast is importlib.import_module(
        f"{PACKAGE}.ops.fastpath").render_fast
