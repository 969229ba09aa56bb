"""A package's former import name, kept so code written against it runs.

``install(old, new)`` makes ``import old`` and ``import old.x.y`` return the
very module objects of ``new`` and ``new.x.y``: one module each, so classes,
caches and ``isinstance`` checks are shared between the two names.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def __init__(self, old: str, new: str):
        self.old, self.new = old, new
        self.specs = {}

    def find_spec(self, name, path=None, target=None):
        if name.startswith(self.old + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(self.new + spec.name[len(self.old):])
        self.specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system set the alias's spec on the shared module; give
        # the module its own back
        module.__spec__ = self.specs.pop(module.__spec__.name)


def install(old: str, new: str) -> None:
    sys.meta_path.insert(0, _Alias(old, new))
    sys.modules[old] = importlib.import_module(new)
