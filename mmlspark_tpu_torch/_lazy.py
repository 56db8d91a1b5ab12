"""Lazy package exports (PEP 562): a package's names resolve on first
use, so importing a package imports torch only once a name that needs it
is used.  A data-service worker process (data/service/worker.py) imports
only the host-side modules its graph runs and starts without loading
torch."""

from __future__ import annotations

import importlib
import sys


def lazy_exports(package: str, exports: dict) -> tuple:
    """`exports` maps each lazily exported name to the module that defines
    it.  Returns the package's (`__getattr__`, `__dir__`): a name resolves
    on first access and is then cached in the package's namespace; any
    other public name resolves as a submodule (`package.config`)."""
    def __getattr__(name: str):
        module = exports.get(name)
        if module is not None:
            value = getattr(importlib.import_module(module), name)
            setattr(sys.modules[package], name, value)
            return value
        if not name.startswith("_"):
            try:
                return importlib.import_module(f"{package}.{name}")
            except ModuleNotFoundError as e:
                if e.name != f"{package}.{name}":
                    raise
        raise AttributeError(
            f"module {package!r} has no attribute {name!r}")

    def __dir__() -> list:
        return sorted(set(vars(sys.modules[package])) | set(exports))
    return __getattr__, __dir__
