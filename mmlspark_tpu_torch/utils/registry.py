"""Stage discovery: reflection over the port's package (the port of
`mmlspark_tpu/utils/registry.py`).

The counterpart of the reference's JarLoadingUtils
(JarLoadingUtils.scala:115-137): a package walk imports every module
under mmlspark_tpu_torch and collects the PipelineStage subclasses.  The
same registry drives the fuzzing pass over every stage and the generated
API reference (`api_summary`).

It also holds the open registry of int8 forwards by layer class
(`register_quant_wrapper` / `quant_wrapper_for`), keyed here by torch
module classes: `models/definitions.py` registers its `Dense` and `Conv`
with `quant/modules.py`'s fused int8 forwards.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
from typing import Callable, Optional

_SKIP_MODULES = ("mmlspark_tpu_torch.native_loader",)


def _walk_modules():
    import mmlspark_tpu_torch
    for info in pkgutil.walk_packages(mmlspark_tpu_torch.__path__,
                                      prefix="mmlspark_tpu_torch."):
        if info.name in _SKIP_MODULES:
            continue
        yield importlib.import_module(info.name)


def all_stage_classes(concrete_only: bool = True) -> list[type]:
    """Every PipelineStage subclass defined in the package."""
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    seen: dict[str, type] = {}
    for module in _walk_modules():
        for _, obj in inspect.getmembers(module, inspect.isclass):
            if not issubclass(obj, PipelineStage):
                continue
            if not obj.__module__.startswith("mmlspark_tpu_torch"):
                continue
            seen[f"{obj.__module__}.{obj.__qualname__}"] = obj
    out = []
    for cls in seen.values():
        if concrete_only:
            if inspect.isabstract(cls):
                continue
            # base plumbing classes are not user stages
            if cls.__module__ == "mmlspark_tpu_torch.core.pipeline":
                continue
            # underscore-prefixed classes are private bases
            if cls.__qualname__.split(".")[-1].startswith("_"):
                continue
        out.append(cls)
    return sorted(out, key=lambda c: f"{c.__module__}.{c.__qualname__}")


# --------------------------------------------------------------------------
# int8 forwards by layer class (quant/).
#
# Maps a torch layer class to the fused int8 forward that computes what
# the layer computes when its weight is int8 with per-output-channel
# scales.  models/definitions.py registers `Dense` and `Conv`; custom
# layers opt in by registering their own.  The lookup walks the MRO, so
# subclasses of a registered layer inherit its forward.
# --------------------------------------------------------------------------

QUANT_MODULE_WRAPPERS: dict[type, Callable] = {}


def register_quant_wrapper(module_cls: type, wrapper: Callable) -> None:
    """Register the fused int8 forward for a torch layer class (for
    `Dense`: `quant_dense_apply(x, weight_q, scale, bias, dtype)`)."""
    QUANT_MODULE_WRAPPERS[module_cls] = wrapper


def quant_wrapper_for(module_cls: type) -> Optional[Callable]:
    """The registered forward for `module_cls` (MRO-aware), or None."""
    for cls in module_cls.__mro__:
        if cls in QUANT_MODULE_WRAPPERS:
            return QUANT_MODULE_WRAPPERS[cls]
    return None


def api_summary() -> str:
    """Markdown API reference generated from the registry and the param
    docs (the PySparkWrapperGenerator's documentation role,
    PySparkWrapperGenerator.scala:34-91)."""
    from mmlspark_tpu_torch.core.pipeline import Estimator, Transformer
    lines = ["# mmlspark_tpu_torch API reference", ""]
    for cls in all_stage_classes():
        kind = ("Estimator" if issubclass(cls, Estimator)
                else "Transformer" if issubclass(cls, Transformer)
                else "PipelineStage")
        lines.append(f"## {cls.__qualname__} ({kind})")
        lines.append(f"`{cls.__module__}`")
        doc = inspect.getdoc(cls)
        if doc:
            lines.append("")
            lines.append(doc.split("\n\n")[0])
        params = cls.params()
        if params:
            lines.append("")
            lines.append("| param | default | doc |")
            lines.append("|---|---|---|")
            for name, p in sorted(params.items()):
                default = repr(p.default) if p.has_default else "(required)"
                lines.append(f"| `{name}` | `{default}` | {p.doc} |")
        lines.append("")
    lines.extend(_config_summary())
    return "\n".join(lines)


def _config_summary() -> list:
    """The port's MMLSPARK_TPU_* registry as a reference table.  The
    package walk above has imported every module that declares a knob, so
    the registry is whole."""
    from mmlspark_tpu_torch import config
    lines = ["## Configuration registry (`mmlspark_tpu_torch.config`)", "",
             "Every `MMLSPARK_TPU_*` environment variable the port reads, "
             "declared once with its default and doc (`config.describe()` "
             "at run time; precedence: `config.set()` override > "
             "environment > default).", "",
             "| variable | default | doc |", "|---|---|---|"]
    for var in config.describe():
        if not var["declared_by"].startswith("mmlspark_tpu_torch"):
            continue  # test/application declarations made in-process
        doc = " ".join(str(var["doc"]).split())
        lines.append(f"| `{var['name']}` | `{var['default']!r}` | {doc} |")
    lines.append("")
    return lines
