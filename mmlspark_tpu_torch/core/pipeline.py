"""Pipeline kernel: PipelineStage / Transformer / Estimator / Pipeline with
save/load (the port's copy of `mmlspark_tpu/core/pipeline.py`).

Persistence layout per stage directory, as in the JAX package:
    stage.json   {"class": "pkg.mod.Class", "uid": ..., "params": {...}}
    extra/       stage-specific payload via the _save_extra/_load_extra hooks

Stages move between the packages.  `load_stage` reads a recorded
`mmlspark_tpu.<path>` class as the port's `mmlspark_tpu_torch.<path>` (by
string: the JAX package is never imported).  A stage whose class sets
`saved_class` records that path instead of its own: the port's `TPUModel`,
`Pipeline` and `PipelineModel` record the JAX package's classes, whose
params and `extra/` layout they share, so the JAX package loads them as
its own.  Stages without a JAX twin of the same layout record their own
path.  A port stage that mixes in `JaxTwin` records the class of the same
name at the same module path in the JAX package.
"""

from __future__ import annotations

import importlib
import inspect
import itertools
import json
import os

from typing import Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.params import Param, Params
from mmlspark_tpu_torch.core.table import DataTable

_uid_counters = itertools.count()

_JAX_ROOT, _PORT_ROOT = "mmlspark_tpu", "mmlspark_tpu_torch"

# Per-row error policy for row-wise transforms: "fail" raises on the first
# bad row (the default), "skip" drops bad rows, "column" keeps every row
# and records the error message in an `<output>_error` object column.
ON_ERROR_POLICIES = ("fail", "skip", "column")


def check_on_error(policy: str) -> str:
    """Validate an on_error policy value (shared by stages and readers)."""
    if policy not in ON_ERROR_POLICIES:
        raise ValueError(
            f"on_error must be one of {ON_ERROR_POLICIES}, got {policy!r}")
    return policy


def record_skipped_rows(stage: str, count: int,
                        reason: str = "on_error=skip") -> None:
    """Make an `on_error='skip'` row drop visible: the
    `rows.skipped_on_error` counter, a cat=resilience trace event and a
    warning."""
    if count <= 0:
        return
    from mmlspark_tpu_torch.observe.logging import get_logger
    from mmlspark_tpu_torch.observe.metrics import inc_counter
    from mmlspark_tpu_torch.observe.trace import trace_event
    inc_counter("rows.skipped_on_error", float(count))
    trace_event("rows.skipped", cat="resilience", stage=stage,
                rows=int(count), reason=reason)
    get_logger("core").warning("%s: skipped %d row(s) (%s)", stage,
                               count, reason)


def _fresh_uid(cls_name: str) -> str:
    return f"{cls_name}_{next(_uid_counters):04d}"


class PipelineStage(Params):
    """Base of all pipeline stages; adds uid + persistence to Params."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.uid = _fresh_uid(type(self).__name__)

    def __init_subclass__(cls, **kwargs):
        # every stage's fit/transform is wrapped for the opt-in stage timer
        # (observe/timing.py): one contextvar check when inactive.
        # Wrapping at class creation covers stages defined outside the
        # framework too.
        super().__init_subclass__(**kwargs)
        from mmlspark_tpu_torch.observe.timing import instrument_stage_method
        for method in ("fit", "transform"):
            fn = cls.__dict__.get(method)
            if fn is not None and not getattr(
                    fn, "__mmlspark_instrumented__", False):
                setattr(cls, method, instrument_stage_method(method, fn))

    # the class path stage.json records when it is not the stage's own
    # (module docstring)
    saved_class: Optional[str] = None

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        cls = type(self)
        payload = {
            "class": (self.saved_class
                      or f"{cls.__module__}.{cls.__qualname__}"),
            "uid": self.uid,
            "params": {k: _param_to_json(v)
                       for k, v in self.param_values(set_only=True).items()},
        }
        with open(os.path.join(path, "stage.json"), "w") as f:
            json.dump(payload, f, indent=1)
        extra = os.path.join(path, "extra")
        os.makedirs(extra, exist_ok=True)
        self._save_extra(extra)

    @classmethod
    def load(cls, path: str, **init_kwargs) -> "PipelineStage":
        stage = load_stage(path, **init_kwargs)
        if not isinstance(stage, cls):
            raise TypeError(
                f"{path} holds {type(stage).__name__}, not {cls.__name__}")
        return stage

    def _save_extra(self, path: str) -> None:  # override for array state
        pass

    def _load_extra(self, path: str, **init_kwargs) -> None:
        """Load the payload `_save_extra` wrote; `init_kwargs` are the
        run-time settings `load_stage` gave the constructor."""

    def __repr__(self):
        set_params = ", ".join(f"{k}={v!r}" for k, v in self._paramMap.items())
        return f"{type(self).__name__}({set_params})"


class JaxTwin:
    """Mixin of a port stage whose JAX twin lies at the same module path
    under `mmlspark_tpu` with the same params and `extra/` layout: the
    stage records that class, so the JAX package loads it as its own.
    A subclass defined outside the port records its own path."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        root, _, rest = cls.__module__.partition(".")
        cls.saved_class = (f"{_JAX_ROOT}.{rest}.{cls.__qualname__}"
                           if root == _PORT_ROOT else None)


def port_class_path(path: str) -> str:
    """A recorded class path as the port reads it: `mmlspark_tpu.<rest>`
    becomes `mmlspark_tpu_torch.<rest>`; any other path is kept."""
    root, dot, rest = path.partition(".")
    return f"{_PORT_ROOT}{dot}{rest}" if root == _JAX_ROOT else path


def load_stage(path: str, **init_kwargs) -> PipelineStage:
    """Load any saved stage, by either package, dispatching on the
    recorded class path (`port_class_path`).  `init_kwargs` go to the
    stage's constructor and its `_load_extra` (a stage that holds stages
    passes them on to each): run-time settings that are not params and
    are not saved, such as a model stage's `device`; the constructor
    gets those it names (a stage that runs nothing on a device takes
    none)."""
    with open(os.path.join(path, "stage.json")) as f:
        payload = json.load(f)
    module_name, _, qualname = port_class_path(payload["class"]).rpartition(
        ".")
    cls = importlib.import_module(module_name)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    named = inspect.signature(cls.__init__).parameters
    stage = cls(**{k: v for k, v in init_kwargs.items() if k in named})
    stage._paramMap = {}
    stage.uid = payload["uid"]
    for k, v in payload["params"].items():
        stage.set(k, _param_from_json(v))
    stage._load_extra(os.path.join(path, "extra"), **init_kwargs)
    return stage


def _param_to_json(v):
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, tuple):
        return list(v)
    return v


def _param_from_json(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"])
    return v


class Transformer(PipelineStage):
    """A stateless table -> table mapping."""

    on_error = Param(
        "fail", "per-row error policy for row-wise transforms: 'fail' "
        "raises on the first bad row, 'skip' drops it, 'column' keeps the "
        "row and records the message in an '<output>_error' column",
        ptype=str, domain=ON_ERROR_POLICIES)

    def transform(self, table: DataTable) -> DataTable:
        raise NotImplementedError

    def __call__(self, table: DataTable) -> DataTable:
        return self.transform(table)


class Estimator(PipelineStage):
    """Fits on a table, producing a Transformer (the "Model")."""

    def fit(self, table: DataTable) -> Transformer:
        raise NotImplementedError


class Evaluator(Transformer):
    """A transformer that computes metric tables."""


class Pipeline(Estimator):
    """Sequence of stages; fit() fits estimators in order, each on the
    table the stages before it transformed."""

    saved_class = f"{_JAX_ROOT}.core.pipeline.Pipeline"

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None,
                 device=None, **kwargs):
        # `device` is a run-time setting of the stages it holds, which
        # `load_stage` hands on to them through `_load_extra`
        super().__init__(**kwargs)
        self._stages: list[PipelineStage] = list(stages or [])

    def get_stages(self) -> list[PipelineStage]:
        return list(self._stages)

    def set_stages(self, stages: Sequence[PipelineStage]) -> "Pipeline":
        self._stages = list(stages)
        return self

    def fit(self, table: DataTable) -> "PipelineModel":
        fitted: list[Transformer] = []
        current = table
        for i, stage in enumerate(self._stages):
            if isinstance(stage, Estimator):
                model = stage.fit(current)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"stage {i} ({stage!r}) is neither Estimator "
                                f"nor Transformer")
            if i < len(self._stages) - 1:
                current = model.transform(current)
            fitted.append(model)
        return PipelineModel(fitted)

    def _save_extra(self, path: str) -> None:
        _save_stage_list(path, self._stages)

    def _load_extra(self, path: str, **init_kwargs) -> None:
        self._stages = _load_stage_list(path, **init_kwargs)


class PipelineModel(Transformer):
    """The fitted pipeline: applies each stage's transform in order."""

    saved_class = f"{_JAX_ROOT}.core.pipeline.PipelineModel"

    def __init__(self, stages: Optional[Sequence[Transformer]] = None,
                 device=None, **kwargs):
        # `device` is a run-time setting of the stages it holds, which
        # `load_stage` hands on to them through `_load_extra`
        super().__init__(**kwargs)
        self._stages: list[Transformer] = list(stages or [])

    def get_stages(self) -> list[Transformer]:
        return list(self._stages)

    def transform(self, table: DataTable) -> DataTable:
        current = table
        for stage in self._stages:
            current = stage.transform(current)
        return current

    def _save_extra(self, path: str) -> None:
        _save_stage_list(path, self._stages)

    def _load_extra(self, path: str, **init_kwargs) -> None:
        self._stages = _load_stage_list(path, **init_kwargs)


def _save_stage_list(path: str, stages: Sequence[PipelineStage]) -> None:
    with open(os.path.join(path, "stages.json"), "w") as f:
        json.dump({"count": len(stages)}, f)
    for i, stage in enumerate(stages):
        stage.save(os.path.join(path, f"stage_{i:03d}"))


def _load_stage_list(path: str, **init_kwargs) -> list:
    with open(os.path.join(path, "stages.json")) as f:
        count = json.load(f)["count"]
    return [load_stage(os.path.join(path, f"stage_{i:03d}"), **init_kwargs)
            for i in range(count)]
