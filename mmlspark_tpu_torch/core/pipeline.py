"""Pipeline kernel: PipelineStage / Transformer with save/load (the port's
copy of the stage contract in `mmlspark_tpu/core/pipeline.py`).

Persistence layout per stage directory, as in the JAX package:
    stage.json   {"class": "pkg.mod.Class", "uid": ..., "params": {...}}
    extra/       stage-specific payload via the _save_extra/_load_extra hooks
"""

from __future__ import annotations

import importlib
import itertools
import json
import os

import numpy as np

from mmlspark_tpu_torch.core.params import Param, Params
from mmlspark_tpu_torch.core.table import DataTable

_uid_counters = itertools.count()

ON_ERROR_POLICIES = ("fail", "skip", "column")


def _fresh_uid(cls_name: str) -> str:
    return f"{cls_name}_{next(_uid_counters):04d}"


class PipelineStage(Params):
    """Base of all pipeline stages; adds uid + persistence to Params."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.uid = _fresh_uid(type(self).__name__)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        cls = type(self)
        payload = {
            "class": f"{cls.__module__}.{cls.__qualname__}",
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

    def _load_extra(self, path: str) -> None:
        pass

    def __repr__(self):
        set_params = ", ".join(f"{k}={v!r}" for k, v in self._paramMap.items())
        return f"{type(self).__name__}({set_params})"


def load_stage(path: str, **init_kwargs) -> PipelineStage:
    """Load any saved stage, dispatching on the recorded class path.
    `init_kwargs` go to the stage's constructor: run-time settings that are
    not params and are not saved, such as a model stage's `device`."""
    with open(os.path.join(path, "stage.json")) as f:
        payload = json.load(f)
    module_name, _, qualname = payload["class"].rpartition(".")
    cls = importlib.import_module(module_name)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    stage = cls(**init_kwargs)
    stage._paramMap = {}
    stage.uid = payload["uid"]
    for k, v in payload["params"].items():
        stage.set(k, _param_from_json(v))
    stage._load_extra(os.path.join(path, "extra"))
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
