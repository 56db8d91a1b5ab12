"""Apply a unary stage to N column pairs.

TPU-native counterpart of the reference's MultiColumnAdapter
(multi-column-adapter/MultiColumnAdapter.scala:73-98): takes a base stage
with inputCol/outputCol params, clones it per (input, output) pair and
chains the applications.  The reference rewired params by reflection; here
the Param protocol makes the rewiring a plain `copy(inputCol=…, outputCol=…)`.

The port's copy of `mmlspark_tpu/stages/adapter.py`.
"""

from __future__ import annotations

import os
from typing import Optional

from mmlspark_tpu_torch.core.params import Param, ParamError
from mmlspark_tpu_torch.core.pipeline import (Estimator, JaxTwin,
                                              PipelineModel, PipelineStage,
                                              Transformer, load_stage)
from mmlspark_tpu_torch.core.table import DataTable


class MultiColumnAdapter(JaxTwin, Estimator):
    """Fit/apply `baseStage` once per (inputCol, outputCol) pair."""

    inputCols = Param(None, "input column names", ptype=(list, tuple),
                      required=True)
    outputCols = Param(None, "output column names", ptype=(list, tuple),
                       required=True)

    def __init__(self, base_stage: Optional[PipelineStage] = None,
                 device=None, **kwargs):
        # `device` is a run-time setting of the base stage, which
        # `load_stage` hands on to it through `_load_extra`
        super().__init__(**kwargs)
        self._base = base_stage

    def set_base_stage(self, stage: PipelineStage) -> "MultiColumnAdapter":
        self._base = stage
        return self

    @property
    def base_stage(self) -> Optional[PipelineStage]:
        return self._base

    def _pairs(self) -> list[tuple[str, str]]:
        self._check_required()
        ins, outs = list(self.inputCols), list(self.outputCols)
        if len(ins) != len(outs):
            raise ParamError(
                f"MultiColumnAdapter: {len(ins)} input cols vs "
                f"{len(outs)} output cols")
        return list(zip(ins, outs))

    def _clone_base(self, in_col: str, out_col: str) -> PipelineStage:
        if self._base is None:
            raise ParamError("MultiColumnAdapter: base stage not set")
        for p in ("inputCol", "outputCol"):
            if not self._base.has_param(p):
                raise ParamError(
                    f"base stage {type(self._base).__name__} lacks param '{p}'")
        return self._base.copy(inputCol=in_col, outputCol=out_col)

    def fit(self, table: DataTable) -> PipelineModel:
        fitted: list[Transformer] = []
        current = table
        for in_col, out_col in self._pairs():
            stage = self._clone_base(in_col, out_col)
            model = stage.fit(current) if isinstance(stage, Estimator) else stage
            current = model.transform(current)
            fitted.append(model)
        return PipelineModel(fitted)

    def transform(self, table: DataTable) -> DataTable:
        """Convenience direct application when the base is a Transformer."""
        if isinstance(self._base, Estimator):
            raise TypeError("base stage is an Estimator; use fit()")
        current = table
        for in_col, out_col in self._pairs():
            current = self._clone_base(in_col, out_col).transform(current)
        return current

    def _save_extra(self, path: str) -> None:
        if self._base is not None:
            self._base.save(os.path.join(path, "base"))

    def _load_extra(self, path: str, **init_kwargs) -> None:
        base = os.path.join(path, "base")
        self._base = (load_stage(base, **init_kwargs)
                      if os.path.exists(base) else None)
