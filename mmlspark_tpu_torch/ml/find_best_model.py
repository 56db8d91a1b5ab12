"""Model selection over one evaluation dataset (the port of
`mmlspark_tpu/ml/find_best_model.py`; the ranking is numpy on the host,
as there, and the candidates score on their own devices).

Counterpart of find-best-model (FindBestModel.scala:68-331):
score each candidate model on the eval table, compare on the chosen metric
with the right direction (higher-is-better for accuracy/precision/recall/
AUC/r2, lower for mse/rmse/mae), and return a BestModel exposing the
winner plus the all-models comparison table and the winner's ROC.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import (Estimator, JaxTwin,
                                              Transformer, load_stage)
from mmlspark_tpu_torch.core.schema import SchemaConstants
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.ml.statistics import (ACCURACY, AUC, MAE, METRIC_TO_COLUMN,
                                        MSE, PRECISION, R2, RECALL, RMSE,
                                        ComputeModelStatistics,
                                        _label_indices, _metrics_from_confusion,
                                        _schema_info, confusion_matrix_batch)

_LOWER_IS_BETTER = {MSE, RMSE, MAE}


class FindBestModel(JaxTwin, Estimator):
    """Pick the best of several trained models on an eval table."""

    evaluationMetric = Param(ACCURACY, "metric to rank models by", ptype=str,
                             domain=(ACCURACY, PRECISION, RECALL, AUC,
                                     MSE, RMSE, R2, MAE))

    def __init__(self, models: Optional[list[Transformer]] = None, **kw):
        super().__init__(**kw)
        self._models = list(models or [])

    def set_models(self, models: list[Transformer]) -> "FindBestModel":
        self._models = list(models)
        return self

    def fit(self, table: DataTable) -> "BestModel":
        if not self._models:
            raise ValueError("FindBestModel: no models to compare")
        metric = self.evaluationMetric
        col_name = METRIC_TO_COLUMN[metric]
        lower = metric in _LOWER_IS_BETTER

        scored_tables = [model.transform(table) for model in self._models]
        rows = self._batched_rows(scored_tables)
        if rows is None:
            rows = [self._serial_row(model, scored)
                    for model, scored in zip(self._models, scored_tables)]
        best = None
        for i, (model, row) in enumerate(zip(self._models, rows)):
            if col_name not in row:
                raise ValueError(
                    f"metric '{metric}' not produced for model "
                    f"{type(model).__name__} (wrong model kind?)")
            value = float(row[col_name])
            if best is None or (value < best[1] if lower else value > best[1]):
                best = (model, value, i)
        best_model, best_value, best_i = best
        # the winner alone takes the full evaluator pass (its metrics
        # table, confusion matrix, and ROC back the BestModel surface);
        # the non-winners were ranked from the batched confusion matrices
        best_result = ComputeModelStatistics().evaluate(
            scored_tables[best_i])
        # models of different arities emit different metric columns (binary
        # AUC vs multiclass macro_*): take the union, NaN where absent
        all_cols: list[str] = []
        for r in rows:
            for k in r:
                if k not in all_cols:
                    all_cols.append(k)
        table_cols = {c: [r.get(c, np.nan) for r in rows] for c in all_cols}
        return BestModel(best_model, best_result.metrics,
                         DataTable(table_cols),
                         roc=best_result.roc,
                         evaluationMetric=metric)

    def _serial_row(self, model: Transformer, scored: DataTable) -> dict:
        """One full evaluator pass (the pre-batched path, kept for
        regression models and mixed-arity candidate sets)."""
        metrics = ComputeModelStatistics().evaluate(scored).metrics
        return {"model_name": model.uid,
                **{c: float(metrics[c][0]) for c in metrics.columns}}

    def _batched_rows(self, scored_tables: list) -> Optional[list]:
        """Rank every classification candidate from ONE vectorized
        confusion-matrix pass (statistics.confusion_matrix_batch) instead
        of a per-model evaluator round trip — the redundant host work the
        serial loop paid between fits.  Returns None (caller falls back
        to the serial path) when the candidates are not uniformly
        same-arity classifiers: regression metrics and mixed
        binary/multiclass sets keep the per-model evaluator."""
        ys, yps, probs_list, n_cls = [], [], [], set()
        for scored in scored_tables:
            try:
                kind, label, scores, scored_labels, probs = _schema_info(
                    scored, None)
            except ValueError:
                return None
            if kind != SchemaConstants.CLASSIFICATION_KIND:
                return None
            pred_col = scored_labels or scores
            try:
                y = _label_indices(scored, label, pred_col)
            except ValueError:
                return None
            yp = np.asarray(scored[pred_col], np.float64).astype(np.int64)
            levels = scored.meta(pred_col).categorical
            n_cls.add(max(levels.num_levels if levels is not None else 0,
                          int(max(y.max(initial=0), yp.max(initial=0))) + 1,
                          2))
            ys.append(y)
            yps.append(yp)
            probs_list.append(
                np.asarray(scored[probs], np.float64)
                if probs is not None and probs in scored else None)
        if len(n_cls) != 1 or len({len(y) for y in ys}) != 1:
            return None  # mixed arities / row counts: evaluate per model
        k = n_cls.pop()
        cms = confusion_matrix_batch(np.stack(ys), np.stack(yps),
                                     n_classes=k)
        rows = []
        for model, cm, y, p in zip(self._models, cms, ys, probs_list):
            out, _ = _metrics_from_confusion(cm, y, p)
            rows.append({"model_name": model.uid, **out})
        return rows


class BestModel(JaxTwin, Transformer):
    """The chosen model + comparison tables (FindBestModel.scala:174-227)."""

    evaluationMetric = Param(ACCURACY, "metric models were ranked by", ptype=str)

    def __init__(self, best_model: Optional[Transformer] = None,
                 best_metrics: Optional[DataTable] = None,
                 all_model_metrics: Optional[DataTable] = None,
                 roc: Optional[tuple] = None, device=None, **kw):
        # `device` is a run-time setting of the best model, which
        # `load_stage` hands on to it through `_load_extra`
        super().__init__(**kw)
        self._best = best_model
        self._best_metrics = best_metrics
        self._all_metrics = all_model_metrics
        self._roc = roc

    @property
    def best_model(self) -> Transformer:
        return self._best

    def get_evaluation_results(self) -> DataTable:
        return self._best_metrics

    def get_all_model_metrics(self) -> DataTable:
        return self._all_metrics

    def get_roc_curve(self) -> DataTable:
        if self._roc is None:
            raise ValueError("best model produced no binary ROC")
        from mmlspark_tpu_torch.ml.statistics import roc_table
        return roc_table(self._roc)

    def transform(self, table: DataTable) -> DataTable:
        return self._best.transform(table)

    def _save_extra(self, path: str) -> None:
        self._best.save(os.path.join(path, "best"))
        if self._best_metrics is not None:
            self._best_metrics.save(os.path.join(path, "best_metrics"))
        if self._all_metrics is not None:
            self._all_metrics.save(os.path.join(path, "all_metrics"))
        if self._roc is not None:
            np.savez(os.path.join(path, "roc.npz"),
                     fpr=np.asarray(self._roc[0]), tpr=np.asarray(self._roc[1]),
                     thresholds=np.asarray(self._roc[2]))

    def _load_extra(self, path: str, **init_kwargs) -> None:
        self._best = load_stage(os.path.join(path, "best"), **init_kwargs)
        bm = os.path.join(path, "best_metrics")
        am = os.path.join(path, "all_metrics")
        self._best_metrics = DataTable.load(bm) if os.path.exists(bm) else None
        self._all_metrics = DataTable.load(am) if os.path.exists(am) else None
        roc_path = os.path.join(path, "roc.npz")
        if os.path.exists(roc_path):
            z = np.load(roc_path)
            self._roc = (z["fpr"], z["tpr"], z["thresholds"])
        else:
            self._roc = None
