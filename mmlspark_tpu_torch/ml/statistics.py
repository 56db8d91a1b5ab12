"""Model evaluation: aggregate and per-instance statistics (the port's
copy of `mmlspark_tpu/ml/statistics.py`: numpy on the host, as there).

TPU-native counterpart of compute-model-statistics and
compute-per-instance-statistics (ComputeModelStatistics.scala:104-530,
ComputePerInstanceStatistics.scala:36-92).  Scored columns are discovered
through the `mml` metadata protocol (core/schema.py), never by hard-coded
names — the same contract the reference relies on
(ComputeModelStatistics.scala:205-218).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Evaluator, JaxTwin
from mmlspark_tpu_torch.core.schema import (SchemaConstants, find_score_columns,
                                      set_score_column)
from mmlspark_tpu_torch.core.table import DataTable

# metric names (ComputeModelStatistics.scala:26-69)
MSE, RMSE, R2, MAE = "mse", "rmse", "r2", "mae"
AUC, ACCURACY, PRECISION, RECALL = "AUC", "accuracy", "precision", "recall"
ALL_METRICS = "all"
MSE_COL = "mean_squared_error"
RMSE_COL = "root_mean_squared_error"
R2_COL = "R^2"
MAE_COL = "mean_absolute_error"
AVG_ACCURACY = "average_accuracy"
MACRO_RECALL = "macro_averaged_recall"
MACRO_PRECISION = "macro_averaged_precision"

METRIC_TO_COLUMN = {MSE: MSE_COL, RMSE: RMSE_COL, R2: R2_COL, MAE: MAE_COL,
                    AUC: AUC, ACCURACY: ACCURACY, PRECISION: PRECISION,
                    RECALL: RECALL}
CLASSIFICATION_METRICS = {ACCURACY, PRECISION, RECALL, AUC}
REGRESSION_METRICS = {MSE, RMSE, R2, MAE}


def _schema_info(table: DataTable, label_fallback: Optional[str]):
    """Resolve (model_kind, label_col, scores_col, scored_labels_col,
    probabilities_col) from metadata (getSchemaInfo, scala:205-218)."""
    cols = find_score_columns(table)
    if not cols:
        raise ValueError(
            "no scored columns found in table metadata; score the table "
            "with a trained model first")
    C = SchemaConstants
    any_col = next(iter(cols.values()))
    kind = table.meta(any_col).model_kind
    label = cols.get(C.TRUE_LABELS_COLUMN) or label_fallback
    if label is None or label not in table:
        raise ValueError("no true-label column found (metadata or labelCol)")
    return (kind, label, cols.get(C.SCORES_COLUMN),
            cols.get(C.SCORED_LABELS_COLUMN),
            cols.get(C.SCORED_PROBABILITIES_COLUMN))


def _label_indices(table: DataTable, label: str,
                   pred_col: Optional[str]) -> np.ndarray:
    """True labels as class indices.

    At score time the label column may still hold raw values (strings);
    they are mapped through the scored-labels categorical levels carried by
    the trained model (TrainClassifier.scala:253-263), the same resolution
    the reference evaluator performs via metadata.
    """
    arr = table[label]
    own = table.meta(label).categorical
    levels = (table.meta(pred_col).categorical
              if pred_col is not None and pred_col in table else None)
    if own is not None:
        # the label's own encoding is authoritative only if it matches the
        # model's fitted levels; otherwise decode + re-map (same rule as
        # feature columns, assemble.py _categorical_indices)
        if levels is None or list(own.levels) == list(levels.levels):
            return np.asarray(arr, np.int64)
        values = list(own.to_levels(np.asarray(arr, np.int64)))
        idx = levels.to_indices(values).astype(np.int64)
    elif arr.dtype == object or np.issubdtype(arr.dtype, np.str_):
        if levels is None:
            raise ValueError(
                f"label column '{label}' is non-numeric and no levels are "
                "available on the scored labels")
        idx = levels.to_indices(list(arr)).astype(np.int64)
    else:
        vals = np.asarray(arr, np.float64)
        if levels is None:
            return vals.astype(np.int64)
        # raw numeric values: predictions live in fitted-level index space,
        # so map raw values through the levels whenever they match them;
        # only treat values as indices if they can't be raw level values
        uniq = set(np.unique(vals).tolist())
        if uniq <= set(_as_plain(levels.levels)):
            idx = levels.to_indices(vals.tolist()).astype(np.int64)
        elif uniq <= set(range(levels.num_levels)):
            return vals.astype(np.int64)
        else:
            idx = np.full(len(vals), -1, np.int64)
    if (idx < 0).any():
        unseen = sorted({str(v) for v, i in zip(arr, idx) if i < 0})[:5]
        raise ValueError(
            f"label column '{label}' contains values never seen at train "
            f"time: {unseen}; metrics would be silently wrong")
    return idx


def _as_plain(levels) -> list:
    return [float(v) if isinstance(v, (int, float)) and not isinstance(v, bool)
            else v for v in levels]


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     n_classes: Optional[int] = None) -> np.ndarray:
    """Row = true class, column = predicted (scala:461-484)."""
    yt = np.asarray(y_true, np.int64)
    yp = np.asarray(y_pred, np.int64)
    k = n_classes or int(max(yt.max(initial=0), yp.max(initial=0))) + 1
    cm = np.zeros((k, k), np.int64)
    np.add.at(cm, (yt, yp), 1)
    return cm


def roc_curve(y_true: np.ndarray, scores: np.ndarray):
    """(fpr, tpr, thresholds), sweeping the decision threshold."""
    y = np.asarray(y_true, np.float64)
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s, kind="stable")
    y, s = y[order], s[order]
    distinct = np.where(np.diff(s))[0]
    idx = np.concatenate([distinct, [len(y) - 1]])
    tps = np.cumsum(y)[idx]
    fps = (idx + 1) - tps
    P = max(y.sum(), 1e-12)
    N = max(len(y) - y.sum(), 1e-12)
    tpr = np.concatenate([[0.0], tps / P])
    fpr = np.concatenate([[0.0], fps / N])
    thresholds = np.concatenate([[np.inf], s[idx]])
    return fpr, tpr, thresholds


def auc_score(y_true: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(y_true, scores)
    return float(np.trapezoid(tpr, fpr))


@dataclasses.dataclass
class EvalResult:
    """One evaluation, returned as a value (the data the reference logged
    through MetricData, scala:486-521) — the evaluator itself stays
    stateless, so concurrent/repeated use is safe."""

    metrics: DataTable
    confusion_matrix: Optional[np.ndarray] = None
    roc: Optional[tuple] = None  # (fpr, tpr, thresholds)

    def confusion_matrix_table(self) -> DataTable:
        if self.confusion_matrix is None:
            raise ValueError("no confusion matrix (regression evaluation?)")
        cm = self.confusion_matrix
        return DataTable({f"pred_{j}": cm[:, j] for j in range(cm.shape[1])})

    def roc_curve_table(self) -> DataTable:
        if self.roc is None:
            raise ValueError("no binary ROC computed")
        return roc_table(self.roc)

    def to_metric_data(self, metric_type: str = "evaluation",
                       model_name: str = "model"):
        """The typed logging contract (reference Metrics.scala:37-47; the
        scala logs scalar metrics AND the full ROC table through it,
        ComputeModelStatistics.scala:486-521)."""
        from mmlspark_tpu_torch.observe.metrics import MetricData
        return MetricData.create(
            {k: float(self.metrics[k][0]) for k in self.metrics.columns},
            metric_type, model_name)

    def roc_metric_data(self, model_name: str = "model"):
        if self.roc is None:
            raise ValueError("no binary ROC computed")
        fpr, tpr, thr = self.roc
        from mmlspark_tpu_torch.observe.metrics import MetricData
        return MetricData.create_table(
            {"false_positive_rate": list(fpr), "true_positive_rate": list(tpr),
             "threshold": list(np.clip(thr, -1e300, 1e300))},
            "roc", model_name)


def roc_table(roc: tuple) -> DataTable:
    fpr, tpr, thr = roc
    return DataTable({"false_positive_rate": np.asarray(fpr),
                      "true_positive_rate": np.asarray(tpr),
                      "threshold": np.asarray(thr)})


class ComputeModelStatistics(JaxTwin, Evaluator):
    """Emit a one-row metrics table for a scored table.

    `evaluate` returns the full `EvalResult` (metrics + confusion matrix +
    ROC); `transform` is the pipeline face and returns just the metrics
    table.  Both are stateless.
    """

    evaluationMetric = Param(ALL_METRICS, "metric to compute ('all' or one "
                             "of accuracy/precision/recall/AUC/mse/rmse/r2/mae)",
                             ptype=str)
    labelCol = Param(None, "fallback true-label column when metadata has none",
                     ptype=str)

    def evaluate(self, table: DataTable) -> EvalResult:
        kind, label, scores, scored_labels, probs = _schema_info(
            table, self.labelCol)
        metric = self.evaluationMetric
        if kind == SchemaConstants.REGRESSION_KIND:
            result = self._regression(table, label, scores, metric)
        else:
            result = self._classification(table, label, scores,
                                          scored_labels, probs, metric)
        # every evaluation flows through the typed metric contract
        # (reference ComputeModelStatistics.scala:486-521 -> MetricData)
        result.to_metric_data(metric_type=kind).log("ml.statistics", "debug")
        return result

    def transform(self, table: DataTable) -> DataTable:
        return self.evaluate(table).metrics

    # -- regression (scala:186-203) --------------------------------------
    def _regression(self, table, label, scores, metric) -> EvalResult:
        y = np.asarray(table[label], np.float64)
        pred = np.asarray(table[scores], np.float64)
        err = y - pred
        mse = float(np.mean(err ** 2))
        out = {MSE_COL: mse, RMSE_COL: float(np.sqrt(mse)),
               R2_COL: float(1.0 - mse / max(np.var(y), 1e-24)),
               MAE_COL: float(np.mean(np.abs(err)))}
        if metric in REGRESSION_METRICS:
            out = {METRIC_TO_COLUMN[metric]: out[METRIC_TO_COLUMN[metric]]}
        return EvalResult(DataTable({k: [v] for k, v in out.items()}))

    # -- classification (scala:143-185, 375-447) -------------------------
    def _classification(self, table, label, scores, scored_labels, probs,
                        metric) -> EvalResult:
        pred_col = scored_labels or scores
        y = _label_indices(table, label, pred_col)
        yp = np.asarray(table[pred_col], np.float64).astype(np.int64)
        levels = table.meta(pred_col).categorical
        n_classes = max(
            levels.num_levels if levels is not None else 0,
            int(max(y.max(initial=0), yp.max(initial=0))) + 1, 2)
        cm = confusion_matrix(y, yp, n_classes)
        p = np.asarray(table[probs], np.float64) if probs is not None \
            else None
        out, roc = _metrics_from_confusion(cm, y, p)
        if n_classes != 2 and metric == AUC:
            raise ValueError("AUC is not available for multiclass "
                             "(scala:173)")
        if metric in CLASSIFICATION_METRICS and metric in out:
            out = {metric: out[metric]}
        return EvalResult(DataTable({k: [v] for k, v in out.items()}),
                          confusion_matrix=cm, roc=roc)


def _metrics_from_confusion(cm: np.ndarray, y: Optional[np.ndarray] = None,
                            probs: Optional[np.ndarray] = None
                            ) -> tuple[dict, Optional[tuple]]:
    """The classification metric arithmetic on ONE confusion matrix
    (binary: accuracy/precision/recall + AUC when probabilities are
    given; multiclass: micro + the macro family, scala:375-429).  Shared
    by the serial evaluator and `classification_report_batch`, so the
    batched sweep path agrees with per-model evaluation by construction."""
    out: dict[str, float] = {}
    roc = None
    if cm.shape[0] == 2:
        tn, fp, fn, tp = cm[0, 0], cm[0, 1], cm[1, 0], cm[1, 1]
        total = cm.sum()
        out[ACCURACY] = float((tp + tn) / max(total, 1))
        out[PRECISION] = float(tp / max(tp + fp, 1))
        out[RECALL] = float(tp / max(tp + fn, 1))
        if probs is not None and y is not None:
            pos = probs[:, 1] if probs.ndim == 2 else probs
            roc = roc_curve(y, pos)
            fpr, tpr, _ = roc
            out[AUC] = float(np.trapezoid(tpr, fpr))
    else:
        # micro-averaged accuracy == overall accuracy; macro averages
        # per-class (scala:375-429)
        diag = np.diag(cm).astype(np.float64)
        row = cm.sum(axis=1).astype(np.float64)  # per true class
        col = cm.sum(axis=0).astype(np.float64)  # per predicted class
        micro = float(diag.sum() / max(cm.sum(), 1))
        out[ACCURACY] = micro
        out[PRECISION] = micro   # micro precision == micro recall == acc
        out[RECALL] = micro
        out[AVG_ACCURACY] = float(np.mean(
            (cm.sum() - row - col + 2 * diag) / max(cm.sum(), 1)))
        out[MACRO_PRECISION] = float(np.mean(diag / np.maximum(col, 1)))
        out[MACRO_RECALL] = float(np.mean(diag / np.maximum(row, 1)))
    return out, roc


def confusion_matrix_batch(y_true_stack: np.ndarray,
                           y_pred_stack: np.ndarray,
                           n_classes: Optional[int] = None) -> np.ndarray:
    """(M, k, k) confusion matrices for M models in ONE scatter-add pass
    — the host-side cost of evaluating a whole sweep population is one
    vectorized histogram instead of M table round trips."""
    yt = np.asarray(y_true_stack, np.int64)
    yp = np.asarray(y_pred_stack, np.int64)
    if yp.ndim != 2:
        raise ValueError(f"predictions must be stacked (M, rows); got "
                         f"shape {yp.shape}")
    m, n = yp.shape
    if yt.ndim == 1:
        yt = np.broadcast_to(yt, (m, n))
    k = n_classes or int(max(yt.max(initial=0), yp.max(initial=0))) + 1
    k = max(k, 2)
    cms = np.zeros((m, k, k), np.int64)
    mi = np.broadcast_to(np.arange(m)[:, None], (m, n))
    np.add.at(cms, (mi, yt, yp), 1)
    return cms


def classification_report_batch(y_true, y_pred_stack,
                                model_uids: Optional[list] = None,
                                probs_stack: Optional[np.ndarray] = None,
                                n_classes: Optional[int] = None) -> DataTable:
    """Evaluate M models' stacked predictions in one batched pass.

    `y_pred_stack` is (M, rows) predicted class indices — e.g. a
    population sweep's `score_population` argmax — and `y_true` is
    shared (rows,) or per-model (M, rows).  Returns a DataTable with one
    row per model (`model_name` + the same metric columns the serial
    evaluator emits, union over binary/multiclass arities).  The metric
    arithmetic is `_metrics_from_confusion`, shared with
    `ComputeModelStatistics`, so values match per-model evaluation
    exactly while the confusion matrices come from a single vectorized
    scatter-add instead of M mml-tagged table round trips
    (FindBestModel's candidate ranking; TrainClassifier's sweep path).
    """
    yp = np.asarray(y_pred_stack, np.int64)
    cms = confusion_matrix_batch(y_true, yp, n_classes)
    m = yp.shape[0]
    yt = np.asarray(y_true, np.int64)
    uids = list(model_uids) if model_uids is not None \
        else [f"model_{i}" for i in range(m)]
    if len(uids) != m:
        raise ValueError(f"{len(uids)} model uids for {m} models")
    rows = []
    for i in range(m):
        y_i = yt[i] if yt.ndim == 2 else yt
        p_i = probs_stack[i] if probs_stack is not None else None
        out, _ = _metrics_from_confusion(cms[i], y_i, p_i)
        rows.append({"model_name": uids[i], **out})
    cols: list[str] = []
    for r in rows:
        for key in r:
            if key not in cols:
                cols.append(key)
    return DataTable({c: [r.get(c, np.nan) for r in rows] for c in cols})


def classification_report(y_true, y_pred, model_uid: str = "model") -> EvalResult:
    """Evaluate raw predicted class indices against true labels through the
    full metadata-driven evaluator: builds the one-model mml-tagged table
    the protocol expects and runs ComputeModelStatistics on it.

    The building block of the quantization accuracy gate
    (quant/gate.py::accuracy_gate): quantized-vs-f32 comparisons go through
    the SAME metric path as every other evaluation in the framework, so
    an accuracy delta in a bench line and one from a notebook agree by
    construction.
    """
    t = DataTable({"label": np.asarray(y_true),
                   "prediction": np.asarray(y_pred)})
    set_score_column(t, model_uid, "prediction",
                     SchemaConstants.SCORED_LABELS_COLUMN,
                     SchemaConstants.CLASSIFICATION_KIND)
    set_score_column(t, model_uid, "label",
                     SchemaConstants.TRUE_LABELS_COLUMN,
                     SchemaConstants.CLASSIFICATION_KIND)
    return ComputeModelStatistics(evaluationMetric=ACCURACY).evaluate(t)


class ComputePerInstanceStatistics(JaxTwin, Evaluator):
    """Per-row metrics: log-loss for classification, L1/L2 loss for
    regression (ComputePerInstanceStatistics.scala:36-92)."""

    labelCol = Param(None, "fallback true-label column", ptype=str)

    def transform(self, table: DataTable) -> DataTable:
        kind, label, scores, scored_labels, probs = _schema_info(
            table, self.labelCol)
        if kind == SchemaConstants.REGRESSION_KIND:
            y = np.asarray(table[label], np.float64)
            pred = np.asarray(table[scores], np.float64)
            out = table.with_column("L1_loss", np.abs(y - pred))
            return out.with_column("L2_loss", (y - pred) ** 2)
        if probs is None:
            raise ValueError("classification per-instance stats need a "
                             "scored-probabilities column")
        y = _label_indices(table, label, scored_labels)
        p = np.asarray(table[probs], np.float64)
        idx = np.clip(y, 0, p.shape[1] - 1)
        true_p = p[np.arange(len(y)), idx]
        log_loss = -np.log(np.maximum(true_p, 1e-15))
        return table.with_column("log_loss", log_loss)
