"""The quantization accuracy gate (the port of `mmlspark_tpu/quant/gate.py`;
numpy on the host, over the two models' scored tables).

A quantized arm is only shippable next to its accuracy delta — a speedup
number without one is how silent quality regressions ship.  The gate runs
both models over the same table and pushes the predictions through the
full metadata-driven evaluator (`ml/statistics.classification_report`, the
ComputeModelStatistics protocol) three times:

  * baseline predictions vs true labels  -> baseline_accuracy
  * quantized predictions vs true labels -> quant_accuracy
  * quantized vs baseline predictions    -> agreement (top-1 match rate)

bench.py wires this next to every quantized arm's speedup (the cifar10
int8 line pins |accuracy_delta| <= 0.005 in tests/test_perf_floor.py).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.ml.statistics import classification_report


def _predictions(model, table: DataTable) -> np.ndarray:
    scored = model.transform(table)
    scores = np.asarray(scored[model.outputCol], np.float32)
    if scores.ndim != 2:
        raise ValueError(
            f"accuracy_gate needs 2-D class scores, got shape {scores.shape}")
    return np.argmax(scores, axis=1)


def accuracy_gate(baseline_model, quant_model, table: DataTable,
                  labels) -> dict:
    """Score `table` through both models; return the gate record.

    Both models must be scoring Transformers (TPUModel-shaped: an
    `outputCol` of per-class scores).  Returns::

        {"baseline_accuracy", "quant_accuracy", "accuracy_delta",
         "agreement", "n_rows"}

    accuracy_delta = quant - baseline (negative means the quantized model
    lost accuracy).
    """
    y = np.asarray(labels)
    pred_base = _predictions(baseline_model, table)
    pred_quant = _predictions(quant_model, table)
    acc_base = float(
        classification_report(y, pred_base).metrics["accuracy"][0])
    acc_quant = float(
        classification_report(y, pred_quant).metrics["accuracy"][0])
    agreement = float(
        classification_report(pred_base, pred_quant).metrics["accuracy"][0])
    return {
        "baseline_accuracy": round(acc_base, 4),
        "quant_accuracy": round(acc_quant, 4),
        "accuracy_delta": round(acc_quant - acc_base, 4),
        "agreement": round(agreement, 4),
        "n_rows": int(len(y)),
    }
