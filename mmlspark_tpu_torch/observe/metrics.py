"""Typed metric contract (the port of `mmlspark_tpu/observe/metrics.py`;
its reference is Metrics.scala:37-47).

The reference funnels every computed metric through `MetricData(data,
metricType, modelName)` — a metric-name -> column-of-doubles table tagged
with what kind of evaluation produced it — consumed by its logging layer
(ComputeModelStatistics.scala:486-521 logs full ROC tables through it).
`MetricData` here is the same contract as a frozen dataclass: evaluators and
the Trainer emit them, `log()` routes them through the logger factory, and
`to_table()` turns one back into a DataTable for pipeline consumption.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Sequence

from mmlspark_tpu_torch.observe.logging import get_logger

# --------------------------------------------------------------------------
# Framework counters: monotonically increasing process-wide tallies that
# subsystems (retry/breaker/chaos, checkpoint rotation) bump on events.
# Deliberately tiny — a dict under a lock — so the resilience hot paths can
# afford to increment on every attempt; `counters_metric_data()` folds the
# current tallies into the same MetricData contract everything else speaks.
# --------------------------------------------------------------------------

_counters: dict[str, float] = {}
_counters_lock = threading.Lock()


def inc_counter(name: str, value: float = 1.0) -> None:
    """Add `value` to the named process-wide counter (creates at 0)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0.0) + value


def get_counter(name: str) -> float:
    """Current value of one counter (0.0 if never incremented)."""
    with _counters_lock:
        return _counters.get(name, 0.0)


def counters_snapshot() -> dict[str, float]:
    """A point-in-time copy of every counter."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    """Zero all counters (test isolation)."""
    with _counters_lock:
        _counters.clear()


def counters_metric_data() -> "MetricData":
    """The counter table as a MetricData row (metric_type='counters')."""
    snap = counters_snapshot()
    return MetricData.create(snap, "counters", "framework")


@dataclasses.dataclass(frozen=True)
class MetricData:
    """A metric table: name -> equal-length columns of floats, tagged with
    the metric type (e.g. "classification", "regression", "training") and
    the model that produced it."""

    data: dict[str, list[float]]
    metric_type: str
    model_name: str

    def __post_init__(self):
        lengths = {len(v) for v in self.data.values()}
        if len(lengths) > 1:
            raise ValueError(
                f"all metric columns must have the same length; got "
                f"{ {k: len(v) for k, v in self.data.items()} }")

    @classmethod
    def create(cls, data: Mapping[str, float], metric_type: str,
               model_name: str) -> "MetricData":
        """One scalar per metric (Metrics.scala:40-42)."""
        return cls({k: [float(v)] for k, v in data.items()},
                   metric_type, model_name)

    @classmethod
    def create_table(cls, data: Mapping[str, Sequence[float]],
                     metric_type: str, model_name: str) -> "MetricData":
        """A column of values per metric (Metrics.scala:43-45) — e.g. a ROC
        table, or per-epoch training losses."""
        return cls({k: [float(x) for x in v] for k, v in data.items()},
                   metric_type, model_name)

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def scalars(self) -> dict[str, float]:
        """The single-row view; raises if any column has multiple rows."""
        if self.num_rows > 1:
            raise ValueError(f"metric table has {self.num_rows} rows; "
                             "use .data for tables")
        return {k: v[0] for k, v in self.data.items()}

    def to_table(self):
        import numpy as np

        from mmlspark_tpu_torch.core.table import DataTable
        return DataTable({k: np.asarray(v, dtype=np.float64)
                          for k, v in self.data.items()})

    def log(self, suffix: str = "metrics", level: str = "info") -> None:
        """Route through the namespaced logger (the reference's
        logMetricData path)."""
        logger = get_logger(suffix)
        getattr(logger, level)("%s", self)

    def __str__(self):
        if self.num_rows == 1:
            body = ", ".join(f"{k}={v[0]:.6g}" for k, v in self.data.items())
        else:
            body = ", ".join(f"{k}[{len(v)}]" for k, v in self.data.items())
        return f"[{self.metric_type}] {self.model_name}: {body}"
