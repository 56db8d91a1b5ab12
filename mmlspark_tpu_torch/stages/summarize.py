"""Per-column statistics stage.

TPU-native counterpart of the reference's SummarizeData
(summarize-data/SummarizeData.scala:65-190): emits one row per input column
with count / basic / sample / percentile statistic groups.  Where the
reference joins four Spark jobs with approximate quantiles, the table is
host-resident here, so quantiles are exact (errorThreshold kept for API
parity; 0 == exact was already the reference default).

The port's copy of `mmlspark_tpu/stages/summarize.py`.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import JaxTwin, Transformer
from mmlspark_tpu_torch.core.table import DataTable

FEATURE_COLUMN = "Feature"
COUNT_FIELDS = ["Count", "Unique Value Count", "Missing Value Count"]
BASIC_FIELDS = ["Min", "1st Quartile", "Median", "3rd Quartile", "Max"]
BASIC_QUANTILES = [0.0, 0.25, 0.5, 0.75, 1.0]
SAMPLE_FIELDS = ["Sample Variance", "Sample Standard Deviation",
                 "Sample Skewness", "Sample Kurtosis"]
PERCENTILE_QUANTILES = [0.005, 0.01, 0.05, 0.95, 0.99, 0.995]
PERCENTILE_FIELDS = ["P0.5", "P1", "P5", "P95", "P99", "P99.5"]


class SummarizeData(JaxTwin, Transformer):
    """Compute per-column summary statistics as a new table."""

    counts = Param(True, "compute count statistics", ptype=bool)
    basic = Param(True, "compute basic statistics (min/quartiles/max)", ptype=bool)
    sample = Param(True, "compute sample statistics (var/std/skew/kurtosis)",
                   ptype=bool)
    percentiles = Param(True, "compute tail percentiles", ptype=bool)
    errorThreshold = Param(0.0, "quantile error tolerance; 0 is exact "
                           "(always exact here)", ptype=float)

    def transform(self, table: DataTable) -> DataTable:
        names = table.columns
        out: dict[str, list] = {FEATURE_COLUMN: list(names)}
        groups: list[tuple[list[str], callable, bool]] = []
        if self.counts:
            groups.append((COUNT_FIELDS, _count_stats, False))
        if self.basic:
            groups.append((BASIC_FIELDS,
                           lambda v: _quantiles(v, BASIC_QUANTILES), True))
        if self.sample:
            groups.append((SAMPLE_FIELDS, _sample_stats, True))
        if self.percentiles:
            groups.append((PERCENTILE_FIELDS,
                           lambda v: _quantiles(v, PERCENTILE_QUANTILES), True))
        for fields, _, _ in groups:
            for f in fields:
                out[f] = []
        for name in names:
            arr = table[name]
            numeric = (arr.dtype != object and arr.ndim == 1
                       and np.issubdtype(arr.dtype, np.number))
            for fields, fn, needs_numeric in groups:
                if needs_numeric and not numeric:
                    vals = [np.nan] * len(fields)
                else:
                    vals = fn(arr)
                for f, v in zip(fields, vals):
                    out[f].append(float(v))
        return DataTable(out)


def _count_stats(arr: np.ndarray) -> list[float]:
    n = len(arr)
    if arr.dtype == object:
        missing = sum(1 for v in arr if v is None)
        present = [v for v in arr if v is not None]
        distinct = len(set(map(_hashable, present)))
    elif arr.ndim > 1:
        missing = 0
        distinct = len({v.tobytes() for v in arr})
    elif np.issubdtype(arr.dtype, np.floating):
        nan = np.isnan(arr)
        missing = int(nan.sum())
        distinct = len(np.unique(arr[~nan]))
    else:
        missing = 0
        distinct = len(np.unique(arr))
    return [n - missing, distinct, missing]


def _hashable(v):
    return v.tobytes() if isinstance(v, np.ndarray) else v


def _quantiles(arr: np.ndarray, qs: list[float]) -> list[float]:
    vals = arr[~np.isnan(arr)] if np.issubdtype(arr.dtype, np.floating) else arr
    if len(vals) == 0:
        return [np.nan] * len(qs)
    return list(np.quantile(vals.astype(np.float64), qs))


def _sample_stats(arr: np.ndarray) -> list[float]:
    vals = (arr[~np.isnan(arr)] if np.issubdtype(arr.dtype, np.floating)
            else arr).astype(np.float64)
    n = len(vals)
    if n < 2:
        return [np.nan] * 4
    var = vals.var(ddof=1)
    std = np.sqrt(var)
    # Spark's skewness/kurtosis are the population m3/m2^1.5 and excess
    # m4/m2^2 - 3 (what the reference's sampleStatsImpl computed via
    # catalyst's skewness/kurtosis aggregates)
    m = vals.mean()
    m2 = ((vals - m) ** 2).mean()
    if m2 == 0:
        return [var, std, np.nan, np.nan]
    skew = ((vals - m) ** 3).mean() / m2 ** 1.5
    kurt = ((vals - m) ** 4).mean() / m2 ** 2 - 3.0
    return [var, std, skew, kurt]
