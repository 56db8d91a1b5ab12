"""Column type coercion stage.

TPU-native counterpart of the reference's DataConversion
(data-conversion/DataConversion.scala:51-149): convert a comma-separated
list of columns to a target type, including to/from categorical and
date/timestamp handling.

The port's copy of `mmlspark_tpu/stages/data_conversion.py`.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from mmlspark_tpu_torch.core.params import Param, domain
from mmlspark_tpu_torch.core.pipeline import JaxTwin, Transformer
from mmlspark_tpu_torch.core.schema import make_categorical
from mmlspark_tpu_torch.core.table import DataTable

_NUMERIC_TARGETS = {
    "boolean": np.bool_,
    "byte": np.int8,
    "short": np.int16,
    "integer": np.int32,
    "long": np.int64,
    "float": np.float32,
    "double": np.float64,
}


class DataConversion(JaxTwin, Transformer):
    """Convert listed columns to a requested type.

    `cols` accepts a list or the reference's comma-separated string form
    (DataConversion.scala:25-26, 55).  Targets mirror the reference's
    dispatch at lines 65-78: numeric types, string, toCategorical,
    clearCategorical, date.
    """

    cols = Param(None, "columns to convert (list or comma-separated string)",
                 required=True)
    convertTo = Param(None, "target type", ptype=str, required=True,
                      domain=domain("boolean", "byte", "short", "integer",
                                    "long", "float", "double", "string",
                                    "toCategorical", "clearCategorical",
                                    "date"))
    dateTimeFormat = Param("%Y-%m-%d %H:%M:%S",
                           "strptime/strftime format for date conversions "
                           "(reference default yyyy-MM-dd HH:mm:ss)",
                           ptype=str)

    def _col_list(self) -> list[str]:
        cols = self.cols
        if isinstance(cols, str):
            return [c.strip() for c in cols.split(",") if c.strip()]
        return list(cols)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        names = self._col_list()
        missing = [c for c in names if c not in table]
        if missing:
            raise KeyError(f"DataConversion: no such columns {missing}")
        out = table
        for name in names:
            out = self._convert(out, name)
        return out

    def _convert(self, table: DataTable, name: str) -> DataTable:
        target = self.convertTo
        arr = table[name]
        if target == "toCategorical":
            return make_categorical(table, name)
        if target == "clearCategorical":
            cmap = table.meta(name).categorical
            if cmap is None:
                return table
            decoded = cmap.to_levels(arr)
            out = table.with_column(name, decoded)
            meta = out.meta(name)
            meta.categorical = None
            out.set_meta(name, meta)
            return out
        if target == "date":
            return table.with_column(name, self._to_datetime(arr))
        if target == "string":
            if np.issubdtype(arr.dtype, np.datetime64):
                return table.with_column(name, self._format_dates(arr))
            str_col = np.empty(len(arr), dtype=object)
            str_col[:] = [str(v) for v in arr]
            return table.with_column(name, str_col)
        np_target = _NUMERIC_TARGETS[target]
        if arr.dtype == object and np_target is np.bool_:
            # reference rejects string->boolean (DataConversion.scala:108)
            if any(isinstance(v, str) for v in arr):
                raise TypeError("string to boolean conversion not supported")
        if np.issubdtype(arr.dtype, np.datetime64):
            # timestamp -> long (epoch millis) or string only
            # (DataConversion.scala:117-126)
            if np_target is not np.int64:
                raise TypeError("date columns only convert to long or string")
            millis = arr.astype("datetime64[ms]").astype(np.int64)
            return table.with_column(name, millis)
        if arr.dtype == object:
            integral = np_target is not np.bool_ and np.issubdtype(
                np_target, np.integer)

            def conv(v):
                if integral:
                    # never round-trip large ints through float64 (2**53 loss)
                    return int(v) if not isinstance(v, str) else int(
                        v) if v.lstrip("+-").isdigit() else int(float(v))
                return float(v) if not isinstance(v, str) else np.float64(v)

            converted = np.asarray([conv(v) for v in arr], dtype=np_target)
            return table.with_column(name, converted)
        return table.with_column(name, arr.astype(np_target))

    def _to_datetime(self, arr: np.ndarray) -> np.ndarray:
        fmt = self.dateTimeFormat
        if np.issubdtype(arr.dtype, np.datetime64):
            return arr
        if np.issubdtype(arr.dtype, np.integer):
            # epoch millis -> datetime64[ms] (reference long->Timestamp path)
            return arr.astype("datetime64[ms]")
        parsed = [np.datetime64(_dt.datetime.strptime(str(v), fmt), "ms")
                  for v in arr]
        return np.asarray(parsed, dtype="datetime64[ms]")

    def _format_dates(self, arr: np.ndarray) -> np.ndarray:
        fmt = self.dateTimeFormat
        out = np.empty(len(arr), dtype=object)
        out[:] = [v.astype("datetime64[ms]").astype(_dt.datetime).strftime(fmt)
                  for v in arr]
        return out
