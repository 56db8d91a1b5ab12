"""DataTable: host-side columnar table with ML metadata (the port's copy of
`mmlspark_tpu/core/table.py`, cut to what the ported stages use).

A table is a dict of numpy columns on the host; tensors are made from them
only at the device boundary, inside a stage.  The on-disk layout
(`columns.npz`, `objects.json`, `meta.json`) is the JAX package's, so a
table saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional

import numpy as np

from mmlspark_tpu_torch.core.schema import ColumnMeta, _json_scalar


def object_column(values: Any) -> np.ndarray:
    """Build a 1-D object column without numpy coercing nested sequences."""
    values = list(values)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _as_column(values: Any) -> np.ndarray:
    if isinstance(values, np.ndarray):
        return values
    values = list(values)
    if values and isinstance(values[0], (str, bytes, dict)) or any(
            v is None for v in values):
        return object_column(values)
    try:
        return np.asarray(values)
    except ValueError:  # ragged
        return object_column(values)


class DataTable:
    """Immutable-by-convention columnar table.

    `set_meta` mutates metadata only; every data-shaping method returns a
    new DataTable sharing column buffers.
    """

    def __init__(self, columns: Mapping[str, Any],
                 metadata: Optional[Mapping[str, ColumnMeta]] = None,
                 num_shards: int = 1):
        self._cols: dict[str, np.ndarray] = {}
        n = None
        for name, vals in columns.items():
            arr = _as_column(vals)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"column '{name}' has {len(arr)} rows, expected {n}")
            self._cols[name] = arr
        self._meta: dict[str, ColumnMeta] = {
            name: (metadata[name].copy() if metadata and name in metadata
                   else ColumnMeta())
            for name in self._cols
        }
        self.num_shards = max(1, int(num_shards))

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    @property
    def num_rows(self) -> int:
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __len__(self) -> int:
        return self.num_rows

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        try:
            return self._cols[name]
        except KeyError:
            raise KeyError(
                f"no column '{name}'; available: {self.columns}") from None

    def meta(self, name: str) -> ColumnMeta:
        self[name]
        return self._meta[name]

    def set_meta(self, name: str, meta: ColumnMeta) -> None:
        self[name]
        self._meta[name] = meta

    def schema(self) -> dict[str, tuple]:
        return {n: (str(a.dtype), a.shape[1:]) for n, a in self._cols.items()}

    def _derive(self, cols: dict[str, np.ndarray]) -> "DataTable":
        t = DataTable.__new__(DataTable)
        t._cols = cols
        t._meta = {n: (self._meta[n].copy() if n in self._meta
                       else ColumnMeta()) for n in cols}
        t.num_shards = self.num_shards
        return t

    def with_column(self, name: str, values: Any,
                    meta: Optional[ColumnMeta] = None) -> "DataTable":
        arr = _as_column(values)
        if self._cols and len(arr) != self.num_rows:
            raise ValueError(
                f"column '{name}' has {len(arr)} rows, table has "
                f"{self.num_rows}")
        cols = dict(self._cols)
        cols[name] = arr
        out = self._derive(cols)
        if meta is not None:
            out._meta[name] = meta.copy()
        return out

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        obj_cols, arr_cols = {}, {}
        for n, a in self._cols.items():
            (obj_cols if a.dtype == object else arr_cols)[n] = a
        np.savez(os.path.join(path, "columns.npz"), **arr_cols)
        with open(os.path.join(path, "objects.json"), "w") as f:
            json.dump({n: [_obj_to_json(v) for v in a]
                       for n, a in obj_cols.items()}, f)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({
                "num_shards": self.num_shards,
                "column_order": self.columns,
                "metadata": {n: m.to_json() for n, m in self._meta.items()},
            }, f)

    @staticmethod
    def load(path: str) -> "DataTable":
        with open(os.path.join(path, "meta.json")) as f:
            info = json.load(f)
        npz = np.load(os.path.join(path, "columns.npz"), allow_pickle=False)
        with open(os.path.join(path, "objects.json")) as f:
            objs = json.load(f)
        cols: dict[str, np.ndarray] = {}
        for n in info["column_order"]:
            cols[n] = npz[n] if n in npz.files else _as_column(
                [_obj_from_json(v) for v in objs[n]])
        meta = {n: ColumnMeta.from_json(m)
                for n, m in info["metadata"].items()}
        return DataTable(cols, metadata=meta, num_shards=info["num_shards"])

    def __repr__(self):
        schema = ", ".join(f"{n}:{d}{list(s) if s else ''}"
                           for n, (d, s) in self.schema().items())
        return f"DataTable[{self.num_rows} rows; {schema}]"


def _obj_to_json(v):
    if isinstance(v, bytes):
        import base64
        return {"__bytes__": base64.b64encode(v).decode()}
    if isinstance(v, np.ndarray):
        return {"__array__": v.tolist(), "dtype": str(v.dtype)}
    return _json_scalar(v)


def _obj_from_json(v):
    if isinstance(v, dict) and "__bytes__" in v:
        import base64
        return base64.b64decode(v["__bytes__"])
    if isinstance(v, dict) and "__array__" in v:
        return np.asarray(v["__array__"], dtype=v["dtype"])
    return v
