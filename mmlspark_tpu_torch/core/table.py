"""DataTable: host-side columnar table with ML metadata (the port's copy of
`mmlspark_tpu/core/table.py`).

A table is a dict of numpy columns on the host; tensors are made from them
only at the device boundary, inside a stage.  The on-disk layout
(`columns.npz`, `objects.json`, `meta.json`) is the JAX package's, so a
table saved by either package loads in the other, and the seeded helpers
(`sample`, `shuffle`) draw the same rows for the same seed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator, Mapping, Optional, Sequence

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

    # -- construction --------------------------------------------------
    @staticmethod
    def from_dict(d: Mapping[str, Any], **kw) -> "DataTable":
        return DataTable(d, **kw)

    @staticmethod
    def from_pandas(df, **kw) -> "DataTable":
        cols = {}
        for name in df.columns:
            s = df[name]
            cols[name] = (s.to_numpy(dtype=object) if s.dtype == object
                          else s.to_numpy())
        return DataTable(cols, **kw)

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]], **kw) -> "DataTable":
        if not rows:
            return DataTable({}, **kw)
        names = list(rows[0].keys())
        return DataTable({n: [r[n] for r in rows] for n in names}, **kw)

    @staticmethod
    def read_csv(path: str, **kw) -> "DataTable":
        import pandas as pd
        return DataTable.from_pandas(pd.read_csv(path), **kw)

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame({name: list(arr) if arr.ndim > 1 else arr
                             for name, arr in self._cols.items()})

    # -- basic accessors -----------------------------------------------
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

    def column(self, name: str) -> np.ndarray:
        return self[name]

    def meta(self, name: str) -> ColumnMeta:
        self[name]
        return self._meta[name]

    def set_meta(self, name: str, meta: ColumnMeta) -> None:
        self[name]
        self._meta[name] = meta

    def schema(self) -> dict[str, tuple]:
        return {n: (str(a.dtype), a.shape[1:]) for n, a in self._cols.items()}

    def rows(self) -> Iterator[dict]:
        for i in range(self.num_rows):
            yield {n: a[i] for n, a in self._cols.items()}

    # -- shaping (all return new tables) --------------------------------
    def _derive(self, cols: dict[str, np.ndarray],
                meta: Optional[Mapping[str, ColumnMeta]] = None
                ) -> "DataTable":
        src = self._meta if meta is None else meta
        t = DataTable.__new__(DataTable)
        t._cols = cols
        t._meta = {n: (src[n].copy() if n in src else ColumnMeta())
                   for n in cols}
        t.num_shards = self.num_shards
        return t

    def select(self, *names: str) -> "DataTable":
        return self._derive({n: self[n] for n in names})

    def drop(self, *names: str) -> "DataTable":
        return self._derive({n: a for n, a in self._cols.items()
                             if n not in names})

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

    def rename(self, mapping: Mapping[str, str]) -> "DataTable":
        cols = {mapping.get(n, n): a for n, a in self._cols.items()}
        meta = {mapping.get(n, n): m for n, m in self._meta.items()}
        return self._derive(cols, meta)

    def filter(self, mask: Any) -> "DataTable":
        mask = np.asarray(mask)
        return self._derive({n: a[mask] for n, a in self._cols.items()})

    def take(self, n: int) -> "DataTable":
        return self._derive({name: a[:n] for name, a in self._cols.items()})

    def slice(self, start: int, stop: int) -> "DataTable":
        return self._derive({n: a[start:stop] for n, a in self._cols.items()})

    def sample(self, fraction: float, seed: int = 0) -> "DataTable":
        rng = np.random.default_rng(seed)
        return self.filter(rng.random(self.num_rows) < fraction)

    def shuffle(self, seed: int = 0) -> "DataTable":
        perm = np.random.default_rng(seed).permutation(self.num_rows)
        return self._derive({n: a[perm] for n, a in self._cols.items()})

    def concat(self, other: "DataTable") -> "DataTable":
        if set(self.columns) != set(other.columns):
            raise ValueError(
                f"column mismatch: {self.columns} vs {other.columns}")
        return self._derive({n: np.concatenate([self[n], other[n]], axis=0)
                             for n in self.columns})

    def repartition(self, num_shards: int) -> "DataTable":
        """A resharding hint: the same rows with `num_shards` recorded."""
        out = self._derive(dict(self._cols))
        out.num_shards = max(1, int(num_shards))
        return out

    def drop_nulls(self, subset: Optional[Sequence[str]] = None
                   ) -> "DataTable":
        """Rows without a None (object columns) or a NaN (float columns;
        any NaN of a multi-dimensional row) in `subset` (default: all)."""
        mask = np.ones(self.num_rows, dtype=bool)
        for n in (list(subset) if subset else self.columns):
            a = self[n]
            if a.dtype == object:
                mask &= np.asarray([v is not None for v in a], dtype=bool)
            elif np.issubdtype(a.dtype, np.floating):
                nan = np.isnan(a)
                mask &= ~(nan.any(axis=tuple(range(1, a.ndim)))
                          if a.ndim > 1 else nan)
        return self.filter(mask)

    def find_unused_column_name(self, prefix: str) -> str:
        name, i = prefix, 0
        while name in self._cols:
            i += 1
            name = f"{prefix}_{i}"
        return name

    # -- batching -------------------------------------------------------
    def batches(self, columns: Sequence[str], batch_size: int,
                pad: bool = True
                ) -> Iterator[tuple[dict[str, np.ndarray], int]]:
        """Yield (column-dict, valid_count) minibatches; with `pad` the
        last one is zero-padded to `batch_size`, so every batch has one
        shape."""
        n = self.num_rows
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            valid = stop - start
            batch = {c: self[c][start:stop] for c in columns}
            if pad and valid < batch_size:
                batch = {c: np.concatenate(
                    [a, np.zeros((batch_size - valid,) + a.shape[1:],
                                 a.dtype)]) for c, a in batch.items()}
            yield batch, valid

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
