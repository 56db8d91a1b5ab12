"""Column-selection, resharding and persistence stages.

TPU-native counterparts of the reference's pipeline-stages and
checkpoint-data components (SelectColumns.scala:22-63, Repartition.scala:15-42,
CheckpointData.scala:35-69); the port of `mmlspark_tpu/stages/basic.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import JaxTwin, Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.parallel.bridge import shard_batch


class SelectColumns(JaxTwin, Transformer):
    """Keep only the listed columns (reference SelectColumns.scala:22-63:
    missing columns are an error, matching Spark's analysis exception)."""

    cols = Param(None, "columns to keep", ptype=(list, tuple), required=True)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        missing = [c for c in self.cols if c not in table]
        if missing:
            raise KeyError(f"SelectColumns: no such columns {missing}; "
                           f"available: {table.columns}")
        return table.select(*self.cols)


class DropColumns(JaxTwin, Transformer):
    """Drop the listed columns (the dual convenience stage)."""

    cols = Param(None, "columns to drop", ptype=(list, tuple), required=True)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        missing = [c for c in self.cols if c not in table]
        if missing:
            raise KeyError(f"DropColumns: no such columns {missing}; "
                           f"available: {table.columns}")
        return table.drop(*self.cols)


class RenameColumns(JaxTwin, Transformer):
    """Rename columns via a mapping (metadata travels with the column)."""

    mapping = Param(None, "old-name -> new-name mapping", ptype=dict,
                    required=True)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        missing = [c for c in self.mapping if c not in table]
        if missing:
            raise KeyError(f"RenameColumns: no such columns {missing}")
        return table.rename(self.mapping)


class Repartition(JaxTwin, Transformer):
    """Set the table's shard count — the layout hint the parallel layer uses
    when placing batches on the mesh.

    Reference Repartition.scala:15-42: `n` partitions with a
    `disable`/coalesce-vs-shuffle switch.  On TPU "partitions" are mesh
    shards; there is no shuffle cost distinction (resharding happens at the
    device boundary), so only the count survives.
    """

    n = Param(None, "number of shards", ptype=int, required=True,
              validator=lambda v: v > 0)
    disable = Param(False, "pass the table through unchanged", ptype=bool)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        if self.disable:
            return table
        return table.repartition(self.n)


class CheckpointData(JaxTwin, Transformer):
    """Materialize (or release) table columns in device memory.

    Reference CheckpointData.scala:35-69 caches/unpersists a DataFrame in
    executor memory as a pipeline stage.  The device equivalent of "cache"
    is pre-staging numeric columns in the card's memory so downstream
    scoring stages skip the host->device copy on every pass over the table
    (e.g. FindBestModel scoring many models on one eval set);
    "unpersist" (removeCheckpoint=True) drops those tensors.  The cache
    lives on the table object itself, so it is garbage-collected with the
    table; TPUModel consults it via `get_device_cache`.

    The port caches on the stage's `device` (a run-time setting, not a
    Param): each numeric column as one tensor of the column's own dtype,
    as `torch.as_tensor` holds it.  Over a mesh (`mesh=` or `set_mesh`,
    the JAX stage's `best_mesh` + `shard_batch`) each column is cached as
    per-device slabs: contiguous rows zero-padded to a multiple of the
    data axis, slab i on shard i's device (`parallel/bridge.py`
    `shard_batch`), which a `TPUModel` over the same mesh scores shard by
    shard; the valid row count is the host column's length.
    """

    removeCheckpoint = Param(False, "release instead of persist", ptype=bool)

    def __init__(self, device="cuda", mesh=None, **kw):
        super().__init__(**kw)
        self.device = resolve_device(device)
        self.mesh = None
        if mesh is not None:
            self.set_mesh(mesh)

    def set_mesh(self, mesh) -> "CheckpointData":
        """Cache over `mesh`'s data axis (None: on `device` alone)."""
        self.mesh = mesh
        if mesh is not None:
            self.device = resolve_device(mesh.devices.flat[0])
        return self

    def transform(self, table: DataTable) -> DataTable:
        out = table.select(*table.columns)
        if self.removeCheckpoint:
            # deliberate mutation of the input (the one exception to the
            # derived-table convention): any holder of the input table keeps
            # device memory pinned through its _device_cache, so drop it
            # there too
            table.__dict__.pop("_device_cache", None)
            return out
        cache: dict[str, torch.Tensor] = {}
        for name in out.columns:
            arr = out[name]
            if arr.dtype != object and np.issubdtype(arr.dtype, np.number):
                arr = np.ascontiguousarray(arr)
                cache[name] = (
                    torch.as_tensor(arr, device=self.device)
                    if self.mesh is None else shard_batch(arr, self.mesh))
        out.__dict__["_device_cache"] = cache
        return out

    @staticmethod
    def get_device_cache(table: DataTable) -> dict:
        return getattr(table, "_device_cache", {})
