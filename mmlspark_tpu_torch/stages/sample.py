"""Head / random-sample / assign-to-partition stage.

TPU-native counterpart of the reference's PartitionSample
(partition-sample/PartitionSample.scala:87-110).  The reference's
AssignToPartition mode was broken (line 92 copies an "input" column); here it
does what its params describe: assigns each row a random shard id in
[0, numParts) into `newColName`.

The port's copy of `mmlspark_tpu/stages/sample.py`.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.params import Param, domain
from mmlspark_tpu_torch.core.pipeline import JaxTwin, Transformer
from mmlspark_tpu_torch.core.table import DataTable

MODE_RS = "RandomSample"
MODE_HEAD = "Head"
MODE_ATP = "AssignToPartition"
RS_ABSOLUTE = "Absolute"
RS_PERCENT = "Percentage"


class PartitionSample(JaxTwin, Transformer):
    """Sample rows or assign partition ids."""

    mode = Param(MODE_RS, "sampling mode",
                 domain=domain(MODE_RS, MODE_HEAD, MODE_ATP))
    rsMode = Param(RS_PERCENT, "random-sample mode",
                   domain=domain(RS_ABSOLUTE, RS_PERCENT))
    seed = Param(-1, "seed for random ops (-1 = nondeterministic)", ptype=int)
    percent = Param(0.01, "fraction of rows to return", ptype=float)
    count = Param(1000, "number of rows to return", ptype=int)
    newColName = Param("Partition", "partition column name (ATP mode)", ptype=str)
    numParts = Param(10, "number of partitions (ATP mode)", ptype=int)

    def _rng(self) -> np.random.Generator:
        seed = self.seed
        return np.random.default_rng(None if seed == -1 else seed)

    def transform(self, table: DataTable) -> DataTable:
        mode = self.mode
        if mode == MODE_HEAD:
            return table.take(self.count)
        if mode == MODE_RS:
            frac = (self.percent if self.rsMode == RS_PERCENT
                    else min(1.0, self.count / max(1, table.num_rows)))
            mask = self._rng().random(table.num_rows) < frac
            return table.filter(mask)
        parts = self._rng().integers(0, self.numParts,
                                     size=table.num_rows).astype(np.int32)
        return table.with_column(self.newColName, parts)
