"""Utility pipeline stages (reference L3: pipeline-stages, data-conversion,
summarize-data, partition-sample, checkpoint-data, multi-column-adapter).
The port of `mmlspark_tpu/stages/`: the same names."""

from mmlspark_tpu_torch.stages.basic import (CheckpointData, DropColumns,
                                       RenameColumns, Repartition,
                                       SelectColumns)
from mmlspark_tpu_torch.stages.data_conversion import DataConversion
from mmlspark_tpu_torch.stages.summarize import SummarizeData
from mmlspark_tpu_torch.stages.sample import PartitionSample
from mmlspark_tpu_torch.stages.adapter import MultiColumnAdapter

__all__ = [
    "SelectColumns", "DropColumns", "RenameColumns", "Repartition",
    "CheckpointData", "DataConversion", "SummarizeData", "PartitionSample",
    "MultiColumnAdapter",
]
