"""Streaming data layer of the port (the port of `mmlspark_tpu/data/`):
composable Dataset graphs with parallel map workers, bounded prefetch
buffers, the depth Autotuner, and the multi-process data service.

data/dataset.py holds the graph, data/autotune.py the controller,
data/executor.py the one thread-pool construction point, data/snapshot.py
the mid-epoch offsets, data/graph.py the serialized graph spec, and
data/service/ the worker tier (`Dataset.distribute`; its transport also
carries the serving tiers' KV handoff).
"""

from mmlspark_tpu_torch.data.autotune import Autotuner
from mmlspark_tpu_torch.data.dataset import Dataset, DatasetIterator, MapError

__all__ = ["Autotuner", "Dataset", "DatasetIterator", "MapError"]
