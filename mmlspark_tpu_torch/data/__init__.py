"""Streaming data layer of the port (the local half of
`mmlspark_tpu/data/`): composable Dataset graphs with parallel map
workers, bounded prefetch buffers and the depth Autotuner.

data/dataset.py holds the graph, data/autotune.py the controller,
data/executor.py the one thread-pool construction point, data/snapshot.py
the mid-epoch offsets.  Of the data service only the transport framing is
ported (`service.transport`, which the serving tiers' KV handoff rides);
its dispatcher and workers, `Dataset.distribute` and the graph
serializer wait for ROADMAP A12.
"""

from mmlspark_tpu_torch.data.autotune import Autotuner
from mmlspark_tpu_torch.data.dataset import Dataset, DatasetIterator, MapError

__all__ = ["Autotuner", "Dataset", "DatasetIterator", "MapError"]
