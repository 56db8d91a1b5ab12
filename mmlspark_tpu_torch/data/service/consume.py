"""The consumer's splice: the service session as a Dataset stage runner
(the port of `mmlspark_tpu/data/service/consume.py`).

`Dataset.distribute()` registers a `ServiceConsumer` as the stage named
"service", so everything that understands stage runners keeps working:
`DatasetIterator.close()` tears the session (and its worker fleet) down
sink to source, and the `Autotuner` reads the same `stats()` counters it
reads from a `Prefetcher`, except that here `depth` counts *worker
processes* (`scale_unit = "workers"`, `depth_floor = 1`), so the
widen-the-bottleneck logic scales the fleet from stall evidence with no
controller of its own.

The session opens on the first pull, which is what lets a `snapshot(tag)`
op above apply a restore offset (`fast_forward`) before any split is
dispatched: resumed elements are never produced, not produced and
dropped.
"""

from __future__ import annotations

from typing import Optional

from mmlspark_tpu_torch.data.service.dispatcher import DataService


class ServiceConsumer:
    """Iterator + tuning surface over one ServiceSession."""

    scale_unit = "workers"   # Autotuner gauge label: depth here = fleet
    depth_floor = 1          # never scale below one worker

    def __init__(self, service: DataService, spec: dict, *,
                 deterministic: bool = True, consumer_index: int = 0,
                 num_consumers: int = 1,
                 split_elems: Optional[int] = None,
                 owns_service: bool = True):
        self._service = service
        self._session = service.session(
            spec, deterministic=deterministic,
            consumer_index=consumer_index, num_consumers=num_consumers,
            split_elems=split_elems)
        self._owns_service = owns_service
        self.tunable = service.autoscale

    # -- the Prefetcher tuning surface (depth == workers) ---------------
    @property
    def depth(self) -> int:
        return self._session.target_workers

    @property
    def max_depth(self) -> int:
        return self._service.max_workers

    def set_depth(self, depth: int) -> int:
        return self._session.scale(depth)

    def stats(self) -> dict:
        return self._session.stats()

    # -- snapshot/resume ------------------------------------------------
    def fast_forward(self, n: int) -> bool:
        return self._session.fast_forward(n)

    # -- iteration ------------------------------------------------------
    def __iter__(self) -> "ServiceConsumer":
        return self

    def __next__(self):
        return self._session.next_element()

    def close(self) -> None:
        self._session.close()
