"""The data layer's one thread-pool construction point (the port of
`mmlspark_tpu/data/executor.py`).

Every parallel stage of a `Dataset` graph (`map` workers, `prefetch`
buffers) runs on a `Prefetcher` (parallel/prefetch.py): the
order-preserving bounded background map with the repo's backpressure,
exception-at-position and clean-shutdown contracts.  Keeping pool
construction in one file keeps "how many threads does ingestion own?" a
one-file audit, and lets the Autotuner assume every stage exposes the
Prefetcher's `stats()` / `set_depth` surface.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from mmlspark_tpu_torch.parallel.prefetch import Prefetcher


def map_runner(fn: Callable[[Any], Any], items: Iterable, *, depth: int,
               workers: Optional[int] = None,
               max_depth: Optional[int] = None,
               name: str = "map") -> Prefetcher:
    """Build the executing stage for a parallel map: `fn` runs on worker
    threads over `items`, results return in item order, at most `depth`
    staged-but-unconsumed (live-tunable up to `max_depth`).  `depth=0`
    is the synchronous inline mode (no threads)."""
    return Prefetcher(fn, items, depth=depth, workers=workers,
                      max_depth=max_depth, name=name)
