"""Bounded background producer: overlap host work and transfers with compute
(the port of `mmlspark_tpu/parallel/prefetch.py`).

`Prefetcher` runs a stage function on a small thread pool; at most `depth`
staged items exist at any moment (backpressure), and results come back
strictly in submission order, so pipelining never reorders rows.

  * **Deterministic ordering**: a FIFO of futures, not a completion queue.
  * **Backpressure**: the source iterator is never advanced more than
    `depth` items past the consumer.
  * **Exception propagation**: a stage-function error surfaces in the
    consumer at the failed item's position; a source-iterator error after
    every already-staged result has been delivered.
  * **Clean shutdown**: `close()` (also via context manager) cancels
    queued work and releases the pool.

`depth=0` is a synchronous inline map on the consumer thread (prefetch
off).  The depth knob is the JAX package's: `prefetchDepth` /
`MMLSPARK_TPU_PREFETCH_DEPTH`, positive pins it, -1 is synchronous, 0
autotunes: the data layer's `Autotuner` (`data/autotune.py`) starts the
window at DEPTH_FLOOR and resizes it live (`set_depth`, up to
`max_depth`) from the counters every Prefetcher keeps (`stats()`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional

from mmlspark_tpu_torch import config

PREFETCH_DEPTH = config.register(
    "MMLSPARK_TPU_PREFETCH_DEPTH", default=8, ptype=int,
    doc="Default pipeline depth: staged batches in flight per hot loop "
        "(TPUModel scoring window). Positive values pin the depth; 0 "
        "means autotune (the data layer's Autotuner starts at the "
        "DEPTH_FLOOR and resizes from measured stage timings); -1 "
        "disables overlap (synchronous per-batch round trips).")

PREFETCH_WORKERS = config.register(
    "MMLSPARK_TPU_PREFETCH_WORKERS", default=4, ptype=int,
    doc="Staging thread-pool width per prefetcher (clamped to the depth); "
        "threads run the host stacking/padding into pinned buffers and "
        "the host->device copy.")

PREFETCH_WORKER_NS = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_WORKER_NS", default=None,
    doc="Gauge namespace prefix for Prefetcher stages running inside a "
        "data-service worker (set per process by the dispatcher at "
        "spawn, e.g. 'data.service.w3'): stage gauges publish as "
        "'<ns>.<stage>.depth' instead of 'prefetch.<stage>.depth', so "
        "N workers reporting into one metrics backend never collide. "
        "Unset: the in-process 'prefetch.' namespace.")


# The autotuner's floor: an autotuned stage starts here and is never
# narrowed below it, so "autotune" always keeps at least double buffering.
DEPTH_FLOOR = 2


def resolve_depth(value=None) -> tuple:
    """Resolve a depth knob to `(depth, autotune)`: `None` defers to
    MMLSPARK_TPU_PREFETCH_DEPTH, a positive value pins the depth, 0 asks
    for autotuning from DEPTH_FLOOR, a negative one means synchronous
    (depth 0)."""
    if value is None:
        value = int(config.get("MMLSPARK_TPU_PREFETCH_DEPTH"))
    value = int(value)
    if value > 0:
        return value, False
    if value == 0:
        return DEPTH_FLOOR, True
    return 0, False


class Prefetcher:
    """Order-preserving bounded background map over an item iterator.

        with Prefetcher(stage_fn, plans, depth=8) as staged:
            for result in staged:
                consume(result)
    """

    def __init__(self, fn: Callable[[Any], Any], items: Iterable, *,
                 depth: int, workers: Optional[int] = None,
                 max_depth: Optional[int] = None, name: str = "prefetch"):
        self._closed = False  # first: __del__ runs even if init raises
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._fn = fn
        self._items = iter(items)
        self._depth = int(depth)
        # the pool is sized for `max_depth`, so `set_depth()` can widen a
        # running stage without rebuilding threads (the Autotuner's lever)
        self._max_depth = (max(self._depth, int(max_depth))
                           if max_depth is not None else self._depth)
        if workers is None:
            workers = int(config.get("MMLSPARK_TPU_PREFETCH_WORKERS"))
        self._workers = max(1, min(int(workers), self._max_depth or 1))
        self._name = name
        self._pending: deque = deque()   # futures, submission order
        self._executor: Optional[ThreadPoolExecutor] = None
        self._source_error: Optional[BaseException] = None
        self._exhausted = False
        # the run handle is captured on the consumer thread: workers never
        # see its contextvar
        from mmlspark_tpu_torch.observe.telemetry import active_run
        self._run = active_run()
        # inside a data-service worker, gauges carry the per-worker
        # namespace the dispatcher assigned (data.service.w<k>.<stage>)
        ns = config.get("MMLSPARK_TPU_DATA_SERVICE_WORKER_NS")
        self._gauge_ns = f"{ns}.{name}" if ns else f"prefetch.{name}"
        # always-on counters, which the Autotuner reads through `stats()`
        self.stall_s = 0.0   # consumer time blocked on unfinished staging
        self.stalls = 0      # deliveries that blocked on an unfinished item
        self.deliveries = 0  # results handed to the consumer
        self.residency = 0   # sum of the staged queue's length at each one

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def max_depth(self) -> int:
        return self._max_depth

    def set_depth(self, depth: int) -> int:
        """Retune the staged window live, clamped to [1, max_depth];
        returns the depth applied.  A synchronous prefetcher (max_depth
        0) has no window and stays at 0."""
        if self._max_depth <= 0:
            return 0
        self._depth = max(1, min(int(depth), self._max_depth))
        return self._depth

    def stats(self) -> dict:
        """Counter snapshot: deliveries, stalls, stall_s, residency,
        depth, max_depth."""
        return {"deliveries": self.deliveries, "stalls": self.stalls,
                "stall_s": self.stall_s, "residency": self.residency,
                "depth": self._depth, "max_depth": self._max_depth}

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._depth == 0:
            try:
                item = next(self._items)
            except StopIteration:
                self.close()
                raise
            result = self._fn(item)
            self.deliveries += 1
            return result
        try:
            self._top_up()
            if not self._pending:
                if self._source_error is not None:
                    err, self._source_error = self._source_error, None
                    raise err
                self.close()
                raise StopIteration
            fut = self._pending.popleft()
            stalled = not fut.done()
            t0 = time.perf_counter() if stalled else 0.0
            result = fut.result()
            if stalled:
                self.stall_s += time.perf_counter() - t0
                self.stalls += 1
            self.deliveries += 1
            self.residency += len(self._pending)
            if self._run is not None:
                self._run.gauge(f"{self._gauge_ns}.depth",
                                len(self._pending))
                self._run.gauge(f"{self._gauge_ns}.stall_s",
                                round(self.stall_s, 6))
            self._top_up()
            return result
        except StopIteration:
            raise
        except BaseException:
            self.close()
            raise

    def _top_up(self) -> None:
        """Keep `depth` items staged; source errors are deferred until the
        already-staged results have been delivered."""
        while (not self._exhausted and self._source_error is None
                and len(self._pending) < self._depth):
            try:
                item = next(self._items)
            except StopIteration:
                self._exhausted = True
                break
            except BaseException as e:  # source iterator failed
                self._source_error = e
                break
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._workers,
                    thread_name_prefix=f"mmlspark-{self._name}")
            self._pending.append(self._executor.submit(self._fn, item))

    def close(self) -> None:
        """Cancel queued work and release the pool (idempotent)."""
        if self._closed or not hasattr(self, "_pending"):
            return
        self._closed = True
        for fut in self._pending:
            fut.cancel()
        self._pending.clear()
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


class OncePerTable:
    """Thread-safe lazy computation shared by one table's staged batches:
    whichever worker arrives first pays for it, the rest reuse the
    value."""

    def __init__(self, compute: Callable[[], Any]):
        self._compute = compute
        self._lock = threading.Lock()
        self._value = None
        self._done = False

    def get(self) -> Any:
        if self._done:  # fast path: no lock once materialized
            return self._value
        with self._lock:
            if not self._done:
                self._value = self._compute()
                self._done = True
        return self._value
