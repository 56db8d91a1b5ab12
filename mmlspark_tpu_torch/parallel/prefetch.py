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
`MMLSPARK_TPU_PREFETCH_DEPTH`, positive pins it, -1 is synchronous; 0
(autotune) needs the data layer's Autotuner, which is not ported, and
raises (`resolve_depth`).
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
        "(TPUModel scoring window). Positive values pin the depth; -1 "
        "disables overlap (synchronous per-batch round trips); 0 "
        "(autotune) is not ported and raises.")

PREFETCH_WORKERS = config.register(
    "MMLSPARK_TPU_PREFETCH_WORKERS", default=4, ptype=int,
    doc="Staging thread-pool width per prefetcher (clamped to the depth); "
        "threads run the host stacking/padding into pinned buffers and "
        "the host->device copy.")


def resolve_depth(value=None) -> int:
    """Resolve a depth knob to a depth: `None` defers to
    MMLSPARK_TPU_PREFETCH_DEPTH, a positive value pins the depth, a
    negative one means synchronous (depth 0); 0 asks for the data layer's
    Autotuner, which the port does not have yet, and raises."""
    if value is None:
        value = int(config.get("MMLSPARK_TPU_PREFETCH_DEPTH"))
    value = int(value)
    if value == 0:
        raise NotImplementedError(
            "prefetch depth 0 (autotune) needs the data layer's Autotuner, "
            "which is not ported (ROADMAP A12); pin a positive depth or "
            "pass -1 for synchronous staging")
    return max(value, 0)


class Prefetcher:
    """Order-preserving bounded background map over an item iterator.

        with Prefetcher(stage_fn, plans, depth=8) as staged:
            for result in staged:
                consume(result)
    """

    def __init__(self, fn: Callable[[Any], Any], items: Iterable, *,
                 depth: int, workers: Optional[int] = None,
                 name: str = "prefetch"):
        self._closed = False  # first: __del__ runs even if init raises
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._fn = fn
        self._items = iter(items)
        self._depth = int(depth)
        if workers is None:
            workers = int(config.get("MMLSPARK_TPU_PREFETCH_WORKERS"))
        self._workers = max(1, min(int(workers), self._depth or 1))
        self._name = name
        self._pending: deque = deque()   # futures, submission order
        self._executor: Optional[ThreadPoolExecutor] = None
        self._source_error: Optional[BaseException] = None
        self._exhausted = False
        # the run handle is captured on the consumer thread: workers never
        # see its contextvar
        from mmlspark_tpu_torch.observe.telemetry import active_run
        self._run = active_run()
        self.stall_s = 0.0   # consumer time blocked on unfinished staging

    @property
    def depth(self) -> int:
        return self._depth

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
            return self._fn(item)
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
            if self._run is not None:
                self._run.gauge(f"prefetch.{self._name}.depth",
                                len(self._pending))
                self._run.gauge(f"prefetch.{self._name}.stall_s",
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
