"""Composable streaming Dataset graph (the port of
`mmlspark_tpu/data/dataset.py`): the ingestion path as a pipeline.

The tf.data construction (Murray et al., arXiv:2101.12127): a declarative
graph of sources and ops,

    ds = (Dataset.from_files("imgs/**/*.png")
            .batch(256)
            .map(decode_chunk, name="decode")
            .prefetch())
    with ds.iterator() as it:
        for chunk in it:
            ...

where `map` runs its function on parallel workers (order-preserving),
`prefetch` decouples producer from consumer with a bounded buffer, and
every parallel stage is an `executor.map_runner` Prefetcher underneath,
so the ordering, backpressure, exception-at-position and clean-shutdown
contracts hold stage by stage.

Graphs are plans: each op closes over its parent and nothing executes
until `iterator()` builds the chain.  Building is eager per stage (the
runners exist at once, so the `Autotuner` can see them) but pulling is
lazy (no source item is read before the first `next`).  Stage depths
follow the shared knob contract (`resolve_depth`): positive pins, 0
autotunes from the floor, negative is synchronous.  When any stage asked
for autotuning, the iterator runs an `Autotuner` (data/autotune.py) over
those stages.

Row-level error policy on `map` is the shared `on_error` contract
(core/pipeline.py): "fail" re-raises at the failed item's position,
"skip" drops the row and reports it through `record_skipped_rows`, and
"column" keeps the row as a `MapError(item, error)`.

The JAX package also records a declarative spec of every node, which its
`data/graph.py` serializes for its data service; neither is ported, and
`distribute` raises (ROADMAP A12).  `snapshot(tag)` exposes a
consumed-element offset for mid-epoch resume (data/snapshot.py).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Iterator, Optional

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.core.pipeline import check_on_error, record_skipped_rows
from mmlspark_tpu_torch.data import executor
from mmlspark_tpu_torch.data.autotune import Autotuner
from mmlspark_tpu_torch.observe.spans import active_timings, span_on
from mmlspark_tpu_torch.parallel.prefetch import resolve_depth

_OK = object()   # map wrapper tags (identity-compared, never user-visible)
_ERR = object()


class MapError:
    """A row that failed `map` under on_error="column": carries the input
    item and the exception, in the row's original stream position."""

    __slots__ = ("item", "error")

    def __init__(self, item, error: BaseException):
        self.item = item
        self.error = error

    def __repr__(self):
        return f"MapError({type(self.error).__name__}: {self.error})"


class _StageHandle:
    """One executing parallel stage: its graph name, the live Prefetcher
    runner, and whether the depth knob asked for autotuning."""

    def __init__(self, name: str, runner, tunable: bool):
        self.name = name
        self.runner = runner
        self.tunable = tunable


def _stage_depth(depth):
    """Resolve one stage's depth knob -> (depth, autotune, max_depth,
    workers_default).  Tunable stages get headroom up to
    MMLSPARK_TPU_DATA_MAX_DEPTH and a pool wide enough that widening the
    window recruits more workers."""
    d, tune = resolve_depth(depth)
    if not tune:
        return d, False, None, None
    cap = max(d, int(config.get("MMLSPARK_TPU_DATA_MAX_DEPTH")))
    workers = max(1, int(config.get("MMLSPARK_TPU_DATA_MAX_WORKERS")))
    return d, True, cap, workers


class Dataset:
    """A lazily-evaluated pipeline plan.  Ops return new Datasets; no
    work happens until `iterator()` (or plain `for ... in ds`)."""

    def __init__(self, make_iter: Callable[["DatasetIterator"], Iterator],
                 name: str):
        self._make_iter = make_iter
        self._name = name

    # -- sources --------------------------------------------------------
    @staticmethod
    def from_iterable(items, name: str = "iterable") -> "Dataset":
        """Wrap an iterable — or a zero-arg callable returning one, which
        makes the dataset re-iterable — as a source."""
        def make(it):
            return iter(items() if callable(items) else items)
        return Dataset(make, name)

    @staticmethod
    def from_files(path: str, *, recursive: bool = False,
                   sample_ratio: float = 1.0, inspect_zip: bool = True,
                   pattern: Optional[str] = None, seed: int = 0,
                   name: str = "files") -> "Dataset":
        """Stream `(path, bytes)` pairs from a directory/glob/zip via
        `io.files.iter_binary_files` — enumeration and reads stay
        sequential on the pulling thread (ordering is part of the
        contract); parallelism comes from downstream `map`."""
        def make(it):
            from mmlspark_tpu_torch.io.files import iter_binary_files
            return iter_binary_files(path, recursive=recursive,
                                     sample_ratio=sample_ratio,
                                     inspect_zip=inspect_zip,
                                     pattern=pattern, seed=seed)
        return Dataset(make, name)

    @staticmethod
    def from_table(table, columns: Optional[list] = None,
                   name: str = "table") -> "Dataset":
        """Stream a DataTable as per-row dicts of the selected columns
        (all columns by default), in row order."""
        def make(it):
            cols = list(columns) if columns is not None else table.columns
            arrays = {c: table[c] for c in cols}
            n = len(table)
            return ({c: arrays[c][i] for c in cols} for i in range(n))
        return Dataset(make, name)

    # -- ops ------------------------------------------------------------
    def map(self, fn: Callable[[Any], Any], *, name: str = "map",
            depth: Optional[int] = None, workers: Optional[int] = None,
            on_error: str = "fail",
            span: Optional[str] = "host") -> "Dataset":
        """Parallel per-element map: `fn` runs on worker threads, results
        are delivered strictly in input order regardless of completion
        order.  `depth` follows the shared knob contract (None = config,
        positive pins, 0 autotunes, negative = inline on the pulling
        thread).  `span` attributes worker time to a pipeline-timings
        stage (observe/spans.py); pass None when `fn` instruments itself.
        `on_error`: "fail" | "skip" | "column" (module docstring)."""
        check_on_error(on_error)
        parent = self

        def make(it):
            upstream = parent._make_iter(it)
            d, tune, cap, wdef = _stage_depth(depth)
            timings = it.timings
            if span is None:
                inner = fn
            else:
                def inner(item):
                    with span_on(timings, span):
                        return fn(item)
            if on_error == "fail":
                work = inner  # raw fn: Prefetcher's native
                # exception-at-position contract IS the fail policy
            else:
                def work(item):
                    try:
                        return _OK, inner(item)
                    except Exception as e:
                        return _ERR, (item, e)
            runner = executor.map_runner(
                work, upstream, depth=d,
                workers=workers if workers is not None else wdef,
                max_depth=cap, name=name)
            it.register(name, runner, tunable=tune)
            if on_error == "fail":
                return iter(runner)

            def gen():
                for tag, val in runner:
                    if tag is _OK:
                        yield val
                    elif on_error == "skip":
                        item, err = val
                        record_skipped_rows(
                            f"data.map.{name}", 1,
                            f"{type(err).__name__}: {err}")
                    else:  # column
                        yield MapError(*val)
            return gen()
        return Dataset(make, f"{self._name}.map({name})")

    def batch(self, batch_size: int,
              drop_remainder: bool = False) -> "Dataset":
        """Group consecutive elements into lists of `batch_size` (the
        final short batch is kept unless drop_remainder)."""
        if batch_size <= 0:
            raise ValueError(
                f"batch_size must be positive, got {batch_size}")
        parent = self

        def make(it):
            upstream = parent._make_iter(it)

            def gen():
                buf: list = []
                for item in upstream:
                    buf.append(item)
                    if len(buf) >= batch_size:
                        yield buf
                        buf = []
                if buf and not drop_remainder:
                    yield buf
            return gen()
        return Dataset(make, f"{self._name}.batch")

    def shuffle(self, buffer_size: int, *, seed: int = 0) -> "Dataset":
        """Seeded windowed shuffle: a `buffer_size` reservoir is kept
        full and each pull swaps out a seeded-random slot.  The order is
        a pure function of (seed, input order), so every fresh iteration
        replays identically — resume is re-iterate + `skip(consumed)`,
        the same replay discipline as Trainer's epoch orders."""
        if buffer_size <= 0:
            raise ValueError(
                f"buffer_size must be positive, got {buffer_size}")
        parent = self

        def make(it):
            upstream = parent._make_iter(it)

            def gen():
                rng = random.Random(seed)
                buf: list = []

                def pop():
                    i = rng.randrange(len(buf))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    return buf.pop()
                for item in upstream:
                    buf.append(item)
                    if len(buf) >= buffer_size:
                        yield pop()
                while buf:
                    yield pop()
            return gen()
        return Dataset(make, f"{self._name}.shuffle")

    def interleave(self, sub_fn: Callable[[Any], Any], *,
                   cycle_length: int, block_length: int = 1) -> "Dataset":
        """Fan-in over sharded sub-streams: `sub_fn(item)` opens a
        Dataset (or any iterable) per input element; `cycle_length` of
        them are open at once and served round-robin, `block_length`
        elements per visit.  When one ends, the next input element's
        stream takes its slot — deterministic given the input order."""
        if cycle_length <= 0:
            raise ValueError(
                f"cycle_length must be positive, got {cycle_length}")
        if block_length <= 0:
            raise ValueError(
                f"block_length must be positive, got {block_length}")
        parent = self

        def make(it):
            upstream = parent._make_iter(it)

            def open_sub(item):
                sub = sub_fn(item)
                if isinstance(sub, Dataset):
                    return sub._make_iter(it)  # sub-stages share plumbing
                return iter(sub)

            def gen():
                active: list = []
                for item in upstream:
                    active.append(open_sub(item))
                    if len(active) >= cycle_length:
                        break
                idx = 0
                while active:
                    if idx >= len(active):
                        idx = 0
                    ended = False
                    for _ in range(block_length):
                        try:
                            yield next(active[idx])
                        except StopIteration:
                            ended = True
                            break
                    if ended:
                        try:
                            active[idx] = open_sub(next(upstream))
                        except StopIteration:
                            active.pop(idx)
                    else:
                        idx += 1
            return gen()
        return Dataset(make, f"{self._name}.interleave")

    def prefetch(self, depth: Optional[int] = None, *,
                 name: str = "prefetch") -> "Dataset":
        """Decouple producer from consumer with a bounded buffer: one
        background thread pulls upstream while the consumer works on
        earlier elements.  Same depth knob contract as `map`; depth that
        resolves to 0 makes this a passthrough.  Note the upstream is
        then pulled on the buffer thread — don't add `prefetch` below
        sources whose pulls must stay on the consumer thread (Trainer's
        rng-ordered plan)."""
        parent = self

        def make(it):
            upstream = parent._make_iter(it)
            d, tune, cap, _ = _stage_depth(depth)
            if d <= 0:
                return upstream

            def pull(_marker):
                try:
                    return True, next(upstream)
                except StopIteration:
                    return False, None
            # workers=1: a single buffer thread keeps upstream pulls
            # serialized, so ordering needs no further machinery
            runner = executor.map_runner(pull, itertools.repeat(None),
                                         depth=d, workers=1,
                                         max_depth=cap, name=name)
            it.register(name, runner, tunable=tune)

            def gen():
                for ok, val in runner:
                    if not ok:
                        break
                    yield val
                runner.close()
            return gen()
        return Dataset(make, f"{self._name}.prefetch")

    def skip(self, n: int) -> "Dataset":
        """Drop the first `n` elements (the resume idiom: replay the
        seeded stream, skip what the previous run consumed)."""
        parent = self

        def make(it):
            upstream = parent._make_iter(it)
            return itertools.islice(upstream, max(0, int(n)), None)
        return Dataset(make, f"{self._name}.skip")

    def take(self, n: int) -> "Dataset":
        """Keep only the first `n` elements."""
        parent = self

        def make(it):
            upstream = parent._make_iter(it)
            return itertools.islice(upstream, max(0, int(n)))
        return Dataset(make, f"{self._name}.take")

    def snapshot(self, tag: str = "default") -> "Dataset":
        """Count delivered elements into the process-wide snapshot
        registry (data/snapshot.py) under `tag`, so a checkpoint can
        record a mid-epoch consumed offset in its `.meta.json` sidecar.
        On the next `iterator()` after `set_restore_offsets`, the recorded
        offset is replayed by dropping the first `offset` elements of the
        seeded local stream."""
        parent = self

        def make(it):
            from mmlspark_tpu_torch.data import snapshot as snapmod
            upstream = parent._make_iter(it)
            handle = snapmod.register(tag)
            pending = snapmod.take_restore(tag)
            if pending:
                upstream = itertools.islice(upstream, pending, None)
                handle.consumed = pending

            def gen():
                for item in upstream:
                    handle.consumed += 1
                    yield item
            return gen()
        return Dataset(make, f"{self._name}.snapshot")

    def distribute(self, service=None, **_kwargs) -> "Dataset":
        """The disaggregated data service (the JAX package's
        `Dataset.distribute`, its dispatcher and worker processes) is not
        ported."""
        raise NotImplementedError(
            "Dataset.distribute: the data service is not ported (ROADMAP "
            "A12); iterate the graph locally")

    # -- execution ------------------------------------------------------
    def iterator(self, *, autotune: Optional[bool] = None,
                 interval: Optional[int] = None) -> "DatasetIterator":
        """Build the executing chain.  `autotune=None` (default) runs
        the Autotuner iff some stage's depth knob asked for it; False
        forces it off (tunable stages stay at their floor); True is
        only meaningful with tunable stages present."""
        return DatasetIterator(self, autotune=autotune, interval=interval)

    def __iter__(self) -> "DatasetIterator":
        return self.iterator()


class DatasetIterator:
    """The executing side of a Dataset: iterate it, `close()` it (also
    via `with`), and inspect `stages` / `tuner` for live depths."""

    def __init__(self, dataset: Dataset, *,
                 autotune: Optional[bool] = None,
                 interval: Optional[int] = None):
        self._closed = False
        self.stages: list[_StageHandle] = []
        # captured HERE on the consumer thread: map workers never see the
        # timings contextvar (the same capture-by-closure rule as every
        # hot loop in the repo)
        self.timings = active_timings()
        self._it = dataset._make_iter(self)
        tunable = [s for s in self.stages if s.tunable]
        self.tuner = (Autotuner(tunable, interval=interval)
                      if tunable and autotune is not False else None)

    # called by each op's `make` as the chain is assembled
    def register(self, name: str, runner, tunable: bool = False):
        self.stages.append(_StageHandle(name, runner, tunable))
        return runner

    def stage(self, name: str) -> Optional[_StageHandle]:
        for s in self.stages:
            if s.name == name:
                return s
        return None

    def __iter__(self) -> "DatasetIterator":
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        try:
            item = next(self._it)
        except BaseException:
            self.close()
            raise
        if self.tuner is not None:
            self.tuner.tick()
        return item

    def close(self) -> None:
        """Shut down every stage's pool (idempotent); sink-to-source so
        upstream runners stop feeding closed consumers."""
        if self._closed:
            return
        self._closed = True
        for s in reversed(self.stages):
            s.runner.close()

    def __enter__(self) -> "DatasetIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
