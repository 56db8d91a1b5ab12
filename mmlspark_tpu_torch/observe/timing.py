"""Per-stage wall timers for fit/transform (the port of
`mmlspark_tpu/observe/timing.py`).

Opt-in and zero-cost when inactive: every PipelineStage subclass's `fit` /
`transform` is wrapped at class-creation time (core/pipeline.py hooks
`instrument_stage_method` from __init_subclass__); the wrapper checks one
context variable and takes the fast path out when no collector is active.

    with stage_timing() as times:
        model = pipeline.fit(table)
        scored = model.transform(table)
    print(times.table())

Nested stages (Pipeline.fit driving per-stage fits) record with their call
depth, so the table reads as a tree.  Wall time counts what the stage's
host code waits for: stages that return host arrays (all of ours) sync
the card before they return, so their walls are fully accounted.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time
from typing import Optional

_collector: contextvars.ContextVar[Optional["StageTimings"]] = \
    contextvars.ContextVar("mmlspark_tpu_stage_timings", default=None)


class StageTimings:
    """Collected (depth, stage, uid, method, seconds) records."""

    def __init__(self):
        self.records: list[dict] = []
        self._depth = 0

    def table(self) -> str:
        """The stage-time table, indented by call depth."""
        if not self.records:
            return "(no stages timed)"
        name_w = max(2 * r["depth"] + len(r["stage"]) + 1 + len(r["method"])
                     for r in self.records)
        lines = [f"{'stage'.ljust(name_w)}  seconds"]
        for r in self.records:
            name = f"{'  ' * r['depth']}{r['stage']}.{r['method']}"
            lines.append(f"{name.ljust(name_w)}  {r['seconds']:8.3f}")
        return "\n".join(lines)

    def total(self, stage: Optional[str] = None) -> float:
        """Sum of top-level stage walls (nested calls excluded to avoid
        double counting), optionally for one stage class."""
        return sum(r["seconds"] for r in self.records
                   if r["depth"] == 0 and (stage is None or r["stage"] == stage))

    def __str__(self):
        return self.table()


@contextlib.contextmanager
def stage_timing():
    """Activate stage timing for the dynamic extent of the block."""
    timings = StageTimings()
    token = _collector.set(timings)
    try:
        yield timings
    finally:
        _collector.reset(token)


def instrument_stage_method(method_name: str, fn):
    """Wrap a fit/transform definition; called from PipelineStage's
    __init_subclass__ so every stage in and out of the framework is covered
    without per-stage code."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        timings = _collector.get()
        if timings is None:
            return fn(self, *args, **kwargs)
        # type(self), not the defining class: a subclass inheriting
        # transform must show under its own name in the timing tree
        record = {"depth": timings._depth, "stage": type(self).__name__,
                  "uid": getattr(self, "uid", "?"), "method": method_name,
                  "seconds": 0.0}
        timings.records.append(record)  # pre-insert: tree order, not finish order
        timings._depth += 1
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kwargs)
        finally:
            record["seconds"] = time.perf_counter() - t0
            timings._depth -= 1

    wrapper.__mmlspark_instrumented__ = True
    return wrapper
