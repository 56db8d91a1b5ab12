"""Stage-attributed pipeline timing (the port of
`mmlspark_tpu/observe/spans.py`): within one scoring, training or
generation loop, how much thread-time went to each PIPELINE PHASE —

    host      decode / np.stack / pad / mask build (CPU-side staging)
    transfer  host->device copies
    compute   dispatch of the model step
    drain     blocking device->host fetch of results
    prefill   the prompt forward that writes the KV cache (generation)
    decode    the windowed per-token segments (generation)

— and which phase is the bottleneck.  Spans may be recorded from several
threads (thread-safe), so totals are thread-seconds, not wall.

Zero-cost when inactive: hot loops call `active_timings()` once per pass
and skip span bookkeeping entirely when no `pipeline_timing()` block is
active.  Worker threads never see the consumer's contextvars, so
collectors are captured ONCE on the consumer thread and passed explicitly
via `span_on`.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Iterator, Optional

STAGES = ("host", "transfer", "compute", "drain")
# generation phases (models/generate.py DecodeEngine); reported by
# summary() only when recorded, so scoring/training summaries stay 4-stage
GENERATE_STAGES = ("prefill", "decode")

_collector: contextvars.ContextVar[Optional["PipelineTimings"]] = \
    contextvars.ContextVar("mmlspark_tpu_pipeline_timings", default=None)


class PipelineTimings:
    """Thread-safe per-phase accumulated seconds + batch counts."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.seconds[stage] = self.seconds.get(stage, 0.0) + seconds
            self.counts[stage] = self.counts.get(stage, 0) + 1

    @contextlib.contextmanager
    def span(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0)

    def bottleneck(self) -> Optional[str]:
        """The phase with the largest accumulated thread-time.

        Under full overlap the pipeline's throughput is set by its slowest
        stage (the classic pipeline law) — this names it.
        """
        if not self.seconds:
            return None
        return max(self.seconds, key=lambda k: self.seconds[k])

    def summary(self) -> dict:
        """The bench/report schema: stage_<phase>_s fields + the verdict."""
        out = {f"stage_{s}_s": round(self.seconds.get(s, 0.0), 4)
               for s in STAGES}
        for s in sorted(set(self.seconds) - set(STAGES)):
            out[f"stage_{s}_s"] = round(self.seconds[s], 4)
        out["bottleneck"] = self.bottleneck()
        return out

    def __str__(self):
        parts = [f"{s}={self.seconds.get(s, 0.0):.3f}s" for s in STAGES]
        return f"PipelineTimings({', '.join(parts)}, " \
               f"bottleneck={self.bottleneck()})"


@contextlib.contextmanager
def pipeline_timing(timings: Optional[PipelineTimings] = None
                    ) -> Iterator[PipelineTimings]:
    """Collect per-phase spans for the dynamic extent of the block.

        with pipeline_timing() as spans:
            model.transform(table)
        print(spans.summary())   # {'stage_host_s': ..., 'bottleneck': ...}

    `timings` installs an EXISTING collector instead of a fresh one —
    how run_telemetry (observe/telemetry.py) owns the run's stage
    attribution while the hot loops keep recording through the same
    `active_timings()` fast path.
    """
    timings = timings if timings is not None else PipelineTimings()
    token = _collector.set(timings)
    try:
        yield timings
    finally:
        _collector.reset(token)


def active_timings() -> Optional[PipelineTimings]:
    """The ambient collector, or None — capture on the CONSUMER thread and
    pass into staging closures (worker threads have their own context)."""
    return _collector.get()


def monotonic() -> float:
    """The sanctioned hot-loop clock (monotonic seconds).

    Fine-grained timing in hot-loop modules rides the span machinery (so
    it is attributed and exported); the few coarse wall fields that remain
    read this one clock — a single seam instead of scattered raw timer
    calls.
    """
    return time.perf_counter()


@contextlib.contextmanager
def span_on(timings: Optional[PipelineTimings], stage: str) -> Iterator[None]:
    """Span against a captured collector; no-op (and near-free) for None."""
    if timings is None:
        yield
        return
    with timings.span(stage):
        yield
