"""Hierarchical structured run traces: the event model under run_telemetry.

`spans.py` answers "how much total thread-time went to each pipeline
PHASE"; this module answers the question that aggregate cannot: *what did
step 1234 of that preempted run actually do* — every step, batch, decode
segment, retry, and checkpoint as a structured record with identity
(span id / parent id), a monotonic timestamp, a duration, and typed
attributes, survivable past the process.

Three consumers drive the design:

  * the **ring** — a bounded in-memory deque of completed records, so a
    live debugger (or `RunTelemetry.summary()`) can inspect the recent
    past without unbounded growth;
  * the **JSONL sink** — when a `Tracer` is given a sink path, every
    completed record streams to disk as one JSON line the moment it
    closes, so a preempted/killed run leaves a readable `run.jsonl`
    prefix (the same torn-tail tolerance checkpoints already have);
  * the **Chrome trace / Perfetto exporter** — `chrome_trace()` renders
    the ring as `trace_event` JSON (`ph: "X"` complete spans, `ph: "i"`
    instants) so a run log opens in Perfetto next to a `torch.profiler`
    trace with the same timeline idiom.

Propagation follows the capture-by-closure rule spans.py established:
the ambient tracer and current-span id live in contextvars (nested
`trace_span` blocks parent automatically on ONE thread), but prefetcher
worker threads never inherit contextvars — hot loops capture
`active_tracer()` plus a parent span handle ONCE on the consumer thread
and pass both into staging closures, recording worker-side spans with
`tracer.span(name, parent=handle)` explicitly.

Zero-cost when inactive (the `active_timings()` pattern): `trace_span` /
`trace_event` read one contextvar and return immediately when no tracer
is active, so instrumented hot loops pay a single None-check per pass.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional

from mmlspark_tpu_torch import config

DEFAULT_RING = 4096  # completed records kept in memory (the JSONL sink,
# when configured, has already persisted everything that scrolls off)

TRACE = config.register(
    "MMLSPARK_TPU_TRACE", True,
    "distributed tracing: propagate a per-request TraceContext through "
    "router dispatch, the KV handoff, and the data-service worker frames "
    "(0 disables the context plumbing; span/event recording under "
    "run_telemetry is governed by MMLSPARK_TPU_TELEMETRY)", ptype=bool)
TRACE_SAMPLE = config.register(
    "MMLSPARK_TPU_TRACE_SAMPLE", 1.0,
    "distributed tracing: head-sampled fraction of requests that keep "
    "full per-stage span detail in assembled waterfalls; the bit is "
    "derived from the trace id, so every tier of a fleet derives the "
    "SAME decision with no coordination.  Requests outside the fraction "
    "are still tail-promoted when they finish slow/shed/errored/hedged",
    ptype=float)
TRACE_SLOW_S = config.register(
    "MMLSPARK_TPU_TRACE_SLOW_S", 1.0,
    "distributed tracing: tail-sampling latency threshold — a request "
    "outside the head-sampled fraction that completes slower than this "
    "(seconds) is promoted to full-detail anyway (slow requests are "
    "exactly the ones worth a waterfall)", ptype=float)

_tracer_var: contextvars.ContextVar[Optional["Tracer"]] = \
    contextvars.ContextVar("mmlspark_tpu_tracer", default=None)
_span_var: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("mmlspark_tpu_current_span", default=None)


class Span:
    """One open span: identity + start time + mutable attrs.

    Closed (and recorded) by `finish()` / context-manager exit; attrs may
    be added any time before that (`sp.attrs["loss"] = ...`), so a step
    span can carry results only known after the step ran.
    """

    __slots__ = ("name", "span_id", "parent_id", "cat", "attrs",
                 "t0", "_tracer", "_tid", "_done")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: Optional[int], cat: str, attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.cat = cat
        self.attrs = attrs
        self._tracer = tracer
        self._tid = tracer._thread_id()
        self.t0 = tracer.now()
        self._done = False

    def elapsed(self) -> float:
        """Seconds since this span opened (for rate attrs computed before
        the span closes)."""
        return self._tracer.now() - self.t0

    def finish(self) -> dict:
        """Close the span and record it; idempotent."""
        if self._done:
            return {}
        self._done = True
        rec = {"type": "span", "name": self.name, "id": self.span_id,
               "parent": self.parent_id, "cat": self.cat,
               "ts": round(self.t0, 6),
               "dur": round(self._tracer.now() - self.t0, 6),
               "thread": self._tid, "attrs": self.attrs}
        self._tracer._record(rec)
        return rec

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class Tracer:
    """One run's span/event recorder: bounded ring + optional JSONL sink.

    Thread-safe: spans open/close and events fire from the consumer
    thread and the prefetcher's staging workers alike.  Timestamps are
    monotonic seconds relative to the tracer's epoch; `wall0` pins that
    epoch to wall-clock time for cross-referencing with external logs.
    """

    def __init__(self, ring: int = DEFAULT_RING,
                 sink_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring)
        self._ids = itertools.count(1)
        self._threads: dict[int, int] = {}   # ident -> small stable tid
        self._t0 = time.perf_counter()
        self.wall0 = time.time()
        self._sink = open(sink_path, "w") if sink_path else None
        self.dropped = 0  # records that scrolled off the ring

    # -- time / identity -------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._t0

    def _thread_id(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._threads.get(ident)
            if tid is None:
                tid = self._threads[ident] = len(self._threads)
            return tid

    # -- recording -------------------------------------------------------
    def _record(self, rec: dict) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)
            if self._sink is not None:
                # default=str: an exotic attr value (numpy scalar, Path)
                # degrades to its repr instead of killing the hot loop
                self._sink.write(json.dumps(rec, default=str) + "\n")

    def span(self, name: str, *, parent: Optional[int] = None,
             cat: str = "span", **attrs) -> Span:
        """Open a span (context manager / `finish()`); `parent` is an
        explicit span id — the handle worker threads are passed, since
        they never see the consumer's contextvars."""
        return Span(self, name, next(self._ids), parent, cat, attrs)

    def event(self, name: str, *, parent: Optional[int] = None,
              cat: str = "event", **attrs) -> dict:
        """Record an instantaneous event (duration-free marker)."""
        rec = {"type": "event", "name": name, "id": next(self._ids),
               "parent": parent, "cat": cat, "ts": round(self.now(), 6),
               "thread": self._thread_id(), "attrs": attrs}
        self._record(rec)
        return rec

    def records(self) -> list[dict]:
        """A snapshot copy of the ring (completed records, oldest first)."""
        with self._lock:
            return list(self._ring)

    def flush(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None

    # -- aggregation / export --------------------------------------------
    def span_aggregates(self) -> dict[str, dict]:
        """Per-span-name {count, total_s, max_s} over the ring — the
        rollup run_summary.json and the Prometheus exposition share."""
        return aggregate_spans(self.records())

    def chrome_trace(self) -> dict:
        """The ring as Chrome-trace/Perfetto `trace_event` JSON."""
        return chrome_trace(self.records(), wall0=self.wall0)

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, default=str)
        return path


def aggregate_spans(records: list[dict]) -> dict[str, dict]:
    """Per-name span rollup for a record list (see Tracer.span_aggregates)."""
    agg: dict[str, dict] = {}
    for rec in records:
        if rec.get("type") != "span":
            continue
        a = agg.setdefault(rec["name"], {"count": 0, "total_s": 0.0,
                                         "max_s": 0.0})
        a["count"] += 1
        a["total_s"] = round(a["total_s"] + rec["dur"], 6)
        a["max_s"] = round(max(a["max_s"], rec["dur"]), 6)
    return agg


def chrome_trace(records: list[dict], wall0: float = 0.0) -> dict:
    """Render span/event records as Chrome-trace (`trace_event`) JSON:
    `ph: "X"` complete events for spans, `ph: "i"` instants for events —
    the format Perfetto (and chrome://tracing) loads directly."""
    events = []
    for rec in records:
        kind = rec.get("type")
        if kind == "gauge":
            # gauges render as Chrome counter tracks (ph "C")
            events.append({"name": rec["name"], "ph": "C", "pid": 0,
                           "ts": round(rec["ts"] * 1e6, 3),
                           "args": {"value": rec["value"]}})
            continue
        if kind not in ("span", "event"):
            continue  # run_start / counters / stage_timings bookkeeping
        base = {"name": rec["name"], "pid": 0, "tid": rec.get("thread", 0),
                "cat": rec.get("cat", "span"),
                "ts": round(rec["ts"] * 1e6, 3),
                "args": {**rec.get("attrs", {}), "id": rec.get("id"),
                         "parent": rec.get("parent")}}
        if kind == "span":
            events.append({**base, "ph": "X",
                           "dur": round(rec["dur"] * 1e6, 3)})
        else:
            events.append({**base, "ph": "i", "s": "t"})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"wall_epoch_s": wall0,
                          "producer": "mmlspark_tpu_torch.observe.trace"}}


# -- ambient propagation (consumer-thread convenience layer) ---------------

def active_tracer() -> Optional[Tracer]:
    """The ambient tracer, or None — hot loops read this ONCE per pass and
    pass the handle (plus a parent span id) into worker closures."""
    return _tracer_var.get()


def current_span_id() -> Optional[int]:
    """The ambient current span id (the parent handle to capture for
    worker-thread spans)."""
    return _span_var.get()


@contextlib.contextmanager
def tracing(tracer: Tracer) -> Iterator[Tracer]:
    """Activate `tracer` as the ambient tracer for the block (run_telemetry
    uses this; tests can too)."""
    token = _tracer_var.set(tracer)
    try:
        yield tracer
    finally:
        _tracer_var.reset(token)


@contextlib.contextmanager
def trace_span(name: str, cat: str = "span", **attrs) -> Iterator[Optional[Span]]:
    """Ambient span: parents under the enclosing trace_span on this
    thread, yields the open Span (or None, near-free, when no tracer is
    active — the hot-loop fast path)."""
    tracer = _tracer_var.get()
    if tracer is None:
        yield None
        return
    sp = tracer.span(name, parent=_span_var.get(), cat=cat, **attrs)
    token = _span_var.set(sp.span_id)
    try:
        with sp:
            yield sp
    finally:
        _span_var.reset(token)


def trace_event(name: str, cat: str = "event", **attrs) -> Optional[dict]:
    """Ambient instantaneous event; None (no record) when inactive."""
    tracer = _tracer_var.get()
    if tracer is None:
        return None
    return tracer.event(name, parent=_span_var.get(), cat=cat, **attrs)


@contextlib.contextmanager
def span_scope(span_id: Optional[int]) -> Iterator[None]:
    """Re-parent ambient spans under an explicit span id for the block —
    how a consumer loop nests its per-item spans under a phase span it
    opened manually with `tracer.span(...)`."""
    token = _span_var.set(span_id)
    try:
        yield
    finally:
        _span_var.reset(token)


def span_on_tracer(tracer: Optional[Tracer], name: str,
                   parent: Optional[int] = None, cat: str = "span",
                   **attrs) -> Any:
    """Span against a captured tracer handle; no-op context for None —
    the worker-thread counterpart of spans.span_on."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, parent=parent, cat=cat, **attrs)


# -- distributed trace context (fleet-wide request tracing) -----------------
#
# A request that crosses a socket seam (data-service worker frames, the
# KV handoff, the HTTP front door) loses its span parentage: span ids are
# per-tracer integers with no cross-process meaning.  TraceContext is the
# Dapper-style identity that survives the wire — a 16-byte trace id (the
# request, everywhere), the sender-side parent span id (stitching hint),
# and the sampling bit — carried as one small JSON field on the existing
# control frames and re-attached on the far side.  observe/assemble.py
# joins shard records back into per-request waterfalls on the trace id.


def trace_enabled() -> bool:
    """The MMLSPARK_TPU_TRACE master switch for context propagation."""
    return bool(TRACE.current())


def new_trace_id() -> str:
    """Mint one 16-byte trace id as 32 lowercase hex chars.

    THE ONE SANCTIONED ID MINT: scripts/lint.py forbids uuid/secrets/
    os.urandom id generation everywhere else under mmlspark_tpu/, so
    cross-process stitching can rely on exactly this format."""
    return os.urandom(16).hex()


def head_sampled(trace_id: str, fraction: float) -> bool:
    """The head-sampling decision, derived FROM the trace id (first 4
    bytes as a uniform in [0, 1)): every tier of a fleet — router,
    prefill, decode, data-service workers — computes the same bit from
    the id alone, so the decision is consistent with no coordination
    and pinned across failover by construction."""
    if fraction >= 1.0:
        return True
    if fraction <= 0.0:
        return False
    return int(trace_id[:8], 16) / float(1 << 32) < fraction


class TraceContext:
    """One request's cross-process trace identity (module comment above).

    `sampled` is the HEAD decision and is immutable for the request's
    lifetime (the satellite consistency pin); tail promotion at
    completion is a separate `trace.tail_sample` event, never a flipped
    bit mid-flight.  `attempt` counts dispatch attempts (1-based) so a
    failover re-uses the trace id with a new attempt span."""

    __slots__ = ("trace_id", "parent_span", "sampled", "attempt")

    def __init__(self, trace_id: str, parent_span: Optional[int] = None,
                 sampled: bool = True, attempt: int = 1):
        self.trace_id = str(trace_id)
        self.parent_span = parent_span
        self.sampled = bool(sampled)
        self.attempt = int(attempt)

    def child(self, parent_span: Optional[int] = None,
              attempt: Optional[int] = None) -> "TraceContext":
        """Same trace id and sampling bit, new stitching point."""
        return TraceContext(
            self.trace_id,
            self.parent_span if parent_span is None else parent_span,
            self.sampled,
            self.attempt if attempt is None else attempt)

    def to_wire(self) -> dict:
        """The JSON control field that rides hello/graph/split frames and
        the kv_begin header."""
        return {"id": self.trace_id, "parent": self.parent_span,
                "sampled": self.sampled, "attempt": self.attempt}

    @classmethod
    def from_wire(cls, obj) -> Optional["TraceContext"]:
        """Parse the wire field; anything malformed degrades to None
        (an untraced request) rather than failing the frame."""
        if not isinstance(obj, dict):
            return None
        tid = obj.get("id")
        if not isinstance(tid, str) or not tid:
            return None
        parent = obj.get("parent")
        if not isinstance(parent, int):
            parent = None
        try:
            attempt = max(1, int(obj.get("attempt", 1)))
        except (TypeError, ValueError):
            attempt = 1
        return cls(tid, parent, bool(obj.get("sampled", True)), attempt)

    def attrs(self) -> dict:
        """The standard span/event attribute triple every traced record
        carries (assemble joins on `trace`)."""
        return {"trace": self.trace_id, "sampled": self.sampled,
                "attempt": self.attempt}

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id[:8]}…, "
                f"attempt={self.attempt}, sampled={self.sampled})")


def mint_context() -> Optional[TraceContext]:
    """Mint a fresh root context (router admission, bare-engine submit,
    data-service session start), or None when tracing is off — callers
    thread the None through and every downstream site stays untraced."""
    if not trace_enabled():
        return None
    tid = new_trace_id()
    return TraceContext(
        tid, sampled=head_sampled(tid, float(TRACE_SAMPLE.current())))


def tail_promote(ctx: Optional[TraceContext], *, status: str,
                 latency_s: Optional[float], hedged: bool = False,
                 retries: int = 0) -> Optional[str]:
    """The tail-sampling decision at request completion: a head-unsampled
    request that finished slow, shed, errored, timed out, hedged, or
    retried is worth full detail after all.  Returns the promotion
    reason (assemble keeps full waterfalls for promoted traces) or None;
    head-sampled requests need no promotion."""
    if ctx is None or ctx.sampled:
        return None
    if status not in ("ok",):
        return status
    if hedged:
        return "hedged"
    if retries > 0:
        return "retried"
    if latency_s is not None and latency_s > float(TRACE_SLOW_S.current()):
        return "slow"
    return None
