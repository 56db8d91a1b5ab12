"""run_telemetry: one context that owns one run's telemetry (the port of
`mmlspark_tpu/observe/telemetry.py`; run summaries have the same keys).

The perf/robustness subsystems each emit fragments — `spans.py`
thread-seconds, `metrics.py` process counters, ad-hoc bench fields — with
no shared event model and no persistent run record.  `run_telemetry(dir)`
unifies them for the dynamic extent of one run:

  * a `Tracer` (observe/trace.py) streaming structured spans/events to
    `<dir>/run.jsonl` as they complete;
  * the run's `PipelineTimings` collector, installed so every existing
    `active_timings()`/`span_on` call site feeds stage attribution into
    THIS run without modification;
  * process counters snapshotted at entry — the run reports DELTAS, so
    two runs in one process (or one test after another) never bleed;
  * gauges: point-in-time samples (`rt.gauge(name, value)`) recorded as
    events and rolled up {last, max, n} — prefetch queue depth/stall
    time, shape-class counts (the recompile detectors), each card's
    `torch.cuda.memory_stats` bytes in use / peak (sampled at entry/exit
    and on demand);
  * a final `<dir>/run_summary.json`: wall time, span aggregates,
    counter deltas, gauge rollups, stage attribution + bottleneck
    verdict, memory snapshot.

`dir=None` falls back to MMLSPARK_TPU_TELEMETRY_DIR; when that is unset
too the run records in memory only (ring + summary(), no files).
MMLSPARK_TPU_TELEMETRY=0 is the kill switch: `run_telemetry` blocks
become inert (no collector installed, hot loops keep their zero-cost
fast path), so a suspect 3% can be ruled out in production without a
code change.

Zero-cost when no block is active: `active_run()` is one contextvar
read, and every instrumented hot path gates on it (or on
`active_tracer()`) exactly once per pass.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import json
import os
import time
from typing import Iterator, Optional

import torch

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe.metrics import counters_snapshot
from mmlspark_tpu_torch.observe.spans import PipelineTimings, pipeline_timing
from mmlspark_tpu_torch.observe.trace import DEFAULT_RING, Tracer, tracing

# knobs declared in the one registry (config.py): MMLSPARK_TPU_TELEMETRY
# (kill switch) and MMLSPARK_TPU_TELEMETRY_DIR (default output directory)
TELEMETRY = config.TELEMETRY
TELEMETRY_DIR = config.TELEMETRY_DIR

_active: contextvars.ContextVar[Optional["RunTelemetry"]] = \
    contextvars.ContextVar("mmlspark_tpu_run_telemetry", default=None)

# latency histogram bucket bounds (seconds) shared by every observe_hist
# family — fixed at declaration so counts are O(1) per sample and two
# shards of one fleet always bucket identically (Prometheus `le` is <=,
# so a sample exactly on a bound lands IN that bound's bucket)
HIST_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def telemetry_enabled() -> bool:
    """False only when MMLSPARK_TPU_TELEMETRY is an explicit off value."""
    raw = TELEMETRY.current()
    return str(raw).strip().lower() not in ("0", "off", "false") \
        if raw is not None else True


class RunTelemetry:
    """One run's unified telemetry state (see module docstring).

    `live=False` builds the inert form the kill switch yields: same API,
    nothing recorded, nothing written.
    """

    def __init__(self, run_dir: Optional[str] = None, *, live: bool = True,
                 ring: Optional[int] = None):
        self.dir = run_dir
        self.live = live
        sink = os.path.join(run_dir, "run.jsonl") \
            if (live and run_dir) else None
        self.tracer = Tracer(ring=ring or DEFAULT_RING, sink_path=sink)
        self.timings = PipelineTimings()
        self._counters0 = counters_snapshot() if live else {}
        self._gauges: dict[str, dict] = {}
        # latency histograms (observe_hist): incremental per-bucket counts
        # against the fixed HIST_BUCKETS bounds + sum/count/min/max — O(1)
        # memory per family no matter how many samples, which is what lets
        # the serve hot path record TTFT/inter-token without a ring
        self._hists: dict[str, dict] = {}
        # the run's serving timeline (serve/engine.py): admission, shed,
        # degrade, drain decisions in order — the machine-readable account
        # the serving tests assert against
        self._serve: list[dict] = []
        # the run's fleet-routing timeline (serve/router.py): dispatch,
        # failover, ejection, probe re-admission — what the router drills
        # assert their failover/ejection sequences against
        self._routing: list[dict] = []
        # the run's KV-handoff timeline (serve/handoff.py): transfer
        # begin/page/splice/fail events in order
        self._handoff: list[dict] = []
        # the run's prefix-pool timeline (serve/prefix_cache.py via
        # serve/engine.py): hit, insert, evict, evict_refused events in
        # order
        self._prefix: list[dict] = []
        # the run's recovery timeline (train/supervisor.py): failures,
        # rollbacks, skip windows and budget decisions in order
        self._recovery: list[dict] = []
        # the run's population-sweep timeline (train/sweep.py): start,
        # rung culls, member finals and the winner in order
        self._sweep: list[dict] = []
        # bounded-time cleanups run at finish() (e.g. stopping a metrics
        # server bound to this run) — never allowed to raise or hang the
        # run exit
        self._finalizers: list = []
        self._t0 = time.perf_counter()
        self._finished: Optional[dict] = None
        if live:
            self.tracer._record({
                "type": "run_start", "ts": 0.0,
                "wall_time": self.tracer.wall0, "pid": os.getpid()})
            self.sample_memory(tag="start")

    # -- gauges ----------------------------------------------------------
    def gauge(self, name: str, value, **attrs) -> None:
        """Record one gauge sample: a `gauge` event in the stream plus the
        {last, max, n} rollup the summary and Prometheus exposition read."""
        if not self.live:
            return
        value = float(value)
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = {"last": value, "max": value, "n": 0}
        g["last"] = value
        g["max"] = max(g["max"], value)
        g["n"] += 1
        self.tracer._record({"type": "gauge", "name": name,
                             "ts": round(self.tracer.now(), 6),
                             "value": value, "attrs": attrs})

    def gauges(self) -> dict[str, dict]:
        return {k: dict(v) for k, v in self._gauges.items()}

    # -- latency histograms -----------------------------------------------
    def observe_hist(self, name: str, value) -> None:
        """Record one latency sample into the named histogram family
        (bounded state: per-bucket counts + sum/count/min/max, never raw
        samples).  observe/export.py renders these as cumulative
        Prometheus `_bucket`/`_sum`/`_count` series."""
        if not self.live:
            return
        value = float(value)
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = {
                "counts": [0] * (len(HIST_BUCKETS) + 1),
                "sum": 0.0, "count": 0, "min": value, "max": value}
        h["counts"][bisect.bisect_left(HIST_BUCKETS, value)] += 1
        h["sum"] += value
        h["count"] += 1
        if value < h["min"]:
            h["min"] = value
        elif value > h["max"]:
            h["max"] = value

    def histograms(self) -> dict[str, dict]:
        """{name: {bounds, counts, sum, count, min, max}} — counts are
        per-bucket (NOT cumulative; exposition cumulates), the last slot
        being the +Inf overflow bucket."""
        return {name: {"bounds": list(HIST_BUCKETS),
                       "counts": list(h["counts"]),
                       "sum": round(h["sum"], 6), "count": h["count"],
                       "min": round(h["min"], 6), "max": round(h["max"], 6)}
                for name, h in self._hists.items()}

    def sample_memory(self, tag: str = "sample") -> dict:
        """Gauge each visible card's bytes in use / peak bytes in use
        (`torch.cuda.memory_stats`, allocated bytes); nothing on a host
        without a card — never fabricated."""
        out: dict[str, float] = {}
        if not self.live:
            return out
        if not torch.cuda.is_available():
            return out
        for index in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(index)
            for key, stat in (("bytes_in_use", "allocated_bytes.all.current"),
                              ("peak_bytes_in_use",
                               "allocated_bytes.all.peak")):
                if stat in stats:
                    name = f"memory.device{index}.{key}"
                    out[name] = float(stats[stat])
                    self.gauge(name, stats[stat], tag=tag)
        return out

    def program_summary(self) -> dict:
        """The per-program roofline table.  It joins compile-time program
        costs (the JAX package's observe/costmodel.py) with execution
        times; the port records no program costs yet (ROADMAP A11), so the
        table is empty, as the JAX package's is when nothing was
        recorded."""
        return {}

    # -- serving timeline --------------------------------------------------
    def record_serve(self, event: dict) -> None:
        """Append one serving-engine lifecycle event to the run's ordered
        timeline (also streamed as a `serve` record); the full list lands
        in run_summary.json under `serve` — what the serve chaos drills
        assert their shed/degrade/drain sequences against."""
        if not self.live:
            return
        rec = dict(event)
        self._serve.append(rec)
        self.tracer._record({"type": "serve",
                             "ts": round(self.tracer.now(), 6), **rec})

    def record_routing(self, event: dict) -> None:
        """Append one fleet-routing event (serve/router.py) to the run's
        ordered timeline (also streamed as a `routing` record); the full
        list lands in run_summary.json under `routing` — every dispatch,
        failover, ejection, and probe re-admission, machine-readable."""
        if not self.live:
            return
        rec = dict(event)
        self._routing.append(rec)
        self.tracer._record({"type": "routing",
                             "ts": round(self.tracer.now(), 6), **rec})

    def record_handoff(self, event: dict) -> None:
        """Append one KV-handoff event (serve/handoff.py) to the run's
        ordered timeline (also streamed as a `handoff` record); the full
        list lands in run_summary.json under `handoff` — every transfer
        begin, page rejection, splice, cancel-at-splice, and re-prefill."""
        if not self.live:
            return
        rec = dict(event)
        self._handoff.append(rec)
        self.tracer._record({"type": "handoff",
                             "ts": round(self.tracer.now(), 6), **rec})

    def record_prefix(self, event: dict) -> None:
        """Append one prefix-pool event (serve/prefix_cache.py decisions
        surfaced by serve/engine.py) to the run's ordered timeline (also
        streamed as a `prefix` record); the full list lands in
        run_summary.json under `prefix` — every hit (matched/suffix
        split), insert, eviction, and refused-under-lease eviction."""
        if not self.live:
            return
        rec = dict(event)
        self._prefix.append(rec)
        self.tracer._record({"type": "prefix",
                             "ts": round(self.tracer.now(), 6), **rec})

    def record_sweep(self, event: dict) -> None:
        """Append one population-sweep event (train/sweep.py: start, rung
        cull, member final, winner) to the run's ordered timeline (also
        streamed as a `sweep` record); the full list lands in
        run_summary.json under `sweep`."""
        if not self.live:
            return
        rec = dict(event)
        self._sweep.append(rec)
        self.tracer._record({"type": "sweep",
                             "ts": round(self.tracer.now(), 6), **rec})

    # -- finalizers --------------------------------------------------------
    def record_recovery(self, event: dict) -> None:
        """Append one recovery-supervisor event to the run's timeline
        (also streamed as a `recovery` record); the ordered list lands in
        run_summary.json under `recovery`."""
        if not self.live:
            return
        rec = dict(event)
        self._recovery.append(rec)
        self.tracer._record({"type": "recovery",
                             "ts": round(self.tracer.now(), 6), **rec})

    def add_finalizer(self, fn) -> None:
        """Register a cleanup to run at `finish()` (LIFO).  Finalizers
        must themselves be bounded-time (observe/export.py's server stop
        is); a raising finalizer is swallowed — run exit always
        completes."""
        self._finalizers.append(fn)

    # -- counters ---------------------------------------------------------
    def counter_deltas(self) -> dict[str, float]:
        """Counter movement since the block was entered (only counters
        that moved) — the per-run view that stops cross-test bleed."""
        now = counters_snapshot()
        deltas = {k: round(v - self._counters0.get(k, 0.0), 9)
                  for k, v in now.items()}
        return {k: v for k, v in deltas.items() if v}

    # -- finish ------------------------------------------------------------
    def summary(self) -> dict:
        """The run rollup (also written to run_summary.json at exit)."""
        if self._finished is not None:
            return self._finished
        return self._build_summary()

    def _slo_summary(self) -> dict:
        """Per-endpoint SLO compliance + burn rates from the serve and
        routing timelines (observe/slo.py, imported lazily so runs that
        never serve pay nothing).  Never allowed to fail the summary."""
        if not (self._serve or self._routing):
            return {}
        try:
            from mmlspark_tpu_torch.observe.slo import compute_slo
            return compute_slo(self._serve, self._routing,
                               now=self.tracer.now())
        except Exception:
            from mmlspark_tpu_torch.observe.logging import get_logger
            get_logger("observe").warning(
                "SLO rollup failed; omitting `slo` from run summary",
                exc_info=True)
            return {}

    def _build_summary(self) -> dict:
        return {
            "wall_s": round(time.perf_counter() - self._t0, 4),
            "wall_time_start": self.tracer.wall0,
            "counters": self.counter_deltas(),
            "gauges": self.gauges(),
            "histograms": self.histograms(),
            "slo": self._slo_summary(),
            "spans": self.tracer.span_aggregates(),
            "stage_timings": self.timings.summary(),
            "programs": self.program_summary(),
            "serve": [dict(e) for e in self._serve],
            "routing": [dict(e) for e in self._routing],
            "prefix": [dict(e) for e in self._prefix],
            "handoff": [dict(e) for e in self._handoff],
            "recovery": [dict(e) for e in self._recovery],
            "sweep": [dict(e) for e in self._sweep],
            # the data service's timeline (not ported yet): empty, so a
            # summary keeps the JAX package's keys
            "data_service": [],
            "trace_records_dropped": self.tracer.dropped,
        }

    def finish(self) -> dict:
        """Seal the run: final memory sample, trailing events (counter
        deltas, stage attribution, run_end), run_summary.json, sink close."""
        if self._finished is not None:
            return self._finished
        while self._finalizers:
            fn = self._finalizers.pop()
            try:
                fn()
            except Exception:  # run exit always completes
                from mmlspark_tpu_torch.observe.logging import get_logger
                get_logger("observe").warning(
                    "run finalizer %r raised; continuing run exit", fn,
                    exc_info=True)
        if not self.live:
            self._finished = {}
            return self._finished
        self.sample_memory(tag="end")
        summary = self._build_summary()
        ts = round(self.tracer.now(), 6)
        for alert in summary.get("slo", {}).get("alerts", []):
            # burn-rate alerts ride the stream too, so run.jsonl replays
            # them without re-deriving the windows
            self.tracer._record({"type": "slo_alert", "ts": ts, **alert})
        self.tracer._record({"type": "counters", "ts": ts,
                             "deltas": summary["counters"]})
        self.tracer._record({"type": "stage_timings", "ts": ts,
                             "seconds": {k: round(v, 6) for k, v in
                                         self.timings.seconds.items()},
                             "summary": summary["stage_timings"]})
        if summary["programs"]:
            # the joined roofline table rides the stream too, so the
            # report CLI renders verdicts from run.jsonl alone
            self.tracer._record({"type": "programs", "ts": ts,
                                 "programs": summary["programs"]})
        self.tracer._record({"type": "run_end", "ts": ts,
                             "wall_s": summary["wall_s"]})
        self.tracer.close()
        if self.dir:
            with open(os.path.join(self.dir, "run_summary.json"), "w") as f:
                json.dump(summary, f, indent=2, sort_keys=True,
                          default=str)
        self._finished = summary
        return summary

    def write_chrome_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Export the ring as Perfetto-loadable trace-event JSON (default:
        <dir>/trace.json when the run has a directory)."""
        if not self.live:
            return None
        if path is None:
            if not self.dir:
                raise ValueError("no path given and the run has no dir")
            path = os.path.join(self.dir, "trace.json")
        return self.tracer.write_chrome_trace(path)


@contextlib.contextmanager
def run_telemetry(run_dir: Optional[str] = None, *,
                  ring: Optional[int] = None) -> Iterator[RunTelemetry]:
    """Own one run's telemetry for the dynamic extent of the block.

        with run_telemetry("/tmp/run1") as rt:
            trainer.fit_arrays(x, y)
            model.transform(table)
        # /tmp/run1/run.jsonl + run_summary.json; rt.summary() in memory

    Nesting installs the inner run for its extent (the outer resumes
    after); the kill switch (MMLSPARK_TPU_TELEMETRY=0) yields an inert
    RunTelemetry so caller code needs no branches.
    """
    if not telemetry_enabled():
        rt = RunTelemetry(None, live=False)
        try:
            yield rt
        finally:
            rt.finish()
        return
    run_dir = run_dir if run_dir is not None else TELEMETRY_DIR.current()
    if run_dir:
        run_dir = os.path.abspath(os.path.expanduser(str(run_dir)))
        os.makedirs(run_dir, exist_ok=True)
    rt = RunTelemetry(run_dir, ring=ring)
    token = _active.set(rt)
    try:
        with tracing(rt.tracer), pipeline_timing(rt.timings):
            yield rt
    finally:
        _active.reset(token)
        rt.finish()


def active_run() -> Optional[RunTelemetry]:
    """The ambient run, or None — the hot-loop fast-path check (capture
    ONCE on the consumer thread; worker threads have their own context)."""
    return _active.get()
