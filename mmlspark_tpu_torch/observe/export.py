"""Metrics export: Prometheus text exposition over counters/gauges/spans
(the port of `mmlspark_tpu/observe/export.py`; the metric names are the
same, so one scrape config reads either package).

The TensorFlow system paper (PAPERS.md) credits built-in metrics — not
bolt-on profiling — for production viability; this is the pull surface:
`prometheus_text()` renders the process counters (observe/metrics.py),
the active run's gauges, its per-span-name aggregates, and its stage
attribution as Prometheus text exposition format (version 0.0.4), so a
run is scrapeable by any standard collector.

Two pull transports, both dependency-free:

  * `write_metrics(path)` — file pull (node_exporter textfile-collector
    style: a cron/sidecar ships the file);
  * `serve_metrics(port)` — a stdlib-only `http.server` thread answering
    GET /metrics; returns the server (its bound port at
    `server.server_address[1]`, stop with `server.shutdown()`).

Metric naming: every name is prefixed `mmlspark_tpu_`, sanitized to the
Prometheus charset, counters suffixed `_total`.  Counter values are the
process-wide ABSOLUTE tallies (Prometheus counters are cumulative by
contract; rate() handles resets) — per-run deltas live in
run_summary.json, not here.
"""

from __future__ import annotations

import re
import threading
from typing import Optional

from mmlspark_tpu_torch.observe.metrics import counters_snapshot
from mmlspark_tpu_torch.observe.telemetry import RunTelemetry, active_run

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
PREFIX = "mmlspark_tpu"


def _metric_name(name: str, suffix: str = "") -> str:
    base = _NAME_RE.sub("_", name.strip())
    if base and base[0].isdigit():
        base = "_" + base
    return f"{PREFIX}_{base}{suffix}"


def _label_value(value) -> str:
    """Escape a label value per the exposition grammar (backslash, quote,
    newline) — program keys carry shape tuples like '(16, 32, 3):uint8'."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt(value: float) -> str:
    value = float(value)
    return repr(int(value)) if value == int(value) else repr(value)


def prometheus_text(run: Optional[RunTelemetry] = None) -> str:
    """The exposition document.  `run` defaults to the ambient
    run_telemetry block; with no run active, counters alone are exposed
    (they are process-wide and always meaningful)."""
    run = run if run is not None else active_run()
    lines: list[str] = []

    counters = counters_snapshot()
    for name in sorted(counters):
        metric = _metric_name(name, "_total")
        lines.append(f"# HELP {metric} mmlspark_tpu process counter "
                     f"{name!r}")
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(counters[name])}")

    # circuit-breaker state per endpoint (resilience/breaker.py): live
    # process-wide snapshots like the counters, so a tripped breaker is
    # visible to a scraper whether or not a run block is active.
    # state codes: 0 closed, 1 half-open, 2 open (breaker.STATE_CODES)
    from mmlspark_tpu_torch.resilience.breaker import breakers_snapshot
    breakers = breakers_snapshot()
    if breakers:
        state = _metric_name("breaker_state")
        retry = _metric_name("breaker_retry_in_s")
        fails = _metric_name("breaker_consecutive_failures")
        lines.append(f"# HELP {state} circuit-breaker state per endpoint "
                     f"(0=closed, 1=half-open, 2=open)")
        lines.append(f"# TYPE {state} gauge")
        for ep in sorted(breakers):
            lines.append(f'{state}{{endpoint="{_label_value(ep)}"}} '
                         f"{_fmt(breakers[ep]['state_code'])}")
        lines.append(f"# HELP {retry} seconds until the endpoint's next "
                     f"half-open probe is allowed (0 when closed/due)")
        lines.append(f"# TYPE {retry} gauge")
        for ep in sorted(breakers):
            lines.append(f'{retry}{{endpoint="{_label_value(ep)}"}} '
                         f"{_fmt(breakers[ep]['retry_in_s'])}")
        lines.append(f"# HELP {fails} consecutive failures recorded "
                     f"against the endpoint")
        lines.append(f"# TYPE {fails} gauge")
        for ep in sorted(breakers):
            lines.append(
                f'{fails}{{endpoint="{_label_value(ep)}"}} '
                f"{_fmt(breakers[ep]['consecutive_failures'])}")

    if run is not None and run.live:
        # latency histograms (RunTelemetry.observe_hist): real Prometheus
        # histogram families — cumulative `le` buckets (a sample counts in
        # ITS bucket and every larger one, closing with +Inf == _count),
        # plus _sum/_count, the shape rate()/histogram_quantile() expect
        for name, h in sorted(run.histograms().items()):
            metric = _metric_name(name + "_seconds")
            lines.append(f"# HELP {metric} mmlspark_tpu latency "
                         f"histogram {name!r} (seconds)")
            lines.append(f"# TYPE {metric} histogram")
            cum = 0
            for bound, count in zip(h["bounds"], h["counts"]):
                cum += count
                lines.append(f'{metric}_bucket{{le="{_fmt(bound)}"}} '
                             f"{cum}")
            cum += h["counts"][-1]
            lines.append(f'{metric}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{metric}_sum {_fmt(h['sum'])}")
            lines.append(f"{metric}_count {h['count']}")

        for name, g in sorted(run.gauges().items()):
            metric = _metric_name(name)
            lines.append(f"# HELP {metric} mmlspark_tpu run gauge "
                         f"{name!r} (last sample; _max variant below)")
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {_fmt(g['last'])}")
            lines.append(f"{metric}_max {_fmt(g['max'])}")

        agg = run.tracer.span_aggregates()
        if agg:
            secs = _metric_name("span_seconds", "_total")
            cnt = _metric_name("span", "_total")
            lines.append(f"# HELP {secs} total seconds per span name")
            lines.append(f"# TYPE {secs} counter")
            for name in sorted(agg):
                lines.append(f'{secs}{{name="{name}"}} '
                             f"{_fmt(agg[name]['total_s'])}")
            lines.append(f"# HELP {cnt} span count per span name")
            lines.append(f"# TYPE {cnt} counter")
            for name in sorted(agg):
                lines.append(f'{cnt}{{name="{name}"}} '
                             f"{_fmt(agg[name]['count'])}")

        progs = run.program_summary()
        if progs:
            # the roofline gauges (observe/costmodel.py): one sample per
            # program, labeled by call site + shape-class key, each metric
            # name with its # HELP/# TYPE metadata once
            fields = (
                ("program_mfu", "mfu",
                 "model-FLOPs utilization per program "
                 "(achieved FLOP/s over the card bf16 peak)"),
                ("program_hbm_bw_util", "hbm_bw_util",
                 "HBM-bandwidth utilization per program "
                 "(achieved bytes/s over the card HBM peak)"),
                ("program_step_seconds", "step_s",
                 "per-execution seconds of one program "
                 "(span wall, device time or probe; see step_basis)"),
                ("program_flops", "flops",
                 "FLOPs per execution of one program "
                 "(the cost counter, kernels included)"),
                ("program_bytes_accessed", "bytes_accessed",
                 "bytes accessed per execution of one program "
                 "(the cost counter, kernels included)"),
            )
            for metric_base, field, help_text in fields:
                samples = [(key, p[field]) for key, p in sorted(
                    progs.items()) if p.get(field) is not None]
                if not samples:
                    continue
                metric = _metric_name(metric_base)
                lines.append(f"# HELP {metric} {help_text}")
                lines.append(f"# TYPE {metric} gauge")
                for key, value in samples:
                    p = progs[key]
                    lines.append(
                        f'{metric}{{where="{_label_value(p["where"])}",'
                        f'program="{_label_value(p["program"])}"}} '
                        f"{_fmt(value)}")

        if run.timings.seconds:
            stage = _metric_name("stage_seconds", "_total")
            lines.append(f"# HELP {stage} thread-seconds per pipeline "
                         f"stage (observe/spans.py)")
            lines.append(f"# TYPE {stage} counter")
            for name in sorted(run.timings.seconds):
                lines.append(f'{stage}{{stage="{name}"}} '
                             f"{_fmt(run.timings.seconds[name])}")

    return "\n".join(lines) + "\n"


def write_metrics(path: str, run: Optional[RunTelemetry] = None) -> str:
    """File-pull exposition (textfile-collector style)."""
    with open(path, "w") as f:
        f.write(prometheus_text(run))
    return path


def stop_server(server, timeout_s: float = 2.0) -> bool:
    """Stop an HTTP server started here within a bounded time.

    `HTTPServer.shutdown()` blocks until the serve_forever loop notices —
    normally milliseconds, but a wedged handler (a hung client mid-write)
    can hold it arbitrarily; this calls it from a reaper thread and waits
    at most `timeout_s` before closing the listening socket regardless,
    so a telemetry exit (or a graceful drain) is never held hostage by
    one stuck connection.  Returns True when the loop confirmed shutdown
    inside the budget."""
    stopper = threading.Thread(target=server.shutdown, daemon=True,
                               name="mmlspark-metrics-stop")
    stopper.start()
    stopper.join(timeout_s)
    clean = not stopper.is_alive()
    if not clean:
        from mmlspark_tpu_torch.observe.logging import get_logger
        get_logger("observe.export").warning(
            "metrics server did not confirm shutdown within %.1fs; "
            "closing its socket anyway", timeout_s)
    server.server_close()
    return clean


def serve_metrics(port: int = 0, host: str = "127.0.0.1",
                  run: Optional[RunTelemetry] = None):
    """Serve GET /metrics on a daemon thread (stdlib http.server only).

    `run` is captured HERE, on the caller's thread: the server thread
    never sees the caller's contextvars (the same capture-by-closure rule
    as spans.py), so the ambient run must be bound at call time.  When a
    live run is bound, the server registers a run finalizer so the
    run_telemetry exit stops it with `stop_server`'s bounded wait —
    a run block never leaks its scrape port.

    Unknown paths get a 404 and errors carry an explicit text/plain
    Content-Type (BaseHTTPRequestHandler's default error page is HTML —
    wrong for a metrics port whose only consumers speak plain text).
    Returns the HTTPServer; port 0 binds an ephemeral port (read it back
    from `server.server_address[1]`), `stop_server(server)` (or
    `server.shutdown()`) stops it.
    """
    import http.server

    run = run if run is not None else active_run()

    class Handler(http.server.BaseHTTPRequestHandler):
        # explicit Content-Type on every error response (404s included)
        error_content_type = "text/plain; charset=utf-8"
        error_message_format = "%(code)d %(message)s\n"

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404, "unknown path (try /metrics)")
                return
            body = prometheus_text(run).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            from mmlspark_tpu_torch.observe.logging import get_logger
            get_logger("observe.export").debug(fmt, *args)

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="mmlspark-metrics")
    thread.start()
    if run is not None and run.live:
        run.add_finalizer(lambda: stop_server(server))
    return server
