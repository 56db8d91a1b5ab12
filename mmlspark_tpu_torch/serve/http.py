"""The stdlib-only HTTP front end: request/response mapping, no policy
(the port of `mmlspark_tpu/serve/http.py`).

Endpoints (all JSON, all dependency-free — the same zero-dependency
stance as observe/export.serve_metrics, which typically runs on the
neighboring port):

    GET  /healthz   liveness: 200 while the process can answer at all
                    (503 only once the engine has fully stopped)
    GET  /readyz    readiness: 200 only when warmup has run every warm
                    bucket's programs (and so built the kernels) AND
                    the engine is not draining —
                    the signal a load balancer routes on
    GET  /statz     the engine's stats dict (counts, percentiles,
                    breaker state; for a router, per-replica health
                    sections) — the drill/bench scrape surface
    POST /generate  body {"prompt": [ids], "max_new_tokens"?: n,
                    "deadline_ms"?: m} -> 200 {"tokens": [...],
                    "degraded": bool, "latency_ms": x}.
                    With "stream": true the response is chunked
                    (Transfer-Encoding: chunked) NDJSON: a {"tokens":
                    [...]} line per segment-boundary flush, a
                    {"restart": true} line when a router failover
                    bumped the stream epoch (previously streamed
                    partials are void), and a final {"done": true,
                    "status": ..., "tokens": [all]} line carrying the
                    authoritative full output.

Error mapping is the admission contract made visible: shed ->
429 + Retry-After (Overloaded.retry_after_s; a router retry-budget
shed maps the same way after admission), poison -> 400, deadline
death -> 504, drain cancellation -> 503 + Retry-After (the engine's
live `retry_after_s()` — remaining drain time, not a constant).  Every
error body is JSON with an explicit Content-Type; a client can always
machine-read why it was refused.

This module only DEFINES the handler (`make_handler(engine)`), bound to
a `ServingEngine` OR a `Router` — the router duck-types the serving
surface (submit/stats/state/ready/now/cfg/retry_after_s), so one front
end serves both.  The server itself — thread, socket — is constructed by
serve/lifecycle.py, the one module of serve/ that does so.  The
handler sets a socket timeout, so a slow or hung client stalls only its
own connection thread, never the engine: its read raises, the
connection drops, everyone else keeps streaming.
"""

from __future__ import annotations

import http.server
import json
import time

from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.serve.admission import InvalidRequest, Overloaded
from mmlspark_tpu_torch.serve.request import CANCELLED, OK, SHED, TIMEOUT

# socket timeout per connection: a hung client's read/write raises
# instead of parking a handler thread forever
CLIENT_TIMEOUT_S = 30.0

# streaming poll cadence: how long one stream_wait parks between checks
# (real seconds — streaming rides the front-end thread, never the
# scheduler)
STREAM_POLL_S = 0.05


def make_handler(engine):
    """The BaseHTTPRequestHandler subclass bound to one engine/router."""

    class ServeHandler(http.server.BaseHTTPRequestHandler):
        # HTTP/1.1 for Transfer-Encoding: chunked (streaming); every
        # non-streamed response carries Content-Length, so keep-alive
        # stays correct
        protocol_version = "HTTP/1.1"
        timeout = CLIENT_TIMEOUT_S
        error_content_type = "application/json"
        error_message_format = '{"error": "%(code)d %(message)s"}\n'

        def _json(self, code: int, payload: dict,
                  headers: dict = None) -> None:
            body = (json.dumps(payload) + "\n").encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                # the client vanished mid-response (hung/killed): its
                # connection is its own problem — drop it quietly rather
                # than spraying tracebacks from the handler thread
                get_logger("serve.http").debug(
                    "client gone before response (%d)", code)

        # -- health/readiness ------------------------------------------
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
            path = self.path.split("?")[0]
            if path == "/healthz":
                role = getattr(engine, "role", None) or (
                    "tiered" if getattr(engine, "tiered", False) else None)
                body = {"status": "ok", "state": engine.state}
                if role:
                    body["role"] = role
                if engine.state == "stopped":
                    self._json(503, {"status": "stopped"})
                else:
                    self._json(200, body)
            elif path == "/readyz":
                if engine.ready:
                    self._json(200, {"ready": True})
                else:
                    self._json(503, {"ready": False,
                                     "state": engine.state})
            elif path == "/statz":
                self._json(200, engine.stats())
            elif path == "/tracez":
                # live waterfall view of the run's slowest requests
                # (observe/assemble): a debug surface, so the import
                # stays lazy and a missing run degrades to an
                # explanatory payload rather than an error.  The run
                # handle comes from the engine (captured on ITS thread
                # at construction) — contextvars don't cross into the
                # server's handler threads, the explicit-handle rule
                # every worker-thread consumer in observe/ follows
                from mmlspark_tpu_torch.observe.assemble import tracez_payload
                from mmlspark_tpu_torch.observe.telemetry import active_run
                try:
                    top = int(self.path.split("top=")[1].split("&")[0]) \
                        if "top=" in self.path else 10
                except ValueError:
                    top = 10
                run = getattr(engine, "_run", None) or active_run()
                self._json(200, tracez_payload(run, top=top))
            else:
                self.send_error(
                    404, "unknown path "
                    "(healthz | readyz | statz | tracez | generate)")

        @staticmethod
        def _trace_headers(req, extra: dict = None) -> dict:
            """Response headers for one request: the distributed trace id
            (when tracing minted one) plus any status-specific extras —
            a client can quote X-Request-Trace to find its waterfall in
            /tracez or the run report."""
            headers = dict(extra or {})
            t = getattr(req, "trace", None)
            if t is not None:
                headers["X-Request-Trace"] = t.trace_id
            return headers

        # -- the request front end -------------------------------------
        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler contract
            if self.path.split("?")[0] != "/generate":
                self.send_error(404, "POST /generate only")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                body = json.loads(raw.decode() or "{}")
                prompt = body["prompt"]
            except Exception as e:  # malformed request == poison: 400
                self._json(400, {"error": f"bad request body: {e}"})
                return
            deadline_ms = body.get("deadline_ms")
            try:
                req = engine.submit(
                    prompt,
                    max_new_tokens=body.get("max_new_tokens"),
                    deadline_s=(float(deadline_ms) / 1e3
                                if deadline_ms is not None else None),
                    priority=body.get("priority"))
            except InvalidRequest as e:
                self._json(400, {"error": str(e)})
                return
            except Overloaded as e:
                self._json(429, {"error": str(e), "reason": e.reason},
                           {"Retry-After":
                            f"{max(0.0, e.retry_after_s):.3f}"})
                return
            # wait past the deadline by a grace period: the boundary
            # cancel needs one segment to notice, and a just-late
            # completion should still return its tokens with the miss
            # flagged rather than a dangling connection
            budget = (max(0.0, req.deadline - engine.now())
                      + engine.cfg.drain_timeout_s + 5.0)
            if body.get("stream"):
                self._stream(req, budget)
                return
            req.wait(budget)
            if not req.finished:
                self._json(504, {"error": "request did not finish",
                                 "request": req.id},
                           self._trace_headers(req))
                return
            if req.status == OK:
                self._json(200, {
                    "tokens": list(map(int, req.tokens)),
                    "request": req.id,
                    "degraded": bool(req.degraded),
                    "met_deadline": req.finished_at <= req.deadline,
                    "latency_ms": round(req.latency_s() * 1e3, 3)},
                    self._trace_headers(req))
            elif req.status == TIMEOUT:
                self._json(504, {"error": "deadline exceeded",
                                 "request": req.id},
                           self._trace_headers(req))
            elif req.status == CANCELLED:
                self._json(503, {"error": "cancelled: engine draining",
                                 "request": req.id},
                           self._trace_headers(req, {
                               "Retry-After":
                               f"{engine.retry_after_s():.3f}"}))
            elif req.status == SHED:
                # router retry-budget exhaustion after admission: the
                # same 429 contract as front-door shedding
                self._json(429, {"error": req.detail or "shed",
                                 "reason": "retry_budget",
                                 "request": req.id},
                           self._trace_headers(req, {
                               "Retry-After":
                               f"{max(0.1, req.retry_after_s):.3f}"}))
            else:
                self._json(500, {"error": req.detail or "internal error",
                                 "request": req.id},
                           self._trace_headers(req))

        # -- token streaming -------------------------------------------
        def _chunk(self, payload: dict) -> None:
            data = (json.dumps(payload) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode()
                             + data + b"\r\n")

        def _stream(self, req, budget: float) -> None:
            """Chunked NDJSON: flush tokens as segment boundaries land
            them (`note_tokens` wakes `stream_wait`), emit a restart
            line when a failover bumps the stream epoch, then the
            authoritative final line."""
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in self._trace_headers(req).items():
                    self.send_header(k, v)
                self.end_headers()
                start = time.monotonic()
                epoch, toks, fin = req.stream_state()
                cursor = 0
                while True:
                    e, toks, fin = req.stream_state()
                    if e != epoch:
                        self._chunk({"restart": True, "epoch": e})
                        epoch, cursor = e, 0
                    if len(toks) > cursor:
                        self._chunk({"tokens": list(
                            map(int, toks[cursor:]))})
                        cursor = len(toks)
                    if fin:
                        break
                    if time.monotonic() - start > budget:
                        break
                    req.stream_wait(epoch, cursor, timeout=STREAM_POLL_S)
                final = {"done": True,
                         "status": req.status or "incomplete",
                         "request": req.id,
                         "restarts": epoch,
                         "degraded": bool(req.degraded)}
                if req.status == OK:
                    final["tokens"] = list(map(int, req.tokens))
                    final["met_deadline"] = req.finished_at <= req.deadline
                    final["latency_ms"] = round(req.latency_s() * 1e3, 3)
                elif req.status == SHED:
                    final["retry_after_s"] = round(
                        max(0.1, req.retry_after_s), 3)
                self._chunk(final)
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                get_logger("serve.http").debug(
                    "streaming client gone (request %d)", req.id)
            self.close_connection = True

        def log_message(self, fmt, *args):
            get_logger("serve.http").debug(fmt, *args)

    return ServeHandler
