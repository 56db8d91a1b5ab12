"""Serving lifecycle (the port of `mmlspark_tpu/serve/lifecycle.py`): the
ONE module in `serve/` that owns threads, sockets, and signals.

Everything concurrent about the serving runtime is constructed here —
the scheduler loop thread, the HTTP front-end server, the SIGTERM ->
graceful-drain wiring (`resilience.preemption.PreemptionGuard`) — so the
engine and admission logic stay synchronous, deterministic, and testable
under a VirtualClock: policy in one place, mechanism in another.

Startup order is deliberate: `warmup()` runs every warm bucket's prefill
and segments BEFORE readiness flips, which builds the CUDA kernels
(nvcc, at first use) and registers the shape classes, so `/readyz`
turning 200 means the first real request pays no build; a load balancer
that respects readiness never routes traffic into that stall.

The thread that runs the scheduler loop does not inherit the caller's
`torch.inference_mode()` (grad mode is thread-local): the engine's
serve hooks enter it themselves.
"""

from __future__ import annotations

import threading
from typing import Optional

from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.resilience.preemption import PreemptionGuard
from mmlspark_tpu_torch.serve.engine import STOPPED, ServingEngine


def spawn(name: str, target) -> threading.Thread:
    """The one sanctioned thread constructor inside serve/ (see module
    docstring); daemonic so a wedged serving thread can never hold the
    interpreter's exit hostage."""
    thread = threading.Thread(target=target, daemon=True, name=name)
    thread.start()
    return thread


def start_engine(engine: ServingEngine, *,
                 install_sigterm: bool = True) -> ServingEngine:
    """Warm up (readiness flips only after every warm bucket's programs
    ran), wire SIGTERM -> graceful drain, and spawn the scheduler
    loop.  Returns the (now ready) engine; `engine.stop()` drains and
    joins."""
    engine.warmup()
    if install_sigterm and engine._guard is None:
        # the handler only sets a flag; the loop checks it at the next
        # tick and starts the drain — an in-flight segment is never
        # interrupted mid-dispatch.  Installation is a
        # no-op off the main thread (the guard's own rule).
        guard = PreemptionGuard(install=True)
        guard.__enter__()
        engine._guard = guard
    engine._thread = spawn("mmlspark-serve-loop", engine._loop)
    return engine


def start_router(router, *, install_sigterm: bool = True):
    """`start_engine` for a replicated fleet (serve/router.py): warm
    every replica, wire SIGTERM -> graceful drain, and spawn ONE
    scheduler thread running the router's loop — the router ticks its
    replicas serially, so the whole fleet shares the engine's
    single-scheduler determinism.  Returns the (now ready) router;
    `router.stop()` drains the fleet and joins."""
    router.warmup()
    if install_sigterm and router._guard is None:
        guard = PreemptionGuard(install=True)
        guard.__enter__()
        router._guard = guard
    router._thread = spawn("mmlspark-serve-router", router._loop)
    return router


def start_http(engine, port: int = 0, host: str = "127.0.0.1"):
    """The stdlib HTTP front end (serve/http.py handlers) on a daemon
    thread, in front of a `ServingEngine` OR a `Router` (the router
    duck-types the engine's serving surface).  Returns the
    ThreadingHTTPServer — ephemeral port readable from
    `server.server_address[1]`; stop it with
    `observe.export.stop_server(server)` (bounded wait)."""
    import http.server

    from mmlspark_tpu_torch.serve.http import make_handler

    server = http.server.ThreadingHTTPServer(
        (host, port), make_handler(engine))
    spawn("mmlspark-serve-http", server.serve_forever)
    get_logger("serve").info("serving HTTP on %s:%d",
                             *server.server_address[:2])
    return server


def serve_forever(engine: ServingEngine, port: int = 0,
                  host: str = "127.0.0.1",
                  poll_s: float = 0.1) -> dict:
    """The blocking production entry point: start the engine + HTTP front
    end, then park until the engine drains (SIGTERM or `stop()`).
    Returns the engine's final stats.  The HTTP server is stopped with a
    bounded wait — a hung client cannot hold the exit."""
    from mmlspark_tpu_torch.observe.export import stop_server

    start_engine(engine)
    server = start_http(engine, port, host)
    try:
        while engine.state != STOPPED:
            if engine._thread is not None:
                engine._thread.join(poll_s)
                if not engine._thread.is_alive():
                    break
    finally:
        stop_server(server)
    return engine.stats()


def stop_http(server, timeout_s: float = 2.0) -> bool:
    """Bounded-time HTTP stop (delegates to observe/export.stop_server —
    one implementation of the reaper pattern)."""
    from mmlspark_tpu_torch.observe.export import stop_server
    return stop_server(server, timeout_s)


def drain_on_sigterm(engine: ServingEngine) -> Optional[PreemptionGuard]:
    """Install (or return the existing) SIGTERM guard for an engine that
    was started without one — inline/test setups that still want the
    mid-flight-SIGTERM drill path."""
    if engine._guard is None:
        guard = PreemptionGuard(install=True)
        guard.__enter__()
        engine._guard = guard
    return engine._guard
