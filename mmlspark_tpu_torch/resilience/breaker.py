"""Per-endpoint circuit breaker: closed -> open -> half-open probe.

Retry policies protect a single call; the breaker protects the FLEET.
When an endpoint (an object-store host, a model-repo CDN) has failed N
consecutive times, every further call is refused instantly
(`CircuitOpenError`) instead of each caller independently burning a full
backoff budget against a dead host — the difference between an ingestion
job that fails in milliseconds with a clear diagnosis and one that takes
minutes to die.  After `reset_s` of cooldown one PROBE call is let
through (half-open): success closes the circuit, failure re-opens it and
restarts the cooldown.

State transitions and refusals are counted through `observe.metrics`
(`breaker.<event>`); cooldowns read `resilience.clock`, so breaker tests
run on a VirtualClock.  Instances are thread-safe; `get_breaker(endpoint)`
returns the process-wide breaker for an endpoint key (one per host).
"""

from __future__ import annotations

import threading
from typing import Optional

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.trace import trace_event
from mmlspark_tpu_torch.resilience.clock import Clock, get_clock

BREAKER_THRESHOLD = config.register(
    "MMLSPARK_TPU_BREAKER_THRESHOLD", 5,
    "circuit breaker: consecutive failures that open the circuit "
    "(0 disables breaking entirely)", ptype=int)
BREAKER_RESET_S = config.register(
    "MMLSPARK_TPU_BREAKER_RESET_S", 30.0,
    "circuit breaker: cooldown before the half-open probe", ptype=float)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

# numeric form of the state for gauges (Prometheus samples are floats):
# 0 = closed (healthy), 1 = half-open (probing), 2 = open (shedding)
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitOpenError(ConnectionError):
    """Refused without calling: the endpoint's circuit is open."""

    def __init__(self, endpoint: str, retry_in_s: float):
        super().__init__(
            f"circuit open for endpoint {endpoint!r}; "
            f"probe allowed in {max(0.0, retry_in_s):.1f}s")
        self.endpoint = endpoint
        self.retry_in_s = retry_in_s


class CircuitBreaker:
    """One endpoint's failure gate.  Use `allow()` before the call and
    `record_success()` / `record_failure()` after — or let
    `RetryPolicy.call(..., breaker=...)` drive all three."""

    def __init__(self, endpoint: str, threshold: Optional[int] = None,
                 reset_s: Optional[float] = None,
                 clock: Optional[Clock] = None):
        self.endpoint = endpoint
        self._threshold = threshold
        self._reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0

    # config is re-read per call so tests (and live operators) can tune
    # knobs without rebuilding the breaker registry
    @property
    def threshold(self) -> int:
        return self._threshold if self._threshold is not None \
            else int(BREAKER_THRESHOLD.current())

    @property
    def reset_s(self) -> float:
        return self._reset_s if self._reset_s is not None \
            else float(BREAKER_RESET_S.current())

    def _now(self) -> float:
        return (self._clock or get_clock()).monotonic()

    def retry_in_s(self) -> float:
        """Seconds until the next half-open probe would be allowed (0 when
        closed or already due) — the time-to-retry the state gauges and
        `Retry-After` surfaces read."""
        with self._lock:
            if self.state != OPEN:
                return 0.0
            return max(0.0, self.reset_s - (self._now() - self._opened_at))

    def snapshot(self) -> dict:
        """Point-in-time state for the observability exports: state name +
        numeric code, consecutive failures, and time-to-retry."""
        retry = self.retry_in_s()
        with self._lock:
            return {"state": self.state,
                    "state_code": STATE_CODES[self.state],
                    "consecutive_failures": self.consecutive_failures,
                    "retry_in_s": round(retry, 3)}

    def _gauge_state(self) -> None:
        """Record the breaker's state as run gauges (call on transitions,
        holding no lock): `breaker.<endpoint>.state` makes a trip visible
        in run_summary.json and Prometheus, not just as an event."""
        from mmlspark_tpu_torch.observe.telemetry import active_run
        run = active_run()
        if run is not None:
            run.gauge(f"breaker.{self.endpoint}.state",
                      STATE_CODES[self.state])
            run.gauge(f"breaker.{self.endpoint}.retry_in_s",
                      self.retry_in_s())

    def allow(self) -> None:
        """Gate one attempt: no-op when closed, raises when open, lets a
        single probe through once the cooldown has elapsed."""
        if self.threshold <= 0:
            return
        with self._lock:
            if self.state == CLOSED:
                return
            waited = self._now() - self._opened_at
            if self.state == OPEN and waited >= self.reset_s:
                self.state = HALF_OPEN
                inc_counter("breaker.half_open")
                trace_event("breaker.half_open", cat="resilience",
                            endpoint=self.endpoint,
                            waited_s=round(waited, 3))
                get_logger("resilience").info(
                    "breaker %s: half-open probe after %.1fs",
                    self.endpoint, waited)
            elif self.state == HALF_OPEN:
                # a probe is already in flight; refuse concurrent callers
                # (they would defeat the single-probe semantics)
                inc_counter("breaker.refused")
                trace_event("breaker.refused", cat="resilience",
                            endpoint=self.endpoint, state=HALF_OPEN)
                raise CircuitOpenError(self.endpoint, self.reset_s)
            else:
                inc_counter("breaker.refused")
                trace_event("breaker.refused", cat="resilience",
                            endpoint=self.endpoint, state=OPEN)
                raise CircuitOpenError(self.endpoint,
                                       self.reset_s - waited)
        # gauges outside the lock (they re-read state via retry_in_s)
        self._gauge_state()
        return  # this caller IS the probe

    def record_success(self) -> None:
        with self._lock:
            changed = self.state != CLOSED
            if changed:
                inc_counter("breaker.closed")
                trace_event("breaker.closed", cat="resilience",
                            endpoint=self.endpoint, outcome="probe_ok")
                get_logger("resilience").info(
                    "breaker %s: closed after successful probe",
                    self.endpoint)
            self.state = CLOSED
            self.consecutive_failures = 0
        if changed:
            self._gauge_state()

    def record_failure(self, exc: Optional[BaseException] = None) -> None:
        if self.threshold <= 0:
            return
        if isinstance(exc, CircuitOpenError):
            return  # a refusal is not new evidence against the endpoint
        with self._lock:
            self.consecutive_failures += 1
            trip = (self.state == HALF_OPEN
                    or self.consecutive_failures >= self.threshold)
            opened = trip and self.state != OPEN
            if opened:
                self.state = OPEN
                self._opened_at = self._now()
                inc_counter("breaker.opened")
                trace_event("breaker.opened", cat="resilience",
                            endpoint=self.endpoint,
                            failures=self.consecutive_failures,
                            error=type(exc).__name__ if exc else None)
                get_logger("resilience").warning(
                    "breaker %s: OPEN after %d consecutive failures "
                    "(last: %r); cooling down %.1fs", self.endpoint,
                    self.consecutive_failures, exc, self.reset_s)
            elif trip:
                self._opened_at = self._now()  # failed probe: restart cooldown
        if opened:
            self._gauge_state()


_breakers: dict[str, CircuitBreaker] = {}
_registry_lock = threading.Lock()


def get_breaker(endpoint: str) -> CircuitBreaker:
    """The process-wide breaker for an endpoint key (e.g. a URL's host)."""
    with _registry_lock:
        breaker = _breakers.get(endpoint)
        if breaker is None:
            breaker = _breakers[endpoint] = CircuitBreaker(endpoint)
        return breaker


def register_breaker(breaker: CircuitBreaker) -> CircuitBreaker:
    """Put an externally constructed breaker (custom threshold/clock —
    e.g. the serve router's per-replica ejection breakers) into the
    process registry so `breakers_snapshot()` and the Prometheus
    exposition see it like any other endpoint.  Last registration for an
    endpoint key wins."""
    with _registry_lock:
        _breakers[breaker.endpoint] = breaker
    return breaker


def breakers_snapshot() -> dict[str, dict]:
    """Every registered breaker's `snapshot()` by endpoint — the pull
    surface observe/export.py renders as per-endpoint Prometheus gauges
    (`mmlspark_tpu_breaker_state{endpoint=...}` etc.)."""
    with _registry_lock:
        breakers = list(_breakers.items())
    return {endpoint: b.snapshot() for endpoint, b in breakers}


def reset_breakers() -> None:
    """Drop all breaker state (test isolation)."""
    with _registry_lock:
        _breakers.clear()
