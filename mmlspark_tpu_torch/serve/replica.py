"""One replica of the serving fleet: a ServingEngine plus its health (the
port of `mmlspark_tpu/serve/replica.py`).

The router (serve/router.py) holds N in-process `Replica` handles and
makes every routing decision from what a replica's handle can PROVE
about it:

  * an EJECTION BREAKER — a `CircuitBreaker` keyed
    `serve.replica.<name>`, tripped by consecutive failed attempts (or
    explicitly by the router on a miss-rate/hang breach).  OPEN means
    ejected: no new traffic until the cooldown elapses, then exactly one
    PROBE request is routed through the half-open gate; an on-time probe
    re-admits the replica.  The breaker is put in the process registry
    (`register_breaker`) so /metrics exports per-replica state for free.
  * a DEADLINE-MISS EWMA — `observe_completion(missed)` folds attempt
    outcomes into `miss_ewma`; the router ejects when it crosses the
    configured rate with enough samples.
  * a PROGRESS CLOCK — `tick()` refreshes `last_progress` whenever the
    engine did work or is idle; a replica that is BUSY but not
    progressing is hung, and the router ejects it on
    `now - last_progress > hang_timeout_s`.

Fault injection for the chaos drills acts on the handle, not the engine
internals: `inject_crash()` fails everything in flight (the work fails
over), `inject_hang()` freezes ticks with work resident, slow-degrade
throttles ticks by an integer factor, and `recover()` clears all of it.
A real exception escaping `engine._tick()` takes the same crash path —
the drill faults exercise exactly the machinery real faults use.

All timing reads the replica's injected resilience clock, so fleet tests
run on a `VirtualClock` with zero sleeps.
"""

from __future__ import annotations

from typing import Optional

from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.resilience.breaker import (CLOSED, OPEN,
                                                   CircuitBreaker,
                                                   register_breaker)
from mmlspark_tpu_torch.resilience.clock import Clock, get_clock
from mmlspark_tpu_torch.serve.admission import StepTimeEstimator
from mmlspark_tpu_torch.serve.engine import ServingEngine
from mmlspark_tpu_torch.serve.request import ERROR, Request


class ReplicaUnavailable(RuntimeError):
    """Submission refused by the replica handle itself (crashed or hung
    before the engine could even queue the request)."""


class _TeeEstimator(StepTimeEstimator):
    """Forwards a replica engine's prefill/segment measurements into the
    ROUTER's fleet-wide estimator as well as the replica's own — the
    router's admission feasibility math must reflect real decode speed
    without the router ever running a segment itself."""

    def __init__(self, sink: StepTimeEstimator, alpha: float = 0.3):
        super().__init__(alpha)
        self._sink = sink

    def observe_prefill(self, bucket: int, seconds: float) -> None:
        super().observe_prefill(bucket, seconds)
        self._sink.observe_prefill(bucket, seconds)

    def observe_step(self, bucket: int, seconds_per_step: float) -> None:
        super().observe_step(bucket, seconds_per_step)
        self._sink.observe_step(bucket, seconds_per_step)


class Replica:
    """One fleet member: engine + ejection breaker + health signals
    (module docstring).  Constructed around an un-warmed or warmed
    `ServingEngine`; the router warms all replicas in `warmup()`."""

    def __init__(self, name: str, engine: ServingEngine, *,
                 clock: Optional[Clock] = None, eject_failures: int = 3,
                 probe_reset_s: float = 5.0, miss_alpha: float = 0.2):
        self.name = name
        self.engine = engine
        self.role = engine.cfg.role
        self._clock = clock
        # the ejection gate: consecutive attempt failures open it; the
        # half-open probe is a real routed request.  Disaggregated tiers
        # get their own breaker keying (`serve.prefill.p0`,
        # `serve.decode.d0`) so per-tier ejection state is separable in
        # /metrics; colocated replicas are `serve.replica.<name>`.
        key = (f"serve.{self.role}.{name}" if self.role != "colocated"
               else f"serve.replica.{name}")
        self.breaker = register_breaker(CircuitBreaker(
            key, threshold=max(1, int(eject_failures)),
            reset_s=float(probe_reset_s), clock=clock))
        self.draining = False          # per-replica SIGTERM drain flag
        self.miss_alpha = float(miss_alpha)
        self.miss_ewma = 0.0
        self.miss_samples = 0
        self.routed = 0                 # attempts dispatched here
        self.completed_ok = 0
        self.last_progress = self.now()
        self.probe: Optional[Request] = None   # in-flight half-open probe
        self._crashed = False
        self._hung = False
        self._slow_every = 1            # tick throttle (1 = full speed)
        self._slow_phase = 0
        self._crash_detail = ""

    def now(self) -> float:
        return (self._clock or get_clock()).monotonic()

    @property
    def faulted(self) -> bool:
        """The handle KNOWS the replica is dead (crashed or hung) — an
        unambiguous fault the router ejects on immediately instead of
        waiting out the consecutive-failure threshold."""
        return self._crashed or self._hung

    @property
    def crashed(self) -> bool:
        """Crash is OBSERVABLE at the handle (the process exited), unlike
        a hang (which only the router's progress clock can call) — the
        router force-ejects a crashed replica as soon as it sees the
        flag, even if no request was in flight to fail."""
        return self._crashed

    def adopt_estimator(self, sink: StepTimeEstimator) -> None:
        """Rewire the engine's measurements to tee into the router's
        fleet estimator (called once, at router construction)."""
        tee = _TeeEstimator(sink, alpha=sink.alpha)
        self.engine.estimator = tee
        self.engine.admission.estimator = tee

    # -- health signals ----------------------------------------------------
    def busy(self) -> bool:
        return (self.engine.in_flight() + self.engine.admission.pending()) > 0

    def load_tokens(self) -> int:
        """Tokens still owed by this replica (resident + queued) — the
        load signal power-of-two-choices compares."""
        return (self.engine.in_flight_tokens()
                + self.engine.admission.queued_tokens())

    def routable(self) -> bool:
        """May receive NORMAL traffic: engine ready, handle healthy, and
        the ejection breaker closed.  A slow replica stays routable —
        ejection needs evidence (misses), not suspicion."""
        return (not self._crashed and not self._hung and not self.draining
                and self.engine.ready and self.breaker.state == CLOSED)

    def probe_due(self) -> bool:
        """Ejected, cooled down, and no probe in flight: the next
        dispatch should route ONE request here through the half-open
        gate.  A still-dead replica fails its probe and restarts the
        cooldown — the probe IS the health check."""
        return (self.breaker.state == OPEN and self.breaker.retry_in_s() <= 0
                and self.probe is None and not self.draining)

    def begin_drain(self, reason: str = "sigterm") -> None:
        """Per-replica SIGTERM: stop taking new traffic and drain by the
        TIER's semantics.  A prefill replica finishes its queued and
        in-flight prefills — and, via the router, its in-flight KV
        transfers — before stopping; a decode replica finishes or
        cancels its resident rows under the engine's drain budget.  The
        router's drain-finalize phase stops the engine once it (and, for
        prefill, the handoff bus) is empty."""
        if self.draining or not self.engine.alive:
            return
        self.draining = True
        self.engine.begin_drain(f"replica_drain:{reason}")

    def observe_completion(self, missed: bool) -> float:
        """Fold one attempt outcome into the deadline-miss EWMA; returns
        the updated rate (the router's miss-rate ejection reads it)."""
        self.miss_ewma += self.miss_alpha * (float(missed) - self.miss_ewma)
        self.miss_samples += 1
        return self.miss_ewma

    def reset_miss_ewma(self) -> None:
        """Clear the miss evidence (on probe re-admission: the replica
        earns a fresh record, exactly like MissRateBreaker's window
        clear)."""
        self.miss_ewma = 0.0
        self.miss_samples = 0

    # -- submission / scheduling ------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None, trace=None) -> Request:
        """Route one attempt to this replica's engine; raises
        `ReplicaUnavailable` when the handle knows the engine is dead
        (crashed/hung) — the router records it as a dispatch failure.
        `trace` is the router's per-attempt TraceContext child: the
        engine attempt inherits the fleet request's trace id."""
        if self._crashed:
            raise ReplicaUnavailable(
                f"replica {self.name} crashed: {self._crash_detail}")
        if self._hung:
            raise ReplicaUnavailable(f"replica {self.name} is hung")
        return self.engine.submit(prompt, max_new_tokens,
                                  deadline_s=deadline_s, priority=priority,
                                  trace=trace)

    def tick(self) -> bool:
        """Advance the engine one scheduler pass, honoring injected
        faults; refreshes `last_progress` (work done, or idle — only a
        busy-but-stuck replica looks hung).  A real exception escaping
        the engine takes the crash path: its in-flight work fails and
        the router fails it over."""
        if self._crashed or self._hung:
            return False
        self._slow_phase += 1
        if self._slow_every > 1 and self._slow_phase % self._slow_every:
            return False
        try:
            worked = self.engine._tick()
        except Exception as e:
            self.crash(f"engine tick raised: {e!r}")
            return False
        if worked or not self.busy():
            self.last_progress = self.now()
        return worked

    def fail_inflight(self, detail: str) -> int:
        """Fail every resident and queued request on this replica as
        `error` (their router requests fail over); returns how many were
        failed.  Used by `crash()` and by the router's hang ejection."""
        now = self.now()
        failed = 0
        for g in list(self.engine._groups.values()):
            for i in g.live_slots():
                g.rows[i].finish(ERROR, now, detail)
                g.release(i)
                failed += 1
        # mid-chunked-prefill cohorts hold only RESERVED slots — their
        # requests live in the pending-job list, not in any row
        for job in list(self.engine._pending):
            self.engine._release_job_lease(job)
            for req in job["reqs"]:
                if not req.finished:
                    req.finish(ERROR, now, detail)
                    failed += 1
        self.engine._pending.clear()
        self.engine._groups.clear()
        for req in self.engine.admission.drop_expired(float("inf")):
            req.finish(ERROR, now, detail)
            failed += 1
        return failed

    # -- fault injection (chaos drills + real-fault path) ------------------
    def crash(self, detail: str = "replica crashed") -> int:
        """Kill the replica: everything in flight fails immediately (the
        router retries it elsewhere).  The engine object survives for
        `recover()` — a crashed process's replacement comes up warm (its
        kernels already built), which this models."""
        self._crashed = True
        self._crash_detail = detail
        failed = self.fail_inflight(detail)
        get_logger("serve").warning(
            "replica %s crashed (%s): %d in-flight attempts failed over",
            self.name, detail, failed)
        return failed

    inject_crash = crash

    def inject_hang(self) -> None:
        """Freeze the replica with its work resident: ticks do nothing,
        requests never finish, `last_progress` stops moving — the hang
        detector's job."""
        self._hung = True

    def inject_slow(self, factor: float = 4.0) -> None:
        """Degrade throughput: the engine only advances every `factor`-th
        tick.  The replica stays routable; only miss evidence ejects it."""
        self._slow_every = max(1, int(factor))
        self._slow_phase = 0

    def recover(self) -> None:
        """Clear all injected faults (the flap scenario's 'process came
        back') and restart the progress clock.  The ejection breaker is
        NOT touched: re-admission must go through the half-open probe."""
        if self._hung:
            # a hang clears with its wedged work still resident; fail it
            # so the router's requests are not stranded
            self.fail_inflight(f"replica {self.name} restarted after hang")
        self._crashed = False
        self._hung = False
        self._slow_every = 1
        self._crash_detail = ""
        self.last_progress = self.now()

    # -- introspection -----------------------------------------------------
    def in_flight_rows(self) -> list:
        """Per-row view of resident work (the /statz replica section)."""
        now = self.now()
        rows = []
        for g in list(self.engine._groups.values()):
            for i in g.live_slots():
                req = g.rows[i]
                if req is None:
                    continue
                rows.append({"request": req.id, "bucket": g.bucket,
                             "tokens": len(req.tokens),
                             "deadline_in_s": round(req.deadline - now, 3)})
        return rows

    def health(self) -> dict:
        """Point-in-time health for /statz, gauges, and the drills."""
        prefix = self.engine.prefix_stats()
        return {"state": self.engine.state,
                **({"prefix": prefix} if prefix is not None else {}),
                "ready": self.engine.ready,
                "role": self.role,
                "draining": self.draining,
                "routable": self.routable(),
                "breaker": self.breaker.snapshot(),
                "miss_ewma": round(self.miss_ewma, 4),
                "miss_samples": self.miss_samples,
                "in_flight": self.engine.in_flight(),
                "queued": self.engine.admission.pending(),
                "load_tokens": self.load_tokens(),
                "in_flight_rows": self.in_flight_rows(),
                "routed": self.routed,
                "completed_ok": self.completed_ok,
                "crashed": self._crashed,
                "hung": self._hung,
                "slow_factor": self._slow_every}
