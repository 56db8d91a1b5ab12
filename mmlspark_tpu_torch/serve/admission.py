"""Admission control: decide at the FRONT DOOR, on evidence (the port of
`mmlspark_tpu/serve/admission.py`).

Under overload, the worst policy is the default one — accept everything
and let deadlines die quietly in the queue.  Every queued request that
cannot possibly finish steals decode steps from requests that could
have.  This module makes the accept/reject decision explicit and cheap:

  * a BOUNDED queue — `queue_full` sheds instantly with a Retry-After
    derived from the measured drain rate, the 429 contract;
  * DEADLINE FEASIBILITY — from per-bucket prefill/step-time estimates
    (EWMAs fed by the engine's `serve.segment`/`serve.prefill` span
    measurements, observe/spans.py clock) the controller computes the
    earliest possible completion: queue wait + prefill + per-token decode.
    If that provably exceeds the request's deadline, admitting it would
    only manufacture a guaranteed timeout — reject as `infeasible`.
    No estimate yet = no proof = admit (the controller only rejects on
    evidence);
  * a MISS-RATE BREAKER — the resilience `CircuitBreaker` keyed on the
    windowed deadline-miss rate of completed requests.  Misses above the
    configured rate open it: new traffic is shed (or failed over to the
    degraded bundle's lane) for `reset_s`, then ONE probe request is
    admitted; an on-time probe closes the circuit.  This is the same
    closed/open/half-open machine resilience/breaker.py runs for network
    endpoints, now protecting the decode engine from its own backlog.

Everything reads the injectable resilience clock, so admission tests run
on a `VirtualClock` with zero sleeps.
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.trace import trace_event
from mmlspark_tpu_torch.resilience.breaker import CLOSED, CircuitBreaker, \
    CircuitOpenError
from mmlspark_tpu_torch.resilience.clock import Clock, get_clock
from mmlspark_tpu_torch.serve.request import (BATCH, INTERACTIVE, PRIORITIES,
                                              Request)


class Overloaded(RuntimeError):
    """Shed at admission (HTTP 429): the engine cannot take this request
    now.  `reason` is one of 'queue_full' | 'infeasible' | 'breaker_open'
    | 'draining'; `retry_after_s` is the client's backoff hint."""

    def __init__(self, reason: str, retry_after_s: float = 1.0,
                 detail: str = ""):
        super().__init__(
            f"overloaded ({reason}): {detail or 'request shed at admission'}"
            f"; retry in {retry_after_s:.2f}s")
        self.reason = reason
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.detail = detail


class InvalidRequest(ValueError):
    """A poison request (HTTP 400): malformed before any queueing —
    out-of-vocabulary tokens, empty prompt, a budget the model cannot
    hold.  Rejected without touching engine state."""


class StepTimeEstimator:
    """Per-bucket EWMA service-time model, fed by the engine's measured
    prefill and segment walls (the `observe` span clock).

    `service_s(bucket, n_tokens)` answers "how long would this request
    occupy the engine end to end" and returns None until a measurement
    for the bucket (or any bucket, as a coarse fallback) exists — the
    admission controller treats None as 'no proof, admit'.  On a tiered
    fleet the KV transfer between the tiers is a third priced stage
    (`observe_handoff`, fed by the handoff bus at each splice)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._prefill: dict[int, float] = {}   # bucket -> seconds
        self._step: dict[int, float] = {}      # bucket -> seconds / step
        self._handoff: dict[int, float] = {}   # bucket -> transfer seconds
        self._lock = threading.Lock()

    def _fold(self, table: dict, bucket: int, value: float) -> None:
        with self._lock:
            prev = table.get(bucket)
            table[bucket] = value if prev is None else \
                prev + self.alpha * (value - prev)

    def observe_prefill(self, bucket: int, seconds: float) -> None:
        self._fold(self._prefill, bucket, max(0.0, float(seconds)))

    def observe_step(self, bucket: int, seconds_per_step: float) -> None:
        self._fold(self._step, bucket, max(0.0, float(seconds_per_step)))

    def observe_handoff(self, bucket: int, seconds: float) -> None:
        """Tiered fleets: the measured prefill->decode KV transfer wall
        per bucket, so admission feasibility includes the wire time
        between the tiers."""
        self._fold(self._handoff, bucket, max(0.0, float(seconds)))

    def _lookup(self, table: dict, bucket: int) -> Optional[float]:
        with self._lock:
            if bucket in table:
                return table[bucket]
            if table:
                # coarse fallback: the worst known bucket (admission must
                # never UNDER-estimate on a bucket it has not seen)
                return max(table.values())
            return None

    def step_s(self, bucket: int) -> Optional[float]:
        return self._lookup(self._step, bucket)

    def service_s(self, bucket: int, n_tokens: int) -> Optional[float]:
        """Estimated engine-occupancy seconds for one request — prefill
        stage + handoff stage (tiered fleets; 0 until observed) + decode
        steps — or None with no evidence yet."""
        step = self._lookup(self._step, bucket)
        if step is None:
            return None
        prefill = self._lookup(self._prefill, bucket) or 0.0
        handoff = self._lookup(self._handoff, bucket) or 0.0
        return prefill + handoff + step * max(1, int(n_tokens))

    def snapshot(self) -> dict:
        with self._lock:
            return {"prefill_s": dict(self._prefill),
                    "step_s": dict(self._step),
                    "handoff_s": dict(self._handoff)}


class MissRateBreaker:
    """Deadline-miss-rate keyed wrapper over the resilience breaker.

    Completions report through `record(missed=...)` into a sliding
    outcome window.  While CLOSED, the circuit opens only when the window
    holds at least `min_samples` outcomes and the miss fraction reaches
    `miss_rate` (threshold=1 on the inner breaker: the rate breach IS the
    failure).  While probing (half-open), the single admitted probe's own
    outcome decides: on-time closes and clears the window, a miss
    re-opens and restarts the cooldown — exactly the CircuitBreaker's state
    machine,
    with 'failure' redefined from 'connection refused' to 'deadline
    missed'."""

    def __init__(self, endpoint: str = "serve", *, window: int = 32,
                 min_samples: int = 8, miss_rate: float = 0.5,
                 reset_s: float = 5.0, clock: Optional[Clock] = None):
        if not 0.0 < miss_rate <= 1.0:
            raise ValueError(f"miss_rate must be in (0, 1], got {miss_rate}")
        self.endpoint = endpoint
        self.min_samples = int(min_samples)
        self.miss_rate = float(miss_rate)
        self._outcomes: collections.deque = collections.deque(
            maxlen=int(window))
        self._breaker = CircuitBreaker(endpoint, threshold=1,
                                       reset_s=reset_s, clock=clock)
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        return self._breaker.state

    def retry_in_s(self) -> float:
        return self._breaker.retry_in_s()

    def allow(self) -> None:
        """Gate one admission; raises CircuitOpenError when shedding."""
        self._breaker.allow()

    def record(self, missed: bool) -> None:
        with self._lock:
            if self._breaker.state != CLOSED:
                # probing: the probe's own outcome decides
                if missed:
                    self._breaker.record_failure(
                        DeadlineMissed(self.endpoint))
                else:
                    self._breaker.record_success()
                    self._outcomes.clear()
                return
            self._outcomes.append(bool(missed))
            n = len(self._outcomes)
            if n >= self.min_samples:
                rate = sum(self._outcomes) / n
                if rate >= self.miss_rate:
                    trace_event("serve.miss_rate_breach", cat="serve",
                                endpoint=self.endpoint,
                                rate=round(rate, 3), window=n)
                    self._breaker.record_failure(DeadlineMissed(
                        self.endpoint, rate=rate, window=n))
                    self._outcomes.clear()

    def miss_rate_now(self) -> float:
        with self._lock:
            n = len(self._outcomes)
            return sum(self._outcomes) / n if n else 0.0


class DeadlineMissed(RuntimeError):
    """The 'failure' fed to the breaker: a windowed miss-rate breach (or
    a missed probe)."""

    def __init__(self, endpoint: str, rate: float = 1.0, window: int = 1):
        super().__init__(
            f"deadline-miss rate {rate:.0%} over {window} completions "
            f"on {endpoint!r}")


class AdmissionController:
    """The bounded queue + the accept/shed decision (module docstring).

    `try_admit(request)` either appends the request to the queue and
    returns its lane ('primary' | 'degraded'), or raises `Overloaded`.
    The scheduler pops with `take(bucket, n)` / `pending()` and calls
    `close()` when draining — after which every admission sheds with
    reason 'draining'."""

    def __init__(self, capacity: int, estimator: StepTimeEstimator,
                 breaker: Optional[MissRateBreaker] = None, *,
                 max_batch: int = 1, degraded_available: bool = False,
                 batch_share: float = 1.0,
                 clock: Optional[Clock] = None):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        if not 0.0 < batch_share <= 1.0:
            raise ValueError(
                f"batch_share must be in (0, 1], got {batch_share}")
        self.capacity = int(capacity)
        self.estimator = estimator
        self.breaker = breaker
        self.max_batch = max(1, int(max_batch))
        self.degraded_available = bool(degraded_available)
        # weighted shedding: the batch lane may hold at most
        # ceil(capacity * batch_share) queue slots, and a full queue
        # displaces its NEWEST batch request to seat an interactive
        # arrival — overload costs the batch tier first, in both
        # directions (docs/serving.md "Prefix reuse & priority lanes")
        self.batch_share = float(batch_share)
        self._displaced: list[Request] = []
        # incrementally-maintained count of queued batch-lane requests:
        # interactive-only traffic (the common case) must not pay
        # per-call queue scans for lane bookkeeping it never uses
        self._batch_queued = 0
        self._clock = clock
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._closed = False
        # Retry-After hint while draining: the engine passes its drain
        # budget at close() so 429/503 responses advertise when a
        # replacement process could plausibly be serving again
        self.drain_hint_s = 1.0

    def _now(self) -> float:
        return (self._clock or get_clock()).monotonic()

    # -- scheduler side ---------------------------------------------------
    def close(self, retry_after_s: Optional[float] = None) -> None:
        """Stop admitting (graceful drain); queued requests stay queued —
        the drain loop decides their fate by deadline.  `retry_after_s`
        becomes the backoff hint shed traffic sees while draining."""
        if retry_after_s is not None:
            self.drain_hint_s = max(0.0, float(retry_after_s))
        self._closed = True

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def queued_tokens(self) -> int:
        with self._lock:
            return sum(r.max_new_tokens for r in self._queue)

    def take(self, bucket: int, n: int, lane: str = "primary") -> list:
        """Pop up to `n` queued requests for `bucket` on `lane`:
        interactive priority first, then batch, FIFO within each — a
        queued batch request never rides ahead of a waiting interactive
        one in its own bucket."""
        out: list[Request] = []
        with self._lock:
            if not self._batch_queued:
                # fast path: no batch work queued, lane order is plain
                # FIFO — one pass, no per-request priority reads
                keep: collections.deque = collections.deque()
                while self._queue and len(out) < n:
                    req = self._queue.popleft()
                    want = "degraded" if req.degraded else "primary"
                    if req.bucket == bucket and want == lane:
                        out.append(req)
                    else:
                        keep.append(req)
                keep.extend(self._queue)
                self._queue = keep
                return out
            for want_pri in PRIORITIES:
                if len(out) >= n:
                    break
                keep = collections.deque()
                while self._queue and len(out) < n:
                    req = self._queue.popleft()
                    want = "degraded" if req.degraded else "primary"
                    if (req.bucket == bucket and want == lane
                            and getattr(req, "priority",
                                        INTERACTIVE) == want_pri):
                        out.append(req)
                    else:
                        keep.append(req)
                keep.extend(self._queue)
                self._queue = keep
            self._batch_queued -= sum(
                1 for r in out
                if getattr(r, "priority", INTERACTIVE) == BATCH)
        return out

    def queued_buckets(self) -> list:
        """(bucket, lane) pairs with waiting work, FIFO-ordered by the
        head request of each pair."""
        seen: dict[tuple, None] = {}
        with self._lock:
            for req in self._queue:
                seen.setdefault(
                    (req.bucket, "degraded" if req.degraded else "primary"))
        return list(seen)

    def drain_displaced(self) -> list:
        """Collect batch requests a full queue displaced for interactive
        arrivals since the last call; the caller owns finishing them
        (the engine cancels them WITHOUT feeding the miss breaker — a
        displacement is a policy decision, not a deadline pathology)."""
        with self._lock:
            out, self._displaced = self._displaced, []
        return out

    def drop_expired(self, now: float) -> list:
        """Remove queued requests whose deadline already passed (they
        would be cancelled the moment they reached a group anyway);
        returns them for the engine to finish as timeouts."""
        expired: list[Request] = []
        with self._lock:
            alive = collections.deque()
            for req in self._queue:
                (expired if req.deadline <= now else alive).append(req)
            self._queue = alive
            if expired and self._batch_queued:
                self._batch_queued -= sum(
                    1 for r in expired
                    if getattr(r, "priority", INTERACTIVE) == BATCH)
        return expired

    # -- front-end side ---------------------------------------------------
    def _queue_wait_s(self, backlog_tokens: int) -> Optional[float]:
        """Earliest-start estimate for a new arrival: the backlog's decode
        steps over the engine's batch parallelism.  None without step
        evidence."""
        if backlog_tokens <= 0:
            return 0.0
        step = self.estimator.step_s(0)  # coarse: worst known bucket
        if step is None:
            return None
        return backlog_tokens * step / self.max_batch

    def try_admit(self, req: Request,
                  in_flight_tokens: int = 0) -> str:
        """Admit or shed (module docstring).  Returns the admitted lane;
        raises `Overloaded` otherwise.  `in_flight_tokens` is the
        scheduler's count of tokens still owed to resident requests —
        part of the backlog a feasibility proof must include."""
        now = self._now()
        if self._closed:
            inc_counter("serve.shed")
            trace_event("serve.shed", cat="serve", reason="draining",
                        request=req.id)
            raise Overloaded("draining", self.drain_hint_s,
                             "engine is draining")
        pri = getattr(req, "priority", INTERACTIVE)
        with self._lock:
            depth = len(self._queue)
            backlog = sum(r.max_new_tokens for r in self._queue)
            batch_depth = self._batch_queued
            # an interactive arrival's wait does not include queued BATCH
            # work — `take` serves it first, so pricing it against the
            # batch backlog would manufacture infeasible rejections for
            # exactly the traffic the lanes exist to protect
            backlog_ahead = (backlog if pri == BATCH or not batch_depth
                             else
                             sum(r.max_new_tokens for r in self._queue
                                 if getattr(r, "priority",
                                            INTERACTIVE) == INTERACTIVE))
            displaced = None
            if (depth >= self.capacity and pri == INTERACTIVE
                    and batch_depth):
                # weighted shedding, eviction side: a full queue seats an
                # interactive arrival by displacing its NEWEST queued
                # batch request (the engine finishes it as cancelled)
                for queued in reversed(self._queue):
                    if getattr(queued, "priority",
                               INTERACTIVE) == BATCH:
                        displaced = queued
                        break
                if displaced is not None:
                    self._queue.remove(displaced)
                    self._displaced.append(displaced)
                    self._batch_queued -= 1
                    backlog -= displaced.max_new_tokens
                    depth -= 1
        if displaced is not None:
            inc_counter("serve.displaced")
            trace_event("serve.displaced", cat="serve",
                        request=displaced.id, by=req.id)
        batch_cap = max(1, int(self.capacity * self.batch_share))
        if depth >= self.capacity or (pri == BATCH
                                      and batch_depth >= batch_cap):
            # Retry-After derived from evidence, not a constant: the
            # backlog's estimated drain time, floored by the breaker's
            # own cooldown when it is open too
            wait = self._queue_wait_s(backlog + in_flight_tokens)
            hint = wait if wait is not None else 1.0
            if self.breaker is not None:
                hint = max(hint, self.breaker.retry_in_s())
            inc_counter("serve.shed")
            trace_event("serve.shed", cat="serve", reason="queue_full",
                        request=req.id, depth=depth, priority=pri)
            detail = (f"batch lane at share cap ({batch_depth}/"
                      f"{batch_cap})" if depth < self.capacity
                      else f"queue at capacity ({depth})")
            raise Overloaded("queue_full", hint, detail)
        # deadline feasibility: reject only on PROOF (estimates exist and
        # the earliest completion still lands past the deadline)
        service = self.estimator.service_s(req.bucket, req.max_new_tokens)
        wait = self._queue_wait_s(backlog_ahead + in_flight_tokens)
        if service is not None and wait is not None:
            earliest = now + wait + service
            if earliest > req.deadline:
                inc_counter("serve.shed")
                trace_event("serve.shed", cat="serve", reason="infeasible",
                            request=req.id, priority=pri,
                            needed_s=round(wait + service, 4),
                            budget_s=round(req.deadline - now, 4))
                raise Overloaded(
                    "infeasible", 0.0,
                    f"needs ~{wait + service:.3f}s but deadline is "
                    f"{req.deadline - now:.3f}s away")
        lane = "primary"
        if self.breaker is not None:
            try:
                self.breaker.allow()
            except CircuitOpenError as e:
                if not self.degraded_available:
                    inc_counter("serve.shed")
                    trace_event("serve.shed", cat="serve",
                                reason="breaker_open", request=req.id)
                    raise Overloaded("breaker_open", e.retry_in_s,
                                     "deadline-miss breaker open") from e
                lane = "degraded"
                req.degraded = True
                inc_counter("serve.degraded")
                trace_event("serve.degraded", cat="serve", request=req.id)
        with self._lock:
            if self._closed:
                raise Overloaded("draining", self.drain_hint_s,
                                 "engine is draining")
            self._queue.append(req)
            if pri == BATCH:
                self._batch_queued += 1
        inc_counter("serve.admitted")
        return lane

    def requeue(self, req: Request) -> None:
        """Put a request back at the HEAD of the queue: the router could
        not place it this tick (all replicas full or cooling down), or a
        failover retry is waiting for re-dispatch — arrival order must
        be preserved either way."""
        with self._lock:
            self._queue.appendleft(req)
            if getattr(req, "priority", INTERACTIVE) == BATCH:
                self._batch_queued += 1

    def remove(self, req: Request) -> bool:
        """Withdraw one still-queued request (a router cancelling the
        losing hedge attempt, or failing a dead replica's backlog over);
        True when it was found.  The caller owns finishing it."""
        with self._lock:
            try:
                self._queue.remove(req)
                if (self._batch_queued
                        and getattr(req, "priority",
                                    INTERACTIVE) == BATCH):
                    self._batch_queued -= 1
                return True
            except ValueError:
                return False
