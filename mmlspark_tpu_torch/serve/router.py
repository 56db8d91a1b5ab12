"""The routing front tier: one admission door over N engine replicas (the
port of the colocated fleet of `mmlspark_tpu/serve/router.py`).

A single `ServingEngine` is a single point of failure — one wedged
decode loop and the whole surface is down.  The `Router` owns the
bounded admission queue and distributes admitted requests across a fleet
of in-process `Replica` handles (serve/replica.py); the stdlib HTTP
front end (serve/http.py) sits in front of `Router.submit` exactly as it
does for a bare engine, because the router duck-types the engine's
serving surface.  The policies, in dispatch order:

  * POWER-OF-TWO-CHOICES — among routable replicas, sample two and take
    the one owing fewer tokens (resident + queued).  Near-least-loaded
    placement at O(1) cost, without the herding a strict argmin causes.
  * OUTLIER EJECTION — each replica carries a `CircuitBreaker`
    (`serve.replica.<name>`): consecutive failed attempts — or an
    explicit breach (deadline-miss EWMA over the configured rate, or a
    busy-but-stuck hang past `hang_timeout_s`) — open it.  An ejected
    replica gets no traffic until the cooldown elapses; then ONE real
    request routes through the half-open gate as the PROBE, and its
    on-time completion re-admits the replica (miss evidence cleared).
  * FAILOVER UNDER A RETRY BUDGET — an attempt that dies (replica crash,
    hang ejection, engine error) is retried on another replica only
    while the token-bucket `RetryBudget` grants a token; when the bucket
    is dry the request is SHED with 429 + Retry-After instead of
    queue-looping.  A retried request RE-PREFILLS from scratch, so its
    final tokens stay byte-exact with the offline decode (greedy);
    streamed partials may repeat across the failover — the stream epoch
    bumps so readers can restart cleanly.
  * HEDGING (optional, off by default) — when a request's remaining
    deadline falls under `hedge_fraction` x its estimated service time
    and only one attempt is live, a duplicate attempt is placed on a
    second replica (budget token required); first completion wins, the
    loser is cancelled WITHOUT feeding any breaker.

  * PREFIX AFFINITY — on a fleet whose engines pool prefixes, requests
    sharing a first cache chunk go to one replica (blake2b of the chunk,
    `PrefixCache.affinity_key`), so their pool hits concentrate; an
    ejected target falls back to power-of-two-choices.

Every decision lands as a `serve.route.*` trace event and in the
`routing` timeline of run_summary.json; per-replica breakers export
through the standard Prometheus surface.  All deadline/health math runs
on the injectable resilience clock — the drills (the router drill's four
scenarios in tests/test_torch_router.py) drive `_tick()` under a
`VirtualClock` with zero sleeps.  Replicas are in-process handles ticked
serially by one scheduler thread, so on one card they share its
stream.

  * DISAGGREGATED TIERS — `prefill_replicas`/`decode_replicas` > 0
    partition the fleet into a prefill tier (p0..) and a decode tier
    (d0..): dispatch goes to the prefill tier only, and the KV handoff
    bus (serve/handoff.py), pumped once per tick, moves each finished
    cache row to the decode tier.  A lost transfer re-prefills through
    the failover path; tiers neither hedge nor route by prefix affinity.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Optional

import numpy as np

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import (mint_context, tail_promote,
                                              trace_event)
from mmlspark_tpu_torch.resilience.breaker import (CLOSED, OPEN,
                                                   STATE_CODES,
                                                   CircuitOpenError)
from mmlspark_tpu_torch.resilience.clock import Clock, get_clock
from mmlspark_tpu_torch.serve.admission import (AdmissionController,
                                                InvalidRequest, Overloaded,
                                                StepTimeEstimator)
from mmlspark_tpu_torch.serve.engine import (CREATED, DRAINING, READY,
                                             STOPPED,
                                             SERVE_DEFAULT_DEADLINE_S,
                                             SERVE_DRAIN_TIMEOUT_S,
                                             SERVE_QUEUE_CAPACITY,
                                             ServeConfig, ServingEngine)
from mmlspark_tpu_torch.serve.handoff import HandoffBus
from mmlspark_tpu_torch.serve.prefix_cache import PrefixCache
from mmlspark_tpu_torch.serve.replica import Replica, ReplicaUnavailable
from mmlspark_tpu_torch.serve.request import (CANCELLED, HANDOFF,
                                              INTERACTIVE, OK, PRIORITIES,
                                              SHED, TIMEOUT)

SERVE_REPLICAS = config.register(
    "MMLSPARK_TPU_SERVE_REPLICAS", 2,
    "serving fleet: engine replicas behind the router", ptype=int)
SERVE_RETRY_BUDGET_CAP = config.register(
    "MMLSPARK_TPU_SERVE_RETRY_BUDGET_CAP", 8.0,
    "serving fleet: token-bucket capacity for failover retries/hedges; "
    "an empty bucket sheds failed requests (429) instead of retrying",
    ptype=float)
SERVE_RETRY_BUDGET_PER_S = config.register(
    "MMLSPARK_TPU_SERVE_RETRY_BUDGET_PER_S", 0.5,
    "serving fleet: retry-budget refill rate (tokens/second)",
    ptype=float)
SERVE_EJECT_FAILURES = config.register(
    "MMLSPARK_TPU_SERVE_EJECT_FAILURES", 3,
    "serving fleet: consecutive attempt failures that eject a replica "
    "(open its breaker)", ptype=int)
SERVE_EJECT_MISS_RATE = config.register(
    "MMLSPARK_TPU_SERVE_EJECT_MISS_RATE", 0.6,
    "serving fleet: deadline-miss EWMA at or above which a replica is "
    "ejected", ptype=float)
SERVE_PROBE_RESET_S = config.register(
    "MMLSPARK_TPU_SERVE_PROBE_RESET_S", 5.0,
    "serving fleet: ejection cooldown before one half-open probe "
    "request is routed to the replica", ptype=float)
SERVE_HANG_TIMEOUT_S = config.register(
    "MMLSPARK_TPU_SERVE_HANG_TIMEOUT_S", 10.0,
    "serving fleet: a replica busy but making no progress for this long "
    "is declared hung — ejected, its in-flight work failed over",
    ptype=float)
SERVE_HEDGE_FRACTION = config.register(
    "MMLSPARK_TPU_SERVE_HEDGE_FRACTION", 0.0,
    "serving fleet: hedge a request onto a second replica when its "
    "remaining deadline < fraction x estimated service time "
    "(0 disables hedging)", ptype=float)
SERVE_PREFILL_REPLICAS = config.register(
    "MMLSPARK_TPU_SERVE_PREFILL_REPLICAS", 0,
    "disaggregated fleet: prefill-tier replicas (0 = colocated fleet; "
    "set together with MMLSPARK_TPU_SERVE_DECODE_REPLICAS)", ptype=int)
SERVE_DECODE_REPLICAS = config.register(
    "MMLSPARK_TPU_SERVE_DECODE_REPLICAS", 0,
    "disaggregated fleet: decode-tier replicas (0 = colocated fleet)",
    ptype=int)
SERVE_HANDOFF_TIMEOUT_S = config.register(
    "MMLSPARK_TPU_SERVE_HANDOFF_TIMEOUT_S", 10.0,
    "disaggregated fleet: a KV transfer with no page/ack movement for "
    "this long (virtual seconds) is failed and the request re-prefills "
    "elsewhere", ptype=float)
SERVE_HANDOFF_PAGES_PER_TICK = config.register(
    "MMLSPARK_TPU_SERVE_HANDOFF_PAGES_PER_TICK", 4,
    "disaggregated fleet: KV pages pushed per transfer per router tick "
    "— the pipelining knob that overlaps transfer with prefill compute",
    ptype=int)
SERVE_PREFIX_AFFINITY = config.register(
    "MMLSPARK_TPU_SERVE_PREFIX_AFFINITY", True,
    "serving fleet: steer requests sharing a first cache chunk to the "
    "same replica (hash-of-prefix affinity) so radix prefix-cache hits "
    "concentrate instead of spreading; falls back to power-of-two-"
    "choices when the target is ejected.  Only active on colocated "
    "fleets whose engines enable MMLSPARK_TPU_SERVE_PREFIX_CACHE",
    ptype=bool)


@dataclasses.dataclass
class RouterConfig:
    """Knobs for one Router (docs/serving.md 'Replicated fleet'): the JAX
    package's fields and names.

    None fields fall back to their MMLSPARK_TPU_SERVE_* config vars at
    construction, the ServeConfig convention."""

    replicas: Optional[int] = None
    queue_capacity: Optional[int] = None
    default_deadline_s: Optional[float] = None
    drain_timeout_s: Optional[float] = None
    retry_budget_cap: Optional[float] = None
    retry_budget_per_s: Optional[float] = None
    eject_failures: Optional[int] = None
    eject_miss_rate: Optional[float] = None
    miss_min_samples: int = 4
    probe_reset_s: Optional[float] = None
    hang_timeout_s: Optional[float] = None
    hedge_fraction: Optional[float] = None
    miss_alpha: float = 0.2
    seed: int = 0
    # disaggregated tiers (docs/serving.md 'Disaggregated tiers'): both
    # counts > 0 makes build_fleet construct role=prefill/decode pools
    # with the KV handoff bus between them
    prefill_replicas: Optional[int] = None
    decode_replicas: Optional[int] = None
    handoff_timeout_s: Optional[float] = None
    handoff_pages_per_tick: Optional[int] = None
    # hash-of-prefix replica affinity (colocated prefix-cache fleets)
    prefix_affinity: Optional[bool] = None

    def __post_init__(self):
        read = lambda explicit, var, cast: cast(
            var.current() if explicit is None else explicit)
        self.replicas = read(self.replicas, SERVE_REPLICAS, int)
        self.queue_capacity = read(self.queue_capacity,
                                   SERVE_QUEUE_CAPACITY, int)
        self.default_deadline_s = read(self.default_deadline_s,
                                       SERVE_DEFAULT_DEADLINE_S, float)
        self.drain_timeout_s = read(self.drain_timeout_s,
                                    SERVE_DRAIN_TIMEOUT_S, float)
        self.retry_budget_cap = read(self.retry_budget_cap,
                                     SERVE_RETRY_BUDGET_CAP, float)
        self.retry_budget_per_s = read(self.retry_budget_per_s,
                                       SERVE_RETRY_BUDGET_PER_S, float)
        self.eject_failures = read(self.eject_failures,
                                   SERVE_EJECT_FAILURES, int)
        self.eject_miss_rate = read(self.eject_miss_rate,
                                    SERVE_EJECT_MISS_RATE, float)
        self.probe_reset_s = read(self.probe_reset_s,
                                  SERVE_PROBE_RESET_S, float)
        self.hang_timeout_s = read(self.hang_timeout_s,
                                   SERVE_HANG_TIMEOUT_S, float)
        self.hedge_fraction = read(self.hedge_fraction,
                                   SERVE_HEDGE_FRACTION, float)
        self.prefill_replicas = read(self.prefill_replicas,
                                     SERVE_PREFILL_REPLICAS, int)
        self.decode_replicas = read(self.decode_replicas,
                                    SERVE_DECODE_REPLICAS, int)
        self.handoff_timeout_s = read(self.handoff_timeout_s,
                                      SERVE_HANDOFF_TIMEOUT_S, float)
        self.handoff_pages_per_tick = read(self.handoff_pages_per_tick,
                                           SERVE_HANDOFF_PAGES_PER_TICK,
                                           int)
        self.prefix_affinity = read(self.prefix_affinity,
                                    SERVE_PREFIX_AFFINITY, bool)
        if (self.prefill_replicas > 0) != (self.decode_replicas > 0):
            raise ValueError(
                "a disaggregated fleet needs BOTH prefill_replicas and "
                "decode_replicas > 0 (or both 0 for colocated)")
        if self.prefill_replicas < 0 or self.decode_replicas < 0:
            raise ValueError("tier replica counts must be >= 0")
        if self.handoff_timeout_s <= 0:
            raise ValueError("handoff_timeout_s must be > 0")
        if self.handoff_pages_per_tick < 1:
            raise ValueError("handoff_pages_per_tick must be >= 1")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.retry_budget_cap < 0:
            raise ValueError("retry_budget_cap must be >= 0")
        if not 0.0 < self.eject_miss_rate <= 1.0:
            raise ValueError("eject_miss_rate must be in (0, 1]")
        if self.hang_timeout_s <= 0:
            raise ValueError("hang_timeout_s must be > 0")
        if self.hedge_fraction < 0:
            raise ValueError("hedge_fraction must be >= 0")


class RetryBudget:
    """Token bucket over the resilience clock: `cap` tokens, refilled at
    `per_s`.  Every failover retry and every hedge costs one token;
    `try_take()` refusing is the signal to SHED instead of retry — the
    bound that keeps a failing fleet from amplifying its own load."""

    def __init__(self, cap: float, per_s: float,
                 clock: Optional[Clock] = None):
        self.cap = max(0.0, float(cap))
        self.per_s = max(0.0, float(per_s))
        self._clock = clock
        self._tokens = self.cap
        self._lock = threading.Lock()
        self._last = self._now()
        self.spent = 0

    def _now(self) -> float:
        return (self._clock or get_clock()).monotonic()

    def _refill(self, now: float) -> None:
        if self.per_s > 0 and now > self._last:
            self._tokens = min(self.cap,
                               self._tokens + (now - self._last) * self.per_s)
        self._last = now

    def try_take(self) -> bool:
        with self._lock:
            self._refill(self._now())
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent += 1
                return True
            return False

    def tokens_now(self) -> float:
        with self._lock:
            self._refill(self._now())
            return self._tokens

    def retry_after_s(self) -> float:
        """Seconds until a token will exist — the Retry-After hint for
        budget-shed traffic (evidence, not a constant)."""
        with self._lock:
            self._refill(self._now())
            if self._tokens >= 1.0:
                return 0.1
            if self.per_s <= 0:
                return 1.0
            return max(0.1, (1.0 - self._tokens) / self.per_s)


class RouterRequest:
    """One admitted FLEET request: the stable handle a client waits on
    while its engine-level ATTEMPTS fail over between replicas.  Mirrors
    the `Request` surface (finish/wait/stream_*) so serve/http.py and
    the admission controller treat both alike; `attempts` holds
    (replica_name, engine Request) pairs, newest last."""

    __slots__ = ("id", "prompt", "true_len", "bucket", "max_new_tokens",
                 "arrival", "deadline", "priority", "degraded", "tokens",
                 "status", "detail", "finished_at", "retry_after_s",
                 "attempts", "retries", "hedged", "span", "trace",
                 "_event", "_progress")

    def __init__(self, req_id: int, prompt: np.ndarray, bucket: int,
                 max_new_tokens: int, arrival: float, deadline: float,
                 priority: str = INTERACTIVE):
        self.id = req_id
        self.prompt = prompt
        self.true_len = int(prompt.shape[0])
        self.bucket = bucket
        self.max_new_tokens = int(max_new_tokens)
        self.arrival = float(arrival)
        self.deadline = float(deadline)
        self.priority = priority
        self.degraded = False
        self.tokens: list[int] = []
        self.status: Optional[str] = None
        self.detail: str = ""
        self.finished_at: Optional[float] = None
        self.retry_after_s = 0.0       # backoff hint when status == shed
        self.attempts: list[tuple] = []
        self.retries = 0
        self.hedged = False
        self.span = None
        self.trace = None    # TraceContext minted at admission; every
        #   attempt (failover, hedge) is a child of the SAME trace id
        self._event = threading.Event()
        self._progress = threading.Condition()

    @property
    def finished(self) -> bool:
        return self.status is not None

    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

    def _notify(self) -> None:
        # attempt progress callbacks (engine scheduler thread) and the
        # router's own terminal transition both land here
        with self._progress:
            self._progress.notify_all()

    def finish(self, status: str, now: float, detail: str = "") -> None:
        if self.status is not None:
            return
        self.status = status
        self.detail = detail
        self.finished_at = now
        self._event.set()
        self._notify()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    # -- token streaming ---------------------------------------------------
    def stream_state(self) -> tuple:
        """(epoch, tokens-so-far, finished).  The epoch counts attempts:
        a failover bumps it, telling a streaming reader its partial
        output was from a dead attempt and the stream restarts (the
        byte-exactness caveat in docs/serving.md — the FINAL tokens are
        exact, streamed partials may repeat)."""
        atts = self.attempts
        epoch = max(0, len(atts) - 1)
        if self.finished:
            return epoch, list(self.tokens), True
        if atts:
            return epoch, list(atts[-1][1].tokens), False
        return epoch, [], False

    def stream_wait(self, epoch: int, cursor: int,
                    timeout: Optional[float] = None) -> bool:
        """Park until the stream moved past (epoch, cursor): new tokens,
        a restart, or the terminal status."""
        def moved() -> bool:
            e, toks, fin = self.stream_state()
            return e != epoch or len(toks) > cursor or fin
        with self._progress:
            if moved():
                return True
            self._progress.wait(timeout)
            return moved()


class Router:
    """Health-aware routing over a replica fleet (module docstring).

    Inline (tests, drills): construct, `warmup()`, then `submit` +
    `_tick()` under a VirtualClock — nothing sleeps.  Production:
    `serve/lifecycle.start_router` spawns the single scheduler thread
    (it ticks every replica serially; replicas are in-process handles,
    not processes) and `start_http` serves `submit` unchanged."""

    def __init__(self, replicas: list, cfg: Optional[RouterConfig] = None,
                 *, clock: Optional[Clock] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.cfg = cfg or RouterConfig()
        self._clock = clock
        self.replicas: list[Replica] = list(replicas)
        self._by_name = {r.name: r for r in self.replicas}
        if len(self._by_name) != len(self.replicas):
            raise ValueError("replica names must be unique")
        # disaggregated tiers: replica roles partition the fleet; a
        # tiered fleet dispatches to the PREFILL tier only and the
        # handoff bus moves finished KV rows to the decode tier
        self._prefill_reps = [r for r in self.replicas
                              if r.role == "prefill"]
        self._decode_reps = [r for r in self.replicas
                             if r.role == "decode"]
        if self._prefill_reps or self._decode_reps:
            colocated = [r for r in self.replicas
                         if r.role not in ("prefill", "decode")]
            if not self._prefill_reps or not self._decode_reps or colocated:
                raise ValueError(
                    "a disaggregated fleet needs at least one prefill and "
                    "one decode replica, and no colocated ones")
        self.tiered = bool(self._prefill_reps)
        # the fleet estimator: every replica's measured prefill/segment
        # walls tee into it, so admission feasibility reflects real
        # decode speed no matter which replica produced the evidence
        self.estimator = StepTimeEstimator()
        for r in self.replicas:
            r.adopt_estimator(self.estimator)
        self.admission = AdmissionController(
            self.cfg.queue_capacity, self.estimator, None,
            max_batch=sum(r.engine.cfg.max_batch for r in self.replicas),
            clock=clock)
        self.budget = RetryBudget(self.cfg.retry_budget_cap,
                                  self.cfg.retry_budget_per_s, clock=clock)
        # fleet-aware prefix affinity: same first cache chunk → same
        # replica, so shared prefixes concentrate their radix-cache hits
        # instead of spreading across the pool.  The router only STEERS
        # — correctness never depends on landing the affinity target,
        # so an ejected target just falls back to power-of-two-choices.
        # Tiered fleets dispatch to the prefill tier, which refuses the
        # pool, so affinity stays colocated-only.
        self._affinity = bool(self.cfg.prefix_affinity and not self.tiered
                              and any(r.engine.cfg.prefix_cache
                                      for r in self.replicas))
        self._affinity_pool = sorted(self.replicas, key=lambda r: r.name)
        self._affinity_chunk = self.replicas[0].engine.cfg.cache_chunk
        self._rng = random.Random(self.cfg.seed)
        self._live: list[RouterRequest] = []   # dispatched, not finished
        self._state = CREATED
        self._state_lock = threading.Lock()
        self._wake = threading.Condition()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._latencies: list[float] = []
        self._counts: dict[str, int] = {}
        self._counts_lock = threading.Lock()
        self._drain_deadline: Optional[float] = None
        self._thread = None            # set by lifecycle.start_router
        self._guard = None             # PreemptionGuard, set by lifecycle
        self._run = active_run()
        self.handoff: Optional[HandoffBus] = None
        if self.tiered:
            self.handoff = HandoffBus(
                self, timeout_s=self.cfg.handoff_timeout_s,
                pages_per_tick=self.cfg.handoff_pages_per_tick)
            for rep in self._prefill_reps:
                rep.engine.handoff_export = self.handoff.make_export(
                    rep.name)

    # -- lifecycle ---------------------------------------------------------
    def now(self) -> float:
        return (self._clock or get_clock()).monotonic()

    @property
    def state(self) -> str:
        return self._state

    @property
    def ready(self) -> bool:
        return self._state == READY

    @property
    def alive(self) -> bool:
        return self._state in (READY, DRAINING)

    def warmup(self) -> "Router":
        """Warm every replica's shape classes before readiness flips."""
        if self._state != CREATED:
            return self
        for r in self.replicas:
            r.engine.warmup()
        self._state = READY
        self._record_routing("ready",
                             replicas=[r.name for r in self.replicas])
        get_logger("serve").info(
            "router ready: %d replicas warm", len(self.replicas))
        return self

    def begin_drain(self, reason: str = "stop") -> None:
        """Stop admitting; dispatched requests finish or cancel by
        min(their deadline, now + drain_timeout), then every replica
        engine drains.  Idempotent; SIGTERM-handler safe."""
        with self._state_lock:
            if self._state not in (CREATED, READY):
                return
            self._state = DRAINING
            self._drain_deadline = self.now() + self.cfg.drain_timeout_s
        self.admission.close(self.cfg.drain_timeout_s)
        inc_counter("serve.drains")
        self._record_routing("drain_start", reason=reason,
                             in_flight=len(self._live),
                             queued=self.admission.pending())
        with self._wake:
            self._wake.notify_all()

    def _finish_drain(self) -> None:
        for r in self.replicas:
            try:
                r.engine.stop()     # inline: replicas share this thread
            except Exception as e:
                get_logger("serve").warning(
                    "replica %s failed to stop cleanly: %r", r.name, e)
        if self.handoff is not None:
            self.handoff.close()
        self._state = STOPPED
        self._record_routing("drain_end", counts=dict(self._counts))
        self._gauge_fleet()
        with self._wake:
            self._wake.notify_all()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Graceful stop: drain, then join the loop thread (if any)."""
        self.begin_drain("stop")
        if self._thread is not None:
            self._thread.join(timeout if timeout is not None
                              else self.cfg.drain_timeout_s + 5.0)
        else:
            while self._state == DRAINING:
                self._tick()

    def retry_after_s(self) -> float:
        """Backoff hint for refused/cancelled traffic (the engine
        contract): remaining drain time while draining, the drain budget
        once stopped, else the soonest replica probe."""
        now = self.now()
        if self._state == DRAINING and self._drain_deadline is not None:
            return max(0.1, self._drain_deadline - now)
        if self._state == STOPPED:
            return max(0.1, self.cfg.drain_timeout_s)
        return self._probe_hint()

    def _probe_hint(self) -> float:
        """Soonest half-open probe across ejected replicas — when the
        fleet could plausibly take traffic again."""
        waits = [r.breaker.retry_in_s() for r in self.replicas
                 if r.breaker.state != CLOSED]
        return max(0.1, min(waits)) if waits else 0.1

    # -- submission --------------------------------------------------------
    def _new_id(self) -> int:
        with self._id_lock:
            self._next_id += 1
            return self._next_id

    def in_flight(self) -> int:
        return sum(1 for rr in list(self._live) if not rr.finished)

    def fleet_load_tokens(self) -> int:
        return sum(r.load_tokens() for r in self.replicas)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None) -> RouterRequest:
        """Admit one request into the FLEET queue or raise
        (`InvalidRequest` / `Overloaded`); the scheduler places it on a
        replica at the next tick.  Shed reasons add `no_replica`: the
        whole fleet is ejected/faulted and not yet due a probe."""
        pri = INTERACTIVE if priority is None else str(priority)
        if pri not in PRIORITIES:
            inc_counter("serve.poison")
            raise InvalidRequest(
                f"priority must be one of {PRIORITIES}, got {pri!r}")
        if not self.alive:
            self._count("shed_draining")
            self._count("shed")
            self._record_routing("shed", reason="draining")
            raise Overloaded("draining", self.retry_after_s(),
                             f"router is {self._state}")
        primary = self.replicas[0].engine
        n_new = int(max_new_tokens if max_new_tokens is not None
                    else primary.cfg.max_new_tokens)
        arr = primary._validate(prompt, n_new)
        try:
            bucket = primary._engines["primary"].bucket_for(arr.size)
        except ValueError as e:
            inc_counter("serve.poison")
            raise InvalidRequest(str(e)) from e
        now = self.now()
        deadline = now + (float(deadline_s) if deadline_s is not None
                          else self.cfg.default_deadline_s)
        rr = RouterRequest(self._new_id(), arr, bucket, n_new, now, deadline,
                           priority=pri)
        # a tiered fleet needs BOTH tiers reachable: prefill to take the
        # dispatch, decode to take the handoff
        pools = ([self._prefill_reps, self._decode_reps] if self.tiered
                 else [self.replicas])
        if not all(any(r.routable() or r.probe_due() for r in pool)
                   for pool in pools):
            self._count("shed_no_replica")
            self._count("shed")
            self._record_routing("shed", reason="no_replica", request=rr.id)
            raise Overloaded("no_replica", self._probe_hint(),
                             "no routable replica in the fleet")
        try:
            self.admission.try_admit(rr, self.fleet_load_tokens())
        except Overloaded as e:
            self._count(f"shed_{e.reason}")
            self._count("shed")
            self._record_routing("shed", reason=e.reason, request=rr.id)
            raise
        finally:
            # an interactive arrival at a full queue displaces the
            # newest queued batch request (weighted shedding: overload
            # costs the batch lane first); finish the victim as SHED
            # with a retry hint so its client backs off and resubmits
            for d in self.admission.drain_displaced():
                self._count("displaced")
                self._record_routing("shed", reason="displaced",
                                     request=d.id)
                self._complete(d, SHED, "displaced by interactive arrival",
                               retry_after=self.retry_after_s())
        self._count("admitted")
        # mint the request's fleet-wide trace identity AT admission: the
        # `admit` event is the waterfall root observe/assemble.py joins
        # every downstream shard's records against
        rr.trace = mint_context()
        self._record_routing("admit", request=rr.id, priority=pri,
                             bucket=bucket, **self._trace_fields(rr))
        with self._wake:
            self._wake.notify_all()
        return rr

    # -- accounting --------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        with self._counts_lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def _record_routing(self, event: str, **fields) -> None:
        if self._run is not None:
            self._run.record_routing({"event": event, **fields})
        trace_event(f"serve.route.{event}", cat="serve", **fields)
        inc_counter(f"serve.route.{event}")

    @staticmethod
    def _trace_fields(rr: RouterRequest) -> dict:
        """The trace join fields a routing event carries (empty when the
        request predates admission or tracing is off)."""
        t = rr.trace
        return {"trace": t.trace_id, "sampled": t.sampled} \
            if t is not None else {}

    def _complete(self, rr: RouterRequest, status: str, detail: str = "",
                  retry_after: Optional[float] = None) -> None:
        now = self.now()
        if retry_after is not None:
            rr.retry_after_s = max(0.1, float(retry_after))
        rr.finish(status, now, detail)
        self._count("finished")
        self._count(status)
        fields = dict(request=rr.id, status=status, priority=rr.priority,
                      latency_s=round(now - rr.arrival, 6),
                      retries=rr.retries, hedged=rr.hedged,
                      deadline_miss=bool(status == OK and now > rr.deadline),
                      **self._trace_fields(rr))
        # tail-based sampling: a head-unsampled request that finished
        # badly (or slow, or needed a retry/hedge) is promoted to full
        # waterfall detail — the bit itself never flips
        tail = tail_promote(rr.trace, status=status,
                            latency_s=now - rr.arrival,
                            hedged=rr.hedged, retries=rr.retries)
        if tail:
            fields["tail"] = tail
        self._record_routing("finish", **fields)
        if status == OK:
            self._latencies.append(now - rr.arrival)
            self._count("tokens_served", len(rr.tokens))
            if now > rr.deadline:
                self._count("deadline_miss")
            else:
                self._count("met_deadline")
                self._count("goodput_tokens", len(rr.tokens))
        elif status == TIMEOUT:
            self._count("deadline_miss")
        inc_counter(f"serve.route.{status}")

    # -- ejection / re-admission -------------------------------------------
    def _replica_failure(self, rep: Replica, exc: BaseException,
                         reason: str, force: bool = False) -> None:
        """Record one attempt failure against a replica's ejection
        breaker.  `force` opens it outright (crash/hang/miss-rate: the
        evidence is unambiguous).  An already-OPEN breaker is left alone
        — late failures from the same incident must not restart the
        probe cooldown."""
        before = rep.breaker.state
        if force:
            spins = 0
            while (rep.breaker.state != OPEN
                   and spins <= rep.breaker.threshold):
                rep.breaker.record_failure(exc)
                spins += 1
        elif rep.breaker.state != OPEN:
            rep.breaker.record_failure(exc)
        if rep.breaker.state == OPEN and before != OPEN:
            self._count("ejections")
            self._record_routing("eject", replica=rep.name, reason=reason,
                                 retry_in_s=round(
                                     rep.breaker.retry_in_s(), 3))

    def _eject(self, rep: Replica, reason: str) -> None:
        self._replica_failure(rep, RuntimeError(reason), reason, force=True)

    def _maybe_miss_eject(self, rep: Replica) -> None:
        if (rep.breaker.state == CLOSED
                and rep.miss_samples >= self.cfg.miss_min_samples
                and rep.miss_ewma >= self.cfg.eject_miss_rate):
            self._eject(rep, "miss_rate")

    def _probe_failed(self, rep: Replica, why: str) -> None:
        rep.probe = None
        self._replica_failure(rep, RuntimeError(why), "probe_failed")

    def _readmit(self, rep: Replica) -> None:
        rep.breaker.record_success()
        rep.reset_miss_ewma()
        self._count("readmissions")
        self._record_routing("readmit", replica=rep.name)

    # -- placement ---------------------------------------------------------
    def _pop_queued(self) -> Optional[RouterRequest]:
        for bucket, lane in self.admission.queued_buckets():
            got = self.admission.take(bucket, 1, lane)
            if got:
                return got[0]
        return None

    def _affinity_target(self, rr: Optional[RouterRequest]):
        """The replica this request's first cache chunk hashes to, or
        None when affinity is off / the prompt is shorter than one
        chunk.  Pool order is sorted-by-name, so the mapping is stable
        across router restarts and replica list permutations."""
        if rr is None or not self._affinity:
            return None
        if rr.true_len < self._affinity_chunk:
            return None
        key = PrefixCache.affinity_key(rr.prompt, self._affinity_chunk)
        return self._affinity_pool[int(key, 16) % len(self._affinity_pool)]

    def _candidates(self, rr: Optional[RouterRequest] = None) -> list:
        """Dispatch preference: a due probe first (re-admission must not
        starve behind healthy capacity), then the affinity target when
        its breaker allows it, then the p2c pick, then the remaining
        routable replicas by load.  A tiered fleet dispatches to its
        prefill tier only."""
        pool = self._prefill_reps if self.tiered else self.replicas
        order: list[Replica] = []
        probes = [r for r in pool if r.probe_due()]
        if probes:
            order.append(probes[0])
        healthy = [r for r in pool if r.routable()]
        target = self._affinity_target(rr)
        if target is not None and target in healthy:
            self._count("affinity_routes")
            self._record_routing("affinity", request=rr.id,
                                 replica=target.name)
            order.append(target)
            order.extend(sorted((r for r in healthy if r is not target),
                                key=lambda r: r.load_tokens()))
            return order
        if target is not None:
            # the affinity target is ejected / faulted / full: fall back
            # to power-of-two-choices rather than queueing behind it
            self._count("affinity_fallback")
            self._record_routing("affinity_fallback", request=rr.id,
                                 replica=target.name)
        if len(healthy) >= 2:
            a, b = self._rng.sample(healthy, 2)
            pick = min((a, b), key=lambda r: r.load_tokens())
            order.append(pick)
            order.extend(sorted((r for r in healthy if r is not pick),
                                key=lambda r: r.load_tokens()))
        else:
            order.extend(healthy)
        return order

    def _try_dispatch(self, rr: RouterRequest, rep: Replica,
                      now: float) -> Optional[object]:
        probe = rep.probe_due()
        if probe:
            try:
                rep.breaker.allow()   # we are the single half-open probe
            except CircuitOpenError:
                return None
        try:
            att = rep.submit(rr.prompt, rr.max_new_tokens,
                             deadline_s=max(1e-3, rr.deadline - now),
                             priority=rr.priority,
                             trace=None if rr.trace is None else
                             rr.trace.child(attempt=len(rr.attempts) + 1))
        except (Overloaded, ReplicaUnavailable, InvalidRequest) as e:
            if probe:
                # the gate was opened for us; a refused probe is a
                # failed probe (re-open, restart the cooldown)
                self._probe_failed(rep, f"probe refused: {e}")
            elif isinstance(e, ReplicaUnavailable):
                self._replica_failure(rep, e, "dispatch",
                                      force=rep.faulted)
            # a plain Overloaded is backpressure, not failure evidence
            return None
        rep.routed += 1
        att.listener = rr._notify
        rr.attempts.append((rep.name, att))
        if probe:
            rep.probe = att
            self._count("probes")
        if rr not in self._live:
            self._live.append(rr)
        self._record_routing("dispatch", request=rr.id, replica=rep.name,
                             probe=probe, attempt=len(rr.attempts),
                             load=rep.load_tokens(),
                             **self._trace_fields(rr))
        if self._run is not None and len(rr.attempts) == 1:
            self._run.observe_hist("serve.queue_wait_s", now - rr.arrival)
        return att

    def _dispatch(self, now: float) -> bool:
        progressed = False
        for _ in range(self.admission.pending()):
            rr = self._pop_queued()
            if rr is None:
                break
            if rr.deadline <= now:
                self._complete(rr, TIMEOUT, "expired in queue")
                progressed = True
                continue
            placed = False
            for rep in self._candidates(rr):
                if self._try_dispatch(rr, rep, now) is not None:
                    placed = True
                    break
            if placed:
                progressed = True
            else:
                # nothing can take work right now (all full, ejected, or
                # cooling down); keep FIFO order and wait for the next
                # tick — deadlines bound the wait
                self.admission.requeue(rr)
                break
        return progressed

    # -- harvest / failover ------------------------------------------------
    def _rr_for_attempt(self, att) -> Optional[RouterRequest]:
        """The live fleet request owning one engine attempt (the handoff
        bus resolves the exported engine request back to its router
        request this way — engine requests carry no back-pointer)."""
        for rr in list(self._live):
            for _, a in rr.attempts:
                if a is att:
                    return rr
        return None

    def _handoff_failed(self, rr: RouterRequest, reason: str,
                        now: float) -> None:
        """A KV transfer died (torn page, stall, sender crash, no decode
        capacity): the prefill work is lost, so the request re-prefills
        elsewhere through the normal failover path — retry budget,
        re-queue at the head, exact final output."""
        if rr.finished:
            return
        if rr in self._live:
            self._live.remove(rr)
        self._count("handoff_retries")
        self._record_routing("handoff_failed", request=rr.id,
                             reason=reason, **self._trace_fields(rr))
        self._failover(rr, now)

    def _prefill_probe_done(self, rep: Replica, missed: bool) -> None:
        """A prefill-tier probe attempt handed its row off: the replica
        did its part, so it is re-admitted (or, past the request's
        deadline, the probe failed).  The JAX router leaves such a probe
        open for good — a prefill attempt never completes `ok` on its
        replica — so there an ejected prefill replica never rejoins."""
        rep.probe = None
        if missed:
            self._probe_failed(rep, "probe missed deadline")
        else:
            self._readmit(rep)

    def _failover(self, rr: RouterRequest, now: float) -> None:
        if rr.deadline <= now:
            self._complete(rr, TIMEOUT, "deadline passed before failover")
            return
        if not self.budget.try_take():
            self._count("shed_retry_budget")
            self._record_routing("shed", reason="retry_budget",
                                 request=rr.id)
            self._complete(rr, SHED, "retry budget exhausted",
                           retry_after=self.budget.retry_after_s())
            return
        rr.retries += 1
        self._count("retries")
        self._record_routing("failover", request=rr.id, retry=rr.retries,
                             **self._trace_fields(rr))
        # re-queue at the head: the retried attempt re-prefills from
        # scratch on whichever replica dispatch picks next tick (greedy
        # output stays byte-exact; the stream epoch bumps on dispatch)
        self.admission.requeue(rr)

    def _harvest(self, now: float) -> bool:
        progressed = False
        for rr in list(self._live):
            if rr.finished:
                self._live.remove(rr)
                continue
            atts = rr.attempts
            winner = None
            for name, att in atts:
                if att.status == OK:
                    winner = (name, att)
                    break
            if winner is not None:
                name, att = winner
                rep = self._by_name[name]
                for n2, a2 in atts:
                    if a2 is not att and not a2.finished:
                        # losing hedge: withdrawn without breaker/miss
                        # evidence — scheduling, not failure
                        self._by_name[n2].engine.cancel_request(
                            a2, "hedge superseded")
                rr.tokens = list(att.tokens)
                rr.degraded = att.degraded
                missed = now > rr.deadline
                if rep.probe is att:
                    rep.probe = None
                    if missed:
                        self._probe_failed(rep, "probe missed deadline")
                    else:
                        self._readmit(rep)
                else:
                    if rep.breaker.state == CLOSED:
                        rep.breaker.record_success()
                    rep.observe_completion(missed)
                    self._maybe_miss_eject(rep)
                rep.completed_ok += 1
                self._live.remove(rr)
                self._complete(rr, OK)
                progressed = True
                continue
            if any(att.status is None for _, att in atts):
                continue               # still running somewhere
            name, att = atts[-1]
            if att.status == HANDOFF:
                continue     # KV transfer in flight; the bus owns the
                #              outcome (splice, cancel, or re-prefill)
            rep = self._by_name[name]
            if att.status == TIMEOUT:
                if rep.probe is att:
                    self._probe_failed(rep, "probe missed deadline")
                else:
                    rep.observe_completion(True)
                    self._maybe_miss_eject(rep)
                self._live.remove(rr)
                self._complete(rr, TIMEOUT,
                               att.detail or "attempt timed out")
            else:                      # error / cancelled: fail it over
                if rep.probe is att:
                    self._probe_failed(rep, att.detail or att.status)
                else:
                    self._replica_failure(
                        rep, RuntimeError(att.detail or att.status),
                        att.status, force=rep.faulted)
                self._live.remove(rr)
                self._failover(rr, now)
            progressed = True
        return progressed

    # -- hedging -----------------------------------------------------------
    def _hedge(self, now: float) -> bool:
        if self.cfg.hedge_fraction <= 0 or self.tiered:
            # tiered fleets don't hedge: a duplicate prefill would also
            # duplicate the KV transfer — failover handles loss instead
            return False
        progressed = False
        for rr in list(self._live):
            if rr.finished or rr.hedged or not rr.attempts:
                continue
            live_atts = [(n, a) for n, a in rr.attempts if a.status is None]
            if len(live_atts) != 1:
                continue
            est = self.estimator.service_s(rr.bucket, rr.max_new_tokens)
            if est is None:
                continue
            remaining = rr.deadline - now
            if remaining <= 0 or remaining >= self.cfg.hedge_fraction * est:
                continue
            current = live_atts[0][0]
            targets = [r for r in self.replicas
                       if r.routable() and r.name != current]
            if not targets:
                continue
            # a hedge costs a budget token like any retry; mark hedged
            # either way so a dry bucket is consulted once per request
            rr.hedged = True
            if not self.budget.try_take():
                continue
            target = min(targets, key=lambda r: r.load_tokens())
            try:
                att = target.submit(rr.prompt, rr.max_new_tokens,
                                    deadline_s=remaining,
                                    priority=rr.priority,
                                    trace=None if rr.trace is None else
                                    rr.trace.child(
                                        attempt=len(rr.attempts) + 1))
            except (Overloaded, ReplicaUnavailable):
                continue
            target.routed += 1
            att.listener = rr._notify
            rr.attempts.append((target.name, att))
            self._count("hedges")
            self._record_routing("hedge", request=rr.id,
                                 replica=target.name,
                                 remaining_s=round(remaining, 4),
                                 **self._trace_fields(rr))
            progressed = True
        return progressed

    # -- the scheduler pass ------------------------------------------------
    def _tick(self) -> bool:
        """One router pass: health checks, expiry, dispatch, replica
        ticks, harvest/failover, hedging, drain.  Synchronous and
        sleep-free; the drills drive it under a VirtualClock."""
        if (self._guard is not None and self._guard.triggered
                and self._state == READY):
            self.begin_drain("sigterm")
        now = self.now()
        worked = False
        # 1a. crash detection: a crash is observable at the handle (the
        # process exited) — eject immediately even if the replica was
        # idle when it died, so the breaker owns re-admission and the
        # blackout shows up as an `eject` event, never silently
        for rep in self.replicas:
            if rep.crashed and rep.breaker.state == CLOSED:
                self._eject(rep, "crash")
                worked = True
        # 1b. hang detection: busy but not progressing for too long
        for rep in self.replicas:
            if (rep.busy() and rep.breaker.state == CLOSED
                    and now - rep.last_progress > self.cfg.hang_timeout_s):
                self._eject(rep, "hang")
                failed = rep.fail_inflight(
                    f"replica {rep.name} hung "
                    f"(no progress for {now - rep.last_progress:.1f}s)")
                self._record_routing("hang", replica=rep.name,
                                     failed_over=failed)
                worked = True
        # 2. expire queued requests whose deadline already passed
        for rr in self.admission.drop_expired(now):
            self._complete(rr, TIMEOUT, "expired in queue")
            worked = True
        # 3. drain-deadline enforcement: past it, cancel everything left
        if self._state == DRAINING and now >= (self._drain_deadline or 0):
            for rr in list(self._live):
                if not rr.finished:
                    for name, att in rr.attempts:
                        if not att.finished:
                            self._by_name[name].engine.cancel_request(
                                att, "drain timeout")
                    if self.handoff is not None and self.handoff.drop_for(rr):
                        self._record_routing("cancel", request=rr.id,
                                             reason="drain_timeout")
                    self._complete(rr, CANCELLED, "drain timeout")
                self._live.remove(rr)
            for rr in self.admission.drop_expired(float("inf")):
                self._complete(rr, CANCELLED, "drain timeout")
            self._finish_drain()
            return True
        # 4. place queued work on replicas (probe first, then p2c)
        worked |= self._dispatch(now)
        # 5. advance every replica one scheduler pass
        prefill_worked = False
        for rep in self.replicas:
            if rep.tick():
                worked = True
                if rep.role == "prefill":
                    prefill_worked = True
        # 5b. pump the KV handoff bus: page pushes pipeline behind the
        # prefill tier's compute (the bus's `overlap` stat)
        if self.handoff is not None:
            worked |= self.handoff.pump(now, compute_worked=prefill_worked)
        # 6. harvest attempt outcomes; fail over the dead ones
        worked |= self._harvest(now)
        # 6b. per-replica SIGTERM drain: stop a draining replica's engine
        # once its own queue, residents, and (prefill tier) in-flight KV
        # transfers are empty
        for rep in self.replicas:
            if rep.draining and rep.engine.state == DRAINING:
                owed = (self.handoff.transfers_from(rep.name)
                        if (self.handoff is not None
                            and rep.role == "prefill") else 0)
                if not rep.busy() and owed == 0:
                    rep.engine._finish_drain()
                    self._count("replica_drains")
                    self._record_routing("replica_drained",
                                         replica=rep.name, role=rep.role)
                    worked = True
        # 7. deadline-aware hedging (off unless configured)
        worked |= self._hedge(now)
        # 8. drain completion
        if (self._state == DRAINING and not self._live
                and self.admission.pending() == 0):
            self._finish_drain()
            return True
        if worked:
            self._gauge_fleet()
        return worked

    # -- the loop (spawned by serve/lifecycle.start_router) ----------------
    def _loop(self) -> None:
        while True:
            if (self._guard is not None and self._guard.triggered
                    and self._state == READY):
                self.begin_drain("sigterm")
            if self._state == STOPPED:
                return
            worked = self._tick()
            if self._state == STOPPED:
                return
            if not worked:
                with self._wake:
                    self._wake.wait(timeout=0.01)

    # -- stats -------------------------------------------------------------
    def _percentile(self, q: float) -> Optional[float]:
        if not self._latencies:
            return None
        return float(np.percentile(np.asarray(self._latencies), q))

    def stats(self) -> dict:
        """Fleet counts + latency percentiles + per-replica health — the
        dict /statz, the drills, and the bench arm read."""
        out = dict(self._counts)
        out["in_flight"] = self.in_flight()
        out["queued"] = self.admission.pending()
        out["state"] = self._state
        out["retry_budget_tokens"] = round(self.budget.tokens_now(), 3)
        out["retry_budget_spent"] = self.budget.spent
        for name, q in (("p50", 50), ("p95", 95), ("p99", 99)):
            p = self._percentile(q)
            out[f"latency_{name}_s"] = round(p, 6) if p is not None else None
        out["replicas"] = {r.name: r.health() for r in self.replicas}
        if self.tiered:
            def tier(reps):
                return {"replicas": [r.name for r in reps],
                        "routable": sum(1 for r in reps if r.routable()),
                        "draining": sum(1 for r in reps if r.draining),
                        "queued": sum(r.engine.admission.pending()
                                      for r in reps),
                        "in_flight": sum(r.engine.in_flight()
                                         for r in reps),
                        "load_tokens": sum(r.load_tokens() for r in reps)}
            out["tiers"] = {"prefill": tier(self._prefill_reps),
                            "decode": tier(self._decode_reps)}
            out["handoff"] = self.handoff.stats()
        return out

    def _gauge_fleet(self) -> None:
        if self._run is None:
            return
        self._run.gauge("serve.router.queue_depth", self.admission.pending())
        self._run.gauge("serve.router.in_flight", self.in_flight())
        self._run.gauge("serve.router.retry_budget_tokens",
                        self.budget.tokens_now())
        for r in self.replicas:
            self._run.gauge(f"serve.replica.{r.name}.load_tokens",
                            r.load_tokens())
            self._run.gauge(f"serve.replica.{r.name}.miss_ewma",
                            r.miss_ewma)
            self._run.gauge(f"serve.replica.{r.name}.breaker_state",
                            STATE_CODES[r.breaker.state])


def build_fleet(bundle, n: Optional[int] = None, *,
                cfg: Optional[RouterConfig] = None,
                serve_cfg: Optional[ServeConfig] = None,
                degraded_bundle=None,
                clock: Optional[Clock] = None, device="cuda") -> Router:
    """Construct a router over `n` fresh engine replicas of `bundle`
    (default: `cfg.replicas`), named r0..r{n-1}, each on `device` (the
    card unless the caller asks for the CPU; replicas may share one
    card).  With `cfg.prefill_replicas` > 0 the fleet is tiered instead:
    prefill replicas p0.. (role "prefill", no prefix pool) and decode
    replicas d0.. (role "decode").  Every replica shares the serve config
    and the degraded fallback bundle; each gets its own engine, weights,
    breaker, and health state."""
    cfg = cfg or RouterConfig()
    scfg = serve_cfg or ServeConfig()

    def make(name: str, role_cfg: ServeConfig) -> Replica:
        engine = ServingEngine(bundle, role_cfg,
                               degraded_bundle=degraded_bundle, clock=clock,
                               device=device)
        return Replica(name, engine, clock=clock,
                       eject_failures=cfg.eject_failures,
                       probe_reset_s=cfg.probe_reset_s,
                       miss_alpha=cfg.miss_alpha)

    replicas = []
    if cfg.prefill_replicas > 0:
        # a prefill-tier replica ships its finished KV rows over the
        # handoff bus — the prefix pool lives on the decode tier only
        for i in range(cfg.prefill_replicas):
            replicas.append(make(
                f"p{i}", dataclasses.replace(scfg, role="prefill",
                                             prefix_cache=False)))
        for i in range(cfg.decode_replicas):
            replicas.append(make(
                f"d{i}", dataclasses.replace(scfg, role="decode")))
    else:
        for i in range(int(n if n is not None else cfg.replicas)):
            replicas.append(make(f"r{i}", scfg))
    return Router(replicas, cfg, clock=clock)
