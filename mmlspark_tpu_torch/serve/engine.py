"""The continuous-batching scheduler (the port of the colocated
`ServingEngine` of `mmlspark_tpu/serve/engine.py`): robustness under load
as the design center.

One scheduler owns a set of resident decode GROUPS — one per (prompt
bucket, lane) — each a fixed-capacity batch driven through
`DecodeEngine`'s serve hooks (models/generate.py).  The loop advances in
SEGMENTS (`segment_steps` decode steps per hook call) and makes every
robustness decision at the segment boundary:

  * JOIN — queued requests prefill as a cohort (padded to a power of two,
    so join batches reuse a handful of shape classes) and their cache rows
    splice into free slots of the running batch (`merge_cache_rows`).  A
    short request that finishes frees its slot for the next arrival while
    long rows keep decoding: occupancy tracks offered load instead of
    draining to one.
  * CANCEL — a resident row whose deadline has passed is frozen (its
    `done` mask bit) and its request finished as `timeout`; the engine
    never spends another decode step on work nobody can use.
  * COMPLETE — rows that hit their token budget or stop token are
    harvested and their slots freed.

Overload never reaches this loop: admission (serve/admission.py) sheds at
the front door on queue depth, deadline feasibility, and the
deadline-miss breaker — and when the breaker is open with a degraded
bundle configured, new traffic runs on that bundle's lane instead of
being refused.

Long prompts and shared prefixes:

  * CHUNKED PREFILL (`prefill_chunk`) — a cohort whose bucket the chunk
    divides prefills ONE chunk per tick (`_pending` jobs, their slots
    reserved), between the joins and the segments, so a long prompt's
    forward interleaves with resident decode segments instead of
    stalling them.
  * THE PREFIX POOL (`prefix_cache`, serve/prefix_cache.py) — every
    spliced request's chunk-aligned prompt prefix stays resident; a later
    request sharing whole chunks of it resumes from those rows and
    prefills only its novel suffix (inline, or chunk by chunk when the
    prefix is chunk-aligned), with greedy tokens a fresh prefill's.

Every request carries a `serve.request` span; segments and prefills are
span-timed and feed the admission controller's per-bucket EWMAs.  The
span around a hook call closes only after the hook's outputs reached the
host, so the estimator learns device time, not the launch's early return.
Deadline math runs on the injectable resilience clock — the whole
scheduler is testable with a `VirtualClock` and zero sleeps by calling
`_tick()` directly (the loop thread, spawned by serve/lifecycle.py, is
just `_tick` + a condition wait).

The engine runs on the card unless the caller passes `device="cpu"`.  Row
sampling streams are `_mix(cfg.seed, request id)`, the port's stream for
the JAX engine's `fold_in(key(seed), id)`: greedy output is the JAX
engine's; sampled output agrees in distribution.

Disaggregated roles (`ServeConfig.role`): a PREFILL-tier engine runs
admission and (chunked) prefill only and hands each finished cohort to
`handoff_export` (wired by serve/handoff.py) instead of seating it; a
DECODE-tier engine seats handed-off rows through `splice_remote` and
decodes them like any join.

SPECULATIVE LANES (`spec_tokens` with a `draft_bundle`, colocated only):
every lane advances by draft/verify rounds (`DecodeEngine.serve_spec_round`)
instead of segments; each join prefills the cohort's draft caches too and
splices them beside the target's, and each row emits the tokens its round
committed.  Greedy tokens are the offline speculative (and plain)
engine's.  The degraded lane takes any bundle of the primary's
vocabulary, an int8-weight `quantize_bundle` included.

Not ported yet (it raises NotImplementedError, naming the ROADMAP step):
serving over a mesh.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.models.generate import (DEFAULT_CACHE_CHUNK,
                                                DecodeEngine, ServingWeights,
                                                _mix, _round_up)
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.spans import monotonic
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import (mint_context, span_on_tracer,
                                              tail_promote, trace_event)
from mmlspark_tpu_torch.resilience.clock import Clock, get_clock
from mmlspark_tpu_torch.serve.admission import (AdmissionController,
                                                InvalidRequest,
                                                MissRateBreaker, Overloaded,
                                                StepTimeEstimator)
from mmlspark_tpu_torch.serve.prefix_cache import PrefixCache
from mmlspark_tpu_torch.serve.request import (CANCELLED, HANDOFF,
                                              INTERACTIVE, OK, PRIORITIES,
                                              TIMEOUT, Request)

SERVE_QUEUE_CAPACITY = config.register(
    "MMLSPARK_TPU_SERVE_QUEUE_CAPACITY", 64,
    "serving: bounded admission-queue depth; arrivals beyond it shed "
    "with Overloaded (429)", ptype=int)
SERVE_MAX_BATCH = config.register(
    "MMLSPARK_TPU_SERVE_MAX_BATCH", 8,
    "serving: resident decode slots per prompt-bucket group (the "
    "continuous batch width)", ptype=int)
SERVE_SEGMENT_STEPS = config.register(
    "MMLSPARK_TPU_SERVE_SEGMENT_STEPS", 8,
    "serving: decode steps per segment — the join/cancel/complete "
    "boundary cadence", ptype=int)
SERVE_DEFAULT_DEADLINE_S = config.register(
    "MMLSPARK_TPU_SERVE_DEFAULT_DEADLINE_S", 30.0,
    "serving: deadline for requests that do not set one", ptype=float)
SERVE_DRAIN_TIMEOUT_S = config.register(
    "MMLSPARK_TPU_SERVE_DRAIN_TIMEOUT_S", 10.0,
    "serving: graceful-drain budget after SIGTERM/stop — in-flight "
    "requests finish or cancel by min(their deadline, this), then the "
    "loop exits", ptype=float)
SERVE_WARMUP_JOINS = config.register(
    "MMLSPARK_TPU_SERVE_WARMUP_JOINS", False,
    "serving: warmup also runs every late-join shape class (cohort "
    "merges and terminal segments at each grown cache width)", ptype=bool)
SERVE_PREFILL_CHUNK = config.register(
    "MMLSPARK_TPU_SERVE_PREFILL_CHUNK", 0,
    "serving: chunked prefill — join cohorts prefill in chunks of this "
    "many prompt tokens, ONE chunk per scheduler tick, so a long "
    "prompt's forward interleaves with resident decode segments instead "
    "of stalling them (0 = whole-prompt prefill; power of two "
    "recommended — buckets a non-divisor chunk doesn't divide fall back "
    "to whole-prompt)", ptype=int)
SERVE_SPEC_TOKENS = config.register(
    "MMLSPARK_TPU_SERVE_SPEC_TOKENS", 0,
    "serving: speculative decoding — draft-model tokens proposed per "
    "verify round (0 = off; needs a draft_bundle on the ServingEngine)",
    ptype=int)
SERVE_ROLE = config.register(
    "MMLSPARK_TPU_SERVE_ROLE", "colocated",
    "serving: this engine's tier — 'colocated' (prefill + decode on one "
    "replica); the disaggregated 'prefill' and 'decode' tiers are not "
    "ported", ptype=str)
SERVE_CACHE_DTYPE = config.register(
    "MMLSPARK_TPU_SERVE_CACHE_DTYPE", "model",
    "serving: resident KV-cache dtype — 'model' or 'int8' (per-head "
    "symmetric quantize-on-write)", ptype=str)
SERVE_PREFIX_CACHE = config.register(
    "MMLSPARK_TPU_SERVE_PREFIX_CACHE", False,
    "serving: cross-request radix prefix KV cache — finished prefill "
    "rows stay resident at cache_chunk granularity and later requests "
    "sharing a chunk-aligned prompt prefix splice them in, prefilling "
    "only the novel suffix (decode/colocated roles only; greedy outputs "
    "stay byte-identical at model dtype)", ptype=bool)
SERVE_PREFIX_MAX_ROWS = config.register(
    "MMLSPARK_TPU_SERVE_PREFIX_MAX_ROWS", 64,
    "serving: prefix-pool LRU budget in resident CHUNK rows (one row = "
    "one cache_chunk of KV slots); leased rows never evict", ptype=int)
SERVE_PREFIX_MAX_MB = config.register(
    "MMLSPARK_TPU_SERVE_PREFIX_MAX_MB", 256.0,
    "serving: prefix-pool LRU budget in resident megabytes (int8 KV "
    "rows fit ~4x more prefixes per MB than model-dtype)", ptype=float)
SERVE_LANE_BATCH_SHARE = config.register(
    "MMLSPARK_TPU_SERVE_LANE_BATCH_SHARE", 0.5,
    "serving: greatest fraction of the admission queue the BATCH "
    "priority lane may hold; beyond it batch arrivals shed queue_full "
    "while interactive traffic still seats (and a full queue displaces "
    "its newest batch request for an interactive arrival) — overload "
    "costs the batch tier first", ptype=float)

_ROLES = ("colocated", "prefill", "decode")


@dataclasses.dataclass
class ServeConfig:
    """Knobs for one ServingEngine: the JAX package's fields and names.

    None fields fall back to their MMLSPARK_TPU_SERVE_* config vars at
    construction."""

    max_new_tokens: int = 32          # engine-wide generation cap
    max_batch: Optional[int] = None   # resident slots per bucket group
    queue_capacity: Optional[int] = None
    segment_steps: Optional[int] = None
    default_deadline_s: Optional[float] = None
    drain_timeout_s: Optional[float] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    stop_tokens: tuple = ()
    cache_chunk: int = DEFAULT_CACHE_CHUNK
    seed: int = 0
    # deadline-miss breaker (serve/admission.py MissRateBreaker)
    miss_window: int = 32
    miss_min_samples: int = 8
    shed_miss_rate: float = 0.5
    breaker_reset_s: float = 5.0
    warmup_buckets: tuple = ()        # () = the engine's smallest bucket
    warmup_joins: Optional[bool] = None  # run late-join shapes too
    prefill_chunk: Optional[int] = None  # chunked prefill (0 = off)
    spec_tokens: Optional[int] = None    # speculative draft depth (0 = off)
    role: Optional[str] = None           # colocated | prefill | decode
    cache_dtype: Optional[str] = None    # model | int8 resident KV cache
    prefix_cache: Optional[bool] = None  # cross-request prefix KV reuse
    prefix_max_rows: Optional[int] = None   # pool LRU budget, chunk rows
    prefix_max_mb: Optional[float] = None   # pool LRU budget, megabytes
    lane_batch_share: Optional[float] = None  # batch lane's queue share

    def __post_init__(self):
        read = lambda explicit, var, cast: cast(  # noqa: E731
            var.current() if explicit is None else explicit)
        self.max_batch = read(self.max_batch, SERVE_MAX_BATCH, int)
        self.role = read(self.role, SERVE_ROLE, str)
        self.cache_dtype = read(self.cache_dtype, SERVE_CACHE_DTYPE, str)
        self.queue_capacity = read(self.queue_capacity,
                                   SERVE_QUEUE_CAPACITY, int)
        self.segment_steps = read(self.segment_steps,
                                  SERVE_SEGMENT_STEPS, int)
        self.default_deadline_s = read(self.default_deadline_s,
                                       SERVE_DEFAULT_DEADLINE_S, float)
        self.drain_timeout_s = read(self.drain_timeout_s,
                                    SERVE_DRAIN_TIMEOUT_S, float)
        self.warmup_joins = read(self.warmup_joins,
                                 SERVE_WARMUP_JOINS, bool)
        self.prefill_chunk = read(self.prefill_chunk,
                                  SERVE_PREFILL_CHUNK, int)
        self.spec_tokens = read(self.spec_tokens, SERVE_SPEC_TOKENS, int)
        self.prefix_cache = read(self.prefix_cache,
                                 SERVE_PREFIX_CACHE, bool)
        self.prefix_max_rows = read(self.prefix_max_rows,
                                    SERVE_PREFIX_MAX_ROWS, int)
        self.prefix_max_mb = read(self.prefix_max_mb,
                                  SERVE_PREFIX_MAX_MB, float)
        self.lane_batch_share = read(self.lane_batch_share,
                                     SERVE_LANE_BATCH_SHARE, float)
        if self.prefix_max_rows < 1:
            raise ValueError("prefix_max_rows must be >= 1")
        if self.prefix_max_mb <= 0:
            raise ValueError("prefix_max_mb must be > 0")
        if not 0.0 < self.lane_batch_share <= 1.0:
            raise ValueError(
                f"lane_batch_share must be in (0, 1], "
                f"got {self.lane_batch_share}")
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if self.spec_tokens < 0:
            raise ValueError("spec_tokens must be >= 0")
        if self.role not in _ROLES:
            raise ValueError(f"role must be one of {_ROLES}, "
                             f"got {self.role!r}")
        if self.cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"cache_dtype must be 'model' or 'int8', "
                f"got {self.cache_dtype!r}")
        if self.role != "colocated" and self.spec_tokens:
            raise ValueError(
                "speculative decoding is colocated-only: a "
                f"role={self.role!r} tier cannot run spec_tokens > 0")
        if self.role == "prefill" and self.prefix_cache:
            raise ValueError(
                "prefix_cache is decode/colocated-only: a role='prefill' "
                "replica ships finished KV rows over the handoff bus and "
                "must not keep a second resident copy — enable the pool "
                "on the decode tier instead")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.segment_steps < 1:
            raise ValueError("segment_steps must be >= 1")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class _Group:
    """One (bucket, lane)'s resident batch: fixed `capacity` rows, numpy
    row state on the host, caches on the device.  A row is free when
    `rows[i] is None` and no chunked prefill holds it (its `done` bit
    stays True so the segment freezes it)."""

    def __init__(self, bucket: int, capacity: int):
        self.bucket = bucket
        self.capacity = capacity
        self.rows: list[Optional[Request]] = [None] * capacity
        self.caches = None
        self.draft_caches = None       # speculative lanes only
        self.spec_rounds = 0           # the rounds' stream index
        self.reserved: set = set()     # slots held by in-flight chunked
        # prefills (their rows stay None until the cohort splices in)
        self.tok = np.zeros(capacity, np.int64)
        self.done = np.ones(capacity, bool)
        self.true_len = np.ones(capacity, np.int64)
        self.budget = np.zeros(capacity, np.int64)
        self.t_row = np.zeros(capacity, np.int64)
        self.row_ids = np.zeros(capacity, np.int64)

    def free_slots(self) -> list:
        return [i for i, r in enumerate(self.rows)
                if r is None and i not in self.reserved]

    def live_slots(self) -> list:
        return [i for i, r in enumerate(self.rows) if r is not None]

    def release(self, slot: int) -> None:
        self.rows[slot] = None
        self.done[slot] = True
        self.t_row[slot] = 0
        self.budget[slot] = 0
        self.true_len[slot] = 1


# engine lifecycle states
CREATED, READY, DRAINING, STOPPED = "created", "ready", "draining", "stopped"


def _assemble_prefix_row(chunks: list) -> list:
    """Concatenate a prefix hit's per-chunk pool payloads back into one
    cache row (slot axis 1), layer by layer — both cache layouts ride
    through (2-tuple model-dtype, 4-tuple int8 with its scale tensors).
    `torch.cat` allocates: the row is a copy, never a view of the pool."""
    with torch.inference_mode():
        return [tuple(torch.cat(ts, dim=1) for ts in zip(*layer_parts))
                for layer_parts in zip(*chunks)]


class ServingEngine:
    """In-process serving over a model bundle (module docstring).

    Inline (tests, benches): construct, `warmup()`, then call `submit` +
    `_tick()` yourself — with an injected `VirtualClock` nothing sleeps.
    Production: `serve/lifecycle.start_engine(engine)` spawns the loop
    thread and wires SIGTERM -> `begin_drain`; `serve/lifecycle.
    start_http` puts the stdlib front end in front of `submit`.

    `degraded_bundle`: a second bundle of the same vocabulary whose lane
    takes new traffic while the miss breaker is open (for example
    `quantize_bundle(bundle, "int8")`: its Dense weights stay int8 on the
    card).  `draft_bundle`: the draft model of the speculative lanes
    (`cfg.spec_tokens` > 0; `zoo.truncated_draft_bundle` builds one),
    shared by every lane.
    """

    def __init__(self, bundle, cfg: Optional[ServeConfig] = None, *,
                 degraded_bundle=None, draft_bundle=None,
                 clock: Optional[Clock] = None, mesh=None, device="cuda"):
        self.cfg = cfg or ServeConfig()
        if mesh is not None:
            if mesh.shape["seq"] > 1:
                raise ValueError(
                    "ServingEngine does not support a seq-sharded mesh "
                    "(seq>1): continuous batching splices and pages "
                    "whole-window cache rows, which a seq-partitioned "
                    "window breaks up; use DecodeEngine.generate / "
                    "TextGenerator for seq-parallel long-context decode")
            raise NotImplementedError(
                "serving over a mesh is not ported (ROADMAP A10)")
        if self.cfg.spec_tokens and draft_bundle is None:
            raise ValueError(
                "spec_tokens > 0 needs a draft_bundle "
                "(zoo.truncated_draft_bundle builds one)")
        self.device = resolve_device(device)
        self._clock = clock
        self._bundle = bundle
        # one draft drafts for every lane: greedy exactness holds lane by
        # lane, so the degraded lane pairs with the same draft
        self._draft = (ServingWeights(draft_bundle.module(self.device))
                       if self.cfg.spec_tokens else None)
        primary = ServingWeights(bundle.module(self.device))
        self.vocab_size = primary.vocab_size
        self._engines = {"primary": self._decode_engine(primary)}
        if degraded_bundle is not None:
            deg = ServingWeights(degraded_bundle.module(self.device))
            if deg.vocab_size != self.vocab_size:
                raise ValueError(
                    "degraded bundle must share the primary vocabulary")
            self._engines["degraded"] = self._decode_engine(deg)
        self.estimator = StepTimeEstimator()
        self.breaker = MissRateBreaker(
            "serve", window=self.cfg.miss_window,
            min_samples=self.cfg.miss_min_samples,
            miss_rate=self.cfg.shed_miss_rate,
            reset_s=self.cfg.breaker_reset_s, clock=clock)
        self.admission = AdmissionController(
            self.cfg.queue_capacity, self.estimator, self.breaker,
            max_batch=self.cfg.max_batch,
            degraded_available=degraded_bundle is not None,
            batch_share=self.cfg.lane_batch_share, clock=clock)
        # cross-request prefix pool: primary-lane rows only (the degraded
        # lane decodes other weights — their caches never mix)
        self._prefix = (PrefixCache(
            self.cfg.cache_chunk, max_rows=self.cfg.prefix_max_rows,
            max_bytes=int(self.cfg.prefix_max_mb * 2 ** 20))
            if self.cfg.prefix_cache else None)
        self._groups: dict[tuple, _Group] = {}
        # in-flight chunked prefills: each advances a single chunk per
        # tick, between phase 4 (joins) and phase 5 (segments)
        self._pending: list[dict] = []
        self.role = self.cfg.role
        # prefill tier: the handoff bus (serve/handoff.py) wires this to
        # receive each finished cohort's (reqs, first tokens, caches)
        # instead of seating them locally; the engine finishes the
        # exported requests with status `handoff`
        self.handoff_export = None
        self._state = CREATED
        self._state_lock = threading.Lock()
        self._wake = threading.Condition()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._latencies: list[float] = []
        self._counts: dict[str, int] = {}
        self._counts_lock = threading.Lock()
        self._drain_deadline: Optional[float] = None
        self._thread = None            # set by lifecycle.start_engine
        self._guard = None             # PreemptionGuard, set by lifecycle
        # telemetry handles captured ONCE, on the constructing thread
        # (the loop thread never sees the caller's contextvars)
        self._run = active_run()
        self._tracer = self._run.tracer if self._run is not None else None
        self._stops = np.asarray(self.cfg.stop_tokens or (), np.int64)

    def _decode_engine(self, weights: ServingWeights) -> DecodeEngine:
        return DecodeEngine(
            weights, self.cfg.max_new_tokens,
            temperature=self.cfg.temperature, top_k=self.cfg.top_k,
            top_p=self.cfg.top_p, stop_tokens=self.cfg.stop_tokens,
            chunk=self.cfg.cache_chunk, cache_dtype=self.cfg.cache_dtype,
            prefill_chunk=self.cfg.prefill_chunk or None,
            draft_module=self._draft, spec_tokens=self.cfg.spec_tokens,
            device=self.device)

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

    def warmup(self) -> "ServingEngine":
        """Run the serving shape classes BEFORE readiness flips: cohort
        prefills (each power-of-two join width up to capacity) and the
        segment ladder of a full-budget batch per warmup bucket.  The
        first call of each kernel builds it (nvcc), so a first real
        request never pays that build against its deadline; at the K1
        widths that needs a warm bucket of 512 or more tokens."""
        if self._state != CREATED:
            return self
        engine = self._engines["primary"]
        buckets = tuple(self.cfg.warmup_buckets) or (engine.bucket_for(1),)
        t0 = monotonic()
        for eng in self._engines.values():
            for bucket in buckets:
                self._warm_bucket(eng, int(bucket))
        self._record_serve({"event": "warmup_done",
                            "buckets": list(map(int, buckets)),
                            "seconds": round(monotonic() - t0, 3)})
        self._state = READY
        self._record_serve({"event": "ready"})
        get_logger("serve").info(
            "serving engine ready: buckets %s warmed in %.2fs",
            list(buckets), monotonic() - t0)
        return self

    def _warm_bucket(self, eng: DecodeEngine, bucket: int) -> None:
        """Run every shape class a full-budget batch in this bucket can
        touch: cohort prefills at each power-of-two join width, then a
        dummy capacity batch driven through the whole segment/window
        ladder.  With `warmup_joins` the sweep also covers the cohort
        merge at every grown cache width and the terminal segment class
        where the cache has already reached its final width."""
        cap = self.cfg.max_batch
        seg = self.cfg.segment_steps
        cohorts = {}
        chunks = eng.serve_prefill_chunks(bucket)
        n = 1
        while True:
            m = min(n, cap)
            prompts = np.zeros((m, bucket), np.int64)
            live = np.ones(m, bool)
            tl = np.ones(m, np.int64)
            seeds = self._row_seeds(np.arange(m))
            if chunks:
                # the chunked programs are what this bucket runs live
                state = None
                for ci in range(chunks):
                    state = eng.serve_prefill_chunk(prompts, tl, ci, state)
                tok, done, caches = eng.serve_prefill_finish(state, live,
                                                             seeds)
            else:
                tok, done, caches = eng.serve_prefill(prompts, tl, live,
                                                      seeds)
            if eng.spec_tokens:
                dcaches = eng.serve_draft_prefill(prompts)
            cohorts[m] = caches
            if n >= cap:
                break
            n *= 2
        if self.role == "prefill":
            # a prefill-tier engine never decodes or merges: the cohort
            # prefills above are its whole serving surface
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            return
        warmed_widths: set = set()

        def warm_joins(resident) -> None:
            # one merge per (resident width, cohort width, join count):
            # splice k rows from the power-of-two cohort a k-wide join
            # would prefill (`_cohort` pads the same way)
            width = int(resident[0][0].shape[1])
            if not self.cfg.warmup_joins or width in warmed_widths:
                return
            warmed_widths.add(width)
            for k in range(1, cap + 1):
                m = 1
                while m < k:
                    m *= 2
                # the dummy batch's contents do not matter: the merge may
                # write them in place
                DecodeEngine.merge_cache_rows(
                    resident, cohorts[min(m, cap)], list(range(k)),
                    list(range(k)))

        budget = np.full(cap, self.cfg.max_new_tokens, np.int64)
        t_row = np.zeros(cap, np.int64)
        t = 0
        warm_joins(caches)
        if eng.spec_tokens:
            # speculative lanes run rounds instead of segments: sweep the
            # window ladder at full-acceptance stride
            k1 = eng.spec_tokens + 1
            rounds = 0
            while t < self.cfg.max_new_tokens + k1:
                tr = np.minimum(t_row + t, self.cfg.max_new_tokens - 1)
                window = eng.serve_window(bucket, int(tr.max()), k1)
                (caches, dcaches, _, _, tok, done,
                 _) = eng.serve_spec_round(
                    caches, dcaches, tok, done, tl, budget, bucket, tr,
                    rounds, seeds, window)
                t += k1
                rounds += 1
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            return
        while t < self.cfg.max_new_tokens:
            window = eng.serve_window(bucket, t, seg)
            caches, _, tok, done = eng.serve_step(
                caches, tok, done, tl, budget, bucket, t_row, seeds, seg,
                window)
            t += seg
            t_row = t_row + seg
            warm_joins(caches)
        if self.cfg.warmup_joins:
            # terminal class: the widest window a live row can demand
            # (t_row = max_new - 1), entered with the cache already at
            # that width — the ladder stops one segment short of it
            final = eng.serve_window(bucket, self.cfg.max_new_tokens - 1,
                                     seg)
            for _ in range(2):
                caches, _, tok, done = eng.serve_step(
                    caches, tok, done, tl, budget, bucket, t_row, seeds,
                    seg, final)
                warm_joins(caches)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)

    def begin_drain(self, reason: str = "stop") -> None:
        """Stop admitting; in-flight requests finish or cancel by
        min(their deadline, now + drain_timeout); then the loop exits.
        Idempotent; safe from any thread (SIGTERM handler included)."""
        with self._state_lock:
            if self._state not in (CREATED, READY):
                return
            self._state = DRAINING
            self._drain_deadline = self.now() + self.cfg.drain_timeout_s
        self.admission.close(self.cfg.drain_timeout_s)
        inc_counter("serve.drains")
        trace_event("serve.drain_start", cat="serve", reason=reason)
        self._record_serve({"event": "drain_start", "reason": reason,
                            "in_flight": self.in_flight(),
                            "queued": self.admission.pending()})
        get_logger("serve").warning(
            "serving engine draining (%s): %d in flight, %d queued",
            reason, self.in_flight(), self.admission.pending())
        with self._wake:
            self._wake.notify_all()

    def _finish_drain(self) -> None:
        self._state = STOPPED
        trace_event("serve.drain_end", cat="serve")
        self._record_serve({"event": "drain_end",
                            "counts": dict(self._counts)})
        self._gauge_stats()
        with self._wake:
            self._wake.notify_all()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Graceful stop: drain, then join the loop thread (if any)."""
        self.begin_drain("stop")
        if self._thread is not None:
            self._thread.join(timeout if timeout is not None
                              else self.cfg.drain_timeout_s + 5.0)
        else:
            # inline engines drain synchronously (each tick makes
            # progress: joins, decode, or the drain-deadline cancel)
            while self._state == DRAINING:
                if self._drained():
                    self._finish_drain()
                    break
                self._tick()

    # -- submission --------------------------------------------------------
    def _new_id(self) -> int:
        with self._id_lock:
            self._next_id += 1
            return self._next_id

    def _validate(self, prompt, max_new_tokens: int) -> np.ndarray:
        try:
            arr = np.asarray(prompt, np.int32)
        except (TypeError, ValueError, OverflowError) as e:
            raise InvalidRequest(f"prompt is not a token array: {e}") from e
        if arr.ndim != 1 or arr.size < 1:
            raise InvalidRequest(
                f"prompt must be a non-empty 1-D token array, got shape "
                f"{arr.shape}")
        if arr.min() < 0 or arr.max() >= self.vocab_size:
            raise InvalidRequest(
                f"prompt tokens outside the vocabulary "
                f"[0, {self.vocab_size})")
        if not 1 <= int(max_new_tokens) <= self.cfg.max_new_tokens:
            raise InvalidRequest(
                f"max_new_tokens must be in [1, {self.cfg.max_new_tokens}],"
                f" got {max_new_tokens}")
        return arr

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None, trace=None) -> Request:
        """Admit one request or raise (`InvalidRequest` for poison,
        `Overloaded` when shed).  `priority` picks the admission lane
        ('interactive', the default, or 'batch' — weighted shedding
        costs the batch lane first under overload).  `trace` is an
        upstream TraceContext; a bare engine mints its own root and
        records the waterfall's `admit` event itself.  Returns the live
        `Request`; callers block on `request.wait()` or poll
        `request.finished`."""
        if not self.alive:
            self._count("shed_draining")
            self._count("shed")
            self._record_serve({"event": "shed", "reason": "draining"})
            raise Overloaded("draining", self.retry_after_s(),
                             f"engine is {self._state}")
        pri = str(priority) if priority is not None else INTERACTIVE
        if pri not in PRIORITIES:
            raise InvalidRequest(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        n_new = int(max_new_tokens if max_new_tokens is not None
                    else self.cfg.max_new_tokens)
        arr = self._validate(prompt, n_new)
        try:
            bucket = self._engines["primary"].bucket_for(arr.size)
        except ValueError as e:
            inc_counter("serve.poison")
            raise InvalidRequest(str(e)) from e
        now = self.now()
        deadline = now + (float(deadline_s) if deadline_s is not None
                          else self.cfg.default_deadline_s)
        req = Request(self._new_id(), arr, bucket, n_new, now, deadline,
                      priority=pri)
        try:
            self.admission.try_admit(req, self.in_flight_tokens())
        except Overloaded as e:
            self._count(f"shed_{e.reason}")
            self._count("shed")
            self._record_serve({"event": "shed", "reason": e.reason,
                                "request": req.id, "priority": pri})
            raise
        finally:
            # a full queue seats an interactive arrival by displacing
            # its newest queued BATCH request: finish the displaced ones
            # here, WITHOUT feeding the miss breaker (displacement is
            # weighted-shedding policy, not a deadline pathology)
            for d in self.admission.drain_displaced():
                d.finish(CANCELLED, now,
                         "displaced by interactive arrival")
                self._count("displaced")
                self._count("shed")
                self._record_serve({
                    "event": "shed", "reason": "displaced",
                    "request": d.id,
                    "priority": getattr(d, "priority", INTERACTIVE)})
        self._count("admitted")
        if req.degraded:
            self._count("degraded")
            self._record_serve({"event": "degraded", "request": req.id})
        if trace is not None:
            req.trace = trace
        else:
            # no router tier above: this engine IS the front door, so it
            # mints the root context and records the waterfall's `admit`
            req.trace = mint_context()
            if req.trace is not None:
                self._record_serve({"event": "admit", "request": req.id,
                                    "priority": pri, "bucket": bucket,
                                    "trace": req.trace.trace_id,
                                    "sampled": req.trace.sampled})
        if self._tracer is not None:
            req.span = self._tracer.span(
                "serve.request", cat="serve", request=req.id,
                bucket=bucket, prompt_len=arr.size, new_tokens=n_new,
                deadline_in_s=round(deadline - now, 4),
                **self._trace_fields(req))
        with self._wake:
            self._wake.notify_all()
        return req

    # -- accounting --------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        # front-end threads (submit) and the loop thread both count;
        # the lock keeps read-modify-write updates from losing increments
        with self._counts_lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def _record_serve(self, event: dict) -> None:
        if self._run is not None:
            self._run.record_serve(event)

    def _record_prefix(self, event: dict) -> None:
        if self._run is not None:
            self._run.record_prefix(event)

    def _gauge_prefix(self) -> None:
        # mmlspark_tpu_prefix_{hit_rate,resident_rows,resident_bytes,
        # evictions} on the Prometheus surface (observe/export.py)
        if self._run is None or self._prefix is None:
            return
        s = self._prefix.stats()
        self._run.gauge("prefix.hit_rate", round(s["hit_rate"], 4))
        self._run.gauge("prefix.resident_rows", s["resident_rows"])
        self._run.gauge("prefix.resident_bytes", s["resident_bytes"])
        self._run.gauge("prefix.evictions", s["evictions"])

    @staticmethod
    def _trace_fields(req: Request) -> dict:
        """The trace join fields a serve event/span carries (empty for an
        untraced request) — observe/assemble.py groups on `trace`."""
        t = getattr(req, "trace", None)
        return {"trace": t.trace_id, "sampled": t.sampled,
                "attempt": t.attempt} if t is not None else {}

    def retry_after_s(self) -> float:
        """The live backoff hint for refused/cancelled traffic: remaining
        drain time while draining, the configured drain budget once
        stopped, and the breaker's own cooldown otherwise."""
        now = self.now()
        if self._state == DRAINING and self._drain_deadline is not None:
            return max(0.1, self._drain_deadline - now)
        if self._state == STOPPED:
            return max(0.1, self.cfg.drain_timeout_s)
        return max(0.1, self.breaker.retry_in_s())

    def cancel_request(self, req: Request, detail: str = "cancelled") -> bool:
        """Withdraw one unfinished request — resident row, chunking, or
        still queued — WITHOUT feeding the miss breaker (the router
        cancelling a losing hedge attempt is scheduling, not engine
        failure).  True when the request was found and cancelled."""
        if req.finished:
            return False
        for g in list(self._groups.values()):
            for i in g.live_slots():
                if g.rows[i] is req:
                    req.finish(CANCELLED, self.now(), detail)
                    g.release(i)
                    self._count("cancelled_external")
                    return True
        for job in list(self._pending):
            if req in job["reqs"]:
                # its cohort row keeps prefilling (fixed shapes) but the
                # finish-time filter drops it before the splice
                req.finish(CANCELLED, self.now(), detail)
                self._count("cancelled_external")
                return True
        if self.admission.remove(req):
            req.finish(CANCELLED, self.now(), detail)
            self._count("cancelled_external")
            return True
        return False

    def in_flight(self) -> int:
        # list() the dict: submit threads read while the loop thread
        # adds/drops groups; chunked-prefill cohorts count too (they hold
        # reserved slots)
        return (sum(len(g.live_slots())
                    for g in list(self._groups.values()))
                + sum(len(job["reqs"]) for job in list(self._pending)))

    def in_flight_tokens(self) -> int:
        total = 0
        for g in list(self._groups.values()):
            for i in g.live_slots():
                req = g.rows[i]
                if req is not None:
                    total += max(0, req.max_new_tokens - len(req.tokens))
        for job in list(self._pending):
            for req in job["reqs"]:
                total += req.max_new_tokens
        return total

    def _row_seeds(self, ids) -> list:
        """Per-row sampling streams: `_mix(seed, request id)`."""
        return [_mix(int(self.cfg.seed), int(i)) for i in ids]

    def _complete(self, req: Request, status: str, detail: str = "") -> None:
        now = self.now()
        req.finish(status, now, detail)
        missed = status != OK or now > req.deadline
        self.breaker.record(missed)
        if self._run is not None:
            rec = {
                "event": "finish", "request": req.id, "status": status,
                "priority": getattr(req, "priority", INTERACTIVE),
                "deadline_miss": bool(missed),
                "latency_s": round(now - req.arrival, 6),
                **self._trace_fields(req)}
            # tail-based sampling: a head-unsampled request that finished
            # badly or slow is promoted to full waterfall detail
            tail = tail_promote(getattr(req, "trace", None), status=status,
                                latency_s=now - req.arrival)
            if tail:
                rec["tail"] = tail
            self._record_serve(rec)
        self._count("finished")
        self._count(status)
        if status == OK:
            self._latencies.append(now - req.arrival)
            self._count("tokens_served", len(req.tokens))
            if now > req.deadline:
                self._count("deadline_miss")
                inc_counter("serve.deadline_miss")
                trace_event("serve.deadline_miss", cat="serve",
                            request=req.id,
                            late_s=round(now - req.deadline, 4))
            else:
                self._count("met_deadline")
                self._count("goodput_tokens", len(req.tokens))
        elif status == TIMEOUT:
            self._count("deadline_miss")
            inc_counter("serve.timeouts")
        inc_counter(f"serve.{status}")

    # -- the scheduler pass ------------------------------------------------
    def _tick(self) -> bool:
        """One scheduler pass: expire, join, advance every group one
        segment, harvest.  Returns True when any work was done (the loop
        idles on False).  Synchronous and sleep-free: tests drive it
        directly under a VirtualClock."""
        if (self._guard is not None and self._guard.triggered
                and self._state == READY):
            # SIGTERM arrived (PreemptionGuard flag): drain, never die
            # mid-decode — checked here as well as in the loop so inline
            # (threadless) engines honor the signal too
            self.begin_drain("sigterm")
        now = self.now()
        worked = False
        # 1. expire queued requests whose deadline already passed
        for req in self.admission.drop_expired(now):
            self._complete(req, TIMEOUT, "expired in queue")
            worked = True
        # 2. drain-deadline enforcement: past it, cancel everything left
        if self._state == DRAINING and now >= (self._drain_deadline or 0):
            for g in self._groups.values():
                for i in g.live_slots():
                    self._complete(g.rows[i], CANCELLED, "drain timeout")
                    g.release(i)
                    worked = True
            for job in self._pending:
                for req in job["reqs"]:
                    self._complete(req, CANCELLED, "drain timeout")
                    worked = True
                self._release_job_lease(job)
            self._pending.clear()
            for req in self.admission.drop_expired(float("inf")):
                self._complete(req, CANCELLED, "drain timeout")
                worked = True
            self._groups.clear()
            return worked
        # 3. cancel expired resident rows at the boundary
        for g in self._groups.values():
            for i in g.live_slots():
                req = g.rows[i]
                if req.deadline <= now:
                    self._complete(req, TIMEOUT, "cancelled at boundary")
                    trace_event("serve.cancel", cat="serve",
                                request=req.id, at_step=int(g.t_row[i]))
                    g.release(i)
                    worked = True
        # 4. joins: pull queued work into free slots, bucket by bucket
        for bucket, lane in self.admission.queued_buckets():
            g = self._groups.get((bucket, lane))
            if g is None:
                g = self._groups[(bucket, lane)] = _Group(
                    bucket, self.cfg.max_batch)
            free = g.free_slots()
            if not free:
                continue
            reqs = self.admission.take(bucket, len(free), lane)
            if reqs:
                slots = free[:len(reqs)]
                if self._prefix is not None and lane == "primary":
                    # peel prefix-pool hits off the cohort: each resumes
                    # from its donor rows (only the novel suffix
                    # prefills); misses keep the normal cohort path
                    reqs, slots = self._join_prefix_hits(g, lane, reqs,
                                                         slots)
                if reqs:
                    if self._engines[lane].serve_prefill_chunks(bucket):
                        self._start_chunked_join(g, lane, reqs, slots)
                    else:
                        self._join(g, lane, reqs, slots)
                worked = True
        # 4b. advance every in-flight chunked prefill by ONE chunk: the
        # long forward yields to phase 5 between chunks instead of
        # holding the tick for the whole prompt
        for job in list(self._pending):
            self._advance_prefill(job)
            worked = True
        # 5. advance each group one segment
        for (bucket, lane), g in list(self._groups.items()):
            if g.live_slots():
                self._advance(g, lane)
                worked = True
            elif not g.reserved and not self.admission.pending():
                # empty group with no queued work: drop the cache memory
                del self._groups[(bucket, lane)]
        return worked

    def _cohort(self, g: _Group, reqs: list) -> tuple:
        """Pack a join cohort: padded to a power of two (capped at
        capacity) so join batches reuse a handful of shape classes."""
        k = len(reqs)
        n = 1
        while n < k:
            n *= 2
        n = min(n, g.capacity)
        prompts = np.zeros((n, g.bucket), np.int64)
        true_len = np.ones(n, np.int64)
        live = np.zeros(n, bool)
        ids = np.zeros(n, np.int64)
        for j, req in enumerate(reqs):
            prompts[j, :req.true_len] = req.prompt
            true_len[j] = req.true_len
            live[j] = True
            ids[j] = req.id
        return prompts, true_len, live, ids

    def _join(self, g: _Group, lane: str, reqs: list, slots: list) -> None:
        """Prefill a join cohort and splice it into the resident batch."""
        eng = self._engines[lane]
        prompts, true_len, live, ids = self._cohort(g, reqs)
        t0 = monotonic()
        with span_on_tracer(self._tracer, "serve.prefill", cat="serve",
                            bucket=g.bucket, cohort=len(ids),
                            joins=len(reqs), lane=lane):
            tok, done, caches = eng.serve_prefill(
                prompts, true_len, live, self._row_seeds(ids))
            # the host copy waits for the device: the span is device time
            tok_h = tok.cpu().numpy()
        self.estimator.observe_prefill(g.bucket, monotonic() - t0)
        self._splice(g, lane, reqs, slots, list(range(len(reqs))), tok_h,
                     caches, prompts)

    def _join_prefix_hits(self, g: _Group, lane: str, reqs: list,
                          slots: list) -> tuple:
        """Try each join candidate against the prefix pool.  Hits resume
        from their donor rows — inline, or as a pending chunked-resume
        job when chunked prefill covers the suffix — and misses return
        for the normal cohort path.  The donor lease holds until the
        hit's splice lands (an in-flight resume never loses its slots to
        eviction)."""
        eng = self._engines[lane]
        miss_reqs, miss_slots = [], []
        for req, slot in zip(reqs, slots):
            # match only whole chunks STRICTLY inside the prompt, so the
            # resumed prefill always recomputes the last prompt
            # position's logits itself
            limit = ((req.true_len - 1) // self._prefix.chunk
                     ) * self._prefix.chunk
            hit = (self._prefix.acquire(req.prompt, limit)
                   if limit else None)
            if hit is None:
                miss_reqs.append(req)
                miss_slots.append(slot)
                continue
            matched = hit.n_tokens
            self._count("prefix_hits")
            inc_counter("serve.prefix_hit")
            self._record_prefix({
                "event": "hit", "request": req.id, "bucket": g.bucket,
                "lane": lane, "matched": matched,
                "suffix": int(req.true_len) - matched})
            if eng.serve_resume_chunks(g.bucket, matched):
                self._start_chunked_resume(g, lane, req, slot, hit)
            else:
                self._join_resume(g, lane, req, slot, hit)
        return miss_reqs, miss_slots

    @staticmethod
    def _one_row(g: _Group, req: Request) -> np.ndarray:
        prompts = np.zeros((1, g.bucket), np.int64)
        prompts[0, :req.true_len] = req.prompt
        return prompts

    def _join_resume(self, g: _Group, lane: str, req: Request, slot: int,
                     hit) -> None:
        """Resume one prefix hit inline: dequantize and copy the donor
        rows, prefill the whole novel suffix in one segment, finish and
        splice — the same (tok, done, caches) contract as a fresh cohort
        prefill, so greedy tokens stay a fresh prefill's."""
        eng = self._engines[lane]
        matched = hit.n_tokens
        t0 = monotonic()
        try:
            with span_on_tracer(self._tracer, "serve.prefill_resume",
                                cat="serve", bucket=g.bucket, lane=lane,
                                matched=matched,
                                suffix=int(req.true_len) - matched):
                tok, done, caches = eng.serve_prefill_resume(
                    self._one_row(g, req), [req.true_len], matched,
                    _assemble_prefix_row(hit.rows), np.ones(1, bool),
                    self._row_seeds([req.id]))
                # the host copy waits for the device: the span is device
                # time
                tok_h = tok.cpu().numpy()
            self.estimator.observe_prefill(g.bucket, monotonic() - t0)
            self._splice(g, lane, [req], [slot], [0], tok_h, caches,
                         self._one_row(g, req))
        finally:
            self._prefix.release(hit)

    def _start_chunked_resume(self, g: _Group, lane: str, req: Request,
                              slot: int, hit) -> None:
        """Queue a chunked RESUME: like `_start_chunked_join`, but the
        state opens from the donor rows and the chunk index starts past
        the matched prefix — `_advance_prefill` then runs the suffix one
        chunk per tick.  The donor lease holds across ticks until the
        splice."""
        eng = self._engines[lane]
        g.reserved.add(slot)
        state = eng.serve_resume_init(_assemble_prefix_row(hit.rows),
                                      g.bucket)
        self._pending.append(dict(
            group=g, lane=lane, reqs=[req], slots=[slot],
            prompts=self._one_row(g, req),
            true_len=np.asarray([req.true_len], np.int64),
            live=np.ones(1, bool), ids=np.asarray([req.id], np.int64),
            state=state, index=hit.n_tokens // eng.prefill_chunk,
            chunks=eng.serve_prefill_chunks(g.bucket), elapsed=0.0,
            hit=hit))

    def _release_job_lease(self, job: dict) -> None:
        hit = job.get("hit")
        if hit is not None and self._prefix is not None:
            self._prefix.release(hit)
            job["hit"] = None

    def _start_chunked_join(self, g: _Group, lane: str, reqs: list,
                            slots: list) -> None:
        """Queue a chunked join: slots are reserved (not yet resident)
        and `_advance_prefill` runs ONE prompt chunk per tick until the
        cohort finishes and splices in."""
        prompts, true_len, live, ids = self._cohort(g, reqs)
        g.reserved.update(slots)
        eng = self._engines[lane]
        self._pending.append(dict(
            group=g, lane=lane, reqs=reqs, slots=slots, prompts=prompts,
            true_len=true_len, live=live, ids=ids, state=None, index=0,
            chunks=eng.serve_prefill_chunks(g.bucket), elapsed=0.0))

    def _advance_prefill(self, job: dict) -> None:
        """One chunk of an in-flight chunked prefill; after the last
        chunk, finish (sample, quantize) and splice the cohort in.  The
        estimator's prefill EWMA sees the SUMMED chunk time, the full
        prompt's cost."""
        g: _Group = job["group"]
        lane = job["lane"]
        eng = self._engines[lane]
        t0 = monotonic()
        with span_on_tracer(self._tracer, "serve.prefill_chunk",
                            cat="serve", bucket=g.bucket, lane=lane,
                            index=job["index"], chunks=job["chunks"]):
            job["state"] = eng.serve_prefill_chunk(
                job["prompts"], job["true_len"], job["index"],
                job["state"])
            if eng.device.type == "cuda":
                # the span closes on the device's time, not the launch's
                torch.cuda.synchronize(eng.device)
        job["elapsed"] += monotonic() - t0
        if self._run is not None:
            rec = {"event": "prefill_chunk", "bucket": g.bucket,
                   "lane": lane, "index": job["index"],
                   "chunks": job["chunks"],
                   "requests": [r.id for r in job["reqs"]]}
            traces = [r.trace.trace_id for r in job["reqs"]
                      if getattr(r, "trace", None) is not None]
            if traces:
                rec["traces"] = traces
            self._record_serve(rec)
        job["index"] += 1
        if job["index"] < job["chunks"]:
            return
        self._pending.remove(job)
        g.reserved.difference_update(job["slots"])
        t0 = monotonic()
        tok, done, caches = eng.serve_prefill_finish(
            job["state"], job["live"], self._row_seeds(job["ids"]))
        tok_h = tok.cpu().numpy()
        job["elapsed"] += monotonic() - t0
        self.estimator.observe_prefill(g.bucket, job["elapsed"])
        # requests whose deadline passed while their prompt was still
        # chunking: finish as timeouts, splice only the survivors
        now = self.now()
        reqs, slots, src = [], [], []
        for j, (req, slot) in enumerate(zip(job["reqs"], job["slots"])):
            if req.finished:
                continue
            if req.deadline <= now:
                self._complete(req, TIMEOUT, "expired during prefill")
                continue
            reqs.append(req)
            slots.append(slot)
            src.append(j)
        if reqs:
            self._splice(g, lane, reqs, slots, src, tok_h, caches,
                         job["prompts"])
        self._release_job_lease(job)

    def _splice(self, g: _Group, lane: str, reqs: list, slots: list,
                src: list, tok_h, caches, prompts) -> None:
        """Merge cohort cache rows into the group (on a speculative lane
        also the draft cache rows of the cohort's `prompts`, prefilled
        here), seat the requests, and (primary lane, pool on) pool their
        prompt prefixes.

        On a PREFILL-tier engine this is where the work leaves: the
        finished cohort's caches go to the handoff bus instead of a
        resident slot, and each engine request ends `handoff` — the
        router's fleet request stays open until a decode replica splices
        the shipped rows and finishes the decode attempt."""
        eng = self._engines[lane]
        if self.role == "prefill" and self.handoff_export is not None:
            now = self.now()
            self.handoff_export(bucket=g.bucket, lane=lane, reqs=reqs,
                                src=src, tok_h=tok_h, caches=caches)
            for req in reqs:
                self._count("handoffs")
                trace_event("serve.handoff_out", cat="serve",
                            request=req.id, bucket=g.bucket, lane=lane,
                            **self._trace_fields(req))
                req.finish(HANDOFF, now)
            return
        if g.caches is None:
            g.caches = self._empty_caches(eng, g.capacity, g.bucket)
        g.caches = DecodeEngine.merge_cache_rows(g.caches, caches, slots,
                                                 src)
        if eng.spec_tokens:
            draft = eng.serve_draft_prefill(prompts)
            if g.draft_caches is None:
                g.draft_caches = self._empty_caches(
                    eng, g.capacity, g.bucket, eng.draft_weights)
            g.draft_caches = DecodeEngine.merge_cache_rows(
                g.draft_caches, draft, slots, src)
        for j, (req, slot) in zip(src, zip(reqs, slots)):
            g.rows[slot] = req
            g.tok[slot] = tok_h[j]
            g.true_len[slot] = req.true_len
            g.budget[slot] = req.max_new_tokens
            g.t_row[slot] = 0
            g.row_ids[slot] = req.id
            g.done[slot] = False
            trace_event("serve.join", cat="serve", request=req.id,
                        bucket=g.bucket, slot=slot, lane=lane,
                        **self._trace_fields(req))
            self._record_serve({"event": "join", "request": req.id,
                                "bucket": g.bucket, "slot": slot,
                                "lane": lane, **self._trace_fields(req)})
            if self._run is not None:
                # attempt-level TTFT: arrival at this engine to its first
                # emitted token (the fleet-level TTFT of a tiered fleet,
                # arrival at the router to the decode-tier splice, lands
                # in serve/handoff.py)
                self._run.observe_hist("serve.ttft_s",
                                       self.now() - req.arrival)
            self._emit(g, slot, [int(tok_h[j])])
        if self._prefix is not None and lane == "primary":
            self._insert_prefix_rows(reqs, src, caches)
            self._gauge_prefix()

    def _insert_prefix_rows(self, reqs: list, src: list, caches) -> None:
        """Pool each freshly spliced request's prompt-prefix slots: the
        greatest chunk multiple STRICTLY inside the prompt, so a later
        resume always recomputes the final prompt position itself.
        First-writer-wins per chunk; a refused eviction (every candidate
        leased) skips the deeper chunks rather than forcing anything.
        The pool copies what it keeps (`PrefixCache.insert`)."""
        chunk = self._prefix.chunk
        for j, req in zip(src, reqs):
            n = ((req.true_len - 1) // chunk) * chunk
            if n < chunk:
                continue
            row = [tuple(t[j:j + 1] for t in layer) for layer in caches]
            with torch.inference_mode():
                res = self._prefix.insert(req.prompt, n, row)
            if res["inserted"]:
                self._count("prefix_inserts", res["inserted"])
                self._record_prefix({
                    "event": "insert", "request": req.id,
                    "chunks": res["inserted"], "tokens": n})
            if res["evicted"]:
                self._count("prefix_evictions", res["evicted"])
                self._record_prefix({
                    "event": "evict", "chunks": res["evicted"],
                    "request": req.id})
            if res["refused"]:
                self._count("prefix_evictions_refused")
                inc_counter("serve.prefix_eviction_refused")
                self._record_prefix({"event": "evict_refused",
                                     "request": req.id})

    def _empty_caches(self, eng: DecodeEngine, capacity: int,
                      bucket: int, weights=None) -> list:
        """A group's zeroed resident caches at the bucket's first window,
        in the engine's cache layout (the int8 4-tuple: payloads and f32
        per-(row, slot, head) scales); with `weights` (the draft's),
        model-dtype caches of that model."""
        w = weights or eng.weights
        shape = (capacity, _round_up(bucket + 1, self.cfg.cache_chunk),
                 w.n_heads, w.d_model // w.n_heads)
        with torch.inference_mode():
            if eng.cache_dtype == "int8" and weights is None:
                def layer():
                    return (torch.zeros(shape, dtype=torch.int8,
                                        device=eng.device),
                            torch.zeros(shape[:3], device=eng.device))
                return [layer() + layer() for _ in range(w.n_layers)]
            return [tuple(torch.zeros(shape, dtype=w.dtype,
                                      device=eng.device) for _ in range(2))
                    for _ in range(w.n_layers)]

    def splice_remote(self, prompt: np.ndarray, max_new_tokens: int,
                      deadline: float, first_tok: int, src_caches,
                      lane: str = "primary", trace=None) -> Optional[Request]:
        """Seat one handed-off row (decode tier): merge the deserialized
        1-row cache into this engine's resident batch through
        `merge_cache_rows` and decode it to completion like any join.
        `trace` is the TraceContext that rode the kv_begin header — the
        decode attempt keeps the fleet request's trace id.  Returns the
        seated engine Request, or None when no slot is free or the
        engine is not alive — the handoff bus retries next tick (bounded
        by the transfer timeout and the request deadline)."""
        if not self.alive:
            return None
        eng = self._engines[lane]
        arr = np.asarray(prompt, np.int32)
        bucket = eng.bucket_for(arr.size)
        g = self._groups.get((bucket, lane))
        if g is None:
            g = self._groups[(bucket, lane)] = _Group(
                bucket, self.cfg.max_batch)
        free = g.free_slots()
        if not free:
            return None
        slot = free[0]
        now = self.now()
        req = Request(self._new_id(), arr, bucket, max_new_tokens, now,
                      float(deadline))
        req.trace = trace
        if g.caches is None:
            g.caches = self._empty_caches(eng, g.capacity, bucket)
        g.caches = DecodeEngine.merge_cache_rows(g.caches, src_caches,
                                                 [slot], [0])
        g.rows[slot] = req
        g.tok[slot] = int(first_tok)
        g.true_len[slot] = req.true_len
        g.budget[slot] = req.max_new_tokens
        g.t_row[slot] = 0
        g.row_ids[slot] = req.id
        g.done[slot] = False
        self._count("remote_joins")
        trace_event("serve.handoff_in", cat="serve", request=req.id,
                    bucket=bucket, slot=slot, lane=lane,
                    **self._trace_fields(req))
        self._record_serve({"event": "remote_join", "request": req.id,
                            "bucket": bucket, "slot": slot, "lane": lane,
                            **self._trace_fields(req)})
        self._emit(g, slot, [int(first_tok)])
        if self._prefix is not None and lane == "primary":
            # the pool lives on the DECODE tier of a disaggregated fleet:
            # handed-off rows are the tier's only prefill source, so they
            # are what populates it (ServeConfig refuses the pool on the
            # prefill tier)
            self._insert_prefix_rows([req], [0], src_caches)
            self._gauge_prefix()
        return req

    def _emit(self, g: _Group, slot: int, tokens: list) -> None:
        """Append emitted tokens to a row's request, honoring its budget
        and stop tokens; completes (and frees) the row when finished."""
        req = g.rows[slot]
        stopped = False
        appended = False
        for tok in tokens:
            if len(req.tokens) >= req.max_new_tokens:
                break
            req.tokens.append(int(tok))
            appended = True
            if self._stops.size and int(tok) in self._stops:
                stopped = True
                break
        if stopped or len(req.tokens) >= req.max_new_tokens:
            self._complete(req, OK)
            g.release(slot)
        elif appended:
            # segment-boundary flush point: wake any streaming reader
            # (finish() notifies on its own for the completed case)
            req.note_tokens()

    def _advance(self, g: _Group, lane: str) -> None:
        """Run one mixed-age segment (on a speculative lane one
        draft/verify round) for a group and harvest the results."""
        eng = self._engines[lane]
        if eng.spec_tokens:
            self._advance_spec(g, lane)
            return
        seg = self.cfg.segment_steps
        live = g.live_slots()
        max_t = int(g.t_row[live].max()) if live else 0
        window = eng.serve_window(g.bucket, max_t, seg)
        t0 = monotonic()
        with span_on_tracer(self._tracer, "serve.segment", cat="serve",
                            bucket=g.bucket, lane=lane, seg_len=seg,
                            window=window, occupancy=round(
                                len(live) / g.capacity, 3)):
            caches, toks, tok, done = eng.serve_step(
                g.caches, g.tok, g.done, g.true_len, g.budget, g.bucket,
                g.t_row, self._row_seeds(g.row_ids), seg, window)
            # the host copies wait for the device: the span is device time
            toks_h = toks.cpu().numpy()
            tok_h = tok.cpu().numpy()
            done_h = done.cpu().numpy()
        elapsed = monotonic() - t0
        self.estimator.observe_step(g.bucket, elapsed / seg)
        self._record_serve({"event": "segment", "bucket": g.bucket,
                            "lane": lane, "rows": len(live)})
        if self._run is not None:
            # per-token pacing: one sample per segment (segment wall over
            # its decode steps), not per token — bounded-cost by design
            self._run.observe_hist("serve.inter_token_s", elapsed / seg)
        g.caches = caches
        g.tok = tok_h.astype(np.int64)
        g.done = done_h.astype(bool)
        for i in live:
            if g.rows[i] is None:
                continue
            self._emit(g, i, toks_h[i].tolist())
            if g.rows[i] is not None:
                g.t_row[i] += seg
        if self._run is not None:
            self._run.gauge("serve.queue_depth", self.admission.pending())
            self._run.gauge("serve.in_flight", self.in_flight())
            self._gauge_prefix()

    def _advance_spec(self, g: _Group, lane: str) -> None:
        """One speculative round: the draft proposes, one target forward
        verifies, each row advances by the tokens it committed.  The
        estimator's per-step EWMA sees the round's time over the tokens a
        live row emitted, the measured speedup."""
        eng = self._engines[lane]
        k1 = eng.spec_tokens + 1
        live = g.live_slots()
        max_t = int(g.t_row[live].max()) if live else 0
        window = eng.serve_window(g.bucket, max_t, k1)
        t0 = monotonic()
        with span_on_tracer(self._tracer, "serve.spec_round", cat="serve",
                            bucket=g.bucket, lane=lane, window=window,
                            occupancy=round(len(live) / g.capacity, 3)):
            (caches, draft_caches, toks, counts, tok, done,
             accepted) = eng.serve_spec_round(
                g.caches, g.draft_caches, g.tok, g.done, g.true_len,
                g.budget, g.bucket, g.t_row, g.spec_rounds,
                self._row_seeds(g.row_ids), window)
            # the host copies wait for the device: the span is device time
            toks_h = toks.cpu().numpy()
            counts_h = counts.cpu().numpy()
            tok_h = tok.cpu().numpy()
            done_h = done.cpu().numpy()
            accepted_h = accepted.cpu().numpy()
        elapsed = monotonic() - t0
        g.spec_rounds += 1
        emitted = int(counts_h[live].sum())
        per_row = emitted / max(1, len(live))
        self.estimator.observe_step(g.bucket, elapsed / max(1.0, per_row))
        inc_counter("serve.spec_drafted_tokens", eng.spec_tokens * len(live))
        inc_counter("serve.spec_accepted_tokens", int(accepted_h[live].sum()))
        self._record_serve({"event": "segment", "bucket": g.bucket,
                            "lane": lane, "rows": len(live), "spec": True,
                            "emitted": emitted})
        if self._run is not None:
            self._run.observe_hist("serve.inter_token_s",
                                   elapsed / max(1.0, per_row))
        g.caches, g.draft_caches = caches, draft_caches
        g.tok = tok_h.astype(np.int64)
        g.done = done_h.astype(bool)
        for i in live:
            if g.rows[i] is None:
                continue
            take = int(counts_h[i])
            if take:
                self._emit(g, i, toks_h[i][:take].tolist())
            if g.rows[i] is not None:
                g.t_row[i] += take
        if self._run is not None:
            self._run.gauge(
                "serve.spec_acceptance_rate",
                round(float(accepted_h[live].sum())
                      / max(1, eng.spec_tokens * len(live)), 4))
            self._run.gauge("serve.queue_depth", self.admission.pending())
            self._run.gauge("serve.in_flight", self.in_flight())

    # -- the loop (spawned by serve/lifecycle.py) -------------------------
    def _drained(self) -> bool:
        return (self._state == DRAINING and self.in_flight() == 0
                and self.admission.pending() == 0)

    def _loop(self) -> None:
        """The scheduler thread body: tick, check the SIGTERM guard,
        idle on the condition when there is no work."""
        while True:
            if (self._guard is not None and self._guard.triggered
                    and self._state == READY):
                self.begin_drain("sigterm")
            if self._state == STOPPED:
                return
            worked = self._tick()
            if self._drained():
                self._finish_drain()
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
        """Counts + latency percentiles (seconds) + breaker state — the
        dict the drills, bench arm, and gauges read."""
        out = dict(self._counts)
        out["in_flight"] = self.in_flight()
        out["queued"] = self.admission.pending()
        out["state"] = self._state
        out["breaker_state"] = self.breaker.state
        if self._prefix is not None:
            out["prefix"] = self._prefix.stats()
        for name, q in (("p50", 50), ("p95", 95), ("p99", 99)):
            p = self._percentile(q)
            out[f"latency_{name}_s"] = round(p, 6) if p is not None else None
        return out

    def prefix_stats(self) -> Optional[dict]:
        """The prefix pool's live stats dict (None when the pool is off)
        — surfaced per replica in `Replica.health()` and `/statz`."""
        return self._prefix.stats() if self._prefix is not None else None

    def _gauge_stats(self) -> None:
        if self._run is None:
            return
        for name, q in (("p50", 50), ("p95", 95), ("p99", 99)):
            p = self._percentile(q)
            if p is not None:
                self._run.gauge(f"serve.latency_{name}_ms", p * 1e3)
        for key in ("admitted", "shed", "ok", "timeout", "cancelled",
                    "degraded", "goodput_tokens"):
            self._run.gauge(f"serve.{key}", self._counts.get(key, 0))
