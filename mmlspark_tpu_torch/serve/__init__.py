"""Online serving over the decode engine (the port of
`mmlspark_tpu/serve/`).

  * `admission` — bounded queue + deadline-feasibility admission control
    and the deadline-miss-rate breaker (shed at the front door, not by
    timing out in the back);
  * `engine` — the continuous-batching scheduler over `DecodeEngine`'s
    serve hooks (join at segment boundaries, cancel expired rows,
    failover to a degraded bundle's lane), with chunked prefill
    interleaved with decode segments and the prefix pool's resumes;
  * `prefix_cache` — the cross-request radix prefix KV cache (`PrefixCache`,
    `PrefixHit`): chunk-granular trie of finished cache rows with LRU
    eviction and lease pinning, so requests sharing a prompt prefix
    prefill only their novel suffix;
  * `replica` / `router` — the replicated fleet (`Replica`,
    `ReplicaUnavailable`, `Router`, `RouterConfig`, `RouterRequest`,
    `RetryBudget`, `build_fleet`): N engine replicas behind one
    admission door, power-of-two-choices, outlier ejection with
    half-open probe re-admission, failover under a retry budget,
    optional hedging, prefix affinity — or, tiered, a prefill tier and a
    decode tier;
  * `handoff` — the tiered fleet's KV handoff bus (`HandoffBus`): prefill
    replicas ship finished (int8-capable) cache rows as crc-checked
    chunk pages over the transport's frames to the decode tier, with
    acks, watchdogs, and re-prefill failover;
  * `lifecycle` — warmup/readiness, the loop + HTTP threads (the ONE
    module of this package that spawns them; `start_engine` for one
    engine, `start_router` for a fleet), SIGTERM -> graceful drain;
  * `http` — stdlib-only request front end + health endpoints
    (`/healthz`, `/readyz`, `/statz`, `/tracez`, POST `/generate` with
    optional chunked token streaming), in front of an engine or a router.
"""

from mmlspark_tpu_torch.serve.admission import (AdmissionController,
                                                InvalidRequest,
                                                MissRateBreaker, Overloaded,
                                                StepTimeEstimator)
from mmlspark_tpu_torch.serve.engine import ServeConfig, ServingEngine
from mmlspark_tpu_torch.serve.handoff import HandoffBus
from mmlspark_tpu_torch.serve.lifecycle import (drain_on_sigterm,
                                                serve_forever, start_engine,
                                                start_http, start_router,
                                                stop_http)
from mmlspark_tpu_torch.serve.prefix_cache import PrefixCache, PrefixHit
from mmlspark_tpu_torch.serve.replica import Replica, ReplicaUnavailable
from mmlspark_tpu_torch.serve.request import Request
from mmlspark_tpu_torch.serve.router import (RetryBudget, Router,
                                             RouterConfig, RouterRequest,
                                             build_fleet)

__all__ = [
    "AdmissionController", "HandoffBus", "InvalidRequest",
    "MissRateBreaker",
    "Overloaded", "PrefixCache", "PrefixHit", "Replica",
    "ReplicaUnavailable", "Request", "RetryBudget", "Router",
    "RouterConfig", "RouterRequest", "ServeConfig", "ServingEngine",
    "StepTimeEstimator", "build_fleet", "drain_on_sigterm",
    "serve_forever", "start_engine", "start_http", "start_router",
    "stop_http",
]
