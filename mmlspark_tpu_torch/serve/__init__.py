"""Online serving over the decode engine (the port of the colocated half
of `mmlspark_tpu/serve/`).

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
  * `replica` / `router` — the replicated colocated fleet (`Replica`,
    `ReplicaUnavailable`, `Router`, `RouterConfig`, `RouterRequest`,
    `RetryBudget`, `build_fleet`): N engine replicas behind one
    admission door, power-of-two-choices, outlier ejection with
    half-open probe re-admission, failover under a retry budget,
    optional hedging, prefix affinity;
  * `lifecycle` — warmup/readiness, the loop + HTTP threads (the ONE
    module of this package that spawns them; `start_engine` for one
    engine, `start_router` for a fleet), SIGTERM -> graceful drain;
  * `http` — stdlib-only request front end + health endpoints
    (`/healthz`, `/readyz`, `/statz`, `/tracez`, POST `/generate` with
    optional chunked token streaming), in front of an engine or a router.

Not ported yet: the disaggregated prefill/decode tiers and their KV
handoff (ROADMAP A9's handoff step).
"""

from mmlspark_tpu_torch.serve.admission import (AdmissionController,
                                                InvalidRequest,
                                                MissRateBreaker, Overloaded,
                                                StepTimeEstimator)
from mmlspark_tpu_torch.serve.engine import ServeConfig, ServingEngine
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
    "AdmissionController", "InvalidRequest", "MissRateBreaker",
    "Overloaded", "PrefixCache", "PrefixHit", "Replica",
    "ReplicaUnavailable", "Request", "RetryBudget", "Router",
    "RouterConfig", "RouterRequest", "ServeConfig", "ServingEngine",
    "StepTimeEstimator", "build_fleet", "drain_on_sigterm",
    "serve_forever", "start_engine", "start_http", "start_router",
    "stop_http",
]
