"""Online serving over the decode engine (the port of the colocated half
of `mmlspark_tpu/serve/`).

  * `admission` — bounded queue + deadline-feasibility admission control
    and the deadline-miss-rate breaker (shed at the front door, not by
    timing out in the back);
  * `engine` — the continuous-batching scheduler over `DecodeEngine`'s
    serve hooks (join at segment boundaries, cancel expired rows,
    failover to a degraded bundle's lane);
  * `lifecycle` — warmup/readiness, the loop + HTTP threads (the ONE
    module of this package that spawns them), SIGTERM -> graceful drain;
  * `http` — stdlib-only request front end + health endpoints
    (`/healthz`, `/readyz`, `/statz`, `/tracez`, POST `/generate` with
    optional chunked token streaming).

Not ported yet: the replicated fleet (`replica`, `router`), the prefix
cache and the disaggregated KV handoff (ROADMAP A9's next step).
"""

from mmlspark_tpu_torch.serve.admission import (AdmissionController,
                                                InvalidRequest,
                                                MissRateBreaker, Overloaded,
                                                StepTimeEstimator)
from mmlspark_tpu_torch.serve.engine import ServeConfig, ServingEngine
from mmlspark_tpu_torch.serve.lifecycle import (drain_on_sigterm,
                                                serve_forever, start_engine,
                                                start_http, stop_http)
from mmlspark_tpu_torch.serve.request import Request

__all__ = [
    "AdmissionController", "InvalidRequest", "MissRateBreaker",
    "Overloaded", "Request", "ServeConfig", "ServingEngine",
    "StepTimeEstimator", "drain_on_sigterm", "serve_forever",
    "start_engine", "start_http", "stop_http",
]
