"""The data service: a multi-process ingestion tier (the port of
`mmlspark_tpu/data/service/`).

A consumer's host CPUs may not feed the card: in one process, decoding
runs under one GIL (PIL's decoder holds it for its copies).  This
package moves graph execution out of the consumer: `Dataset.distribute()`
serializes the plan (data/graph.py), a dispatcher (dispatcher.py) cuts
the output stream into splits and drives a fleet of worker processes
(worker.py) over length-prefixed socket frames (transport.py, the
package's only socket and subprocess module), and the consumer pulls
ready elements either first-come (dynamic sharding) or reassembled
byte-identically (deterministic mode).  Workers run with no card visible
(`CUDA_VISIBLE_DEVICES=""`) and send numpy arrays; resize, batching and
scoring on the card stay in the consumer.

Knobs (each overridable per `distribute()` call), with the JAX
package's names and defaults:

  MMLSPARK_TPU_DATA_SERVICE_WORKERS       fleet size (0 = autoscale,
                                          negative = bypass the service)
  MMLSPARK_TPU_DATA_SERVICE_MODE          'process' | 'inproc'
  MMLSPARK_TPU_DATA_SERVICE_SPLIT_ELEMS   elements per split
  MMLSPARK_TPU_DATA_SERVICE_MAX_WORKERS   autoscale ceiling
  MMLSPARK_TPU_DATA_SERVICE_RESPAWNS      worker respawn budget
  MMLSPARK_TPU_DATA_SERVICE_START_TIMEOUT first-data deadline (s)
  MMLSPARK_TPU_DATA_SERVICE_CHAOS         worker-side fault injection
  MMLSPARK_TPU_DATA_SERVICE_WORKER_LOG    per-worker stderr log dir
  MMLSPARK_TPU_DATA_SERVICE_WORKER_NS     (registered in
                                          parallel/prefetch.py) gauge
                                          namespace inside a worker
"""

from __future__ import annotations

from mmlspark_tpu_torch import config

SERVICE_WORKERS = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_WORKERS", default=2, ptype=int,
    doc="Default worker count for Dataset.distribute(): positive pins "
        "the fleet size, 0 autoscales from one worker on stall evidence "
        "(data/autotune.py), negative bypasses the service entirely "
        "(the graph runs locally in-process).")

SERVICE_MODE = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_MODE", default="process",
    doc="Default worker kind: 'process' spawns real worker processes "
        "streaming over localhost sockets (the throughput tier; each "
        "worker sees no card); 'inproc' pumps the same WorkerCore "
        "cooperatively on the consumer thread — thread-free and "
        "deterministic, what drills and restricted environments use.")

SERVICE_SPLIT_ELEMS = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_SPLIT_ELEMS", default=8, ptype=int,
    doc="Elements per service split (the re-dispatch/recovery unit and "
        "the deterministic-mode reassembly granularity). Larger splits "
        "amortize per-split graph rebuilds; smaller ones bound redone "
        "work after a worker crash.")

SERVICE_MAX_WORKERS = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_MAX_WORKERS", default=4, ptype=int,
    doc="Autoscale ceiling on a session's worker fleet (the Autotuner "
        "widens worker count like a stage depth, never past this).")

SERVICE_RESPAWNS = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_RESPAWNS", default=2, ptype=int,
    doc="How many replacement workers a session may spawn after the "
        "whole fleet has died before giving up with DataServiceError "
        "(single-worker crash recovery re-dispatches to survivors and "
        "does not draw on this budget).")

SERVICE_START_TIMEOUT = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_START_TIMEOUT", default=120.0,
    ptype=float,
    doc="Seconds the consumer will wait for the FIRST element before "
        "declaring the fleet unable to start (worker spawn + import + "
        "connect happens inside this window; once data flows the "
        "deadline no longer applies).")

SERVICE_CHAOS = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_CHAOS", default=None,
    doc="Worker-side fault injection (crash:<elem>|slow:<seconds>), set "
        "by the dispatcher in a spawned worker's environment when a "
        "chaos script targets it — drills and tests only, never by "
        "hand.")

SERVICE_WORKER_LOG = config.register(
    "MMLSPARK_TPU_DATA_SERVICE_WORKER_LOG", default=None,
    doc="Directory for per-worker stderr logs (worker-<k>.log); unset "
        "sends worker stderr to /dev/null. Set when debugging worker "
        "crashes the dispatcher only sees as 'connection lost'.")

from mmlspark_tpu_torch.data.service.dispatcher import (  # noqa: E402
    DataService, DataServiceError, ServiceSession)

__all__ = ["DataService", "DataServiceError", "ServiceSession"]
