"""Observability (the port of `mmlspark_tpu/observe/`): the namespaced
logger, process counters, pipeline spans, stage timers, structured traces
with Chrome-trace export, run telemetry with gauges and histograms, SLO
burn rates, per-request waterfalls, the Prometheus exposition, the
training numerics probes, device profiling, and the analytics that
interpret them: per-program cost counting with roofline attribution
(costmodel.py), the run-report diagnostic (report.py) and the persistent
bench-history regression store (history.py).  Run summaries carry the
JAX package's keys."""

from mmlspark_tpu_torch._lazy import lazy_exports
from mmlspark_tpu_torch.observe.telemetry import (RunTelemetry, active_run,
                                                  run_telemetry)
from mmlspark_tpu_torch.observe.timing import (StageTimings,
                                               instrument_stage_method,
                                               stage_timing)

__all__ = ["CostCounter", "costmodel_enabled", "roofline", "annotate",
           "profile", "RunTelemetry", "active_run", "run_telemetry",
           "StageTimings", "instrument_stage_method", "stage_timing"]

# costmodel and profiler import torch: resolved on first use (`_lazy.py`)
__getattr__, __dir__ = lazy_exports(__name__, {
    **dict.fromkeys(("CostCounter", "costmodel_enabled", "roofline"),
                    "mmlspark_tpu_torch.observe.costmodel"),
    **dict.fromkeys(("annotate", "profile"),
                    "mmlspark_tpu_torch.observe.profiler")})
