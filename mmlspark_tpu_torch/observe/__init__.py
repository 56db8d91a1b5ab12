"""Observability (the port of the parts of `mmlspark_tpu/observe/` that
serving and training need): the namespaced logger, process counters,
pipeline spans, structured traces with Chrome-trace export, run telemetry
with gauges and histograms, SLO burn rates, per-request waterfalls, the
Prometheus exposition and the training numerics probes.  Run summaries
carry the JAX package's keys."""
