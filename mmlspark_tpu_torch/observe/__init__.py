"""Observability (the port of the parts of `mmlspark_tpu/observe/` that
serving needs): the namespaced logger, process counters, pipeline spans,
structured traces with Chrome-trace export, run telemetry with gauges and
histograms, SLO burn rates, per-request waterfalls and the Prometheus
exposition.  Run summaries carry the JAX package's keys."""
