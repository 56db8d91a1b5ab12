"""Resilience primitives the serving engine needs (the port of part of
`mmlspark_tpu/resilience/`): the injectable clock, the per-endpoint
circuit breaker and the SIGTERM preemption guard."""
