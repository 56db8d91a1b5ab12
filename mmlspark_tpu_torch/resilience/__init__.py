"""Resilience primitives the serving engine needs (the port of part of
`mmlspark_tpu/resilience/`): the injectable clock, the per-endpoint
circuit breaker, the SIGTERM preemption guard, and the seeded fault
injector with its scenario DSL (`chaos`)."""
