"""Resilience primitives (the port of `mmlspark_tpu/resilience/`): the
injectable clock, the per-endpoint circuit breaker, the retry policy
(`retry`) and the one raw-HTTP seam under it (`net`), the SIGTERM
preemption guard and the step watchdog, the seeded fault injector with
its scenario DSL (`chaos`), and checkpoint rotation with its async
writer (`checkpoints`, `ckpt_writer`)."""
