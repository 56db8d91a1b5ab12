"""One schedule served by a JAX fleet and a port fleet on the CPU.

Both fleets are built by their package's `build_fleet` from the same
seeded weights and configs, with the same router seed, on their own
VirtualClock.  The schedule: a burst, arrivals between ticks, a crash of
the replica holding the most work, a failover.  Power-of-two-choices
draws from `random.Random(seed)` and compares each replica's
`load_tokens` (resident plus queued tokens), so the port must count the
same load at every tick to route alike.  Required: the same replicas for
every request's attempts, the same load at every tick, equal statuses
and equal tokens.
"""

import numpy as np

from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.resilience.clock import VirtualClock as JaxVirtualClock
from mmlspark_tpu.serve import RouterConfig as JaxRouterConfig
from mmlspark_tpu.serve import ServeConfig as JaxServeConfig
from mmlspark_tpu.serve import build_fleet as jax_build_fleet
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import RouterConfig, ServeConfig, build_fleet

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}
SERVE = dict(max_new_tokens=8, max_batch=2, queue_capacity=8,
             segment_steps=4, default_deadline_s=100.0,
             drain_timeout_s=50.0, cache_chunk=16)
ROUTER = dict(replicas=2, queue_capacity=16, default_deadline_s=100.0,
              drain_timeout_s=50.0, retry_budget_cap=8.0,
              retry_budget_per_s=0.5, eject_failures=3, probe_reset_s=5.0,
              hang_timeout_s=10.0, seed=3)


def _schedule(router, clock):
    """[(status, tokens, replicas of its attempts)] per request, and the
    per-tick load of each replica."""
    rng = np.random.default_rng(4)

    def submit(n):
        return [router.submit(rng.integers(0, 64, int(rng.integers(2, 9)))
                              .astype(np.int32),
                              max_new_tokens=int(rng.integers(3, 9)))
                for _ in range(n)]

    router.warmup()
    reqs, loads = submit(5), []
    for tick in range(400):
        worked = router._tick()
        loads.append([r.load_tokens() for r in router.replicas])
        if tick in (1, 3):
            reqs += submit(2)
        if tick == 2:
            max(router.replicas, key=lambda r: r.load_tokens()).crash()
        if tick > 3 and all(r.finished for r in reqs):
            break
        if not worked:
            clock.advance(0.05)
    router.stop()
    return [(r.status, list(map(int, r.tokens)),
             [name for name, _ in r.attempts]) for r in reqs], loads


def test_jax_and_port_fleets_route_one_schedule_alike():
    bundle = ModelBundle.init("TransformerLM", CFG, seed=0)
    jax_clock = JaxVirtualClock()
    ref = _schedule(jax_build_fleet(
        JaxModelBundle("TransformerLM", CFG, bundle.variables),
        cfg=JaxRouterConfig(**ROUTER), serve_cfg=JaxServeConfig(**SERVE),
        clock=jax_clock), jax_clock)
    clock = VirtualClock()
    got = _schedule(build_fleet(
        bundle, cfg=RouterConfig(**ROUTER), serve_cfg=ServeConfig(**SERVE),
        clock=clock, device="cpu"), clock)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    rows = got[0]
    assert {s for s, _, _ in rows} == {"ok"}
    assert len(rows) == 9
    assert any(len(names) == 2 for _, _, names in rows)   # a failover
    assert {names[0] for _, _, names in rows} == {"r0", "r1"}
