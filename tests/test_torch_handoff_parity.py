"""The tiered fleet in both packages, on the CPU.

One schedule (a burst of prompts, arrivals between ticks, a torn page on
the second transfer) through a JAX tiered fleet and a port tiered fleet,
built by each package's `build_fleet` from the same seeded weights and
configs on their own VirtualClock, gives the same tokens and the same
`handoff` stats: transfers, pages, bytes, splices and retries (the pages
are the same wire bytes).  tests/test_torch_handoff_pages.py moves pages
between the two packages.
"""

import numpy as np
import pytest

from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.resilience import chaos as jax_chaos
from mmlspark_tpu.resilience.clock import VirtualClock as JaxVirtualClock
from mmlspark_tpu.serve import RouterConfig as JaxRouterConfig
from mmlspark_tpu.serve import ServeConfig as JaxServeConfig
from mmlspark_tpu.serve import build_fleet as jax_build_fleet
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.resilience import chaos
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import RouterConfig, ServeConfig, build_fleet

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}
SERVE = dict(max_new_tokens=6, max_batch=2, queue_capacity=8,
             segment_steps=3, default_deadline_s=100.0,
             drain_timeout_s=50.0, cache_chunk=8)
ROUTER = dict(replicas=3, prefill_replicas=2, decode_replicas=1,
              queue_capacity=16, default_deadline_s=100.0,
              drain_timeout_s=50.0, retry_budget_cap=8.0,
              retry_budget_per_s=0.5, eject_failures=3, probe_reset_s=5.0,
              hang_timeout_s=10.0, handoff_pages_per_tick=1, seed=3)
HANDOFF_KEYS = ("transfers", "spliced", "retries", "bytes_sent",
                "pages_sent", "cancelled_at_splice")


@pytest.fixture(scope="module")
def bundles():
    bundle = ModelBundle.init("TransformerLM", CFG, seed=0)
    return bundle, JaxModelBundle("TransformerLM", CFG, bundle.variables)


def _schedule(router, clock, fault_mod):
    """[(status, tokens)] per request and the bus's stats."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 60, int(n)).astype(np.int32)
               for n in rng.integers(3, 9, 6)]
    prev = fault_mod.get_injector()
    fault_mod.set_injector(fault_mod.ChaosInjector(script=[
        fault_mod.Fault(kind="handoff_torn", at_request=2)]))
    try:
        router.warmup()
        reqs = [router.submit(p) for p in prompts[:4]]
        for tick in range(800):
            worked = router._tick()
            if tick == 2:
                reqs += [router.submit(p) for p in prompts[4:]]
            if tick > 2 and all(r.finished for r in reqs):
                break
            if not worked:
                clock.advance(0.05)
    finally:
        fault_mod.set_injector(prev)
    stats = router.stats()
    router.stop()
    return ([(r.status, list(map(int, r.tokens))) for r in reqs],
            {k: stats["handoff"][k] for k in HANDOFF_KEYS},
            stats.get("handoff_retries", 0))


def test_jax_and_port_tiered_fleets_serve_one_schedule_alike(bundles):
    bundle, jax_bundle = bundles
    jax_clock = JaxVirtualClock()
    ref = _schedule(jax_build_fleet(
        jax_bundle, cfg=JaxRouterConfig(**ROUTER),
        serve_cfg=JaxServeConfig(**SERVE), clock=jax_clock), jax_clock,
        jax_chaos)
    clock = VirtualClock()
    got = _schedule(build_fleet(
        bundle, cfg=RouterConfig(**ROUTER), serve_cfg=ServeConfig(**SERVE),
        clock=clock, device="cpu"), clock, chaos)
    assert got == ref
    rows, hand, retries = got
    assert {s for s, _ in rows} == {"ok"} and len(rows) == 6
    assert hand["spliced"] == 6 and hand["retries"] == 1 and retries == 1

