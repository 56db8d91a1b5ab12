"""The one place the port's tiered router departs from the JAX
package's (ROADMAP queue C), pinned from both sides on the CPU: one
script crashes the only prefill replica mid-transfer and restarts it,
through a JAX tiered fleet and a port tiered fleet built by each
package's `build_fleet` from the same seeded weights and configs.
tests/test_torch_handoff.py holds the port's later tokens to a
colocated fleet's.
"""

import numpy as np
import pytest

from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.resilience import chaos as jax_chaos
from mmlspark_tpu.resilience.clock import VirtualClock as JaxVirtualClock
from mmlspark_tpu.serve import RouterConfig as JaxRouterConfig
from mmlspark_tpu.serve import ServeConfig as JaxServeConfig
from mmlspark_tpu.serve import build_fleet as jax_build_fleet
from mmlspark_tpu.serve.admission import Overloaded as JaxOverloaded
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.resilience import chaos
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import RouterConfig, ServeConfig, build_fleet
from mmlspark_tpu_torch.serve.admission import Overloaded

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}
SERVE = dict(max_new_tokens=6, max_batch=2, queue_capacity=8,
             segment_steps=3, default_deadline_s=100.0,
             drain_timeout_s=50.0, cache_chunk=8)
ROUTER = dict(replicas=2, prefill_replicas=1, decode_replicas=1,
              queue_capacity=16, default_deadline_s=100.0,
              drain_timeout_s=50.0, retry_budget_cap=8.0,
              retry_budget_per_s=0.5, eject_failures=3, probe_reset_s=5.0,
              hang_timeout_s=10.0, handoff_pages_per_tick=1, seed=3)


@pytest.fixture(scope="module")
def bundles():
    bundle = ModelBundle.init("TransformerLM", CFG, seed=0)
    return bundle, JaxModelBundle("TransformerLM", CFG, bundle.variables)


def _crash_and_restart(router, clock, fault_mod, overloaded):
    """p0, the only prefill replica, crashes mid-transfer on the first
    request and restarts once it is ejected; the request re-prefills on
    p0's half-open probe.  Then three more prompts are submitted: each
    is served, or refused at submit (its shed reason)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 60, int(n)).astype(np.int32)
               for n in (5, 9, 14, 7)]
    prev = fault_mod.get_injector()
    fault_mod.set_injector(fault_mod.ChaosInjector(script=[
        fault_mod.Fault(kind="prefill_crash_mid_transfer", at_request=1)]))
    p0 = router._by_name["p0"]
    try:
        router.warmup()
        reqs = [router.submit(prompts[0])]
        for _ in range(1200):
            if reqs[0].finished:
                break
            if p0._crashed and p0.breaker.state == "open":
                p0.recover()
            if not router._tick():
                clock.advance(0.05)
        shed = []
        for p in prompts[1:]:
            try:
                reqs.append(router.submit(p))
            except overloaded as e:
                shed.append(e.reason)
        for _ in range(1200):
            if all(r.finished for r in reqs):
                break
            if not router._tick():
                clock.advance(0.05)
    finally:
        fault_mod.set_injector(prev)
    stats = router.stats()
    router.stop()
    return ([(r.status, list(map(int, r.tokens))) for r in reqs], shed,
            stats.get("readmissions", 0), p0.breaker.state)


def test_only_the_port_readmits_a_restarted_prefill_replica(bundles):
    """The port's one departure from the JAX router (ROADMAP queue C),
    pinned from both sides on one script: after p0's crash and restart,
    both fleets serve the re-prefilled request alike through p0's probe;
    the JAX router never resolves that probe and sheds `no_replica`
    from then on, the port re-admits p0 and serves the rest
    (tests/test_torch_handoff.py holds those tokens to a colocated
    fleet's)."""
    bundle, jax_bundle = bundles
    jax_clock = JaxVirtualClock()
    ref = _crash_and_restart(jax_build_fleet(
        jax_bundle, cfg=JaxRouterConfig(**ROUTER),
        serve_cfg=JaxServeConfig(**SERVE), clock=jax_clock), jax_clock,
        jax_chaos, JaxOverloaded)
    clock = VirtualClock()
    got = _crash_and_restart(build_fleet(
        bundle, cfg=RouterConfig(**ROUTER), serve_cfg=ServeConfig(**SERVE),
        clock=clock, device="cpu"), clock, chaos, Overloaded)
    assert ref[0][0][0] == "ok" and got[0][0] == ref[0][0]
    assert ref[1] == ["no_replica"] * 3 and ref[2] == 0, ref
    assert ref[3] != "closed"
    assert got[1] == [] and got[2] == 1 and got[3] == "closed"
    assert [s for s, _ in got[0]] == ["ok"] * 4
