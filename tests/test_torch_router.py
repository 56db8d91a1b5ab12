"""The port's replicated serving fleet (mmlspark_tpu_torch/serve/replica.py
+ router.py) on the CPU: the colocated cases of tests/test_router.py and
the four scenarios of scripts/router_drill.py, all deadline and health
math on a VirtualClock with zero sleeps.

The corruption oracle is the port's offline `DecodeEngine` (which
tests/test_torch_generate.py pins to the JAX engine at f32): a
failed-over request re-prefills from scratch, so failover is scheduling,
never arithmetic, and every completion must equal the offline tokens.
The drill scenarios run through the port's `Scenario` DSL
(resilience/chaos.py) with the drill's own `expect` dicts.
tests/test_torch_router_parity.py serves one schedule through a JAX fleet
and a port fleet.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle
from mmlspark_tpu_torch.observe.telemetry import run_telemetry
from mmlspark_tpu_torch.resilience.chaos import (Fault, Scenario,
                                                 get_injector, run_scenario)
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import (Overloaded, RouterConfig, ServeConfig,
                                      build_fleet)
from mmlspark_tpu_torch.serve.lifecycle import start_http, stop_http

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=0)


@pytest.fixture(scope="module")
def offline(bundle):
    """Greedy tokens of one prompt on its own, per budget."""
    engines: dict = {}

    def decode(prompt, max_new=12):
        eng = engines.get(max_new)
        if eng is None:
            eng = engines[max_new] = DecodeEngine(
                bundle.module("cpu"), max_new, chunk=16, device="cpu")
        b = eng.bucket_for(len(prompt))
        padded = np.zeros((1, b), np.int32)
        padded[0, :len(prompt)] = prompt
        return eng.generate(padded, np.asarray([len(prompt)], np.int32)
                            )[0].tolist()
    return decode


def make_fleet(bundle, clock, n=2, serve_overrides=None, warm=True, **rkw):
    skw = dict(max_new_tokens=12, max_batch=4, queue_capacity=8,
               segment_steps=4, default_deadline_s=100.0,
               drain_timeout_s=50.0, cache_chunk=16)
    skw.update(serve_overrides or {})
    kw = dict(replicas=n, queue_capacity=16, default_deadline_s=100.0,
              drain_timeout_s=50.0, retry_budget_cap=8.0,
              retry_budget_per_s=0.5, eject_failures=3,
              probe_reset_s=5.0, hang_timeout_s=10.0)
    kw.update(rkw)
    router = build_fleet(bundle, cfg=RouterConfig(**kw),
                         serve_cfg=ServeConfig(**skw), clock=clock,
                         device="cpu")
    return router.warmup() if warm else router


def drive(router, clock, reqs, max_ticks=600, advance=0.05):
    """Tick to completion; the virtual clock advances on idle ticks only."""
    for _ in range(max_ticks):
        if all(r.finished for r in reqs):
            return
        if not router._tick():
            clock.advance(advance)
    raise AssertionError(
        f"requests not finished after {max_ticks} ticks: "
        f"{[r.status for r in reqs]}")


def submit_n(router, n, max_new=8, seed=0, deadline_s=None):
    rng = np.random.default_rng(seed)
    return [router.submit(rng.integers(0, 64, (5,)).astype(np.int32),
                          max_new_tokens=max_new, deadline_s=deadline_s)
            for _ in range(n)]


def busy_replica(router):
    reps = sorted(router.replicas, key=lambda r: -r.load_tokens())
    assert reps[0].load_tokens() > 0, "no replica took work"
    return reps[0]


def assert_exact(reqs, offline):
    for r in reqs:
        assert r.tokens == offline(r.prompt, 12)[:r.max_new_tokens]


# ---------------------------------------------------------------------------
# routing, failover, budget, probes, hedging (tests/test_router.py)
# ---------------------------------------------------------------------------

def test_fleet_routes_across_replicas_byte_exact(bundle, offline):
    clock = VirtualClock()
    router = make_fleet(bundle, clock)
    reqs = submit_n(router, 6)
    drive(router, clock, reqs)
    assert [r.status for r in reqs] == ["ok"] * 6
    assert_exact(reqs, offline)
    assert all(rep.routed >= 1 for rep in router.replicas)
    router.stop()
    assert router.state == "stopped"
    assert all(r.engine.state == "stopped" for r in router.replicas)


def test_crash_mid_flight_fails_over_byte_exact(bundle, offline):
    clock = VirtualClock()
    router = make_fleet(bundle, clock)
    reqs = submit_n(router, 6)
    router._tick()
    victim = busy_replica(router)
    victim.inject_crash()
    drive(router, clock, reqs)
    assert [r.status for r in reqs] == ["ok"] * 6
    assert_exact(reqs, offline)
    stats = router.stats()
    assert stats["retries"] >= 1
    assert stats["ejections"] >= 1
    assert victim.breaker.state == "open"
    other = next(r for r in router.replicas if r is not victim)
    assert other.completed_ok >= 1
    router.stop()


def test_hang_ejected_within_window_others_unaffected(bundle, offline):
    clock = VirtualClock()
    router = make_fleet(bundle, clock, hang_timeout_s=2.0)
    reqs = submit_n(router, 6)
    router._tick()
    victim = busy_replica(router)
    victim.inject_hang()
    drive(router, clock, reqs, advance=0.5)
    assert [r.status for r in reqs] == ["ok"] * 6
    assert_exact(reqs, offline)
    assert router.stats()["ejections"] >= 1
    assert victim.breaker.state == "open"
    router.stop()


def test_retry_budget_exhaustion_sheds_never_loops(bundle):
    clock = VirtualClock()
    router = make_fleet(bundle, clock, retry_budget_cap=0.0,
                        retry_budget_per_s=0.0)
    reqs = submit_n(router, 6)
    router._tick()
    busy_replica(router).inject_crash()
    drive(router, clock, reqs)
    shed = [r for r in reqs if r.status == "shed"]
    assert shed, [r.status for r in reqs]
    for r in shed:
        assert len(r.attempts) == 1
        assert r.retry_after_s > 0
    assert router.stats()["shed_retry_budget"] == len(shed)
    assert router.stats().get("retries", 0) == 0
    router.stop()


def test_recovered_replica_readmitted_via_probe(bundle, offline):
    clock = VirtualClock()
    router = make_fleet(bundle, clock, probe_reset_s=5.0)
    reqs = submit_n(router, 6)
    router._tick()
    victim = busy_replica(router)
    victim.inject_crash()
    drive(router, clock, reqs)
    assert victim.breaker.state == "open"
    clock.advance(6.0)
    probe_req = submit_n(router, 1, seed=7)[0]
    drive(router, clock, [probe_req])
    assert probe_req.status == "ok"
    assert victim.breaker.state == "open"
    victim.recover()
    clock.advance(6.0)
    late = submit_n(router, 4, seed=8)
    drive(router, clock, late)
    assert [r.status for r in late] == ["ok"] * 4
    assert_exact(late, offline)
    stats = router.stats()
    assert stats["probes"] >= 1 and stats["readmissions"] >= 1
    assert victim.breaker.state == "closed"
    router.stop()


def test_hedge_launches_second_attempt_near_deadline(bundle, offline):
    clock = VirtualClock()
    router = make_fleet(bundle, clock, hedge_fraction=100.0)
    router.estimator.observe_prefill(8, 1.0)
    router.estimator.observe_step(8, 1.0)
    req = submit_n(router, 1, deadline_s=100.0)[0]
    drive(router, clock, [req])
    assert req.status == "ok"
    assert_exact([req], offline)
    assert req.hedged and len(req.attempts) == 2
    assert {name for name, _ in req.attempts} == {"r0", "r1"}
    assert router.stats()["hedges"] == 1
    # the losing attempt was withdrawn without breaker evidence
    loser = next(a for _, a in req.attempts if a.status != "ok")
    assert loser.status == "cancelled"
    assert all(r.breaker.state == "closed" for r in router.replicas)
    router.stop()


def test_stats_carry_per_replica_health_sections(bundle):
    clock = VirtualClock()
    router = make_fleet(bundle, clock)
    reqs = submit_n(router, 4, max_new=12)
    rows = []
    for _ in range(6):
        router._tick()
        stats = router.stats()
        rows = [row for h in stats["replicas"].values()
                for row in h["in_flight_rows"]]
        if rows:
            break
    assert set(stats["replicas"]) == {"r0", "r1"}
    for health in stats["replicas"].values():
        assert {"state", "routable", "breaker", "miss_ewma", "in_flight",
                "queued", "in_flight_rows", "routed", "completed_ok",
                "load_tokens", "role"} <= set(health)
        assert health["breaker"]["state"] == "closed"
        assert health["role"] == "colocated"
    assert rows and {"request", "bucket", "tokens", "deadline_in_s"} \
        <= set(rows[0])
    drive(router, clock, reqs)
    router.stop()


def test_routing_timeline_in_run_summary(bundle, tmp_path):
    clock = VirtualClock()
    with run_telemetry(str(tmp_path)) as rt:
        router = make_fleet(bundle, clock)
        reqs = submit_n(router, 6)
        router._tick()
        busy_replica(router).inject_crash()
        drive(router, clock, reqs)
        router.stop()
        summary = rt.summary()
    assert [r.status for r in reqs] == ["ok"] * 6
    events = [e["event"] for e in summary["routing"]]
    for expected in ("ready", "admit", "dispatch", "eject", "failover",
                     "finish", "drain_start", "drain_end"):
        assert expected in events, (expected, events)
    assert events.index("ready") < events.index("dispatch")
    assert events.index("eject") < events.index("drain_start")
    assert summary["slo"]["endpoints"]["interactive"]["requests"] >= 6
    assert summary["gauges"]["serve.router.in_flight"]["n"] >= 1
    with open(tmp_path / "run_summary.json") as f:
        assert json.load(f)["routing"] == summary["routing"]


def test_prefix_affinity_concentrates_shared_prefixes(bundle, offline):
    """Requests sharing a first cache chunk land on one replica, whose
    pool then serves the later ones; an ejected target falls back to
    power-of-two-choices."""
    clock = VirtualClock()
    router = make_fleet(bundle, clock, prefix_affinity=True,
                        serve_overrides={"prefix_cache": True})
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 64, 32).astype(np.int32)

    def shared(n):
        return [router.submit(np.concatenate(
            [prefix, rng.integers(0, 64, 4).astype(np.int32)]),
            max_new_tokens=8) for _ in range(n)]

    first = shared(1)
    drive(router, clock, first)
    later = shared(3)
    drive(router, clock, later)
    assert [r.status for r in first + later] == ["ok"] * 4
    assert_exact(first + later, offline)
    names = {r.attempts[-1][0] for r in first + later}
    assert len(names) == 1
    stats = router.stats()
    assert stats["affinity_routes"] == 4
    target = router._by_name[names.pop()]
    assert stats["replicas"][target.name]["prefix"]["hits"] == 3
    target.inject_crash()
    router._tick()
    moved = shared(1)
    drive(router, clock, moved)
    assert moved[0].status == "ok" and moved[0].attempts[-1][0] != \
        target.name
    assert router.stats()["affinity_fallback"] >= 1
    router.stop()


def test_chunked_prefill_fleet_fails_over_mid_chunk(bundle, offline):
    """A replica that crashes with a chunked prefill in flight fails the
    cohort over: the pending job is dropped with its reserved slots and
    the retry re-prefills byte-exact elsewhere."""
    clock = VirtualClock()
    router = make_fleet(bundle, clock,
                        serve_overrides={"prefill_chunk": 8})
    rng = np.random.default_rng(6)
    reqs = [router.submit(rng.integers(0, 64, 30).astype(np.int32),
                          max_new_tokens=8) for _ in range(3)]
    router._tick()                      # dispatched; chunk 0 ran
    victim = next(r for r in router.replicas if r.engine._pending)
    assert victim.engine.in_flight() >= 1
    victim.inject_crash()
    assert victim.engine._pending == [] and victim.engine.in_flight() == 0
    drive(router, clock, reqs)
    assert [r.status for r in reqs] == ["ok"] * 3
    assert_exact(reqs, offline)
    assert router.stats()["retries"] >= 1
    router.stop()


def test_tiered_config_raises_naming_the_handoff_step(bundle):
    """Tiered configs and both roles now CONSTRUCT (the handoff is
    ported; no NotImplementedError is left to name).  What still raises
    is the JAX package's ValueErrors: an empty tier, a speculating
    prefill tier, an unknown role, an empty fleet."""
    for kw in ({"prefill_replicas": 1, "decode_replicas": 1},
               {"prefill_replicas": 2, "decode_replicas": 3}):
        cfg = RouterConfig(replicas=2, **kw)
        assert (cfg.prefill_replicas, cfg.decode_replicas) == (
            kw["prefill_replicas"], kw["decode_replicas"])
    with pytest.raises(ValueError, match="BOTH"):
        RouterConfig(replicas=2, prefill_replicas=1, decode_replicas=0)
    for role in ("prefill", "decode"):
        assert ServeConfig(role=role).role == role
    with pytest.raises(ValueError, match="spec"):
        ServeConfig(role="prefill", spec_tokens=3)
    with pytest.raises(ValueError):
        ServeConfig(role="nonsense")
    with pytest.raises(ValueError, match="at least one replica"):
        from mmlspark_tpu_torch.serve import Router
        Router([])


# ---------------------------------------------------------------------------
# HTTP front end over a router (real socket, real clock)
# ---------------------------------------------------------------------------

def test_http_router_statz_and_streaming(bundle, offline):
    router = make_fleet(bundle, None, serve_overrides={"prefix_cache": True},
                        prefix_affinity=True)
    server = start_http(router, port=0)
    port = server.server_address[1]
    stop_ticking = threading.Event()

    def ticker():
        while not stop_ticking.is_set():
            time.sleep(0.03 if router._tick() else 0.005)

    tick_thread = threading.Thread(target=ticker, daemon=True)
    tick_thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read().decode())
        assert resp.status == 200 and health["state"] == "ready"
        prompt = np.random.default_rng(3).integers(
            0, 64, (20,)).astype(np.int32)
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt.tolist(),
                                 "max_new_tokens": 12, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        streamed, chunks, final = [], 0, None
        while True:
            line = resp.readline()
            if not line:
                break
            payload = json.loads(line.decode())
            if payload.get("restart"):
                streamed = []
            elif "tokens" in payload and not payload.get("done"):
                chunks += 1
                streamed.extend(payload["tokens"])
            if payload.get("done"):
                final = payload
                break
        conn.close()
        assert final is not None and final["status"] == "ok"
        assert chunks >= 2
        assert streamed == final["tokens"] == offline(prompt, 12)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt.tolist(),
                                 "max_new_tokens": 12}))
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        assert resp.status == 200 and body["tokens"] == final["tokens"]
        conn.request("GET", "/statz")
        resp = conn.getresponse()
        stats = json.loads(resp.read().decode())
        conn.close()
        assert resp.status == 200
        assert set(stats["replicas"]) == {"r0", "r1"}
        for health in stats["replicas"].values():
            assert health["breaker"]["state"] == "closed"
            assert "prefix" in health
        assert stats["affinity_routes"] == 2
        assert stats.get("affinity_fallback", 0) == 0
        assert sum(h["prefix"]["hits"]
                   for h in stats["replicas"].values()) == 1
    finally:
        stop_http(server)
        stop_ticking.set()
        tick_thread.join(timeout=5)
        router.stop()


# ---------------------------------------------------------------------------
# the router drill's four scenarios (scripts/router_drill.py) on the port
# ---------------------------------------------------------------------------

def drive_fleet(router, clock, prompts, max_new, deadline_s, offline, *,
                inter_arrival_s=0.0, submit_ticks=1, max_ticks=4000):
    """The drill's workload runner: submit in order, acting out the
    injector's replica faults before each request, tick to completion
    (the clock advancing only when idle), drain; the observation dict."""
    router.warmup()
    injector = get_injector()
    recoveries, routed_at_recovery = [], {}
    requests, shed_admission = [], 0

    def run_recoveries():
        for rep, due in list(recoveries):
            if router.now() >= due:
                rep.recover()
                routed_at_recovery.setdefault(rep.name, rep.routed)
                recoveries.remove((rep, due))

    for i, prompt in enumerate(prompts, 1):
        for fault in injector.replica_faults_due(i):
            rep = router.replicas[fault.replica]
            if fault.kind == "replica_crash":
                rep.inject_crash()
            elif fault.kind == "replica_hang":
                rep.inject_hang()
                if fault.seconds > 0:
                    recoveries.append((rep, router.now() + fault.seconds))
            elif fault.kind == "replica_flap":
                rep.inject_crash()
                recoveries.append((rep, router.now() + fault.seconds))
            elif fault.kind == "replica_slow":
                rep.inject_slow(fault.factor)
        try:
            requests.append(router.submit(prompt, max_new_tokens=max_new,
                                          deadline_s=deadline_s))
        except Overloaded:
            shed_admission += 1
        for _ in range(submit_ticks):
            router._tick()
        if inter_arrival_s > 0:
            clock.advance(inter_arrival_s)
            run_recoveries()
    ticks = 0
    while not all(r.finished for r in requests) and ticks < max_ticks:
        run_recoveries()
        if not router._tick():
            clock.advance(0.25)
        ticks += 1
    router.begin_drain("drill")
    for _ in range(400):
        if router.state == "stopped":
            break
        if not router._tick():
            clock.advance(1.0)
    ok = [r for r in requests if r.status == "ok"]
    exact = sum(r.tokens == offline(r.prompt, max_new) for r in ok)
    shed_rrs = [r for r in requests if r.status == "shed"]
    stats = router.stats()
    obs = {
        "submitted": len(prompts), "admitted": len(requests),
        "shed_admission": shed_admission, "ok": len(ok),
        "timeout": sum(r.status == "timeout" for r in requests),
        "cancelled": sum(r.status == "cancelled" for r in requests),
        "error": sum(r.status == "error" for r in requests),
        "shed_budget": len(shed_rrs),
        "shed_with_hint": all(r.retry_after_s > 0 for r in shed_rrs),
        "unfinished": sum(not r.finished for r in requests),
        "exact": exact, "corrupt": len(ok) - exact,
        "retries": stats.get("retries", 0),
        "ejections": stats.get("ejections", 0),
        "readmissions": stats.get("readmissions", 0),
        "probes": stats.get("probes", 0),
        "drained": router.state == "stopped"}
    for name, at_recovery in routed_at_recovery.items():
        obs[f"{name}_routed_after_recovery"] = \
            stats["replicas"][name]["routed"] - at_recovery
    for rep in router.replicas:
        obs[f"{rep.name}_breaker"] = rep.breaker.state
        obs[f"{rep.name}_completed"] = rep.completed_ok
    return obs


def prompts_for(seed, n, length=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (length,)).astype(np.int32)
            for _ in range(n)]


def drill_fleet(bundle, clock, serve_overrides=None, **router_kw):
    """The drill's fleet (scripts/router_drill.py make_fleet)."""
    skw = dict(max_new_tokens=12, max_batch=4, queue_capacity=8,
               segment_steps=4, default_deadline_s=60.0,
               drain_timeout_s=30.0, cache_chunk=16)
    skw.update(serve_overrides or {})
    rkw = dict(replicas=2, queue_capacity=32, default_deadline_s=60.0,
               drain_timeout_s=30.0, retry_budget_cap=8.0,
               retry_budget_per_s=1.0, eject_failures=3,
               probe_reset_s=5.0, hang_timeout_s=5.0)
    rkw.update(router_kw)
    return build_fleet(bundle, cfg=RouterConfig(**rkw),
                       serve_cfg=ServeConfig(**skw), clock=clock,
                       device="cpu")


# (scenario, faults, expect, fleet overrides, prompts, drive kwargs): the
# drill's own scripts and expectations, unchanged
DRILLS = {
    "replica_crash": (
        [Fault(kind="replica_crash", at_request=5, replica=0)],
        {"ok": 8, "error": 0, "cancelled": 0, "timeout": 0,
         "shed_budget": 0, "corrupt": 0, "unfinished": 0,
         "min_retries": 1, "min_ejections": 1, "drained": True},
        {}, (10, 8), dict(max_new=8)),
    "replica_hang": (
        [Fault(kind="replica_hang", at_request=3, replica=0, seconds=0.0)],
        {"ok": 8, "error": 0, "cancelled": 0, "shed_budget": 0,
         "corrupt": 0, "unfinished": 0, "min_ejections": 1,
         "min_r1_completed": 4, "drained": True},
        {"hang_timeout_s": 5.0}, (11, 8), dict(max_new=8)),
    "fleet_overload": (
        [Fault(kind="replica_crash", at_request=10, replica=0)],
        {"error": 0, "cancelled": 0, "timeout": 0, "corrupt": 0,
         "unfinished": 0, "max_retries": 1, "min_shed_budget": 1,
         "shed_with_hint": True, "min_ejections": 1, "drained": True},
        {"retry_budget_cap": 1.0, "retry_budget_per_s": 0.0,
         "serve_overrides": {"max_batch": 1, "queue_capacity": 8,
                             "max_new_tokens": 16}},
        (12, 12), dict(max_new=16)),
    "replica_flap": (
        [Fault(kind="replica_flap", at_request=4, replica=0, seconds=3.0)],
        {"error": 0, "cancelled": 0, "corrupt": 0, "unfinished": 0,
         "min_ejections": 1, "min_probes": 1, "min_readmissions": 1,
         "r0_breaker": "closed", "min_r0_routed_after_recovery": 2,
         "drained": True},
        {"probe_reset_s": 1.0}, (13, 16),
        dict(max_new=8, inter_arrival_s=0.5)),
}


@pytest.fixture(scope="module")
def drill_reports(bundle, offline):
    """Every scenario inside one telemetry run, as the drill runs them;
    (reports by name, the run summary)."""
    reports = {}
    with run_telemetry(None) as rt:
        for name, (faults, expect, fleet_kw, (seed, n), drive_kw) in \
                DRILLS.items():
            def run(fleet_kw=fleet_kw, seed=seed, n=n, drive_kw=drive_kw):
                clock = VirtualClock()
                router = drill_fleet(bundle, clock, **fleet_kw)
                kw = dict(drive_kw)
                max_new = kw.pop("max_new")
                return drive_fleet(router, clock, prompts_for(seed, n),
                                   max_new, 60.0, offline, **kw)
            reports[name] = run_scenario(
                Scenario(name, faults=faults, expect=expect), run)
        summary = rt.summary()
    return reports, summary


@pytest.mark.parametrize("name", list(DRILLS))
def test_router_drill_scenario(drill_reports, name):
    report = drill_reports[0][name]
    failed = {k: c for k, c in report["checks"].items() if not c["ok"]}
    assert report["passed"], (failed, report["observed"])
    assert report["observed"]["corrupt"] == 0
    assert report["observed"]["exact"] == report["observed"]["ok"] > 0


def test_router_drill_timeline(drill_reports):
    """The drill's timeline check: the decision events, ejection before
    re-admission."""
    events = [e.get("event") for e in drill_reports[1]["routing"]]
    for want in ("ready", "dispatch", "eject", "failover", "readmit",
                 "drain_start", "drain_end"):
        assert want in events, want
    assert events.index("eject") < events.index("readmit")
