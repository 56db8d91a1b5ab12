"""The port's disaggregated tiers (serve/handoff.py + the tiered Router) on
the CPU: the disagg cases of tests/test_router.py on port fleets, the
prefill tier's refusal of the prefix pool (tests/test_prefix_cache.py),
the tiered HTTP surface, and the handoff-retry waterfall
(tests/test_tracing.py), live and from the JAX test's records.

The corruption oracle is a colocated port fleet of the same config (and,
through it, the offline engine that tests/test_torch_router.py pins it
to): a handed-off row decodes from the exact cache rows prefill wrote, so
tiers are transport, never arithmetic.  Faults are installed as a chaos
script before the fleet runs; the bus reads them through
`get_injector()`.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.observe.assemble import assemble
from mmlspark_tpu_torch.observe.export import prometheus_text
from mmlspark_tpu_torch.observe.telemetry import run_telemetry
from mmlspark_tpu_torch.observe.trace import new_trace_id
from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                 get_injector, set_injector)
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.serve import RouterConfig, ServeConfig, build_fleet
from mmlspark_tpu_torch.serve.lifecycle import start_http, stop_http

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=0)


def make_fleet(bundle, clock, n=2, serve_overrides=None, **rkw):
    skw = dict(max_new_tokens=12, max_batch=4, queue_capacity=8,
               segment_steps=4, default_deadline_s=100.0,
               drain_timeout_s=50.0, cache_chunk=16)
    skw.update(serve_overrides or {})
    kw = dict(replicas=n, queue_capacity=16, default_deadline_s=100.0,
              drain_timeout_s=50.0, retry_budget_cap=8.0,
              retry_budget_per_s=0.5, eject_failures=3,
              probe_reset_s=5.0, hang_timeout_s=10.0)
    kw.update(rkw)
    if kw.get("prefill_replicas"):
        kw["replicas"] = kw["prefill_replicas"] + kw["decode_replicas"]
    return build_fleet(bundle, cfg=RouterConfig(**kw),
                       serve_cfg=ServeConfig(**skw), clock=clock,
                       device="cpu").warmup()


def drive(router, clock, reqs, max_ticks=1200, advance=0.05):
    """Tick to completion; the virtual clock advances on idle ticks only."""
    for _ in range(max_ticks):
        if all(r.finished for r in reqs):
            return
        if not router._tick():
            clock.advance(advance)
    raise AssertionError(
        f"requests not finished after {max_ticks} ticks: "
        f"{[r.status for r in reqs]}")


def submit_n(router, n, max_new=8, seed=0):
    rng = np.random.default_rng(seed)
    return [router.submit(rng.integers(0, 64, (5,)).astype(np.int32),
                          max_new_tokens=max_new) for _ in range(n)]


def _grid_prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 60, size=n).astype(np.int32)
            for n in (5, 9, 14, 7)]


def _run_prompts(bundle, prompts, serve_overrides=None, faults=None,
                 deadline_s=None, **rkw):
    """One fleet, one workload: [(status, tokens)] per request plus the
    router, stopped, for post-mortem assertions."""
    clock = VirtualClock()
    prev = get_injector()
    set_injector(ChaosInjector(script=faults) if faults else None)
    try:
        router = make_fleet(bundle, clock, serve_overrides=serve_overrides,
                            **rkw)
        reqs = [router.submit(p, deadline_s=deadline_s) for p in prompts]
        drive(router, clock, reqs)
    finally:
        set_injector(prev)
    router.stop()
    return [(r.status, tuple(r.tokens)) for r in reqs], router


@pytest.mark.parametrize("cache_dtype", ["model", "int8"])
@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_disagg_byte_exact_grid(bundle, cache_dtype, prefill_chunk):
    """Colocated and tiered fleets give IDENTICAL greedy outputs across
    {model dtype, int8 cache} x {whole, chunked prefill} x {clean,
    prefill crash mid-transfer}: the handoff moves bits, it never changes
    them, even when the transfer has to re-prefill."""
    prompts = _grid_prompts()
    over = {"cache_dtype": cache_dtype, "prefill_chunk": prefill_chunk,
            "cache_chunk": 8}
    ref, _ = _run_prompts(bundle, prompts, serve_overrides=over)
    assert all(s == "ok" for s, _ in ref)

    got, router = _run_prompts(bundle, prompts, serve_overrides=over,
                               prefill_replicas=2, decode_replicas=1)
    assert got == ref
    hs = router.stats()["handoff"]
    assert hs["spliced"] == len(prompts) and hs["retries"] == 0
    if cache_dtype == "int8":
        # int8 rows ship fewer bytes than the model dtype would
        assert hs["bytes_sent"] < 26000

    crashed, router = _run_prompts(
        bundle, prompts, serve_overrides=over,
        prefill_replicas=2, decode_replicas=1, handoff_pages_per_tick=1,
        faults=[Fault(kind="prefill_crash_mid_transfer", at_request=2)])
    assert crashed == ref
    st = router.stats()
    assert st.get("handoff_retries", 0) >= 1
    assert st.get("ejections", 0) >= 1


def test_disagg_torn_and_stalled_handoffs_reprefill_byte_exact(bundle):
    prompts = _grid_prompts(seed=5)
    over = {"cache_chunk": 8}
    ref, _ = _run_prompts(bundle, prompts, serve_overrides=over)
    for fault in (Fault(kind="handoff_torn", at_request=2),
                  Fault(kind="handoff_stall", at_request=2, seconds=30.0)):
        got, router = _run_prompts(
            bundle, prompts, serve_overrides=over, prefill_replicas=2,
            decode_replicas=1, handoff_pages_per_tick=1, faults=[fault])
        assert got == ref, fault.kind
        assert router.stats().get("handoff_retries", 0) >= 1, fault.kind
        assert router.stats()["handoff"]["retries"] >= 1


def test_cancel_at_splice_lands_cancel_event_refunds_nothing(bundle,
                                                             tmp_path):
    """A request whose deadline expires while its KV pages are in flight
    is cancelled AT SPLICE: `serve.route.cancel` lands in the routing
    timeline and the retry budget is untouched."""
    clock = VirtualClock()
    set_injector(ChaosInjector(script=[
        Fault(kind="handoff_stall", at_request=1, seconds=5.0)]))
    try:
        with run_telemetry(str(tmp_path)) as rt:
            router = make_fleet(bundle, clock, prefill_replicas=1,
                                decode_replicas=1, handoff_timeout_s=60.0,
                                serve_overrides={"cache_chunk": 8})
            rr = router.submit(_grid_prompts()[0], deadline_s=2.0)
            for _ in range(1200):
                if rr.finished:
                    break
                if not router._tick():
                    clock.advance(0.05)
            summary = rt.summary()
    finally:
        set_injector(None)
    assert rr.status == "timeout"
    assert "splice" in rr.detail
    cancels = [e for e in summary["routing"] if e["event"] == "cancel"]
    assert cancels and cancels[0]["reason"] == "deadline_at_splice"
    assert router.budget.spent == 0
    assert router.stats()["handoff"]["cancelled_at_splice"] == 1
    handoff_events = [e["event"] for e in summary["handoff"]]
    assert "begin" in handoff_events
    assert "cancel_at_splice" in handoff_events
    router.stop()


def test_disagg_statz_tiers_and_prometheus_gauges(bundle, tmp_path):
    """router.stats() grows per-tier sections and the run exports the
    mmlspark_tpu_handoff_{bytes,inflight,retries} gauges; the decode
    tier's estimator sees no prefill and the prefill tier no segment."""
    clock = VirtualClock()
    with run_telemetry(str(tmp_path)) as rt:
        router = make_fleet(bundle, clock, prefill_replicas=2,
                            decode_replicas=1)
        reqs = submit_n(router, 4)
        drive(router, clock, reqs)
        stats = router.stats()
        text = prometheus_text(rt)
        router.stop()
    assert [r.status for r in reqs] == ["ok"] * 4
    tiers = stats["tiers"]
    assert tiers["prefill"]["replicas"] == ["p0", "p1"]
    assert tiers["decode"]["replicas"] == ["d0"]
    for key in ("routable", "queued", "in_flight", "load_tokens"):
        assert key in tiers["prefill"] and key in tiers["decode"]
    assert stats["handoff"]["spliced"] == 4
    assert stats["replicas"]["p0"]["role"] == "prefill"
    assert stats["replicas"]["d0"]["role"] == "decode"
    for metric in ("mmlspark_tpu_handoff_bytes",
                   "mmlspark_tpu_handoff_inflight",
                   "mmlspark_tpu_handoff_retries"):
        assert metric in text, metric
    # tier breakers get their own keying in the registry exposition
    assert 'serve.prefill.p0' in text and 'serve.decode.d0' in text
    d0 = router._by_name["d0"].engine
    assert d0._counts.get("remote_joins") == 4
    assert d0.estimator.snapshot()["prefill_s"] == {}
    assert sum(rep.engine._counts.get("handoffs", 0)
               for rep in router._prefill_reps) == 4
    assert all(rep.engine.estimator.snapshot()["step_s"] == {}
               for rep in router._prefill_reps)
    assert router.estimator.snapshot()["handoff_s"]


def test_prefill_replica_drain_finishes_transfers(bundle, tmp_path):
    """SIGTERM on one prefill replica: it finishes its in-flight prefills
    AND KV transfers, then stops — zero dropped decodes, the rest of the
    tier keeps serving."""
    clock = VirtualClock()
    with run_telemetry(str(tmp_path)) as rt:
        router = make_fleet(bundle, clock, prefill_replicas=2,
                            decode_replicas=1,
                            serve_overrides={"cache_chunk": 8})
        reqs = submit_n(router, 6)
        router._tick()
        router._by_name["p0"].begin_drain("sigterm")
        drive(router, clock, reqs)
        for _ in range(200):
            if router._by_name["p0"].engine.state == "stopped":
                break
            if not router._tick():
                clock.advance(0.05)
        summary = rt.summary()
        router.stop()
    assert [r.status for r in reqs] == ["ok"] * 6
    assert router._by_name["p0"].engine.state == "stopped"
    drained = [e for e in summary["routing"]
               if e["event"] == "replica_drained"]
    assert drained and drained[0]["replica"] == "p0"
    assert router.stats()["replicas"]["p1"]["role"] == "prefill"


@pytest.mark.parametrize("cache_dtype", ["model", "int8"])
def test_bus_pages_are_made_on_demand(bundle, cache_dtype):
    """The bus frames a row's pages one at a time (`CacheRowPages`, one
    host copy a page; tests/test_torch_serve_hooks.py holds their bytes
    to the JAX package's): the byte total is known before any page is
    made, and the pages reassemble to the row bit for bit."""
    from mmlspark_tpu_torch.models import DecodeEngine
    from mmlspark_tpu_torch.models.generate import (CacheRowPages,
                                                    deserialize_cache_row)
    eng = DecodeEngine(bundle.module("cpu"), 4, chunk=8,
                       cache_dtype=cache_dtype, device="cpu")
    prompts = np.zeros((2, 16), np.int64)
    prompts[:, :11] = np.random.default_rng(2).integers(1, 60, (2, 11))
    _, _, caches = eng.serve_prefill(prompts, [11, 9], np.ones(2, bool),
                                     [0, 1])
    for row in (0, 1):
        pages = CacheRowPages(caches, row, 8)
        assert len(pages) == caches[0][0].shape[1] // 8
        total = pages.nbytes()
        made = [pages[i] for i in range(len(pages))]
        assert total == sum(map(len, made))
        with pytest.raises(IndexError):
            pages[len(pages)]
        for got, layer in zip(deserialize_cache_row(made), caches):
            for g, t in zip(got, layer):
                assert g.dtype == t.dtype
                assert torch.equal(g[0], t[row])


def test_restarted_prefill_replica_is_readmitted_by_its_probe(bundle,
                                                             tmp_path):
    """The port's one departure from the JAX router (ROADMAP queue C):
    p0, the only prefill replica, crashes mid-transfer and restarts; its
    half-open probe hands its row off, so p0 is re-admitted and later
    requests are served exactly.  The JAX router leaves that probe open
    and sheds `no_replica` from then on
    (tests/test_torch_handoff_probe.py pins that side)."""
    prompts = _grid_prompts(seed=7)
    over = {"cache_chunk": 8}
    ref, _ = _run_prompts(bundle, prompts, serve_overrides=over)
    clock = VirtualClock()
    set_injector(ChaosInjector(script=[
        Fault(kind="prefill_crash_mid_transfer", at_request=1)]))
    try:
        with run_telemetry(str(tmp_path)) as rt:
            router = make_fleet(bundle, clock, prefill_replicas=1,
                                decode_replicas=1, handoff_pages_per_tick=1,
                                serve_overrides=over)
            p0 = router._by_name["p0"]
            first = router.submit(prompts[0])
            restarts = 0
            for _ in range(1200):
                if first.finished:
                    break
                if p0._crashed and p0.breaker.state == "open":
                    p0.recover()         # restarts once it is ejected
                    restarts += 1
                if not router._tick():
                    clock.advance(0.05)
            late = [router.submit(p) for p in prompts[1:]]
            drive(router, clock, late)
            summary = rt.summary()
    finally:
        set_injector(None)
    router.stop()
    assert restarts == 1
    events = [e["event"] for e in summary["routing"]
              if e.get("replica") == "p0"]
    assert "eject" in events and "readmit" in events
    assert events.index("eject") < events.index("readmit")
    assert p0.breaker.state == "closed" and p0.probe is None
    stats = router.stats()
    assert stats["readmissions"] == 1 and stats["handoff_retries"] == 1
    assert [(r.status, tuple(r.tokens)) for r in [first] + late] == ref


def test_tiered_config_validation(bundle):
    with pytest.raises(ValueError, match="BOTH"):
        RouterConfig(replicas=2, prefill_replicas=1, decode_replicas=0)
    with pytest.raises(ValueError, match="spec"):
        ServeConfig(role="prefill", spec_tokens=3)
    with pytest.raises(ValueError):
        ServeConfig(role="nonsense")
    with pytest.raises(ValueError, match="handoff_pages_per_tick"):
        RouterConfig(replicas=2, prefill_replicas=1, decode_replicas=1,
                     handoff_pages_per_tick=0)
    router = make_fleet(bundle, VirtualClock(), prefill_replicas=1,
                        decode_replicas=2)
    assert [r.name for r in router.replicas] == ["p0", "d0", "d1"]
    assert router.tiered and router.handoff.stats()["links"] == 2
    router.stop()


def test_prefill_tier_rejects_prefix_cache(bundle):
    """A prefill-tier replica ships its rows over the handoff bus — a
    resident pool there would double-cache every prefix.  The config
    refuses the combination; the decode tier keeps the pool, filled by
    the rows it splices."""
    with pytest.raises(ValueError, match="decode"):
        ServeConfig(role="prefill", prefix_cache=True)
    assert ServeConfig(role="decode", prefix_cache=True).prefix_cache
    assert ServeConfig(prefix_cache=True).prefix_cache
    clock = VirtualClock()
    router = make_fleet(bundle, clock, prefill_replicas=1, decode_replicas=1,
                        serve_overrides={"prefix_cache": True,
                                         "prefix_max_rows": 16})
    assert not router._by_name["p0"].engine.cfg.prefix_cache
    prompt = (np.arange(1, 41, dtype=np.int32) % 63) + 1
    reqs = [router.submit(prompt)]
    drive(router, clock, reqs)
    assert reqs[0].status == "ok"
    assert router._by_name["d0"].engine.prefix_stats()["resident_rows"] >= 2
    router.stop()


def test_http_tiered_fleet_healthz_statz_and_generate(bundle):
    """`start_http` over a tiered router: /healthz says `role: tiered`,
    /statz carries the tiers' name lists and the handoff section, and a
    POST decodes through the tiers to the colocated fleet's tokens."""
    prompt = np.random.default_rng(9).integers(0, 64, 11).astype(np.int32)
    ref, _ = _run_prompts(bundle, [prompt])
    router = make_fleet(bundle, None, prefill_replicas=1, decode_replicas=1)
    server = start_http(router, port=0)
    port = server.server_address[1]
    stop_ticking = threading.Event()

    def ticker():
        while not stop_ticking.is_set():
            time.sleep(0.01 if router._tick() else 0.005)

    tick_thread = threading.Thread(target=ticker, daemon=True)
    tick_thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read().decode())
        assert resp.status == 200 and health["role"] == "tiered"
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt.tolist(),
                                 "max_new_tokens": 12}))
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        assert resp.status == 200
        assert tuple(body["tokens"]) == ref[0][1]
        conn.request("GET", "/statz")
        resp = conn.getresponse()
        stats = json.loads(resp.read().decode())
        conn.close()
        assert stats["tiers"]["prefill"]["replicas"] == ["p0"]
        assert stats["tiers"]["decode"]["replicas"] == ["d0"]
        assert stats["handoff"]["spliced"] == 1
    finally:
        stop_ticking.set()
        tick_thread.join(5)
        stop_http(server)
        router.stop()


def _handoff_retry_records(tid):
    """tests/test_tracing.py's synthetic handoff-retry timeline: prefill
    attempt 1 hands off, the transfer fails, the router re-queues,
    attempt 2 hands off and splices — ONE trace id throughout."""
    return [
        {"type": "routing", "event": "admit", "ts": 0.0, "trace": tid,
         "sampled": True, "priority": "interactive"},
        {"type": "routing", "event": "dispatch", "ts": 0.5, "attempt": 1,
         "trace": tid, "sampled": True},
        {"type": "handoff", "event": "begin", "ts": 1.0, "trace": tid},
        {"type": "handoff", "event": "transfer_failed", "ts": 1.5,
         "trace": tid, "reason": "prefill_crash"},
        {"type": "routing", "event": "failover", "ts": 1.5, "trace": tid},
        {"type": "routing", "event": "dispatch", "ts": 2.0, "attempt": 2,
         "trace": tid, "sampled": True},
        {"type": "handoff", "event": "begin", "ts": 2.5, "trace": tid},
        {"type": "handoff", "event": "spliced", "ts": 3.0, "trace": tid},
        {"type": "routing", "event": "finish", "ts": 4.0, "trace": tid,
         "status": "ok", "priority": "interactive"},
    ]


def test_handoff_retry_waterfall_one_trace_two_attempts():
    tid = new_trace_id()
    out = assemble(_handoff_retry_records(tid))
    assert not out["orphans"]
    [wf] = out["waterfalls"]
    assert wf["trace"] == tid and wf["attempts"] == 2
    assert wf["status"] == "ok"
    assert wf["wall_s"] == pytest.approx(4.0)
    assert wf["stages_sum_s"] == pytest.approx(wf["wall_s"], abs=1e-6)
    assert wf["stages"] == {"queue": pytest.approx(1.0),
                            "prefill": pytest.approx(1.0),
                            "handoff": pytest.approx(1.0),
                            "decode": pytest.approx(1.0)}
    queue_segs = [s for s in wf["segments"] if s["stage"] == "queue"]
    assert len(queue_segs) == 2


def test_live_torn_handoff_is_one_trace_with_two_attempts(bundle, tmp_path):
    """The same waterfall from a real tiered fleet: a torn page fails the
    first transfer, the request re-prefills, and the run's records
    assemble into ONE trace with both attempts, exact tokens."""
    prompt = _grid_prompts()[2]
    ref, _ = _run_prompts(bundle, [prompt], serve_overrides={"cache_chunk": 8})
    clock = VirtualClock()
    set_injector(ChaosInjector(script=[
        Fault(kind="handoff_torn", at_request=1)]))
    try:
        with run_telemetry(str(tmp_path)) as rt:
            router = make_fleet(bundle, clock, prefill_replicas=1,
                                decode_replicas=1, handoff_pages_per_tick=1,
                                serve_overrides={"cache_chunk": 8})
            rr = router.submit(prompt)
            drive(router, clock, [rr])
            records = rt.tracer.records()
            router.stop()
    finally:
        set_injector(None)
    assert (rr.status, tuple(rr.tokens)) == ref[0]
    mine = [r for r in records if r.get("trace") == rr.trace.trace_id]
    events = [(r["type"], r["event"]) for r in mine
              if r.get("type") in ("handoff", "routing")]
    assert events.count(("handoff", "begin")) == 2
    assert ("handoff", "transfer_failed") in events
    assert ("handoff", "splice") in events
    [wf] = [w for w in assemble(records)["waterfalls"]
            if w["trace"] == rr.trace.trace_id]
    assert wf["attempts"] == 2 and wf["status"] == "ok"
    assert wf["stages_sum_s"] == pytest.approx(wf["wall_s"], abs=1e-6)
