"""The port's online serving engine (mmlspark_tpu_torch/serve/) on the CPU:
the scenarios of tests/test_serve.py — admission, deadlines, continuous
batching, shedding, the degraded lane, drain, HTTP — run on the port,
deadline math on a VirtualClock with zero sleeps, greedy tokens held
exactly to the port's offline `DecodeEngine` (which
tests/test_torch_generate.py pins to the JAX engine).  One case serves the
same submission schedule through the JAX and the port engines and
requires equal tokens and statuses.
"""

import http.client
import json
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.resilience.clock import VirtualClock as JaxVirtualClock
from mmlspark_tpu.serve import Overloaded as JaxOverloaded
from mmlspark_tpu.serve import ServeConfig as JaxServeConfig
from mmlspark_tpu.serve import ServingEngine as JaxServingEngine
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle
from mmlspark_tpu_torch.observe.telemetry import run_telemetry
from mmlspark_tpu_torch.resilience.breaker import CircuitOpenError
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.resilience.preemption import PreemptionGuard
from mmlspark_tpu_torch.serve import (AdmissionController, InvalidRequest,
                                      MissRateBreaker, Overloaded, Request,
                                      ServeConfig, ServingEngine,
                                      StepTimeEstimator)
from mmlspark_tpu_torch.serve.lifecycle import (start_engine, start_http,
                                                stop_http)
from mmlspark_tpu_torch.serve.request import CANCELLED, SHED

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32"}


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=0)


def _oracle(bundle, max_new=12):
    """The offline decode oracle of one bundle: greedy tokens for one
    prompt on its own."""
    eng = DecodeEngine(bundle.module("cpu"), max_new, chunk=16,
                       device="cpu")

    def decode(prompt, n=max_new):
        b = eng.bucket_for(len(prompt))
        padded = np.zeros((1, b), np.int32)
        padded[0, :len(prompt)] = prompt
        return eng.generate(padded, np.asarray([len(prompt)], np.int32)
                            )[0][:n].tolist()
    return decode


@pytest.fixture(scope="module")
def offline(bundle):
    return _oracle(bundle)


def make_engine(bundle, clock, **overrides):
    kw = dict(max_new_tokens=12, max_batch=4, queue_capacity=8,
              segment_steps=4, default_deadline_s=100.0,
              drain_timeout_s=50.0, cache_chunk=16)
    kw.update(overrides)
    deg = kw.pop("degraded_bundle", None)
    return ServingEngine(bundle, ServeConfig(**kw), degraded_bundle=deg,
                         clock=clock, device="cpu")


def drain(engine, requests, max_ticks=200):
    for _ in range(max_ticks):
        if all(r.finished for r in requests):
            return
        engine._tick()
    raise AssertionError(
        f"requests not finished after {max_ticks} ticks: "
        f"{[r.status for r in requests]}")


def _prompt(seed, n=5):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (n,)).astype(np.int32)


def _req(clock, bucket=8, n_new=8, deadline_s=10.0, rid=1, plen=5):
    prompt = np.ones(plen, np.int32)
    now = clock.monotonic()
    return Request(rid, prompt, bucket, n_new, now, now + deadline_s)


# ---------------------------------------------------------------------------
# admission control (no engine, pure policy, virtual clock)
# ---------------------------------------------------------------------------

def test_queue_full_sheds_with_reason():
    clock = VirtualClock()
    adm = AdmissionController(2, StepTimeEstimator(), clock=clock)
    adm.try_admit(_req(clock, rid=1))
    adm.try_admit(_req(clock, rid=2))
    with pytest.raises(Overloaded) as e:
        adm.try_admit(_req(clock, rid=3))
    assert e.value.reason == "queue_full"
    assert adm.pending() == 2


def test_infeasible_deadline_rejected_only_on_proof():
    clock = VirtualClock()
    est = StepTimeEstimator()
    adm = AdmissionController(8, est, clock=clock)
    adm.try_admit(_req(clock, rid=1, deadline_s=0.001))
    est.observe_prefill(8, 0.5)
    est.observe_step(8, 1.0)
    with pytest.raises(Overloaded) as e:
        adm.try_admit(_req(clock, rid=2, n_new=8, deadline_s=2.0))
    assert e.value.reason == "infeasible"
    adm.try_admit(_req(clock, rid=3, n_new=8, deadline_s=60.0))


def test_admission_close_sheds_as_draining():
    clock = VirtualClock()
    adm = AdmissionController(8, StepTimeEstimator(), clock=clock)
    adm.close()
    with pytest.raises(Overloaded) as e:
        adm.try_admit(_req(clock))
    assert e.value.reason == "draining"


def test_estimator_worst_bucket_fallback():
    est = StepTimeEstimator()
    assert est.service_s(8, 4) is None
    est.observe_step(16, 0.25)
    est.observe_step(32, 1.0)
    assert est.step_s(8) == 1.0
    assert est.service_s(8, 4) == pytest.approx(1.0 * 4)
    assert est.service_s(16, 4) == pytest.approx(0.25 * 4)


def test_queue_expiry_dropped():
    clock = VirtualClock()
    adm = AdmissionController(8, StepTimeEstimator(), clock=clock)
    adm.try_admit(_req(clock, rid=1, deadline_s=5.0))
    adm.try_admit(_req(clock, rid=2, deadline_s=50.0))
    clock.advance(10.0)
    assert [r.id for r in adm.drop_expired(clock.monotonic())] == [1]
    assert adm.pending() == 1


def test_admission_cold_start_admits_without_evidence():
    clock = VirtualClock()
    est = StepTimeEstimator(alpha=0.3)
    ac = AdmissionController(8, est, None, max_batch=4, clock=clock)
    assert est.service_s(8, 12) is None and est.step_s(8) is None
    now = clock.monotonic()
    req = Request(1, np.zeros(5, np.int32), 8, 12, now, now + 1e-3)
    assert ac.try_admit(req, 0) == "primary"
    assert ac.pending() == 1


def test_estimator_converges_then_admission_uses_proof():
    clock = VirtualClock()
    est = StepTimeEstimator(alpha=0.3)
    ac = AdmissionController(8, est, None, max_batch=4, clock=clock)
    est.observe_prefill(8, 1.0)
    est.observe_step(8, 1.0)
    for _ in range(12):
        est.observe_step(8, 0.1)
        est.observe_prefill(8, 0.1)
    assert est.step_s(8) == pytest.approx(0.1, abs=0.02)
    now = clock.monotonic()
    req = Request(2, np.zeros(5, np.int32), 8, 12, now, now + 1e-3)
    with pytest.raises(Overloaded) as exc:
        ac.try_admit(req, 0)
    assert exc.value.reason == "infeasible"
    req = Request(3, np.zeros(5, np.int32), 8, 12, now, now + 60.0)
    assert ac.try_admit(req, 0) == "primary"


def test_miss_rate_breaker_state_machine():
    clock = VirtualClock()
    brk = MissRateBreaker("serve-test", window=8, min_samples=4,
                          miss_rate=0.5, reset_s=5.0, clock=clock)
    for _ in range(4):
        brk.record(missed=True)
    assert brk.state == "open"
    with pytest.raises(CircuitOpenError):
        brk.allow()
    clock.advance(5.1)
    brk.allow()
    assert brk.state == "half_open"
    brk.record(missed=False)
    assert brk.state == "closed"
    for _ in range(4):
        brk.record(missed=True)
    clock.advance(5.1)
    brk.allow()
    brk.record(missed=True)
    assert brk.state == "open"


# ---------------------------------------------------------------------------
# the engine: parity, joins, cancellation, drain — inline, VirtualClock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["model", "int8"])
def test_single_request_matches_offline(bundle, offline, cache):
    engine = make_engine(bundle, VirtualClock(), cache_dtype=cache)
    engine.warmup()
    prompt = _prompt(0)
    req = engine.submit(prompt, max_new_tokens=12)
    drain(engine, [req])
    assert req.status == "ok"
    if cache == "model":
        assert req.tokens == offline(prompt, 12)
    else:
        eng = DecodeEngine(bundle.module("cpu"), 12, chunk=16,
                           cache_dtype="int8", device="cpu")
        padded = np.zeros((1, 8), np.int32)
        padded[0, :5] = prompt
        assert req.tokens == eng.generate(padded, [5])[0].tolist()


def test_midflight_join_exact_parity(bundle, offline):
    """A request joining a running batch at a segment boundary gets
    EXACTLY the tokens it would get alone."""
    engine = make_engine(bundle, VirtualClock(), max_batch=2)
    engine.warmup()
    p1, p2 = _prompt(1), _prompt(11, 7)
    r1 = engine.submit(p1, max_new_tokens=12)
    engine._tick()
    assert engine.in_flight() == 1
    r2 = engine.submit(p2, max_new_tokens=12)
    drain(engine, [r1, r2])
    assert r1.tokens == offline(p1, 12)
    assert r2.tokens == offline(p2, 12)


def test_short_rows_free_slots_for_later_arrivals(bundle):
    engine = make_engine(bundle, VirtualClock(), max_batch=2,
                         segment_steps=4)
    engine.warmup()
    short1 = engine.submit(_prompt(2), max_new_tokens=2)
    long1 = engine.submit(_prompt(12), max_new_tokens=12)
    waiting = engine.submit(_prompt(22), max_new_tokens=2)
    engine._tick()
    assert short1.finished
    engine._tick()
    assert not long1.finished
    assert waiting.finished or engine.in_flight() == 2
    drain(engine, [long1, waiting])
    assert {r.status for r in (short1, long1, waiting)} == {"ok"}


def test_deadline_cancel_at_segment_boundary(bundle, offline):
    clock = VirtualClock()
    engine = make_engine(bundle, clock, segment_steps=2)
    engine.warmup()
    doomed = engine.submit(_prompt(3), max_new_tokens=12, deadline_s=5.0)
    healthy = engine.submit(_prompt(13, 6), max_new_tokens=12,
                            deadline_s=1000.0)
    engine._tick()
    assert not doomed.finished
    clock.advance(10.0)
    engine._tick()
    assert doomed.status == "timeout"
    assert len(doomed.tokens) < 12
    drain(engine, [healthy])
    assert healthy.status == "ok"
    assert healthy.tokens == offline(np.asarray(healthy.prompt), 12)


def test_queued_request_expires_without_decoding(bundle):
    clock = VirtualClock()
    engine = make_engine(bundle, clock, max_batch=1, queue_capacity=4)
    engine.warmup()
    resident = engine.submit(_prompt(4), max_new_tokens=12,
                             deadline_s=1000.0)
    queued = engine.submit(_prompt(14), max_new_tokens=12, deadline_s=3.0)
    engine._tick()
    clock.advance(5.0)
    engine._tick()
    assert queued.status == "timeout"
    assert queued.tokens == []
    drain(engine, [resident])
    assert resident.status == "ok"


def test_drain_finishes_in_flight_by_deadline(bundle):
    engine = make_engine(bundle, VirtualClock(), drain_timeout_s=100.0)
    engine.warmup()
    req = engine.submit(_prompt(5), max_new_tokens=8)
    engine._tick()
    engine.begin_drain("test")
    with pytest.raises(Overloaded) as e:
        engine.submit(_prompt(15))
    assert e.value.reason == "draining"
    engine.stop()
    assert req.status == "ok"
    assert engine.state == "stopped"


def test_drain_deadline_cancels_stragglers(bundle):
    clock = VirtualClock()
    engine = make_engine(bundle, clock, drain_timeout_s=2.0, max_batch=1,
                         queue_capacity=4)
    engine.warmup()
    resident = engine.submit(_prompt(6), max_new_tokens=12)
    queued = engine.submit(_prompt(16), max_new_tokens=12)
    engine._tick()
    engine.begin_drain("test")
    clock.advance(5.0)
    engine._tick()
    assert resident.status == "cancelled"
    assert queued.status == "cancelled"
    assert engine.in_flight() == 0
    assert engine._drained()


def test_sigterm_flag_triggers_drain(bundle):
    engine = make_engine(bundle, VirtualClock())
    engine.warmup()
    guard = PreemptionGuard(install=False)
    engine._guard = guard
    req = engine.submit(_prompt(7), max_new_tokens=4)
    guard.request()
    engine._tick()
    assert engine.state == "draining"
    drain(engine, [req])
    assert req.status == "ok"


def test_poison_rejected_without_side_effects(bundle):
    engine = make_engine(bundle, VirtualClock())
    engine.warmup()
    before = dict(engine._counts)
    for prompt, kw in ((np.asarray([99999], np.int64), {}),
                       (np.asarray([], np.int32), {}),
                       (np.ones(200, np.int32), {}),
                       (np.ones(5, np.int32), {"max_new_tokens": 999}),
                       ([[1, 2], [3, 4]], {}), ("not tokens", {})):
        with pytest.raises(InvalidRequest):
            engine.submit(prompt, **kw)
    with pytest.raises(InvalidRequest, match="priority"):
        engine.submit(np.ones(5, np.int32), priority="urgent")
    assert engine._counts == before
    assert engine.in_flight() == 0 and engine.admission.pending() == 0


def test_warmup_runs_every_shape_class_of_a_bucket(bundle):
    """After warmup a full-budget request in the warmed bucket runs no
    shape class warmup did not; `warmup_joins` adds the late-join
    merges and the terminal segment class."""
    engine = make_engine(bundle, VirtualClock())
    engine.warmup()
    eng = engine._engines["primary"]
    warmed = eng.compiled_programs
    # cohorts 1, 2, 4, and the segment classes of the 12-token ladder of
    # 4-step segments over bucket 8: windows 16 -> 16 and 16 -> 32
    assert warmed == 3 + 2
    req = engine.submit(np.ones(5, np.int32), max_new_tokens=12)
    drain(engine, [req])
    assert eng.compiled_programs == warmed
    joins = make_engine(bundle, VirtualClock(), warmup_joins=True)
    joins.warmup()
    assert joins._engines["primary"].compiled_programs > warmed
    assert joins.ready


def test_breaker_open_sheds_without_degraded(bundle):
    engine = make_engine(bundle, VirtualClock(), miss_window=8,
                         miss_min_samples=4, shed_miss_rate=0.5)
    engine.warmup()
    for _ in range(4):
        engine.breaker.record(missed=True)
    assert engine.breaker.state == "open"
    with pytest.raises(Overloaded) as e:
        engine.submit(np.ones(5, np.int32))
    assert e.value.reason == "breaker_open"
    assert e.value.retry_after_s > 0


def test_breaker_open_fails_over_to_degraded(bundle):
    """The degraded lane decodes its own bundle: with the breaker open a
    new request runs there and gets that bundle's offline tokens."""
    deg_bundle = ModelBundle.init("TransformerLM", CFG, seed=1)
    engine = make_engine(bundle, VirtualClock(), degraded_bundle=deg_bundle,
                         miss_window=8, miss_min_samples=4,
                         shed_miss_rate=0.5)
    engine.warmup()
    for _ in range(4):
        engine.breaker.record(missed=True)
    assert engine.breaker.state == "open"
    prompt = _prompt(8)
    req = engine.submit(prompt, max_new_tokens=8)
    assert req.degraded
    drain(engine, [req])
    assert req.status == "ok"
    assert req.tokens == _oracle(deg_bundle)(prompt, 8)
    assert engine.stats()["degraded"] == 1


def test_degraded_bundle_the_loader_refuses_fails_at_construction(bundle):
    """An int8-weight bundle (the JAX package's PTQ) now loads: its lane
    builds with the Dense weights int8 on the device.  A bundle of another
    vocabulary is still refused when the engine is built."""
    from mmlspark_tpu.quant import quantize_bundle
    jax_bundle = JaxModelBundle("TransformerLM", CFG, bundle.variables)
    q = quantize_bundle(jax_bundle, "int8")
    int8_bundle = ModelBundle("TransformerLM", q.config,
                              jax.tree_util.tree_map(np.asarray, q.variables))
    engine = make_engine(bundle, VirtualClock(), degraded_bundle=int8_bundle)
    lane = engine._engines["degraded"].weights
    assert all(layer.weight.dtype == torch.int8
               for layer in lane.dense_layers())
    other = ModelBundle.init("TransformerLM", {**CFG, "vocab_size": 32})
    with pytest.raises(ValueError, match="vocabulary"):
        make_engine(bundle, VirtualClock(), degraded_bundle=other)


def test_unported_options_raise_naming_the_roadmap_step(bundle,
                                                        monkeypatch):
    # speculation is ported: the config takes it, the engine wants a draft
    assert ServeConfig(spec_tokens=2).spec_tokens == 2
    # the disaggregated roles are ported: they construct
    for role in ("prefill", "decode"):
        assert ServeConfig(role=role).role == role
    with pytest.raises(ValueError, match="role"):
        ServeConfig(role="router")
    with pytest.raises(ValueError, match="draft_bundle"):
        ServingEngine(bundle, ServeConfig(spec_tokens=2), device="cpu")
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    for axes, err in (({"seq": 2}, ValueError), ({"data": 2},
                                                  NotImplementedError)):
        spec = MeshSpec(**{"data": 1, **axes})
        mesh = make_mesh(spec, [torch.device("cpu")] * 2)
        with pytest.raises(err):
            ServingEngine(bundle, ServeConfig(), mesh=mesh, device="cpu")
    # the default device is the card: without one the engine raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(bundle, ServeConfig())


def test_serve_timeline_and_gauges_in_run_summary(bundle, tmp_path):
    clock = VirtualClock()
    with run_telemetry(str(tmp_path)) as rt:
        engine = make_engine(bundle, clock, queue_capacity=1, max_batch=1)
        engine.warmup()
        reqs = [engine.submit(_prompt(9), max_new_tokens=4)]
        shed = 0
        for i in range(3):
            try:
                reqs.append(engine.submit(_prompt(19 + i), max_new_tokens=4))
            except Overloaded:
                shed += 1
        drain(engine, reqs)
        engine.stop()
        summary = rt.summary()
    assert shed >= 1
    events = [e["event"] for e in summary["serve"]]
    assert "ready" in events and "shed" in events and "join" in events
    assert events.index("drain_start") < events.index("drain_end")
    assert summary["gauges"]["serve.latency_p50_ms"]["n"] >= 1
    assert summary["gauges"]["serve.in_flight"]["n"] >= 1
    assert summary["histograms"]["serve.ttft_s"]["count"] >= 1
    assert summary["spans"]["serve.request"]["count"] >= 1
    assert summary["spans"]["serve.segment"]["count"] >= 1
    assert summary["slo"]["endpoints"]["interactive"]["requests"] >= 1
    with open(tmp_path / "run_summary.json") as f:
        assert json.load(f)["serve"] == summary["serve"]


# ---------------------------------------------------------------------------
# one schedule through the JAX engine and the port's
# ---------------------------------------------------------------------------

def _schedule(engine, clock, overloaded):
    """A fixed submission schedule over two buckets of capacity 2, the
    clock advancing 100 virtual seconds per tick: a queue overflow
    (shed), a boundary cancel, a queue expiry, and joins into running
    batches.  Admission prices requests by the host's measured prefill
    and step times; deadlines of 100 s and more keep that proof from
    deciding any request, however loaded the host.  Returns
    [(status, tokens)] in submission order."""
    out, live = [], []

    def submit(seed, n, deadline=1e4, plen=5):
        try:
            req = engine.submit(_prompt(seed, plen), max_new_tokens=n,
                                deadline_s=deadline)
        except overloaded as e:
            out.append(("shed:" + e.reason, []))
            return
        live.append(req)

    submit(30, 12)
    submit(31, 3, plen=9)              # bucket 16, done in one segment
    submit(32, 12, deadline=150.0)     # cancelled at the tick-2 boundary
    submit(33, 6)                      # joins the slot 32 frees
    submit(35, 5)                      # the queue holds 4: shed
    for tick in range(40):
        engine._tick()
        clock.advance(100.0)
        if tick == 0:
            submit(34, 8, deadline=150.0)  # expires in the queue
            submit(36, 10, plen=7)         # joins beside 33 at tick 3
        if all(r.finished for r in live):
            break
    return out + [(r.status, list(map(int, r.tokens))) for r in live]


def test_jax_and_port_engines_serve_one_schedule_alike(bundle):
    cfg = dict(max_new_tokens=12, max_batch=2, queue_capacity=4,
               segment_steps=4, default_deadline_s=1e4,
               drain_timeout_s=50.0, cache_chunk=16)
    jax_clock = JaxVirtualClock()
    ref_engine = JaxServingEngine(
        JaxModelBundle("TransformerLM", CFG, bundle.variables),
        JaxServeConfig(**cfg), clock=jax_clock)
    ref_engine.warmup()
    ref = _schedule(ref_engine, jax_clock, JaxOverloaded)
    clock = VirtualClock()
    engine = ServingEngine(bundle, ServeConfig(**cfg), clock=clock,
                           device="cpu")
    engine.warmup()
    got = _schedule(engine, clock, Overloaded)
    assert got == ref
    statuses = {s for s, _ in got}
    assert {"ok", "timeout", "shed:queue_full"} <= statuses


# ---------------------------------------------------------------------------
# HTTP front end over a real socket (threaded engine; event-based waits)
# ---------------------------------------------------------------------------

def test_http_front_end_end_to_end(bundle, offline):
    engine = make_engine(bundle, None)
    start_engine(engine, install_sigterm=False)
    server = start_http(engine, port=0)
    port = server.server_address[1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)

        def get(path):
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read().decode() or "{}")

        status, body = get("/healthz")
        assert status == 200 and body["status"] == "ok"
        assert body["role"] == "colocated"
        status, body = get("/readyz")
        assert status == 200 and body["ready"] is True
        prompt = _prompt(10)
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt.tolist(),
                                 "max_new_tokens": 8}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        assert resp.status == 200
        assert body["tokens"] == offline(prompt, 8)
        assert body["met_deadline"] is True
        status, body = get("/statz")
        assert status == 200 and body["ok"] == 1
        status, body = get("/tracez")
        assert status == 200
        conn.request("POST", "/generate", json.dumps({"prompt": [99999]}))
        resp = conn.getresponse()
        assert resp.status == 400
        assert "error" in json.loads(resp.read().decode())
        conn.request("GET", "/nope")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
        engine.begin_drain("test")
        status, body = get("/readyz")
        assert status == 503 and body["ready"] is False
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt.tolist()}))
        resp = conn.getresponse()
        assert resp.status == 429
        assert resp.getheader("Retry-After") is not None
        resp.read()
        conn.close()
    finally:
        stop_http(server)
        engine.stop()
    assert engine.state == "stopped"


class _ShedRequest(Request):
    """A request finished `shed` carries the router's backoff hint."""
    retry_after_s = 0.0


def test_retry_after_headers_on_429_and_503():
    """Every shed/cancel response carries a numeric Retry-After from live
    evidence; a duck-typed stub engine makes each refusal deterministic."""
    class StubEngine:
        state = "ready"
        ready = True
        cfg = types.SimpleNamespace(drain_timeout_s=1.0)
        mode = "ok"

        def now(self):
            return time.monotonic()

        def retry_after_s(self):
            return 7.5

        def stats(self):
            return {"state": self.state}

        def submit(self, prompt, max_new_tokens=None, deadline_s=None,
                   priority=None):
            now = self.now()
            if self.mode == "front_door_shed":
                raise Overloaded("queue_full", 3.25, "queue at capacity")
            req = _ShedRequest(1, np.asarray(prompt, np.int32), 8,
                               int(max_new_tokens or 4), now, now + 5.0)
            if self.mode == "drain_cancel":
                req.finish(CANCELLED, now, "engine draining")
            elif self.mode == "budget_shed":
                req.retry_after_s = 2.5
                req.finish(SHED, now, "retry budget exhausted")
            return req

    stub = StubEngine()
    server = start_http(stub, port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=10)

        def post():
            conn.request("POST", "/generate",
                         json.dumps({"prompt": [1, 2, 3]}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp, json.loads(resp.read().decode())

        stub.mode = "front_door_shed"
        resp, body = post()
        assert resp.status == 429 and body["reason"] == "queue_full"
        assert float(resp.getheader("Retry-After")) == pytest.approx(3.25)
        stub.mode = "budget_shed"
        resp, body = post()
        assert resp.status == 429 and body["reason"] == "retry_budget"
        assert float(resp.getheader("Retry-After")) == pytest.approx(2.5)
        stub.mode = "drain_cancel"
        resp, body = post()
        assert resp.status == 503 and "error" in body
        assert float(resp.getheader("Retry-After")) == pytest.approx(7.5)
        conn.close()
    finally:
        stop_http(server)


def test_streaming_flushes_at_segment_boundaries(bundle, offline):
    """Chunked NDJSON over a real engine: tokens arrive in several
    segment-boundary flushes, the first before the full response, and
    the concatenated stream equals the final tokens equals the oracle."""
    engine = make_engine(bundle, None)
    engine.warmup()
    server = start_http(engine, port=0)
    stop_ticking = threading.Event()

    def ticker():
        while not stop_ticking.is_set():
            time.sleep(0.03 if engine._tick() else 0.005)

    tick_thread = threading.Thread(target=ticker, daemon=True)
    tick_thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=30)
        prompt = _prompt(21)
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt.tolist(),
                                 "max_new_tokens": 12, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        t0 = time.monotonic()
        first_token_at = done_at = final = None
        streamed, chunks = [], 0
        while True:
            line = resp.readline()
            if not line:
                break
            payload = json.loads(line.decode())
            if "tokens" in payload and not payload.get("done"):
                chunks += 1
                if first_token_at is None:
                    first_token_at = time.monotonic() - t0
                streamed.extend(payload["tokens"])
            if payload.get("done"):
                done_at = time.monotonic() - t0
                final = payload
                break
        assert final is not None and final["status"] == "ok"
        assert final["restarts"] == 0
        assert chunks >= 2
        assert first_token_at < done_at
        assert streamed == final["tokens"] == offline(prompt, 12)
        conn.close()
    finally:
        stop_http(server)
        stop_ticking.set()
        tick_thread.join(timeout=5)
        engine.stop()
