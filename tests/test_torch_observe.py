"""The port's observe/, resilience/ and config modules against the JAX
package's, on the CPU: the same inputs give the same breaker states,
counters, trace records, Chrome-trace export, SLO rollup, waterfalls,
Prometheus exposition and run-summary keys.  Timing fields (timestamps,
durations, wall epochs) are the only ones left out of a comparison.
"""

import importlib
import signal

import numpy as np
import pytest

from mmlspark_tpu import config as jax_config
from mmlspark_tpu.observe import export as jax_export
from mmlspark_tpu.observe import metrics as jax_metrics
from mmlspark_tpu.observe import slo as jax_slo
from mmlspark_tpu.observe import telemetry as jax_telemetry
from mmlspark_tpu.observe import trace as jax_trace
from mmlspark_tpu.resilience import breaker as jax_breaker
from mmlspark_tpu.resilience.clock import VirtualClock as JaxVirtualClock
from mmlspark_tpu.serve import ServeConfig as JaxServeConfig
from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe import assemble, export, metrics, slo, \
    telemetry, trace
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.resilience import breaker
from mmlspark_tpu_torch.resilience.clock import VirtualClock
from mmlspark_tpu_torch.resilience.preemption import PreemptionGuard
from mmlspark_tpu_torch.serve import ServeConfig

# the JAX package's observe/__init__ re-exports a function named
# `assemble`, which shadows the module of that name as an attribute
jax_assemble = importlib.import_module("mmlspark_tpu.observe.assemble")
TIMING = ("ts", "dur", "wall_time", "wall_epoch_s", "wall_s",
          "wall_time_start", "producer", "pid", "seconds")


def _untimed(obj):
    """`obj` with every timing field dropped, recursively."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in TIMING}
    if isinstance(obj, (list, tuple)):
        return [_untimed(v) for v in obj]
    return obj


def test_config_reads_the_jax_packages_variable_names(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_SERVE_MAX_BATCH", "3")
    monkeypatch.setenv("MMLSPARK_TPU_SERVE_SEGMENT_STEPS", "5")
    monkeypatch.setenv("MMLSPARK_TPU_SERVE_CACHE_DTYPE", "int8")
    ours, ref = ServeConfig(), JaxServeConfig()
    assert (ours.max_batch, ours.segment_steps, ours.cache_dtype) == \
        (ref.max_batch, ref.segment_steps, ref.cache_dtype) == (3, 5, "int8")
    assert ServeConfig(max_batch=2).max_batch == 2
    names = {v["name"] for v in config.describe()}
    ref_names = {v["name"] for v in jax_config.describe()}
    assert {"MMLSPARK_TPU_SERVE_MAX_BATCH", "MMLSPARK_TPU_TRACE_SAMPLE",
            "MMLSPARK_TPU_SLO_TARGET", "MMLSPARK_TPU_BREAKER_THRESHOLD",
            "MMLSPARK_TPU_TELEMETRY"} <= names
    # every port variable is one the JAX package declares too
    assert names <= ref_names
    config.set("MMLSPARK_TPU_SERVE_MAX_BATCH", 6)
    try:
        assert config.get("MMLSPARK_TPU_SERVE_MAX_BATCH") == 6
        # the registries are separate: the override stays in the port
        assert jax_config.get("MMLSPARK_TPU_SERVE_MAX_BATCH") == 3
    finally:
        config.set("MMLSPARK_TPU_SERVE_MAX_BATCH", None)
    with pytest.raises(KeyError):
        config.get("MMLSPARK_TPU_NOT_A_KNOB")
    with pytest.raises(ValueError, match="namespaced"):
        config.register("OTHER_KNOB", 1)


def test_logger_factory_namespacing():
    assert get_logger("serve").name == "mmlspark_tpu_torch.serve"
    assert get_logger().name == "mmlspark_tpu_torch"


def _drive_breaker(mod, clock):
    """One breaker script: states, failure counts, refusals and snapshots
    after each step."""
    brk = mod.CircuitBreaker("test-endpoint", threshold=3, reset_s=5.0,
                             clock=clock)
    log = []

    def note(tag):
        snap = brk.snapshot()
        log.append((tag, snap["state"], snap["state_code"],
                    snap["consecutive_failures"], snap["retry_in_s"]))

    def attempt(tag):
        try:
            brk.allow()
            note(tag + ":allowed")
        except mod.CircuitOpenError as e:
            note(f"{tag}:refused:{e.retry_in_s:.3f}")

    for i in range(3):
        attempt(f"a{i}")
        brk.record_failure(RuntimeError("down"))
        note(f"fail{i}")
    attempt("open")
    clock.advance(2.0)
    attempt("cooling")
    clock.advance(3.5)
    attempt("probe")
    attempt("second_probe")
    brk.record_failure(RuntimeError("still down"))
    note("probe_failed")
    clock.advance(5.5)
    attempt("probe2")
    brk.record_success()
    note("closed")
    return log


def test_breaker_state_machine_matches_jax():
    assert _drive_breaker(breaker, VirtualClock()) == \
        _drive_breaker(jax_breaker, JaxVirtualClock())


def test_counters_and_metric_data_match_jax():
    for mod in (metrics, jax_metrics):
        mod.reset_counters()
        mod.inc_counter("serve.ok")
        mod.inc_counter("serve.ok", 2)
        mod.inc_counter("breaker.open", 0.5)
    assert metrics.counters_snapshot() == jax_metrics.counters_snapshot() \
        == {"serve.ok": 3.0, "breaker.open": 0.5}
    assert metrics.get_counter("serve.ok") == 3.0
    assert metrics.get_counter("never") == 0.0
    assert str(metrics.counters_metric_data()) == \
        str(jax_metrics.counters_metric_data())
    table = {"loss": [0.5, 0.25], "acc": [0.1, 0.2]}
    ours = metrics.MetricData.create_table(table, "training", "m")
    ref = jax_metrics.MetricData.create_table(table, "training", "m")
    assert str(ours) == str(ref)
    np.testing.assert_array_equal(ours.to_table()["loss"],
                                  np.asarray(ref.to_table()["loss"]))
    for mod in (metrics, jax_metrics):
        mod.reset_counters()


def _trace_script(mod):
    """Spans (nested through the ambient tracer, and explicit), events and
    a gauge-like record on one tracer; its records and Chrome export."""
    tracer = mod.Tracer(ring=64)
    with mod.tracing(tracer):
        with mod.trace_span("outer", cat="serve", bucket=8) as outer:
            with mod.trace_span("inner", step=1):
                mod.trace_event("tick", cat="serve", request=3)
            outer.attrs["tokens"] = 12
        with mod.span_on_tracer(tracer, "serve.segment", cat="serve",
                                window=128):
            pass
    tracer.event("lonely", parent=1, cat="x", k="v")
    tracer._record({"type": "gauge", "name": "serve.queue_depth",
                    "ts": 0.5, "value": 2.0, "attrs": {}})
    return tracer.records(), tracer.chrome_trace(), tracer.span_aggregates()


def test_trace_records_and_chrome_export_match_jax():
    ours, ref = _trace_script(trace), _trace_script(jax_trace)
    assert _untimed(ours[0]) == _untimed(ref[0])
    assert _untimed(ours[1]) == _untimed(ref[1])
    assert {k: v["count"] for k, v in ours[2].items()} == \
        {k: v["count"] for k, v in ref[2].items()}
    assert ours[1]["otherData"]["producer"] == \
        "mmlspark_tpu_torch.observe.trace"
    # the export of one fixed record list is identical, timings included
    records = ref[0]
    assert trace.chrome_trace(records, 12.5)["traceEvents"] == \
        jax_trace.chrome_trace(records, 12.5)["traceEvents"]
    assert trace.aggregate_spans(records) == \
        jax_trace.aggregate_spans(records)
    # nothing recorded without an active tracer
    assert trace.trace_event("nobody") is None


def test_trace_context_sampling_and_wire_match_jax():
    ids = [trace.new_trace_id() for _ in range(64)]
    assert all(len(t) == 32 for t in ids)
    for tid in ids:
        for frac in (0.0, 0.25, 0.5, 1.0):
            assert trace.head_sampled(tid, frac) == \
                jax_trace.head_sampled(tid, frac)
    ctx = trace.mint_context().child(parent_span=7, attempt=2)
    back = jax_trace.TraceContext.from_wire(ctx.to_wire())
    assert (back.trace_id, back.parent_span, back.attempt, back.sampled) \
        == (ctx.trace_id, 7, 2, ctx.sampled)
    assert trace.TraceContext.from_wire(back.to_wire()).attrs() == \
        ctx.attrs()
    for bad in (None, 5, "x", {}, {"id": 9}, {"id": ""}):
        assert trace.TraceContext.from_wire(bad) is None
    unsampled = trace.TraceContext("t" * 32, sampled=False)
    ref_unsampled = jax_trace.TraceContext("t" * 32, sampled=False)
    for kw in ({"status": "timeout", "latency_s": 0.1},
               {"status": "ok", "latency_s": 5.0},
               {"status": "ok", "latency_s": 0.1, "hedged": True},
               {"status": "ok", "latency_s": 0.1}):
        assert trace.tail_promote(unsampled, **kw) == \
            jax_trace.tail_promote(ref_unsampled, **kw)


def _serve_timeline():
    return [
        {"event": "admit", "ts": 0.0, "request": 1, "trace": "a" * 32,
         "sampled": True, "priority": "interactive", "bucket": 8},
        {"event": "join", "ts": 0.2, "request": 1, "trace": "a" * 32},
        {"event": "finish", "ts": 1.0, "request": 1, "status": "ok",
         "priority": "interactive", "deadline_miss": False,
         "trace": "a" * 32},
        {"event": "admit", "ts": 0.1, "request": 2, "trace": "b" * 32,
         "sampled": False, "priority": "batch", "bucket": 16},
        {"event": "finish", "ts": 3.0, "request": 2, "status": "timeout",
         "priority": "batch", "deadline_miss": True, "trace": "b" * 32,
         "tail": "timeout"},
        {"event": "finish", "ts": 3.5, "request": 3, "status": "ok",
         "priority": "interactive", "deadline_miss": True},
    ]


def test_slo_rollup_matches_jax():
    events = _serve_timeline()
    for target in (0.5, 0.99):
        assert slo.compute_slo(events, [], now=4.0, target=target) == \
            jax_slo.compute_slo(events, [], now=4.0, target=target)
    assert slo.compute_slo([], [], now=1.0) == {}


def test_waterfalls_and_tracez_match_jax():
    records = [{"type": "serve", **e} for e in _serve_timeline()]
    assert assemble.assemble(records) == jax_assemble.assemble(records)
    assert assemble.tracez_payload(None) == jax_assemble.tracez_payload(None)


def _run_script(mod_tel, mod_metrics, mod_trace, run_dir):
    with mod_tel.run_telemetry(str(run_dir)) as rt:
        mod_metrics.inc_counter("serve.ok", 2)
        rt.gauge("serve.queue_depth", 3)
        rt.gauge("serve.queue_depth", 1)
        for v in (0.0004, 0.02, 0.02, 7.0, 30.0):
            rt.observe_hist("serve.ttft_s", v)
        for e in _serve_timeline():
            rt.record_serve({k: v for k, v in e.items() if k != "ts"})
        with mod_trace.trace_span("serve.request", cat="serve"):
            pass
    return rt.summary()


def test_telemetry_summary_keys_and_rollups_match_jax(tmp_path):
    ours = _run_script(telemetry, metrics, trace, tmp_path / "port")
    ref = _run_script(jax_telemetry, jax_metrics, jax_trace,
                      tmp_path / "jax")
    assert set(ours) == set(ref)
    for key in ("counters", "gauges", "histograms", "serve", "routing",
                "stage_timings", "programs", "trace_records_dropped"):
        assert ours[key] == ref[key], key
    assert _untimed(ours["slo"]) == _untimed(ref["slo"])
    assert set(ours["spans"]) == set(ref["spans"]) == {"serve.request"}
    assert (tmp_path / "port" / "run_summary.json").exists()
    assert (tmp_path / "port" / "run.jsonl").exists()
    # no card here: the memory sample records nothing, as on a CPU mesh
    assert telemetry.RunTelemetry(None).sample_memory() == {}


def test_prometheus_exposition_matches_jax(tmp_path):
    texts = []
    for tel, met, brk in ((telemetry, metrics, breaker),
                          (jax_telemetry, jax_metrics, jax_breaker)):
        met.reset_counters()
        brk.reset_breakers()
        brk.register_breaker(brk.CircuitBreaker("model-cdn", threshold=2))
        met.inc_counter("serve.shed", 4)
        with tel.run_telemetry(None) as rt:
            rt.gauge("serve.in_flight", 5)
            rt.observe_hist("serve.inter_token_s", 0.003)
            rt.observe_hist("serve.inter_token_s", 0.3)
            texts.append(export.prometheus_text(rt) if tel is telemetry
                         else jax_export.prometheus_text(rt))
        met.reset_counters()
        brk.reset_breakers()
    ours, ref = ([line for line in t.splitlines() if "span" not in line]
                 for t in texts)
    assert ours == ref
    assert any(line.startswith("mmlspark_tpu_serve_shed_total 4")
               for line in ours)


def test_preemption_guard_turns_sigterm_into_a_flag():
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda *a: seen.append(a))
    try:
        with PreemptionGuard() as guard:
            assert not guard.triggered
            signal.raise_signal(signal.SIGTERM)
            assert guard.triggered
            assert len(seen) == 1          # the earlier handler chains
        # the guard restored the handler it found
        signal.raise_signal(signal.SIGTERM)
        assert len(seen) == 2
        inert = PreemptionGuard(install=False)
        with inert:
            inert.request()
        assert inert.triggered
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_virtual_clock_moves_only_when_told():
    clock = VirtualClock(10.0)
    clock.sleep(0.5)
    clock.sleep(-1.0)
    clock.advance(2.0)
    assert clock.monotonic() == 12.5
    assert clock.sleeps == [0.5, 0.0]
