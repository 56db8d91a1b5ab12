"""The port's per-program cost counting (mmlspark_tpu_torch/observe/
costmodel.py, utils/perf.py) against the JAX package's cost model: the
roofline and the program table give the JAX functions' outputs on equal
inputs, the cost counter counts hand-counted ops exactly, the kernel
wrappers report their formulas on CPU tensors (through the plain
versions) and hide the plain version from the counter, and the hot
loops (TPUModel, DecodeEngine) count, time, replay and degrade as the
JAX loops do.  The train step's FLOPs: test_torch_train_flops.py."""

import json
import os
import re

import numpy as np
import pytest
import torch

from mmlspark_tpu.observe import costmodel as jax_costmodel
from mmlspark_tpu_torch import DataTable, TPUModel, config, run_telemetry
from mmlspark_tpu_torch.models import DecodeEngine, ModelBundle
from mmlspark_tpu_torch.observe import costmodel
from mmlspark_tpu_torch.observe.costmodel import CostCounter
from mmlspark_tpu_torch.observe.export import prometheus_text
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention, fused_single_query_attention_stats,
    k4_cost)
from mmlspark_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_with_lse, flash_block_grads, k1_cost,
    k2_cost, k3_cost, visible_pairs)
from mmlspark_tpu_torch.utils import perf

# -- roofline and the program table: the JAX functions' outputs ------------

# the reference's cases (tests/test_analytics.py): compute-, bandwidth-
# and host-bound, unknown peaks
ROOFLINE = {
    "compute": (dict(flops=1e12, bytes_accessed=1e9, step_s=0.005,
                     peak_flops=4e14, peak_bw=1e12), "compute-bound"),
    "bandwidth": (dict(flops=1e9, bytes_accessed=1e9, step_s=0.002,
                       peak_flops=4e14, peak_bw=1e12), "bandwidth-bound"),
    "host": (dict(flops=1e12, bytes_accessed=1e9, step_s=5.0,
                  peak_flops=4e14, peak_bw=1e12), "host-bound"),
    "unknown_peaks": (dict(flops=1e12, bytes_accessed=1e9, step_s=0.005),
                      None),
}


@pytest.mark.parametrize("case", sorted(ROOFLINE))
def test_roofline_equals_jax(case):
    kwargs, verdict = ROOFLINE[case]
    ours = costmodel.roofline(**kwargs)
    assert ours == jax_costmodel.roofline(**kwargs)
    assert ours["verdict"] == verdict
    if verdict is None:
        assert ours["mfu"] is None and ours["hbm_bw_util"] is None


PROGRAM_COSTS = {
    ("trainer", "(8, 2048):int32"): {"flops": 3.1e14, "bytes_accessed":
                                     2.2e11},
    ("tpu_model", "(256, 224, 224, 3):uint8"): {
        "flops": 2.1e12, "bytes_accessed": 9e10, "probe_step_s": 0.012},
    ("decode", "('segment', 8, 1088, 1152, 64)"): {
        "flops": 1.4e11, "bytes_accessed": 6e10},
    ("decode", "('prefill', 8, 1024)"): {"flops": 2e12,
                                         "bytes_accessed": 1e10},
}
PROGRAM_TIMES = {
    ("trainer", "(8, 2048):int32"): {"seconds": 1.2, "count": 3,
                                     "basis": "step_wall"},
    ("tpu_model", "(256, 224, 224, 3):uint8"): {"seconds": 0.004,
                                                "count": 3,
                                                "basis": "dispatch"},
    ("decode", "('segment', 8, 1088, 1152, 64)"): {"seconds": 0.09,
                                                   "count": 2,
                                                   "basis": "device"},
    ("decode", "('resume', 1)"): {"seconds": 0.5, "count": 1,
                                  "basis": "dispatch"},
}


@pytest.mark.parametrize("peaks", [(None, None), (989e12, 3.35e12)])
def test_program_summary_equals_jax(peaks):
    ours = costmodel.program_summary(PROGRAM_COSTS, PROGRAM_TIMES, *peaks)
    ref = jax_costmodel.program_summary(PROGRAM_COSTS, PROGRAM_TIMES,
                                        *peaks)
    assert ours == ref
    assert ours["trainer:(8, 2048):int32"]["step_basis"] == "span_wall"
    assert ours["tpu_model:(256, 224, 224, 3):uint8"]["step_basis"] == \
        "probe"
    assert ours["decode:('prefill', 8, 1024)"]["executions"] == 0
    # the port's rows add the kernels' share beside the JAX keys
    rows = costmodel.program_rows(
        {**PROGRAM_COSTS, ("x", "y"): {"flops": 4.0, "kernel_flops": 3.0}},
        PROGRAM_TIMES, *peaks)
    assert rows["x:y"]["kernel_flops"] == 3.0
    assert rows["trainer:(8, 2048):int32"]["kernel_flops"] is None
    assert costmodel.HOST_BOUND_FLOOR == jax_costmodel.HOST_BOUND_FLOOR


# -- the counter on hand-counted ops -----------------------------------------

def test_counter_counts_a_matmul():
    m, k, n = 8, 16, 4
    a, b = torch.randn(m, k), torch.randn(k, n)
    with CostCounter() as c:
        a @ b
    assert c.flops == 2 * m * n * k
    assert c.bytes_accessed == (m * k + k * n + m * n) * 4
    assert c.row()["kernel_flops"] == 0.0


def test_counter_counts_a_convolution():
    x, w = torch.randn(2, 3, 10, 10), torch.randn(5, 3, 3, 3)
    with CostCounter() as c:
        out = torch.nn.functional.conv2d(x, w, padding=1)
    # every kernel tap of every output, the padded ones included
    assert c.flops == 2 * out.numel() * 3 * 3 * 3
    assert c.bytes_accessed == (x.numel() + w.numel() + out.numel()) * 4


def test_counter_sees_through_composite_ops_in_inference_mode():
    """Under inference mode `linear` reaches the counter undecomposed; it
    is counted through what it decomposes into."""
    x, w = torch.randn(8, 16), torch.randn(4, 16)
    with torch.inference_mode(), CostCounter() as c:
        torch.nn.functional.linear(x, w)
    assert c.flops == 2 * 8 * 16 * 4


def test_counter_failure_never_fails_the_op(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no formula")
    with CostCounter() as c:
        monkeypatch.setitem(c._registry, torch.ops.aten.mm, broken)
        out = torch.ones(2, 3) @ torch.ones(3, 2)
    assert torch.equal(out, torch.full((2, 2), 3.0))
    assert isinstance(c.error, RuntimeError)


# -- the kernel wrappers' reports (CPU tensors, plain versions) -------------

def _qkv(b=2, s=24, h=2, d=8, sk=None, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=g)
    k, v = (torch.randn((b, sk or s, h, d), generator=g) for _ in range(2))
    return [t.requires_grad_(grad) for t in (q, k, v)]


@pytest.mark.parametrize("causal,q_off,k_off,sk", [
    (True, 0, 0, None), (False, 0, 0, 40), (True, 16, 0, 40),
    (True, 0, 30, 20)])
def test_k1_and_backward_hooks_report_their_formulas(causal, q_off, k_off,
                                                     sk):
    q, k, v = _qkv(sk=sk)
    pairs = visible_pairs(24, k.shape[1], causal, q_off, k_off)
    with CostCounter() as c:
        out, lse = flash_attention_with_lse(q, k, v, causal, None, q_off,
                                            k_off)
    assert c.flops == 0 and c.bytes_accessed == 0   # the plain is hidden
    assert c.kernel_flops == 4 * 2 * 2 * 8 * pairs
    assert c.kernel_launches == {"K1[lse]": 1}
    assert c.kernel_bytes == k1_cost(q, k, v, causal, q_off, k_off, True)[1]
    delta = torch.zeros_like(lse)
    with CostCounter() as c:
        flash_block_grads(q, k, v, q.clone(), lse, delta, causal, 0.5,
                          q_off, k_off)
    assert c.kernel_launches == {"K2": 1, "K3": 1}
    assert c.kernel_flops == (6 + 8) * 2 * 2 * 8 * pairs
    assert c.kernel_bytes == (k2_cost(q, k, v, causal, q_off, k_off)[1]
                              + k3_cost(q, k, v, causal, q_off, k_off)[1])
    assert c.flops == 0


def test_flash_autograd_counts_each_kernel_once():
    """The flash operator registers no formula: K1[lse] forward, K2 and
    K3 backward are counted by their wrappers alone; delta is an aten op
    (bytes, no FLOPs)."""
    q, k, v = _qkv(grad=True)
    with CostCounter() as c:
        flash_attention(q, k, v, causal=True).sum().backward()
    assert c.kernel_launches == {"K1[lse]": 1, "K2": 1, "K3": 1}
    want = sum(f(q, k, v, True)[0] for f in (k2_cost, k3_cost)) \
        + k1_cost(q, k, v, True, 0, 0, True)[0]
    assert c.kernel_flops == want
    assert c.flops == 0 and c.bytes_accessed > 0
    with torch.no_grad(), CostCounter() as c:
        flash_attention(q, k, v, causal=False)
    assert c.kernel_launches == {"K1": 1}
    assert c.kernel_flops == 4 * 2 * 2 * 8 * 24 * 24


@pytest.mark.parametrize("stats,int8", [(False, False), (True, False),
                                        (False, True)])
def test_k4_hooks_report_their_formula(stats, int8):
    g = torch.Generator().manual_seed(1)
    b, window, h, d = 3, 40, 2, 16
    q = torch.randn((b, h, d), generator=g)
    k, v = (torch.randn((b, window, h, d), generator=g) for _ in range(2))
    kw = {}
    if int8:
        k, v = (t.to(torch.int8) for t in (k, v))
        kw = dict(k_scale=torch.ones(b, window, h),
                  v_scale=torch.ones(b, window, h))
    visible = torch.rand((b, window), generator=g) > 0.3
    fn = (fused_single_query_attention_stats if stats
          else fused_single_query_attention)
    with CostCounter() as c:
        fn(q, k, v, visible, **kw)
    assert c.flops == 0
    assert c.kernel_flops == 4 * b * window * h * d
    assert c.kernel_bytes == k4_cost(q, k, v, visible, kw.get("k_scale"),
                                     kw.get("v_scale"), stats)[1]
    assert c.kernel_launches == {("K4[stats]" if stats else "K4"): 1}


def test_hooks_cost_one_check_without_a_counter():
    q, k, v = _qkv()
    assert costmodel.kernel_work("K1", k1_cost, q, k, v, True) is \
        costmodel._NULL
    with CostCounter():
        assert costmodel.kernel_work("K1", k1_cost, q, k, v, True) is not \
            costmodel._NULL


# -- the hot loops: scoring, decode, replay, kill switch, failures ----------

def _bundle():
    return ModelBundle.init("ConvNetCIFAR10", {"widths": [4, 8, 8],
                                               "dense_width": 16,
                                               "dtype": "float32"},
                            seed=0, input_shape=(1, 16, 16, 3))


def _score(tmp_path, name, model=None, n_rows=24):
    model = model or TPUModel(_bundle(), device="cpu", inputCol="image",
                              outputCol="s", miniBatchSize=16)
    d = str(tmp_path / name)
    with run_telemetry(d) as rt:
        model.transform(DataTable({"image": np.zeros((n_rows, 16, 16, 3),
                                                     np.uint8)}))
        text = prometheus_text(rt)
    with open(os.path.join(d, "run_summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(d, "run.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return model, summary["programs"], events, text


def test_scoring_row_probe_and_exposition(tmp_path):
    model, progs, events, text = _score(tmp_path, "run")
    key = "tpu_model:(16, 16, 16, 3):uint8"
    row = progs[key]
    assert row["flops"] == perf.forward_flops(model.bundle, (16, 16, 16, 3),
                                              np.uint8)
    assert row["bytes_accessed"] > 0 and row["kernel_flops"] == 0
    # the first batch was counted, the second timed; the probe is the step
    assert row["executions"] == 1 and row["step_basis"] == "probe"
    assert row["step_s"] > 0
    assert [e["attrs"]["program"] for e in events
            if e.get("name") == "program_cost"] == ["(16, 16, 16, 3):uint8"]
    assert [e["attrs"]["shape_class"] for e in events
            if e.get("name") == "recompile"] == ["(16, 16, 16, 3):uint8"]
    assert any(e.get("type") == "programs" for e in events)
    for metric in ("program_step_seconds", "program_flops",
                   "program_bytes_accessed"):
        assert f"# TYPE mmlspark_tpu_{metric} gauge" in text
        assert f"# HELP mmlspark_tpu_{metric}" in text
    assert "mmlspark_tpu_program_mfu" not in text   # no peaks on the CPU
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$')
    for line in text.strip().splitlines():
        assert line.startswith("#") or sample.match(line), line


def test_warm_model_replays_its_rows(tmp_path):
    model, _, _, _ = _score(tmp_path, "run1")
    _, progs, events, _ = _score(tmp_path, "run2", model=model)
    row = progs["tpu_model:(16, 16, 16, 3):uint8"]
    assert row["flops"] > 0 and row["executions"] == 2
    assert not any(e.get("name") == "program_cost" for e in events)


def test_kill_switch(tmp_path):
    config.set("MMLSPARK_TPU_COSTMODEL", "0")
    try:
        _, progs, events, _ = _score(tmp_path, "run")
    finally:
        config.set("MMLSPARK_TPU_COSTMODEL", None)
    assert not any(e.get("name") == "program_cost" for e in events)
    row = progs["tpu_model:(16, 16, 16, 3):uint8"]
    assert row["flops"] is None and row["executions"] == 2


def test_count_failure_is_a_logged_noop(tmp_path, monkeypatch):
    def broken(self, *args):
        raise RuntimeError("no cost model")
    monkeypatch.setattr(CostCounter, "_count", broken)
    model, progs, events, _ = _score(tmp_path, "run")
    assert model.transform(DataTable({"image": np.zeros(
        (2, 16, 16, 3), np.uint8)}))["s"].shape == (2, 10)
    row = progs["tpu_model:(16, 16, 16, 3):uint8"]
    assert row["flops"] is None and row["executions"] == 1
    (ev,) = [e for e in events
             if e.get("name") == "program_cost_unavailable"]
    assert "no cost model" in ev["attrs"]["error"]


def test_decode_rows_carry_the_decode_kernel(tmp_path):
    cfg = {"vocab_size": 64, "d_model": 32, "n_heads": 2, "n_layers": 2,
           "max_len": 128, "dtype": "float32"}
    eng = DecodeEngine(ModelBundle.init("TransformerLM", cfg,
                                        seed=0).module("cpu"),
                       12, chunk=16, device="cpu")
    prompts = np.random.default_rng(0).integers(1, 64, (2, 16))
    summaries = []
    for run in ("run1", "run2"):
        with run_telemetry(str(tmp_path / run)) as rt:
            eng.generate(prompts, np.array([16, 9]))
        summaries.append(rt.summary()["programs"])
    seg = "decode:('segment', 2, 32, 32, 11)"
    assert set(summaries[0]) == {"decode:('prefill', 2, 16)", seg}
    row = summaries[0][seg]
    # 11 steps x 2 layers of K4 over the 32-slot window
    assert row["kernel_launches"] == {"K4": 22}
    assert row["kernel_flops"] == 22 * 4 * 2 * 32 * 2 * 16
    assert row["executions"] == 0
    warm = summaries[1][seg]
    assert warm["flops"] == row["flops"] and warm["executions"] == 1
    assert warm["step_basis"] == "device" and warm["step_s"] > 0


# -- the card's peaks ---------------------------------------------------------

def test_peaks_are_never_fabricated(monkeypatch):
    assert perf.device_peak_flops(torch.device("cpu")) is None
    assert perf.device_peak_hbm_bw("cpu") is None
    assert perf.mfu(100.0, 1e9, torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
                       ("NVIDIA A100-SXM4-80GB", (None, None))):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        assert (perf.device_peak_flops(), perf.device_peak_hbm_bw()) == want
    assert perf.mfu(100.0, None) is None
