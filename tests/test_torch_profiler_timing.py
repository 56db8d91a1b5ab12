"""The port's stage timers and profiler (mmlspark_tpu_torch/observe/
timing.py, profiler.py): the stage-timing tree of a Pipeline fit and
transform equals the JAX collector's on the same stage graph (depths,
stages, methods, `total()`, `table()` text); `profile` writes a Chrome
trace that parses and holds the block's annotations; `annotate` is an
inert context without a profiler."""

import json
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu import Pipeline as JaxPipeline
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.ml import TrainClassifier as JaxTrainClassifier
from mmlspark_tpu.ml.learners import NaiveBayes as JaxNaiveBayes
from mmlspark_tpu.observe import stage_timing as jax_stage_timing
from mmlspark_tpu.stages.basic import SelectColumns as JaxSelectColumns
from mmlspark_tpu_torch import DataTable, Pipeline, profile, stage_timing
from mmlspark_tpu_torch.ml import TrainClassifier
from mmlspark_tpu_torch.ml.learners import NaiveBayes
from mmlspark_tpu_torch.observe import annotate
from mmlspark_tpu_torch.observe.timing import StageTimings
from mmlspark_tpu_torch.stages.basic import SelectColumns


def _columns():
    rng = np.random.default_rng(0)
    return {"f0": rng.random(64).astype(np.float32),
            "f1": rng.random(64).astype(np.float32),
            "label": (rng.random(64) > 0.5).astype(np.int32),
            "junk": rng.standard_normal(64).astype(np.float32)}


def _timed(pipeline, table, timing):
    """(depth, stage, method) records of a fit then a transform, and the
    collector with every wall set to its record's index (walls differ
    between runs; the tree and its rendering must not)."""
    with timing() as times:
        model = pipeline.fit(table)
        model.transform(table)
    for i, r in enumerate(times.records):
        assert r["seconds"] >= 0
        r["seconds"] = float(i)
    return [(r["depth"], r["stage"], r["method"]) for r in times.records], \
        times


def test_stage_timing_tree_equals_jax():
    ours, times = _timed(
        Pipeline([SelectColumns(cols=["f0", "f1", "label"]),
                  TrainClassifier(NaiveBayes(device="cpu"),
                                  labelCol="label")]),
        DataTable(_columns()), stage_timing)
    ref, jax_times = _timed(
        JaxPipeline([JaxSelectColumns(cols=["f0", "f1", "label"]),
                     JaxTrainClassifier(model=JaxNaiveBayes(),
                                        labelCol="label")]),
        JaxDataTable(_columns()), jax_stage_timing)
    assert ours == ref
    assert (0, "Pipeline", "fit") in ours
    assert any(d == 1 and s == "TrainClassifier" for d, s, _ in ours)
    assert times.total() == jax_times.total()
    assert times.total("Pipeline") == jax_times.total("Pipeline")
    assert times.table() == jax_times.table()
    assert str(times) == times.table()


def test_stage_timing_inactive_is_silent():
    table = DataTable({"a": np.arange(4.0)})
    assert SelectColumns(cols=["a"]).transform(table).columns == ["a"]
    assert StageTimings().table() == "(no stages timed)"
    # wrapped once, at class creation, for subclasses defined anywhere
    assert SelectColumns.transform.__mmlspark_instrumented__


def test_profile_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profile(str(tmp_path / "trace")) as path:
        with annotate("port.block"):
            (x @ x).sum()
    assert path == os.path.join(str(tmp_path / "trace"), "trace.json")
    with open(path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "port.block" in names
    assert any(str(n).startswith("aten::mm") for n in names)


def test_profile_logs_a_failed_start(tmp_path, monkeypatch, caplog):
    def broken(**kwargs):
        raise RuntimeError("profiler busy")
    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with caplog.at_level("WARNING"):
        with profile(str(tmp_path)) as path:
            ran.append(True)
    assert ran and not os.path.exists(path)
    assert "profiler busy" in caplog.text


def test_annotate_is_inert_without_a_profiler():
    with annotate("nothing.recording"):
        value = torch.ones(3).sum().item()
    assert value == 3.0
    with pytest.raises(ValueError):
        with annotate("still.propagates"):
            raise ValueError("user error")
