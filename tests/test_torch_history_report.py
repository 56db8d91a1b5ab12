"""The port's bench history and run report (mmlspark_tpu_torch/observe/
history.py, report.py) against the JAX modules: equal verdicts, baselines
and CLI exit codes on equal stores, torn files tolerated the same way,
and equal structured reports, text and `--format json` over the
reference's synthetic runs and over a run directory the port's
`run_telemetry` writes."""

import json
import os
import shutil

import numpy as np
import pytest

from mmlspark_tpu.observe import history as jax_history
from mmlspark_tpu.observe import report as jax_report
from mmlspark_tpu_torch import DataTable, TPUModel, run_telemetry
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.observe import history, report
from test_analytics import _REC, _synthetic_run_with_analytics
from test_telemetry import _synthetic_run

FIELDS = ("value", "mfu", "device_mfu", "ragged_tokens_per_sec",
          "windowed_step_ms", "telemetry_overhead", "int8_device_speedup",
          "stage_host_s", "link_h2d_MBps", "train_wall_s", "hbm_bw_util",
          "top1_accuracy", "p99_ms", "unit")


def test_direction_equals_jax():
    for field in FIELDS:
        assert history.direction(field) == jax_history.direction(field)
    assert history.default_store() == jax_history.default_store()


def _stores(tmp_path, values):
    """The same runs appended to one store by each package."""
    paths = []
    for mod, name in ((history, "port"), (jax_history, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        for v in values:
            mod.append_records(path, [{**_REC, "value": v}])
        paths.append(path)
    return paths


def _untimed(entries):
    return [{k: v for k, v in e.items() if k != "ingested_at"}
            for e in entries]


@pytest.mark.parametrize("values,fresh", [
    ([10000.0, 10000.0], {}),                                    # quiet
    ([10000.0, 10050.0], {"value": 8000.0, "steady_step_ms": 1.2}),
    ([10000.0, 13000.0, 9000.0, 12500.0, 9500.0], {"value": 8600.0}),
    ([], {}),                                                    # new
])
def test_judge_equals_jax(tmp_path, values, fresh):
    port_path, jax_path = _stores(tmp_path, values)
    ours = history.load_history(port_path)
    ref = jax_history.load_history(jax_path)
    assert _untimed(ours) == _untimed(ref)
    rec = {**_REC, **fresh}
    assert history.judge(ours, [rec]) == jax_history.judge(ref, [rec])
    assert history.baseline(ours, _REC["metric"], "value") == \
        jax_history.baseline(ref, _REC["metric"], "value")
    rows = history.judge(ours, [rec])
    assert history.render_verdicts(rows) == jax_history.render_verdicts(rows)
    assert history.render_store(ours) == jax_history.render_store(ref)


def test_torn_store_degrades_as_jax(tmp_path):
    port_path, jax_path = _stores(tmp_path, [10000.0, 10000.0])
    for path in (port_path, jax_path):
        with open(path, "a") as f:
            f.write('{"kind": "bench", "run_id": 99, "record": {"met')
            f.write("\nnot json at all\n")
            f.write('{"foreign": "line"}\n')
    ours = history.load_history(port_path)
    assert len(ours) == 2
    assert _untimed(ours) == _untimed(jax_history.load_history(jax_path))
    assert history.append_records(port_path, [dict(_REC)]) == \
        jax_history.append_records(jax_path, [dict(_REC)]) == 3


def test_cli_exit_codes_and_output_equal_jax(tmp_path, capsys):
    bench = tmp_path / "bench.json"
    bench.write_text("backend warning noise\n" + json.dumps(_REC) + "\n")
    regressed = tmp_path / "regressed.json"
    regressed.write_text(json.dumps({**_REC, "value": 8000.0}) + "\n")
    empty = tmp_path / "empty.json"
    empty.write_text("no records here\n")
    script = [["ingest", str(bench)], ["ingest", str(bench)],
              ["check", str(bench), "--strict"],
              ["check", str(regressed)],
              ["check", str(regressed), "--strict"],
              ["check", str(regressed), "--format", "json"],
              ["check", str(empty)], ["show"]]
    runs = {}
    for mod, name in ((history, "port"), (jax_history, "jax")):
        store = str(tmp_path / f"{name}.jsonl")
        codes, outs = [], []
        for argv in script:
            codes.append(mod.main(argv + ["--store", store]))
            out = capsys.readouterr().out
            outs.append(out.replace(store, "<store>"))
        runs[name] = codes, outs
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == [0, 0, 0, 0, 1, 0, 1, 0]
    assert "quiet: every tracked field" in runs["port"][1][1]
    rows = json.loads(runs["port"][1][5])
    assert any(r["verdict"] == "regression" and r["field"] == "value"
               for r in rows)


def _port_run_dir(tmp_path) -> str:
    """A run directory written by the port's run_telemetry: a scoring
    run with its roofline row, recompile event and spans."""
    bundle = ModelBundle.init("ConvNetCIFAR10", {"widths": [4, 8, 8],
                                                 "dense_width": 16,
                                                 "dtype": "float32"},
                              seed=0, input_shape=(1, 16, 16, 3))
    model = TPUModel(bundle, device="cpu", inputCol="image", outputCol="s",
                     miniBatchSize=16)
    d = str(tmp_path / "port_run")
    with run_telemetry(d):
        model.transform(DataTable({"image": np.zeros((40, 16, 16, 3),
                                                     np.uint8)}))
    return d


@pytest.fixture
def runs(tmp_path):
    synthetic = tmp_path / "synthetic"
    analytics = tmp_path / "analytics"
    for d in (synthetic, analytics):
        d.mkdir()
    _synthetic_run(str(synthetic / "run.jsonl"))
    _synthetic_run_with_analytics(str(analytics / "run.jsonl"))
    return {"synthetic": str(synthetic), "analytics": str(analytics),
            "port": _port_run_dir(tmp_path)}


@pytest.mark.parametrize("name", ["synthetic", "analytics", "port"])
def test_report_equals_jax(runs, name, capsys):
    path = runs[name]
    events = report.load_run(path)
    assert events == jax_report.load_run(path)
    for top in (2, 5):
        ours = report.build_report(events, top=top, source=path)
        ref = jax_report.build_report(events, top=top, source=path)
        assert ours == ref
        assert report.render_report(ours) == jax_report.render_report(ref)
    outs = []
    for mod in (report, jax_report):
        for fmt in ("text", "json"):
            assert mod.main([path, "--format", fmt]) == 0
            outs.append(capsys.readouterr().out)
    assert outs[:2] == outs[2:]
    doc = json.loads(outs[1])
    if name == "port":
        (key,) = doc["programs"]
        assert key == "tpu_model:(16, 16, 16, 3):uint8"
        assert doc["programs"][key]["flops"] > 0
        assert "-- roofline: compiled programs (1) --" in outs[0]
        # no peaks on the CPU: no utilization, no verdict, never made up
        assert "verdict: unknown (no device peaks)" in outs[0]
    elif name == "analytics":
        assert "verdict: bandwidth-bound" in outs[0]
    else:
        assert doc["bottleneck"] == "transfer"


def test_torn_port_run_rebuilds_costs_as_jax(runs, tmp_path):
    """A run killed before it sealed its `programs` event: both reports
    rebuild the table from the `program_cost` events alone."""
    torn = tmp_path / "torn"
    torn.mkdir()
    with open(os.path.join(runs["port"], "run.jsonl")) as f:
        lines = [line for line in f
                 if '"type": "programs"' not in line
                 and '"type": "run_end"' not in line]
    (torn / "run.jsonl").write_text("".join(lines) + '{"torn')
    events = report.load_run(str(torn))
    ours = report.build_report(events)
    assert ours == jax_report.build_report(events)
    (row,) = ours["programs"].values()
    assert row["step_basis"] == "probe" and row["flops"] > 0
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert report.main([str(empty)]) == jax_report.main([str(empty)]) == 1
    shutil.rmtree(torn)
