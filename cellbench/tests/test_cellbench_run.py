"""What a run promises from outside: no card, no result; the result
line's keys; and on a card (marked `cuda`) a short run of a cell."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from cellbench.harness import manifest
from cellbench.tests import tiny

RUN = os.path.join(manifest.HERE, "run.py")


def _run(args, cwd=manifest.ROOT, env=None, timeout=600):
    return subprocess.run([sys.executable, RUN] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})


def test_without_a_card_it_fails_and_prints_no_result():
    out = _run(["--workload", "resnet50.score.b256", "--seed",
                str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
               env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_an_unknown_workload_fails():
    out = _run(["--workload", "no.such.cell", "--seed", "1", "--seconds",
                "1"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_alone_without_the_port_it_fails(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload",
         "resnet50.score.b256", "--seed", "3", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    ctx = tiny.context("gpt2-xl.train.b8s1024", trace=trace, limits={
        "loss_gap": {"limit": 1.0}, "grad_gap": {"limit": 1.0},
        "change_gap": {"limit": 1.0}})
    line = tiny.run(ctx)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = set(line["metrics"])
    if trace:
        assert "breakdown" in line
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert names == {"lm_train.dispatch_ms", "lm_train.stage_ms"}
    else:
        assert names == {"train_tokens_per_s", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line, allow_nan=False))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_scoring_run_on_the_card(card):
    out = _run(["--workload", "resnet50.score.b256", "--seed",
                str(2 ** 33 + 1), "--seconds", "2", "--trace", "0"])
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"score_images_per_s", "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
