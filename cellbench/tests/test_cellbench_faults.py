"""`correct` comes out false when the timed path is broken underneath, and
for the control, with each cell's own limits.

The runs skip the look for a card and drive the rest of a run on the CPU
at the cells' tiny sizes (`tiny.py`), the program computing in float32
so that a sound run reads round-off alone.  Faults: a step that leaves
the state unchanged; half of each batch left out, the loss the mean over
the rest; a scoring answer altered where it is produced.  The control is
the reference in fp8 in the program's place."""

import copy

import pytest
import torch

from cellbench import calibrate
from cellbench.harness import compare, manifest
from cellbench.tests import tiny

TRAIN = ["gpt2-xl.train.b8s1024", "resnet50.train.b256"]


def _f32(workload: str):
    ctx = tiny.context(workload, seed=2 ** 32 + 11)
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["program"]["model_config"]["dtype"] = "float32"
    return ctx


@pytest.mark.parametrize("workload", TRAIN + ["resnet50.score.b256"])
def test_a_sound_run_is_correct(workload):
    assert tiny.run(_f32(workload))["correct"] is True


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(workload, monkeypatch):
    from mmlspark_tpu_torch.train import optim

    def update(self, grads, state, params, return_updates=False):
        self.updates(grads, state, params)   # moments move, weights do not
        state["count"] += 1

    monkeypatch.setattr(optim.Optimizer, "update", update)
    line = tiny.run(_f32(workload))
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out(workload, monkeypatch):
    from mmlspark_tpu_torch.train import trainer
    make = trainer.make_loss

    def make_loss(kind):
        loss = make(kind)

        def half(logits, labels, mask, denom=None):
            n = labels.shape[0] // 2
            return loss(logits[:n], labels[:n], mask[:n])
        return half

    monkeypatch.setattr(trainer, "make_loss", make_loss)
    assert tiny.run(_f32(workload))["correct"] is False


def test_a_scoring_answer_altered():
    with calibrate.altered_answers():
        assert tiny.run(_f32("resnet50.score.b256"))["correct"] is False


@pytest.mark.parametrize("workload", TRAIN)
def test_the_training_control_fails(workload):
    ctx = _f32(workload)
    if workload.startswith("gpt2"):
        ctx.config = dict(tiny.GPT2_CONTROL)
        ctx.traffic = dict(tiny.TRAIN_TOKENS_CONTROL)
    drv = manifest.driver("train")
    x, y = drv.pools(ctx)
    rows = {"x": x, "y": y}
    ref = drv.reference_check(ctx, rows)
    low = drv.reference_check(ctx, rows, quant="fp8")
    numbers = compare.train_numbers(
        {"losses": low["losses"], "grad": compare._norms(low["grad"]),
         "grad_tensors": low["grad"], "change": low["change"]}, ref)
    assert compare.verdict(numbers, ctx.limits)[0] is False


def test_the_scoring_control_fails():
    ctx = _f32("resnet50.score.b256")
    drv = manifest.driver("score")
    out = drv.run(ctx)
    numbers = drv.check(ctx, out.record["kept"], out.record["pool"], "fp8")
    assert compare.verdict(numbers, ctx.limits)[0] is False
    assert torch.isfinite(torch.tensor(numbers["score_gap"][0]))
