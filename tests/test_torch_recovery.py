"""The port's fault-tolerant training on the CPU: the cases of the JAX
package's tests/test_recovery.py and tests/test_train.py (checkpoint,
resume, torn files, skip windows, the watchdog, the numerics halts, the
recovery supervisor, async writes, chaos scenarios) that need no mesh,
run on the port's Trainer with a small TransformerLM (the port's one
architecture) in place of the reference's MLP.  A resumed fit equals its
fault-free fit bit for bit here.  Cross-package cases:
tests/test_torch_recovery_parity.py.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Trainer, TrainerConfig, config
from mmlspark_tpu_torch.observe.numerics import (DivergenceError,
                                                 LossSpikeDetector,
                                                 NonFiniteError)
from mmlspark_tpu_torch.observe.telemetry import run_telemetry
from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                 Scenario, reset_chaos,
                                                 run_scenario, set_injector)
from mmlspark_tpu_torch.resilience.checkpoints import (
    checkpoint_meta, latest_valid_checkpoint, list_checkpoints, step_of)
from mmlspark_tpu_torch.resilience.ckpt_writer import (CheckpointWriteError,
                                                       read_checkpoint)
from mmlspark_tpu_torch.resilience.preemption import (HungStepError,
                                                      Preempted,
                                                      StepWatchdog)
from mmlspark_tpu_torch.train import (RecoveryBudgetExceeded,
                                      RecoveryPolicy, RecoverySupervisor)

LM = {"vocab_size": 32, "d_model": 16, "n_heads": 2, "n_layers": 1,
      "max_len": 8, "dtype": "float32", "attn_impl": "flash"}


@pytest.fixture(autouse=True)
def _clean_chaos():
    reset_chaos()
    yield
    reset_chaos()


def lm_data(n=64, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, LM["vocab_size"], (n, seq + 1)).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]


def drill_config(**kw) -> TrainerConfig:
    """4 epochs x 4 steps = 16, a probe and a checkpoint every step."""
    base = dict(
        architecture="TransformerLM", model_config=dict(LM),
        optimizer="momentum", learning_rate=0.05, epochs=4, batch_size=16,
        seed=0, shuffle_each_epoch=False, numerics_cadence=1,
        halt_on_nonfinite=True, checkpoint_every_steps=1)
    base.update(kw)
    return TrainerConfig(**base)


def trainer(cfg) -> Trainer:
    return Trainer(cfg, device="cpu")


def leaves(bundle) -> list:
    out = []

    def walk(node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        else:
            out.append(np.asarray(node))
    walk(bundle.variables)
    return out


def finite(bundle) -> bool:
    return all(np.isfinite(a).all() for a in leaves(bundle))


def bit_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def scripted(*faults):
    previous = set_injector(ChaosInjector(script=list(faults)))
    return lambda: set_injector(previous)


# ----------------------------------------------------- checkpoint/resume ---

def test_checkpoint_save_restore(tmp_path):
    """A fit's final checkpoint restores into a fresh Trainer's state:
    parameters, step and optimizer state equal the fit's."""
    x, y = lm_data()
    cfg = drill_config(epochs=1, numerics_cadence=0,
                       checkpoint_dir=str(tmp_path / "ckpt"))
    t = trainer(cfg)
    bundle = t.fit_arrays(x, y)
    t2 = trainer(cfg)
    state = t2.restore_checkpoint(t2.init_state((1, 8), 4),
                                  str(tmp_path / "ckpt"))
    assert state.step == 4 == bundle.metadata["steps"]
    assert bit_equal(t2.bundle_from_state(state), bundle)
    for a, b in zip(state.opt_state["trace"],
                    t._last_state.opt_state["trace"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,preempt_at", [("momentum", 5), ("adam", 3),
                                             ("adam", 10)])
def test_preemption_resume_matches_fault_free_run(tmp_path, kind,
                                                  preempt_at):
    """A chaos SIGTERM at a step: the fit writes an emergency checkpoint
    and raises Preempted; resume=True finishes with the fault-free run's
    step count, loss history and weights, bit for bit."""
    x, y = lm_data()
    cfg = drill_config(optimizer=kind, numerics_cadence=0,
                       shuffle_each_epoch=True, lr_schedule="cosine",
                       checkpoint_every_steps=4, learning_rate=0.01)
    ref_t = trainer(cfg)
    ref = ref_t.fit_arrays(x, y)
    ckpt = str(tmp_path / "ckpt")
    restore = scripted(Fault("sigterm", step=preempt_at))
    try:
        with pytest.raises(Preempted) as ei:
            trainer(cfg).fit_arrays(x, y, ckpt_dir=ckpt, resume=True)
    finally:
        restore()
    assert ei.value.step == preempt_at + 1 and ei.value.ckpt_dir == ckpt
    resumed_t = trainer(cfg)
    resumed = resumed_t.fit_arrays(x, y, ckpt_dir=ckpt, resume=True)
    assert resumed.metadata["steps"] == ref.metadata["steps"] == 16
    assert resumed_t.history[-1]["loss"] == ref_t.history[-1]["loss"]
    assert bit_equal(resumed, ref)


def test_resume_skips_torn_checkpoint(tmp_path):
    """A torn newest checkpoint is skipped by checksum: the restore falls
    back to the one before it."""
    x, y = lm_data()
    ckpt = str(tmp_path / "ckpt")
    cfg = drill_config(epochs=1, numerics_cadence=0)
    trainer(cfg).fit_arrays(x, y, ckpt_dir=ckpt)
    steps = [s for s, _ in list_checkpoints(ckpt)]
    assert steps == [4, 3, 2]
    newest = list_checkpoints(ckpt)[0][1]
    with open(newest, "r+b") as f:
        f.truncate(10)
    t = trainer(cfg)
    state = t.restore_checkpoint(t.init_state((1, 8), 4), ckpt)
    assert state.step == 3


def test_resume_with_completed_run_is_idempotent(tmp_path):
    """resume=True over a finished run replays nothing and returns the
    same weights."""
    x, y = lm_data()
    ckpt = str(tmp_path / "ckpt")
    cfg = drill_config(epochs=1, numerics_cadence=0)
    first = trainer(cfg).fit_arrays(x, y, ckpt_dir=ckpt)
    again_t = trainer(cfg)
    again = again_t.fit_arrays(x, y, ckpt_dir=ckpt, resume=True)
    assert again.metadata["steps"] == first.metadata["steps"] == 4
    assert again_t.history == []
    assert bit_equal(again, first)


def test_async_snapshot_survives_the_in_place_update(tmp_path):
    """An async save copies the state on its device before returning:
    updating the masters in place right after (as the next step does)
    leaves the written checkpoint at the saved values."""
    cfg = drill_config(epochs=1, numerics_cadence=0)
    t = trainer(cfg)
    state = t.init_state((1, 8), 4)
    t._effective_batch_size = 16
    before = [p.detach().clone() for p in state.params]
    t.save_checkpoint(state, str(tmp_path), step=1, sync=False)
    with torch.no_grad():
        for p in state.params:
            p.add_(1.0)
    t._close_writers()
    path = latest_valid_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "ckpt_0000000001.msgpack"
    assert int(np.asarray(read_checkpoint(None, path)["step"])) == 0
    restored = t.restore_checkpoint(t.init_state((1, 8), 4), str(tmp_path))
    for a, b in zip(restored.params, before):
        assert torch.equal(a, b)


# ------------------------------------------------ the supervisor drills ---

def test_supervisor_nan_rollback_completes_with_timeline(tmp_path):
    """A NaN poisons step 5; the supervisor rolls back to the last finite
    checkpoint, skips the poisoned window and completes the configured
    step count with finite weights and its timeline in
    run_summary.json."""
    x, y = lm_data()
    config.set("MMLSPARK_TPU_CHAOS_NAN_AT_STEP", 5)
    reset_chaos()
    try:
        sup = RecoverySupervisor(drill_config(),
                                 RecoveryPolicy(max_recoveries=2),
                                 device="cpu")
        tel = str(tmp_path / "tel")
        with run_telemetry(tel):
            bundle = sup.fit_arrays(x, y, ckpt_dir=str(tmp_path / "ckpt"))
    finally:
        config.set("MMLSPARK_TPU_CHAOS_NAN_AT_STEP", None)
        reset_chaos()
    assert bundle.metadata["steps"] == 16
    assert finite(bundle)
    assert sup.recoveries == 1
    events = [e["event"] for e in sup.timeline]
    assert events == ["failure", "recover", "completed"]
    assert sup.timeline[0]["kind"] == "nonfinite"
    assert sup.timeline[1]["skip_window"] == [5, 5]
    with open(os.path.join(tel, "run_summary.json")) as f:
        summary = json.load(f)
    assert [e["event"] for e in summary["recovery"]] == events
    assert summary["recovery"][0]["step"] == 5


def test_budget_exhaustion_fails_cleanly_last_finite_newest(tmp_path):
    """More poisons than budget: RecoveryBudgetExceeded carries the
    timeline, and the newest checkpoint on disk is still finite."""
    x, y = lm_data()
    restore = scripted(*[Fault("nan", step=s) for s in (3, 4, 5, 6)])
    try:
        sup = RecoverySupervisor(drill_config(),
                                 RecoveryPolicy(max_recoveries=1),
                                 device="cpu")
        with pytest.raises(RecoveryBudgetExceeded) as ei:
            sup.fit_arrays(x, y, ckpt_dir=str(tmp_path))
    finally:
        restore()
    assert ei.value.recoveries == 1
    assert isinstance(ei.value.__cause__, NonFiniteError)
    assert [e["event"] for e in ei.value.timeline] == \
        ["failure", "recover", "failure", "gave_up"]
    probe = trainer(drill_config())
    restored = probe.restore_checkpoint(probe.init_state((1, 8)),
                                        str(tmp_path))
    assert all(torch.isfinite(p).all() for p in restored.params)


def test_recovery_policy_backoff_and_refold(tmp_path):
    x, y = lm_data()
    restore = scripted(Fault("nan", step=5))
    try:
        sup = RecoverySupervisor(
            drill_config(),
            RecoveryPolicy(max_recoveries=2, lr_backoff=0.5,
                           refold_rng=True), device="cpu")
        bundle = sup.fit_arrays(x, y, ckpt_dir=str(tmp_path))
    finally:
        restore()
    assert bundle.metadata["steps"] == 16
    assert sup.trainer.config.learning_rate == pytest.approx(0.025)
    assert sup.trainer.config.rng_fold == 1
    recover = next(e for e in sup.timeline if e["event"] == "recover")
    assert recover["lr_scale"] == pytest.approx(0.5)
    assert recover["rng_fold"] == 1


def test_supervisor_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint directory"):
        RecoverySupervisor(drill_config(), device="cpu").fit_arrays(
            *lm_data())


def test_divergence_halt_feeds_supervisor(tmp_path):
    """The detector's verdicts, and a halt on divergence: a fit whose
    loss explodes raises DivergenceError at the probe step before the
    step's checkpoint, which the supervisor treats like a NaN."""
    det = LossSpikeDetector(warmup=3, div_consecutive=2)
    for v in (1.0, 1.01, 0.99, 1.0, 1.02):
        assert det.update(v) == "ok"
    assert det.update(50.0) == "spike"
    assert det.update(55.0) == "divergence"
    err = DivergenceError(7, 55.0, det.threshold(), str(tmp_path))
    assert err.step == 7 and "divergence" in str(err)
    # gradient ascent (a negative rate): the loss climbs, finite, until
    # the detector calls it a divergence at step 7, before step 7's
    # checkpoint; the supervisor records the failure by kind
    x, y = lm_data()
    cfg = drill_config(optimizer="sgd", learning_rate=-0.5,
                       halt_on_divergence=True)
    with pytest.raises(DivergenceError) as ei:
        trainer(cfg).fit_arrays(x, y, ckpt_dir=str(tmp_path / "d"))
    assert ei.value.step == 7
    newest = latest_valid_checkpoint(str(tmp_path / "d"))
    assert step_of(os.path.basename(newest)) == 7
    sup = RecoverySupervisor(cfg, RecoveryPolicy(max_recoveries=0),
                             device="cpu")
    with pytest.raises(RecoveryBudgetExceeded) as ei:
        sup.fit_arrays(x, y, ckpt_dir=str(tmp_path / "s"))
    assert isinstance(ei.value.__cause__, DivergenceError)
    assert [(e["event"], e.get("kind")) for e in sup.timeline] == \
        [("failure", "divergence"), ("gave_up", None)]


# ------------------------------------------------------- skip windows ---

def test_skip_window_preserves_step_count_and_skips_data(tmp_path):
    x, y = lm_data()
    cfg = drill_config(checkpoint_every_steps=0, numerics_cadence=0)
    plain = trainer(cfg).fit_arrays(x, y)
    with run_telemetry(None) as rt:
        skipped = trainer(cfg).fit_arrays(x, y, skip_data_windows=[(2, 3)])
    assert plain.metadata["steps"] == skipped.metadata["steps"] == 16
    assert not bit_equal(plain, skipped)
    ev = [r for r in rt.tracer.records()
          if r.get("name") == "train.step_skipped"]
    assert [e["attrs"]["step"] for e in ev] == [2, 3]


def test_rng_fold_changes_shuffle_order_only_when_set():
    x, y = lm_data()
    cfg = drill_config(checkpoint_every_steps=0, numerics_cadence=0,
                       shuffle_each_epoch=True, epochs=2)
    a = trainer(cfg).fit_arrays(x, y)
    b = trainer(cfg).fit_arrays(x, y)
    c = trainer(TrainerConfig(**{**cfg.to_json(), "rng_fold": 1,
                                 "mesh": cfg.mesh})).fit_arrays(x, y)
    assert bit_equal(a, b)
    assert not bit_equal(a, c)


# -------------------------------------------------- hung-step watchdog ---

def test_watchdog_raises_hung_step_and_checkpoints(tmp_path):
    """A chaos hang past step_timeout_s raises HungStepError; the newest
    checkpoint is the last completed step's emergency save."""
    x, y = lm_data()
    restore = scripted(Fault("hang", step=4, seconds=0.5))
    try:
        with pytest.raises(HungStepError) as ei:
            trainer(drill_config(step_timeout_s=0.1,
                                 numerics_cadence=0)).fit_arrays(
                x, y, ckpt_dir=str(tmp_path))
    finally:
        restore()
    assert ei.value.step == 4
    newest = latest_valid_checkpoint(str(tmp_path))
    assert step_of(os.path.basename(newest)) == 4


def test_watchdog_writes_no_checkpoint_when_the_hung_step_launched(
        tmp_path):
    """A step that blocks inside the step function past step_timeout_s
    raises HungStepError but writes no emergency checkpoint: its
    abandoned worker may still update the state in place, so the newest
    checkpoint is the last periodic one."""
    release = threading.Event()

    class SlowStep(Trainer):
        def make_train_step(self):
            inner, calls = super().make_train_step(), [0]

            def step_fn(state, *args):
                calls[0] += 1
                if calls[0] == 6:   # step 5, launched
                    release.wait(10.0)
                return inner(state, *args)
            return step_fn

    x, y = lm_data()
    t = SlowStep(drill_config(step_timeout_s=0.5, numerics_cadence=0,
                              checkpoint_every_steps=2), device="cpu")
    try:
        with pytest.raises(HungStepError) as ei:
            t.fit_arrays(x, y, ckpt_dir=str(tmp_path))
    finally:
        release.set()
    assert ei.value.step == 5
    assert [step for step, _ in list_checkpoints(str(tmp_path))] == [4, 2]
    newest = latest_valid_checkpoint(str(tmp_path))
    assert step_of(os.path.basename(newest)) == 4


def test_supervisor_recovers_from_hung_step(tmp_path):
    x, y = lm_data()
    restore = scripted(Fault("hang", step=4, seconds=0.5))
    try:
        sup = RecoverySupervisor(
            drill_config(step_timeout_s=0.1, numerics_cadence=0),
            RecoveryPolicy(max_recoveries=2), device="cpu")
        bundle = sup.fit_arrays(x, y, ckpt_dir=str(tmp_path))
    finally:
        restore()
    assert bundle.metadata["steps"] == 16
    assert finite(bundle)
    assert sup.timeline[0]["kind"] == "hung_step"


def test_watchdog_off_by_default_and_validates():
    assert drill_config().step_timeout_s == 0.0
    with pytest.raises(ValueError):
        StepWatchdog(0.0)
    assert StepWatchdog(5.0).run(lambda: 42, step=0) == 42
    with pytest.raises(RuntimeError, match="boom"):
        StepWatchdog(5.0).run(lambda: (_ for _ in ()).throw(
            RuntimeError("boom")), step=0)


# ------------------------------------------------- preemption resume ---

def test_supervisor_preemption_reraises_by_default(tmp_path):
    x, y = lm_data()
    config.set("MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", 5)
    reset_chaos()
    try:
        sup = RecoverySupervisor(drill_config(numerics_cadence=0),
                                 device="cpu")
        with pytest.raises(Preempted):
            sup.fit_arrays(x, y, ckpt_dir=str(tmp_path))
    finally:
        config.set("MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", None)
        reset_chaos()
    assert sup.timeline[-1]["event"] == "preempted"
    assert sup.timeline[-1]["resumed_in_process"] is False


def test_supervisor_preemption_resume_in_process(tmp_path):
    x, y = lm_data()
    cfg = drill_config(numerics_cadence=0)
    ref = trainer(cfg).fit_arrays(x, y)
    config.set("MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", 5)
    reset_chaos()
    try:
        sup = RecoverySupervisor(
            cfg, RecoveryPolicy(resume_on_preemption=True), device="cpu")
        bundle = sup.fit_arrays(x, y, ckpt_dir=str(tmp_path))
    finally:
        config.set("MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", None)
        reset_chaos()
    assert bundle.metadata["steps"] == ref.metadata["steps"] == 16
    assert sup.recoveries == 0 and sup.preemption_resumes == 1
    assert bit_equal(bundle, ref)


# -------------------------------------------------- async checkpointing ---

def test_async_matches_sync_final_weights_and_rotation(tmp_path):
    x, y = lm_data()
    outs = {}
    for mode in (True, False):
        d = str(tmp_path / ("async" if mode else "sync"))
        cfg = drill_config(async_checkpointing=mode, numerics_cadence=0,
                           checkpoint_every_steps=2)
        outs[mode] = trainer(cfg).fit_arrays(x, y, ckpt_dir=d)
        assert [s for s, _ in list_checkpoints(d)][0] == 16
        assert latest_valid_checkpoint(d) is not None
    assert bit_equal(outs[True], outs[False])
    with open(latest_valid_checkpoint(str(tmp_path / "async")), "rb") as a, \
            open(latest_valid_checkpoint(str(tmp_path / "sync")), "rb") as b:
        assert a.read() == b.read()


def test_async_writer_failure_surfaces_in_fit(tmp_path):
    x, y = lm_data()
    blocker = tmp_path / "ckpt"
    blocker.write_bytes(b"a file where the directory should be")
    cfg = drill_config(numerics_cadence=0, checkpoint_every_steps=2)
    with pytest.raises(CheckpointWriteError):
        trainer(cfg).fit_arrays(x, y, ckpt_dir=str(blocker))


def test_elastic_meta_written_and_adopted(tmp_path):
    """The meta sidecar carries the JAX Trainer's keys; a resume under
    another configured batch size adopts the saved one and replays the
    same step numbering."""
    x, y = lm_data()
    cfg = drill_config(numerics_cadence=0)
    trainer(cfg).fit_arrays(x, y, ckpt_dir=str(tmp_path))
    meta = checkpoint_meta(latest_valid_checkpoint(str(tmp_path)))
    assert meta == {"step": 16, "data_devices": 1, "model_devices": 1,
                    "process_count": 1, "effective_batch_size": 16,
                    "seed": 0, "rng_fold": 0, "format": 1}
    t = trainer(drill_config(numerics_cadence=0, batch_size=8))
    again = t.fit_arrays(x, y, ckpt_dir=str(tmp_path), resume=True)
    assert t._effective_batch_size == 16
    assert again.metadata["steps"] == 16


# --------------------------------------------------- scenario runner ---

def test_multi_fault_scenario_end_to_end(tmp_path):
    """NaN at one step, a SIGTERM later and a torn sidecar, as one
    scenario: the supervised run absorbs all three and completes."""
    x, y = lm_data()

    def run_fn():
        sup = RecoverySupervisor(
            drill_config(),
            RecoveryPolicy(max_recoveries=3, resume_on_preemption=True),
            device="cpu")
        bundle = sup.fit_arrays(x, y, ckpt_dir=str(tmp_path / "ckpt"))
        return {"outcome": "completed",
                "steps": int(bundle.metadata["steps"]),
                "recoveries": sup.recoveries, "finite": finite(bundle)}

    report = run_scenario(Scenario(
        name="nan_preempt_tear",
        faults=[Fault("nan", step=5), Fault("sigterm", step=11),
                Fault("tear", at_write=3, target="sidecar")],
        expect={"outcome": "completed", "steps": 16, "finite": True,
                "min_recoveries": 1}), run_fn)
    assert report["passed"], report
