"""Recovery supervisor: the detect -> react loop around
`Trainer.fit_arrays` (the port of `mmlspark_tpu/train/supervisor.py`).

On a recoverable failure the supervisor

  1. **rolls back** — the next attempt resumes from the newest VALID
     checkpoint (by the raise-before-write contract of the numerics
     halts, the last finite / pre-divergence state);
  2. **applies a RecoveryPolicy** — skip the offending data window (the
     steps between the restore point and the failure advance the step
     number but feed no data), optionally re-fold the data-order RNG
     (`TrainerConfig.rng_fold`) so retried shuffles draw different
     batches, optionally back the learning rate off per recovery;
  3. **resumes** — a fresh Trainer runs from the restored step to the
     configured step count;
  4. **gives up cleanly** — past `max_recoveries` it raises
     `RecoveryBudgetExceeded` with the full timeline, and the newest
     checkpoint on disk is still the last healthy state.

Failures handled: `NonFiniteError`, `DivergenceError`, `HungStepError`.
`Preempted` re-raises by default (the job runner owns restarts); with
`resume_on_preemption=True` the supervisor resumes in-process.

Every decision lands as a `recovery.*` trace event, in the ambient
RunTelemetry's `recovery` list, and in `self.timeline`, with the JAX
package's event names and fields.  Each attempt's Trainer runs on
`device` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.models.bundle import ModelBundle
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.numerics import (DivergenceError,
                                                 NonFiniteError)
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import trace_event
from mmlspark_tpu_torch.resilience.checkpoints import (
    latest_valid_checkpoint, step_of)
from mmlspark_tpu_torch.resilience.preemption import (HungStepError,
                                                      Preempted)
from mmlspark_tpu_torch.train.config import TrainerConfig
from mmlspark_tpu_torch.train.trainer import Trainer


@dataclasses.dataclass
class RecoveryPolicy:
    """What the supervisor does between a failure and the retry.

    max_recoveries        restore-and-resume attempts before giving up
    skip_window_steps     size of the data window skipped, ending at the
                          failing step; None = skip everything since the
                          restore point (every step the probe had not yet
                          cleared is treated as suspect)
    refold_rng            fold the recovery count into the data-order RNG
                          so the retry shuffles different batches past
                          the restore point (TrainerConfig.rng_fold)
    lr_backoff            per-recovery learning-rate multiplier (1 = off)
    resume_on_preemption  resume in-process after Preempted instead of
                          re-raising (chaos drills / runner-less jobs)
    max_preemption_resumes  bound on those (preemptions never consume
                          the failure budget — capacity loss is not a
                          training pathology)
    """

    max_recoveries: int = 3
    skip_window_steps: Optional[int] = None
    refold_rng: bool = True
    lr_backoff: float = 1.0
    resume_on_preemption: bool = False
    max_preemption_resumes: int = 4


class RecoveryBudgetExceeded(RuntimeError):
    """The supervisor exhausted its recovery budget; the last failure is
    chained as __cause__ and `timeline` carries every decision made.
    The newest checkpoint on disk is still the last healthy state (the
    raise-before-write contract held on every attempt)."""

    def __init__(self, recoveries: int, timeline: list):
        self.recoveries = recoveries
        self.timeline = timeline
        super().__init__(
            f"recovery budget exhausted after {recoveries} "
            f"restore-and-resume attempt(s); the newest valid checkpoint "
            f"is the last healthy state — see .timeline for the full "
            f"recovery record")


class RecoverySupervisor:
    """Self-healing wrapper around Trainer.fit_arrays (module docstring).

        sup = RecoverySupervisor(cfg, RecoveryPolicy(max_recoveries=2))
        bundle = sup.fit_arrays(x, y, ckpt_dir="/ckpt")
        sup.timeline   # every failure / rollback / skip-window decision
    """

    def __init__(self, config: TrainerConfig,
                 policy: Optional[RecoveryPolicy] = None, device="cuda"):
        self.config = config
        self.policy = policy or RecoveryPolicy()
        self._device = device
        self.timeline: list[dict] = []
        self.recoveries = 0
        self.preemption_resumes = 0
        self.trainer: Optional[Trainer] = None  # the current attempt's

    # -- timeline ---------------------------------------------------------
    def _record(self, event: str, **attrs) -> dict:
        rec = {"event": event, **attrs}
        self.timeline.append(rec)
        trace_event(f"recovery.{event}", cat="resilience", **attrs)
        run = active_run()
        if run is not None:
            run.record_recovery(rec)
        return rec

    # -- the supervised loop ----------------------------------------------
    def _attempt_config(self) -> TrainerConfig:
        cfg, pol = self.config, self.policy
        if self.recoveries == 0:
            return cfg
        lr = cfg.learning_rate * (pol.lr_backoff ** self.recoveries)
        return dataclasses.replace(
            cfg, learning_rate=lr,
            rng_fold=self.recoveries if pol.refold_rng else cfg.rng_fold)

    @staticmethod
    def _restore_step(ckpt_dir: str) -> int:
        path = latest_valid_checkpoint(ckpt_dir)
        if path is None:
            return 0
        try:
            return step_of(os.path.basename(path))
        except ValueError:  # legacy single-file layout
            return 0

    def fit_arrays(self, x: np.ndarray, y: np.ndarray,
                   ckpt_dir: Optional[str] = None, resume: bool = False,
                   **fit_kw) -> ModelBundle:
        """Train with automatic rollback-recovery; returns the bundle of
        the attempt that completed.  Raises RecoveryBudgetExceeded when
        the policy's budget runs out, or re-raises Preempted when
        in-process preemption resume is not enabled."""
        cfg, pol = self.config, self.policy
        ckpt_dir = ckpt_dir if ckpt_dir is not None else cfg.checkpoint_dir
        if not ckpt_dir:
            raise ValueError(
                "RecoverySupervisor needs a checkpoint directory "
                "(ckpt_dir= or TrainerConfig.checkpoint_dir) — rollback "
                "recovery without a restore point is a restart")
        windows: list[tuple[int, int]] = []
        while True:
            trainer = Trainer(self._attempt_config(), device=self._device)
            self.trainer = trainer
            attempt_resume = resume or self.recoveries > 0 \
                or self.preemption_resumes > 0
            try:
                bundle = trainer.fit_arrays(
                    x, y, ckpt_dir=ckpt_dir, resume=attempt_resume,
                    skip_data_windows=windows or None, **fit_kw)
                self._record("completed",
                             steps=int(bundle.metadata.get("steps", 0)),
                             recoveries=self.recoveries,
                             preemption_resumes=self.preemption_resumes,
                             skipped_windows=len(windows))
                return bundle
            except NonFiniteError as e:
                failure, kind, fail_step = e, "nonfinite", e.step
            except DivergenceError as e:
                failure, kind, fail_step = e, "divergence", e.step
            except HungStepError as e:
                failure, kind, fail_step = e, "hung_step", e.step
            except Preempted as e:
                if not pol.resume_on_preemption:
                    self._record("preempted", step=e.step,
                                 resumed_in_process=False)
                    raise
                self.preemption_resumes += 1
                if self.preemption_resumes > pol.max_preemption_resumes:
                    self._record("gave_up", reason="preemption_budget",
                                 preemption_resumes=self.preemption_resumes
                                 - 1)
                    raise
                self._record("preempted", step=e.step,
                             resumed_in_process=True,
                             resume_no=self.preemption_resumes)
                continue  # capacity loss: resume, no failure budget spent
            # a training-health failure: roll back, apply policy, retry
            restore_step = self._restore_step(ckpt_dir)
            self.recoveries += 1
            inc_counter("recovery.failures")
            self._record("failure", kind=kind, step=fail_step,
                         restore_step=restore_step,
                         recovery=self.recoveries, detail=str(failure))
            if self.recoveries > pol.max_recoveries:
                self._record("gave_up", reason="recovery_budget",
                             recoveries=self.recoveries - 1,
                             budget=pol.max_recoveries)
                get_logger("train").error(
                    "recovery budget (%d) exhausted; newest valid "
                    "checkpoint in %s is the last healthy state",
                    pol.max_recoveries, ckpt_dir)
                raise RecoveryBudgetExceeded(
                    self.recoveries - 1, list(self.timeline)) from failure
            lo = restore_step if pol.skip_window_steps is None else \
                max(restore_step, fail_step - int(pol.skip_window_steps) + 1)
            windows.append((lo, fail_step))
            inc_counter("recovery.rollbacks")
            self._record(
                "recover", recovery=self.recoveries,
                restore_step=restore_step,
                skip_window=[lo, fail_step],
                lr_scale=round(pol.lr_backoff ** self.recoveries, 6),
                rng_fold=self.recoveries if pol.refold_rng else 0)
            get_logger("train").warning(
                "recovery %d/%d: %s at step %d — rolling back to step "
                "%d, skipping data window [%d, %d], resuming",
                self.recoveries, pol.max_recoveries, kind, fail_step,
                restore_step, lo, fail_step)
