"""Preemption guard and step watchdog (the port of
`mmlspark_tpu/resilience/preemption.py`).

Spot/preemptible capacity gets a SIGTERM with a short grace window before
the plug is pulled.  The guard installs a handler that only sets a flag —
an in-flight step or decode segment is never interrupted — and the loop
checks the flag at its next boundary: the serving loop drains
(serve/engine.py); the training loop writes an emergency checkpoint and
raises `Preempted` (train/trainer.py), and a restart with `resume=True`
continues from it.

The handler chains to any previously installed SIGTERM handler, and the
guard restores it on exit (context manager), so the framework never
swallows the application's own shutdown hooks.  Installation is skipped
off the main thread (signal.signal would raise) — there the flag can
still be set by `request()` (e.g. a cluster-notice poller).

`StepWatchdog` covers the silent death: a wedged device or a stalled
runtime.  It runs one training step on a worker thread with a bounded
wall-clock wait and raises `HungStepError` past the deadline, so the
trainer can checkpoint the last completed state and a supervisor
(train/supervisor.py) can resume.  On a CUDA device a step is an
asynchronous launch sequence: the watched function must end with a
synchronize (the trainer's ends with a CUDA event's), or the watchdog
bounds only the launches.
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Callable, Optional

from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.trace import trace_event


class Preempted(Exception):
    """Training stopped cleanly at a step boundary after SIGTERM; an
    emergency checkpoint for `step` was written to `ckpt_dir`."""

    def __init__(self, step: int, ckpt_dir: Optional[str]):
        super().__init__(
            f"preempted at step {step}; emergency checkpoint in "
            f"{ckpt_dir!r} — restart with resume=True to continue")
        self.step = step
        self.ckpt_dir = ckpt_dir


class HungStepError(RuntimeError):
    """A training step did not complete within the watchdog deadline.  The
    trainer writes a best-effort emergency checkpoint before letting this
    escape; a supervisor restarts and resumes."""

    def __init__(self, step: int, deadline_s: float,
                 ckpt_dir: Optional[str] = None):
        self.step = step
        self.deadline_s = deadline_s
        self.ckpt_dir = ckpt_dir
        msg = (f"training step {step} stalled past the {deadline_s:.1f}s "
               f"watchdog deadline — device/collective likely wedged")
        if ckpt_dir:
            msg += (f"; restart with resume=True against {ckpt_dir} "
                    f"(or run under RecoverySupervisor) to continue")
        super().__init__(msg)


class StepWatchdog:
    """Bounded-wait execution of one training step.

    `run(fn, step)` executes `fn` on a worker thread and waits at most
    `deadline_s` wall seconds; on expiry it raises `HungStepError` and
    abandons the (daemonic) worker.  `fn` must synchronize on the step's
    results, so a launched-but-never-finishing step counts as hung.
    Each run's `abandoned` event is set when the worker is given up on:
    the trainer checks it before launching the step, so a worker that
    wakes past the deadline runs nothing."""

    def __init__(self, deadline_s: float):
        if deadline_s <= 0:
            raise ValueError(
                f"watchdog deadline must be positive, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.abandoned = threading.Event()

    def run(self, fn: Callable[[], Any], step: int,
            ckpt_dir: Optional[str] = None) -> Any:
        result: dict = {}
        error: list = []
        self.abandoned = abandoned = threading.Event()

        def work():
            try:
                result["value"] = fn()
            except BaseException as e:  # surfaced to the caller below
                error.append(e)

        worker = threading.Thread(target=work, daemon=True,
                                  name=f"step-watchdog-{step}")
        worker.start()
        worker.join(self.deadline_s)
        if worker.is_alive():
            abandoned.set()
            inc_counter("watchdog.hung_steps")
            trace_event("watchdog.hung_step", cat="resilience", step=step,
                        deadline_s=self.deadline_s)
            get_logger("resilience").error(
                "watchdog: step %d stalled past %.1fs deadline", step,
                self.deadline_s)
            raise HungStepError(step, self.deadline_s, ckpt_dir)
        if error:
            raise error[0]
        return result["value"]


class PreemptionGuard:
    """Context manager: SIGTERM -> `triggered` flag, restored on exit.

    `install=False` keeps the signal table untouched (no checkpoint dir =
    nowhere to save; the default SIGTERM disposition stands) while still
    providing the flag object for uniform loop code."""

    def __init__(self, install: bool = True):
        self.triggered = False
        self._previous = None
        self._installed = False
        self._install = install

    def request(self) -> None:
        """Flag a preemption without a signal (pollers, tests)."""
        self.triggered = True

    def _handler(self, signum, frame) -> None:
        self.triggered = True
        inc_counter("preempt.sigterm")
        trace_event("preempt.sigterm", cat="resilience")
        get_logger("resilience").warning(
            "SIGTERM received: finishing the in-flight step, then "
            "draining or checkpointing")
        if callable(self._previous):
            self._previous(signum, frame)

    def __enter__(self) -> "PreemptionGuard":
        if (self._install
                and threading.current_thread() is threading.main_thread()):
            self._previous = signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM,
                          self._previous if self._previous is not None
                          else signal.SIG_DFL)
            self._installed = False
        return None
