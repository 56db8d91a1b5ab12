"""Preemption guard: turn SIGTERM into a flag a loop checks at its next
boundary (the port of `PreemptionGuard`, `mmlspark_tpu/resilience/
preemption.py`).

Spot/preemptible capacity gets a SIGTERM with a short grace window before
the plug is pulled.  The guard installs a handler that only sets a flag —
an in-flight kernel or decode segment is never interrupted — and the
serving loop checks the flag at the next segment boundary and drains
(serve/engine.py).

The handler chains to any previously installed SIGTERM handler, and the
guard restores it on exit (context manager), so the framework never
swallows the application's own shutdown hooks.  Installation is skipped
off the main thread (signal.signal would raise) — there the flag can
still be set by `request()` (e.g. a cluster-notice poller).

The JAX module's training half (`Preempted`, `StepWatchdog`,
`HungStepError`) comes with checkpointed training (ROADMAP A5, A11).
"""

from __future__ import annotations

import signal
import threading

from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.trace import trace_event


class PreemptionGuard:
    """Context manager: SIGTERM -> `triggered` flag, restored on exit.

    `install=False` keeps the signal table untouched (the default SIGTERM
    disposition stands) while still providing the flag object for uniform
    loop code."""

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
            "draining")
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
