"""The serving unit of work: one admitted request and its lifecycle (the
port of `mmlspark_tpu/serve/request.py`).

A `Request` exists only AFTER admission (shed traffic raises
`admission.Overloaded` at `submit()` and never allocates state — the
point of shedding is that refused work costs nothing downstream).  From
admission on, the request moves through exactly one of these terminal
statuses:

    ok         completed; `tokens` holds the generation (trimmed after
               the first stop token), possibly `degraded=True` when the
               open breaker routed it to the quantized fallback bundle
    timeout    its deadline passed — cancelled at a segment boundary, or
               finished too late to count
    cancelled  the engine drained (SIGTERM / stop) before it could finish
    error      an internal failure; `detail` carries the reason
    handoff    prefill-tier engines only: the finished KV cache shipped
               to a decode replica (the fleet request is still live)
    shed       router requests only: the retry budget would not place a
               failed request again (HTTP 429)

Deadlines are ABSOLUTE times on the resilience clock
(`resilience.clock.get_clock().monotonic()`), so every piece of deadline
math — admission feasibility, boundary cancellation, drain-by-deadline —
runs on a `VirtualClock` in tests with zero sleeps.  Completion is
signalled through a `threading.Event`; `wait()` is how a front-end thread
parks until the scheduler finishes the row.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

# terminal statuses
OK, TIMEOUT, CANCELLED, ERROR = "ok", "timeout", "cancelled", "error"
# terminal FOR THE PREFILL-TIER ENGINE only: the request's KV cache left
# for a decode replica over the handoff bus; the router's request stays
# open until the decode attempt finishes (serve/handoff.py owns it)
HANDOFF = "handoff"
# the router-only terminal status (the JAX package keeps it in
# serve/router.py): a failed request the retry budget would not let the
# router place again.  The HTTP front end maps it to 429 + Retry-After.
SHED = "shed"

# priority lanes (admission weighted shedding: overload costs the batch
# lane first — docs/serving.md "Prefix reuse & priority lanes")
INTERACTIVE, BATCH = "interactive", "batch"
PRIORITIES = (INTERACTIVE, BATCH)


class Request:
    """One admitted generation request (see module docstring)."""

    __slots__ = ("id", "prompt", "true_len", "bucket", "max_new_tokens",
                 "arrival", "deadline", "priority", "degraded", "tokens",
                 "status", "detail", "finished_at", "span", "trace",
                 "_event", "_progress", "listener")

    def __init__(self, req_id: int, prompt: np.ndarray, bucket: int,
                 max_new_tokens: int, arrival: float, deadline: float,
                 priority: str = INTERACTIVE):
        self.id = req_id
        self.prompt = prompt                  # (true_len,) int32
        self.true_len = int(prompt.shape[0])
        self.bucket = bucket
        self.max_new_tokens = int(max_new_tokens)
        self.arrival = float(arrival)
        self.deadline = float(deadline)
        self.priority = priority              # interactive | batch lane
        self.degraded = False
        self.tokens: list[int] = []           # emitted generation so far
        self.status: Optional[str] = None     # terminal status, None = open
        self.detail: str = ""
        self.finished_at: Optional[float] = None
        self.span = None                      # serve.request trace span
        self.trace = None                     # TraceContext (observe/trace):
        #   minted at router admission (or locally for a bare engine) and
        #   carried across every dispatch attempt and the KV handoff
        self._event = threading.Event()
        self._progress = threading.Condition()
        self.listener = None                  # optional progress callback
        #   (the router bridges attempt progress to its own request)

    @property
    def finished(self) -> bool:
        return self.status is not None

    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

    def finish(self, status: str, now: float, detail: str = "") -> None:
        """Terminal transition (scheduler thread); idempotent — the first
        status wins, so a drain cancel can never overwrite a completion."""
        if self.status is not None:
            return
        self.status = status
        self.detail = detail
        self.finished_at = now
        if self.span is not None:
            self.span.attrs.update(
                status=status, degraded=self.degraded,
                tokens=len(self.tokens),
                latency_s=round(now - self.arrival, 6))
            self.span.finish()
        self._event.set()
        self.note_tokens()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request reaches a terminal status (front-end
        threads; the scheduler never calls this).  True when finished."""
        return self._event.wait(timeout)

    # -- token streaming ---------------------------------------------------
    def note_tokens(self) -> None:
        """Wake streaming waiters (scheduler side, after a segment's
        tokens land in `tokens` or the request finishes)."""
        with self._progress:
            self._progress.notify_all()
        if self.listener is not None:
            self.listener()

    def stream_state(self) -> tuple:
        """(epoch, tokens-so-far, finished) for a chunked-response writer.
        A plain engine request never restarts, so its epoch is always 0;
        the router's request bumps the epoch on failover (the streamed-
        partial caveat in docs/serving.md)."""
        return 0, list(self.tokens), self.finished

    def stream_wait(self, epoch: int, cursor: int,
                    timeout: Optional[float] = None) -> bool:
        """Park until there are tokens past `cursor` (or the request is
        finished); True when progress is visible.  Streaming front-end
        threads call this between chunk flushes."""
        with self._progress:
            if len(self.tokens) > cursor or self.finished:
                return True
            self._progress.wait(timeout)
            return len(self.tokens) > cursor or self.finished
