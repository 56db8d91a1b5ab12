"""Retry policy: exponential backoff with full jitter, bounded by budgets
(the port of `mmlspark_tpu/resilience/retry.py`).

  * exponential backoff `base * 2**(attempt-1)` capped at `max_backoff_s`,
    with FULL jitter (delay drawn uniformly from [0, backoff]);
  * retryable-exception classification: timeouts, connection resets, and
    5xx/408/429 HTTP responses retry; any other 4xx (auth, not-found,
    bad-request) fails fast;
  * a server's `Retry-After` (429/503) overrides the computed backoff for
    that attempt;
  * two deadline budgets: per attempt (`attempt_deadline_s`, offered to
    the callable as its timeout) and in total (`total_deadline_s`).

All time flows through `resilience.clock`, so tests run the schedule on a
VirtualClock with no wall-clock sleeps.  Every attempt and give-up bumps
a counter through `observe.metrics`.  The config names are the JAX
package's (`MMLSPARK_TPU_RETRY_*`).
"""

from __future__ import annotations

import dataclasses
import random
import urllib.error
from typing import Any, Callable, Optional

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.trace import trace_event
from mmlspark_tpu_torch.resilience.clock import Clock, get_clock

RETRY_MAX_ATTEMPTS = config.register(
    "MMLSPARK_TPU_RETRY_MAX_ATTEMPTS", 5,
    "retry policy: attempts before giving up (1 = no retries)", ptype=int)
RETRY_BASE_S = config.register(
    "MMLSPARK_TPU_RETRY_BASE_S", 0.5,
    "retry policy: first backoff interval, doubled per attempt",
    ptype=float)
RETRY_MAX_BACKOFF_S = config.register(
    "MMLSPARK_TPU_RETRY_MAX_BACKOFF_S", 30.0,
    "retry policy: backoff ceiling per attempt", ptype=float)
RETRY_TOTAL_DEADLINE_S = config.register(
    "MMLSPARK_TPU_RETRY_TOTAL_DEADLINE_S", 120.0,
    "retry policy: total budget (sleep + attempts) before giving up",
    ptype=float)
RETRY_ATTEMPT_DEADLINE_S = config.register(
    "MMLSPARK_TPU_RETRY_ATTEMPT_DEADLINE_S", 0.0,
    "retry policy: per-attempt timeout offered to the callable "
    "(0 = the callable's own timeout applies)", ptype=float)


class RetryBudgetExceeded(Exception):
    """All attempts (or the total deadline) were consumed; the last
    underlying error is chained as __cause__."""

    def __init__(self, message: str, attempts: int, elapsed_s: float):
        super().__init__(message)
        self.attempts = attempts
        self.elapsed_s = elapsed_s


def retryable_status(code: int) -> bool:
    """HTTP classification: 5xx and the two transient 4xx (408 request
    timeout, 429 too-many-requests) retry; every other 4xx fails fast."""
    return code in (408, 429) or 500 <= code < 600


def default_classify(exc: BaseException) -> bool:
    """True when `exc` is worth retrying.

    Conservative allow-list: network-shaped transients only.  Unknown
    exception types (ValueError, KeyError, ...) are program bugs, not
    faults — retrying them is noise.
    """
    from mmlspark_tpu_torch.resilience.breaker import CircuitOpenError
    if isinstance(exc, CircuitOpenError):
        return False  # the breaker already said stop calling
    if isinstance(exc, urllib.error.HTTPError):
        return retryable_status(exc.code)
    if isinstance(exc, (TimeoutError, ConnectionError,
                        urllib.error.URLError)):
        return True
    return False


def retry_after_hint(exc: BaseException) -> Optional[float]:
    """Server-requested wait from a 429/503 `Retry-After` header (seconds
    form only; the HTTP-date form is ignored rather than parsed wrong)."""
    if not isinstance(exc, urllib.error.HTTPError):
        return None
    if exc.code not in (429, 503):
        return None
    raw = (exc.headers.get("Retry-After") if exc.headers is not None
           else None)
    if raw is None:
        return None
    try:
        return max(0.0, float(raw.strip()))
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """An immutable retry schedule; `call()` runs a callable under it."""

    max_attempts: int = 5
    base_s: float = 0.5
    max_backoff_s: float = 30.0
    total_deadline_s: float = 120.0
    attempt_deadline_s: float = 0.0    # 0 = callable's own timeout
    classify: Callable[[BaseException], bool] = default_classify
    seed: Optional[int] = None         # None = nondeterministic jitter
    name: str = "retry"                # counter/log namespace

    @staticmethod
    def from_config(name: str = "retry", **overrides) -> "RetryPolicy":
        """A policy from the MMLSPARK_TPU_RETRY_* registry variables."""
        fields = dict(
            max_attempts=int(RETRY_MAX_ATTEMPTS.current()),
            base_s=float(RETRY_BASE_S.current()),
            max_backoff_s=float(RETRY_MAX_BACKOFF_S.current()),
            total_deadline_s=float(RETRY_TOTAL_DEADLINE_S.current()),
            attempt_deadline_s=float(RETRY_ATTEMPT_DEADLINE_S.current()),
            name=name)
        fields.update(overrides)
        return RetryPolicy(**fields)

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Full-jitter delay after failed attempt number `attempt` (1-based)."""
        ceiling = min(self.max_backoff_s,
                      self.base_s * (2.0 ** (attempt - 1)))
        return rng.uniform(0.0, ceiling)

    def call(self, fn: Callable[..., Any], *, breaker=None,
             clock: Optional[Clock] = None,
             on_retry: Optional[Callable[[int, BaseException, float],
                                         None]] = None) -> Any:
        """Run `fn` under this policy.

        `fn` is called as `fn()` or, when `attempt_deadline_s` is set, as
        `fn(timeout=remaining_attempt_budget)`.  A `breaker` (CircuitBreaker)
        gates each attempt and is fed the outcome.  `on_retry(attempt, exc,
        delay)` observes each scheduled retry.
        """
        clock = clock or get_clock()
        rng = random.Random(self.seed)
        start = clock.monotonic()
        attempt = 0
        while True:
            attempt += 1
            if breaker is not None:
                breaker.allow()   # raises CircuitOpenError when open
            inc_counter(f"{self.name}.attempts")
            try:
                if self.attempt_deadline_s > 0:
                    remaining = self.total_deadline_s - (clock.monotonic()
                                                         - start)
                    result = fn(timeout=max(0.001, min(
                        self.attempt_deadline_s, remaining)))
                else:
                    result = fn()
            except BaseException as exc:  # noqa: blanket on purpose —
                # classification decides; non-retryables re-raise below
                if breaker is not None:
                    breaker.record_failure(exc)
                elapsed = clock.monotonic() - start
                if not self.classify(exc):
                    inc_counter(f"{self.name}.non_retryable")
                    trace_event(f"{self.name}.attempt", cat="resilience",
                                attempt=attempt,
                                error=type(exc).__name__,
                                outcome="non_retryable")
                    raise
                if attempt >= self.max_attempts:
                    inc_counter(f"{self.name}.giveup")
                    trace_event(f"{self.name}.attempt", cat="resilience",
                                attempt=attempt,
                                error=type(exc).__name__,
                                outcome="giveup",
                                elapsed_s=round(elapsed, 3))
                    raise RetryBudgetExceeded(
                        f"{self.name}: gave up after {attempt} attempts "
                        f"({elapsed:.1f}s): {exc!r}", attempt,
                        elapsed) from exc
                delay = self.backoff_s(attempt, rng)
                hinted = retry_after_hint(exc)
                if hinted is not None:
                    delay = hinted
                if elapsed + delay > self.total_deadline_s:
                    inc_counter(f"{self.name}.giveup")
                    trace_event(f"{self.name}.attempt", cat="resilience",
                                attempt=attempt,
                                error=type(exc).__name__,
                                outcome="deadline_exceeded",
                                elapsed_s=round(elapsed, 3))
                    raise RetryBudgetExceeded(
                        f"{self.name}: total deadline "
                        f"{self.total_deadline_s:.1f}s exceeded after "
                        f"{attempt} attempts: {exc!r}", attempt,
                        elapsed) from exc
                inc_counter(f"{self.name}.retries")
                trace_event(f"{self.name}.attempt", cat="resilience",
                            attempt=attempt, error=type(exc).__name__,
                            outcome="retry_scheduled",
                            delay_s=round(delay, 3))
                if on_retry is not None:
                    on_retry(attempt, exc, delay)
                get_logger("resilience").debug(
                    "%s: attempt %d failed (%r); retrying in %.2fs",
                    self.name, attempt, exc, delay)
                clock.sleep(delay)
            else:
                if breaker is not None:
                    breaker.record_success()
                if attempt > 1:
                    inc_counter(f"{self.name}.recovered")
                    trace_event(f"{self.name}.attempt", cat="resilience",
                                attempt=attempt, outcome="recovered")
                return result


def retry_call(fn: Callable[..., Any], *, policy: Optional[RetryPolicy] = None,
               **kwargs) -> Any:
    """Convenience: run `fn` under `policy` (default: from config)."""
    return (policy or RetryPolicy.from_config()).call(fn, **kwargs)
