"""Injectable clock: the one seam between resilience policies and time.

Every sleep and every deadline read in the resilience layer goes through
the process clock installed here, so tests drive retry backoff, breaker
cooldowns, and chaos stalls with a `VirtualClock` — deterministic and
instantaneous — while production uses the monotonic wall clock.  This is
the same move tf.data's input-pipeline tests make (arXiv:2101.12127):
fault-handling logic is only testable when time is a parameter.
"""

from __future__ import annotations

import time


class Clock:
    """The production clock: monotonic time + real sleeps."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock(Clock):
    """A clock that only moves when slept on — test time, not wall time.

    `sleeps` records every requested sleep so tests can assert on the
    exact backoff schedule a policy produced.
    """

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self.sleeps: list[float] = []

    def monotonic(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        self.sleeps.append(seconds)
        self.now += seconds

    def advance(self, seconds: float) -> None:
        """Move time forward without recording a sleep (external waiting)."""
        self.now += float(seconds)


_clock: Clock = Clock()


def get_clock() -> Clock:
    """The process-wide clock every resilience policy reads."""
    return _clock


def set_clock(clock: Clock) -> Clock:
    """Install a clock (tests: a VirtualClock); returns the previous one."""
    global _clock
    previous = _clock
    _clock = clock
    return previous
