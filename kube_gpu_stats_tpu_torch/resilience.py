"""Resilience primitives used on the embedded exporter's path.

The port's copy of two of the reference's primitives, cut to the shapes
the port uses:

- :class:`BackoffPolicy` — capped exponential backoff with
  reset-on-success (the HTTP accept fence's backoff);
- :class:`DeadlineBudget` — a per-tick wall-time budget that child calls
  draw down, so one slow device can't blow the whole tick's deadline.
"""

from __future__ import annotations

import time
from typing import Callable


class BackoffPolicy:
    """Exponential backoff (doubling) with a cap and reset-on-success:
    ``next_delay()`` returns the delay before the next retry and advances
    the attempt counter; ``reset()`` on success."""

    def __init__(self, base: float, cap: float) -> None:
        if base <= 0 or cap < base:
            raise ValueError(f"need 0 < base <= cap (got {base}, {cap})")
        self.base = base
        self.cap = cap
        self.attempts = 0

    def next_delay(self) -> float:
        """The delay to wait before the next attempt:
        ``min(cap, base * 2**attempts)``."""
        delay = self.base
        for _ in range(self.attempts):
            delay *= 2.0
            if delay >= self.cap:
                delay = self.cap
                break
        self.attempts += 1
        return delay

    def reset(self) -> None:
        self.attempts = 0


class DeadlineBudget:
    """A wall-time budget for one tick that child calls draw down.
    Construct at the top of the tick; every subordinate wait takes
    ``take(want)`` — the minimum of what it wants and what's left — so
    the slowest child can only consume the remainder, never push the
    whole tick past its deadline."""

    def __init__(self, total: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._deadline = clock() + total

    def remaining(self) -> float:
        return max(0.0, self._deadline - self._clock())

    def take(self, want: float | None = None) -> float:
        """Seconds a child call may spend: the remaining budget, capped
        at ``want`` when given."""
        left = self.remaining()
        return left if want is None else min(want, left)
