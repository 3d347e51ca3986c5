"""Resilience primitives for every I/O edge of the exporter.

The port's copy of the reference's primitives, cut to the ones the
embedded exporter and the daemon use:

- :class:`BackoffPolicy` — exponential growth with optional decorrelated
  jitter, a cap, and reset-on-success. Used statefully (``next_delay``)
  by the supervisor's restart pacing and the HTTP accept fence, and
  statelessly (``interval_for``) by the refresh loops that track their
  own consecutive-failure counters;
- :class:`CircuitBreaker` — closed / open / half-open with single-probe
  admission, tripped by consecutive failures.
  Wired into the kubelet PodResources client; its state is exported as
  ``kts_breaker_state``;
- :class:`DeadlineBudget` — a per-tick wall-time budget that child calls
  draw down, so one slow device can't blow the whole tick's deadline.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable

# Breaker states. String values are the exported/printed form (/healthz
# reasons, logs); state_value() maps them onto the kts_breaker_state gauge.
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

STATE_VALUES = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class BreakerOpenError(RuntimeError):
    """A call was refused because its circuit breaker is open. Callers
    that distinguish "dependency persistently down" (mark stale, serve
    last-good) from a transient failure catch this type."""


def flatten_error(error: BaseException | str, limit: int = 200) -> str:
    """One line, bounded length, for embedding an error in line-oriented
    surfaces (/healthz component reasons): gRPC RpcError strings are
    multi-line blobs that would corrupt the one-line-per-component
    format."""
    text = " ".join(str(error).split())
    return text if len(text) <= limit else text[:limit - 1] + "…"


class BackoffPolicy:
    """Exponential backoff with a cap, optional decorrelated jitter, and
    reset-on-success.

    - Stateful: ``next_delay()`` returns the delay before the next retry
      and advances the attempt counter; ``reset()`` on success.
    - Stateless: ``interval_for(n)`` maps a caller-maintained
      consecutive-failure count onto a deterministic (jitter-free)
      interval.

    Decorrelated jitter (``jitter=True``): ``delay = min(cap,
    uniform(base, prev * 3))`` — retries from a fleet of daemons hitting
    one dependency decorrelate instead of thundering in lockstep.
    """

    def __init__(self, base: float, cap: float, *,
                 jitter: bool = False) -> None:
        if base <= 0 or cap < base:
            raise ValueError(f"need 0 < base <= cap (got {base}, {cap})")
        self.base = base
        self.cap = cap
        self.jitter = jitter
        self._rng = random.Random()
        self.attempts = 0
        self._prev = base

    def interval_for(self, failures: int) -> float:
        """Deterministic interval for a given consecutive-failure count:
        ``min(cap, base * 2**failures)``. 0 failures = base."""
        if failures <= 0:
            return self.base
        delay = self.base
        for _ in range(failures):
            delay *= 2.0
            if delay >= self.cap:
                return self.cap
        return delay

    def next_delay(self) -> float:
        """Stateful: the delay to wait before the next attempt."""
        if self.jitter:
            delay = min(self.cap,
                        self._rng.uniform(self.base, self._prev * 3))
        else:
            delay = self.interval_for(self.attempts)
        self.attempts += 1
        self._prev = delay
        return delay

    def reset(self) -> None:
        self.attempts = 0
        self._prev = self.base


class CircuitBreaker:
    """Closed / open / half-open circuit breaker with probe admission.

    - CLOSED: every call admitted. Trips to OPEN after
      ``failure_threshold`` consecutive failures.
    - OPEN: calls refused (``allow()`` False) until ``recovery_time``
      has elapsed, then ONE probe is admitted (transition to HALF_OPEN).
    - HALF_OPEN: the probe's outcome decides — success closes the
      breaker (counters reset), failure re-opens it and restarts the
      recovery clock.

    Thread-safe; the lock guards only the counters, never the guarded
    call. ``clock`` is injectable so tests drive recovery without
    sleeping. ``trips_total``, ``last_error`` and ``state`` feed the
    kts_breaker_state and /healthz surfaces.
    """

    def __init__(self, name: str = "", *, failure_threshold: int = 3,
                 recovery_time: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self._failure_threshold = failure_threshold
        self._recovery_time = recovery_time
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started_at = 0.0
        self.consecutive_failures = 0
        self.trips_total = 0
        self.last_error: BaseException | str | None = None

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_value(self) -> float:
        """Numeric encoding for the kts_breaker_state gauge
        (0 closed, 1 half-open, 2 open)."""
        return STATE_VALUES[self.state]

    def describe(self) -> str:
        """One-line human summary for /healthz reasons."""
        with self._lock:
            parts = [self._state]
            if self.trips_total:
                parts.append(f"{self.trips_total} trip(s)")
            if self.last_error is not None:
                parts.append(
                    f"last error: {flatten_error(self.last_error)}")
            return ", ".join(parts)

    # -- admission -----------------------------------------------------------

    def allow(self) -> bool:
        """May a call proceed now? OPEN past recovery_time admits exactly
        one probe (HALF_OPEN); further calls are refused until the probe's
        outcome is recorded."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN:
                if now - self._opened_at >= self._recovery_time:
                    self._state = HALF_OPEN
                    self._probe_inflight = True
                    self._probe_started_at = now
                    return True
                return False
            # HALF_OPEN: one probe at a time — but a probe whose outcome
            # was never recorded must not wedge the breaker here forever:
            # reclaim the slot after a recovery window.
            if (not self._probe_inflight
                    or now - self._probe_started_at >= self._recovery_time):
                self._probe_inflight = True
                self._probe_started_at = now
                return True
            return False

    def guard(self) -> None:
        """``allow()`` or raise :class:`BreakerOpenError` naming the
        breaker."""
        if not self.allow():
            raise BreakerOpenError(
                f"circuit breaker {self.name or '<anonymous>'} is open "
                f"({self.describe()})")

    # -- outcomes ------------------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._state = CLOSED
            self._probe_inflight = False
            self.last_error = None

    def record_failure(self, error: BaseException | str | None = None) -> None:
        with self._lock:
            self.consecutive_failures += 1
            self.last_error = error if error is not None else self.last_error
            if self._state == HALF_OPEN:
                # The probe failed: back to OPEN, recovery clock restarts.
                self._trip()
            elif (self._state == CLOSED and self.consecutive_failures
                  >= self._failure_threshold):
                self._trip()

    def _trip(self) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._probe_inflight = False
        self.trips_total += 1


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
