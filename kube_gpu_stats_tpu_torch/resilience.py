"""Resilience primitives for every I/O edge of the exporter.

The port's copy of the reference's primitives, cut to the ones the
embedded exporter and the daemon use:

- :class:`BackoffPolicy` — exponential growth with optional decorrelated
  jitter, a cap, and reset-on-success. Used statefully (``next_delay``)
  by the supervisor's restart pacing and the HTTP accept fence, and
  statelessly (``interval_for``) by the refresh loops that track their
  own consecutive-failure counters;
- :class:`CircuitBreaker` — closed / open / half-open with single-probe
  admission, tripped by consecutive failures or (optionally) by the
  failure rate over a window of outcomes. Wired into the kubelet
  PodResources client and the hub's per-target scrape loop; its state is
  exported as ``kts_breaker_state``;
- :class:`TokenBucket` — a rate limiter that refuses without blocking:
  the delta publisher's spill-drain rate;
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

    - CLOSED: every call admitted. Trips to OPEN when either condition
      holds: ``failure_threshold`` consecutive failures, or — when
      ``failure_rate_threshold`` is set — the failure rate over the last
      ``window`` outcomes reaches it (with at least ``window`` outcomes
      observed, so a single early failure can't trip a fresh breaker).
    - OPEN: calls refused (``allow()`` False) until ``recovery_time``
      has elapsed, then ONE probe is admitted (transition to HALF_OPEN).
    - HALF_OPEN: the probe's outcome decides — success closes the
      breaker (counters reset), failure re-opens it and restarts the
      recovery clock.

    Thread-safe; the lock guards only the counters, never the guarded
    call. ``clock`` is injectable so tests drive recovery without
    sleeping. ``trips_total``, ``last_error`` and ``state`` feed the
    kts_breaker_state / doctor-resilience surfaces.

    ``on_transition`` (optional, assigned post-construction) is called
    as ``hook(breaker, old_state, new_state)`` on every state change —
    the flight recorder's journal feed (tracing.Tracer.breaker_listener;
    the supervisor attaches it to every breaker it can see, the hub to
    its per-target breakers). Fired AFTER the lock is released so a
    hook may read breaker state freely; a hook exception is swallowed
    (observer must never break the guarded edge).
    """

    def __init__(self, name: str = "", *, failure_threshold: int = 3,
                 recovery_time: float = 5.0, window: int = 20,
                 failure_rate_threshold: float | None = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self._failure_threshold = failure_threshold
        self._recovery_time = recovery_time
        self._window = max(1, window)
        self._rate_threshold = failure_rate_threshold
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started_at = 0.0
        self._outcomes: list[bool] = []  # rolling window, True = failure
        self.consecutive_failures = 0
        self.trips_total = 0
        self.last_error: BaseException | str | None = None
        # Transition observer (flight recorder). None = no journaling.
        self.on_transition: Callable[["CircuitBreaker", str, str],
                                     None] | None = None

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
        """One-line human summary for doctor / /healthz reasons."""
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
        fire: tuple[str, str] | None = None
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN:
                if now - self._opened_at >= self._recovery_time:
                    self._state = HALF_OPEN
                    self._probe_inflight = True
                    self._probe_started_at = now
                    fire = (OPEN, HALF_OPEN)
                    allowed = True
                else:
                    allowed = False
            # HALF_OPEN: one probe at a time — but a probe whose outcome
            # was never recorded (admitted call abandoned before running,
            # e.g. a queued fetch dropped at a deadline) must not wedge
            # the breaker here forever: reclaim the slot after a
            # recovery window and admit a fresh probe.
            elif (not self._probe_inflight
                    or now - self._probe_started_at >= self._recovery_time):
                self._probe_inflight = True
                self._probe_started_at = now
                allowed = True
            else:
                allowed = False
        if fire is not None:
            self._fire(*fire)
        return allowed

    def guard(self) -> None:
        """``allow()`` or raise :class:`BreakerOpenError` naming the
        breaker — the refuse-fast shape for call sites that propagate
        exceptions anyway."""
        if not self.allow():
            raise BreakerOpenError(
                f"circuit breaker {self.name or '<anonymous>'} is open "
                f"({self.describe()})")

    # -- outcomes ------------------------------------------------------------

    def record_success(self) -> None:
        fire: tuple[str, str] | None = None
        with self._lock:
            self.consecutive_failures = 0
            self._push_outcome(False)
            if self._state != CLOSED:
                fire = (self._state, CLOSED)
                self._state = CLOSED
                self._outcomes.clear()
            self._probe_inflight = False
            self.last_error = None
        if fire is not None:
            self._fire(*fire)

    def record_failure(self, error: BaseException | str | None = None) -> None:
        fire: tuple[str, str] | None = None
        with self._lock:
            self.consecutive_failures += 1
            self._push_outcome(True)
            self.last_error = error if error is not None else self.last_error
            if self._state == HALF_OPEN:
                # The probe failed: back to OPEN, recovery clock restarts.
                fire = self._trip()
            elif self._state != OPEN:
                if self.consecutive_failures >= self._failure_threshold:
                    fire = self._trip()
                elif (self._rate_threshold is not None
                      and len(self._outcomes) >= self._window
                      and (sum(self._outcomes) / len(self._outcomes)
                           >= self._rate_threshold)):
                    fire = self._trip()
        if fire is not None:
            self._fire(*fire)

    def _push_outcome(self, failed: bool) -> None:
        self._outcomes.append(failed)
        if len(self._outcomes) > self._window:
            del self._outcomes[0]

    def _trip(self) -> tuple[str, str]:
        old = self._state
        self._state = OPEN
        self._opened_at = self._clock()
        self._probe_inflight = False
        self.trips_total += 1
        return (old, OPEN)

    def _fire(self, old: str, new: str) -> None:
        hook = self.on_transition
        if hook is None:
            return
        try:
            hook(self, old, new)
        except Exception:  # noqa: BLE001 - observer must not break the edge
            pass


class TokenBucket:
    """Thread-safe token bucket: ``rate`` tokens/second refill up to a
    ``burst`` ceiling; :meth:`try_take` either debits and admits or
    refuses without blocking. The delta publisher's drain limiter (a
    recovering hub is never stampeded by a node's backlog) and the
    admission primitive of the reference hub's ingest shed path, where a
    refusal answers 429/503 with :meth:`retry_after` as the Retry-After
    hint.

    Same injectable-clock discipline as CircuitBreaker (tests never
    sleep); the lock guards only the counter math."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if rate <= 0 or burst <= 0:
            raise ValueError(f"need rate > 0 and burst > 0 "
                             f"(got {rate}, {burst})")
        self.rate = rate
        self.burst = burst
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = burst
        self._stamp = clock()

    def _refill(self, now: float) -> None:
        elapsed = now - self._stamp
        if elapsed > 0:
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._stamp = now

    def try_take(self, tokens: float = 1.0) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True
            return False

    def retry_after(self, tokens: float = 1.0) -> float:
        """Seconds until ``tokens`` will have refilled — the honest
        Retry-After value for a refused caller (a floor, not a
        guarantee: other callers drain the bucket too, which is why the
        shed path pairs this with decorrelated-jitter backoff on the
        publisher side)."""
        with self._lock:
            self._refill(self._clock())
            deficit = tokens - self._tokens
        return max(0.0, deficit / self.rate)




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
