"""Crash-only component supervisor, and thread birth.

The port's copy of the reference's supervisor. The daemon is a set of
long-lived worker threads: the poll loop, the attribution refresher, the
device-process watcher, the textfile writer, the render warmer. Each
contains its own exceptions, but a thread can still die to a truly
unexpected error or wedge inside a blocking call no timeout covers (a
hung driver call). The supervisor owns a per-component record: an
``is_alive`` probe, an optional heartbeat (components call :meth:`beat`;
the poll loop beats once per tick), and a ``restart`` callable. A watchdog
thread checks every component each interval:

- thread dead (``is_alive`` False) or heartbeat stale past the
  component's ``heartbeat_timeout`` → the component is restarted
  (crash-only: the old thread, if merely wedged, is abandoned to retire
  itself), paced by a :class:`~.resilience.BackoffPolicy` so a component
  that dies on arrival isn't respawned in a hot loop.

Health is a three-state machine per component — ``healthy`` →
``degraded`` (restarted recently, or its circuit breaker is not closed)
→ ``stale`` (hung/dead right now) — exported as ``kts_component_healthy``
(1 / 0.5 / 0), with restarts in ``kts_component_restarts_total`` and
every registered breaker's state in ``kts_breaker_state`` /
``kts_breaker_trips_total``. The same report feeds /healthz's
per-component reasons.

With a flight recorder (``tracer``), each watchdog pass journals a
``component`` event when a component's health state flips and attaches
the recorder's ``breaker_listener`` to every breaker it can see (a
``breaker`` event per transition); a latched restart storm journals a
``thread_restart_storm`` event.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Mapping, Sequence

from . import schema
from .resilience import CLOSED, BackoffPolicy, CircuitBreaker

log = logging.getLogger(__name__)

HEALTHY = "healthy"
DEGRADED = "degraded"
STALE = "stale"

HEALTH_VALUES = {HEALTHY: 1.0, DEGRADED: 0.5, STALE: 0.0}


def spawn(target: Callable, *, name: str, daemon: bool = True,
          args: tuple = (), kwargs: dict | None = None) -> threading.Thread:
    """The one place the port's long-lived threads are born: daemonic and
    named, so each shows under a real name in a stack dump and never
    gates process exit. Returns the (unstarted) thread; callers keep
    their own ``.start()``."""
    return threading.Thread(target=target, name=name, daemon=daemon,
                            args=args, kwargs=kwargs or {})


@dataclasses.dataclass
class ComponentHealth:
    """One row of the health report (also the /healthz body shape)."""

    name: str
    state: str  # healthy | degraded | stale
    reason: str
    restarts: int


class _Component:
    def __init__(self, name: str, *, is_alive: Callable[[], bool],
                 restart: Callable[[], None] | None,
                 heartbeat_timeout: float, backoff: BackoffPolicy,
                 breaker_prefixes: tuple[str, ...],
                 clock: Callable[[], float]) -> None:
        self.name = name
        self.is_alive = is_alive
        self.restart = restart
        self.heartbeat_timeout = heartbeat_timeout
        self.backoff = backoff
        # Breaker names owned by this component (exact, or
        # "<prefix>:<detail>"): attribution owns "kubelet". The
        # component's own name always matches too.
        self.breaker_prefixes = (name,) + tuple(breaker_prefixes)
        self.last_beat = clock()
        self.restarts = 0
        self.last_restart_at: float | None = None
        self.next_restart_at = 0.0
        self.last_reason = ""
        # Restart-storm self-metering: recent restart timestamps inside
        # the storm window, the latch deadline, and the storms-latched
        # counter (kts_thread_restart_storms_total). probe_next marks the
        # first post-hold respawn as THE probe; probing means that probe
        # is outstanding — if the component is hung/dead again before it
        # reads healthy once, the storm re-latches immediately.
        self.restart_times: list[float] = []
        self.storm_until = 0.0
        self.storms = 0
        self.probe_next = False
        self.probing = False


class Supervisor:
    """Watchdog + health registry. Single writer (the watchdog thread)
    for restart bookkeeping; ``beat`` writes one float (GIL-atomic) so
    components never contend on a lock from their hot paths."""

    # A component restarted within this many seconds reads as degraded.
    DEGRADED_HOLD = 60.0

    # Restart-storm latch: STORM_THRESHOLD restarts inside STORM_WINDOW
    # seconds means respawning is hammering, not healing. The latch pauses
    # restarts for STORM_HOLD (the component reads degraded with a
    # 'restart storm' reason), then ONE probe respawn re-tests it; a probe
    # that dies again re-latches immediately.
    STORM_WINDOW = 120.0
    STORM_THRESHOLD = 5
    STORM_HOLD = 300.0

    def __init__(self, *, check_interval: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None) -> None:
        self._check_interval = check_interval
        self._clock = clock
        # Flight recorder (tracing.Tracer): the watchdog pass journals
        # health flips and attaches the breaker-transition listener to
        # every breaker it can see — late-bound providers included, so a
        # lazily created client's breaker journals within one check
        # interval of existing. None = no journaling.
        self._tracer = tracer
        self._last_health: dict[str, str] = {}
        self._components: dict[str, _Component] = {}
        self._breaker_providers: list[
            Callable[[], Mapping[str, CircuitBreaker]]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Self-metrics memo: contribute() replays prepared rows between
        # edges instead of re-probing every component on each publish.
        # The watchdog pass (and any registration) bumps the generation;
        # breakers trip asynchronously, so their live (state, trips)
        # fingerprint is part of the cache key; the check-interval clock
        # bound covers processes that publish without a running watchdog.
        self._state_gen = 0
        self._contrib_cache: tuple[float, int, tuple, tuple] = (
            float("-inf"), -1, (), ())

    # -- registration --------------------------------------------------------

    def register(self, name: str, *, is_alive: Callable[[], bool],
                 restart: Callable[[], None] | None = None,
                 heartbeat_timeout: float = 0.0,
                 backoff: BackoffPolicy | None = None,
                 breaker_prefixes: tuple[str, ...] = ()) -> None:
        """Supervise a component. ``heartbeat_timeout`` 0 means liveness
        only (no hang detection); components with one must call
        :meth:`beat` at least that often. ``restart`` None = report-only.
        ``breaker_prefixes`` names the breakers this component owns (a
        non-closed one reads as degraded): exact name or
        "<prefix>:<detail>"."""
        with self._lock:
            self._components[name] = _Component(
                name, is_alive=is_alive, restart=restart,
                heartbeat_timeout=heartbeat_timeout,
                # Decorrelated jitter on the default restart pacing: a
                # fleet of DaemonSets hitting the same node-level fault
                # must not respawn in lockstep. Tests that need
                # determinism pass their own policy.
                backoff=backoff or BackoffPolicy(
                    base=self._check_interval, cap=60.0, jitter=True),
                breaker_prefixes=breaker_prefixes,
                clock=self._clock)
            self._state_gen += 1

    def register_breaker_provider(
            self, provider: Callable[[], Mapping[str, CircuitBreaker]]
    ) -> None:
        """Expose circuit breakers in the kts_breaker_* self-metrics and
        the health report. Late-bound, resolved at every read: a
        lazily-created client (auto-mode PodResources) appears the
        moment it exists."""
        with self._lock:
            self._breaker_providers.append(provider)
            self._state_gen += 1

    def breakers(self) -> dict[str, CircuitBreaker]:
        with self._lock:
            providers = list(self._breaker_providers)
        merged: dict[str, CircuitBreaker] = {}
        for provider in providers:
            try:
                merged.update(provider())
            except Exception:  # noqa: BLE001 - a provider bug must not
                log.debug("breaker provider failed", exc_info=True)
        return merged

    # -- heartbeats ----------------------------------------------------------

    def beat(self, name: str) -> None:
        component = self._components.get(name)
        if component is not None:
            component.last_beat = self._clock()

    def beater(self, name: str) -> Callable[[], None]:
        """A zero-arg heartbeat closure for wiring into component ctors."""
        return lambda: self.beat(name)

    # -- watchdog ------------------------------------------------------------

    @staticmethod
    def _probe(component: _Component, now: float) -> tuple[bool, bool, str]:
        """(hung, dead, reason) — THE definition of hung/dead, shared by
        the watchdog and the health report so they can never disagree
        about the same component."""
        hung = (component.heartbeat_timeout > 0
                and now - component.last_beat > component.heartbeat_timeout)
        try:
            dead = not component.is_alive()
        except Exception:  # noqa: BLE001 - a probe bug = treat as dead
            dead = True
        reason = ""
        if hung:
            reason = (f"hung: no heartbeat for "
                      f"{now - component.last_beat:.1f}s")
        elif dead:
            reason = "thread dead"
        return hung, dead, reason

    def check_once(self) -> list[str]:
        """One watchdog pass; returns the names restarted (tests)."""
        restarted: list[str] = []
        now = self._clock()
        with self._lock:
            components = list(self._components.values())
        for component in components:
            hung, dead, reason = self._probe(component, now)
            if not (hung or dead):
                # Healthy: an outstanding storm probe SUCCEEDED.
                component.probing = False
                if (component.last_restart_at is not None
                        and now - component.last_restart_at
                        > self.DEGRADED_HOLD):
                    # Survived the hold window since its last restart:
                    # restart pacing resets.
                    component.backoff.reset()
                    component.last_restart_at = None
                continue
            component.last_reason = reason
            if component.restart is None:
                continue
            if now < component.storm_until:
                continue  # storm latch: paused until the probe window
            if component.probing:
                # The post-hold probe respawn is hung/dead again: re-latch
                # IMMEDIATELY (one probe per hold).
                self._latch_storm(component, now)
                continue
            if now < component.next_restart_at:
                continue  # backoff pacing: don't hot-loop a dying component
            log.warning("supervisor: restarting %s (%s; restart #%d)",
                        component.name, reason, component.restarts + 1)
            try:
                component.restart()
            except Exception:  # noqa: BLE001 - a restart bug must not
                # kill the watchdog — and must not COUNT either: nothing
                # was respawned. Only the backoff advances.
                log.exception("supervisor: restart of %s crashed",
                              component.name)
                component.next_restart_at = (
                    now + component.backoff.next_delay())
                continue
            component.restarts += 1
            component.last_restart_at = now
            component.last_beat = now  # grace: the fresh thread starts clean
            component.next_restart_at = now + component.backoff.next_delay()
            restarted.append(component.name)
            if component.probe_next:
                component.probe_next = False
                component.probing = True
            self._meter_storm(component, now)
        self._observe_transitions()
        self._state_gen += 1  # a watchdog pass revalidates contribute()
        return restarted

    def _meter_storm(self, component: _Component, now: float) -> None:
        """Count this restart against the storm window; latch when the
        component is dying on arrival."""
        component.restart_times.append(now)
        component.restart_times = [
            t for t in component.restart_times
            if now - t <= self.STORM_WINDOW]
        if len(component.restart_times) < self.STORM_THRESHOLD:
            return
        self._latch_storm(component, now)

    def _latch_storm(self, component: _Component, now: float) -> None:
        component.storms += 1
        component.storm_until = now + self.STORM_HOLD
        component.restart_times.clear()
        component.probing = False
        component.probe_next = True  # the first post-hold respawn probes
        log.warning(
            "supervisor: %s restart storm — latching degraded, "
            "restarts paused %.0fs, then ONE probe respawn "
            "(storm #%d; last reason: %s)",
            component.name, self.STORM_HOLD, component.storms,
            component.last_reason)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.event(
                "thread_restart_storm",
                f"{component.name}: restart storm #{component.storms}; "
                f"restarts paused {self.STORM_HOLD:.0f}s, then one "
                f"probe respawn ({component.last_reason})",
                component=component.name)

    def _observe_transitions(self) -> None:
        """Journal feed, once per watchdog pass: attach the breaker
        listener to newly seen breakers, and emit a ``component`` event
        whenever a component's health state changed since the last
        pass."""
        tracer = self._tracer
        if tracer is None or not tracer.enabled:
            return
        breakers = self.breakers()
        for breaker in breakers.values():
            if getattr(breaker, "on_transition", None) is None:
                breaker.on_transition = tracer.breaker_listener
        for row in self.health(breakers):
            previous = self._last_health.get(row.name)
            if previous is not None and previous != row.state:
                detail = f"{row.name}: {previous} -> {row.state}"
                if row.reason:
                    detail += f" ({row.reason})"
                tracer.event("component", detail, component=row.name,
                             state=row.state)
            self._last_health[row.name] = row.state

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 - the watchdog must outlive bugs
                log.exception("supervisor check crashed; continuing")
            self._stop.wait(self._check_interval)

    def start(self) -> None:
        self._thread = spawn(self._run, name="supervisor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    # -- health report -------------------------------------------------------

    def health(self, breakers: Mapping[str, CircuitBreaker] | None = None
               ) -> list[ComponentHealth]:
        """Per-component health rows in registration order. ``breakers``
        lets a caller that also needs the mapping resolve the provider
        chain once instead of twice."""
        now = self._clock()
        rows: list[ComponentHealth] = []
        with self._lock:
            components = list(self._components.values())
        if breakers is None:
            breakers = self.breakers()
        open_by_prefix = {
            name: breaker for name, breaker in breakers.items()
            if breaker.state != CLOSED
        }
        for component in components:
            hung, dead, reason = self._probe(component, now)
            if (hung or dead) and now < component.storm_until:
                # Storm-latched: the dead state is known and deliberate —
                # restarts are paused, the probe respawn is scheduled.
                # Degraded (with the storm named), not stale.
                rows.append(ComponentHealth(
                    component.name, DEGRADED,
                    f"restart storm: restarts paused "
                    f"{component.storm_until - now:.0f}s more "
                    f"({component.last_reason})", component.restarts))
                continue
            if hung or dead:
                rows.append(ComponentHealth(
                    component.name, STALE, reason, component.restarts))
                continue
            # Degraded: restarted recently, or a breaker this component
            # owns is not closed.
            tripped = [
                f"breaker {name} {breaker.state}"
                for name, breaker in sorted(open_by_prefix.items())
                if any(name == prefix or name.startswith(prefix + ":")
                       for prefix in component.breaker_prefixes)
            ]
            if (component.last_restart_at is not None
                    and now - component.last_restart_at
                    <= self.DEGRADED_HOLD):
                rows.append(ComponentHealth(
                    component.name, DEGRADED,
                    f"restarted {now - component.last_restart_at:.0f}s ago "
                    f"({component.last_reason})", component.restarts))
            elif tripped:
                rows.append(ComponentHealth(
                    component.name, DEGRADED, "; ".join(tripped),
                    component.restarts))
            else:
                rows.append(ComponentHealth(
                    component.name, HEALTHY, "", component.restarts))
        return rows

    def health_report(self) -> Sequence[tuple[str, str, str]]:
        """(name, state, reason) rows for MetricsServer's /healthz body;
        breakers that belong to no registered component get their own
        rows so an open breaker is visible."""
        breakers = self.breakers()
        rows = [(h.name, h.state, h.reason) for h in self.health(breakers)]
        with self._lock:
            prefixes = [p for c in self._components.values()
                        for p in c.breaker_prefixes]
        for name, breaker in sorted(breakers.items()):
            if any(name == prefix or name.startswith(prefix + ":")
                   for prefix in prefixes):
                continue  # owned: surfaces via its component's row
            state = HEALTHY if breaker.state == CLOSED else DEGRADED
            rows.append((name, state,
                         "" if state == HEALTHY else breaker.describe()))
        return rows

    def contribute(self, builder) -> None:
        """Fold kts_* self-metrics into a SnapshotBuilder (called from
        the poll loop's snapshot build). Cached between edges: the probe
        walk reruns when a watchdog pass or a registration bumped the
        state generation, when any breaker's live (state, trips)
        fingerprint moved, or at most once per check interval."""
        now = self._clock()
        breakers = self.breakers()
        fingerprint = tuple(
            (name, breaker.state_value(), breaker.trips_total)
            for name, breaker in sorted(breakers.items()))
        cached_at, cached_gen, cached_fp, rows = self._contrib_cache
        if (cached_gen != self._state_gen
                or fingerprint != cached_fp
                or now - cached_at >= self._check_interval):
            rows = self._build_contrib_rows(breakers)
            self._contrib_cache = (now, self._state_gen, fingerprint,
                                   rows)
        for spec, value, labels in rows:
            builder.add(spec, value, labels)

    def _build_contrib_rows(self, breakers) -> tuple:
        with self._lock:
            storms = {c.name: c.storms for c in self._components.values()}
        rows: list = []
        for row in self.health(breakers):
            labels = (("component", row.name),)
            rows.append((schema.COMPONENT_HEALTHY,
                         HEALTH_VALUES[row.state], labels))
            # Unconditional, born at 0: increase()-based alerting misses
            # a burst if the series first appears already at N.
            rows.append((schema.COMPONENT_RESTARTS, float(row.restarts),
                         labels))
            rows.append((schema.THREAD_RESTART_STORMS,
                         float(storms.get(row.name, 0)), labels))
        for name, breaker in sorted(breakers.items()):
            labels = (("component", name),)
            rows.append((schema.BREAKER_STATE, breaker.state_value(),
                         labels))
            rows.append((schema.BREAKER_TRIPS, float(breaker.trips_total),
                         labels))
        return tuple(rows)
