"""Worker scaffolds: the refresh loop behind the daemon's caches, the
push loop behind the senders, the daemon-thread sampler pool, and the
redirect refusal of authed requests and pushes.

:class:`PeriodicRefresher` runs ``refresh_once()`` on its own daemon
thread at a fixed cadence, with capped exponential backoff on persistent
failure: the pod-attribution cache, the device-process watcher and the
backend-upgrade watcher build on it.

:class:`PublishFollower` runs ``push_once()`` after each registry publish,
rate-limited and backed off under failure: the Pushgateway pusher, the
remote writer and the delta publisher build on it, and
:func:`push_opener` is the no-redirect opener they send through.

:class:`DaemonSamplerPool`:

`concurrent.futures.ThreadPoolExecutor` creates non-daemon workers and
registers an interpreter-exit hook that joins them — so one sample call
wedged inside a sick backend (a hung driver call) makes the *process*
unkillable by SIGTERM. The poll loop already abandons wedged futures at the
tick deadline (poll.py stuck-guard); this pool makes the exit path match:
worker threads are daemonic, created directly (never registered with the
futures atexit machinery), so process exit is never gated on a stuck
backend call.

API is the subset of ThreadPoolExecutor the poll loop uses — `submit`
returning real `concurrent.futures.Future` objects, so callers keep their
timeout/cancel semantics, and a `shutdown` that cancels queued work and
never waits (the wedged-backend rationale above).
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
import urllib.request
from typing import Callable

from .resilience import BackoffPolicy
from .supervisor import spawn

log = logging.getLogger(__name__)

_PUSH_OPENER = None


class PeriodicRefresher:
    """Background cache-refresh scaffold shared by the attribution watcher,
    the device-process watcher and the backend-upgrade watcher (never on
    the poll path): daemon thread, ``refresh_once()`` per period, capped
    exponential backoff on persistent failure so a dead dependency isn't
    hammered. Subclasses implement ``refresh_once()`` and maintain
    ``consecutive_failures`` (an exported health counter, which is why
    the policy is consulted statelessly from it)."""

    BACKOFF_CAP_FACTOR = 6.0  # max wait = interval * this

    def __init__(self, refresh_interval: float, thread_name: str,
                 first_refresh_immediately: bool = True) -> None:
        self._interval = refresh_interval
        self._thread_name = thread_name
        self._first_immediately = first_refresh_immediately
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None
        self.consecutive_failures = 0
        self.backoff = BackoffPolicy(
            base=max(refresh_interval, 1e-6),
            cap=max(refresh_interval, 1e-6) * self.BACKOFF_CAP_FACTOR)

    def refresh_once(self) -> None:
        raise NotImplementedError

    def _run(self) -> None:
        if not self._first_immediately:
            # e.g. the backend-upgrade watcher: construction just probed,
            # an immediate re-probe would be a duplicate.
            self._stop_event.wait(self._interval)
        while not self._stop_event.is_set():
            try:
                self.refresh_once()
            except Exception:  # noqa: BLE001 - a raising subclass must not
                # silently kill its watcher thread (stale cache forever);
                # containment lives HERE, once, not in every subclass.
                self.consecutive_failures += 1
                log.warning("%s refresh crashed (%d consecutive)",
                            self._thread_name, self.consecutive_failures,
                            exc_info=True)
            wait = self.backoff.interval_for(self.consecutive_failures)
            self._stop_event.wait(wait)

    def start(self) -> None:
        self._thread = spawn(self._run, name=self._thread_name)
        self._thread.start()

    def thread_alive(self) -> bool:
        """Liveness probe for the supervisor; start() doubles as the
        crash-only restart (fresh thread, retained cache/state)."""
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread:
            self._thread.join(timeout=5)


class NoRedirectHandler(urllib.request.HTTPRedirectHandler):
    """The one redirect-refusal policy, shared by the push senders and
    the authed scrape path (validate.fetch_exposition): a 3xx raises
    instead of being followed — a redirected POST/PUT would degrade into
    a body-less GET, and a followed redirect would forward Authorization
    headers to a cross-origin Location."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        return None


def push_opener():
    """urllib opener for the push senders that REFUSES redirects. The
    default handler converts a redirected POST/PUT into a body-less GET
    (RFC-sanctioned for 301/302), so an auth proxy answering 302 would
    make every push "succeed" while writing nothing — silent total data
    loss counted as pushes_total. A 3xx now raises HTTPError and lands
    in the senders' retryable-failure accounting, where a misconfigured
    receiver is visible. Built once (OpenerDirector.open is safe for
    this concurrent use); both senders push every interval forever."""
    global _PUSH_OPENER
    if _PUSH_OPENER is None:
        _PUSH_OPENER = urllib.request.build_opener(NoRedirectHandler)
    return _PUSH_OPENER


class PublishFollower:
    """Publish-following push scaffold shared by the Pushgateway,
    remote-write and delta senders: wait for a snapshot publish, rate-limit to
    ``min_interval`` (scaled up under consecutive failures via the
    shared resilience.BackoffPolicy, capped — a down receiver is not
    hammered), push, and flush the final snapshot on
    shutdown so stopping isn't a data gap. Defer-never-drop: a publish
    landing inside the interval window is pushed when the window elapses.

    Subclasses implement ``push_once()`` (which must never raise — but a
    bug in it is contained anyway) and maintain ``consecutive_failures``
    — kept as a plain exported counter (the collector_push_* health
    surface reads it) with the interval math delegated to the policy.
    """

    BACKOFF_CAP_FACTOR = 6.0  # max push interval = min_interval * this

    def __init__(self, registry, min_interval: float, thread_name: str) -> None:
        self._registry = registry
        self._min_interval = min_interval
        self._thread_name = thread_name
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None
        self.consecutive_failures = 0
        self.backoff = BackoffPolicy(
            base=max(min_interval, 1e-6),
            cap=max(min_interval, 1e-6) * self.BACKOFF_CAP_FACTOR)
        # Shipping-health counters, exported as collector_push_* self
        # metrics: subclasses bump pushes_total on success and
        # failures_total on retryable failure; dropped_total counts
        # non-retryable payload rejections (remote-write 4xx).
        self.pushes_total = 0
        self.failures_total = 0
        self.dropped_total = 0
        # Optional supervisor heartbeat: the
        # owner sets this to Supervisor.beater(<component>) so a wedge
        # INSIDE push_once (a hung socket no timeout covers) is
        # detected as a hang, not just thread death. Called once per
        # loop iteration, between pushes.
        self.heartbeat: Callable[[], None] | None = None

    def push_once(self) -> None:
        raise NotImplementedError

    def _guarded_push(self) -> None:
        import logging

        try:
            self.push_once()
        except Exception:  # a push bug must not kill the shipping thread
            self.consecutive_failures += 1
            self.failures_total += 1
            logging.getLogger(__name__).exception(
                "%s push crashed; continuing", self._thread_name)

    def superseded(self) -> bool:
        """True when the calling thread is no longer this follower's
        live thread — a respawn replaced it while it was wedged. A
        superseded thread must retire WITHOUT touching
        shared send state again: two loops draining one at-least-once
        cursor (spill queue, remote-write WAL) would race peek/commit
        and skip records. Never-started followers (tests/bench drive
        push_once inline) have no thread and are never superseded."""
        thread = self._thread
        return (thread is not None
                and thread is not threading.current_thread())

    def run_forever(self) -> None:
        import time

        generation = self._registry.generation
        last_push = float("-inf")
        dirty = False
        while not self._stop_event.is_set():
            if self.superseded():
                log.info("%s thread superseded by respawn; retiring",
                         self._thread_name)
                return
            if self.heartbeat is not None:
                self.heartbeat()
            if self._registry.wait_for_publish(generation, timeout=0.2):
                generation = self._registry.generation
                dirty = True
            interval = self.backoff.interval_for(self.consecutive_failures)
            if dirty and time.monotonic() - last_push >= interval:
                self._guarded_push()
                last_push = time.monotonic()
                dirty = False
        if dirty and not self.superseded():
            self._guarded_push()

    def start(self) -> None:
        """Start the push thread (idempotent: a live thread is left
        alone — double-starting would double-drain)."""
        if self.thread_alive():
            return
        self.respawn()

    def respawn(self) -> None:
        """The supervisor's crash-only restart closure: ALWAYS spawns
        a fresh thread — a hung one (the hang the heartbeat detected)
        is abandoned and retires itself at its next superseded() check
        instead of being waited on."""
        self._thread = spawn(self.run_forever, name=self._thread_name)
        self._thread.start()

    def thread_alive(self) -> bool:
        """Liveness probe for the supervisor."""
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread:
            self._thread.join(timeout=5)


class DaemonSamplerPool:
    def __init__(self, max_workers: int, thread_name_prefix: str = "sampler") -> None:
        self._work: queue.SimpleQueue = queue.SimpleQueue()
        self._shutdown = False
        # Guards the shutdown-flag-check-then-enqueue in submit against
        # shutdown's drain-then-sentinel: without it a racing submit could
        # land work behind the sentinels, leaving a Future that never
        # completes (ThreadPoolExecutor's shutdown lock, re-established).
        self._lock = threading.Lock()
        self._threads = [
            spawn(self._worker, name=f"{thread_name_prefix}-{i}")
            for i in range(max_workers)
        ]
        for thread in self._threads:
            thread.start()

    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            future, fn, args = item
            if future.set_running_or_notify_cancel():
                try:
                    future.set_result(fn(*args))
                except BaseException as exc:  # noqa: BLE001 - to the waiter
                    future.set_exception(exc)
            # Idle workers must not pin the last tick's Sample/Future until
            # the next item arrives (cpython's thread.py does the same).
            del item, future, fn, args

    def submit(self, fn: Callable, *args) -> concurrent.futures.Future:
        future: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._shutdown:
                raise RuntimeError("cannot submit after shutdown")
            self._work.put((future, fn, args))
        return future

    def shutdown(self) -> None:
        """Stop the pool without waiting: queued work is cancelled and
        the daemon threads die with the process, which is the whole point
        of this class — a wedged backend call must not wedge teardown
        too."""
        with self._lock:
            self._shutdown = True
            while True:
                try:
                    item = self._work.get_nowait()
                except queue.Empty:
                    break
                if item is not None:  # skip a prior shutdown's sentinel
                    item[0].cancel()  # (shutdown must stay idempotent)
            for _ in self._threads:
                self._work.put(None)
