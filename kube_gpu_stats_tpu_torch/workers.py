"""Worker scaffolds: the refresh loop behind the daemon's caches, and the
daemon-thread sampler pool.

:class:`PeriodicRefresher` runs ``refresh_once()`` on its own daemon
thread at a fixed cadence, with capped exponential backoff on persistent
failure: the pod-attribution cache, the device-process watcher and the
backend-upgrade watcher build on it.

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
from typing import Callable

from .resilience import BackoffPolicy
from .supervisor import spawn

log = logging.getLogger(__name__)


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
