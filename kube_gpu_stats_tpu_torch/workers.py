"""Daemon-thread sampler pool.

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
import queue
import threading
from typing import Callable

from .supervisor import spawn


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
