"""Process-global store health registry.

The port has no segment stores yet. It keeps the process-global registry
of per-store health state machines that every exposition reads
(``kts_store_state``, ``kts_store_lost_records_total``,
``kts_disk_faults_total``): the HTTP accept fence is such a store
(``http-accept``), so every server of the port registers one.
"""

from __future__ import annotations

import errno as errno_mod
import logging
import threading

log = logging.getLogger(__name__)

# -- per-store durability state machine --------------------------

STORE_HEALTHY = "healthy"
STORE_DEGRADED = "degraded"

# Numeric export values for kts_store_state{store} (the
# kts_component_healthy convention: 1 = durable, 0 = degraded).
STORE_STATE_VALUES = {STORE_HEALTHY: 1.0, STORE_DEGRADED: 0.0}

# errno -> degradation reason. Anything else is "io_fault" — still a
# counted degradation, just without a specialized recovery move.
_FAULT_REASONS = {
    errno_mod.ENOSPC: "disk_full",
    errno_mod.EDQUOT: "disk_full",
    errno_mod.EIO: "io_error",
    errno_mod.EROFS: "read_only",
    errno_mod.EACCES: "read_only",
    errno_mod.EPERM: "read_only",
    errno_mod.EMFILE: "fd_exhausted",
    errno_mod.ENFILE: "fd_exhausted",
    # Kernel resource exhaustion on the accept path (socket buffers /
    # memory) — same operator fix class as fd exhaustion (raise the
    # budget, find the leak), and the accept fence fences all four.
    errno_mod.ENOBUFS: "fd_exhausted",
    errno_mod.ENOMEM: "fd_exhausted",
}

def classify_oserror(exc: BaseException) -> tuple[str, str]:
    """(reason, errno name) for one OSError — the single errno
    taxonomy every store and the accept-loop fence share, so
    kts_disk_faults_total{errno} is spelled identically everywhere."""
    err = getattr(exc, "errno", None)
    name = errno_mod.errorcode.get(err, "E_UNKNOWN") if err else "E_UNKNOWN"
    return _FAULT_REASONS.get(err, "io_fault"), name


class StoreHealth:
    """Health state machine for one store (the HTTP accept loop is one).

    Two states: ``healthy`` and ``degraded`` (a local resource fault).
    Thread-safe. Transitions (not repeats) log: one episode of fd
    exhaustion is one warning, and the recovery is one more."""

    def __init__(self, store: str) -> None:
        self.store = store
        self._lock = threading.Lock()
        self.state = STORE_HEALTHY
        self.reason = ""
        self.errno_name = ""
        self.fault_counts: dict[str, int] = {}  # errno name -> faults
        self.lost_records = 0   # records that lost durability (counted!)

    def record_fault(self, exc: BaseException) -> str:
        """Count one OSError against this store and (if not already)
        enter the degraded state. Returns the classified reason. Logs on
        the EPISODE edge only — a new errno class mid-episode logs again
        (the fault changed shape), a repeat of the same one doesn't."""
        reason, name = classify_oserror(exc)
        with self._lock:
            transition = (self.state != STORE_DEGRADED
                          or name != self.errno_name)
            self.state = STORE_DEGRADED
            self.reason = reason
            self.errno_name = name
            self.fault_counts[name] = self.fault_counts.get(name, 0) + 1
        _bump_health_generation()
        if transition:
            log.warning("store %s degraded (%s, %s): %s — counted in "
                        "kts_disk_faults_total; re-armed by the next "
                        "operation that succeeds", self.store, reason,
                        name, exc)
        return reason

    def ok(self) -> None:
        """An operation succeeded: re-arm the store if degraded."""
        with self._lock:
            if self.state == STORE_HEALTHY:
                return
            self.state = STORE_HEALTHY
            reason, name = self.reason, self.errno_name
            self.reason = ""
            self.errno_name = ""
        _bump_health_generation()
        log.warning("store %s recovered after %s (%s)", self.store, reason,
                    name)

    def status(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "fault_counts": dict(self.fault_counts),
                    "lost_records": self.lost_records}


# Module registry: one StoreHealth per store label, shared by every store
# of the process so kts_store_* is exported without per-subsystem
# plumbing (the quarantine_counts pattern).
_store_lock = threading.Lock()
_stores: dict[str, StoreHealth] = {}

# Edge-stamped health generation: bumped on every edge that
# changes what store_report()/contribute_store_metrics would emit — a
# new store registering, a fault recorded (state + per-errno counts), a
# recovery, records losing durability, or the test-hook reset. Publish
# paths compare this against a cached stamp instead of walking the
# registry: a quiet publish is one GIL-atomic int read.
_health_gen = 1


def health_generation() -> int:
    """Monotone stamp of the store registry's emitted state. Reading it
    is GIL-atomic by design (no lock): the per-publish fast path."""
    return _health_gen


def _bump_health_generation() -> None:
    global _health_gen
    with _store_lock:
        _health_gen += 1


def store_health(store: str) -> StoreHealth:
    """Get-or-create the durability state machine for one store label
    ('energy', 'ingest', 'spill', 'remote-write shard 0', ...)."""
    global _health_gen
    with _store_lock:
        health = _stores.get(store)
        if health is None:
            health = _stores[store] = StoreHealth(store)
            _health_gen += 1  # a new store appears in the report
        return health


def store_report() -> dict[str, dict]:
    """store label -> status dict."""
    with _store_lock:
        stores = list(_stores.items())
    return {store: health.status() for store, health in stores}


def reset_store_stats() -> None:
    """Test hook: the registry is process-global, and suites assert
    exact counts/states."""
    global _health_gen
    with _store_lock:
        _stores.clear()
        _health_gen += 1
