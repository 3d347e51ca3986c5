"""Write-ahead-log discipline shared by every disk-backed store.

The port's copy of the reference's ``wal.py``, whose file formats it
keeps byte for byte: a state file or a segment ring written by one
package reads in the other. Two halves:

- **Atomic JSON state** (:func:`write_state` / :func:`load_newest`):
  full state to ``<path>.wal``, fsync, atomic rename over ``<path>``;
  recovery reads BOTH candidates and the higher monotone ``seq`` wins —
  a crash between the wal's fsync and the rename leaves the NEWER
  fsynced state shadowed behind an older (or absent) main file, and
  loading main alone would restart counters below already-published
  values. Every state dict must carry a ``seq`` the writer increments.
  The energy accountant's checkpoint (``energy.py``) rides it.

- **Bounded binary record log** (:class:`SegmentRing`): an append-only
  ring of CRC-framed segment files in one directory, for a spill queue
  or a remote-write shard's WAL. Appends go to the tail segment
  (fsynced per append by default — these logs exist exactly for the
  crash case); reads drain oldest-first through a persistent cursor;
  when the ring exceeds its byte bound the OLDEST segment is evicted
  whole and the evicted record count is returned to the caller, which
  must count and journal it (bounded loss is a feature only when it is
  accounted). Torn tails (a crash mid-append) are truncated at the
  first bad CRC on recovery, never a raise.

Version skew: a fleet is never upgraded atomically, so every persisted
format here is versioned and every reader follows one rule — **tolerate
the past, quarantine the future, never corrupt either**:

- JSON state carries a mandatory ``version`` stamp (:func:`write_state`
  refuses an unstamped dict). Readers accept any version up to their
  own (older builds simply wrote fewer keys — loaders default-and-warn)
  and **quarantine** a future-major file: moved byte-identical aside to
  ``<path>.skew-v<N>`` (never truncated, never overwritten), so a
  DOWNGRADE can move it back and replay it. The process starts
  degraded-but-running from empty state, and the quarantine is counted
  (:func:`quarantine_counts`, the ``kts_wal_quarantined_total`` source)
  so the degradation is visible, not silent.
- Segment files open with a ``KTSG`` header (container format byte +
  caller-declared payload format byte); headerless files from older
  builds read as legacy payload-v1 — a ring may hold BOTH mid-rollout.
  A segment whose container or payload format is from the future is
  quarantined whole (renamed to ``<seg>.skew``, bytes intact, outside
  the ring's accounting) and recovery continues with the rest of the
  ring.

Local faults: the agent observes exactly the host pathologies — full
disks, I/O errors, read-only remounts, fd exhaustion — it must itself
survive, so every disk-backed store here carries a :class:`StoreHealth`
durability state machine. A local resource fault is a *counted,
journaled, auto-recovering degradation*, never a crash and never a
silent stop:

- **ENOSPC** sheds the OLDEST segment to reclaim space, then enters
  ``degraded(disk_full)``: telemetry continues in-memory, every record
  that lost durability is counted (``kts_store_lost_records_total``).
- **EIO** quarantines the bad tail segment aside (``<seg>.eioq``) and
  re-opens a fresh one; a second failure degrades the store.
- **EROFS** (and permission faults) disable durability with ONE
  journal event — memory-only until the disk returns.
- Every degraded state **probe-recovers automatically**: the next
  durable op after the probe interval is attempted for real, and on
  success the store re-arms durability (journaled). The monotone-
  counter and exactly-once guarantees survive the degraded window —
  checkpoints simply persist less often (in-memory state never
  resets), and the rings' read cursors still commit.

Faults export as ``kts_store_state{store}`` /
``kts_disk_faults_total{store,errno}`` /
``kts_store_lost_records_total{store}`` (module registry, the
quarantine-counts pattern; the HTTP accept fence is the store
``http-accept``), surface at ``/debug/stores`` and in ``doctor
--stores``, and log once per (store, errno) EPISODE — a full disk is
one warning, not one per tick.
"""

from __future__ import annotations

import errno as errno_mod
import json
import logging
import os
import struct
import threading
import time
import zlib

log = logging.getLogger(__name__)

# One record's frame header: wall timestamp (f64), payload byte length
# (u32), crc32 of the payload (u32). A record is readable iff the
# header fits, the length fits the file, and the CRC matches — anything
# else is a torn tail.
_RECORD = struct.Struct("<dII")

# Segment files: <dir>/<prefix>-<seq>.seg, seq monotone per directory.
_SEG_SUFFIX = ".seg"

# Segment container header: magic + container format byte +
# caller-declared payload format byte. Headerless segments (older
# builds) are read as container v0 / payload v1.
_SEG_MAGIC = b"KTSG"
SEGMENT_CONTAINER_VERSION = 1

# Quarantined future-format files: moved byte-identical aside under
# this suffix family, never truncated — a downgrade moves them back.
_SKEW_SUFFIX = ".skew"

# -- quarantine accounting (module-wide, all stores) ------------------------
# One registry for every WAL user in the process so the daemon/hub can
# export kts_wal_quarantined_total{store} and doctor can list what was
# set aside without each subsystem growing its own plumbing.
_quarantine_lock = threading.Lock()
_quarantine_counts: dict[str, int] = {}
_quarantine_events: list[dict] = []
_QUARANTINE_EVENT_CAP = 64


def _note_quarantine(label: str, path: str, aside: str,
                     version) -> None:
    with _quarantine_lock:
        _quarantine_counts[label] = _quarantine_counts.get(label, 0) + 1
        _quarantine_events.append({
            "store": label, "path": path, "aside": aside,
            "version": version,
        })
        del _quarantine_events[:-_QUARANTINE_EVENT_CAP]


def quarantine_counts() -> dict[str, int]:
    """store label -> files quarantined this process — the
    ``kts_wal_quarantined_total{store}`` source."""
    with _quarantine_lock:
        return dict(_quarantine_counts)


def quarantine_events() -> list[dict]:
    """Recent quarantine records (bounded) for /debug and doctor
    surfaces: which file went aside where, and what version it
    claimed."""
    with _quarantine_lock:
        return list(_quarantine_events)


def reset_quarantine_stats() -> None:
    """Test hook: the registry is process-global, and suites assert
    exact counts."""
    with _quarantine_lock:
        _quarantine_counts.clear()
        del _quarantine_events[:]


# -- per-store durability state machine --------------------------

STORE_HEALTHY = "healthy"
STORE_DEGRADED = "degraded"

# Numeric export values for kts_store_state{store} (the
# kts_component_healthy convention: 1 = durable, 0 = degraded).
STORE_STATE_VALUES = {STORE_HEALTHY: 1.0, STORE_DEGRADED: 0.0}

# errno -> degradation reason. Anything else is "io_fault" — still a
# counted, probed degradation, just without a specialized recovery move.
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

# How long a degraded store waits before the next durable op is
# attempted for real (the attempt IS the recovery probe). Short enough
# that a cleared fault re-arms within seconds; long enough that a full
# disk isn't re-stat'd on every 1 Hz tick. Sims/tests lower it via
# set_probe_interval().
DEFAULT_PROBE_INTERVAL = 5.0


def classify_oserror(exc: BaseException) -> tuple[str, str]:
    """(reason, errno name) for one OSError — the single errno
    taxonomy every store and the accept-loop fence share, so
    kts_disk_faults_total{errno} is spelled identically everywhere."""
    err = getattr(exc, "errno", None)
    name = errno_mod.errorcode.get(err, "E_UNKNOWN") if err else "E_UNKNOWN"
    return _FAULT_REASONS.get(err, "io_fault"), name


class StoreHealth:
    """Durability state machine for one disk-backed store.

    Two states: ``healthy`` (durable ops go to disk) and ``degraded``
    (a local resource fault; ops are skipped except for a periodic
    probe, telemetry continues in-memory, loss is counted). Thread-safe
    — checkpoint writers, ring appends and HTTP status readers all
    touch it. Transitions (not repeats) log and journal: one episode of
    a full disk is one warning + one ``disk_fault`` event, and the
    recovery is one ``store_recovered`` event."""

    def __init__(self, store: str, *,
                 clock=time.monotonic,
                 probe_interval: float | None = None) -> None:
        self.store = store
        self._clock = clock
        # Resolved at construction time (not def time) so a sim's
        # set_probe_interval() applies to stores created after it too.
        self.probe_interval = (DEFAULT_PROBE_INTERVAL
                               if probe_interval is None
                               else probe_interval)
        self._lock = threading.Lock()
        self.state = STORE_HEALTHY
        self.reason = ""
        self.errno_name = ""
        self.last_error = ""
        self.fault_counts: dict[str, int] = {}  # errno name -> faults
        self.lost_records = 0   # records that lost durability (counted!)
        self.episodes = 0       # healthy -> degraded transitions
        self.recoveries = 0     # degraded -> healthy transitions
        self.degraded_since: float | None = None
        self._probe_at = 0.0

    # -- fault/recovery edges -------------------------------------------------

    def record_fault(self, exc: BaseException, *, lost: int = 0) -> str:
        """Count one OSError against this store and (if not already)
        enter the degraded state. Returns the classified reason so the
        caller can pick its recovery move (shed / quarantine / stop).
        Logs + journals on the EPISODE edge only — a new errno class
        mid-episode re-journals (the fault changed shape), a repeat of
        the same one doesn't."""
        reason, name = classify_oserror(exc)
        with self._lock:
            transition = (self.state != STORE_DEGRADED
                          or name != self.errno_name)
            if self.state != STORE_DEGRADED:
                self.episodes += 1
                self.degraded_since = self._clock()
            self.state = STORE_DEGRADED
            self.reason = reason
            self.errno_name = name
            self.last_error = str(exc)
            self.fault_counts[name] = self.fault_counts.get(name, 0) + 1
            self.lost_records += lost
            self._probe_at = self._clock() + self.probe_interval
        _bump_health_generation()
        if transition:
            log.warning(
                "store %s degraded (%s, %s): %s — continuing in-memory, "
                "loss counted in kts_store_lost_records_total; durable "
                "ops re-probe every %.0fs and re-arm when the disk "
                "returns", self.store, reason, name, exc,
                self.probe_interval)
            _journal_event(
                "disk_fault",
                f"store {self.store} degraded ({reason}, {name}): {exc}",
                store=self.store, reason=reason, errno=name)
        return reason

    def record_lost(self, n: int = 1) -> None:
        """Count records that lost durability without a fresh OSError
        (memory-only appends while degraded, shed-to-reclaim evictions)."""
        if n <= 0:
            return
        with self._lock:
            self.lost_records += n
        _bump_health_generation()

    def ok(self) -> None:
        """A durable op succeeded: re-arm durability if degraded."""
        with self._lock:
            if self.state == STORE_HEALTHY:
                return
            self.state = STORE_HEALTHY
            reason, name = self.reason, self.errno_name
            self.reason = ""
            self.errno_name = ""
            self.degraded_since = None
            self.recoveries += 1
            self._probe_at = 0.0
        _bump_health_generation()
        log.warning("store %s recovered: durability re-armed after %s "
                    "(%s)", self.store, reason, name)
        _journal_event(
            "store_recovered",
            f"store {self.store} recovered from {reason} ({name}): "
            f"durability re-armed",
            store=self.store, reason=reason, errno=name)

    def allow_io(self) -> bool:
        """Should a durable op be ATTEMPTED right now? Always while
        healthy; while degraded only once per probe interval — that
        attempt is the recovery probe, and its success calls
        :meth:`ok`. A False return means the caller stays on its
        in-memory path (and counts the loss where records are at
        stake)."""
        with self._lock:
            if self.state == STORE_HEALTHY:
                return True
            now = self._clock()
            if now >= self._probe_at:
                self._probe_at = now + self.probe_interval
                return True
            return False

    # -- read side ------------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            out = {
                "state": self.state,
                "reason": self.reason,
                "errno": self.errno_name,
                "last_error": self.last_error,
                "fault_counts": dict(self.fault_counts),
                "lost_records": self.lost_records,
                "episodes": self.episodes,
                "recoveries": self.recoveries,
            }
            if self.degraded_since is not None:
                out["degraded_for_seconds"] = round(
                    max(0.0, self._clock() - self.degraded_since), 3)
            return out


# Module registry: one StoreHealth per store label, shared by every WAL
# user so the daemon/hub export kts_store_* without per-subsystem
# plumbing (the quarantine_counts pattern). The journal hook is set
# once by whoever owns the process's Tracer.
_store_lock = threading.Lock()
_stores: dict[str, StoreHealth] = {}
_journal_tracers: list = []

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
    """store label -> status dict for /debug/stores and doctor
    --stores."""
    with _store_lock:
        stores = list(_stores.items())
    return {store: health.status() for store, health in stores}


def set_journal(tracer) -> None:
    """Wire a flight recorder: disk_fault / store_recovered events
    land in the shared journal (daemon and hub call this at
    construction). SUBSCRIBES rather than replaces — an in-process
    daemon+hub pair (sims, tests) each keep their journal feed; in
    production there is one tracer per process either way. None
    detaches everything (tests)."""
    with _store_lock:
        if tracer is None:
            del _journal_tracers[:]
        elif tracer not in _journal_tracers:
            _journal_tracers.append(tracer)


def _journal_event(kind: str, detail: str, **attrs) -> None:
    with _store_lock:
        tracers = list(_journal_tracers)
    for tracer in tracers:
        try:
            tracer.event(kind, detail, **attrs)
        except Exception:  # noqa: BLE001 - telemetry about telemetry
            log.debug("store journal event failed", exc_info=True)


def set_probe_interval(seconds: float) -> None:
    """Adjust the degraded-probe cadence for every store, existing and
    future (sims/tests; production keeps the default). Pending probe
    deadlines reset so a SHORTER interval applies immediately."""
    global DEFAULT_PROBE_INTERVAL
    DEFAULT_PROBE_INTERVAL = seconds
    with _store_lock:
        for health in _stores.values():
            health.probe_interval = seconds
            health._probe_at = 0.0


def reset_store_stats() -> None:
    """Test hook: the registry is process-global, and suites assert
    exact counts/states."""
    global _health_gen
    with _store_lock:
        _stores.clear()
        _health_gen += 1


def _quarantine_aside(path: str, version, *, label: str,
                      base: str = "") -> str | None:
    """Move a future-format file byte-identical aside (refuse, don't
    corrupt): ``<path>.skew-v<N>`` (or the caller's ``base`` — the
    segment rings park as ``<seg>.skew``), first free numbered variant
    if a previous rollout already parked one — two downgrade accidents
    in a row must keep BOTH files, never clobber the first. Returns
    the aside path, or None when the move itself failed (the file is
    left in place and the caller must NOT overwrite it)."""
    base = base or f"{path}{_SKEW_SUFFIX}-v{version}"
    target = base
    for attempt in range(1, 100):
        if not os.path.exists(target):
            break
        target = f"{base}.{attempt}"
    else:
        log.warning("%s: no free quarantine slot beside %s", label, path)
        return None
    try:
        os.replace(path, target)
    except OSError as exc:
        log.warning("%s: could not quarantine %s aside: %s",
                    label, path, exc)
        return None
    log.warning(
        "%s: %s carries future format version %r (this build understands "
        "older); quarantined byte-identical at %s — starting degraded "
        "from empty state. A downgrade to the writing build can move it "
        "back and replay it.", label, path, version, target)
    _note_quarantine(label, path, target, version)
    return target


# -- atomic JSON state (the checkpoint half) --------------------------------

def write_state(path: str, state: dict, *, label: str = "state",
                version_key: str = "version",
                health: StoreHealth | None = None) -> bool:
    """Write-ahead persist of one JSON state dict: full state to
    ``<path>.wal``, fsync, atomic rename over ``<path>``. Returns False
    on OSError — callers keep their dirty flag set and retry on their
    own cadence.

    Every state dict MUST stamp its format version: an
    unstamped write raises — readers on other builds have no other way
    to decide tolerate-vs-quarantine.

    Durability faults route through the store's
    :class:`StoreHealth` (``health``, defaulting to the registry entry
    for ``label``): an ENOSPC/EIO/EROFS here degrades the store — one
    warning per episode, not one per cadence — and while degraded the
    disk is only re-touched once per probe interval (the skip returns
    False exactly like a failed write, so every caller's dirty-flag
    retry loop doubles as the probe cadence). Checkpoint state lives
    in memory and is rewritten whole on the next success, so a
    degraded window defers persistence without losing records."""
    if version_key not in state:
        raise ValueError(
            f"{label} checkpoint state has no {version_key!r} stamp — "
            f"every wal.py writer must version its format")
    if health is None:
        health = store_health(label)
    if not health.allow_io():
        return False  # degraded: stay off the disk until the probe window
    wal = path + ".wal"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(wal, "w", encoding="utf-8") as handle:
            json.dump(state, handle, separators=(",", ":"))
            handle.flush()
            os.fsync(handle.fileno())
        os.replace(wal, path)
    except OSError as exc:
        health.record_fault(exc)
        return False
    health.ok()
    return True


def read_state(path: str, version: int, *, label: str = "state",
               version_key: str = "version") -> dict | None:
    """One candidate file: None on absent/unreadable/garbage.

    Version rule: a stamp AT OR BELOW ``version`` loads —
    an older build simply wrote fewer keys, and every loader defaults
    the missing ones — while a FUTURE stamp is quarantined
    byte-identical aside (``<path>.skew-v<N>``) and None returned: the
    caller starts degraded from empty state instead of truncating data
    a newer build wrote (a downgrade can move the file back and replay
    it). A non-integer or non-positive stamp is garbage, not skew."""
    try:
        with open(path, encoding="utf-8") as handle:
            state = json.load(handle)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as exc:
        log.warning("%s checkpoint %s unreadable (%s)", label, path, exc)
        return None
    found = state.get(version_key) if isinstance(state, dict) else None
    if not isinstance(found, int) or isinstance(found, bool) or found < 1:
        log.warning("%s checkpoint %s version %r unsupported; ignoring",
                    label, path,
                    found if isinstance(state, dict)
                    else type(state).__name__)
        return None
    if found > version:
        # Refuse-don't-corrupt: this file is from a newer build.
        _quarantine_aside(path, found, label=label)
        return None
    if found < version:
        log.info("%s checkpoint %s is format v%d (this build writes "
                 "v%d): loading with defaults for the newer keys",
                 label, path, found, version)
    return state


def load_newest(path: str, version: int, *, label: str = "state",
                seq_key: str = "seq") -> dict | None:
    """Both candidates (main + ``.wal``), highest ``seq_key`` wins —
    the crash-between-fsync-and-rename recovery rule every WAL user
    shares. The winner's ``seq_key`` IS the max across both candidates,
    so a restarting writer re-seeds its write epoch from the returned
    state directly (:func:`newest_seq` re-reads both files; callers
    that already hold the loaded state never need it)."""
    main = read_state(path, version, label=label)
    wal = read_state(path + ".wal", version, label=label)
    state = main
    if wal is not None and (state is None
                            or wal.get(seq_key, 0) > state.get(seq_key, 0)):
        state = wal
        log.info("%s checkpoint: recovering from the newer .wal (crash "
                 "between fsync and rename)", label)
    return state


def newest_seq(path: str, version: int, *, label: str = "state",
               seq_key: str = "seq") -> int:
    """Highest write epoch across BOTH candidate files (0 when neither
    exists) — what a restarting writer must resume past."""
    best = 0
    for candidate in (path, path + ".wal"):
        state = read_state(candidate, version, label=label)
        if state is not None:
            best = max(best, int(state.get(seq_key, 0)))
    return best


# -- bounded binary record log (the queue half) -----------------------------

class SegmentRing:
    """Bounded, crash-recoverable FIFO of (timestamp, payload) records
    over CRC-framed segment files.

    Single-writer/single-reader by contract (the publisher thread or a
    shard sender owns its ring); the small lock only protects status()
    snapshots from HTTP handler threads. Appends land in the tail
    segment and roll to a new one at ``segment_bytes``; the ring
    evicts whole OLDEST segments once total bytes exceed ``max_bytes``
    (returning the evicted record count so the caller accounts the
    loss). The read cursor (segment seq + record index) persists as a
    tiny JSON state on the :func:`write_state` discipline so a restart
    resumes the drain instead of replaying what was already shipped —
    rate-limited by the caller via :meth:`save_cursor`.
    """

    CURSOR_VERSION = 1

    def __init__(self, directory: str, *, max_bytes: int,
                 segment_bytes: int = 1 << 20, prefix: str = "wal",
                 fsync: bool = True, label: str = "segment-ring",
                 format_version: int = 1) -> None:
        self._dir = directory
        self._max_bytes = max(segment_bytes, max_bytes)
        self._segment_bytes = segment_bytes
        self._prefix = prefix
        self._fsync = fsync
        self._label = label
        # The CALLER's record-payload format: stamped into
        # every new segment's KTSG header beside the container version,
        # and the ceiling this reader accepts — a recovered segment
        # declaring a NEWER payload format is quarantined whole
        # (renamed aside intact; a downgrade replays it) instead of
        # being fed to a decoder that predates it. Headerless segments
        # from pre-versioning builds read as payload v1.
        self._format_version = max(1, int(format_version))
        # Durability state machine: every disk fault in this
        # ring routes through here — counted, journaled, probed. The
        # registry entry is shared with write_state cursor saves so one
        # store has ONE state.
        self.health = store_health(label)
        # Records shed to reclaim space inside the current append()
        # (ENOSPC recovery move) — folded into append's return value so
        # the caller journals the loss exactly like a byte-bound evict.
        self._shed_in_append = 0
        # True when the CURRENT tail segment holds memory-only records
        # the disk file doesn't (a degraded-window append): the next
        # durable write must roll to a FRESH segment first, or the
        # disk file's record indexes desynchronize from memory and a
        # post-crash recovery maps the drain cursor onto the wrong
        # records (skipping a durable, undelivered one uncounted).
        self._tail_gap = False
        self._lock = threading.Lock()
        # seg seq -> [(ts, payload), ...] for every live segment; the
        # tail segment additionally has an open append handle. Records
        # are small relative to max_bytes (frames/requests), so keeping
        # the live window in memory is the simple-and-bounded choice —
        # disk is the crash copy, memory is the working set.
        self._segments: dict[int, list[tuple[float, bytes]]] = {}
        self._sizes: dict[int, int] = {}
        self._tail_seq = 0
        self._tail_handle = None
        self._tail_size = 0
        # Read cursor: first unconsumed record is (cursor_seg,
        # cursor_idx) in segment order.
        self._cursor_seg = 0
        self._cursor_idx = 0
        self._cursor_dirty = False
        self._cursor_epoch = 0
        self.torn_records = 0     # truncated at recovery (crash tails)
        self.evicted_records = 0  # dropped oldest-first at the byte cap
        self.appended_records = 0
        # Future-format segments set aside intact at recovery (version
        # skew after a downgrade) — counted so the degradation is
        # visible in status()/doctor, and per-segment payload formats
        # tracked so mixed-version rings stay diagnosable.
        self.skew_segments = 0
        self._headered: set[int] = set()        # segments with KTSG
        self._payload_versions: dict[int, int] = {}
        # Construction runs on pool workers and handler threads — an
        # unwritable/read-only directory must degrade the store, never
        # propagate and kill the constructing thread.
        try:
            os.makedirs(directory, exist_ok=True)
        except OSError as exc:
            self.health.record_fault(exc)
        self._recover()

    # -- recovery -------------------------------------------------------------

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self._dir, f"{self._prefix}-{seq:08d}"
                            + _SEG_SUFFIX)

    def _cursor_path(self) -> str:
        return os.path.join(self._dir, self._prefix + "-cursor.json")

    def _read_segment(self, path: str) -> tuple[
            list[tuple[float, bytes]], int, int, int]:
        """(records, torn, payload_version, skew_version) for one
        segment file: stop at the first truncated/corrupt record — a
        crash mid-append tears only the tail, and everything before it
        is CRC-proven intact. A ``KTSG`` header names the container
        and payload format versions; a headerless file is a
        pre-versioning build's segment (payload_version 0 here, read
        as payload v1). skew_version > 0 means the segment is from a
        NEWER build — the caller must quarantine it whole, never parse
        past the header."""
        records: list[tuple[float, bytes]] = []
        torn = 0
        try:
            with open(path, "rb") as handle:
                data = handle.read()
        except OSError:
            return records, 1, 0, 0
        pos = 0
        payload_version = 0  # 0 = headerless legacy (reads as v1)
        if data[:4] == _SEG_MAGIC:
            if len(data) < 6:
                return records, 1, SEGMENT_CONTAINER_VERSION, 0
            container_v, payload_v = data[4], data[5]
            if container_v > SEGMENT_CONTAINER_VERSION or \
                    payload_v > self._format_version:
                return records, 0, payload_v, max(container_v, payload_v)
            payload_version = payload_v
            pos = 6
        header = _RECORD.size
        while pos + header <= len(data):
            ts, length, crc = _RECORD.unpack_from(data, pos)
            end = pos + header + length
            if end > len(data):
                torn = 1
                break
            payload = data[pos + header:end]
            if zlib.crc32(payload) != crc:
                torn = 1
                break
            records.append((ts, payload))
            pos = end
        if pos < len(data) and not torn:
            torn = 1
        return records, torn, payload_version, 0

    def _recover(self) -> None:
        seqs = []
        try:
            names = os.listdir(self._dir)
        except OSError as exc:
            # Same audit class as the ctor makedirs: an EIO/EMFILE here
            # must start the ring empty + degraded, not kill the thread.
            self.health.record_fault(exc)
            names = []
        for name in names:
            if name.startswith(self._prefix + "-") and \
                    name.endswith(_SEG_SUFFIX + ".wal"):
                # Orphaned rewrite temp: a crash between a torn-tail
                # rewrite and its os.replace. The .seg it shadowed was
                # (or is about to be) re-recovered from its own intact
                # prefix; the temp would otherwise sit outside the
                # byte accounting forever.
                try:
                    os.unlink(os.path.join(self._dir, name))
                except OSError:
                    pass
                continue
            if name.startswith(self._prefix + "-") and \
                    name.endswith(_SEG_SUFFIX):
                try:
                    seqs.append(int(name[len(self._prefix) + 1:
                                         -len(_SEG_SUFFIX)]))
                except ValueError:
                    continue
        for seq in sorted(seqs):
            path = self._seg_path(seq)
            records, torn, payload_v, skew = self._read_segment(path)
            if skew:
                # A newer build wrote this segment (downgrade in
                # progress): set it aside INTACT — outside the ring's
                # byte accounting, never truncated — and recover the
                # rest of the ring around it. The free-slot probe
                # matters even here: a drained ring restarts its seq
                # numbering, so a SECOND downgrade accident can land
                # the same seq — it must park beside the first file,
                # never over it.
                aside = _quarantine_aside(path, skew, label=self._label,
                                          base=path + _SKEW_SUFFIX)
                if aside is None:
                    continue
                self.skew_segments += 1
                log.warning(
                    "%s: segment %d declares future format v%d (this "
                    "build reads <= container v%d / payload v%d); "
                    "quarantined intact at %s", self._label, seq, skew,
                    SEGMENT_CONTAINER_VERSION, self._format_version,
                    aside)
                continue
            headered = payload_v > 0
            if torn:
                self.torn_records += torn
                # Rewrite the proven-intact prefix so the torn bytes
                # never come back on the NEXT recovery. Headerness is
                # preserved: rewriting a legacy segment WITH a header
                # would turn a later downgrade's recovery of it into a
                # full-segment truncation (the old reader sees the
                # header bytes as a torn first record).
                self._rewrite_segment(
                    seq, records,
                    payload_version=payload_v if headered else 0)
            if headered:
                self._headered.add(seq)
            self._payload_versions[seq] = payload_v if headered else 1
            self._segments[seq] = records
            self._sizes[seq] = sum(_RECORD.size + len(p)
                                   for _t, p in records) + \
                (6 if headered else 0)
        self._tail_seq = max(seqs) if seqs else 0
        cursor = read_state(self._cursor_path(), self.CURSOR_VERSION,
                            label=self._label + " cursor")
        if cursor is not None:
            missing = [key for key in ("segment", "record")
                       if key not in cursor]
            if missing:
                # Older-build cursor with pruned keys:
                # default-and-warn, never a KeyError on
                # the restart path — the clamp below keeps the
                # defaulted cursor inside reality either way.
                log.warning("%s cursor missing %s (older build?); "
                            "defaulting to the oldest record",
                            self._label, ", ".join(missing))
            self._cursor_seg = int(cursor.get("segment", 0))
            self._cursor_idx = int(cursor.get("record", 0))
            self._cursor_epoch = int(cursor.get("seq", 0))
        self._drop_consumed_segments()
        # Clamp a cursor pointing past reality (records torn behind it).
        live = self._live_segments()
        if live:
            first = live[0]
            if self._cursor_seg < first:
                self._cursor_seg, self._cursor_idx = first, 0
            elif self._cursor_seg in self._segments:
                self._cursor_idx = min(
                    self._cursor_idx, len(self._segments[self._cursor_seg]))
        else:
            self._cursor_seg = self._tail_seq
            self._cursor_idx = 0

    def _rewrite_segment(self, seq: int,
                         records: list[tuple[float, bytes]], *,
                         payload_version: int = 0) -> None:
        """payload_version > 0 rewrites with a KTSG header carrying
        it; 0 rewrites headerless (a legacy segment stays readable by
        the build that wrote it, should a downgrade follow)."""
        path = self._seg_path(seq)
        try:
            if not records:
                os.unlink(path)
                return
            tmp = path + ".wal"
            with open(tmp, "wb") as handle:
                if payload_version > 0:
                    handle.write(_SEG_MAGIC
                                 + bytes((SEGMENT_CONTAINER_VERSION,
                                          payload_version)))
                for ts, payload in records:
                    handle.write(_RECORD.pack(ts, len(payload),
                                              zlib.crc32(payload)))
                    handle.write(payload)
                handle.flush()
                os.fsync(handle.fileno())
            os.replace(tmp, path)
        except OSError as exc:
            # Recovery-time rewrite failure: the torn bytes stay on
            # disk (re-truncated on the NEXT recovery); fault counted,
            # never raised off the recovering thread.
            self.health.record_fault(exc)

    # -- write side -----------------------------------------------------------

    def append(self, ts: float, payload: bytes) -> int:
        """Append one record — durably while the store is healthy,
        memory-only (durability loss counted) while it is degraded.
        Returns how many OLDEST records were dropped to stay under the
        byte bound or to reclaim a full disk (0 almost always — the
        caller counts and journals any loss).

        Fault containment: an ENOSPC sheds the oldest
        segment and retries once on a fresh tail; an EIO quarantines
        the sick tail segment aside and retries once on a fresh one;
        EROFS/EMFILE/anything else degrades immediately. Every path
        lands the record in memory (the queue keeps serving) and every
        record that missed the disk is counted lost — a crash during
        the window loses exactly the accounted set, nothing silent."""
        size = _RECORD.size + len(payload)
        with self._lock:
            self._shed_in_append = 0
            wrote = False
            if self.health.allow_io():
                episodes_before = self.health.episodes
                if self._tail_gap or self._tail_handle is None or \
                        self._tail_size + size > self._segment_bytes:
                    # _tail_gap: the open tail carries memory-only
                    # records — re-align disk and memory on a fresh
                    # segment before writing durably again.
                    self._roll_tail()
                wrote = self._write_record(ts, payload, episodes_before)
                if wrote:
                    self.health.ok()
                else:
                    self.health.record_lost(1)
            else:
                # Degraded, between probes: stay off the disk entirely.
                self.health.record_lost(1)
            if not wrote:
                self._tail_gap = True
            self._segments.setdefault(self._tail_seq, []).append(
                (ts, payload))
            self._tail_size += size
            self._sizes[self._tail_seq] = self._tail_size
            self.appended_records += 1
            return self._evict_over_bound() + self._shed_in_append

    def _write_framed(self, handle, ts: float, payload: bytes) -> None:
        handle.write(_RECORD.pack(ts, len(payload), zlib.crc32(payload)))
        handle.write(payload)
        handle.flush()
        if self._fsync:
            os.fsync(handle.fileno())

    def _write_record(self, ts: float, payload: bytes,
                      episodes_before: int) -> bool:
        """One durable write attempt with the per-errno recovery move
        applied and ONE retry on a fresh tail. True iff the record is
        on disk. Never raises — this runs on publisher/pool/handler
        threads (an fsync failure must never propagate off one).
        ``episodes_before`` gates
        the ENOSPC shed to once per EPISODE: if shedding a segment
        didn't clear the disk, shedding more of our own data won't —
        the WAL is rarely the disk's hog."""
        if self._tail_handle is not None:
            try:
                self._write_framed(self._tail_handle, ts, payload)
                return True
            except OSError as exc:
                reason = self.health.record_fault(exc)
        else:
            # The roll itself failed (fault recorded there — e.g. the
            # KTSG header write drew the ENOSPC): apply the same
            # per-reason recovery move before giving up.
            reason = self.health.reason or "io_fault"
        new_episode = self.health.episodes > episodes_before
        if reason == "disk_full" and new_episode:
            # Shed oldest-first to reclaim, then retry once: a spool
            # that filled its own disk trades its oldest records for
            # the ability to keep journaling the newest.
            self._shed_oldest()
        elif reason == "io_error" and new_episode:
            # Quarantine the sick segment; a fresh file on the same
            # disk often survives a localized bad block. Once per
            # EPISODE like the shed: re-quarantining on every recovery
            # probe of a persistently sick disk would re-count the
            # already-counted in-memory tail as lost and grow a new
            # .eioq file per probe.
            self._quarantine_tail()
        else:
            return False  # read-only / fd exhaustion / ongoing episode
        self._roll_tail()
        if self._tail_handle is None:
            return False
        try:
            self._write_framed(self._tail_handle, ts, payload)
            return True
        except OSError as exc:
            self.health.record_fault(exc)
            return False

    def _shed_oldest(self) -> None:
        """ENOSPC reclaim: drop the OLDEST live segment that actually
        HAS a disk file — disk AND memory (the memory copy of records
        whose loss we are about to account must not resurrect them).
        Memory-only segments (appended during the degraded window) are
        never shed: unlinking nothing reclaims nothing, and their
        records are the telemetry-continues-in-memory promise. Counted
        in evicted_records AND the append's return value (the caller
        journals it) AND the store's lost_records."""
        live = self._live_segments()
        for victim in live:
            if victim == self._tail_seq and len(live) <= 1:
                return  # never shed the only (open) tail
            if not os.path.exists(self._seg_path(victim)):
                continue  # memory-only: nothing on disk to reclaim
            if victim == self._tail_seq:
                return  # only the open tail is disk-backed: keep it
            records = self._segments.pop(victim, [])
            self._sizes.pop(victim, None)
            self._headered.discard(victim)
            self._payload_versions.pop(victim, None)
            start = self._cursor_idx if victim == self._cursor_seg else 0
            lost = max(0, len(records) - start)
            if self._cursor_seg <= victim:
                self._cursor_seg = victim + 1
                self._cursor_idx = 0
                self._cursor_dirty = True
            try:
                os.unlink(self._seg_path(victim))
            except OSError:
                pass
            if lost:
                self.evicted_records += lost
                self._shed_in_append += lost
                self.health.record_lost(lost)
            return

    def _quarantine_tail(self) -> None:
        """EIO containment: close the tail handle and park the
        segment's FILE aside (``<seg>.eioq``, first free slot — the
        skew-quarantine discipline) so the next roll opens a fresh
        file. The in-memory records stay drainable; their durable
        copies just went aside, so their loss is counted."""
        if self._tail_handle is not None:
            try:
                self._tail_handle.close()
            except OSError:
                pass
            self._tail_handle = None
        path = self._seg_path(self._tail_seq)
        base = path + ".eioq"
        target = base
        for attempt in range(1, 100):
            if not os.path.exists(target):
                break
            target = f"{base}.{attempt}"
        try:
            os.replace(path, target)
        except OSError:
            # Can't even rename it: leave it; recovery's CRC walk will
            # salvage the intact prefix either way.
            return
        pending = self._segments.get(self._tail_seq, ())
        start = (self._cursor_idx if self._tail_seq == self._cursor_seg
                 else 0)
        self.health.record_lost(max(0, len(pending) - start))
        log.warning("%s: tail segment %d quarantined after EIO (%s); "
                    "re-opening a fresh segment", self._label,
                    self._tail_seq, target)

    def _roll_tail(self) -> None:
        if self._tail_handle is not None:
            try:
                self._tail_handle.close()
            except OSError:
                pass
            self._tail_handle = None
        self._tail_gap = False  # a fresh segment re-aligns disk/memory
        # Bounded seq probe: a recovery whose listdir faulted left this
        # ring blind to pre-existing segment files — appending into one
        # would bury new-format records behind stale ones under a
        # header the ring never accounted. Skip PAST any non-empty
        # file, leaving its bytes untouched for the next (seeing)
        # recovery to replay.
        for _ in range(10_000):
            self._tail_seq += 1
            try:
                handle = open(self._seg_path(self._tail_seq), "ab")
            except OSError as exc:
                # Counted + episode-logged by the state machine (a
                # full/read-only disk must not log once per roll
                # attempt).
                self.health.record_fault(exc)
                self._tail_size = self._sizes.get(self._tail_seq, 0)
                self._segments.setdefault(self._tail_seq, [])
                return
            try:
                if handle.tell() != 0:
                    handle.close()
                    continue  # unknown pre-existing file: never append
                # Fresh segment: stamp the KTSG header so
                # readers on other builds can tell this segment's
                # container + payload format apart from both older
                # headerless segments and newer ones they must park.
                handle.write(
                    _SEG_MAGIC + bytes((SEGMENT_CONTAINER_VERSION,
                                        self._format_version)))
                handle.flush()
            except OSError as exc:
                try:
                    handle.close()
                except OSError:
                    pass
                self.health.record_fault(exc)
                self._tail_size = self._sizes.get(self._tail_seq, 0)
                self._segments.setdefault(self._tail_seq, [])
                return
            self._tail_handle = handle
            self._tail_size = 6
            self._headered.add(self._tail_seq)
            self._payload_versions[self._tail_seq] = self._format_version
            self._segments.setdefault(self._tail_seq, [])
            return
        log.warning("%s: no free segment sequence found (10k probed)",
                    self._label)
        self._tail_size = self._sizes.get(self._tail_seq, 0)
        self._segments.setdefault(self._tail_seq, [])

    def _evict_over_bound(self) -> int:
        evicted = 0
        while self.bytes_pending() > self._max_bytes:
            live = self._live_segments()
            if len(live) <= 1:
                break  # never evict the open tail out from under itself
            victim = live[0]
            records = self._segments.pop(victim, [])
            self._sizes.pop(victim, None)
            self._headered.discard(victim)
            self._payload_versions.pop(victim, None)
            start = self._cursor_idx if victim == self._cursor_seg else 0
            evicted += max(0, len(records) - start)
            if self._cursor_seg <= victim:
                self._cursor_seg = victim + 1
                self._cursor_idx = 0
                self._cursor_dirty = True
            try:
                os.unlink(self._seg_path(victim))
            except OSError:
                pass
        if evicted:
            self.evicted_records += evicted
        return evicted

    # -- read side ------------------------------------------------------------

    def _live_segments(self) -> list[int]:
        return sorted(self._segments)

    def _advance_to_records(self) -> bool:
        """Move the cursor past exhausted segments; True when a record
        is available at the cursor."""
        while True:
            records = self._segments.get(self._cursor_seg)
            if records is None:
                nxt = [s for s in self._segments if s > self._cursor_seg]
                if not nxt:
                    return False
                self._cursor_seg = min(nxt)
                self._cursor_idx = 0
                continue
            if self._cursor_idx < len(records):
                return True
            if self._cursor_seg == self._tail_seq:
                return False  # drained to the live tail
            self._drop_segment(self._cursor_seg)

    def _drop_segment(self, seq: int) -> None:
        self._segments.pop(seq, None)
        self._sizes.pop(seq, None)
        self._headered.discard(seq)
        self._payload_versions.pop(seq, None)
        try:
            os.unlink(self._seg_path(seq))
        except OSError:
            pass
        nxt = [s for s in self._segments if s > seq]
        self._cursor_seg = min(nxt) if nxt else self._tail_seq
        self._cursor_idx = 0

    def _drop_consumed_segments(self) -> None:
        for seq in list(self._live_segments()):
            if seq < self._cursor_seg and seq != self._tail_seq:
                self._segments.pop(seq, None)
                self._sizes.pop(seq, None)
                self._headered.discard(seq)
                self._payload_versions.pop(seq, None)
                try:
                    os.unlink(self._seg_path(seq))
                except OSError:
                    pass

    def peek(self) -> tuple[float, bytes] | None:
        """Oldest unconsumed record without consuming it (send first,
        commit after the receiver acked — at-least-once, never lossy)."""
        with self._lock:
            if not self._advance_to_records():
                return None
            return self._segments[self._cursor_seg][self._cursor_idx]

    def commit(self) -> None:
        """Consume the record :meth:`peek` returned. The cursor is
        persisted separately (:meth:`save_cursor`) so a crash between
        commit and save re-sends at most the uncheckpointed window."""
        with self._lock:
            if self._advance_to_records():
                self._cursor_idx += 1
                self._cursor_dirty = True

    def save_cursor(self, force: bool = False) -> bool:
        with self._lock:
            if not self._cursor_dirty and not force:
                return False
            self._cursor_epoch += 1
            state = {"version": self.CURSOR_VERSION,
                     "seq": self._cursor_epoch,
                     "segment": self._cursor_seg,
                     "record": self._cursor_idx}
            self._cursor_dirty = False
        # The cursor shares the RING's health: a cursor-write fault is
        # this store degrading, not a separate "spill cursor" store.
        return write_state(self._cursor_path(), state,
                           label=self._label + " cursor",
                           health=self.health)

    # -- introspection --------------------------------------------------------

    def records_pending(self) -> int:
        with self._lock:
            return self._pending_locked()

    def _pending_locked(self) -> int:
        total = 0
        for seq, records in self._segments.items():
            if seq < self._cursor_seg:
                continue
            start = self._cursor_idx if seq == self._cursor_seg else 0
            total += max(0, len(records) - start)
        return total

    def bytes_pending(self) -> int:
        total = 0
        for seq, records in self._segments.items():
            if seq < self._cursor_seg:
                continue
            start = self._cursor_idx if seq == self._cursor_seg else 0
            total += sum(_RECORD.size + len(p)
                         for _t, p in records[start:])
        return total

    def oldest_ts(self) -> float | None:
        """Wall timestamp of the oldest unconsumed record (spool age =
        now - this)."""
        with self._lock:
            if not self._advance_to_records():
                return None
            return self._segments[self._cursor_seg][self._cursor_idx][0]

    def status(self) -> dict:
        with self._lock:
            return {
                "records": self._pending_locked(),
                "bytes": self.bytes_pending(),
                "segments": len(self._segments),
                "appended_total": self.appended_records,
                "evicted_total": self.evicted_records,
                "torn_total": self.torn_records,
                "max_bytes": self._max_bytes,
                # Version-skew surfaces: future-format
                # segments parked aside at recovery, the payload
                # format this writer stamps, and whether the live ring
                # still carries legacy (pre-versioning) segments — the
                # mixed-fleet picture doctor --skew folds in.
                "skew_segments_total": self.skew_segments,
                "format_version": self._format_version,
                "legacy_segments": sum(
                    1 for seq in self._segments
                    if seq not in self._headered),
                # Durability state machine: the store's
                # current state + fault/loss accounting, for
                # /debug/stores and doctor --stores.
                "health": self.health.status(),
            }

    def close(self) -> None:
        with self._lock:
            if self._tail_handle is not None:
                try:
                    self._tail_handle.close()
                except OSError:
                    pass
                self._tail_handle = None
        self.save_cursor(force=True)
