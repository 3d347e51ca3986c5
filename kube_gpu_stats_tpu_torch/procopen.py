"""Which processes hold each accelerator device node open (procfs scan).

The port's copy of the reference's ``procopen.py``. A process using a card
holds an open fd on its device node (``/dev/nvidia<minor>``), visible as a
``/proc/<pid>/fd/*`` symlink; the scan reads those, the reference's way,
rather than NVML's process list.

Exported as ``accelerator_process_open{..., pid, comm, pod_uid} 1`` per
holder. ``pod_uid`` comes from the holder's cgroup path (the
``...podXXXX...`` component kubelet drivers put there, systemd or
cgroupfs layout) — pod attribution for the process table with no kubelet
API at all. Scanning every fd of every process is far too slow for the
poll tick, so the watcher runs on the attribution cadence (default 10 s)
and the poll loop reads its cached result.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Callable, Sequence

from .workers import PeriodicRefresher

log = logging.getLogger(__name__)

# Cardinality guard default: one series per (card, pid); a pathological
# node with thousands of holders (fork-heavy launcher, fd-inheriting
# children) must not blow up the registry, the scrape, or Prometheus.
# Overridable via --max-process-series.
MAX_HOLDERS_PER_DEVICE = 32

# Holders beyond the cap fold into ONE stable series per device:
# {pid="", comm="_overflow"} with the fold count as the value — bounded
# cardinality with the overflow still visible (a silent truncation would
# hide holders).
OVERFLOW_COMM = "_overflow"

# One exported holder entry: (pid label value, comm label value, pod_uid
# label value, gauge value). Normal holders are (str(pid), comm, uid, 1.0);
# the overflow entry is ("", "_overflow", "", <folded holder count>).
Holder = tuple[str, str, str, float]

# Pod UID inside a kubelet-managed cgroup path. Two layouts exist:
# systemd driver:  .../kubepods-burstable-pod0a1b2c3d_e4f5_....slice/...
# cgroupfs driver: /kubepods/burstable/pod0a1b2c3d-e4f5-.../...
_POD_UID_RE = re.compile(
    r"pod([0-9a-f]{8}[-_][0-9a-f]{4}[-_][0-9a-f]{4}[-_][0-9a-f]{4}"
    r"[-_][0-9a-f]{12})")


def _pod_uid(proc_root: str, pid: str) -> str:
    """Pod UID owning `pid` per its cgroup path, "" when not in a pod
    (plain VM process) or unreadable. Read only for holders that survive
    the cardinality cap — never one file per process on the node."""
    try:
        with open(os.path.join(proc_root, pid, "cgroup")) as f:
            data = f.read()
    except OSError:
        return ""
    match = _POD_UID_RE.search(data)
    return match.group(1).replace("_", "-") if match else ""


def scan(proc_root: str, device_paths: Sequence[str],
         max_holders: int = MAX_HOLDERS_PER_DEVICE
         ) -> dict[str, list[Holder]]:
    """One pass over ``<proc_root>``: device_path -> [holder, ...].

    Never raises: unreadable entries (processes exiting mid-scan, fds we
    lack permission for) are skipped; missing /proc yields {}. Holders
    are sorted by pid and capped at ``max_holders`` per device, the
    excess folded into the overflow entry — series identity stays stable
    across refreshes for any fixed population.
    """
    wanted = set(device_paths)
    raw: dict[str, list[tuple[int, str]]] = {path: [] for path in wanted}
    if not wanted:
        return {}
    try:
        pids = [e for e in os.listdir(proc_root) if e.isdigit()]
    except OSError:
        return {path: [] for path in wanted}
    for pid in pids:
        fd_dir = os.path.join(proc_root, pid, "fd")
        try:
            fds = os.listdir(fd_dir)
        except OSError:
            continue  # gone, or not ours to read (no hostPID / not root)
        held: set[str] = set()
        for fd in fds:
            try:
                target = os.readlink(os.path.join(fd_dir, fd))
            except OSError:
                continue
            if target in wanted:
                held.add(target)
        if not held:
            continue
        try:
            with open(os.path.join(proc_root, pid, "comm")) as f:
                comm = f.read().strip()
        except OSError:
            comm = ""
        for path in held:
            raw[path].append((int(pid), comm))
    out: dict[str, list[Holder]] = {}
    uid_cache: dict[int, str] = {}
    for path, holders in raw.items():
        holders.sort()  # deterministic keep-set under the cap
        kept: list[Holder] = []
        for pid, comm in holders[:max_holders]:
            uid = uid_cache.get(pid)
            if uid is None:
                uid = uid_cache[pid] = _pod_uid(proc_root, str(pid))
            kept.append((str(pid), comm, uid, 1.0))
        overflow = len(holders) - max_holders
        if overflow > 0:
            kept.append(("", OVERFLOW_COMM, "", float(overflow)))
        out[path] = kept
    return out


class DeviceProcessWatcher(PeriodicRefresher):
    """Cached device→holders map, refreshed on its own thread (never on
    the poll path). ``lookup`` is a dict read; a failing scan keeps the
    previous map and backs off (same last-good + backoff semantics as the
    attribution watcher, via the shared PeriodicRefresher scaffold)."""

    def __init__(
        self,
        paths_fn: Callable[[], Sequence[str]],
        proc_root: str = "/proc",
        refresh_interval: float = 10.0,
        max_holders: int = MAX_HOLDERS_PER_DEVICE,
    ) -> None:
        super().__init__(refresh_interval, thread_name="procopen-watcher")
        self._paths_fn = paths_fn
        self._proc_root = proc_root
        self._max_holders = max_holders
        self._cache: dict[str, list[Holder]] = {}

    def refresh_once(self) -> None:
        try:
            self._cache = scan(self._proc_root, list(self._paths_fn()),
                               self._max_holders)
            self.consecutive_failures = 0
        except Exception as exc:  # defensive: watcher must never die
            self.consecutive_failures += 1
            log.warning("device-process scan failed (keeping last map): %s", exc)

    def lookup(self, device_path: str) -> list[Holder]:
        return self._cache.get(device_path, [])
