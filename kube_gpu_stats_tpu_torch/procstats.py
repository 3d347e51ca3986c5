"""Standard Prometheus process metrics (process_cpu_seconds_total,
process_resident_memory_bytes, process_virtual_memory_bytes,
process_start_time_seconds, process_open_fds, process_max_fds) read from
/proc once per tick — the conventional exporter self-observability the
reference genre gets from its client library (SURVEY.md §5 observability
item). Degrades to nothing on hosts without /proc."""

from __future__ import annotations

import os

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _boot_time() -> float | None:
    try:
        with open("/proc/stat") as f:
            for line in f:
                if line.startswith("btime "):
                    return float(line.split()[1])
    except OSError:
        return None
    return None


_BOOT_TIME = _boot_time()


def _get_boot_time() -> float | None:
    """Cached boot time, retried lazily: the import-time read can fail
    transiently (container startup races a /proc remount), and caching
    the None would leave process_start_time_seconds permanently absent
    for the process lifetime. Boot time itself never changes, so a
    successful read caches forever."""
    global _BOOT_TIME
    if _BOOT_TIME is None:
        _BOOT_TIME = _boot_time()
    return _BOOT_TIME


def read() -> dict[str, float]:
    """Current process CPU seconds, RSS bytes, start time (unix). Empty on
    failure — never raises on the poll path."""
    out: dict[str, float] = {}
    try:
        with open("/proc/self/stat") as f:
            # Field 2 (comm) may contain spaces/parens; split after it.
            rest = f.read().rpartition(")")[2].split()
        # rest[0] is field 3 (state); utime=14, stime=15, starttime=22
        # (1-indexed in proc(5)) -> rest indices 11, 12, 19.
        utime, stime = int(rest[11]), int(rest[12])
        out["process_cpu_seconds_total"] = (utime + stime) / _CLK_TCK
        boot_time = _get_boot_time()
        if boot_time is not None:
            out["process_start_time_seconds"] = (
                boot_time + int(rest[19]) / _CLK_TCK
            )
    except (OSError, IndexError, ValueError):
        pass
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        out["process_virtual_memory_bytes"] = float(int(fields[0]) * _PAGE_SIZE)
        out["process_resident_memory_bytes"] = float(int(fields[1]) * _PAGE_SIZE)
    except (OSError, IndexError, ValueError):
        pass
    try:
        out["process_open_fds"] = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    try:
        import resource

        soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft != resource.RLIM_INFINITY:
            out["process_max_fds"] = float(soft)
    except (ImportError, OSError, ValueError):
        pass
    return out


def contribute(builder, readings: dict[str, float] | None = None) -> None:
    """Fold process_* readings into a SnapshotBuilder; a procstats key
    missing from schema.SELF_METRICS fails loudly. ``readings`` lets a
    caller pass a read() it prefetched off the hot path (the poll loop
    overlaps the ~20 /proc syscalls with its device fan-out); None reads
    inline."""
    from . import schema

    by_self = {spec.name: spec for spec in schema.SELF_METRICS}
    for name, value in (read() if readings is None else readings).items():
        builder.add(by_self[name], value)
