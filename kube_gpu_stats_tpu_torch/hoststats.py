"""Host-signals correlation collector: root-cause *why* a slow node is
slow.

The flight recorder (tracing.py) names the slow phase of a tick and
stops at the device boundary, yet stragglers commonly root-cause to
HOST-side conditions: memory reclaim stalls, IRQ storms, thermal
throttling, a noisy co-scheduled pod. This module reads those signals
once per tick, OFF the tick hot path (the poll loop submits
:meth:`HostStats.read` to its sampler pool, like the ``procstats``
prefetch), and exports them as the ``kts_host_*`` families, beside the
card's own numbers on the same scrape.

Sources, each independent and each degrading to ABSENT — never an
error — when the backing file is missing (pre-4.20 kernels have no
/proc/pressure; VMs often expose no thermal zones; cgroup v1-only
hosts have no unified pod tree):

- **PSI** — ``/proc/pressure/{cpu,memory,io}``: some+full avg10/avg60
  shares and cumulative stall totals.
- **IRQ/softirq** — ``/proc/stat`` intr/softirq totals with per-sample
  rate deltas, plus per-type rates from ``/proc/softirqs``.
- **NIC** — ``/sys/class/net/*/statistics`` errors/drops per
  direction, plus a summed drop rate.
- **Thermal/throttle** — ``/sys/class/thermal`` zone temps and the
  cpufreq ``thermal_throttle`` counters with a rate edge.
- **Per-pod cgroup v2** — CPU/throttled/memory/IO per kubelet pod
  cgroup, joined to pod/namespace through the kubelet attribution
  mapping (``pod_map``) where a device-holder process ties a pod UID to
  an attributed card.
- **eBPF runqueue latency** — optional, behind :func:`probe_runq_source`:
  only emitted when a working eBPF source is actually wired (tests
  inject one; the probe refuses gracefully and /debug/host reports why).

A hostile/garbage line in an otherwise-present file yields a PARTIAL
snapshot plus an error reason the poll loop folds into
``collector_poll_errors_total`` — the same contract as the read path.

Concurrency: ``read()`` runs on one pool thread at a time (the poll
loop keeps at most one read in flight); ``contribute``/``trace_note``/
``debug_payload`` read the last published snapshot by reference
(atomic under CPython), so HTTP threads never block a read.

The port's copy of the reference's ``hoststats.py``; it imports no
torch.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Mapping, NamedTuple, Sequence

from . import schema
from .procopen import _POD_UID_RE

# Cardinality fences (same threat class as poll.py's link/raw caps): a
# host minting NICs/zones/pods without bound must not mint series
# without bound. Over-cap entries are dropped and counted once per read.
MAX_NICS = 32
MAX_THERMAL_ZONES = 32
MAX_PODS = 64

# PSI windows exported (avg300 adds nothing a Prometheus range query
# can't derive from the stall counter).
_PSI_WINDOWS = ("avg10", "avg60")
_PSI_RESOURCES = ("cpu", "memory", "io")

_PSI_FIELD_RE = re.compile(
    r"^(some|full)(?:\s+avg10=([0-9.]+))(?:\s+avg60=([0-9.]+))"
    r"(?:\s+avg300=[0-9.]+)?(?:\s+total=([0-9]+))\s*$")


class HostSnapshot(NamedTuple):
    """One read's parsed host signals. Every member may be empty —
    partial snapshots are the normal degraded state, not an error."""

    at: float
    # (resource, kind, window) -> share 0-100
    pressure: Mapping[tuple[str, str, str], float]
    # (resource, kind) -> cumulative stall seconds
    pressure_stall: Mapping[tuple[str, str], float]
    # kind ("hard"|"soft") -> cumulative count
    interrupts: Mapping[str, float]
    # kind -> per-second rate (absent until two samples)
    irq_rate: Mapping[str, float]
    # softirq type -> per-second rate
    softirq_rate: Mapping[str, float]
    # (device, direction) -> cumulative errors / drops
    nic_errors: Mapping[tuple[str, str], float]
    nic_drops: Mapping[tuple[str, str], float]
    nic_drop_rate: float | None
    # (zone index, type) -> celsius
    thermal: Mapping[tuple[str, str], float]
    # scope ("core"|"package") -> cumulative events
    throttle: Mapping[str, float]
    throttle_rate: float | None
    # pod_uid -> {"pod","namespace","cpu_seconds","throttled_seconds",
    #             "memory_bytes","io_read_bytes","io_write_bytes"}
    pods: Mapping[str, Mapping]
    # quantile -> seconds (eBPF source only)
    runq: Mapping[str, float]
    # error reasons from THIS read (poll folds them into
    # collector_poll_errors_total)
    errors: tuple[str, ...]


_EMPTY = HostSnapshot(0.0, {}, {}, {}, {}, {}, {}, {}, None, {}, {},
                      None, {}, {}, ())


def probe_runq_source():
    """Capability probe for the optional eBPF runqueue-latency source:
    ``(source, reason)`` — source None with a human-readable reason when
    the host can't run one (no toolchain, no privilege). Deliberately
    conservative: the collector must never trade its never-raise
    contract for a kernel feature."""
    try:
        import bcc  # type: ignore  # noqa: F401 - availability probe only
    except Exception:
        return None, "eBPF toolchain (bcc) not importable"
    if hasattr(os, "geteuid") and os.geteuid() != 0:
        return None, "not root (CAP_BPF/CAP_SYS_ADMIN required)"
    # A toolchain alone is not a working program: attaching a runqlat
    # probe is deployment-specific (kernel headers, BTF). Refuse here
    # rather than half-attach; deployments wire a real source object.
    return None, "bcc present but no runqlat program wired (inject a source)"


class HostStats:
    """The host-signals collector. One instance per daemon; the poll
    loop owns the read cadence, the HTTP server the /debug/host view."""

    def __init__(self, *, proc_root: str = "/proc",
                 sysfs_root: str = "/sys",
                 cgroup_root: str = "/sys/fs/cgroup",
                 pod_map: Callable[[], Mapping[str, tuple[str, str]]] | None = None,
                 enabled: bool = True,
                 ebpf_source=None,
                 probe_ebpf: bool = False,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.enabled = enabled
        self._proc = proc_root.rstrip("/") or "/"
        self._sysfs = sysfs_root.rstrip("/") or "/"
        self._cgroup = cgroup_root.rstrip("/") or "/"
        self._pod_map = pod_map
        self._clock = clock
        # Rate state: counter name -> (at, value) from the previous read.
        # Touched only inside read() (single read in flight by contract).
        self._prev: dict[str, tuple[float, float]] = {}
        # Over-cap conditions are latched (one error count per process),
        # not per-read: a node steadily over MAX_NICS/MAX_PODS must not
        # ramp collector_poll_errors_total forever for a known state.
        self._nic_cap_noted = False
        self._pod_cap_noted = False
        self._last: HostSnapshot = _EMPTY
        # Cumulative error counts for /debug/host (the per-read reasons
        # ride the snapshot for the poll loop's counter).
        self._error_totals: dict[str, int] = {}
        self._ebpf = ebpf_source
        self._ebpf_reason = "" if ebpf_source is not None else "not probed"
        if ebpf_source is None and probe_ebpf:
            self._ebpf, self._ebpf_reason = probe_runq_source()

    # -- reading (pool thread) ----------------------------------------------

    def read(self) -> HostSnapshot:
        """One pass over every source. Never raises; missing files are
        absent, garbage lines are partial + an error reason."""
        errors: list[str] = []
        now = self._clock()
        pressure, stall = self._read_psi(errors)
        interrupts, irq_rate = self._read_proc_stat(now, errors)
        softirq_rate = self._read_softirqs(now, errors)
        nic_errors, nic_drops, drop_rate = self._read_nics(now, errors)
        thermal = self._read_thermal(errors)
        throttle, throttle_rate = self._read_throttle(now, errors)
        pods = self._read_pods(errors)
        runq = self._read_runq(errors)
        snap = HostSnapshot(now, pressure, stall, interrupts, irq_rate,
                            softirq_rate, nic_errors, nic_drops, drop_rate,
                            thermal, throttle, throttle_rate, pods, runq,
                            tuple(errors))
        if errors:
            # Copy-then-swap, never mutate in place: debug_payload()
            # iterates this dict on HTTP threads, and an in-place
            # insert of a NEW reason mid-iteration would raise
            # "dictionary changed size" into a 500.
            totals = dict(self._error_totals)
            for reason in errors:
                totals[reason] = totals.get(reason, 0) + 1
            self._error_totals = totals
        self._last = snap
        return snap

    def _rate(self, key: str, now: float, value: float) -> float | None:
        """Per-second delta of a cumulative counter against the previous
        read; None on the first sample or a counter reset (negative
        delta — a reboot must not export a giant negative rate)."""
        prev = self._prev.get(key)
        self._prev[key] = (now, value)
        if prev is None:
            return None
        prev_at, prev_value = prev
        if now <= prev_at or value < prev_value:
            return None
        return (value - prev_value) / (now - prev_at)

    def _read_psi(self, errors: list[str]):
        pressure: dict[tuple[str, str, str], float] = {}
        stall: dict[tuple[str, str], float] = {}
        for resource in _PSI_RESOURCES:
            try:
                with open(f"{self._proc}/pressure/{resource}") as f:
                    lines = f.read().splitlines()
            except OSError:
                continue  # pre-4.20 kernel / PSI off: absent, no error
            for line in lines:
                if not line.strip():
                    continue
                match = _PSI_FIELD_RE.match(line)
                if match is None:
                    # Present-but-garbage is the hostile case: partial
                    # families plus a counted reason, never a raise.
                    errors.append("hoststats_psi")
                    continue
                kind, avg10, avg60, total_us = match.groups()
                try:
                    pressure[(resource, kind, "avg10")] = float(avg10)
                    pressure[(resource, kind, "avg60")] = float(avg60)
                    stall[(resource, kind)] = int(total_us) / 1e6
                except ValueError:
                    errors.append("hoststats_psi")
        return pressure, stall

    def _read_proc_stat(self, now: float, errors: list[str]):
        interrupts: dict[str, float] = {}
        irq_rate: dict[str, float] = {}
        try:
            with open(f"{self._proc}/stat") as f:
                lines = f.read().splitlines()
        except OSError:
            return interrupts, irq_rate
        for line in lines:
            kind = None
            if line.startswith("intr "):
                kind = "hard"
            elif line.startswith("softirq "):
                kind = "soft"
            if kind is None:
                continue
            try:
                total = float(int(line.split(None, 2)[1]))
            except (IndexError, ValueError):
                errors.append("hoststats_stat")
                continue
            interrupts[kind] = total
            rate = self._rate(f"irq:{kind}", now, total)
            if rate is not None:
                irq_rate[kind] = rate
        return interrupts, irq_rate

    def _read_softirqs(self, now: float, errors: list[str]):
        rates: dict[str, float] = {}
        try:
            with open(f"{self._proc}/softirqs") as f:
                lines = f.read().splitlines()
        except OSError:
            return rates
        for line in lines[1:]:  # first line is the CPU header
            name, _, rest = line.partition(":")
            name = name.strip()
            if not name:
                continue
            try:
                total = float(sum(int(tok) for tok in rest.split()))
            except ValueError:
                errors.append("hoststats_softirqs")
                continue
            rate = self._rate(f"softirq:{name}", now, total)
            if rate is not None:
                rates[name] = rate
        return rates

    _NIC_COUNTERS = (("rx_errors", "rx", "errors"),
                     ("tx_errors", "tx", "errors"),
                     ("rx_dropped", "rx", "drops"),
                     ("tx_dropped", "tx", "drops"))

    def _read_nics(self, now: float, errors: list[str]):
        nic_errors: dict[tuple[str, str], float] = {}
        nic_drops: dict[tuple[str, str], float] = {}
        net = f"{self._sysfs}/class/net"
        try:
            devices = sorted(os.listdir(net))
        except OSError:
            return nic_errors, nic_drops, None
        if len(devices) > MAX_NICS:
            # Lexicographic-first keeps a stable window for a fixed
            # population (veth-per-pod nodes exceed the cap routinely);
            # latched, not per-read: a steady over-cap condition must
            # not ramp the error counter forever.
            if not self._nic_cap_noted:
                self._nic_cap_noted = True
                errors.append("hoststats_nic_cap")
            devices = devices[:MAX_NICS]
        rates = []
        for device in devices:
            if device == "lo":
                continue
            stats = f"{net}/{device}/statistics"
            device_drops = 0.0
            saw_drops = False
            for filename, direction, family in self._NIC_COUNTERS:
                try:
                    with open(f"{stats}/{filename}") as f:
                        value = float(int(f.read().strip()))
                except OSError:
                    continue
                except ValueError:
                    errors.append("hoststats_nic")
                    continue
                if family == "errors":
                    nic_errors[(device, direction)] = value
                else:
                    nic_drops[(device, direction)] = value
                    device_drops += value
                    saw_drops = True
            if saw_drops:
                # Rate PER DEVICE, summed after: an interface entering
                # or leaving the set (pod veth churn, the cap window
                # shifting) contributes nothing on its first sight
                # instead of dumping its lifetime counter into one
                # spurious fleet-anomaly-raising spike.
                rate = self._rate(f"nic:drops:{device}", now, device_drops)
                if rate is not None:
                    rates.append(rate)
        # Departed interfaces' rate baselines go with them (veth churn
        # must not grow the state dict without bound).
        alive = {f"nic:drops:{device}" for device in devices}
        for key in [k for k in self._prev
                    if k.startswith("nic:drops:") and k not in alive]:
            del self._prev[key]
        return nic_errors, nic_drops, (sum(rates) if rates else None)

    def _read_thermal(self, errors: list[str]):
        thermal: dict[tuple[str, str], float] = {}
        base = f"{self._sysfs}/class/thermal"
        try:
            zones = sorted(entry for entry in os.listdir(base)
                           if entry.startswith("thermal_zone"))
        except OSError:
            return thermal
        if len(zones) > MAX_THERMAL_ZONES:
            errors.append("hoststats_thermal_cap")
            zones = zones[:MAX_THERMAL_ZONES]
        for zone in zones:
            try:
                with open(f"{base}/{zone}/temp") as f:
                    milli = int(f.read().strip())
            except OSError:
                continue  # unreadable zone: absent, no error
            except ValueError:
                errors.append("hoststats_thermal")
                continue
            zone_type = ""
            try:
                with open(f"{base}/{zone}/type") as f:
                    zone_type = f.read().strip()
            except OSError:
                pass
            index = zone[len("thermal_zone"):]
            thermal[(index, zone_type)] = milli / 1000.0
        return thermal

    def _read_throttle(self, now: float, errors: list[str]):
        throttle: dict[str, float] = {}
        base = f"{self._sysfs}/devices/system/cpu"
        try:
            cpus = [entry for entry in os.listdir(base)
                    if entry.startswith("cpu") and entry[3:].isdigit()]
        except OSError:
            return throttle, None
        for cpu in cpus:
            for scope in ("core", "package"):
                path = (f"{base}/{cpu}/thermal_throttle/"
                        f"{scope}_throttle_count")
                try:
                    with open(path) as f:
                        count = float(int(f.read().strip()))
                except OSError:
                    continue
                except ValueError:
                    errors.append("hoststats_throttle")
                    continue
                throttle[scope] = throttle.get(scope, 0.0) + count
        if not throttle:
            return throttle, None
        rate = self._rate("throttle", now, sum(throttle.values()))
        return throttle, rate

    def _read_pods(self, errors: list[str]):
        pods: dict[str, dict] = {}
        root = self._cgroup
        # cgroup v2 detection: the unified hierarchy always has
        # cgroup.controllers at its root. v1-only hosts degrade to no
        # pod families at all, silently (expected, not an error).
        if not os.path.exists(f"{root}/cgroup.controllers"):
            return pods
        pod_names: Mapping[str, tuple[str, str]] = {}
        if self._pod_map is not None:
            try:
                pod_names = self._pod_map() or {}
            except Exception:  # noqa: BLE001 - join is best-effort
                errors.append("hoststats_pod_map")
        # Bounded walk for kubelet pod cgroups (systemd slice or
        # cgroupfs layout); matched pod dirs are not descended into.
        # Discover-then-sort so the over-cap selection is the SAME
        # subset every read for a fixed population (os.walk order
        # shifts under pod churn, and a flapping series set would
        # break every rate() query over the pod counters — the
        # procopen stable-identity rule).
        found: list[tuple[str, str]] = []
        for dirpath, dirnames, _files in os.walk(root):
            depth = dirpath[len(root):].count(os.sep)
            if depth >= 5:
                dirnames[:] = []
                continue
            match = _POD_UID_RE.search(os.path.basename(dirpath))
            if match is None:
                continue
            dirnames[:] = []  # container cgroups live below; stop here
            found.append((match.group(1).replace("_", "-"), dirpath))
        found.sort()
        if len(found) > MAX_PODS:
            if not self._pod_cap_noted:
                self._pod_cap_noted = True
                errors.append("hoststats_pod_cap")
            found = found[:MAX_PODS]
        for uid, dirpath in found:
            entry = self._read_pod_cgroup(dirpath, errors)
            if entry is None:
                continue
            pod, namespace = pod_names.get(uid, ("", ""))
            entry["pod"] = pod
            entry["namespace"] = namespace
            pods[uid] = entry
        return pods

    @staticmethod
    def _read_pod_cgroup(path: str, errors: list[str]) -> dict | None:
        entry: dict = {}
        try:
            with open(f"{path}/cpu.stat") as f:
                for line in f:
                    key, _, value = line.partition(" ")
                    if key == "usage_usec":
                        entry["cpu_seconds"] = int(value) / 1e6
                    elif key == "throttled_usec":
                        entry["throttled_seconds"] = int(value) / 1e6
        except OSError:
            pass
        except ValueError:
            errors.append("hoststats_cgroup")
        try:
            with open(f"{path}/memory.current") as f:
                entry["memory_bytes"] = float(int(f.read().strip()))
        except OSError:
            pass
        except ValueError:
            errors.append("hoststats_cgroup")
        try:
            read_bytes = write_bytes = 0
            with open(f"{path}/io.stat") as f:
                for line in f:
                    for token in line.split()[1:]:
                        key, _, value = token.partition("=")
                        if key == "rbytes":
                            read_bytes += int(value)
                        elif key == "wbytes":
                            write_bytes += int(value)
            entry["io_read_bytes"] = float(read_bytes)
            entry["io_write_bytes"] = float(write_bytes)
        except OSError:
            pass
        except ValueError:
            errors.append("hoststats_cgroup")
        return entry or None

    def _read_runq(self, errors: list[str]):
        if self._ebpf is None:
            return {}
        try:
            return dict(self._ebpf.read())
        except Exception:  # noqa: BLE001 - optional source, never fatal
            errors.append("hoststats_ebpf")
            return {}

    # -- export (poll-loop thread) -------------------------------------------

    def contribute(self, builder, snap: HostSnapshot | None = None) -> None:
        """Fold a snapshot's kts_host_* families into a SnapshotBuilder
        (the poll loop passes the snapshot it harvested; None uses the
        last read — bare tools)."""
        snap = snap if snap is not None else self._last
        if not self.enabled or snap.at == 0.0:
            return
        for (resource, kind, window), value in sorted(snap.pressure.items()):
            builder.add(schema.HOST_PRESSURE, value,
                        (("resource", resource), ("kind", kind),
                         ("window", window)))
        for (resource, kind), value in sorted(snap.pressure_stall.items()):
            builder.add(schema.HOST_PRESSURE_STALL, value,
                        (("resource", resource), ("kind", kind)))
        for kind, value in sorted(snap.interrupts.items()):
            builder.add(schema.HOST_INTERRUPTS, value, (("kind", kind),))
        for kind, value in sorted(snap.irq_rate.items()):
            builder.add(schema.HOST_IRQ_RATE, value, (("kind", kind),))
        for name, value in sorted(snap.softirq_rate.items()):
            builder.add(schema.HOST_SOFTIRQ_RATE, value, (("type", name),))
        for (device, direction), value in sorted(snap.nic_errors.items()):
            builder.add(schema.HOST_NIC_ERRORS, value,
                        (("device", device), ("direction", direction)))
        for (device, direction), value in sorted(snap.nic_drops.items()):
            builder.add(schema.HOST_NIC_DROPS, value,
                        (("device", device), ("direction", direction)))
        if snap.nic_drop_rate is not None:
            builder.add(schema.HOST_NIC_DROP_RATE, snap.nic_drop_rate)
        for (zone, zone_type), value in sorted(snap.thermal.items()):
            builder.add(schema.HOST_THERMAL_ZONE, value,
                        (("zone", zone), ("type", zone_type)))
        for scope, value in sorted(snap.throttle.items()):
            builder.add(schema.HOST_THROTTLE_EVENTS, value,
                        (("scope", scope),))
        if snap.throttle_rate is not None:
            builder.add(schema.HOST_THROTTLE_RATE, snap.throttle_rate)
        for uid in sorted(snap.pods):
            entry = snap.pods[uid]
            labels = (("pod", entry.get("pod", "")),
                      ("namespace", entry.get("namespace", "")),
                      ("pod_uid", uid))
            if "cpu_seconds" in entry:
                builder.add(schema.HOST_POD_CPU, entry["cpu_seconds"],
                            labels)
            if "throttled_seconds" in entry:
                builder.add(schema.HOST_POD_THROTTLED,
                            entry["throttled_seconds"], labels)
            if "memory_bytes" in entry:
                builder.add(schema.HOST_POD_MEMORY, entry["memory_bytes"],
                            labels)
            for direction, key in (("read", "io_read_bytes"),
                                   ("write", "io_write_bytes")):
                if key in entry:
                    builder.add(schema.HOST_POD_IO, entry[key],
                                labels + (("direction", direction),))
        for quantile, value in sorted(snap.runq.items()):
            builder.add(schema.HOST_RUNQ_LATENCY, value,
                        (("quantile", quantile),))

    def trace_note(self, snap: HostSnapshot | None = None) -> dict | None:
        """Compact host summary stamped onto the flight recorder's tick
        meta (the TickTrace 'host' aux annotation): the strongest
        root-cause signals, time-aligned with the tick they rode. None
        when nothing has been read yet."""
        snap = snap if snap is not None else self._last
        if not self.enabled or snap.at == 0.0:
            return None
        note: dict = {}
        for key, psi in (("mem_full_avg10", ("memory", "full", "avg10")),
                         ("cpu_some_avg10", ("cpu", "some", "avg10")),
                         ("io_full_avg10", ("io", "full", "avg10"))):
            value = snap.pressure.get(psi)
            if value is not None:
                note[key] = value
        if snap.nic_drop_rate is not None:
            note["nic_drop_rate"] = round(snap.nic_drop_rate, 3)
        if snap.throttle_rate is not None:
            note["throttle_rate"] = round(snap.throttle_rate, 3)
        return note or None

    # -- read side (HTTP threads) --------------------------------------------

    def debug_payload(self) -> dict:
        """The /debug/host JSON: the last snapshot, the eBPF capability
        verdict, cumulative error counts — mirroring /debug/fleet's
        'enabled' contract (--no-host-stats keeps the endpoint up and
        says so)."""
        if not self.enabled:
            return {"enabled": False}
        snap = self._last
        payload: dict = {
            "enabled": True,
            "read_at": snap.at,
            "pressure": {
                f"{resource}_{kind}_{window}": value
                for (resource, kind, window), value
                in sorted(snap.pressure.items())
            },
            "pressure_stall_seconds": {
                f"{resource}_{kind}": value
                for (resource, kind), value
                in sorted(snap.pressure_stall.items())
            },
            "irq_rate": dict(sorted(snap.irq_rate.items())),
            "softirq_rate": dict(sorted(snap.softirq_rate.items())),
            "nic_drops": {
                f"{device}_{direction}": value
                for (device, direction), value in sorted(snap.nic_drops.items())
            },
            "nic_errors": {
                f"{device}_{direction}": value
                for (device, direction), value
                in sorted(snap.nic_errors.items())
            },
            "nic_drop_rate": snap.nic_drop_rate,
            "thermal_celsius": {
                f"zone{zone}_{zone_type}" if zone_type else f"zone{zone}": value
                for (zone, zone_type), value in sorted(snap.thermal.items())
            },
            "throttle_events": dict(sorted(snap.throttle.items())),
            "throttle_rate": snap.throttle_rate,
            "pods": {uid: dict(entry)
                     for uid, entry in sorted(snap.pods.items())},
            "runq_latency_seconds": dict(sorted(snap.runq.items())),
            "ebpf": {
                "available": self._ebpf is not None,
                "reason": self._ebpf_reason,
            },
            "errors": dict(sorted(self._error_totals.items())),
        }
        return payload
