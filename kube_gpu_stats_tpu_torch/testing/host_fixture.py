"""Host-signals fixture trees: a faked ``/proc`` + ``/sys`` + cgroup v2
layout for the host-stats tests and ``bench.measure_hoststats``. The
port's copy of the reference's builder; the files it writes are the
same, byte for byte, so one tree reads alike in either package."""

from __future__ import annotations

from pathlib import Path

DEFAULT_POD_UID = "0a1b2c3d-e4f5-6789-abcd-ef0123456789"


def write_psi(proc_root: Path, resource: str, *,
              some_avg10: float = 0.0, some_avg60: float = 0.0,
              some_total_us: int = 0,
              full_avg10: float | None = 0.0,
              full_avg60: float = 0.0,
              full_total_us: int = 0) -> None:
    """(Re)write one /proc/pressure/<resource> file. ``full_avg10``
    None omits the full line (the cpu file on older kernels)."""
    lines = [f"some avg10={some_avg10:.2f} avg60={some_avg60:.2f} "
             f"avg300=0.00 total={some_total_us}"]
    if full_avg10 is not None:
        lines.append(f"full avg10={full_avg10:.2f} avg60={full_avg60:.2f} "
                     f"avg300=0.00 total={full_total_us}")
    path = proc_root / "pressure" / resource
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")


def write_proc_stat(proc_root: Path, *, intr_total: int = 1000,
                    softirq_total: int = 500) -> None:
    proc_root.mkdir(parents=True, exist_ok=True)
    (proc_root / "stat").write_text(
        "cpu  100 0 50 1000 5 0 2 0 0 0\n"
        "btime 1700000000\n"
        f"intr {intr_total} 1 2 3\n"
        "ctxt 123456\n"
        f"softirq {softirq_total} 10 20 30\n")


def write_softirqs(proc_root: Path,
                   totals: dict[str, tuple[int, ...]] | None = None) -> None:
    totals = totals or {"TIMER": (100, 100), "NET_RX": (50, 25)}
    lines = ["          CPU0       CPU1"]
    for name, per_cpu in totals.items():
        lines.append(f"{name:>10}: " + " ".join(str(v) for v in per_cpu))
    proc_root.mkdir(parents=True, exist_ok=True)
    (proc_root / "softirqs").write_text("\n".join(lines) + "\n")


def write_nic(sysfs_root: Path, device: str = "eth0", *,
              rx_errors: int = 0, tx_errors: int = 0,
              rx_dropped: int = 0, tx_dropped: int = 0) -> None:
    stats = sysfs_root / "class" / "net" / device / "statistics"
    stats.mkdir(parents=True, exist_ok=True)
    (stats / "rx_errors").write_text(f"{rx_errors}\n")
    (stats / "tx_errors").write_text(f"{tx_errors}\n")
    (stats / "rx_dropped").write_text(f"{rx_dropped}\n")
    (stats / "tx_dropped").write_text(f"{tx_dropped}\n")


def write_thermal(sysfs_root: Path, zone: int = 0,
                  zone_type: str = "x86_pkg_temp",
                  temp_mc: int = 45_000) -> None:
    path = sysfs_root / "class" / "thermal" / f"thermal_zone{zone}"
    path.mkdir(parents=True, exist_ok=True)
    (path / "temp").write_text(f"{temp_mc}\n")
    (path / "type").write_text(f"{zone_type}\n")


def write_throttle(sysfs_root: Path, cpu: int = 0, *,
                   core: int = 0, package: int = 0) -> None:
    path = (sysfs_root / "devices" / "system" / "cpu" / f"cpu{cpu}"
            / "thermal_throttle")
    path.mkdir(parents=True, exist_ok=True)
    (path / "core_throttle_count").write_text(f"{core}\n")
    (path / "package_throttle_count").write_text(f"{package}\n")


def write_pod_cgroup(cgroup_root: Path, pod_uid: str = DEFAULT_POD_UID, *,
                     cpu_usec: int = 1_000_000, throttled_usec: int = 0,
                     memory_bytes: int = 64 << 20,
                     rbytes: int = 0, wbytes: int = 0,
                     layout: str = "systemd") -> Path:
    """One kubelet pod cgroup in the v2 tree (systemd-slice or cgroupfs
    layout). Also stamps the v2 marker (cgroup.controllers) at the
    root."""
    cgroup_root.mkdir(parents=True, exist_ok=True)
    (cgroup_root / "cgroup.controllers").write_text("cpu io memory\n")
    if layout == "systemd":
        slug = pod_uid.replace("-", "_")
        pod_dir = (cgroup_root / "kubepods.slice"
                   / "kubepods-burstable.slice"
                   / f"kubepods-burstable-pod{slug}.slice")
    else:
        pod_dir = cgroup_root / "kubepods" / "burstable" / f"pod{pod_uid}"
    pod_dir.mkdir(parents=True, exist_ok=True)
    (pod_dir / "cpu.stat").write_text(
        f"usage_usec {cpu_usec}\n"
        "user_usec 0\nsystem_usec 0\n"
        "nr_periods 10\nnr_throttled 1\n"
        f"throttled_usec {throttled_usec}\n")
    (pod_dir / "memory.current").write_text(f"{memory_bytes}\n")
    (pod_dir / "io.stat").write_text(
        f"8:0 rbytes={rbytes} wbytes={wbytes} rios=10 wios=5 "
        "dbytes=0 dios=0\n")
    return pod_dir


def make_host_tree(root: Path, *, pod_uid: str = DEFAULT_POD_UID,
                   mem_full_avg10: float = 0.0) -> dict[str, Path]:
    """A complete healthy host fixture: {proc, sysfs, cgroup} roots.
    Pass the returned paths as proc_root/sysfs_root/cgroup_root; mutate
    individual files (write_psi etc.) to inject episodes."""
    proc = root / "proc"
    sysfs = root / "sys"
    cgroup = root / "cgroup"
    write_psi(proc, "cpu", some_avg10=1.0, some_total_us=10_000,
              full_avg10=None)
    write_psi(proc, "memory", some_avg10=0.0, full_avg10=mem_full_avg10,
              some_total_us=5_000, full_total_us=2_000)
    write_psi(proc, "io", some_avg10=0.5, full_avg10=0.1,
              some_total_us=8_000, full_total_us=3_000)
    write_proc_stat(proc)
    write_softirqs(proc)
    write_nic(sysfs)
    write_thermal(sysfs)
    write_throttle(sysfs)
    write_pod_cgroup(cgroup, pod_uid)
    return {"proc": proc, "sysfs": sysfs, "cgroup": cgroup}
