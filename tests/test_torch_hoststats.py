"""The port's host-signals collector against the JAX package's.

One fixture tree under ``tmp_path`` (``proc``, ``sys``, a cgroup v2
mount), made by the reference's ``testing.host_fixture``, is read by the
reference's ``HostStats`` and the port's on the same injected clock.
Each case follows one of ``tests/test_hoststats.py``: the snapshots must
be equal field for field, and so must the rendered ``kts_host_*`` text,
the ``/debug/host`` payload and the tick's trace note, read after read.
Then the port's own wiring: the poll loop folds the host read off the
tick path, the daemon serves ``enabled: false`` under
``--no-host-stats``, and the pod join takes the port's own pod-UID
pattern.
"""

from __future__ import annotations

import shutil
import time

import pytest

from kube_gpu_stats_tpu import hoststats as ref_hoststats
from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
from kube_gpu_stats_tpu.testing import host_fixture
from kube_gpu_stats_tpu_torch import hoststats, procopen
from kube_gpu_stats_tpu_torch.registry import SnapshotBuilder

POD_UID = host_fixture.DEFAULT_POD_UID


class Clock:
    def __init__(self, now: float = 100.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now


def _pair(roots: dict, clock: Clock, **kwargs):
    common = dict(proc_root=str(roots["proc"]),
                  sysfs_root=str(roots["sysfs"]),
                  cgroup_root=str(roots["cgroup"]), clock=clock)
    return (ref_hoststats.HostStats(**common, **kwargs),
            hoststats.HostStats(**common, **kwargs))


def _rendered(host, snap, builder_cls) -> str:
    builder = builder_cls()
    host.contribute(builder, snap)
    return builder.build().render()


def _read_both(ref, port) -> tuple[dict, dict]:
    out = []
    for host, builder in ((ref, RefBuilder), (port, SnapshotBuilder)):
        snap = host.read()
        out.append({"snapshot": dict(snap._asdict()),
                    "text": _rendered(host, snap, builder),
                    "debug": host.debug_payload(),
                    "note": host.trace_note(snap)})
    return out[0], out[1]


def _pod_dir(roots):
    return (roots["cgroup"] / "kubepods.slice" / "kubepods-burstable.slice"
            / f"kubepods-burstable-pod{POD_UID.replace('-', '_')}.slice")


# Each case: (steps, HostStats kwargs). A step mutates the tree and the
# clock before a read of both collectors.

def _full(roots, clock):
    yield
    host_fixture.write_proc_stat(roots["proc"], intr_total=3000,
                                 softirq_total=1500)
    host_fixture.write_softirqs(roots["proc"],
                                {"TIMER": (300, 100), "NET_RX": (60, 25)})
    host_fixture.write_nic(roots["sysfs"], rx_dropped=40, tx_errors=2)
    host_fixture.write_throttle(roots["sysfs"], core=5, package=1)
    host_fixture.write_psi(roots["proc"], "memory", full_avg10=18.0,
                           full_avg60=9.0, full_total_us=180_000)
    clock.now += 10.0
    yield


def _counter_reset(roots, clock):
    host_fixture.write_proc_stat(roots["proc"], intr_total=5000)
    yield
    host_fixture.write_proc_stat(roots["proc"], intr_total=10)
    clock.now += 10.0
    yield


def _missing_psi(roots, clock):
    shutil.rmtree(roots["proc"] / "pressure")
    yield


def _cgroup_v1(roots, clock):
    (roots["cgroup"] / "cgroup.controllers").unlink()
    yield


def _unreadable_thermal(roots, clock):
    temp = roots["sysfs"] / "class" / "thermal" / "thermal_zone0" / "temp"
    temp.unlink()
    temp.mkdir()
    yield


def _hostile_psi(roots, clock):
    (roots["proc"] / "pressure" / "memory").write_text(
        "some avg10=GARBAGE avg60=nope total=zzz\n"
        "full avg10=18.00 avg60=9.00 avg300=4.00 total=180000\n")
    yield
    clock.now += 1.0
    yield


def _garbage_cgroup_and_nic(roots, clock):
    (_pod_dir(roots) / "memory.current").write_text("not-a-number\n")
    (roots["sysfs"] / "class" / "net" / "eth0" / "statistics"
     / "rx_dropped").write_text("garbage\n")
    yield


def _everything_missing(roots, clock):
    for key in ("proc", "sysfs", "cgroup"):
        shutil.rmtree(roots[key])
    yield


def _cgroupfs_layout(roots, clock):
    host_fixture.write_pod_cgroup(
        roots["cgroup"], "11112222-3333-4444-5555-666677778888",
        layout="cgroupfs", cpu_usec=2_000_000)
    yield


def _pod_cap(roots, clock):
    for i in range(hoststats.MAX_PODS + 5):
        host_fixture.write_pod_cgroup(
            roots["cgroup"], f"{i:08x}-0000-0000-0000-000000000000",
            layout="cgroupfs")
    yield
    clock.now += 1.0
    yield


def _nic_cap(roots, clock):
    for i in range(hoststats.MAX_NICS + 3):
        host_fixture.write_nic(roots["sysfs"], f"veth{i:03d}", rx_dropped=i)
    yield
    clock.now += 1.0
    yield


def _thermal_cap(roots, clock):
    for zone in range(hoststats.MAX_THERMAL_ZONES + 2):
        host_fixture.write_thermal(roots["sysfs"], zone,
                                   temp_mc=40_000 + zone)
    yield


def _nic_churn(roots, clock):
    yield
    host_fixture.write_nic(roots["sysfs"], "veth9", rx_dropped=100_000)
    clock.now += 10.0
    yield
    host_fixture.write_nic(roots["sysfs"], "veth9", rx_dropped=100_050)
    clock.now += 10.0
    yield
    shutil.rmtree(roots["sysfs"] / "class" / "net" / "veth9")
    clock.now += 10.0
    yield


class _Runq:
    def read(self):
        return {"p50": 0.0001, "p99": 0.004}


class _BrokenRunq:
    def read(self):
        raise OSError("bpf prog detached")


def _boom():
    raise RuntimeError("kubelet went away")


CASES = {
    "full_fixture_and_rates": (_full, {}),
    "counter_reset": (_counter_reset, {}),
    "missing_psi": (_missing_psi, {}),
    "cgroup_v1_only": (_cgroup_v1, {}),
    "unreadable_thermal": (_unreadable_thermal, {}),
    "hostile_psi_line": (_hostile_psi, {}),
    "garbage_cgroup_and_nic": (_garbage_cgroup_and_nic, {}),
    "everything_missing": (_everything_missing, {}),
    "pod_map_join": (_full, {"pod_map": lambda: {POD_UID: ("train-0", "ml")}}),
    "pod_map_crash": (_full, {"pod_map": _boom}),
    "cgroupfs_layout": (_cgroupfs_layout, {}),
    "pod_cap": (_pod_cap, {}),
    "nic_cap": (_nic_cap, {}),
    "thermal_cap": (_thermal_cap, {}),
    "nic_churn": (_nic_churn, {}),
    "runq_source": (_full, {"ebpf_source": _Runq()}),
    "runq_source_crash": (_full, {"ebpf_source": _BrokenRunq()}),
    "disabled": (_full, {"enabled": False}),
}


@pytest.mark.parametrize("case", CASES)
def test_reads_equal_the_reference_on_the_same_tree(case, tmp_path):
    steps, kwargs = CASES[case]
    roots = host_fixture.make_host_tree(tmp_path)
    clock = Clock()
    ref, port = _pair(roots, clock, **kwargs)
    reads = 0
    for _ in steps(roots, clock):
        want, got = _read_both(ref, port)
        assert got == want
        reads += 1
    assert reads >= 1


def test_the_cases_cover_what_the_reference_tests(tmp_path):
    """The shared tree exercises every path the reference's own tests
    do: partial snapshots with their error reasons, the caps latched
    once, rates from the second read, the pod join."""
    roots = host_fixture.make_host_tree(tmp_path)
    clock = Clock()
    _, port = _pair(roots, clock,
                    pod_map=lambda: {POD_UID: ("train-0", "ml")})
    first = port.read()
    assert first.errors == () and first.irq_rate == {}
    assert first.pods[POD_UID]["pod"] == "train-0"
    for i in range(hoststats.MAX_PODS + 1):
        host_fixture.write_pod_cgroup(
            roots["cgroup"], f"{i:08x}-0000-0000-0000-000000000000",
            layout="cgroupfs")
    host_fixture.write_proc_stat(roots["proc"], intr_total=2000)
    (roots["proc"] / "pressure" / "io").write_text("garbage\n")
    clock.now += 10.0
    second = port.read()
    assert second.irq_rate["hard"] == pytest.approx(100.0)
    assert {"hoststats_pod_cap", "hoststats_psi"} <= set(second.errors)
    assert len(second.pods) == hoststats.MAX_PODS
    assert "hoststats_pod_cap" not in port.read().errors
    assert port.debug_payload()["errors"]["hoststats_pod_cap"] == 1


def test_the_ebpf_probe_refuses_and_says_why():
    source, reason = hoststats.probe_runq_source()
    assert (source, reason) == ref_hoststats.probe_runq_source()
    assert source is None and reason
    host = hoststats.HostStats(proc_root="/nonexistent", probe_ebpf=True)
    assert host.debug_payload()["ebpf"] == {"available": False,
                                            "reason": reason}


def test_the_pod_join_takes_the_ports_own_pattern():
    assert hoststats._POD_UID_RE is procopen._POD_UID_RE


def test_the_poll_loop_folds_host_signals_off_the_tick(tmp_path):
    from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
    from kube_gpu_stats_tpu_torch.poll import PollLoop
    from kube_gpu_stats_tpu_torch.registry import Registry

    roots = host_fixture.make_host_tree(tmp_path)
    (roots["proc"] / "pressure" / "memory").write_text("garbage line\n")
    _, host = _pair(roots, Clock())
    registry = Registry()
    loop = PollLoop(MockCollector(2), registry, host_stats=host)
    try:
        loop.tick()
        deadline = time.monotonic() + 5.0
        names: set = set()
        while time.monotonic() < deadline:
            loop.tick()
            names = {s.spec.name for s in registry.snapshot().series}
            if "kts_host_pressure_share" in names:
                break
            time.sleep(0.02)
        assert "kts_host_pressure_share" in names
        errors = {dict(s.labels)["reason"]: s.value
                  for s in registry.snapshot().series
                  if s.spec.name == "collector_poll_errors_total"}
        assert errors.get("hoststats_psi", 0) >= 1
        notes = [t.meta["host"] for t in loop.tracer.traces()
                 if "host" in t.meta]
        assert notes and "cpu_some_avg10" in notes[-1]
    finally:
        loop.stop()


def test_a_disabled_collector_keeps_the_families_absent(tmp_path):
    from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
    from kube_gpu_stats_tpu_torch.poll import PollLoop
    from kube_gpu_stats_tpu_torch.registry import Registry

    roots = host_fixture.make_host_tree(tmp_path)
    _, host = _pair(roots, Clock(), enabled=False)
    registry = Registry()
    loop = PollLoop(MockCollector(1), registry, host_stats=host)
    try:
        for _ in range(3):
            loop.tick()
            time.sleep(0.01)
        names = {s.spec.name for s in registry.snapshot().series}
        assert not any(name.startswith("kts_host_") for name in names)
        assert host.debug_payload() == {"enabled": False}
    finally:
        loop.stop()


@pytest.mark.parametrize("argv,enabled", [([], True),
                                          (["--no-host-stats"], False)])
def test_the_daemon_serves_debug_host(argv, enabled, tmp_path):
    import json
    import urllib.request

    from kube_gpu_stats_tpu_torch import config, daemon

    roots = host_fixture.make_host_tree(tmp_path)
    cfg = config.from_args([
        "--backend", "mock", "--mock-devices", "1", "--listen-host",
        "127.0.0.1", "--listen-port", "0", "--interval", "0.05",
        "--attribution", "off", "--proc-root", str(roots["proc"]),
        "--sysfs-root", str(roots["sysfs"]), "--cgroup-root",
        str(roots["cgroup"]), *argv])
    instance = daemon.Daemon(cfg)
    instance.start()
    try:
        url = f"http://127.0.0.1:{instance.server.port}/debug/host"
        deadline = time.monotonic() + 10
        while True:
            payload = json.loads(urllib.request.urlopen(url).read())
            if not enabled or payload.get("read_at"):
                break
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        instance.stop()
    assert payload["enabled"] is enabled
    if enabled:
        assert payload["pods"][POD_UID]["cpu_seconds"] == pytest.approx(1.0)
        assert payload["thermal_celsius"] == {"zone0_x86_pkg_temp": 45.0}


def test_the_daemon_joins_pod_uids_through_the_cards_holders():
    """pod UID -> (pod, namespace): a card's holder carrying a pod UID
    ties it to the kubelet's pod for that card, as the reference's
    daemon joins it."""
    from types import SimpleNamespace

    from kube_gpu_stats_tpu import daemon as ref_daemon
    from kube_gpu_stats_tpu_torch import daemon
    from kube_gpu_stats_tpu_torch.collectors import Device

    devices = [Device(i, str(i), f"/dev/nvidia{i}", "gpu-h100")
               for i in range(3)]
    pods = {"0": {"pod": "train-0", "namespace": "ml"},
            "1": {"pod": "train-1", "namespace": "ml"}, "2": {}}
    holders = {"/dev/nvidia0": [("11", "python", POD_UID, 1.0),
                                ("12", "bash", "", 1.0)],
               "/dev/nvidia1": [("21", "python", "uid-b", 1.0)],
               "/dev/nvidia2": [("31", "python", "uid-c", 1.0)]}
    fake = SimpleNamespace(
        procwatch=SimpleNamespace(lookup=lambda path: holders[path]),
        poll=SimpleNamespace(devices=devices),
        attribution=SimpleNamespace(lookup=lambda dev: pods[dev.device_id]))
    want = {POD_UID: ("train-0", "ml"), "uid-b": ("train-1", "ml")}
    assert daemon.Daemon._pod_uid_map(fake) == want
    assert ref_daemon.Daemon._pod_uid_map(fake) == want
    fake.procwatch = None
    assert daemon.Daemon._pod_uid_map(fake) == {}
