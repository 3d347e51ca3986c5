"""The reference's fault-injection suite on the port's NVML daemon.

One case per test of ``tests/test_fault_injection.py``. Each runs the
reference's scenario on its own fixtures (sysfs tree, fake libtpu server,
fake kubelet, mock collector) and the NVML counterpart of the fault on
the port over ``testing.fake_nvml``, on the same tick schedule, and
compares the per-tick outcomes: ``accelerator_up`` per card, which
families vanish, ``stale`` labels, breaker state and trips, and
``kts_component_restarts_total``. The faults are scripted over the fake
by ``testing.nvml_faults.NvmlFaults``, the wrapper the on-card smoke
scripts them with over the real binding.

Where the port rightly behaves otherwise, the case says so:

- NVML has no reading that survives a library outage the way sysfs
  survives libtpu's. Where the reference serves a chip up with its
  environment-only gauges (runtime down, breaker still closed), the port
  serves the card down; under the open breaker both serve the card down
  and label what is left ``stale="true"`` (the reference: the sysfs
  gauges; the port: the retained memory total).
- One NVML read covers every family of a card, so a stalled read costs
  the card its tick (``accelerator_up 0``, nothing old served) where the
  reference keeps the chip up on fresh sysfs values.
- A lost card fails alone (``NVML_ERROR_GPU_IS_LOST``, per card): it is
  down without ``stale`` labels and the breaker stays closed. The
  reference's per-port breaker marks a dead process's chips stale.
- NVML has no uptime reading, so a driver reload does not count in
  ``accelerator_runtime_restarts_total`` (the reference counts the
  runtime's uptime drop).
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request

import pytest

from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu.collectors.composite import TpuCollector
from kube_gpu_stats_tpu.collectors.libtpu import LibtpuClient
from kube_gpu_stats_tpu.collectors.mock import MockCollector as RefMock
from kube_gpu_stats_tpu.exposition import MetricsServer as RefServer
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
from kube_gpu_stats_tpu.supervisor import Supervisor as RefSupervisor
from kube_gpu_stats_tpu.testing.libtpu_server import FakeLibtpuServer
from kube_gpu_stats_tpu.testing.sysfs_fixture import make_sysfs
from kube_gpu_stats_tpu_torch import doctor, schema
from kube_gpu_stats_tpu_torch.collectors import CollectorError
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.config import Config
from kube_gpu_stats_tpu_torch.daemon import Daemon
from kube_gpu_stats_tpu_torch.exposition import MetricsServer
from kube_gpu_stats_tpu_torch.native import nvml as binding
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry, SnapshotBuilder
from kube_gpu_stats_tpu_torch.supervisor import Supervisor
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml
from kube_gpu_stats_tpu_torch.testing.nvml_faults import (NvmlFaults,
                                                          run_scenarios)

pytestmark = pytest.mark.chaos

DUTY = schema.DUTY_CYCLE.name
BANDWIDTH = schema.ICI_BANDWIDTH.name
KIB_PER_TICK = 4096  # NVLink KiB each link moves per tick, TX and RX each


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _cards(n: int, links: int = 0) -> list[FakeDevice]:
    return [FakeDevice(uuid=f"GPU-{i:08x}-1111-2222-3333-444455556666",
                       minor=i, gpu_util=90, power_mw=300_000,
                       memory_used=(1 + i) * 2**30,
                       nvlink_kib={link: (0, 0) for link in range(links)})
            for i in range(n)]


def _traffic(fake: FakeNvml) -> None:
    """One tick of NVLink traffic on every card's every link."""
    for dev in fake.devices:
        dev.nvlink_kib = {link: (tx + KIB_PER_TICK, rx + KIB_PER_TICK)
                          for link, (tx, rx) in dev.nvlink_kib.items()}


def _collector(fake, clock=None, **kw) -> NvmlCollector:
    if clock is not None:
        kw["clock"] = clock
    return NvmlCollector(fake, **kw)


def _sample(col, dev):
    """One card's sample as the poll loop's split path takes it."""
    try:
        env, err = col.read_environment(dev), None
    except Exception as exc:  # noqa: BLE001 - assemble decides
        env, err = {}, exc
    try:
        return col.assemble(dev, env, err)
    except CollectorError:
        return None  # the loop serves the card down


def _values(snapshot, family: str, **labels) -> list[float]:
    return [s.value for s in snapshot.series if s.spec.name == family
            and all(dict(s.labels).get(k) == v for k, v in labels.items())]


def _ups(snapshot) -> list[float]:
    return _values(snapshot, "accelerator_up")


def outcome(snapshot) -> dict:
    """One tick as the comparison sees it."""
    return {
        "up": tuple(_ups(snapshot)),
        "families": frozenset(s.spec.name for s in snapshot.series
                              if s.spec.name.startswith("accelerator_")),
        "stale": frozenset(s.spec.name for s in snapshot.series
                           if ("stale", "true") in s.labels),
        "up_labelled_stale": any(
            ("stale", "true") in s.labels for s in snapshot.series
            if s.spec.name == "accelerator_up"),
        "breaker": tuple(_values(snapshot, "kts_breaker_state")),
        "trips": tuple(_values(snapshot, "kts_breaker_trips_total")),
        "restarts": tuple(_values(snapshot, "kts_component_restarts_total",
                                  component="poll")),
    }


# -- :31 runtime restart, counters reset ---------------------------------------

def _ref_restart(tmp_path) -> dict:
    make_sysfs(tmp_path, num_chips=2)
    server = FakeLibtpuServer(num_chips=2).start()
    col = TpuCollector(sysfs_root=str(tmp_path),
                       libtpu_client=LibtpuClient(ports=(server.port,),
                                                  rpc_timeout=0.5),
                       use_native=False)
    reg = RefRegistry()
    loop = RefPollLoop(col, reg, deadline=5.0, pipeline_fetch=False)
    ticks = []
    server2 = None
    try:
        for _ in range(2):
            loop.tick()
            ticks.append(outcome(reg.snapshot()))
        server.stop()
        loop.tick()
        ticks.append(outcome(reg.snapshot()))
        server2 = FakeLibtpuServer(num_chips=2, port=server.port).start()
        server2.uptime_base = 3.0
        rates = []
        for _ in range(10):
            loop.tick()
            time.sleep(0.2)
            snap = reg.snapshot()
            rates += _values(snap, ref_schema.ICI_BANDWIDTH.name)
            ticks.append(outcome(snap))
            if _values(snap, ref_schema.ICI_BANDWIDTH.name):
                break
        return {"ticks": ticks, "rates": rates,
                "restarts": _values(reg.snapshot(),
                                    ref_schema.RUNTIME_RESTARTS.name)}
    finally:
        if server2 is not None:
            server2.stop()
        loop.stop()


def test_driver_reload_counters_reset_then_recover(tmp_path):
    """Reference :31. The runtime dies and comes back on the same port
    with its counters reset; here the driver goes away (every call
    ``NVML_ERROR_UNINITIALIZED``) and comes back with the energy and
    NVLink counters at 0. The port serves the cards down while the
    library answers nothing (the reference keeps them up on sysfs), then
    the breaker opens and its probe re-initialises NVML. Both recover
    within the reference's 10 ticks, and no rate ever goes negative or
    spikes."""
    ref = _ref_restart(tmp_path)
    ref_ticks = ref["ticks"]
    assert [t["up"] for t in ref_ticks[:3]] == [(1.0, 1.0)] * 3
    assert ref_schema.DUTY_CYCLE.name not in ref_ticks[2]["families"]
    assert ref_ticks[-1]["up"] == (1.0, 1.0)
    assert ref["rates"] and min(ref["rates"]) >= 0
    assert ref["restarts"] == [1.0, 1.0]

    clock = Clock()
    fake = FakeNvml(_cards(2, links=2))
    faults = NvmlFaults(fake)
    reg = Registry()
    loop = PollLoop(_collector(faults, clock), reg, deadline=5.0,
                    clock=clock, pipeline_fetch=False)
    ticks, rates, joules, epochs = [], [], [], []

    def tick():
        clock.now += 1.0
        _traffic(fake)
        loop.tick()
        snap = reg.snapshot()
        rates.extend(_values(snap, BANDWIDTH))
        joules.append(_values(snap, schema.ENERGY.name))
        ticks.append(outcome(snap))
        epochs.append(fake.epoch)

    try:
        for _ in range(2):
            tick()
        faults.driver_gone()
        tick()
        faults.driver_back(reset=True)
        for _ in range(10):
            tick()
            if ticks[-1]["up"] == (1.0, 1.0) and BANDWIDTH in \
                    ticks[-1]["families"]:
                break
    finally:
        loop.stop()
    assert [t["up"] for t in ticks[:2]] == [(1.0, 1.0)] * 2
    assert ticks[2]["up"] == (0.0, 0.0)  # the reference: (1, 1) on sysfs
    assert DUTY not in ticks[2]["families"]
    assert not ticks[2]["stale"]  # the breaker has not opened yet
    # Fresh within two ticks of the good probe (the tick it ran in, when
    # the session epoch moved, counts as the first); the reference is
    # back within its 10.
    probe = epochs.index(1)
    fresh = next(n for n, t in enumerate(ticks) if n >= probe
                 and t["up"] == (1.0, 1.0) and DUTY in t["families"]
                 and not t["stale"])
    assert fresh - probe + 1 <= 2, (probe, ticks)
    assert ticks[-1]["up"] == (1.0, 1.0)
    assert DUTY in ticks[-1]["families"] and not ticks[-1]["stale"]
    # No negative rate and no spike: each rate is one tick's traffic.
    assert rates and all(r == 2 * KIB_PER_TICK * 1024 for r in rates), rates
    # The joule counters never go back.
    for before, after in zip(joules, joules[1:]):
        assert all(b <= a for b, a in zip(before, after)), joules
    assert fake.epoch == 1  # one fresh session


# -- :100 scrape storm ------------------------------------------------------------

def _storm(loop, server) -> tuple[float, float]:
    def p50(n=30):
        xs = sorted(loop.tick() for _ in range(n))
        return xs[n // 2]

    loop.tick()
    baseline = p50()
    stop = threading.Event()

    def storm():
        while not stop.is_set():
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/metrics",
                    timeout=2).read()
            except Exception:  # noqa: BLE001 - the storm only loads
                pass

    threads = [threading.Thread(target=storm, daemon=True)
               for _ in range(8)]
    for t in threads:
        t.start()
    try:
        stormy = p50()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=2)
        server.stop()
        loop.stop()
    return baseline, stormy


@pytest.mark.parametrize("backend", ["mock", "fake_nvml"])
def test_scrape_storm_does_not_perturb_poll_latency(backend):
    """Reference :100, on the port's mock backend and on NVML over the
    fake: a storm of 8 scrapers stretches the port's median tick no
    further than the reference's bound. The reference's loop runs the
    same storm beside it; its figures are printed, not asserted: a
    timing bound it misses on a loaded host is host noise, not a
    difference of the port."""
    ref_reg = RefRegistry()
    ref_loop = RefPollLoop(RefMock(num_devices=8), ref_reg, deadline=5.0)
    ref_server = RefServer(ref_reg, host="127.0.0.1", port=0)
    ref_server.start()
    ref_baseline, ref_stormy = _storm(ref_loop, ref_server)
    print(f"reference: median tick {ref_baseline:.6f} s, under the storm "
          f"{ref_stormy:.6f} s")
    reg = Registry()
    col = (MockCollector(num_devices=8) if backend == "mock"
           else _collector(FakeNvml(_cards(8))))
    loop = PollLoop(col, reg, deadline=5.0)
    server = MetricsServer(reg, host="127.0.0.1", port=0)
    server.start()
    baseline, stormy = _storm(loop, server)
    assert stormy < max(baseline * 5, baseline + 0.010), (baseline, stormy)


# -- :142 hotplug ------------------------------------------------------------------

def _wait_for_cards(reg, n: int) -> bool:
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if len(_ups(reg.snapshot())) == n:
            return True
        reg.wait_for_publish(reg.generation, timeout=5)
    return len(_ups(reg.snapshot())) == n


def test_hotplug_rediscovery_picks_up_a_new_card():
    """Reference :142: a third chip appears and the next rediscovery
    serves it; here a third card appears in NVML's list."""
    class Growing(RefMock):
        grown = False

        def discover(self):
            return RefMock(num_devices=3 if self.grown else 2).discover()

        def sample(self, device):
            if device.index >= 2:
                return RefMock(num_devices=3,
                               start_tick=5).sample(device)
            return super().sample(device)

    counts = []
    ref_col = Growing(num_devices=2)
    fake = FakeNvml(_cards(2))
    for col, reg, loop_cls in (
            (ref_col, RefRegistry(), RefPollLoop),
            (_collector(fake), Registry(), PollLoop)):
        loop = loop_cls(col, reg, interval=0.01, deadline=5.0,
                        rediscovery_interval=0.05)
        loop.start()
        try:
            assert reg.wait_for_publish(0, timeout=5)
            before = len(_ups(reg.snapshot()))
            if col is ref_col:
                ref_col.grown = True
            else:
                fake.devices.append(_cards(3)[2])
            assert _wait_for_cards(reg, 3)
            counts.append((before, len(_ups(reg.snapshot())),
                           _ups(reg.snapshot())))
        finally:
            loop.stop()
    assert counts[0] == counts[1] == (2, 3, [1.0, 1.0, 1.0])


# -- :178 failing rediscovery --------------------------------------------------------

def test_failing_rediscovery_keeps_serving():
    """Reference :178: a rediscovery that fails keeps the known devices
    and counts ``reason="rediscover"``; here ``nvmlDeviceGetCount_v2``
    fails."""
    class Flaky(RefMock):
        calls = 0

        def discover(self):
            self.calls += 1
            if self.calls > 1:
                raise RuntimeError("sysfs went away")
            return super().discover()

    faults = NvmlFaults(FakeNvml(_cards(2)))

    def fail():
        faults.count_error = binding.NVML_ERROR_UNKNOWN

    got = []
    for col, reg, loop_cls, fault in (
            (Flaky(num_devices=2), RefRegistry(), RefPollLoop, lambda: None),
            (_collector(faults), Registry(), PollLoop, fail)):
        loop = loop_cls(col, reg, deadline=5.0)
        try:
            loop.tick()
            fault()
            loop.rediscover()
            loop.tick()
            snap = reg.snapshot()
            got.append((outcome(snap)["up"],
                        _values(snap, "collector_poll_errors_total",
                                reason="rediscover")))
        finally:
            loop.stop()
    assert got[0] == got[1] == ((1.0, 1.0), [1.0])


# -- :207 tick crash -----------------------------------------------------------------

def _run_until(reg, generation: int, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and reg.generation < generation:
        time.sleep(0.01)


def test_tick_crash_does_not_kill_loop():
    """Reference :207: an exception that is not a ``CollectorError``
    escapes ``begin_tick`` on the second tick; the loop counts one
    ``tick_crash`` and keeps publishing. Then the same on NVML's read:
    a read that raises is counted by its type for the card that tick,
    and the card is back on the next."""
    class RefExploding(RefMock):
        calls = 0

        def begin_tick(self):
            self.calls += 1
            if self.calls == 2:
                raise TypeError("unexpected proto shape")

    class Exploding(NvmlCollector):
        calls = 0

        def begin_tick(self):
            self.calls += 1
            if self.calls == 2:
                raise TypeError("unexpected NVML answer")
            super().begin_tick()

    crashes = []
    for col, reg, loop_cls in (
            (RefExploding(num_devices=1), RefRegistry(), RefPollLoop),
            (Exploding(FakeNvml(_cards(1))), Registry(), PollLoop)):
        loop = loop_cls(col, reg, interval=0.01, deadline=5.0)
        loop.start()
        try:
            _run_until(reg, 5)
            assert reg.generation >= 5
            snap = reg.snapshot()
            crashes.append((_values(snap, "collector_poll_errors_total",
                                    reason="tick_crash"), _ups(snap)))
        finally:
            loop.stop()
    assert crashes[0] == crashes[1] == ([1.0], [1.0])

    fake = FakeNvml(_cards(2))
    reg = Registry()
    loop = PollLoop(_collector(fake), reg, deadline=5.0,
                    pipeline_fetch=False)
    real = fake.temperature
    calls = {"n": 0}

    def temperature(handle):
        calls["n"] += 1
        if calls["n"] == 3:  # card 0 on the second tick
            raise TypeError("unexpected NVML answer")
        return real(handle)

    fake.temperature = temperature
    try:
        ups = []
        for _ in range(3):
            loop.tick()
            ups.append(tuple(_ups(reg.snapshot())))
        snap = reg.snapshot()
    finally:
        loop.stop()
    assert ups[0] == ups[2] == (1.0, 1.0)
    assert sorted(ups[1]) == [0.0, 1.0]
    assert _values(snap, "collector_poll_errors_total",
                   reason="TypeError") == [1.0]


# -- :240 /healthz when the poll dies ----------------------------------------------

def _status(url: str) -> int:
    try:
        return urllib.request.urlopen(url, timeout=2).status
    except urllib.error.HTTPError as exc:
        return exc.code


def test_healthz_goes_unhealthy_when_poll_dies():
    """Reference :240: 503 before the first snapshot, 200 after it, 503
    once no snapshot came for longer than the max age."""
    statuses = []
    for server_cls, reg, builder in ((RefServer, RefRegistry(), RefBuilder),
                                     (MetricsServer, Registry(),
                                      SnapshotBuilder)):
        server = server_cls(reg, host="127.0.0.1", port=0,
                            healthz_max_age=0.2)
        server.start()
        url = f"http://127.0.0.1:{server.port}/healthz"
        try:
            seen = [_status(url)]
            reg.publish(builder().build())
            seen.append(_status(url))
            time.sleep(0.4)
            seen.append(_status(url))
        finally:
            server.stop()
        statuses.append(seen)
    assert statuses[0] == statuses[1] == [503, 200, 503]


# -- :267 a slow read degrades fresh, not stale -------------------------------------

def _ref_slow_runtime(tmp_path) -> list[dict]:
    make_sysfs(tmp_path, num_chips=2)
    server = FakeLibtpuServer(num_chips=2).start()
    col = TpuCollector(sysfs_root=str(tmp_path),
                       libtpu_client=LibtpuClient(ports=(server.port,),
                                                  rpc_timeout=5.0),
                       use_native=False)
    reg = RefRegistry()
    loop = RefPollLoop(col, reg, deadline=0.4, pipeline_fetch=False)
    ticks = []
    try:
        loop.tick()
        ticks.append(outcome(reg.snapshot()))
        server.delay = 2.0
        loop.tick()
        ticks.append(outcome(reg.snapshot()))
        server.delay = 0.0
        col.wait_ready(5.0)
        loop.tick()
        loop.tick()
        ticks.append(outcome(reg.snapshot()))
        return ticks
    finally:
        loop.stop()
        server.stop()
        col.close()


def test_slow_read_degrades_fresh_not_stale(tmp_path):
    """Reference :267: a read slower than the tick deadline must not
    serve the last tick's values as fresh. Here a stalled
    ``utilization`` read past a 0.4 s deadline, ``pipeline_fetch=False``.
    The reference keeps the chips up on this tick's sysfs values; one
    NVML read covers the whole card, so the port serves the card down,
    keeps only the retained memory total, serves no duty cycle from the
    last tick, and labels nothing stale. Both are back after the stall."""
    ref = _ref_slow_runtime(tmp_path)
    assert ref[1]["up"] == (1.0, 1.0)
    assert ref_schema.DUTY_CYCLE.name not in ref[1]["families"]
    assert ref_schema.MEMORY_TOTAL.name in ref[1]["families"]
    assert ref_schema.DUTY_CYCLE.name in ref[2]["families"]

    faults = NvmlFaults(FakeNvml(_cards(2)))
    reg = Registry()
    loop = PollLoop(_collector(faults), reg, deadline=0.4,
                    pipeline_fetch=False)
    ticks = []
    try:
        loop.tick()
        ticks.append(outcome(reg.snapshot()))
        faults.stalls = {card: {"utilization": (1.0, 1)} for card in (0, 1)}
        loop.tick()
        ticks.append(outcome(reg.snapshot()))
        faults.stalls = {}
        assert loop.settle(5.0)
        loop.tick()
        loop.tick()
        ticks.append(outcome(reg.snapshot()))
    finally:
        loop.stop()
    assert ticks[0]["up"] == (1.0, 1.0) and DUTY in ticks[0]["families"]
    assert ticks[1]["up"] == (0.0, 0.0)
    assert DUTY not in ticks[1]["families"]
    assert schema.MEMORY_TOTAL.name in ticks[1]["families"]
    assert not ticks[1]["stale"] and not ref[1]["stale"]
    assert ticks[2]["up"] == (1.0, 1.0) and DUTY in ticks[2]["families"]


# -- :313 the breaker opens, stale labels, recovery ---------------------------------

def _ref_breaker(tmp_path) -> dict:
    make_sysfs(tmp_path, num_chips=2)
    server = FakeLibtpuServer(num_chips=2).start()
    col = TpuCollector(
        sysfs_root=str(tmp_path),
        libtpu_client=LibtpuClient(ports=(server.port,), rpc_timeout=0.5,
                                   breaker_recovery_time=0.05,
                                   breaker_min_span=0.0),
        use_native=False)
    sup = RefSupervisor()
    sup.register_breaker_provider(col.breakers)
    reg = RefRegistry()
    loop = RefPollLoop(col, reg, deadline=5.0, health_stats=sup.contribute,
                       pipeline_fetch=False)
    ticks = []
    server2 = None
    try:
        loop.tick()
        ticks.append(outcome(reg.snapshot()))
        server.stop()
        for _ in range(4):
            loop.tick()
            ticks.append(outcome(reg.snapshot()))
        server2 = FakeLibtpuServer(num_chips=2, port=server.port).start()
        time.sleep(0.06)
        recovered = None
        for attempt in range(10):
            loop.tick()
            ticks.append(outcome(reg.snapshot()))
            if ticks[-1]["up"] == (1.0, 1.0):
                recovered = attempt
                break
            time.sleep(0.2)
        return {"ticks": ticks, "recovered": recovered}
    finally:
        if server2 is not None:
            server2.stop()
        loop.stop()
        col.close()


def _port_breaker(fake: FakeNvml, recover: bool = True) -> dict:
    clock = Clock()
    faults = NvmlFaults(fake)
    col = _collector(faults, clock)
    sup = Supervisor()
    sup.register_breaker_provider(col.breakers)
    reg = Registry()
    loop = PollLoop(col, reg, deadline=5.0, clock=clock,
                    health_stats=sup.contribute, pipeline_fetch=False)
    ticks, rates = [], []

    def tick():
        clock.now += 1.0
        _traffic(fake)
        loop.tick()
        snap = reg.snapshot()
        rates.extend(_values(snap, BANDWIDTH))
        ticks.append(outcome(snap))

    recovered = None
    try:
        tick()
        faults.driver_gone()
        for _ in range(4):
            tick()
        open_state = col.breaker.state
        if recover:
            faults.driver_back(reset=True)
            for attempt in range(10):
                tick()
                if ticks[-1]["up"] == (1.0, 1.0):
                    recovered = attempt
                    break
        return {"ticks": ticks, "recovered": recovered, "rates": rates,
                "open_state": open_state, "collector": col,
                "snapshot": reg.snapshot()}
    finally:
        loop.stop()


def test_breaker_opens_stale_labels_then_recovers(tmp_path):
    """Reference :313. The runtime stays down for 3+ rounds; here the
    driver is gone for 4. On the fourth round the breaker is open in
    both: the cards serve ``accelerator_up 0`` with its base identity,
    nothing is fabricated, what is still served carries
    ``stale="true"``, ``kts_breaker_state`` reads 2 and one trip is
    counted. After the driver is back, the probe re-initialises NVML and
    the cards are up and fresh within two ticks, with the breaker closed
    and no negative rate. Before the breaker opens the reference keeps
    the chips up on sysfs; the port serves them down."""
    ref = _ref_breaker(tmp_path)
    fake = FakeNvml(_cards(2, links=2))
    port = _port_breaker(fake)
    assert port["open_state"] == "open"
    for side in (ref, port):
        ticks = side["ticks"]
        assert ticks[0]["up"] == (1.0, 1.0)
        assert ticks[0]["breaker"] == (0.0,)
        under = ticks[4]  # the first tick under the open breaker
        assert under["up"] == (0.0, 0.0)
        assert DUTY not in under["families"]
        assert under["stale"] and not under["up_labelled_stale"]
        assert under["breaker"] == (2.0,) and under["trips"] == (1.0,)
        assert side["recovered"] is not None and side["recovered"] <= 1
        last = ticks[-1]
        assert last["up"] == (1.0, 1.0) and DUTY in last["families"]
        assert not last["stale"] and last["breaker"] == (0.0,)
    assert ref["ticks"][4]["stale"] == {ref_schema.POWER.name,
                                        ref_schema.TEMPERATURE.name} or \
        ref_schema.POWER.name in ref["ticks"][4]["stale"]
    assert port["ticks"][4]["stale"] == {schema.MEMORY_TOTAL.name}
    # Before the open breaker's first tick: the reference serves its
    # chips up on sysfs until the tick that trips the breaker, which is
    # already stale; the port serves the cards down, not stale, until
    # the next round's start records the third failed round.
    assert [t["up"] for t in ref["ticks"][1:3]] == [(1.0, 1.0)] * 2
    assert ref["ticks"][3]["up"] == (0.0, 0.0) and ref["ticks"][3]["stale"]
    assert [t["up"] for t in port["ticks"][1:4]] == [(0.0, 0.0)] * 3
    assert not any(t["stale"] for t in port["ticks"][1:4])
    assert all(r >= 0 for r in port["rates"])
    assert fake.epoch == 1


def test_breaker_open_shows_in_a_scrape_and_in_the_doctor():
    """The daemon registers the collector's breaker: under the open
    breaker a scrape of ``/metrics`` reads
    ``kts_breaker_state{component="nvml"} 2`` and the doctor's
    ``resilience`` row fails naming ``nvml``; after the driver is back,
    both read closed."""
    faults = NvmlFaults(FakeNvml(_cards(2)))
    d = Daemon(Config(backend="nvml", interval=0.1, listen_host="127.0.0.1",
                      listen_port=0, attribution="off",
                      pipeline_fetch=False, rediscovery_interval=0),
               nvml=faults)
    d.start()
    url = f"http://127.0.0.1:{d.server.port}/metrics"

    def scrape() -> str:
        return urllib.request.urlopen(url, timeout=5).read().decode()

    def wait_for(text: str, timeout: float = 10.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            body = scrape()
            if text in body:
                return body
            time.sleep(0.05)
        raise AssertionError(f"{text!r} never served")

    try:
        wait_for('kts_breaker_state{component="nvml"} 0')
        assert doctor.resilience_result(d.collector).status == doctor.OK
        faults.driver_gone()
        body = wait_for('kts_breaker_state{component="nvml"} 2')
        assert 'kts_breaker_trips_total{component="nvml"} 1' in body
        row = doctor.resilience_result(d.collector)
        assert row.status == doctor.FAIL and "nvml" in row.detail
        faults.driver_back()
        wait_for('kts_breaker_state{component="nvml"} 0')
        body = wait_for('accelerator_up{')
        deadline = time.monotonic() + 5
        while body.count(" 1\n") == 0 or "accelerator_duty_cycle{" \
                not in body:
            assert time.monotonic() < deadline
            time.sleep(0.05)
            body = scrape()
        row = doctor.resilience_result(d.collector)
        # Closed again; the trip stays on record, so the row warns.
        assert row.status == doctor.WARN
        assert row.detail.startswith("nvml: closed, 1 trip(s)")
    finally:
        d.stop()


def test_probe_with_another_session_open_keeps_the_breaker_open():
    """NVML counts its inits: while another holder in the process (the
    embedded exporter's UUID lookup) keeps a session open, the probe's
    shutdown does not end the library's, the probe's enumeration still
    fails and the breaker opens again. Once the holder lets go, the next
    probe opens a fresh session."""
    clock = Clock()
    fake = FakeNvml(_cards(2))
    faults = NvmlFaults(fake)
    col = _collector(faults, clock)
    (dev0, dev1) = col.discover()
    fake.init()  # the other holder, on the library itself
    faults.driver_gone()
    for _ in range(4):  # the fourth round's start records the third
        clock.now += 1.0
        col.begin_tick()
        for dev in (dev0, dev1):
            _sample(col, dev)
    assert col.breaker.state == "open"
    faults.driver_back()
    clock.now += 1.0
    col.begin_tick()  # probe: shutdown + init leave the old session
    assert col.breaker.state == "open" and col.breaker.trips_total == 2
    assert col.reinits_total == 0 and faults.inits[-1][1] is False
    fake.shutdown()  # the other holder lets go
    clock.now += 1.0
    col.begin_tick()
    assert col.breaker.state == "closed" and col.reinits_total == 1
    assert faults.inits[-1][1] is True and fake.epoch == 1
    sample = col.sample(dev0)
    assert sample.values[DUTY] == 90.0 and not sample.stale
    col.close()


# -- :398 a hung tick is respawned ------------------------------------------------------

def test_hung_tick_respawned_by_supervisor_watchdog():
    """Reference :398: ``begin_tick`` blocks; the watchdog respawns the
    loop, ``kts_component_restarts_total{component="poll"}`` counts it,
    and ``/metrics`` answers throughout. Here over NVML."""
    def hanging(base):
        class Hanging(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self.hang = threading.Event()
                self.hung = threading.Event()
                self.release = threading.Event()

            def begin_tick(self):
                if self.hang.is_set():
                    self.hang.clear()
                    self.hung.set()
                    self.release.wait(30)
                super().begin_tick()
        return Hanging

    got = []
    for col, reg, sup, loop_cls, server_cls in (
            (hanging(RefMock)(num_devices=1), RefRegistry(),
             RefSupervisor(check_interval=0.05), RefPollLoop, RefServer),
            (hanging(NvmlCollector)(FakeNvml(_cards(1))), Registry(),
             Supervisor(check_interval=0.05), PollLoop, MetricsServer)):
        loop = loop_cls(col, reg, interval=0.05, deadline=5.0,
                        heartbeat=sup.beater("poll"),
                        health_stats=sup.contribute)
        sup.register("poll", is_alive=loop.thread_alive,
                     restart=loop.respawn, heartbeat_timeout=0.5)
        server = server_cls(reg, host="127.0.0.1", port=0)
        server.start()
        loop.start()
        sup.start()
        try:
            _run_until(reg, 2)
            before = outcome(reg.snapshot())["restarts"]
            col.hang.set()
            assert col.hung.wait(5)
            wedged_at = reg.generation
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=2).read()
            assert b"accelerator_up" in body
            _run_until(reg, wedged_at + 3, timeout=10)
            assert reg.generation >= wedged_at + 3, "loop never respawned"
            after = outcome(reg.snapshot())
            got.append((before, after["restarts"], after["up"]))
        finally:
            col.release.set()
            sup.stop()
            loop.stop()
            server.stop()
    assert got[0] == got[1] == ((0.0,), (1.0,), (1.0,))


# -- :471 kubelet socket loss ------------------------------------------------------------

def test_kubelet_socket_loss_last_good_mapping_stale_then_fresh(tmp_path):
    """Reference :471: the kubelet's socket goes away; attribution
    serves the last good mapping labelled ``stale="true"`` once the
    kubelet breaker opens, then the new allocation, fresh, once the
    socket is back. Here the port's PodResources client under NVML
    cards allocated as ``nvidia.com/gpu`` by UUID."""
    from kube_gpu_stats_tpu.attribution import CachedAttribution as RefCached
    from kube_gpu_stats_tpu.attribution.podresources import \
        PodResourcesSource as RefSource
    from kube_gpu_stats_tpu.resilience import CircuitBreaker as RefBreaker
    from kube_gpu_stats_tpu.testing.kubelet_server import (FakeKubeletServer,
                                                           tpu_pod)
    from kube_gpu_stats_tpu_torch.attribution import CachedAttribution
    from kube_gpu_stats_tpu_torch.attribution.podresources import \
        PodResourcesSource
    from kube_gpu_stats_tpu_torch.resilience import CircuitBreaker

    cards = _cards(2)
    uuids = [card.uuid for card in cards]
    sides = (
        (RefCached, RefSource, RefBreaker, RefMock(num_devices=2),
         RefRegistry(), RefPollLoop, ["0", "1"], "google.com/tpu",
         ref_schema.POWER.name),
        (CachedAttribution, PodResourcesSource, CircuitBreaker,
         _collector(FakeNvml(cards)), Registry(), PollLoop, uuids,
         "nvidia.com/gpu", schema.POWER.name),
    )
    got = []
    for (cached_cls, source_cls, breaker_cls, col, reg, loop_cls, ids,
         resource, power) in sides:
        socket_path = str(tmp_path / f"kubelet-{len(got)}.sock")
        server = FakeKubeletServer(
            socket_path, [tpu_pod("train", "ml", "worker", ids,
                                  resource=resource)]).start()
        cached = cached_cls(
            source_cls(socket_path, rpc_timeout=2.0,
                       breaker=breaker_cls("kubelet", failure_threshold=2,
                                           recovery_time=0.05)),
            refresh_interval=60.0)
        loop = loop_cls(col, reg, deadline=5.0, attribution=cached)
        ticks = []

        def record():
            loop.tick()
            snap = reg.snapshot()
            rows = [dict(s.labels) for s in snap.series
                    if s.spec.name == power]
            ticks.append((tuple(_ups(snap)),
                          tuple((r["pod"], r.get("stale")) for r in rows)))

        server2 = None
        try:
            cached.refresh_once()
            record()
            server.close_socket()
            cached.refresh_once()
            cached.refresh_once()
            assert cached.breaker.state == "open" and cached.stale
            record()
            server2 = FakeKubeletServer(
                socket_path, [tpu_pod("serve", "ml", "worker", ids,
                                      resource=resource)]).start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and cached.stale:
                time.sleep(0.06)
                cached.refresh_once()
            assert not cached.stale
            record()
        finally:
            if server2 is not None:
                server2.stop()
            loop.stop()
        got.append(ticks)
    assert got[0] == got[1] == [
        ((1.0, 1.0), (("train", None), ("train", None))),
        ((1.0, 1.0), (("train", "true"), ("train", "true"))),
        ((1.0, 1.0), (("serve", None), ("serve", None))),
    ]


# -- :544 a partial outage stales only its cards ----------------------------------------

def test_partial_outage_downs_only_the_lost_card(tmp_path):
    """Reference :544: one runtime process of two dies and only its chips
    go down. Here 1 of 4 cards is lost: only it goes down, the other
    three stay up and fresh, and the breaker stays closed (one lost card
    is not a library outage). The reference labels the dead process's
    chips stale; the lost card carries no stale label."""
    make_sysfs(tmp_path, num_chips=4)
    server_a = FakeLibtpuServer(num_chips=2).start()
    server_b = FakeLibtpuServer(num_chips=2, chip_offset=2).start()
    col = TpuCollector(
        sysfs_root=str(tmp_path),
        libtpu_client=LibtpuClient(
            ports=(server_a.port, server_b.port), rpc_timeout=0.5,
            breaker_recovery_time=30.0, breaker_min_span=0.0),
        use_native=False)
    reg = RefRegistry()
    loop = RefPollLoop(col, reg, deadline=5.0, pipeline_fetch=False)
    try:
        loop.tick()
        server_b.stop()
        for _ in range(4):
            loop.tick()
        ref = reg.snapshot()
    finally:
        loop.stop()
        server_a.stop()
        col.close()
    ref_duty = {dict(s.labels)["chip"] for s in ref.series
                if s.spec.name == ref_schema.DUTY_CYCLE.name}

    clock = Clock()
    faults = NvmlFaults(FakeNvml(_cards(4)))
    ncol = _collector(faults, clock)
    sup = Supervisor()
    sup.register_breaker_provider(ncol.breakers)
    reg = Registry()
    loop = PollLoop(ncol, reg, deadline=5.0, clock=clock,
                    health_stats=sup.contribute, pipeline_fetch=False)
    try:
        loop.tick()
        faults.lost.add(3)
        for _ in range(4):
            clock.now += 1.0
            loop.tick()
        port = reg.snapshot()
    finally:
        loop.stop()
    port_duty = {dict(s.labels)["chip"] for s in port.series
                 if s.spec.name == DUTY}
    assert _ups(ref) == [1.0, 1.0, 0.0, 0.0]
    assert _ups(port) == [1.0, 1.0, 1.0, 0.0]
    # Only the healthy cards serve their readings, in both.
    assert ref_duty == {"0", "1"} and port_duty == {"0", "1", "2"}
    assert outcome(port)["breaker"] == (0.0,)
    assert ncol.breaker.trips_total == 0
    assert not outcome(port)["stale"]


# -- :587 the probe tick stays stale ---------------------------------------------------------

def test_probe_tick_stays_stale_not_flapping(tmp_path):
    """Reference :587: during an outage the half-open probe overruns the
    tick, and that tick must still be stale, not flap the chip up once
    per recovery window. Here ``nvmlInit_v2`` takes 0.5 s in the probe
    and fails (a scripted error): the probe's tick, and the one after,
    serve the card stale, and the breaker is open again; the next
    probe's init succeeds and the card is fresh."""
    make_sysfs(tmp_path, num_chips=1)
    col = TpuCollector(
        sysfs_root=str(tmp_path),
        libtpu_client=LibtpuClient(ports=(1,), rpc_timeout=0.1,
                                   breaker_min_span=0.0,
                                   breaker_recovery_time=30.0),
        use_native=False)
    try:
        (dev,) = col.discover()
        for _ in range(3):
            col.begin_tick()
            col.wait_ready(5.0)
        env = col.read_environment(dev)
        ref = [col.assemble(dev, env, None, runtime_ready=False).stale,
               col.assemble(dev, env, None, runtime_ready=True).stale]
    finally:
        col.close()

    clock = Clock()
    faults = NvmlFaults(FakeNvml(_cards(1)))
    ncol = _collector(faults, clock)
    (ndev,) = ncol.discover()
    faults.driver_gone()
    for _ in range(4):  # the fourth round's start records the third
        clock.now += 1.0
        ncol.begin_tick()
        _sample(ncol, ndev)
    assert ncol.breaker.state == "open"
    faults.driver_back()
    faults.init_delay = 0.5
    faults.init_errors = [binding.NVML_ERROR_UNKNOWN]
    clock.now += 1.0
    started = time.monotonic()
    ncol.begin_tick()  # the probe: slow, and its init fails
    assert time.monotonic() - started >= 0.5
    port = []
    for _ in range(2):
        port.append(_sample(ncol, ndev).stale)
        ncol.begin_tick()  # inside the recovery window: no probe
    assert ref == [True, True]
    assert port == [True, True]
    assert ncol.breaker.state == "open" and ncol.breaker.trips_total == 2
    faults.init_delay = 0.0
    clock.now += 1.0
    ncol.begin_tick()  # the next probe's init succeeds
    sample = _sample(ncol, ndev)
    assert ncol.breaker.state == "closed" and not sample.stale
    assert sample.values[DUTY] == 90.0
    ncol.close()


# -- :619 the pipelined tick sees the runtime die ---------------------------------------------

def test_pipelined_tick_detects_driver_loss(tmp_path):
    """Reference :619: under the default pipelined tick, a runtime death
    shows within a few ticks, never masked by the last completed round.
    Here the driver goes away under the pipelined loop: the duty cycle
    vanishes (the reference keeps power on sysfs; the port serves the
    card down)."""
    found = []
    make_sysfs(tmp_path, num_chips=2)
    server = FakeLibtpuServer(num_chips=2).start()
    ref_col = TpuCollector(sysfs_root=str(tmp_path),
                           libtpu_client=LibtpuClient(ports=(server.port,),
                                                      rpc_timeout=0.5),
                           use_native=False)
    faults = NvmlFaults(FakeNvml(_cards(2)))
    sides = (
        (ref_col, RefRegistry(), RefPollLoop, server.stop,
         ref_schema.DUTY_CYCLE.name),
        (_collector(faults), Registry(), PollLoop, faults.driver_gone, DUTY),
    )
    try:
        for col, reg, loop_cls, fault, duty in sides:
            loop = loop_cls(col, reg, interval=0.05, deadline=5.0)
            try:
                loop.tick()
                loop.tick()
                assert duty in outcome(reg.snapshot())["families"]
                fault()
                ticks = 0
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    loop.tick()
                    ticks += 1
                    if duty not in outcome(reg.snapshot())["families"]:
                        break
                    time.sleep(0.05)
                snap = outcome(reg.snapshot())
                found.append((duty in snap["families"], snap["up"], ticks))
            finally:
                loop.stop()
    finally:
        server.stop()
        ref_col.close()
    (ref_duty, ref_up, ref_ticks), (port_duty, port_up, port_ticks) = found
    assert not ref_duty and not port_duty
    assert ref_up == (1.0, 1.0) and port_up == (0.0, 0.0)
    assert port_ticks <= max(ref_ticks, 3), found


# -- the smoke's faults phase, over the fake --------------------------------------

def test_the_smoke_faults_scenarios_pass_over_the_fake():
    """``testing.nvml_faults.run_scenarios``, which the on-card smoke
    drives over the real binding, passes over the fake: a lost card,
    the driver gone until the breaker opens and back, a hung tick, and a
    short soak with the card flapping under scrapers."""
    faults = NvmlFaults(FakeNvml(_cards(1, links=2)))
    d = Daemon(Config(backend="nvml", interval=0.1, listen_host="127.0.0.1",
                      listen_port=0, attribution="off"), nvml=faults)
    d.start()
    try:
        assert d.registry.wait_for_publish(0, timeout=10)
        got = run_scenarios(d, faults, soak_s=2.0, flap_s=0.4, scrapers=2)
    finally:
        d.stop()
    lost, gone = got["lost"], got["driver_gone"]
    assert lost["detect_ticks"] <= 2 and lost["recover_ticks"] <= 2
    assert lost["trips"] == 0
    assert gone["trips"] == 1 and gone["reinits"] == 1
    assert gone["fresh_after_probe_ticks"] <= 2 and gone["doctor"] == "fail"
    assert gone["init_ms"] >= 0 and gone["cold_init_ms"] >= 0
    assert gone["stale_families"] == [schema.MEMORY_TOTAL.name]
    assert got["hung_tick"]["restarts"] == 1
    soak = got["soak"]
    assert soak["flaps"] >= 4 and soak["threads_after"] \
        <= soak["threads_before"] + 8


def test_the_card_wrapper_passes_calls_on_and_scripts_faults():
    """``testing.nvml_faults.NvmlFaults``, the smoke's wrapper of the real
    binding, here over the fake: calls pass through; a lost card answers
    ``GPU_IS_LOST``; a stalled card's every Nth call of a name sleeps;
    with the driver gone every call answers ``UNINITIALIZED``, and init
    and shutdown ``DRIVER_NOT_LOADED`` (they stay paired); once back, an
    init while another holder keeps the library open leaves the calls
    failing, and the init of a fresh session clears the fault."""
    from kube_gpu_stats_tpu_torch.native.nvml import NvmlError

    fake = FakeNvml(_cards(2))
    faults = NvmlFaults(fake)
    faults.init()
    h0, h1 = faults.handle(0), faults.handle(1)
    assert faults.uuid(h0) == fake.devices[0].uuid
    assert faults.utilization(h1) == (90, 0)

    def code(call, *args):
        with pytest.raises(NvmlError) as info:
            call(*args)
        return info.value.code

    faults.lost.add(1)
    assert code(faults.memory, h1) == binding.NVML_ERROR_GPU_IS_LOST
    assert faults.power_mw(h0) == 300_000
    faults.lost.clear()
    faults.stalls[0] = {"temperature": (0.2, 2)}
    started = time.monotonic()
    faults.power_mw(h0)
    faults.temperature(h0)
    assert time.monotonic() - started < 0.2
    faults.temperature(h0)
    assert time.monotonic() - started >= 0.2
    faults.stalls.clear()
    faults.driver_gone()
    assert code(faults.device_count) == binding.NVML_ERROR_UNINITIALIZED
    assert code(faults.utilization, h0) == binding.NVML_ERROR_UNINITIALIZED
    assert code(faults.shutdown) == binding.NVML_ERROR_DRIVER_NOT_LOADED
    assert code(faults.init) == binding.NVML_ERROR_DRIVER_NOT_LOADED
    faults.driver_back()
    fake.init()  # another holder
    faults.shutdown()
    faults.init()  # the library stayed open: no fresh session
    assert code(faults.device_count) == binding.NVML_ERROR_UNINITIALIZED
    fake.shutdown()
    faults.shutdown()
    faults.init()
    assert faults.gone is None and [fresh for _ms, fresh in faults.inits] \
        == [True, False, True]
    assert faults.device_count() == 2 and fake.epoch == 1
    assert code(faults.uuid, h0) == binding.NVML_ERROR_INVALID_ARGUMENT
    faults.shutdown()
