"""The port's PollLoop against the JAX package's, tick by tick.

One scripted collector per trait (the reference's ``Collector`` and the
port's), both drawing each (device, tick) sample from the same seeded
numpy generator — healthy, failing, stale, restarted, with interconnect
counters (and a counter reset), collective ops, passthrough values and
DCN percentiles. Both loops run on an injected clock that the test moves
one interval per tick. The per-device families must render
byte-identically, the deterministic self-metrics line for line, and every
other self-metric family with the same name, TYPE and HELP.
"""

import numpy as np
import pytest

from kube_gpu_stats_tpu import collectors as ref_collectors
from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu import wal as ref_wal
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu_torch import collectors as port_collectors
from kube_gpu_stats_tpu_torch import wal as port_wal
from kube_gpu_stats_tpu_torch.poll import PollLoop as PortPollLoop
from kube_gpu_stats_tpu_torch.registry import Registry as PortRegistry

TICKS = 6
DEVICES = 3
TOPOLOGY = {"slice": "s1", "worker": "2", "topology": "2x2"}
PER_DEVICE = {spec.name for spec in ref_schema.PER_DEVICE_METRICS}
# Self-metrics whose values depend only on the script, not on timing.
DETERMINISTIC = {"collector_devices", "collector_poll_errors_total",
                 "kts_tick_plan_compiles_total",
                 "kts_tick_plan_cache_hits_total", "collector_info",
                 "kts_build_info"}


def _script(seed: int, device: int, tick: int):
    """What device ``device`` reports at tick ``tick``: None for a failed
    read, else (values, ici, collective_ops, raw, stale)."""
    rng = np.random.default_rng([seed, device, tick])
    if rng.random() < 0.15:
        return None
    values = {
        ref_schema.DUTY_CYCLE.name: round(float(rng.uniform(0, 100)), 1),
        ref_schema.POWER.name: round(float(rng.uniform(50, 700)), 1),
        ref_schema.TEMPERATURE.name: float(rng.integers(30, 90)),
        ref_schema.MEMORY_USED.name: float(rng.integers(0, 80 << 30)),
        # Uptime goes backwards once: a runtime restart.
        ref_schema.UPTIME.name: float(1000 * (tick < 4) + 10 * tick),
    }
    if rng.random() < 0.8:
        values[ref_schema.MEMORY_TOTAL.name] = float(80 << 30)
    for key in ref_schema.PERCENTILE_VALUE_KEYS:
        values[key] = float(rng.uniform(0, 1e-3))
    # Cumulative link counters; link "nvlink1" resets at tick 4.
    ici = {"nvlink0": 1000 * tick * (device + 1),
           "nvlink1": (5000 * tick if tick != 4 else 7)}
    raw = {("vendor_counter", "nvlink0"): float(rng.integers(0, 100))}
    return values, ici, int(rng.integers(0, 1000)), raw, rng.random() < 0.1


def _collector(module):
    class Scripted(module.Collector):
        name = "scripted"

        def __init__(self, seed):
            self.seed = seed
            self.tick_no = 0

        def discover(self):
            return [module.Device(i, str(i), f"/dev/nvidia{i}", "gpu-h100",
                                  f"GPU-{i}") for i in range(DEVICES)]

        def begin_tick(self):
            self.tick_no += 1

        def sample(self, device):
            got = _script(self.seed, device.index, self.tick_no)
            if got is None:
                raise module.CollectorError("scripted outage")
            values, ici, ops, raw, stale = got
            return module.Sample(device=device, values=values,
                                 ici_counters=ici, collective_ops=ops,
                                 raw_values=raw, stale=stale)

    return Scripted


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.fixture(autouse=True)
def no_stores_from_other_tests():
    """The store-health registries are process-global: a server started
    by an earlier test in this process (its HTTP accept fence is a store)
    would add the kts_store_* families to one side's self-metrics."""
    ref_wal.reset_store_stats()
    port_wal.reset_store_stats()


def _loops(seed):
    clocks = (Clock(), Clock())
    common = dict(interval=1.0, deadline=30.0, topology_labels=TOPOLOGY,
                  version="test")
    ref_registry, port_registry = RefRegistry(native=False), PortRegistry()
    ref = RefPollLoop(_collector(ref_collectors)(seed), ref_registry,
                      clock=clocks[0], **common)
    port = PortPollLoop(_collector(port_collectors)(seed), port_registry,
                        clock=clocks[1], **common)
    return (ref, ref_registry), (port, port_registry), clocks


def _families(text: str) -> dict[str, list[str]]:
    """family -> its lines (HELP, TYPE, samples) in render order."""
    out: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            current = line.split()[2]
        out.setdefault(current, []).append(line)
    return out


def _run(seed):
    (ref, ref_reg), (port, port_reg), clocks = _loops(seed)
    try:
        for _ in range(TICKS):
            ref.tick()
            port.tick()
            yield (_families(ref_reg.rendered()[0].decode()),
                   _families(port_reg.rendered()[0].decode()))
            for clock in clocks:
                clock.now += 1.0
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("seed", range(5))
def test_device_families_render_identically(seed):
    seen = set()
    for want, got in _run(seed):
        device_want = {f: v for f, v in want.items() if f in PER_DEVICE}
        device_got = {f: v for f, v in got.items() if f in PER_DEVICE}
        assert list(device_got) == list(device_want)
        assert device_got == device_want
        seen |= set(device_want)
    # The script reached every shape it was written for.
    assert {"accelerator_up", "accelerator_energy_joules_total",
            "accelerator_runtime_restarts_total",
            "accelerator_ici_link_bandwidth_bytes_per_second",
            "accelerator_ici_link_traffic_bytes_total",
            "accelerator_collective_ops_total", "tpu_runtime_passthrough",
            "accelerator_dcn_transfer_latency_seconds",
            "accelerator_memory_total_bytes"} <= seen


@pytest.mark.parametrize("seed", range(5))
def test_self_metric_families_match(seed):
    for want, got in _run(seed):
        want_self = {f: v for f, v in want.items() if f not in PER_DEVICE}
        got_self = {f: v for f, v in got.items() if f not in PER_DEVICE}
        assert sorted(got_self) == sorted(want_self)
        for family, lines in want_self.items():
            assert got_self[family][:2] == lines[:2], family  # HELP, TYPE
            if family in DETERMINISTIC:
                assert got_self[family] == lines, family


def test_poll_errors_and_stale_devices_are_counted():
    *_, (want, got) = _run(7)
    assert got["collector_poll_errors_total"] == \
        want["collector_poll_errors_total"]
    assert any('reason="CollectorError"' in line
               for line in got["collector_poll_errors_total"])
    assert any(line.endswith(" 0") and line.startswith("accelerator_up{")
               for line in got["accelerator_up"])


def test_metric_filter_drops_families_like_the_reference():
    disabled = ref_schema.resolve_metric_filter((), ("accelerator_power_*",
                                                     "accelerator_ici_*"))
    texts = []
    for loop_cls, registry, module in (
            (RefPollLoop, RefRegistry(native=False), ref_collectors),
            (PortPollLoop, PortRegistry(), port_collectors)):
        loop = loop_cls(_collector(module)(3), registry, deadline=30.0,
                        disabled_metrics=disabled, clock=Clock())
        try:
            loop.tick()
        finally:
            loop.stop()
        texts.append(_families(registry.rendered()[0].decode()))
    want, got = texts
    assert ({f: v for f, v in got.items() if f in PER_DEVICE}
            == {f: v for f, v in want.items() if f in PER_DEVICE})
    assert "accelerator_power_watts" not in got
    assert "accelerator_duty_cycle" in got


def test_deadline_marks_a_wedged_device_down():
    import threading

    release = threading.Event()

    class Wedged(_collector(port_collectors)):
        def sample(self, device):
            if device.index == 1:
                release.wait(5)
            return super().sample(device)

    registry = PortRegistry()
    loop = PortPollLoop(Wedged(0), registry, deadline=0.05)
    try:
        loop.tick()
        loop.tick()  # still wedged: counted as stuck, no second worker
    finally:
        release.set()
        loop.stop()
    text = registry.rendered()[0].decode()
    assert 'reason="deadline"' in text and 'reason="stuck"' in text
    assert 'accelerator_up{accel_type="gpu-h100",chip="1"' in text
    line = [ln for ln in text.splitlines()
            if ln.startswith('accelerator_up{accel_type="gpu-h100",chip="1"')]
    assert line[0].endswith(" 0")
