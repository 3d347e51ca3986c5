"""The port's burst sampler against the JAX package's, and the NVML read
behind it.

Both samplers are driven through ``inject`` with the thread never
started, on one injected clock, each with its own package's flight
recorder: the same samples must fold into the same ``kts_power_burst_*``
text, the same ``/debug/burst`` status, and the same ``burst_arm``/
``burst_disarm`` journal. The cases follow ``tests/test_burst.py``:
the ring and its cap, the fold and its histogram, ``forget_device``,
arm/hold/disarm, continuous mode, the journal scan's auto-arm on a
power-shaped ``fleet_anomaly``, the inject guard, a backend whose read
answers None. Then ``NvmlCollector.read_burst`` over ``fake_nvml``: the
instantaneous power field in watts where the card serves it, None (and
no sample, and the reason in the status) where it answers
``NVML_ERROR_NOT_SUPPORTED`` — never the one-second average.
"""

import numpy as np
import pytest

from kube_gpu_stats_tpu import burstsampler as ref_burstsampler
from kube_gpu_stats_tpu.collectors.mock import MockCollector as RefMock
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
from kube_gpu_stats_tpu.tracing import Tracer as RefTracer
from kube_gpu_stats_tpu_torch import burstsampler, schema
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.native import nvml as binding
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry, SnapshotBuilder
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml
from kube_gpu_stats_tpu_torch.tracing import Tracer


class Clock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


class Pair:
    """The reference's sampler and the port's, side by side."""

    def __init__(self, clock=None, collectors=None, **kwargs) -> None:
        self.clock = clock or Clock()
        ref_col, port_col = collectors or (RefMock(2), MockCollector(2))
        self.ref_tracer, self.port_tracer = RefTracer(), Tracer()
        self.ref = ref_burstsampler.BurstSampler(
            lambda: ref_col, ref_col.discover, clock=self.clock,
            tracer=self.ref_tracer, **kwargs)
        self.port = burstsampler.BurstSampler(
            lambda: port_col, port_col.discover, clock=self.clock,
            tracer=self.port_tracer, **kwargs)

    def inject(self, device_id: str, t: float, watts: float) -> None:
        self.ref.inject(device_id, t, watts)
        self.port.inject(device_id, t, watts)

    def fold(self, device_ids=("0", "1")) -> tuple:
        drained = []
        for sampler in (self.ref, self.port):
            got = {d: sampler.drain(d) for d in device_ids}
            for d, samples in got.items():
                sampler.fold(d, samples)
            drained.append(got)
        return drained[0], drained[1]

    def texts(self, device_ids=("0", "1")) -> tuple[str, str]:
        labels = {d: (("chip", d),) for d in device_ids}
        out = []
        for sampler, builder_cls in ((self.ref, RefBuilder),
                                     (self.port, SnapshotBuilder)):
            builder = builder_cls()
            sampler.contribute(builder, labels)
            out.append(builder.build().render())
        return out[0], out[1]

    def statuses(self) -> tuple[dict, dict]:
        port = self.port.status()
        assert port.pop("read") == {}
        return self.ref.status(), port

    def journals(self) -> tuple[list, list]:
        def burst_events(tracer):
            return [(e["kind"], e["detail"], e["attrs"])
                    for e in tracer.events(0)["events"]
                    if e["kind"].startswith("burst_")]
        return burst_events(self.ref_tracer), burst_events(self.port_tracer)

    def assert_equal(self) -> None:
        want, got = self.texts()
        assert got == want
        want, got = self.statuses()
        assert got == want
        want, got = self.journals()
        assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_the_same_samples_fold_into_the_same_families(seed):
    rng = np.random.default_rng(seed)
    pair = Pair(mode="continuous")
    for tick in range(4):
        for device in ("0", "1"):
            for k in range(int(rng.integers(0, 40))):
                watts = float(rng.choice([rng.uniform(60, 720),
                                          rng.uniform(0, 2000)]))
                pair.inject(device, tick + k / 100.0, round(watts, 3))
        want, got = pair.fold()
        assert got == want
        pair.assert_equal()
    assert "kts_power_burst_watts_distribution_bucket" in pair.texts()[1]


def test_the_ring_caps_and_drains_oldest_first():
    pair = Pair(ring=16)
    for k in range(40):
        pair.inject("0", k / 100.0, float(100 + k))
    want, got = pair.fold(("0",))
    assert got == want
    assert [w for _, w in got["0"]] == [float(100 + k) for k in range(24, 40)]
    assert pair.port.drain("0") == ()
    pair.assert_equal()


def test_forget_device_purges_ring_and_fold():
    pair = Pair()
    for device in ("0", "1"):
        pair.inject(device, 0.0, 300.0)
    pair.fold()
    pair.inject("1", 0.5, 320.0)
    for sampler in (pair.ref, pair.port):
        sampler.forget_device("1")
    pair.assert_equal()
    assert "1" not in pair.port.status()["devices"]
    assert pair.port.drain("1") == ()


def test_arm_hold_disarm_and_their_events():
    clock = Clock(10.0)
    pair = Pair(clock=clock, hold=30.0)
    for sampler in (pair.ref, pair.port):
        assert not sampler.armed
        assert sampler.arm(5.0) == 5.0
        sampler.arm(2.0)  # an extension never shortens the window
    clock.t = 14.0
    assert pair.port.armed and pair.ref.armed
    pair.assert_equal()
    for sampler in (pair.ref, pair.port):
        sampler.disarm()
        assert sampler.arm() == 30.0  # the default hold
    clock.t = 50.0
    for sampler in (pair.ref, pair.port):
        assert not sampler.armed
    pair.assert_equal()
    kinds = [kind for kind, _, _ in pair.journals()[1]]
    assert kinds == ["burst_arm", "burst_disarm", "burst_arm"]
    assert pair.port.arms_total == {"demand": 2}


def test_continuous_mode_is_always_armed():
    pair = Pair(mode="continuous")
    for sampler in (pair.ref, pair.port):
        sampler.disarm()
        assert sampler.armed
    pair.assert_equal()
    assert pair.port.status()["arm_reason"] == "continuous"


@pytest.mark.parametrize("anomaly,armed", [("power", True), ("duty", True),
                                           ("power_burst", True),
                                           ("freshness", False)])
def test_scan_journal_arms_on_power_shaped_anomalies(anomaly, armed):
    pair = Pair()
    for tracer in (pair.ref_tracer, pair.port_tracer):
        tracer.event("fleet_anomaly", "node-7 anomalous", anomaly=anomaly)
    for sampler in (pair.ref, pair.port):
        sampler.scan_journal()
        assert sampler.armed is armed
    pair.assert_equal()
    if armed:
        assert pair.port.arms_total == {"anomaly": 1}


def test_the_inject_guard_drops_nonfinite_and_negative_watts():
    pair = Pair()
    for watts in (float("nan"), float("inf"), -1.0, 250.0):
        pair.inject("0", 0.0, watts)
    want, got = pair.fold(("0",))
    assert got == want == {"0": ((0.0, 250.0),)}


def test_a_read_answering_none_takes_no_sample():
    class NoBurst:
        def read_burst(self, device):
            return None

    clock = Clock()
    pair = Pair(clock=clock, mode="continuous")
    devices = MockCollector(2).discover()
    sampler = burstsampler.BurstSampler(lambda: NoBurst(), lambda: devices,
                                        clock=clock, mode="continuous")
    assert sampler._read_once() == 0
    assert pair.port._read_once() == pair.ref._read_once() == 2
    pair.fold()
    pair.assert_equal()


def test_the_poll_loop_folds_the_burst_ring_as_the_reference_does():
    clock = Clock(100.0)
    pair = Pair(clock=clock, mode="continuous")
    ref_registry, port_registry = RefRegistry(native=False), Registry()
    loops = (RefPollLoop(RefMock(2), ref_registry, clock=clock,
                         burst_sampler=pair.ref),
             PollLoop(MockCollector(2), port_registry, clock=clock,
                      burst_sampler=pair.port))

    def burst_lines(registry) -> list[str]:
        return [line for line in registry.snapshot().render().splitlines()
                if line.startswith("kts_power_burst_")]

    try:
        for tick in range(3):
            for k in range(10):
                pair.inject("0", clock.t + k / 100.0, 200.0 + 50 * k + tick)
            for loop in loops:
                loop.tick()
            assert burst_lines(port_registry) == burst_lines(ref_registry)
            clock.t += 1.0
        lines = burst_lines(port_registry)
        assert 'kts_power_burst_samples_total{chip="0"} 30' in lines
        assert 'kts_power_burst_watts{chip="0",stat="max"} 652' in lines
        # A departed device's state goes with it on rediscovery.
        for loop, col in zip(loops, (RefMock(1), MockCollector(1))):
            loop._collector = col
            loop.rediscover()
        assert pair.port.status()["devices"].keys() == {"0"}
    finally:
        for loop in loops:
            loop.stop()


# -- NvmlCollector.read_burst ---------------------------------------------------


def _nvml(**device) -> NvmlCollector:
    return NvmlCollector(FakeNvml([FakeDevice(uuid="GPU-b", minor=0,
                                              power_mw=412_000, **device)]))


def test_read_burst_reads_the_instantaneous_field_in_watts():
    collector = _nvml(power_instant_mw=689_500)
    (dev,) = collector.discover()
    try:
        assert collector.read_burst(dev) == 689.5
        # Not the one-second average of nvmlDeviceGetPowerUsage.
        assert collector.sample(dev).values[schema.POWER.name] == 412.0
        fake = collector._nvml
        assert fake.devices[0].calls["power_instant"] == 1
        assert collector.burst_state == {}
    finally:
        collector.close()


def test_the_instantaneous_field_id_is_nvml_h_s():
    assert binding.NVML_FI_DEV_POWER_INSTANT == 186


def test_a_card_without_the_field_gives_no_burst_sample():
    collector = _nvml(power_instant_supported=False)
    (dev,) = collector.discover()
    clock = Clock()
    sampler = burstsampler.BurstSampler(lambda: collector, lambda: [dev],
                                        clock=clock, mode="continuous")
    try:
        assert collector.read_burst(dev) is None
        assert sampler._read_once() == 0
        assert sampler.drain(dev.device_id) == ()
        reason = sampler.status()["read"][dev.device_id]
        assert "NVML_FI_DEV_POWER_INSTANT" in reason
        assert "Not Supported" in reason
        builder = SnapshotBuilder()
        sampler.contribute(builder, {dev.device_id: (("chip", "0"),)})
        text = builder.build().render()
        assert "kts_power_burst_samples_total" not in text
        assert "kts_power_burst_armed 1" in text
    finally:
        collector.close()


def test_a_refused_call_is_not_supported_too_and_other_errors_raise():
    collector = _nvml(errors={"power_instant": binding.NVML_ERROR_NOT_SUPPORTED})
    (dev,) = collector.discover()
    try:
        assert collector.read_burst(dev) is None
        assert "Not Supported" in collector.burst_state[dev.device_id]
        collector._nvml.devices[0].errors = {
            "power_instant": binding.NVML_ERROR_UNKNOWN}
        with pytest.raises(binding.NvmlError, match="Unknown Error"):
            collector.read_burst(dev)
        # The sampler skips a failing read rather than dying.
        sampler = burstsampler.BurstSampler(
            lambda: collector, lambda: [dev], clock=Clock(),
            mode="continuous")
        assert sampler._read_once() == 0
    finally:
        collector.close()


def test_the_daemon_arms_the_nvml_sampler_and_serves_its_families():
    import json
    import time
    import urllib.request

    from kube_gpu_stats_tpu_torch import config, daemon

    fake = FakeNvml([FakeDevice(uuid="GPU-d", minor=0,
                                power_instant_mw=655_250)])
    cfg = config.from_args(["--backend", "nvml", "--listen-host",
                            "127.0.0.1", "--listen-port", "0",
                            "--interval", "0.05", "--attribution", "off",
                            "--burst-hz", "200"])
    original = daemon._nvml_collector
    daemon._nvml_collector = lambda: NvmlCollector(fake)
    try:
        instance = daemon.Daemon(cfg)
    finally:
        daemon._nvml_collector = original
    instance.start()
    try:
        base = f"http://127.0.0.1:{instance.server.port}"
        armed = json.loads(urllib.request.urlopen(
            base + "/debug/burst?arm=0.6").read())
        assert armed["armed"] and armed["armed_for_s"] == 0.6
        deadline = time.monotonic() + 10
        while True:
            status = json.loads(urllib.request.urlopen(
                base + "/debug/burst").read())
            if not status["armed"] and status["devices"]:
                break
            assert time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(0.2)
        text = instance.registry.snapshot().render()
    finally:
        instance.stop()
    assert status["devices"]["0"]["samples_total"] >= 20
    assert status["devices"]["0"]["last_fold"]["max"] == 655.25
    assert 'kts_power_burst_watts{chip="0",stat="mean"} 655.25' in text
    assert "kts_power_burst_armed 0" in text
