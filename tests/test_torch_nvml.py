"""The NVML backend over the scripted NVML, against the JAX package's loop.

``NvmlCollector`` runs over ``testing.fake_nvml``: discovery, the family
mapping and its units, a reading NVML does not support, a failing or lost
card, the startup failure under ``--backend nvml``, and the NVLink links.
Then the same per-device readings, drawn from a seeded numpy generator,
go through a scripted reference ``Collector`` into the reference's
``PollLoop`` and through the fake NVML into the port's ``PollLoop``, tick
by tick on injected clocks: the per-device series must render
byte-identically.
"""

import ctypes
import subprocess
import sys

import numpy as np
import pytest

from kube_gpu_stats_tpu import collectors as ref_collectors
from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu_torch import daemon, schema
from kube_gpu_stats_tpu_torch.collectors import CollectorError
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.config import Config
from kube_gpu_stats_tpu_torch.native import nvml as binding
from kube_gpu_stats_tpu_torch.native.nvml import Nvml, NvmlError
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml

PER_DEVICE = {spec.name for spec in ref_schema.PER_DEVICE_METRICS}


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _devices(n=2):
    return [FakeDevice(uuid=f"GPU-{i:08x}-1111-2222-3333-444455556666",
                       minor=2 * i + 1) for i in range(n)]


def _families(text: str) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            current = line.split()[2]
        out.setdefault(current, []).append(line)
    return out


def _per_device(registry) -> dict[str, list[str]]:
    text = registry.rendered()[0].decode()
    return {f: v for f, v in _families(text).items() if f in PER_DEVICE}


def test_discovery_one_device_per_nvml_index():
    fake = FakeNvml(_devices(3))
    collector = NvmlCollector(fake)
    got = collector.discover()
    assert [(d.index, d.device_id, d.device_path, d.uuid, d.accel_type)
            for d in got] == [
        (i, str(i), f"/dev/nvidia{2 * i + 1}", fake.devices[i].uuid,
         "gpu-h100") for i in range(3)]
    assert fake.init_calls == 1
    collector.close()
    collector.close()
    assert fake.shutdown_calls == 1


def test_family_mapping_and_units():
    dev = FakeDevice(uuid="GPU-a", minor=0, gpu_util=97, mem_util=41,
                     memory_total=81559 * 1024**2, memory_used=3 * 1024**3,
                     power_mw=612_345, temperature=64)
    collector = NvmlCollector(FakeNvml([dev]))
    (device,) = collector.discover()
    sample = collector.sample(device)
    assert dict(sample.values) == {
        schema.DUTY_CYCLE.name: 97.0,
        schema.MEMORY_BANDWIDTH_UTIL.name: 41.0,
        schema.MEMORY_USED.name: float(3 * 1024**3),
        schema.MEMORY_TOTAL.name: float(81559 * 1024**2),
        schema.POWER.name: 612.345,
        schema.TEMPERATURE.name: 64.0,
    }
    # A card without GPM has no tensor-core reading, and NVML has no
    # uptime: neither is exported.
    assert schema.TENSORCORE_UTIL.name not in sample.values
    assert schema.UPTIME.name not in sample.values
    assert dict(sample.ici_counters) == {}
    assert sample.stale is False


@pytest.mark.parametrize("call,families", [
    ("temperature", {schema.TEMPERATURE.name}),
    ("power_mw", {schema.POWER.name}),
    ("utilization", {schema.DUTY_CYCLE.name,
                     schema.MEMORY_BANDWIDTH_UTIL.name}),
])
@pytest.mark.parametrize("code", [binding.NVML_ERROR_NOT_SUPPORTED,
                                  binding.NVML_ERROR_UNKNOWN])
def test_one_failing_reading_is_omitted(call, families, code):
    dev = FakeDevice(uuid="GPU-a", minor=0, errors={call: code})
    collector = NvmlCollector(FakeNvml([dev]))
    (device,) = collector.discover()
    values = collector.sample(device).values
    assert not families & set(values)
    assert schema.MEMORY_USED.name in values


def test_every_reading_failing_raises():
    errors = {call: binding.NVML_ERROR_UNKNOWN for call in
              ("utilization", "memory", "power_mw", "temperature")}
    collector = NvmlCollector(FakeNvml([FakeDevice("GPU-a", 0,
                                                   errors=errors)]))
    (device,) = collector.discover()
    with pytest.raises(CollectorError, match="Unknown Error"):
        collector.sample(device)


def test_lost_card_serves_up_0_and_the_other_card_stays_up():
    fake = FakeNvml(_devices(2))
    loop = PollLoop(NvmlCollector(fake), Registry(), deadline=30.0,
                    clock=Clock(), pipeline_fetch=False)
    try:
        loop.tick()
        fake.devices[1].lost = True
        loop.tick()
    finally:
        loop.stop()
    text = "\n".join(_per_device(loop._registry)["accelerator_up"])
    assert 'chip="0"' in text and 'chip="1"' in text
    ups = {line.split('chip="')[1][0]: line.rsplit(" ", 1)[1]
           for line in text.splitlines() if line.startswith("accelerator_up{")}
    assert ups == {"0": "1", "1": "0"}
    assert 'reason="CollectorError"' in loop._registry.rendered()[0].decode()


def test_init_failure_raises_under_backend_nvml(monkeypatch):
    fake = FakeNvml(_devices(1),
                    init_error=binding.NVML_ERROR_DRIVER_NOT_LOADED)
    monkeypatch.setattr(daemon, "_nvml_collector",
                        lambda: NvmlCollector(fake))
    with pytest.raises(NvmlError, match="Driver Not Loaded") as info:
        daemon.build_collector(Config(backend="nvml"))
    assert info.value.code == binding.NVML_ERROR_DRIVER_NOT_LOADED
    # auto degrades to null on the same node; nvml named never does.
    assert daemon.build_collector(Config(backend="auto")).name == "null"


def test_missing_library_raises_its_nvml_code():
    with pytest.raises(NvmlError) as info:
        NvmlCollector(Nvml(library="libnvidia-ml-absent.so.1"))
    assert info.value.code == binding.NVML_ERROR_LIBRARY_NOT_FOUND
    assert not info.value.not_supported


def test_cli_backend_nvml_without_the_library_exits_non_zero(tmp_path):
    try:
        ctypes.CDLL(binding.LIBRARY)
    except OSError:
        pass
    else:
        pytest.skip("this machine has NVML; the premise needs none")
    proc = subprocess.run(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "--backend",
         "nvml", "--listen-port", "0", "--attribution", "off"],
        capture_output=True, text=True, timeout=60, cwd=tmp_path,
        env={"PYTHONPATH": str(__import__("pathlib").Path(__file__)
                               .resolve().parent.parent)})
    assert proc.returncode == 1
    assert "NVML error 12" in proc.stderr
    assert "libnvidia-ml.so.1" in proc.stderr


def test_nvlink_links_become_counters_with_rates_from_the_second_tick():
    dev = FakeDevice(uuid="GPU-a", minor=0,
                     nvlink_kib={0: (100, 200), 1: (0, 0), 2: None})
    fake = FakeNvml([dev])
    clock = Clock()
    loop = PollLoop(NvmlCollector(fake), Registry(), deadline=30.0,
                    clock=clock, pipeline_fetch=False)
    bw = schema.ICI_BANDWIDTH.name
    traffic = schema.ICI_TRAFFIC_TOTAL.name
    try:
        loop.tick()
        first = _per_device(loop._registry)
        dev.nvlink_kib = {0: (1100, 1200), 1: (5, 0), 2: None}
        clock.now += 1.0
        loop.tick()
        second = _per_device(loop._registry)
    finally:
        loop.stop()
    assert bw not in first
    assert [ln for ln in first[traffic] if not ln.startswith("#")] == [
        ln for ln in first[traffic] if 'link="nvlink0"' in ln]
    assert first[traffic][-1].endswith(f" {300 * 1024}")
    # nvlink1 carried its first bytes: counted from now, its rate next tick.
    assert any('link="nvlink1"' in ln and ln.endswith(f" {5 * 1024}")
               for ln in second[traffic])
    rates = [ln for ln in second[bw] if not ln.startswith("#")]
    assert len(rates) == 1 and 'link="nvlink0"' in rates[0]
    assert rates[0].endswith(f" {2000 * 1024}")
    assert not any('link="nvlink2"' in ln for ln in second[traffic])


# -- the same readings through the reference's loop ---------------------------

TICKS = 6
N_DEV = 3


def _reading(seed: int, device: int, tick: int):
    """What card ``device`` reads at ``tick``: None for a lost card, else
    (values in NVML units, nvlink KiB per link, unsupported calls)."""
    rng = np.random.default_rng([seed, device, tick])
    if rng.random() < 0.12:
        return None
    reading = {
        "gpu_util": int(rng.integers(0, 101)),
        "mem_util": int(rng.integers(0, 101)),
        "memory_total": 81559 * 1024**2,
        "memory_used": int(rng.integers(0, 81559)) * 1024**2,
        "power_mw": int(rng.integers(60_000, 700_001)),
        "temperature": int(rng.integers(25, 90)),
    }
    kib = {link: (1000 * tick * (link + 1) + device, 700 * tick)
           for link in range(2)}
    unsupported = ("temperature",) if rng.random() < 0.2 else ()
    return reading, kib, unsupported


def _to_values(reading, unsupported):
    values = {
        ref_schema.DUTY_CYCLE.name: float(reading["gpu_util"]),
        ref_schema.MEMORY_BANDWIDTH_UTIL.name: float(reading["mem_util"]),
        ref_schema.MEMORY_USED.name: float(reading["memory_used"]),
        ref_schema.MEMORY_TOTAL.name: float(reading["memory_total"]),
        ref_schema.POWER.name: reading["power_mw"] / 1000.0,
        ref_schema.TEMPERATURE.name: float(reading["temperature"]),
    }
    if "temperature" in unsupported:
        del values[ref_schema.TEMPERATURE.name]
    return values


class _RefScripted(ref_collectors.Collector):
    name = "nvml"

    def __init__(self, seed):
        self.seed = seed
        self.tick_no = 0

    def discover(self):
        return [ref_collectors.Device(
            i, str(i), f"/dev/nvidia{2 * i + 1}", "gpu-h100",
            f"GPU-{i:08x}-1111-2222-3333-444455556666")
            for i in range(N_DEV)]

    def begin_tick(self):
        self.tick_no += 1

    def sample(self, device):
        got = _reading(self.seed, device.index, self.tick_no)
        if got is None:
            raise ref_collectors.CollectorError("lost")
        reading, kib, unsupported = got
        return ref_collectors.Sample(
            device=device, values=_to_values(reading, unsupported),
            ici_counters={f"nvlink{link}": (tx + rx) * 1024
                          for link, (tx, rx) in kib.items()})


def _script_fake(fake: FakeNvml, seed: int, tick: int) -> None:
    for index, dev in enumerate(fake.devices):
        got = _reading(seed, index, tick)
        dev.lost = got is None
        if got is None:
            continue
        reading, kib, unsupported = got
        for key, value in reading.items():
            setattr(dev, key, value)
        dev.nvlink_kib = kib
        dev.errors = {call: binding.NVML_ERROR_NOT_SUPPORTED
                      for call in unsupported}


@pytest.mark.parametrize("seed", range(4))
def test_per_device_series_render_identically_to_the_reference(seed):
    fake = FakeNvml(_devices(N_DEV))
    for dev in fake.devices:
        dev.link_count = 2
    clocks = (Clock(), Clock())
    common = dict(interval=1.0, deadline=30.0, version="test",
                  topology_labels={"slice": "s", "worker": "0",
                                   "topology": "1x1"})
    ref_registry, port_registry = RefRegistry(native=False), Registry()
    ref = RefPollLoop(_RefScripted(seed), ref_registry, clock=clocks[0],
                      **common)
    # Blocking, as the reference's generic loop: each tick serves its own
    # reads (tests/test_torch_pipeline.py holds the pipelined tick).
    port = PollLoop(NvmlCollector(fake), port_registry, clock=clocks[1],
                    pipeline_fetch=False, **common)
    seen = set()
    try:
        for tick in range(1, TICKS + 1):
            _script_fake(fake, seed, tick)
            ref.tick()
            port.tick()
            want, got = _per_device(ref_registry), _per_device(port_registry)
            assert got == want
            assert list(got) == list(want)
            seen |= set(want)
            for clock in clocks:
                clock.now += 1.0
    finally:
        ref.stop()
        port.stop()
    assert {"accelerator_up", "accelerator_power_watts",
            "accelerator_energy_joules_total",
            "accelerator_ici_link_bandwidth_bytes_per_second",
            "accelerator_memory_bandwidth_utilization"} <= seen


# -- memory v2 and GPM ----------------------------------------------------------


def test_memory_used_leaves_out_the_drivers_reservation():
    dev = FakeDevice(uuid="GPU-a", minor=0, memory_used=2425 * 1024**2,
                     memory_reserved=480 * 1024**2)
    collector = NvmlCollector(FakeNvml([dev]))
    (device,) = collector.discover()
    values = collector.sample(device).values
    assert values[schema.MEMORY_USED.name] == 2425 * 1024**2
    assert values[schema.MEMORY_TOTAL.name] == dev.memory_total


class _CountingLibrary:
    """Stands in for libnvidia-ml: each call takes 5 ms and counts how
    many run at once."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.running = self.most = self.calls = 0

    def _call(self, *args):
        import time

        with self._lock:
            self.running += 1
            self.calls += 1
            self.most = max(self.most, self.running)
        time.sleep(0.005)
        with self._lock:
            self.running -= 1
        return binding.NVML_SUCCESS

    nvmlDeviceGetFieldValues = nvmlDeviceGetPowerUsage = _call
    nvmlDeviceGetMemoryInfo_v2 = _call


def test_nvml_calls_run_one_at_a_time():
    """The burst sampler's one-field read and the poll loop's reads come
    from different threads; the binding makes them one at a time."""
    import threading

    library = _CountingLibrary()
    nvml = Nvml()
    nvml._lib = library
    links = [(binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX, link)
             for link in range(18)]
    calls = [lambda: nvml.field_values(0, links),
             lambda: nvml.field_values(
                 0, [(binding.NVML_FI_DEV_POWER_INSTANT, 0)]),
             lambda: nvml.power_mw(0), lambda: nvml.memory(0)]

    def run(call):
        for _ in range(10):
            call()

    threads = [threading.Thread(target=run, args=(call,)) for call in calls]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=30)
    assert library.calls == 40
    assert library.most == 1


def test_memory_v2_struct_and_version():
    assert ctypes.sizeof(binding.NvmlMemoryV2) == 40
    assert binding.NVML_MEMORY_V2_VERSION == \
        ctypes.sizeof(binding.NvmlMemoryV2) | (2 << 24)
    assert [name for name, _ in binding.NvmlMemoryV2._fields_] == \
        ["version", "total", "reserved", "free", "used"]


def _gpm_card(**kw):
    return FakeDevice(uuid="GPU-a", minor=0, gpu_util=97, mem_util=41,
                      gpm_supported=True, tensor_util=62.5,
                      dram_bw_util=35.25, **kw)


def test_gpm_families_from_the_second_tick():
    dev = _gpm_card()
    fake = FakeNvml([dev])
    collector = NvmlCollector(fake)
    (device,) = collector.discover()
    first = collector.sample(device).values
    # No interval yet: neither GPM family, and not the time share either.
    assert schema.TENSORCORE_UTIL.name not in first
    assert schema.MEMORY_BANDWIDTH_UTIL.name not in first
    assert first[schema.DUTY_CYCLE.name] == 97.0
    assert collector.gpm_state == {"0": "on"}
    second = collector.sample(device).values
    assert second[schema.TENSORCORE_UTIL.name] == 62.5
    assert second[schema.MEMORY_BANDWIDTH_UTIL.name] == 35.25
    dev.tensor_util, dev.dram_bw_util = 90.0, 70.0
    third = collector.sample(device).values
    assert (third[schema.TENSORCORE_UTIL.name],
            third[schema.MEMORY_BANDWIDTH_UTIL.name]) == (90.0, 70.0)
    collector.close()
    assert fake.gpm_samples == {} and fake.gpm_freed == 2


@pytest.mark.parametrize("refusal", ["unsupported", "sample_get",
                                     "query"])
def test_without_gpm_the_time_share_stands(refusal):
    dev = _gpm_card()
    if refusal == "unsupported":
        dev.gpm_supported = False
    elif refusal == "sample_get":
        # The card supports GPM but the container refuses its counters.
        dev.errors["gpm_sample_get"] = binding.NVML_ERROR_UNKNOWN
    else:
        dev.errors["gpm_supported"] = binding.NVML_ERROR_NOT_SUPPORTED
    fake = FakeNvml([dev])
    collector = NvmlCollector(fake)
    (device,) = collector.discover()
    for _ in range(3):
        values = collector.sample(device).values
        assert schema.TENSORCORE_UTIL.name not in values
        assert values[schema.MEMORY_BANDWIDTH_UTIL.name] == 41.0
    assert collector.gpm_state == {"0": {
        "unsupported": "unsupported",
        "sample_get": "NVML error 999: Unknown Error",
        "query": "NVML error 3: Not Supported"}[refusal]}
    assert fake.gpm_samples == {}  # nothing held for a card without GPM


def test_a_failed_gpm_read_restarts_the_interval():
    dev = _gpm_card()
    collector = NvmlCollector(FakeNvml([dev]))
    (device,) = collector.discover()
    collector.sample(device)
    assert schema.TENSORCORE_UTIL.name in collector.sample(device).values
    dev.errors["gpm_sample_get"] = binding.NVML_ERROR_UNKNOWN
    values = collector.sample(device).values
    assert schema.TENSORCORE_UTIL.name not in values
    assert schema.MEMORY_BANDWIDTH_UTIL.name not in values
    del dev.errors["gpm_sample_get"]
    # The next read starts a new interval; the one after serves again.
    assert schema.TENSORCORE_UTIL.name not in collector.sample(device).values
    assert collector.sample(device).values[schema.TENSORCORE_UTIL.name] \
        == 62.5
    assert collector.gpm_state == {"0": "on"}


def test_gpm_on_a_lost_card_raises():
    dev = _gpm_card()
    collector = NvmlCollector(FakeNvml([dev]))
    (device,) = collector.discover()
    collector.sample(device)
    dev.lost = True
    with pytest.raises(CollectorError, match="GPU is lost"):
        collector.sample(device)


def test_rediscovery_waits_for_a_gpm_read_in_flight():
    """A pipelined read may still fill the card's GPM buffers when the
    loop rediscovers: they are freed when that read lets go, not under
    it."""
    import threading
    import time

    dev = _gpm_card()
    fake = FakeNvml([dev])
    collector = NvmlCollector(fake)
    (device,) = collector.discover()
    collector.sample(device)  # opens GPM: one sample_get
    dev.stalls["gpm_sample_get"] = (0.3, dev.calls["gpm_sample_get"] + 1)
    reader = threading.Thread(target=collector.read_environment,
                              args=(device,))
    reader.start()
    time.sleep(0.1)
    collector.discover()
    assert fake.gpm_freed == 0  # the read still holds them
    reader.join(timeout=5)
    assert not reader.is_alive()
    assert fake.gpm_freed == 2 and fake.gpm_samples == {}
    collector.close()


def test_rediscovery_frees_and_reopens_gpm():
    fake = FakeNvml([_gpm_card()])
    collector = NvmlCollector(fake)
    (device,) = collector.discover()
    collector.sample(device)
    (device,) = collector.discover()
    assert fake.gpm_freed == 2 and fake.gpm_samples == {}
    assert schema.TENSORCORE_UTIL.name not in collector.sample(device).values
    assert schema.TENSORCORE_UTIL.name in collector.sample(device).values
    collector.close()
    assert fake.gpm_freed == 4


def test_rediscovery_keeps_a_cards_no_gpm_verdict():
    """A card whose GPM was refused is not probed again when rediscovery
    finds the same card at its index; another card there is."""
    dev = _gpm_card()
    dev.errors["gpm_sample_get"] = binding.NVML_ERROR_UNKNOWN
    fake = FakeNvml([dev])
    collector = NvmlCollector(fake)
    (device,) = collector.discover()
    collector.sample(device)
    (device,) = collector.discover()
    for _ in range(2):
        values = collector.sample(device).values
    assert dev.calls["gpm_sample_get"] == 1
    assert schema.TENSORCORE_UTIL.name not in values
    assert collector.gpm_state == {"0": "NVML error 999: Unknown Error"}
    fake.devices[0] = _gpm_card()
    fake.devices[0].uuid = "GPU-b"
    (device,) = collector.discover()
    collector.sample(device)
    assert fake.devices[0].calls["gpm_sample_get"] == 1
    assert collector.gpm_state == {"0": "on"}
    collector.close()
    assert fake.gpm_samples == {}


def test_gpm_structs_as_the_header_lays_them_out():
    # Held against nvml.h itself by the card-only probe.
    assert ctypes.sizeof(binding.NvmlGpmMetric) == 40
    assert binding.NvmlGpmMetric.value.offset == 8
    assert binding.NvmlGpmMetricsGet.metrics.offset == 24
    assert ctypes.sizeof(binding.NvmlGpmMetricsGet) == \
        24 + 40 * binding.NVML_GPM_METRIC_MAX
    assert ctypes.sizeof(binding.NvmlGpmSupport) == 8
