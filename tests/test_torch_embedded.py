"""The port's embedded exporter against the JAX package's.

The same seeded ``record_step`` sequence goes into the reference's
``JaxIntrospectCollector`` (the 8-device CPU mesh of tests/conftest.py)
and the port's ``TorchIntrospectCollector(device="cpu")`` (one device):
steps, busy seconds, per-device FLOPs, MFU and the step histogram must
agree. Then the whole stack: the port's exporter scraped over HTTP passes
the reference's validator and serves the reference exporter's families
(memory aside: PyTorch has no allocator statistics on the CPU), and
``loadgen --embedded-port`` serves it during a burn.
"""

import gzip
import json
import math
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kube_gpu_stats_tpu import embedded as ref_embedded
from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu import validate
from kube_gpu_stats_tpu_torch import embedded
from kube_gpu_stats_tpu_torch import schema
from kube_gpu_stats_tpu_torch.collectors import CollectorError
from kube_gpu_stats_tpu_torch.loadgen import burn
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry

PEAK = 2.5e12
REL = 1e-12


class FakeTime:
    """Stands in for the ``time`` module inside both embedded modules."""

    def __init__(self):
        self.now = 50.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


@pytest.fixture
def pinned(monkeypatch):
    clock = FakeTime()
    for module in (ref_embedded, embedded):
        monkeypatch.setattr(module, "_kind_peak_flops", lambda kind: PEAK)
        monkeypatch.setattr(module, "time", clock)
    return clock


def _read(sample, name):
    return sample.values.get(name)


def _compare(ref_col, port_col, ref_dev, port_dev):
    want = ref_col.sample(ref_dev)
    got = port_col.sample(port_dev)
    for spec in (ref_schema.WORKLOAD_STEPS, ref_schema.WORKLOAD_BUSY_SECONDS,
                 ref_schema.WORKLOAD_FLOPS, ref_schema.WORKLOAD_MFU,
                 ref_schema.PEAK_FLOPS, ref_schema.UPTIME):
        w, g = _read(want, spec.name), _read(got, spec.name)
        assert (w is None) == (g is None), spec.name
        if w is not None:
            assert g == pytest.approx(w, rel=REL, abs=0.0), spec.name
    (want_hist,), (got_hist,) = (ref_col.extra_histograms(),
                                 port_col.extra_histograms())
    assert got_hist.spec.name == want_hist.spec.name
    assert got_hist.buckets == want_hist.buckets
    assert got_hist.counts == want_hist.counts
    assert got_hist.total == want_hist.total
    assert got_hist.sum == pytest.approx(want_hist.sum, rel=REL, abs=0.0)
    return got


@pytest.mark.parametrize("seed", range(4))
def test_record_step_sequence_matches_reference(pinned, seed):
    ref_col = ref_embedded.JaxIntrospectCollector()
    port_col = embedded.TorchIntrospectCollector(device="cpu")
    ref_dev, port_dev = ref_col.discover()[0], port_col.discover()[0]
    # Each collector splits workload FLOPs over its own device count:
    # feed each its count times the per-device FLOPs.
    ref_n, port_n = len(ref_col.discover()), len(port_col.discover())
    assert (ref_n, port_n) == (8, 1)
    rng = np.random.default_rng(seed)
    mfus = []
    for _ in range(60):
        n = int(rng.integers(0, 40))
        seconds = (float(rng.lognormal(-5, 2)) * max(n, 1)
                   if rng.random() < 0.8 else None)
        flops = float(rng.uniform(1e9, 1e13)) if rng.random() < 0.7 else None
        ref_col.record_step(n, seconds=seconds,
                            flops=None if flops is None else flops * ref_n)
        port_col.record_step(n, seconds=seconds,
                             flops=None if flops is None else flops * port_n)
        if rng.random() < 0.3:
            pinned.now += float(rng.uniform(0.05, 2.0))
            ref_col.begin_tick()
            port_col.begin_tick()
            got = _compare(ref_col, port_col, ref_dev, port_dev)
            mfus.append(got.values.get(schema.WORKLOAD_MFU.name))
    pinned.now += 1.0
    ref_col.begin_tick()
    port_col.begin_tick()
    _compare(ref_col, port_col, ref_dev, port_dev)
    assert [m for m in mfus if m is not None], "no MFU window was compared"


def test_step_timer_matches_reference(pinned):
    ref_col = ref_embedded.JaxIntrospectCollector()
    port_col = embedded.TorchIntrospectCollector(device="cpu")
    for col in (ref_col, port_col):
        with col.step_timer():
            pinned.now += 0.125
    ref_col.begin_tick()
    port_col.begin_tick()
    got = _compare(ref_col, port_col, ref_col.discover()[0],
                   port_col.discover()[0])
    assert got.values[schema.WORKLOAD_BUSY_SECONDS.name] == 0.125


def test_tick_view_keeps_histogram_count_equal_to_steps(pinned):
    """One snapshot describes one set of steps: record_step after the
    tick's begin_tick shows in the next tick, for every family at once."""
    col = embedded.TorchIntrospectCollector(device="cpu")
    dev = col.discover()[0]
    col.record_step(4, seconds=0.4, flops=1e12)
    col.begin_tick()
    col.record_step(2, seconds=0.2, flops=1e12)
    sample = col.sample(dev)
    (hist,) = col.extra_histograms()
    assert sample.values[schema.WORKLOAD_STEPS.name] == 4 == hist.total
    assert sample.values[schema.WORKLOAD_FLOPS.name] == 1e12
    col.begin_tick()
    (hist,) = col.extra_histograms()
    assert col.sample(dev).values[schema.WORKLOAD_STEPS.name] == 6 == \
        hist.total


def test_cpu_device_has_no_memory_families():
    col = embedded.TorchIntrospectCollector(device="cpu")
    (dev,) = col.discover()
    assert (dev.index, dev.device_id, dev.accel_type, dev.device_path) == \
        (0, "0", "cpu", "torch:cpu:0")
    col.begin_tick()
    values = col.sample(dev).values
    for spec in (schema.MEMORY_USED, schema.MEMORY_PEAK, schema.MEMORY_TOTAL):
        assert spec.name not in values
    assert col.name == "torch-embedded"


def test_exporter_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embedded.EmbeddedExporter()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embedded.TorchIntrospectCollector()


def test_memory_read_failure_is_a_counted_collector_error():
    """A card whose allocator cannot be read (here: a CUDA device on a
    build without CUDA) raises CollectorError; the poll loop counts it and
    marks the device down — no silent omission."""
    if torch.cuda.is_available():
        pytest.skip("needs a build where CUDA calls fail")
    col = embedded.TorchIntrospectCollector(device="cpu")
    col._devices = {0: (torch.device("cuda", 0), "NVIDIA H100 80GB HBM3")}
    col._device_paths = {0: "/dev/nvidia0"}
    (dev,) = col.discover()
    assert (dev.accel_type, dev.device_path) == ("gpu-h100", "/dev/nvidia0")
    with pytest.raises(CollectorError, match="memory stats"):
        col.sample(dev)
    registry = Registry()
    loop = PollLoop(col, registry, deadline=5.0)
    try:
        loop.tick()
    finally:
        loop.stop()
    text = registry.rendered()[0].decode()
    assert 'collector_poll_errors_total{reason="CollectorError"} 1' in text
    up = [line for line in text.splitlines()
          if line.startswith("accelerator_up{")]
    assert len(up) == 1 and up[0].endswith(" 0")


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", "gpu-h100"),
    ("NVIDIA H100 PCIe", "gpu-h100"),
    ("NVIDIA H100 NVL", "gpu-h100"),
    ("NVIDIA A100-SXM4-80GB", "gpu-a100"),
    ("NVIDIA GH200 480GB", "gpu-gh200"),
    ("NVIDIA L40S", "gpu-l40s"),
    ("Tesla V100-SXM2-16GB", "gpu-v100"),
    ("NVIDIA RTX A6000", "gpu-a6000"),
    ("NVIDIA GeForce RTX 4090", "gpu-geforce-rtx-4090"),
    ("cpu", "cpu"),
])
def test_accel_type_normalizes_product_names(name, want):
    assert embedded.accel_type(name) == want


# NVML's view of the node: minors in another order than NVML's indices
# (and CUDA's ordinals).
_NODE = [("GPU-aaa", 2), ("GPU-bbb", 0), ("GPU-ccc", 5)]


@pytest.mark.parametrize("ordinal,visible,uuid,nvml_error,want", [
    # Unset: CUDA ordinal 0 is the card whose minor is 2, not /dev/nvidia0.
    (0, None, "GPU-aaa", None, "/dev/nvidia2"),
    (1, None, "GPU-bbb", None, "/dev/nvidia0"),
    # An integer entry is neither the minor nor the NVML index.
    (0, "2", "GPU-bbb", None, "/dev/nvidia0"),
    (1, "5, 3", "GPU-ccc", None, "/dev/nvidia5"),
    # A UUID entry goes through the same lookup.
    (0, "GPU-aaa", "GPU-aaa", None, "/dev/nvidia2"),
    (1, "4,MIG-abc", "GPU-ccc", None, "MIG-abc"),
    # A card NVML does not list, or no NVML: the UUID, never a guess.
    (0, None, "GPU-zzz", None, "GPU-zzz"),
    (0, "0", "GPU-aaa", "init", "GPU-aaa"),
    (0, None, "GPU-aaa", "minor_number", "GPU-aaa"),
])
def test_device_path_follows_cuda_visible_devices(ordinal, visible, uuid,
                                                  nvml_error, want):
    from kube_gpu_stats_tpu_torch.native import nvml as binding
    from kube_gpu_stats_tpu_torch.testing.fake_nvml import (FakeDevice,
                                                            FakeNvml)

    devices = [FakeDevice(uuid=u, minor=m) for u, m in _NODE]
    fake = FakeNvml(devices, init_error=(
        binding.NVML_ERROR_LIBRARY_NOT_FOUND if nvml_error == "init"
        else None))
    if nvml_error == "minor_number":
        devices[0].errors["minor_number"] = binding.NVML_ERROR_NOT_SUPPORTED
    minors = embedded.nvml_minors(fake)
    assert embedded.nvidia_device_path(ordinal, visible, uuid, minors) == want
    assert fake._refs == 0  # NVML was shut down again


@pytest.mark.parametrize("ordinal,visible", [(1, "0"), (0, ""), (2, "1,,3"),
                                             (1, "0,foo,2")])
def test_device_path_rejects_an_ordinal_outside_the_list(ordinal, visible):
    with pytest.raises(ValueError):
        embedded.nvidia_device_path(ordinal, visible, "GPU-aaa",
                                    {"GPU-aaa": 2})


def _get(port, path, headers=None):
    request = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     headers=headers or {})
    with urllib.request.urlopen(request, timeout=10) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _served(exporter):
    """Two scrapes after the step hook fired; the second folds the first
    one's render stats. Returns the second body."""
    exporter.record_step(3, seconds=0.3, flops=8e9)
    registry = exporter.registry
    assert registry.wait_for_publish(0, timeout=10)
    _get(exporter.port, "/metrics")
    generation = registry.generation
    assert registry.wait_for_publish(generation + 1, timeout=10)
    return _get(exporter.port, "/metrics")[2].decode()


def _families(body: str) -> set[str]:
    return {line.split()[2] for line in body.splitlines()
            if line.startswith("# TYPE ")}


def test_exporter_end_to_end_matches_the_reference_exporter():
    port_exp = embedded.EmbeddedExporter(port=0, interval=0.05,
                                         device="cpu").start()
    ref_exp = ref_embedded.EmbeddedExporter(port=0, interval=0.05).start()
    try:
        got = _served(port_exp)
        want = _served(ref_exp)
        status, _, healthz = _get(port_exp.port, "/healthz")
        assert (status, healthz) == (200, b"ok\n")
        assert _get(port_exp.port, "/readyz")[2] == b"ready\n"
    finally:
        port_exp.stop()
        ref_exp.stop()
    assert validate.check(got) == []
    memory = {spec.name for spec in (schema.MEMORY_USED, schema.MEMORY_PEAK,
                                     schema.MEMORY_TOTAL)}
    assert _families(got) == _families(want) - memory
    assert _families(want) & memory  # the reference serves live-array bytes
    assert 'backend="torch-embedded"' in got
    assert got.count("accelerator_up{") == 1
    assert "accelerator_workload_steps_total{" in got
    assert "accelerator_workload_flops_total{" in got
    assert "accelerator_workload_step_duration_seconds_count 3" in got


def test_metrics_negotiates_gzip_openmetrics_and_etag():
    exporter = embedded.EmbeddedExporter(port=0, interval=0.05,
                                         device="cpu").start()
    try:
        assert exporter.registry.wait_for_publish(0, timeout=10)
        status, headers, body = _get(
            exporter.port, "/metrics",
            {"Accept-Encoding": "gzip",
             "Accept": "application/openmetrics-text"})
        assert headers["Content-Encoding"] == "gzip"
        assert headers["Content-Type"].startswith(
            "application/openmetrics-text")
        assert gzip.decompress(body).decode().endswith("# EOF\n")
        # The tag names a generation; ask before the next publish can
        # land and the same tag answers 304 with no body.
        generation = exporter.registry.generation
        assert exporter.registry.wait_for_publish(generation, timeout=10)
        exporter.poll.stop()  # no further publishes
        _, headers, _ = _get(exporter.port, "/metrics")
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(exporter.port, "/metrics",
                 {"If-None-Match": headers["ETag"]})
        assert err.value.code == 304
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(exporter.port, "/nowhere")
        assert err.value.code == 404
    finally:
        exporter.stop()


def test_metric_filter_and_typo_like_the_reference():
    exporter = embedded.EmbeddedExporter(
        port=0, interval=0.05, device="cpu",
        metrics_exclude=("accelerator_uptime_seconds",)).start()
    try:
        body = _served(exporter)
    finally:
        exporter.stop()
    assert "accelerator_uptime_seconds" not in body
    assert "accelerator_workload_steps_total" in body
    with pytest.raises(ValueError, match="unknown metric family"):
        embedded.EmbeddedExporter(metrics_exclude=("not_a_family",),
                                  device="cpu")


def test_loadgen_embedded_port_serves_during_a_cpu_burn(monkeypatch, capsys,
                                                        tmp_path):
    started = []
    real_start = embedded.start

    def start(*args, **kwargs):
        exporter = real_start(*args, **kwargs)
        started.append(exporter)
        return exporter

    monkeypatch.setattr(embedded, "start", start)
    assert burn.main(["--size", "64", "--depth", "2", "--seconds", "0.5",
                      "--embedded-port", "0",
                      "--embedded-textfile", str(tmp_path)],
                     device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    (exporter,) = started
    assert out[0] == f"embedded-exporter-port: {exporter.port}"
    steady = json.loads(out[-1])["steady_state"]
    assert steady["devices"] == 1 and steady["steps_per_s"] > 0
    steps, busy, flops, hist = exporter.collector._counters
    assert steps > 0 and busy > 0 and hist.total == steps
    assert math.isclose(flops, steps * 2 * 2 * 64**3, rel_tol=REL)
    # The exporter was stopped in main's finally: nothing listens.
    with pytest.raises(urllib.error.URLError):
        _get(exporter.port, "/healthz")
    prom = (tmp_path / "accelerator.prom").read_text()
    assert "accelerator_workload_steps_total{" in prom


@pytest.mark.parametrize("local_world,world,cards,want_chips,share", [
    # One CPU device in a group of 4: a quarter of the global FLOPs.
    (None, 4, 0, [0], 2e12),
    # One process per host of 2, each owning 8 cards: 8e12 / 16.
    (None, 2, 8, list(range(8)), 0.5e12),
    # torchrun, one process per card (8 on the host, world 8): this
    # process owns its current card, 3, and divides by the world.
    ("8", 8, 8, [3], 1e12),
])
def test_world_size_scales_the_per_device_share(monkeypatch, local_world,
                                                world, cards, want_chips,
                                                share):
    fake_dist = types.SimpleNamespace(is_available=lambda: True,
                                      is_initialized=lambda: True,
                                      get_world_size=lambda: world)
    monkeypatch.setattr(torch, "distributed", fake_dist)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    if cards:
        # CUDA made to look present: the collector reads no card.
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev=None: "NVIDIA H100 80GB HBM3")
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: types.SimpleNamespace(uuid="u"))
        monkeypatch.setattr(embedded, "nvml_minors", lambda: {})
        monkeypatch.setattr(embedded.TorchIntrospectCollector, "_memory",
                            staticmethod(lambda dev: {}))
    col = embedded.TorchIntrospectCollector(
        device="cpu" if not cards else None)
    col.record_step(1, flops=8e12)
    col.begin_tick()
    devices = col.discover()
    assert [d.index for d in devices] == want_chips
    for dev in devices:
        assert col.sample(dev).values[schema.WORKLOAD_FLOPS.name] == share


def test_accept_fence_counts_fd_exhaustion_and_rearms(monkeypatch):
    import errno

    from kube_gpu_stats_tpu_torch import exposition, wal

    wal.reset_store_stats()
    sleeps = []
    monkeypatch.setattr(exposition.time, "sleep", sleeps.append)
    try:
        fence = exposition._AcceptFence()
        for _ in range(3):
            fence.faulted(OSError(errno.EMFILE, "too many open files"))
        assert fence.in_episode and sleeps == [0.05, 0.1, 0.2]
        report = wal.store_report()["http-accept"]
        assert report["state"] == "degraded"
        assert report["fault_counts"] == {"EMFILE": 3}
        fence.accepted()
        assert not fence.in_episode
        assert wal.store_report()["http-accept"]["state"] == "healthy"
    finally:
        wal.reset_store_stats()
