"""Embedded (workload-side) exporter — telemetry from inside the process
that owns the card.

The port of the reference's embedded exporter: the SAME registry + poll
loop + exposition stack runs *inside* the workload process and collects
what in-process PyTorch can see:

- device enumeration (every local CUDA card: its product name, its
  ``/dev/nvidiaN`` device file);
- per-card memory from PyTorch's caching allocator
  (``allocated_bytes.all.current`` and ``.peak`` — the tensors the
  workload holds, not the allocator's cached-but-free blocks) and the
  card's capacity (``torch.cuda.mem_get_info``);
- a workload step hook (``exporter.record_step()``) exported as
  ``accelerator_workload_steps_total``. Timed steps additionally feed
  ``accelerator_workload_busy_seconds_total`` (rate() = busy fraction)
  and the ``accelerator_workload_step_duration_seconds`` histogram;
  steps reporting ``flops=`` also feed the per-card FLOPs counter and a
  live MFU gauge against the card's peak dense bf16 rate.

Usage (one call in the training script)::

    from kube_gpu_stats_tpu_torch import embedded
    exporter = embedded.start(port=9400)        # or port=0 = pick free
    for batch in data:
        with exporter.step_timer():             # or exporter.record_step()
            step(batch)

The scrape surface, schema, labels and self-metrics are the reference's,
so Prometheus cannot tell an H100 node's exposition from a TPU node's.
Everything runs on the CUDA cards unless the caller passes
``device="cpu"``; without CUDA the exporter raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Sequence

import torch

from . import schema
from .collectors import Collector, CollectorError, Device, Sample
from .device import device_kind, local_devices, on_device
from .exposition import MetricsServer, RenderStats, TextfileWriter
from .kinds import _kind_peak_flops, accel_type
from .poll import PollLoop
from .registry import HistogramState, Registry
from .topology import topology_labels

log = logging.getLogger(__name__)

def nvml_minors(nvml=None) -> dict[str, int]:
    """NVML's ``GPU-…`` UUID -> minor number for every card of the node;
    empty when NVML cannot be loaded or read (no driver library in the
    container). ``nvml``: the binding (or ``testing.fake_nvml.FakeNvml``);
    None loads ``libnvidia-ml.so.1``."""
    from .native.nvml import Nvml, NvmlError

    if nvml is None:
        nvml = Nvml()
    try:
        nvml.init()
    except NvmlError as exc:
        log.info("NVML unavailable, device_path is the card's UUID: %s", exc)
        return {}
    try:
        return {nvml.uuid(handle): nvml.minor_number(handle)
                for handle in map(nvml.handle, range(nvml.device_count()))}
    except NvmlError as exc:
        log.info("NVML could not list the cards, device_path is the "
                 "card's UUID: %s", exc)
        return {}
    finally:
        nvml.shutdown()


def nvidia_device_path(ordinal: int, visible: str | None, uuid: str,
                       minors: dict[str, int]) -> str:
    """The ``device_path`` label of CUDA ordinal ``ordinal``, whose card
    has the ``GPU-…`` UUID ``uuid``, given the ``CUDA_VISIBLE_DEVICES``
    string (None when unset) and NVML's UUID -> minor map.

    The card is matched by UUID, whatever selected it: the minor number's
    file, ``/dev/nvidia<minor>``, as the DaemonSet serves it. An integer
    entry of ``CUDA_VISIBLE_DEVICES`` is neither the minor nor the NVML
    index (CUDA orders cards its own way). Where NVML does not know the
    UUID (no NVML in the container), the UUID itself is emitted, and a
    ``MIG-…`` entry is emitted as itself: a stable node-local identity,
    never a guessed device file. An ordinal the list does not reach
    raises ``ValueError``."""
    if visible is not None:
        entries = []
        # CUDA reads the list up to its first entry that is neither an
        # index nor a UUID; the cards after it are not visible.
        for entry in visible.split(","):
            entry = entry.strip()
            if not (entry.isdecimal() or entry.startswith(("GPU-", "MIG-"))):
                break
            entries.append(entry)
        if not 0 <= ordinal < len(entries):
            raise ValueError(f"CUDA ordinal {ordinal} is not in "
                             f"CUDA_VISIBLE_DEVICES={visible!r}")
        if entries[ordinal].startswith("MIG-"):
            return entries[ordinal]
    minor = minors.get(uuid)
    return uuid if minor is None else f"/dev/nvidia{minor}"


def cuda_uuid(device: torch.device) -> str:
    """The card's UUID as NVML and ``nvidia-smi`` spell it."""
    return "GPU-" + str(torch.cuda.get_device_properties(device).uuid)


def _world_size() -> int:
    """The torch.distributed world size when a process group is up, else 1
    (the burn's ``_global_scale``: every process burns the cards it owns,
    ``device.local_devices``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class TorchIntrospectCollector(Collector):
    """Collector over in-process PyTorch device introspection. No RPC, no
    NVML — everything comes from the live CUDA runtime of this process.

    ``device=None`` means the cards this process owns
    (``device.local_devices``: every visible card, or the current one
    under one process per card; raises without CUDA); ``device="cpu"``
    one CPU device, which has no allocator statistics: its samples carry
    no memory families (partial data, never a guess)."""

    name = "torch-embedded"

    def __init__(self, device=None) -> None:
        self._start_monotonic = time.monotonic()
        devices = local_devices(device)
        # chip index -> (device, product name); the CUDA ordinal is the
        # chip index, so a card named alone keeps its number.
        self._devices = {dev.index or 0: (dev, device_kind(dev))
                         for dev in devices}
        # The workload thread's counters, published by reference swap as
        # one immutable (steps, busy_seconds, flops, step histogram)
        # tuple; the poll thread takes ONE read of it per tick
        # (begin_tick), so every family of a snapshot describes the same
        # set of steps (the histogram's _count equals the steps counter
        # in every scrape). One workload thread reports steps in practice.
        self._counters: tuple[int, float, float, HistogramState] = (
            0, 0.0, 0.0, HistogramState.empty(
                schema.WORKLOAD_STEP_DURATION, schema.STEP_DURATION_BUCKETS))
        self._tick_counters = self._counters
        # MFU window state, advanced once per tick in begin_tick (poll
        # thread); sample() divides the precomputed per-device FLOP/s by
        # ITS device's peak, so mixed-kind processes get correct
        # per-device MFU.
        self._flops_per_device_per_s: float | None = None
        self._mfu_prev: tuple[float, float] | None = None  # (flops, at)
        # FLOPs are reported workload-global; the per-card share divides
        # by the GLOBAL card count: this process's cards times the
        # process group's world size (every process burns the cards it
        # owns, as loadgen's hook FLOPs assume). Under one process per
        # card that is the world size.
        self._global_devices = max(1, len(devices) * _world_size())
        self._device_paths = self._cuda_device_paths(devices)

    # -- workload hook -------------------------------------------------------

    def record_step(self, n: int = 1, seconds: float | None = None,
                    flops: float | None = None) -> None:
        """Report n completed steps; ``seconds`` is the wall time they
        took (feeds the busy counter and the step-duration histogram as
        seconds/n per step); ``flops`` is the model FLOPs those n steps
        executed across the whole workload (feeds the FLOPs counter and
        the in-process MFU gauge)."""
        steps, busy, total_flops, hist = self._counters
        steps += n
        if seconds is not None and n > 0:
            busy += seconds
            hist = hist.observe(seconds / n, count=n)
        if flops is not None and flops > 0:
            total_flops += flops
        self._counters = (steps, busy, total_flops, hist)

    @contextlib.contextmanager
    def step_timer(self, flops: float | None = None) -> Iterator[None]:
        """Time one step: ``with collector.step_timer(): train_step()``.
        ``flops`` = model FLOPs this step executes (for MFU)."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.record_step(1, seconds=time.perf_counter() - start,
                             flops=flops)

    def begin_tick(self) -> None:
        """Take this tick's view of the workload counters, and advance the
        MFU window: the delta of workload-reported FLOPs over the tick
        interval, as a per-device rate; sample() divides by each device's
        own peak."""
        # Single read: the training thread may record_step(flops=) at any
        # point in here; reading twice would count those FLOPs in both
        # this window (the delta) and the next (the stored baseline).
        self._tick_counters = counters = self._counters
        flops = counters[2]
        if flops <= 0:
            return
        now = time.monotonic()
        prev = self._mfu_prev
        self._mfu_prev = (flops, now)
        if prev is None:
            return
        dt = now - prev[1]
        if dt <= 0:
            return
        self._flops_per_device_per_s = (
            (flops - prev[0]) / self._global_devices / dt)

    def extra_histograms(self) -> tuple[HistogramState, ...]:
        """Poll-loop hook: fold the step-duration histogram (as of this
        tick's begin_tick) into each snapshot."""
        return (self._tick_counters[3],)

    # -- Collector interface -------------------------------------------------

    def discover(self) -> Sequence[Device]:
        # accel_type per DEVICE, not from device 0: a process may hold
        # cards of different kinds.
        return [
            Device(
                index=index,
                device_id=str(index),
                device_path=self._device_paths.get(index, "torch:cpu:0"),
                accel_type=accel_type(kind),
            )
            for index, (dev, kind) in self._devices.items()
        ]

    @staticmethod
    def _cuda_device_paths(devices) -> dict[int, str]:
        """CUDA ordinal -> device_path of every card among ``devices``,
        resolved once through NVML (``nvidia_device_path``)."""
        cards = [dev for dev in devices if dev.type == "cuda"]
        if not cards:
            return {}
        minors = nvml_minors()
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        return {dev.index: nvidia_device_path(dev.index, visible,
                                              cuda_uuid(dev), minors)
                for dev in cards}

    @staticmethod
    def _memory(dev: torch.device) -> dict[str, float]:
        """Used and peak bytes of PyTorch's allocator, and the card's
        capacity. Read under the card's own context: the poll thread is
        not the workload's."""
        try:
            with on_device(dev):
                stats = torch.cuda.memory_stats(dev)
                total = torch.cuda.mem_get_info(dev)[1]
        except Exception as exc:
            raise CollectorError(f"memory stats of {dev} failed: {exc}") from exc
        return {
            # An allocator that never allocated has no keys yet: nothing
            # is allocated.
            schema.MEMORY_USED.name: float(
                stats.get("allocated_bytes.all.current", 0)),
            schema.MEMORY_PEAK.name: float(
                stats.get("allocated_bytes.all.peak", 0)),
            schema.MEMORY_TOTAL.name: float(total),
        }

    def sample(self, device: Device) -> Sample:
        entry = self._devices.get(device.index)
        if entry is None:
            raise CollectorError(f"device {device.index} disappeared")
        dev, kind = entry
        values: dict[str, float] = (
            {} if dev.type == "cpu" else self._memory(dev))
        steps, busy, flops, _hist = self._tick_counters
        values[schema.UPTIME.name] = time.monotonic() - self._start_monotonic
        values[schema.WORKLOAD_STEPS.name] = float(steps)
        values[schema.WORKLOAD_BUSY_SECONDS.name] = busy
        peak = _kind_peak_flops(kind)
        if peak is not None:
            values[schema.PEAK_FLOPS.name] = peak
        if flops > 0:
            values[schema.WORKLOAD_FLOPS.name] = flops / self._global_devices
            if self._flops_per_device_per_s is not None and peak is not None:
                values[schema.WORKLOAD_MFU.name] = (
                    100.0 * self._flops_per_device_per_s / peak)
        return Sample(device=device, values=values)

    def close(self) -> None:
        pass


class EmbeddedExporter:
    """The registry/poll/exposition stack wired around a
    TorchIntrospectCollector, owned by the workload process."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 textfile: str | None = None, interval: float = 1.0,
                 metrics_include: Sequence[str] = (),
                 metrics_exclude: Sequence[str] = (),
                 device=None) -> None:
        # Same family selection as the daemon's --metrics-include/
        # --metrics-exclude (validated: a typo raises at start()).
        disabled = schema.resolve_metric_filter(metrics_include,
                                                metrics_exclude)
        self.registry = Registry()
        self.render_stats = RenderStats()
        self.collector = TorchIntrospectCollector(device)
        self.poll = PollLoop(
            self.collector,
            self.registry,
            interval=interval,
            disabled_metrics=disabled,
            # In-process introspection is a few allocator reads per card,
            # but it shares the interpreter with the workload: keep the
            # reference's headroom over the poll loop's 50 ms default.
            deadline=5.0,
            topology_labels=topology_labels(),
            version="embedded",
            render_stats=self.render_stats.contribute,
        )
        self.server = MetricsServer(
            self.registry, host, port,
            healthz_max_age=max(5.0, interval * 5),
            render_stats=self.render_stats,
        )
        self.textfile = (
            TextfileWriter(self.registry, textfile,
                           render_stats=self.render_stats)
            if textfile else None
        )
        self._started = False

    @property
    def port(self) -> int:
        return self.server.port

    def record_step(self, n: int = 1, seconds: float | None = None,
                    flops: float | None = None) -> None:
        self.collector.record_step(n, seconds=seconds, flops=flops)

    def step_timer(self, flops: float | None = None
                   ) -> contextlib.AbstractContextManager[None]:
        return self.collector.step_timer(flops=flops)

    def start(self) -> "EmbeddedExporter":
        self.server.start()
        if self.textfile:
            self.textfile.start()
        self.poll.start()
        self._started = True
        log.info("embedded exporter: %d device(s), scrape on :%d",
                 len(self.poll.devices), self.port)
        return self

    def stop(self) -> None:
        if not self._started:
            return
        self.poll.stop()
        if self.textfile:
            self.textfile.stop()
        self.server.stop()
        self._started = False


def start(port: int = 0, *, host: str = "127.0.0.1",
          textfile: str | None = None,
          interval: float = 1.0,
          metrics_include: Sequence[str] = (),
          metrics_exclude: Sequence[str] = (),
          device=None) -> EmbeddedExporter:
    """Start an embedded exporter inside this (workload) process."""
    return EmbeddedExporter(port=port, host=host, textfile=textfile,
                            interval=interval,
                            metrics_include=metrics_include,
                            metrics_exclude=metrics_exclude,
                            device=device).start()
