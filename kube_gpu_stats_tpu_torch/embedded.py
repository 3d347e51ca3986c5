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
import re
import time
from typing import Iterator, Sequence

import torch

from . import schema
from .collectors import Collector, CollectorError, Device, Sample
from .device import device_kind, local_devices, on_device
from .exposition import MetricsServer, RenderStats, TextfileWriter
from .poll import PollLoop
from .registry import HistogramState, Registry
from .topology import topology_labels

log = logging.getLogger(__name__)

# Device memory per card by device-name substring. Checked in order — more
# specific spellings first ("h100 nvl" and "h100 pcie" before the bare
# "h100", which the SXM part's name "NVIDIA H100 80GB HBM3" matches).
# Unknown kinds return None — partial data, never a guess. Each row cites
# the public spec it came from.
_HBM_BY_KIND: tuple[tuple[str, int], ...] = (
    # H100 NVL: 94 GB HBM3 — NVIDIA H100 Tensor Core GPU datasheet
    ("h100 nvl", 94 * 1024**3),
    # H100 PCIe: 80 GB HBM2e — same datasheet
    ("h100 pcie", 80 * 1024**3),
    # H100 SXM: 80 GB HBM3 — same datasheet
    ("h100", 80 * 1024**3),
)


# Peak dense (no sparsity) bf16 tensor-core FLOP/s per card, same match
# discipline. The MFU denominator; each row cites the public spec.
_PEAK_FLOPS_BY_KIND: tuple[tuple[str, float], ...] = (
    # H100 NVL: 835 TFLOPS bf16 dense — NVIDIA H100 datasheet
    ("h100 nvl", 835e12),
    # H100 PCIe: 756 TFLOPS bf16 dense — same datasheet
    ("h100 pcie", 756e12),
    # H100 SXM: 989 TFLOPS bf16 dense — same datasheet
    ("h100", 989e12),
)


def _kind_lookup(table, device_kind: str):
    """First-match substring lookup over a per-device-kind table."""
    lowered = device_kind.lower()
    for needle, value in table:
        if needle in lowered:
            return value
    return None


def _kind_capacity(device_kind: str) -> int | None:
    return _kind_lookup(_HBM_BY_KIND, device_kind)


def _kind_peak_flops(device_kind: str) -> float | None:
    return _kind_lookup(_PEAK_FLOPS_BY_KIND, device_kind)


_MODEL_TOKEN = re.compile(r"[A-Za-z]+\d+[A-Za-z]*")


def accel_type(name: str) -> str:
    """The ``accel_type`` label for a device's product name
    (``docs/UNIFIED_SCHEMA.md``: the normalized NVML product name):
    ``"NVIDIA H100 80GB HBM3"`` → ``"gpu-h100"``, ``"NVIDIA A100-SXM4-80GB"``
    → ``"gpu-a100"``. The first token of letters then digits is the model;
    a name without one keeps all its words (``"NVIDIA GeForce RTX 4090"``
    → ``"gpu-geforce-rtx-4090"``). ``"cpu"`` stays ``"cpu"``."""
    if name.lower() == "cpu":
        return "cpu"
    tokens = [t for t in re.split(r"[\s\-_]+", name)
              if t and t.lower() != "nvidia"]
    for token in tokens:
        if _MODEL_TOKEN.fullmatch(token):
            return "gpu-" + token.lower()
    return "-".join(["gpu"] + [t.lower() for t in tokens])


def nvidia_device_path(ordinal: int, visible: str | None) -> str:
    """The ``device_path`` label of CUDA ordinal ``ordinal`` given the
    ``CUDA_VISIBLE_DEVICES`` string (None when unset).

    Unset: the ordinal is the physical minor number, ``/dev/nvidia<N>``.
    A list of integers: the ordinal indexes it, ``/dev/nvidia<list[N]>``.
    A UUID entry (``GPU-…`` or ``MIG-…``): the minor number cannot be
    known from the environment, so the entry itself is emitted — a stable
    node-local identity, never a guessed device file."""
    if visible is None:
        return f"/dev/nvidia{ordinal}"
    entries = []
    # CUDA reads the list up to its first entry that is neither an index
    # nor a UUID; the cards after it are not visible.
    for entry in visible.split(","):
        entry = entry.strip()
        if not (entry.isdecimal() or entry.startswith(("GPU-", "MIG-"))):
            break
        entries.append(entry)
    if not 0 <= ordinal < len(entries):
        raise ValueError(f"CUDA ordinal {ordinal} is not in "
                         f"CUDA_VISIBLE_DEVICES={visible!r}")
    entry = entries[ordinal]
    return f"/dev/nvidia{int(entry)}" if entry.isdecimal() else entry


def _world_size() -> int:
    """The torch.distributed world size when a process group is up, else 1
    (the burn's ``_global_scale``: every process burns its own cards)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class TorchIntrospectCollector(Collector):
    """Collector over in-process PyTorch device introspection. No RPC, no
    NVML — everything comes from the live CUDA runtime of this process.

    ``device=None`` means every local CUDA card (raises without CUDA);
    ``device="cpu"`` one CPU device, which has no allocator statistics:
    its samples carry no memory families (partial data, never a guess)."""

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
        # process group's world size (every process burns its own cards,
        # as loadgen's hook FLOPs assume).
        self._global_devices = max(1, len(devices) * _world_size())
        self._visible = os.environ.get("CUDA_VISIBLE_DEVICES")

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
                device_path=("torch:cpu:0" if dev.type == "cpu" else
                             nvidia_device_path(index, self._visible)),
                accel_type=accel_type(kind),
            )
            for index, (dev, kind) in self._devices.items()
        ]

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
