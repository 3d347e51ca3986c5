"""The H100 node backend: NVML readings per card, one sample per tick.

The port's counterpart of the reference's ``collectors/composite.py``
(``TpuCollector``: sysfs plus the libtpu runtime-metrics RPC). On an
NVIDIA card the driver's NVML library (``native/nvml.py``) plays both
roles. Wired by ``daemon.build_collector`` for ``--backend nvml`` and by
the ``auto`` probe.

Discovery: one :class:`Device` per NVML index — ``device_id`` the index,
``device_path`` ``/dev/nvidia<minor number>``, ``uuid`` NVML's ``GPU-…``
string, ``accel_type`` from the product name through the same kind lookup
as the embedded collector (an H100 is ``gpu-h100``). NVML enumerates every
card of the node in PCI order, whatever ``CUDA_VISIBLE_DEVICES`` says.

Families per sample:

- ``utilization.gpu`` → ``accelerator_duty_cycle``;
- GPM's ``NVML_GPM_METRIC_ANY_TENSOR_UTIL`` →
  ``accelerator_tensorcore_utilization``: the share of the interval in
  which any tensor pipe was active, averaged over the SMs (the analog of
  DCGM's ``PIPE_TENSOR_ACTIVE``). ``docs/UNIFIED_SCHEMA.md`` defines the
  family as a share of the peak FLOP rate; a pipe kept busy by narrow or
  low-rate instructions reads as active here while doing fewer FLOPs, so
  this reading is an upper bound on that share;
- GPM's ``NVML_GPM_METRIC_DRAM_BW_UTIL`` →
  ``accelerator_memory_bandwidth_utilization``: DRAM bandwidth used as a
  share of the card's peak, the schema's meaning;
- memory ``used``/``total`` (``nvmlMemory_v2_t``: ``used`` leaves out the
  driver's reservation) → ``accelerator_memory_used_bytes`` /
  ``accelerator_memory_total_bytes``;
- power (mW / 1000) → ``accelerator_power_watts``;
- GPU temperature → ``accelerator_temperature_celsius``;
- per-link NVLink data counters (TX + RX, KiB × 1024) →
  ``Sample.ici_counters`` as ``link="nvlink<N>"``; the poll loop turns
  them into rates from the second tick. A link that has carried no byte
  since the driver loaded (a card without active links reads zeros), or
  whose counters are not supported, is omitted.

GPM metrics are computed between two samples of the card's counters, so
the collector keeps the previous tick's sample per card and the first
tick omits both GPM families. Where ``nvmlGpmQueryDeviceSupport`` says
no, or taking a sample fails (a container may refuse the card's counters
while the query says yes), the card has no GPM for the collector's life:
``accelerator_tensorcore_utilization`` is omitted and
``accelerator_memory_bandwidth_utilization`` is ``utilization.memory``,
the share of the last sample period in which device memory was read or
written (a time share, not a share of the peak bandwidth).
:attr:`NvmlCollector.gpm_state` says which, per card.

Not exported: NVML has no uptime reading, so ``accelerator_uptime_seconds``
is omitted, as the reference's sysfs backend omits what it cannot read.
``accelerator_energy_joules_total`` stays the poll loop's integration of
power, as in the reference.

Failures degrade one read at a time, as ``composite.assemble`` does: a
``NOT_SUPPORTED`` reading is omitted; a sample raises ``CollectorError``
(the loop serves ``accelerator_up 0``) when no reading succeeded, and at
once when the card is lost (``NVML_ERROR_GPU_IS_LOST``).

``nvmlInit_v2`` runs once per collector, in the constructor (so
``--backend nvml`` fails at startup without the driver); ``nvmlShutdown``
in :meth:`close`. Rediscovery re-enumerates.
"""

from __future__ import annotations

import logging
from typing import Callable, Mapping, Sequence

from . import Collector, CollectorError, Device, Sample
from .. import schema
from ..kinds import accel_type
from ..native import nvml as binding
from ..native.nvml import Nvml, NvmlError

log = logging.getLogger(__name__)

# (binding call, its reading -> {family: value}), in sample order.
_READS: tuple[tuple[str, Callable[..., Mapping[str, float]]], ...] = (
    ("utilization", lambda r: {
        schema.DUTY_CYCLE.name: float(r[0]),
        schema.MEMORY_BANDWIDTH_UTIL.name: float(r[1])}),
    ("memory", lambda r: {
        schema.MEMORY_USED.name: float(r[3]),
        schema.MEMORY_TOTAL.name: float(r[0])}),
    ("power_mw", lambda mw: {schema.POWER.name: mw / 1000.0}),
    ("temperature", lambda c: {schema.TEMPERATURE.name: float(c)}),
)

_LINK_FIELDS = (binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX)

# GPM metric id -> family.
_GPM_FAMILIES = (
    (binding.NVML_GPM_METRIC_ANY_TENSOR_UTIL, schema.TENSORCORE_UTIL.name),
    (binding.NVML_GPM_METRIC_DRAM_BW_UTIL, schema.MEMORY_BANDWIDTH_UTIL.name),
)
_GPM_IDS = tuple(metric_id for metric_id, _ in _GPM_FAMILIES)


class _GpmSamples:
    """One card's two GPM sample buffers: ``previous`` holds the last
    tick's counters once ``primed``."""

    def __init__(self, nvml) -> None:
        self.previous = nvml.gpm_sample_alloc()
        try:
            self.current = nvml.gpm_sample_alloc()
        except NvmlError:
            nvml.gpm_sample_free(self.previous)
            raise
        self.primed = False

    def free(self, nvml) -> None:
        for sample in (self.previous, self.current):
            try:
                nvml.gpm_sample_free(sample)
            except NvmlError as exc:
                log.warning("nvmlGpmSampleFree failed: %s", exc)


class NvmlCollector(Collector):
    name = "nvml"

    def __init__(self, nvml=None) -> None:
        """``nvml``: the binding (or ``testing.fake_nvml.FakeNvml``);
        None loads ``libnvidia-ml.so.1``. Raises ``NvmlError`` when the
        library cannot be loaded or ``nvmlInit_v2`` fails."""
        self._nvml = nvml if nvml is not None else Nvml()
        self._nvml.init()
        self._closed = False
        # device_id -> NVML handle / NVLink link count, from discover().
        self._handles: dict[str, int] = {}
        self._links: dict[str, int] = {}
        # device_id -> links that have carried traffic: exported from
        # their first non-zero read on.
        self._active_links: dict[str, set[int]] = {}
        # device_id -> the card's GPM samples, or None once GPM is found
        # unavailable; absent until the card's first sample.
        self._gpm: dict[str, _GpmSamples | None] = {}
        # device_id -> "on", "unsupported" or the NVML error that turned
        # GPM off for the card.
        self.gpm_state: dict[str, str] = {}

    def discover(self) -> Sequence[Device]:
        nvml = self._nvml
        devices: list[Device] = []
        handles: dict[str, int] = {}
        links: dict[str, int] = {}
        for index in range(nvml.device_count()):
            handle = nvml.handle(index)
            device_id = str(index)
            devices.append(Device(
                index=index,
                device_id=device_id,
                device_path=f"/dev/nvidia{nvml.minor_number(handle)}",
                accel_type=accel_type(nvml.name(handle)),
                uuid=nvml.uuid(handle),
            ))
            handles[device_id] = handle
            links[device_id] = self._link_count(handle)
        self._free_gpm()
        self._handles = handles
        self._links = links
        return devices

    def _link_count(self, handle: int) -> int:
        try:
            [(code, count)] = self._nvml.field_values(
                handle, [(binding.NVML_FI_DEV_NVLINK_LINK_COUNT, 0)])
        except NvmlError as exc:
            log.debug("NVLink link count unavailable: %s", exc)
            return 0
        return int(count) if code == binding.NVML_SUCCESS else 0

    def sample(self, device: Device) -> Sample:
        handle = self._handles.get(device.device_id)
        if handle is None:
            raise CollectorError(f"{device.device_path}: not discovered")
        values: dict[str, float] = {}
        failures: list[NvmlError] = []
        for call, to_families in _READS:
            reading = self._read(device, call, failures, handle)
            if reading is not None:
                values.update(to_families(reading))
        gpm = self._gpm_values(device, handle)
        if gpm is not None:
            # GPM serves the bandwidth family: not the time share.
            values.pop(schema.MEMORY_BANDWIDTH_UTIL.name, None)
            values.update(gpm)
        ici = self._nvlink(device, handle, failures)
        if not values:
            raise CollectorError(
                f"{device.device_path}: no NVML reading succeeded: "
                + ("; ".join(map(str, failures)) or "none is supported"))
        for exc in failures:
            log.debug("%s: reading missing: %s", device.device_path, exc)
        return Sample(device=device, values=values, ici_counters=ici)

    def _read(self, device: Device, call: str, failures: list[NvmlError],
              *args):
        """One binding call; None when it failed (recorded in
        ``failures`` unless not supported). A lost card raises."""
        try:
            return getattr(self._nvml, call)(*args)
        except NvmlError as exc:
            if exc.code == binding.NVML_ERROR_GPU_IS_LOST:
                raise CollectorError(f"{device.device_path}: {exc}") from exc
            if not exc.not_supported:
                failures.append(exc)
            return None

    def _gpm_values(self, device: Device, handle: int
                    ) -> dict[str, float] | None:
        """This tick's GPM families; None when the card has no GPM (the
        time share then stands), empty on the card's first tick."""
        nvml = self._nvml
        device_id = device.device_id
        if device_id not in self._gpm:
            samples = self._gpm[device_id] = self._gpm_open(device, handle)
            return None if samples is None else {}
        samples = self._gpm[device_id]
        if samples is None:
            return None
        try:
            nvml.gpm_sample_get(handle, samples.current)
            got = (nvml.gpm_metrics(samples.previous, samples.current,
                                    _GPM_IDS) if samples.primed else [])
        except NvmlError as exc:
            if exc.code == binding.NVML_ERROR_GPU_IS_LOST:
                raise CollectorError(f"{device.device_path}: {exc}") from exc
            # A failed read leaves no baseline: the next tick starts anew.
            samples.primed = False
            log.debug("%s: GPM reading missing: %s", device.device_path, exc)
            return {}
        samples.previous, samples.current = samples.current, samples.previous
        samples.primed = True
        return {family: float(value)
                for (_, family), (code, value) in zip(_GPM_FAMILIES, got)
                if code == binding.NVML_SUCCESS}

    def _gpm_open(self, device: Device, handle: int) -> _GpmSamples | None:
        """The card's GPM samples, or None (and why, in ``gpm_state``)
        when the card or the container does not give GPM."""
        nvml = self._nvml
        try:
            if not nvml.gpm_supported(handle):
                self.gpm_state[device.device_id] = "unsupported"
                return None
            samples = _GpmSamples(nvml)
        except NvmlError as exc:
            self.gpm_state[device.device_id] = str(exc)
            return None
        try:
            # One sample now proves the counters can be read at all.
            nvml.gpm_sample_get(handle, samples.previous)
        except NvmlError as exc:
            samples.free(nvml)
            self.gpm_state[device.device_id] = str(exc)
            log.info("%s: GPM unavailable (%s); serving NVML's memory "
                     "time share, no tensor-core utilization",
                     device.device_path, exc)
            return None
        samples.primed = True
        self.gpm_state[device.device_id] = "on"
        return samples

    def _free_gpm(self) -> None:
        gpm, self._gpm = self._gpm, {}
        for samples in gpm.values():
            if samples is not None:
                samples.free(self._nvml)

    def _nvlink(self, device: Device, handle: int,
                failures: list[NvmlError]) -> dict[str, int]:
        count = self._links.get(device.device_id, 0)
        if not count:
            return {}
        fields = [(field, link) for link in range(count)
                  for field in _LINK_FIELDS]
        got = self._read(device, "field_values", failures, handle, fields)
        if got is None:
            return {}
        active = self._active_links.setdefault(device.device_id, set())
        out: dict[str, int] = {}
        for link in range(count):
            (tx_code, tx), (rx_code, rx) = got[2 * link], got[2 * link + 1]
            if (tx_code != binding.NVML_SUCCESS
                    or rx_code != binding.NVML_SUCCESS):
                continue
            total = (int(tx) + int(rx)) * 1024
            if total == 0 and link not in active:
                continue
            active.add(link)
            out[f"nvlink{link}"] = total
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._free_gpm()
        try:
            self._nvml.shutdown()
        except NvmlError as exc:
            log.warning("nvmlShutdown failed: %s", exc)
