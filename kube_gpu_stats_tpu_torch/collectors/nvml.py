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
- ``utilization.memory`` → ``accelerator_memory_bandwidth_utilization``.
  NVML's figure is the share of the last sample period in which device
  memory was being read or written, not DCGM's DRAM-active share (the
  fraction of cycles the DRAM interface was busy) that
  ``docs/UNIFIED_SCHEMA.md`` names for this family;
- memory ``used``/``total`` → ``accelerator_memory_used_bytes`` /
  ``accelerator_memory_total_bytes``;
- power (mW / 1000) → ``accelerator_power_watts``;
- GPU temperature → ``accelerator_temperature_celsius``;
- per-link NVLink data counters (TX + RX, KiB × 1024) →
  ``Sample.ici_counters`` as ``link="nvlink<N>"``; the poll loop turns
  them into rates from the second tick. A link that has carried no byte
  since the driver loaded (a card without active links reads zeros), or
  whose counters are not supported, is omitted.

Not exported: NVML has no tensor-core or uptime reading without DCGM, so
``accelerator_tensorcore_utilization`` and ``accelerator_uptime_seconds``
are omitted, as the reference's sysfs backend omits what it cannot read.
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
        schema.MEMORY_USED.name: float(r[2]),
        schema.MEMORY_TOTAL.name: float(r[0])}),
    ("power_mw", lambda mw: {schema.POWER.name: mw / 1000.0}),
    ("temperature", lambda c: {schema.TEMPERATURE.name: float(c)}),
)

_LINK_FIELDS = (binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX)


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
        try:
            self._nvml.shutdown()
        except NvmlError as exc:
            log.warning("nvmlShutdown failed: %s", exc)
