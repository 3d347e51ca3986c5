"""A scripted NVML with the binding's function surface, in pure Python.

Every CPU test of the NVML backend runs on it. Devices carry their
readings in the binding's units (milliwatts, millijoules, bytes, KiB per
NVLink link); a test changes them between ticks, scripts a return code
per call (``errors``), moves NVLink counters on at a rate
(``set_nvlink_rate``), stalls every Nth call of a named call
(``stalls``, as NVML on an H100 80GB HBM3 at 700 W took 20-113 ms in a
few percent of its memory and NVLink reads), or
loses the card (``lost``), which makes every call on it return
``NVML_ERROR_GPU_IS_LOST``.

A driver reload or a GPU reset on the node (:meth:`FakeNvml.reload`)
starts a new session epoch: the first ``init`` that finds no session
open (the library counts its inits; a shutdown by one holder does not
end another's session) moves it, and handles taken before that answer
``NVML_ERROR_INVALID_ARGUMENT``. ``reload(reset=True)`` also starts
every card's energy and NVLink counters again from 0. The outage itself
(every call failing until then) is scripted over this fake by
``testing.nvml_faults.NvmlFaults``, as over the real binding. Cards are
added or removed by editing ``devices`` between rediscoveries (hotplug).

``nvmlDeviceGetFieldValues`` answers under two names: ``power_instant``
for the burst sampler's one-field read of ``NVML_FI_DEV_POWER_INSTANT``
(``power_instant_mw``, or ``NVML_ERROR_NOT_SUPPORTED`` for that field
when ``power_instant_supported`` is False), ``field_values`` for every
other request.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

from ..native import nvml as binding
from ..native.nvml import NvmlError

_ERROR_TEXT = {
    binding.NVML_ERROR_UNINITIALIZED: "Uninitialized",
    binding.NVML_ERROR_INVALID_ARGUMENT: "Invalid Argument",
    binding.NVML_ERROR_LIB_RM_VERSION_MISMATCH:
        "RM has detected an NVML/RM version mismatch",
    binding.NVML_ERROR_NOT_SUPPORTED: "Not Supported",
    binding.NVML_ERROR_DRIVER_NOT_LOADED: "Driver Not Loaded",
    binding.NVML_ERROR_LIBRARY_NOT_FOUND: "NVML Shared Library Not Found",
    binding.NVML_ERROR_GPU_IS_LOST: "GPU is lost",
    binding.NVML_ERROR_UNKNOWN: "Unknown Error",
}


@dataclasses.dataclass
class FakeDevice:
    uuid: str
    minor: int
    name: str = "NVIDIA H100 80GB HBM3"
    gpu_util: int = 0
    mem_util: int = 0
    memory_total: int = 81559 * 1024**2
    memory_used: int = 0
    memory_reserved: int = 480 * 1024**2
    power_mw: int = 70_000
    temperature: int = 30
    energy_mj: int = 0
    # link id -> (tx KiB, rx KiB); None marks a link whose counters are
    # not supported. The link count is len(nvlink_kib) unless set.
    nvlink_kib: dict[int, tuple[int, int] | None] = dataclasses.field(
        default_factory=dict)
    link_count: int | None = None
    gpm_supported: bool = False
    tensor_util: float = 0.0
    dram_bw_util: float = 0.0
    # The instantaneous power field (mW; None reads power_mw).
    power_instant_mw: int | None = None
    power_instant_supported: bool = True
    # binding method name -> the nvmlReturn_t it returns instead.
    errors: dict[str, int] = dataclasses.field(default_factory=dict)
    # binding method name -> (seconds, every): every Nth call of it
    # sleeps that long before it answers. ``calls`` counts each name.
    stalls: dict[str, tuple[float, int]] = dataclasses.field(
        default_factory=dict)
    calls: dict[str, int] = dataclasses.field(default_factory=dict)
    lost: bool = False
    # link id -> KiB a second each way: the link's counters move on at
    # that rate between reads (:meth:`set_nvlink_rate`).
    nvlink_rate: dict[int, float] = dataclasses.field(default_factory=dict)
    _rate_since: float = 0.0

    def set_nvlink_rate(self, rates: dict[int, float]) -> None:
        """Links carrying traffic: from now on each link's TX and RX
        counters grow by ``rates[link]`` KiB a second."""
        self._fold_rates()
        self.nvlink_rate = dict(rates)

    def _fold_rates(self) -> None:
        now = time.monotonic()
        if self.nvlink_rate:
            dt = now - self._rate_since
            for link, rate in self.nvlink_rate.items():
                tx, rx = self.nvlink_kib.get(link) or (0, 0)
                step = int(rate * dt)
                self.nvlink_kib[link] = (tx + step, rx + step)
        self._rate_since = now


class FakeNvml:
    """``init_error`` scripts the return of ``nvmlInit_v2`` (e.g.
    ``NVML_ERROR_DRIVER_NOT_LOADED`` for a node without the driver)."""

    def __init__(self, devices: Sequence[FakeDevice] = (),
                 init_error: int | None = None,
                 driver_version: str = "580.159.03",
                 cuda_driver_version: int = 13000) -> None:
        self.devices = list(devices)
        self.init_error = init_error
        self._driver_version = driver_version
        self._cuda_driver_version = cuda_driver_version
        self.init_calls = 0
        self.shutdown_calls = 0
        self._refs = 0
        self._lock = threading.Lock()
        # Handles carry the session they were taken in: index + 1000 x
        # epoch. The first fresh session after a reload moves the epoch.
        self.epoch = 0
        self._reloaded = False
        # GPM sample buffer id -> the counters read into it (None until
        # read); ``gpm_freed`` counts the buffers given back.
        self.gpm_samples: dict[int, dict[int, float] | None] = {}
        self.gpm_freed = 0

    @staticmethod
    def _raise(code: int) -> None:
        raise NvmlError(code, _ERROR_TEXT.get(code, f"code {code}"))

    def error_string(self, code: int) -> str:
        return _ERROR_TEXT.get(code, f"code {code}")

    def reload(self, reset: bool = True) -> None:
        """The driver was reloaded: the next fresh session is a new
        epoch. ``reset`` zeroes every card's energy and NVLink counters,
        as a GPU reset does."""
        with self._lock:
            self._reloaded = True
            if reset:
                for dev in self.devices:
                    dev._fold_rates()
                    dev.energy_mj = 0
                    dev.nvlink_kib = {
                        link: None if pair is None else (0, 0)
                        for link, pair in dev.nvlink_kib.items()}

    def init(self) -> None:
        with self._lock:
            self.init_calls += 1
            if self.init_error is not None:
                self._raise(self.init_error)
            if self._refs == 0 and self._reloaded:
                # The first session after the reload: every older handle
                # is invalid.
                self._reloaded = False
                self.epoch += 1
            self._refs += 1

    def shutdown(self) -> None:
        with self._lock:
            self.shutdown_calls += 1
            if self._refs == 0:
                self._raise(binding.NVML_ERROR_UNINITIALIZED)
            self._refs -= 1

    def _session(self) -> None:
        if self._refs == 0:
            self._raise(binding.NVML_ERROR_UNINITIALIZED)

    def driver_version(self) -> str:
        self._session()
        return self._driver_version

    def cuda_driver_version(self) -> int:
        self._session()
        return self._cuda_driver_version

    def _device(self, handle: int, call: str) -> FakeDevice:
        self._session()
        epoch, index = divmod(handle, 1000)
        if epoch != self.epoch or index >= len(self.devices):
            self._raise(binding.NVML_ERROR_INVALID_ARGUMENT)
        dev = self.devices[index]
        with self._lock:
            n = dev.calls[call] = dev.calls.get(call, 0) + 1
        stall = dev.stalls.get(call)
        if stall is not None and n % stall[1] == 0:
            time.sleep(stall[0])
        if dev.lost:
            self._raise(binding.NVML_ERROR_GPU_IS_LOST)
        code = dev.errors.get(call)
        if code is not None:
            self._raise(code)
        return dev

    def device_count(self) -> int:
        self._session()
        return len(self.devices)

    def handle(self, index: int) -> int:
        handle = index + 1000 * self.epoch
        self._device(handle, "handle")
        return handle

    def uuid(self, handle: int) -> str:
        return self._device(handle, "uuid").uuid

    def name(self, handle: int) -> str:
        return self._device(handle, "name").name

    def minor_number(self, handle: int) -> int:
        return self._device(handle, "minor_number").minor

    def utilization(self, handle: int) -> tuple[int, int]:
        dev = self._device(handle, "utilization")
        return dev.gpu_util, dev.mem_util

    def memory(self, handle: int) -> tuple[int, int, int, int]:
        dev = self._device(handle, "memory")
        return (dev.memory_total, dev.memory_reserved,
                dev.memory_total - dev.memory_reserved - dev.memory_used,
                dev.memory_used)

    def power_mw(self, handle: int) -> int:
        return self._device(handle, "power_mw").power_mw

    def temperature(self, handle: int) -> int:
        return self._device(handle, "temperature").temperature

    def energy_mj(self, handle: int) -> int:
        return self._device(handle, "energy_mj").energy_mj

    def field_values(self, handle: int, fields: Sequence[tuple[int, int]]
                     ) -> list[tuple[int, float | int | None]]:
        instant = [(binding.NVML_FI_DEV_POWER_INSTANT, 0)]
        if list(fields) == instant:
            dev = self._device(handle, "power_instant")
            if not dev.power_instant_supported:
                return [(binding.NVML_ERROR_NOT_SUPPORTED, None)]
            return [(binding.NVML_SUCCESS,
                     dev.power_mw if dev.power_instant_mw is None
                     else dev.power_instant_mw)]
        dev = self._device(handle, "field_values")
        dev._fold_rates()
        out: list[tuple[int, float | int | None]] = []
        for field_id, link in fields:
            if field_id == binding.NVML_FI_DEV_NVLINK_LINK_COUNT:
                count = (len(dev.nvlink_kib) if dev.link_count is None
                         else dev.link_count)
                out.append((binding.NVML_SUCCESS, count))
                continue
            pair = dev.nvlink_kib.get(link)
            if pair is None or field_id not in (
                    binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                    binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX):
                out.append((binding.NVML_ERROR_NOT_SUPPORTED, None))
                continue
            tx, rx = pair
            value = (tx if field_id
                     == binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX else rx)
            out.append((binding.NVML_SUCCESS, value))
        return out

    # -- GPM -----------------------------------------------------------------

    def gpm_supported(self, handle: int) -> bool:
        return self._device(handle, "gpm_supported").gpm_supported

    def gpm_sample_alloc(self) -> int:
        with self._lock:
            sample = len(self.gpm_samples) + 1
            self.gpm_samples[sample] = None
        return sample

    def gpm_sample_free(self, sample: int) -> None:
        with self._lock:
            del self.gpm_samples[sample]
            self.gpm_freed += 1

    def gpm_sample_get(self, handle: int, sample: int) -> None:
        dev = self._device(handle, "gpm_sample_get")
        if not dev.gpm_supported:
            self._raise(binding.NVML_ERROR_NOT_SUPPORTED)
        self.gpm_samples[sample] = {
            binding.NVML_GPM_METRIC_ANY_TENSOR_UTIL: dev.tensor_util,
            binding.NVML_GPM_METRIC_DRAM_BW_UTIL: dev.dram_bw_util}

    def gpm_metrics(self, sample1: int, sample2: int,
                    metric_ids: Sequence[int]
                    ) -> list[tuple[int, float | None]]:
        first, second = self.gpm_samples[sample1], self.gpm_samples[sample2]
        if first is None or second is None:
            self._raise(binding.NVML_ERROR_UNKNOWN)
        return [(binding.NVML_SUCCESS, second[i]) if i in second
                else (binding.NVML_ERROR_NOT_SUPPORTED, None)
                for i in metric_ids]
