"""A scripted NVML with the binding's function surface, in pure Python.

Every CPU test of the NVML backend runs on it. Devices carry their
readings in the binding's units (milliwatts, millijoules, bytes, KiB per
NVLink link); a test changes them between ticks, scripts a return code
per call (``errors``), or loses the card (``lost``), which makes every
call on it return ``NVML_ERROR_GPU_IS_LOST``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

from ..native import nvml as binding
from ..native.nvml import NvmlError

_ERROR_TEXT = {
    binding.NVML_ERROR_UNINITIALIZED: "Uninitialized",
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
    power_mw: int = 70_000
    temperature: int = 30
    energy_mj: int = 0
    # link id -> (tx KiB, rx KiB); None marks a link whose counters are
    # not supported. The link count is len(nvlink_kib) unless set.
    nvlink_kib: dict[int, tuple[int, int] | None] = dataclasses.field(
        default_factory=dict)
    link_count: int | None = None
    # binding method name -> the nvmlReturn_t it returns instead.
    errors: dict[str, int] = dataclasses.field(default_factory=dict)
    lost: bool = False


class FakeNvml:
    """``init_error`` scripts the return of ``nvmlInit_v2`` (e.g.
    ``NVML_ERROR_DRIVER_NOT_LOADED`` for a node without the driver)."""

    def __init__(self, devices: Sequence[FakeDevice] = (),
                 init_error: int | None = None) -> None:
        self.devices = list(devices)
        self.init_error = init_error
        self.init_calls = 0
        self.shutdown_calls = 0
        self._refs = 0
        self._lock = threading.Lock()

    @staticmethod
    def _raise(code: int) -> None:
        raise NvmlError(code, _ERROR_TEXT.get(code, f"code {code}"))

    def error_string(self, code: int) -> str:
        return _ERROR_TEXT.get(code, f"code {code}")

    def init(self) -> None:
        with self._lock:
            self.init_calls += 1
            if self.init_error is not None:
                self._raise(self.init_error)
            self._refs += 1

    def shutdown(self) -> None:
        with self._lock:
            self.shutdown_calls += 1
            if self._refs == 0:
                self._raise(binding.NVML_ERROR_UNINITIALIZED)
            self._refs -= 1

    def _device(self, handle: int, call: str) -> FakeDevice:
        if self._refs == 0:
            self._raise(binding.NVML_ERROR_UNINITIALIZED)
        dev = self.devices[handle]
        if dev.lost:
            self._raise(binding.NVML_ERROR_GPU_IS_LOST)
        code = dev.errors.get(call)
        if code is not None:
            self._raise(code)
        return dev

    def device_count(self) -> int:
        if self._refs == 0:
            self._raise(binding.NVML_ERROR_UNINITIALIZED)
        return len(self.devices)

    def handle(self, index: int) -> int:
        self._device(index, "handle")
        return index

    def uuid(self, handle: int) -> str:
        return self._device(handle, "uuid").uuid

    def name(self, handle: int) -> str:
        return self._device(handle, "name").name

    def minor_number(self, handle: int) -> int:
        return self._device(handle, "minor_number").minor

    def utilization(self, handle: int) -> tuple[int, int]:
        dev = self._device(handle, "utilization")
        return dev.gpu_util, dev.mem_util

    def memory(self, handle: int) -> tuple[int, int, int]:
        dev = self._device(handle, "memory")
        return (dev.memory_total, dev.memory_total - dev.memory_used,
                dev.memory_used)

    def power_mw(self, handle: int) -> int:
        return self._device(handle, "power_mw").power_mw

    def temperature(self, handle: int) -> int:
        return self._device(handle, "temperature").temperature

    def energy_mj(self, handle: int) -> int:
        return self._device(handle, "energy_mj").energy_mj

    def field_values(self, handle: int, fields: Sequence[tuple[int, int]]
                     ) -> list[tuple[int, float | int | None]]:
        dev = self._device(handle, "field_values")
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
