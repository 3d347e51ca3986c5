"""Mock and null backends: schema-valid output with no accelerator.

The port's copy of the reference's ``collectors/mock.py``. ``mock`` is a
shippable product feature for card-less nodes and the fixture the daemon
tests build on; ``null`` serves the self-metrics alone. The values are
the reference's, deterministic functions of (chip, tick), so the two
packages' expositions can be held against each other byte for byte.
"""

from __future__ import annotations

import itertools
from typing import Sequence

from . import Collector, CollectorError, Device, Sample
from .. import schema

_HBM_TOTAL = 95 * 1024**3  # the reference's mock capacity, bytes
_LINKS = ("x0", "x1", "y0", "y1", "z0", "z1")  # the reference's link names


class MockCollector(Collector):
    name = "mock"

    def __init__(
        self,
        num_devices: int = 4,
        accel_type: str = "mock",
        fail_devices: Sequence[int] = (),
        start_tick: int = 0,
    ) -> None:
        self._num = num_devices
        self._accel_type = accel_type
        self._fail = frozenset(fail_devices)
        # Per-device tick counters so each sample advances deterministically
        # regardless of call interleaving.
        self._ticks = [itertools.count(start_tick) for _ in range(num_devices)]

    def discover(self) -> Sequence[Device]:
        return [
            Device(
                index=i,
                device_id=str(i),
                device_path=f"/dev/accel{i}",
                accel_type=self._accel_type,
                uuid=f"mock-{i:04x}",
            )
            for i in range(self._num)
        ]

    def sample(self, device: Device) -> Sample:
        if device.index in self._fail:
            raise CollectorError(f"mock failure injected for chip {device.index}")
        tick = next(self._ticks[device.index])
        # Triangle wave 0..100 with period 60 ticks, phase-shifted per chip.
        phase = (tick + device.index * 7) % 60
        duty = (phase if phase <= 30 else 60 - phase) * (100.0 / 30.0)
        hbm_used = int(_HBM_TOTAL * (0.10 + 0.008 * ((tick + device.index) % 100)))
        values = {
            schema.DUTY_CYCLE.name: duty,
            schema.TENSORCORE_UTIL.name: duty * 0.85,
            schema.MEMORY_USED.name: float(hbm_used),
            schema.MEMORY_TOTAL.name: float(_HBM_TOTAL),
            schema.MEMORY_BANDWIDTH_UTIL.name: duty * 0.6,
            schema.POWER.name: 90.0 + duty * 2.5,
            schema.TEMPERATURE.name: 35.0 + duty * 0.3,
            schema.UPTIME.name: float(3600 + tick),
            # Synthetic DCN latency: a stable spread around a per-chip base
            # so the percentile ordering p50<p90<p99 holds.
            schema.dcn_value_key("p50"): 0.0010 + 0.0001 * device.index,
            schema.dcn_value_key("p90"): 0.0030 + 0.0001 * device.index,
            schema.dcn_value_key("p99"): 0.0080 + 0.0001 * device.index,
        }
        # Cumulative link counters: constant per-link rate, distinct per chip.
        rate = 1_000_000 * (device.index + 1)
        ici = {link: (tick + 1) * rate * (li + 1) for li, link in enumerate(_LINKS)}
        return Sample(
            device=device,
            values=values,
            ici_counters=ici,
            collective_ops=(tick + 1) * 10 * (device.index + 1),
        )


class NullCollector(Collector):
    """Zero devices: exposition stays schema-valid (self-metrics only) on
    nodes with no accelerator."""

    name = "null"

    def discover(self) -> Sequence[Device]:
        return []

    def sample(self, device: Device) -> Sample:  # pragma: no cover
        raise CollectorError("null collector has no devices")
