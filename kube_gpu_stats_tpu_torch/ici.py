"""Interconnect counter → bandwidth rate math.

The port's copy of the reference's :class:`RateTracker`: a counter that
goes backwards means the device or runtime restarted — emit no rate for
that interval rather than a huge negative/positive spike.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class _Last:
    value: int
    monotonic: float


class RateTracker:
    """Turns cumulative per-(device, link) counters into byte/s rates.

    Single-writer (the poll loop); no locking needed. Keys are opaque
    (device_id, link) tuples so the tracker also serves collective-op rates.
    """

    # Link-name churn guard: per-device entries beyond this are not
    # tracked (no rate, no stored state) — the poll loop caps exported
    # links separately, but churn WITHIN its cap must not grow this dict
    # for the device's lifetime either.
    MAX_LINKS_PER_DEVICE = 128

    def __init__(self) -> None:
        self._last: dict[tuple[str, str], _Last] = {}
        self._per_device: dict[str, int] = {}

    def rate(self, device_id: str, link: str, value: int, now: float) -> float | None:
        """Return bytes/sec since the previous observation, or None when no
        rate can be computed (first sample, reset/wraparound, zero dt,
        or the device's link-name budget is exhausted)."""
        key = (device_id, link)
        prev = self._last.get(key)
        if prev is None:
            if self._per_device.get(device_id, 0) >= self.MAX_LINKS_PER_DEVICE:
                return None
            self._per_device[device_id] = self._per_device.get(device_id, 0) + 1
        self._last[key] = _Last(value, now)
        if prev is None:
            return None
        dt = now - prev.monotonic
        if dt <= 0:
            return None
        delta = value - prev.value
        if delta < 0:
            # Counter reset (the device or its runtime restarted):
            # drop this interval; next tick re-establishes the baseline.
            return None
        return delta / dt

    def forget_device(self, device_id: str) -> None:
        for key in [k for k in self._last if k[0] == device_id]:
            del self._last[key]
        self._per_device.pop(device_id, None)
