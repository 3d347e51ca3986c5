"""Device backends: the collector trait the poll loop samples.

The port's copy of the reference's trait (``Device``, ``Sample``,
``CollectorError``, ``Collector``). The only backend so far is the
embedded one, ``embedded.TorchIntrospectCollector``; an NVML backend for
the DaemonSet comes later.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Device:
    """One local accelerator chip.

    ``device_id`` is the stable node-local identity (the CUDA ordinal for
    the embedded collector); ``device_path`` the node-local device file
    (``/dev/nvidiaN``, ``docs/UNIFIED_SCHEMA.md``).
    """

    index: int
    device_id: str
    device_path: str  # "/dev/nvidia0"
    accel_type: str  # "gpu-h100", "cpu", ...
    uuid: str = ""


@dataclasses.dataclass(frozen=True)
class Sample:
    """One poll of one device.

    ``values`` maps metric-family name (schema.py) -> value.
    ``ici_counters`` maps link name -> cumulative traffic bytes; the poll
    loop turns deltas into bandwidth gauges (C10 rate math lives OFF the
    collector so every backend gets wraparound handling for free).
    ``raw_values`` maps ``(family, link)`` pairs — the runtime-native
    family name outside the pinned schema, and its link attribute or ""
    — to values; the poll loop exports them under the schema's
    ``tpu_runtime_passthrough`` gauge with the pair as the
    ``family``/``link`` labels.
    """

    device: Device
    values: Mapping[str, float]
    ici_counters: Mapping[str, int] = dataclasses.field(default_factory=dict)
    collective_ops: int | None = None
    raw_values: Mapping[tuple[str, str], float] = dataclasses.field(
        default_factory=dict)
    # Persistent-degradation marker (resilience.py): the runtime side of
    # this sample is known-down (its circuit breaker is open), so what's
    # here is environment-only. The poll loop flips accelerator_up to 0
    # and labels the surviving gauges stale="true" instead of letting
    # the chip look merely "runtime-metrics-free".
    stale: bool = False


class CollectorError(RuntimeError):
    """A sample failed; the poll loop marks the device down (never
    crashes)."""


class Collector(abc.ABC):
    """L0 trait: ``discover() -> [Device]``, ``sample(Device) -> Sample``."""

    name: str = "abstract"

    @abc.abstractmethod
    def discover(self) -> Sequence[Device]:
        """Enumerate local devices. Called at startup and on rediscovery —
        never on the poll hot path."""

    def begin_tick(self) -> None:
        """Called once by the poll loop before the per-device fan-out of a
        tick. Backends take their tick-scoped view here so ``sample``
        stays a lookup (the embedded collector takes one read of the
        workload's counters); per-device backends ignore it. Errors must
        be swallowed and surfaced per-device from ``sample``."""

    @abc.abstractmethod
    def sample(self, device: Device) -> Sample:
        """Read one device's current counters. Hot path: must be fast and
        must raise CollectorError (not crash) on backend failure."""

    def close(self) -> None:  # pragma: no cover - trivial default
        pass
