"""Pod<->device attribution for the daemon.

The port's copy of the reference's attribution cache. The allocation
source is the NVIDIA device plugin (resource ``nvidia.com/gpu``), read
through either:

- :mod:`.podresources` — kubelet PodResources v1 ``List()`` over the unix
  socket (pod name + namespace + container), or
- :mod:`.checkpoint` — the kubelet device-plugin checkpoint file (fallback
  for clusters where the PodResources socket isn't mounted; pod *UID*
  only).

Both feed :class:`CachedAttribution`: a background refresher on its own
cadence maintaining an immutable device-key -> labels dict, so the poll
loop's ``lookup`` is a pure dict probe — the hot path never crosses a
process boundary.

Device-key matching: the NVIDIA device plugin names devices by UUID
(``GPU-…``, its default) or by index, so a refresh indexes every id under
several normalized candidate keys and ``lookup`` probes the device's own
candidates (device id, UUID, device path, index) in order.
"""

from __future__ import annotations

import logging
from typing import Mapping, Protocol

from ..collectors import Device
from ..resilience import CLOSED
from ..workers import PeriodicRefresher

log = logging.getLogger(__name__)

# Resource classes attributed: the NVIDIA device plugin's.
GPU_RESOURCE = "nvidia.com/gpu"
RESOURCE_NAMES = (GPU_RESOURCE,)

Labels = Mapping[str, str]


def candidate_keys(device_id: str) -> list[str]:
    """Normalized index keys for one allocation-side device id."""
    keys = [device_id]
    if device_id.startswith("/dev/"):
        keys.append(device_id[len("/dev/"):])
    if device_id.startswith("accel"):
        suffix = device_id[len("accel"):]
        if suffix.isdigit():
            keys.append(suffix)
    # "4-7" style range ids expand to each index.
    if "-" in device_id:
        lo, _, hi = device_id.partition("-")
        if lo.isdigit() and hi.isdigit() and int(lo) <= int(hi) <= int(lo) + 512:
            keys.extend(str(i) for i in range(int(lo), int(hi) + 1))
    return keys


def device_probe_keys(device: Device) -> list[str]:
    """Keys a local device answers to, in match-priority order."""
    keys = [device.device_id]
    if device.uuid:
        keys.append(device.uuid)
    keys.append(device.device_path)
    if device.device_path.startswith("/dev/"):
        keys.append(device.device_path[len("/dev/"):])
    keys.append(str(device.index))
    seen: set[str] = set()
    return [k for k in keys if k and not (k in seen or seen.add(k))]


class AllocationSource(Protocol):
    """One refresh: returns device-key -> {"pod","namespace","container"}."""

    def fetch(self) -> dict[str, Labels]: ...

    def close(self) -> None: ...


def index_allocations(
    allocations: list[tuple[str, Labels]]
) -> dict[str, Labels]:
    """Expand (device_id, labels) pairs into the candidate-key index."""
    table: dict[str, Labels] = {}
    for device_id, labels in allocations:
        for key in candidate_keys(device_id):
            table.setdefault(key, labels)
    return table


class CachedAttribution(PeriodicRefresher):
    """Background-refreshed map; RPC-free lookups (off the hot path).

    On refresh failure the previous map is retained and a warning logged —
    stale attribution beats a crash-looping DaemonSet.
    Once the failure is persistent — the source's kubelet circuit
    breaker is open, or ``_STALE_AFTER`` consecutive refreshes failed —
    :attr:`stale` turns True and the poll loop labels the served
    (last-good) mapping ``stale="true"`` so dashboards can tell cached
    truth from live truth."""

    _STALE_AFTER = 3

    def __init__(self, source: AllocationSource,
                 refresh_interval: float = 10.0) -> None:
        super().__init__(refresh_interval, thread_name="attribution-refresh")
        self._source = source
        self._map: dict[str, Labels] = {}
        self._allocatable: dict[str, int] = {}

    @property
    def breaker(self):
        """The source's kubelet circuit breaker, when it has one (None
        for checkpoint-only sources, or auto mode before the
        PodResources client exists)."""
        return getattr(self._source, "breaker", None)

    @property
    def stale(self) -> bool:
        """True when lookups serve a retained last-good mapping under a
        persistent source outage (never True before any map exists —
        empty lookups aren't stale, they're empty). A succeeding
        refresh is never stale, whatever the kubelet breaker says:
        auto mode's checkpoint fallback serves FRESH (UID-labeled) data
        while the PodResources socket is still down."""
        if not self._map or self.consecutive_failures == 0:
            return False
        breaker = self.breaker
        if breaker is not None and breaker.state != CLOSED:
            return True
        return self.consecutive_failures >= self._STALE_AFTER

    def refresh_once(self) -> None:
        try:
            self._map = self._source.fetch()
            self.consecutive_failures = 0
        except Exception as exc:
            self.consecutive_failures += 1
            log.warning("attribution refresh failed (%d consecutive): %s",
                        self.consecutive_failures, exc)
            return
        # Allocatable counts are an optional cross-check (kubelet >= 1.23);
        # their failure must not fail the attribution refresh.
        fetch_allocatable = getattr(self._source, "fetch_allocatable", None)
        if fetch_allocatable is not None:
            try:
                self._allocatable = fetch_allocatable()
            except Exception as exc:
                log.debug("allocatable fetch unavailable: %s", exc)

    def allocatable(self) -> Mapping[str, int]:
        """Per-resource allocatable device counts from the last successful
        refresh (empty until one lands)."""
        return self._allocatable

    def lookup(self, device: Device) -> Labels:
        table = self._map
        for key in device_probe_keys(device):
            labels = table.get(key)
            if labels is not None:
                return labels
        return {}

    def stop(self) -> None:
        super().stop()
        self._source.close()


class AutoSource:
    """auto mode: prefer the richer PodResources API, re-probing the socket
    on every refresh — a kubelet that (re)starts after the exporter must be
    picked up without a pod restart. Falls back to the checkpoint file —
    with hysteresis once PodResources has succeeded: the checkpoint labels
    pods by UID while PodResources labels them by name, so flip-flopping on
    a kubelet blip would churn every series' label identity. After the
    first PodResources success, a failure (RPC error or vanished socket)
    raises — CachedAttribution keeps the last-good name-labeled map — and
    only ``_FALLBACK_AFTER`` consecutive failures switch to the checkpoint
    (kubelet genuinely gone beats frozen stale names eventually)."""

    _FALLBACK_AFTER = 3

    def __init__(self, kubelet_socket: str, checkpoint_path: str) -> None:
        self._socket_path = kubelet_socket
        self._podresources = None
        self._podresources_ever_ok = False
        self._pr_failures = 0  # consecutive, counted only after first success
        # Set by fetch() when this cycle was served by the checkpoint, so
        # fetch_allocatable (called right after) goes straight there
        # instead of paying the PodResources rpc deadline a second time.
        self._cycle_used_checkpoint = False
        from .checkpoint import CheckpointSource

        self._checkpoint = CheckpointSource(checkpoint_path)

    @property
    def breaker(self):
        """The PodResources client's kubelet breaker once that client
        exists (lazy — auto mode may never create it)."""
        return (self._podresources.breaker
                if self._podresources is not None else None)

    def _active(self) -> AllocationSource:
        import os

        if os.path.exists(self._socket_path):
            if self._podresources is None:
                from .podresources import PodResourcesSource

                self._podresources = PodResourcesSource(self._socket_path)
            return self._podresources
        return self._checkpoint

    def fetch(self) -> dict[str, Labels]:
        # A crashed kubelet leaves its socket file behind (unix sockets are
        # not unlinked on crash), so existence alone can't gate the choice:
        # fall back to the checkpoint when the live fetch fails too.
        source = self._active()
        self._cycle_used_checkpoint = source is self._checkpoint
        if source is self._checkpoint and self._podresources_ever_ok:
            # Socket vanished after PodResources was healthy: hysteresis
            # (see class docstring) before remapping names to UIDs.
            self._pr_failures += 1
            if self._pr_failures < self._FALLBACK_AFTER:
                raise RuntimeError(
                    f"podresources socket vanished; keeping last-good map "
                    f"({self._pr_failures}/{self._FALLBACK_AFTER} before "
                    f"checkpoint fallback)")
            return self._checkpoint.fetch()
        try:
            result = source.fetch()
        except Exception:
            if source is self._checkpoint:
                raise
            if self._podresources_ever_ok:
                self._pr_failures += 1
                if self._pr_failures < self._FALLBACK_AFTER:
                    raise
            self._cycle_used_checkpoint = True
            return self._checkpoint.fetch()
        if source is not self._checkpoint:
            self._podresources_ever_ok = True
            self._pr_failures = 0
        return result

    def fetch_allocatable(self) -> dict[str, int]:
        if self._cycle_used_checkpoint:
            return self._checkpoint.fetch_allocatable()
        source = self._active()
        try:
            return source.fetch_allocatable()
        except Exception:
            if source is not self._checkpoint and not self._podresources_ever_ok:
                return self._checkpoint.fetch_allocatable()
            raise

    def close(self) -> None:
        if self._podresources is not None:
            self._podresources.close()
        self._checkpoint.close()


def build(mode: str, kubelet_socket: str, checkpoint_path: str,
          refresh_interval: float) -> CachedAttribution:
    """Factory for daemon.build_attribution. mode: auto|podresources|checkpoint.
    Imports are per-mode: the checkpoint path is pure stdlib and must work
    on grpcio-less installs without dragging the PodResources module in."""
    source: AllocationSource
    if mode == "podresources":
        from .podresources import PodResourcesSource

        source = PodResourcesSource(kubelet_socket)
    elif mode == "checkpoint":
        from .checkpoint import CheckpointSource

        source = CheckpointSource(checkpoint_path)
    else:
        source = AutoSource(kubelet_socket, checkpoint_path)
    return CachedAttribution(source, refresh_interval)
