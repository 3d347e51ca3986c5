"""Device-plugin checkpoint-file allocation source — the fallback when the
PodResources socket isn't mounted.

The kubelet persists device-plugin allocations in
``/var/lib/kubelet/device-plugins/kubelet_internal_checkpoint`` as JSON:

    {"Data": {"PodDeviceEntries": [
        {"PodUID": "...", "ContainerName": "...",
         "ResourceName": "nvidia.com/gpu",
         "DeviceIDs": {"-1": ["GPU-…"]}},   # NUMA-keyed since 1.20
        ...], "RegisteredDevices": {...}}, "Checksum": ...}

Limitation vs PodResources: only the pod *UID* is recorded, so the ``pod``
label carries the UID and ``namespace`` is empty. Pure stdlib.
"""

from __future__ import annotations

import json
from pathlib import Path

from . import RESOURCE_NAMES, Labels, index_allocations


class CheckpointSource:
    def __init__(self, path: str) -> None:
        self._path = Path(path)

    def fetch(self) -> dict[str, Labels]:
        doc = json.loads(self._path.read_text())
        entries = (doc.get("Data") or {}).get("PodDeviceEntries") or []
        allocations: list[tuple[str, Labels]] = []
        for entry in entries:
            if entry.get("ResourceName") not in RESOURCE_NAMES:
                continue
            labels = {
                "pod": entry.get("PodUID", ""),
                "namespace": "",
                "container": entry.get("ContainerName", ""),
            }
            raw_ids = entry.get("DeviceIDs")
            if isinstance(raw_ids, dict):  # NUMA-node keyed (k8s >= 1.20)
                ids = [i for sub in raw_ids.values() for i in (sub or [])]
            else:  # flat list (older kubelets)
                ids = list(raw_ids or [])
            for device_id in ids:
                allocations.append((device_id, labels))
        return index_allocations(allocations)

    def fetch_allocatable(self) -> dict[str, int]:
        """RegisteredDevices from the checkpoint file (best-effort analog of
        GetAllocatableResources)."""
        doc = json.loads(self._path.read_text())
        registered = (doc.get("Data") or {}).get("RegisteredDevices") or {}
        return {
            resource: len(ids or [])
            for resource, ids in registered.items()
            if resource in RESOURCE_NAMES
        }

    def close(self) -> None:
        pass
