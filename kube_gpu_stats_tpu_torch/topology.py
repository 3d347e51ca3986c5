"""Slice/worker topology labels.

Every per-device series carries ``slice``, ``worker`` and ``topology``
(empty strings when unknown, so series identity stays stable). On an H100
node they come only from the explicit ``KTS_SLICE``, ``KTS_WORKER`` and
``KTS_TOPOLOGY`` environment variables: the reference's other sources (the
GKE TPU environment and the GCE metadata server) describe TPU slices.
"""

from __future__ import annotations

import os
from typing import Mapping


def topology_labels(environ: Mapping[str, str] | None = None) -> dict[str, str]:
    env = os.environ if environ is None else environ
    return {"slice": env.get("KTS_SLICE", ""),
            "worker": env.get("KTS_WORKER", ""),
            "topology": env.get("KTS_TOPOLOGY", "")}
