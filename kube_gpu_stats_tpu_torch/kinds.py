"""Device kinds: the ``accel_type`` label and the per-kind datasheet tables.

Shared by the embedded collector and the NVML backend, so both name an
H100 ``gpu-h100``. Imports no torch: the daemon path (NVML backend, poll
loop, exposition) must run where no CUDA userspace but NVML is present.
"""

from __future__ import annotations

import re

# Device memory per card by device-name substring. Checked in order — more
# specific spellings first ("h100 nvl" and "h100 pcie" before the bare
# "h100", which the SXM part's name "NVIDIA H100 80GB HBM3" matches).
# Unknown kinds return None — partial data, never a guess. Each row cites
# the public spec it came from.
_HBM_BY_KIND: tuple[tuple[str, int], ...] = (
    # H100 NVL: 94 GB HBM3 — NVIDIA H100 Tensor Core GPU datasheet
    ("h100 nvl", 94 * 1024**3),
    # H100 PCIe: 80 GB HBM2e — same datasheet
    ("h100 pcie", 80 * 1024**3),
    # H100 SXM: 80 GB HBM3 — same datasheet
    ("h100", 80 * 1024**3),
)


# Peak dense (no sparsity) bf16 tensor-core FLOP/s per card, same match
# discipline. The MFU denominator; each row cites the public spec.
_PEAK_FLOPS_BY_KIND: tuple[tuple[str, float], ...] = (
    # H100 NVL: 835 TFLOPS bf16 dense — NVIDIA H100 datasheet
    ("h100 nvl", 835e12),
    # H100 PCIe: 756 TFLOPS bf16 dense — same datasheet
    ("h100 pcie", 756e12),
    # H100 SXM: 989 TFLOPS bf16 dense — same datasheet
    ("h100", 989e12),
)


def _kind_lookup(table, device_kind: str):
    """First-match substring lookup over a per-device-kind table."""
    lowered = device_kind.lower()
    for needle, value in table:
        if needle in lowered:
            return value
    return None


def _kind_capacity(device_kind: str) -> int | None:
    return _kind_lookup(_HBM_BY_KIND, device_kind)


def _kind_peak_flops(device_kind: str) -> float | None:
    return _kind_lookup(_PEAK_FLOPS_BY_KIND, device_kind)


_MODEL_TOKEN = re.compile(r"[A-Za-z]+\d+[A-Za-z]*")


def accel_type(name: str) -> str:
    """The ``accel_type`` label for a device's product name
    (``docs/UNIFIED_SCHEMA.md``: the normalized NVML product name):
    ``"NVIDIA H100 80GB HBM3"`` → ``"gpu-h100"``, ``"NVIDIA A100-SXM4-80GB"``
    → ``"gpu-a100"``. The first token of letters then digits is the model;
    a name without one keeps all its words (``"NVIDIA GeForce RTX 4090"``
    → ``"gpu-geforce-rtx-4090"``). ``"cpu"`` stays ``"cpu"``."""
    if name.lower() == "cpu":
        return "cpu"
    tokens = [t for t in re.split(r"[\s\-_]+", name)
              if t and t.lower() != "nvidia"]
    for token in tokens:
        if _MODEL_TOKEN.fullmatch(token):
            return "gpu-" + token.lower()
    return "-".join(["gpu"] + [t.lower() for t in tokens])
