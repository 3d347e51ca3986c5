"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration's file is the one its ``configs`` entry gives; the traffic
mix is ``h100bench/traffic/<traffic>.json``; each metric's reader is
``h100bench/metrics/<name>.py``; a configuration's ``driver`` is the module
``h100bench/drivers/<driver>.py``. A later change adds files and entries
and edits none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class ManifestError(ValueError):
    """BENCHMARK.json or a file it names is missing or malformed."""


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load(path: Path) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise ManifestError(f"cannot read {path}: {exc}") from exc


def reports(metric: dict, cell: str) -> bool:
    """True when ``metric`` is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(manifest: dict, root: Path, cell_name: str) -> Cell:
    """The cell ``cell_name`` with its configuration, traffic and metrics."""
    cells = {c["name"]: c for c in manifest.get("workloads", [])}
    if cell_name not in cells:
        raise ManifestError(f"no workload {cell_name!r}; known: {sorted(cells)}")
    entry = cells[cell_name]
    configs = {c["name"]: c for c in manifest.get("configs", [])}
    if entry["config"] not in configs:
        raise ManifestError(f"workload {cell_name} names unknown config "
                            f"{entry['config']!r}")
    config = load(root / configs[entry["config"]]["file"])
    traffic = load(HARNESS / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=cell_name, config=config, traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, cell_name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, cell_name)])


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``h100bench/metrics/<name>.py``."""
    path = HARNESS / "metrics" / f"{metric_name}.py"
    if not path.is_file():
        raise ManifestError(f"no reader for metric {metric_name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{metric_name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    """The module ``h100bench.drivers.<kind>``."""
    if not NAME.fullmatch(kind) or not (HARNESS / "drivers" / f"{kind}.py").is_file():
        raise ManifestError(f"no driver {kind!r}")
    return importlib.import_module(f"h100bench.drivers.{kind}")
