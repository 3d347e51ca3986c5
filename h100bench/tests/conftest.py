"""Shared fixtures: the benchmark's cells cut to a CPU-sized job."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench import run  # noqa: E402
from h100bench.core import manifest  # noqa: E402


# The CPU cells scrape this many times as often as the chip's.
SPEEDUP = 15


@pytest.fixture
def bench():
    return manifest.load(ROOT / "BENCHMARK.json")


@pytest.fixture
def cpu_cell(bench):
    """A cell of the benchmark with its job cut to ``size`` on the CPU,
    its scrapers' periods cut by ``speedup`` (``SPEEDUP`` unless told) so a
    window of seconds holds scrapes, labels as the CPU serves them, and the daemon over the mock
    backend."""

    def make(name: str, size: int = 256, speedup: float = SPEEDUP):
        cell = manifest.resolve(bench, ROOT, name)
        traffic = dict(
            cell.traffic, job=dict(cell.traffic["job"], size=size),
            scrapers=[dict(s, period_s=s["period_s"] / speedup)
                      for s in cell.traffic["scrapers"]])
        config = dict(cell.config, card_labels=dict(
            cell.config["card_labels"], accel_type="cpu"))
        if "daemon_args" in config:
            config["daemon_args"] = ["--backend", "mock", "--mock-devices", "1"]
            config["card_labels"] = {"chip": "0"}
        return dataclasses.replace(cell, traffic=traffic, config=config)

    return make


@pytest.fixture
def measure_cpu():
    """``run.measure`` on the CPU, the chip check skipped."""

    def go(cell, seconds: float = 3.0, trace: bool = False, seed: int = 2**31 + 7):
        return run.measure(cell, 1, seed, seconds, trace, "cpu", "cpu", None,
                           run.T_START)

    return go


@pytest.fixture
def card():
    """The CUDA card's name; skips the test where there is none."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
