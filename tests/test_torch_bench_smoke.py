"""The tables ``chip_smoke.py``'s ``bench`` phase holds the card's figures
to, held against the reference on the CPU.

On the card the phase runs the port's measurements at the reference's
defaults (``BENCH_MEASUREMENTS``) and requires the figures that do not depend on
the host's speed to equal ``BENCH_EXACT`` and ``PROFILE_INGEST_EXACT``
exactly. Here the reference computes them at the same arguments; the
port's equality to the reference at small arguments is
``tests/test_torch_bench.py``'s. Every measurement of the port's module
is in the phase.

Each test that starts a hub has its own time limit.
"""

from __future__ import annotations

import contextlib
import signal

import pytest

import chip_smoke
from kube_gpu_stats_tpu import bench as ref_bench
from kube_gpu_stats_tpu import profiler as ref_profiler
from kube_gpu_stats_tpu_torch import bench


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the test, rather than hang the run, when it outlasts
    ``seconds`` (SIGALRM on the main thread)."""
    def expired(*_):
        raise TimeoutError(f"test exceeded its {seconds:g} s limit")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.mark.parametrize("name", sorted(chip_smoke.BENCH_EXACT))
def test_the_smokes_exact_figures_are_the_references(name):
    with time_limit(120):
        want = getattr(ref_bench, name)()
    assert want is not None
    assert set(want) == set(chip_smoke.BENCH_KEYS[name])
    exact = chip_smoke.BENCH_EXACT[name]
    assert {key: want[key] for key in exact} == exact


def test_the_smokes_profile_ingest_counts_are_the_references():
    with time_limit(120):
        _report, summary = ref_profiler.profile_ingest(
            **chip_smoke.PROFILE_INGEST_ARGS)
    assert summary["ingest"] == chip_smoke.PROFILE_INGEST_EXACT


def test_every_measurement_of_the_module_runs_in_the_phase():
    names = {name for name in dir(bench) if name.startswith("measure_")}
    names.discard("measure_collector")  # the harnesses' inner loop
    assert sorted(chip_smoke.BENCH_MEASUREMENTS) == sorted(names) == \
        sorted(chip_smoke.BENCH_KEYS)
