"""The port's chaos sim against the reference's ``tools/chaos_sim.py``.

Each scenario runs on both sides at the same parameters, in process and
through 2 acceptor processes: the port's over NVML daemons and its hub,
the reference's over its TPU daemons and hub. Asserted are the figures
the scenario fixes (sessions resumed and FULLs forced, sessions alive
and served, frames answered, recovery FULLs admitted, lorises cut, the
frame that tripped the quarantine) and that they equal the reference's.
Host timings are printed, not asserted: whether the stampede outran the
lanes' refill, the recovery time, the waves' latency.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import re
import sys

import pytest

from kube_gpu_stats_tpu_torch.sims import chaos

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import chaos_sim  # noqa: E402  (the reference's scenarios)

pytestmark = pytest.mark.chaos

SESSIONS = 64
# The reference's checks that pin host speed: a shed that only a host
# fast enough to outrun the lanes' refill sees (the port holds the
# buckets' arithmetic instead), and its recovery and wave-latency pins.
HOST_SPEED = ("stampede: the guard never shed", "warm: recovery took",
              "hostile: healthy wave took")


def _reference(fn, *args, **kw) -> tuple[list[str], str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        problems = fn(*args, verbose=True, **kw)
    print(out.getvalue())
    return [p for p in problems if not p.startswith(HOST_SPEED)], \
        out.getvalue()


def _show(result) -> None:
    print(result.report(result.name))


@pytest.mark.parametrize("procs", [0, 2])
def test_warm_restart_as_the_reference(tmp_path, procs):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_problems, out = _reference(chaos_sim.scenario_warm_restart,
                                   str(tmp_path / "ref"), 2, SESSIONS,
                                   procs=procs)
    resumed, sessions, fulls = map(int, re.search(
        r"warm restart: (\d+)/(\d+) resumed, (\d+) FULL", out).groups())
    port = chaos.scenario_warm_restart(str(tmp_path / "port"), 2, SESSIONS,
                                       procs=procs)
    _show(port)
    assert ref_problems == [] and port.problems == []
    assert (port.figures["resumed"], port.figures["sessions"],
            port.figures["full_resyncs"]) == (resumed, sessions, fulls) \
        == (SESSIONS, SESSIONS, 0)
    assert port.figures["dropped"] == 0 and port.figures["ready"]


@pytest.mark.parametrize("procs", [0, 2])
def test_stampede_as_the_reference(procs):
    ref_problems, out = _reference(chaos_sim.scenario_stampede,
                                   procs=procs)
    landed, shed, alive, n = map(int, re.search(
        r"stampede: (\d+) landed, (\d+) shed with 429, (\d+)/(\d+) "
        r"sessions alive", out).groups())
    port = chaos.scenario_stampede(procs)
    _show(port)
    assert ref_problems == [] and port.problems == []
    fig = port.figures
    assert (fig["answered"], fig["alive"], fig["sessions"]) \
        == (landed + shed, alive, n) == (4 * 128, 128, 128)
    assert fig["fence"] == (503, True)
    assert fig["non_shed_failures"] == 0
    assert fig["recovery_admitted"] == 4 and fig["served"] == 128


@pytest.mark.parametrize("procs", [0, 2])
def test_hostile_frames_as_the_reference(procs):
    ref_problems, out = _reference(chaos_sim.scenario_hostile, procs=procs)
    cut, quarantined_at = re.search(
        r"hostile: (\d+)/5 lorises cut, evil source quarantined after "
        r"(\S+) bad frames", out).groups()
    port = chaos.scenario_hostile(procs)
    _show(port)
    assert ref_problems == [] and port.problems == []
    fig = port.figures
    assert (fig["lorises_cut"], str(fig["quarantined_at"])) \
        == (int(cut), quarantined_at) == (5, "5")
    assert fig["healthy_failed"] == 0
    assert fig["quarantine_rose"] and fig["journaled"]
