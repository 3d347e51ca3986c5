"""The port's partition sim against the reference's
``tools/partition_sim.py``.

Each scenario runs on both sides at the same parameters: the port's over
NVML daemons, its publishers, spill queues, hub and durable writer, the
reference's over its TPU daemons and the same. Asserted are the figures
the scenario fixes and that they equal the reference's: nothing lost or
dropped inside the bounds and no resync through the hub blackout; the
frames a bound drops and the frames it delivers (the synthetic snapshots
carry the reference's labels, so the spool's and the WAL's bytes are the
reference's); the drain's backlog, its cap and its one session FULL; the
requests delivered exactly once. The spooled counts, FULLs re-establishing
a session and the drain's achieved rate depend on the host's timing and
are printed. No check of the reference pins the host's speed: its drain
checks bound the rate from above, which a slow host cannot break. The
port's TSDB receiver is ``testing/egress_sink.py`` (the reference's sim
has its own ``FakeTsdb``), its outages closing the listener as the
reference's do.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import re
import sys

import pytest

import chip_smoke
from kube_gpu_stats_tpu_torch.sims import partition

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import partition_sim  # noqa: E402  (the reference's scenarios)

pytestmark = pytest.mark.chaos


def _as_the_smoke(sim: str, prefix: str, fig: dict) -> None:
    """The figures ``chip_smoke.py``'s ``sims`` phase requires of this
    scenario on the card's host are the ones the port gave here."""
    want = {key[len(prefix):]: value
            for key, value in chip_smoke.SIMS_EXACT[sim].items()
            if key.startswith(prefix)}
    assert want and {key: fig.get(key) for key in want} == want


def _reference(fn, *args) -> tuple[list[str], str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        problems = fn(*args, verbose=True)
    print(out.getvalue())
    return problems, out.getvalue()


def _port(fn, *args):
    result = fn(*args)
    print(result.report(result.name))
    return result


def _dirs(tmp_path) -> tuple[str, str]:
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
    return str(tmp_path / "ref"), str(tmp_path / "port")


def test_hub_blackout_as_the_reference(tmp_path):
    ref_dir, port_dir = _dirs(tmp_path)
    ref_problems, out = _reference(partition_sim.scenario_hub_blackout,
                                   ref_dir, 2)
    daemons = int(re.search(r"across (\d+) daemons, drained to 0, \d+ "
                            r"session FULLs, 0 resyncs, 0 dropped",
                            out).group(1))
    port = _port(partition.scenario_hub_blackout, port_dir, 2)
    assert ref_problems == [] and port.problems == []
    fig = port.figures
    assert fig["daemons"] == daemons == 2
    assert (fig["dropped"], fig["lost"], fig["resyncs"]) == (0, 0, 0)
    assert fig["drained_to_zero"] and fig["live_resumed"]
    assert not fig["full_amplification"] and fig["journaled"]
    _as_the_smoke("partition", "blackout.", fig)


def test_beyond_bounds_as_the_reference(tmp_path):
    ref_dir, port_dir = _dirs(tmp_path)
    ref_problems, out = _reference(partition_sim.scenario_beyond_bounds,
                                   ref_dir)
    dropped, frames, drained = map(int, re.search(
        r"beyond bounds: (\d+)/(\d+) dropped oldest-first, (\d+) "
        r"delivered", out).groups())
    port = _port(partition.scenario_beyond_bounds, port_dir)
    assert ref_problems == [] and port.problems == []
    fig = port.figures
    assert (fig["dropped"], fig["frames"], fig["drained"]) \
        == (dropped, frames, drained)
    assert dropped + drained == frames == 401 and dropped > 0
    assert fig["oldest_first"] and fig["journaled"] and fig["left"] == 0
    assert fig["accounting_closes"] and fig["status_agrees"]
    _as_the_smoke("partition", "bounds.", fig)


def test_drain_rate_and_shed_as_the_reference(tmp_path):
    ref_dir, port_dir = _dirs(tmp_path)
    ref_problems, out = _reference(
        partition_sim.scenario_drain_rate_and_shed, ref_dir)
    backlog, rate = re.search(r"drain rate: (\d+) frames in \S+s \(\d+/s "
                              r"vs (\S+)/s configured\)", out).groups()
    fulls = int(re.search(r"shed honoring: \d+ shed\(s\) deferred, (\d+) "
                          r"FULL total, 0 resyncs", out).group(1))
    port = _port(partition.scenario_drain_rate_and_shed, port_dir)
    assert ref_problems == [] and port.problems == []
    fig = port.figures
    assert (fig["backlog"], fig["rate_cap"]) == (int(backlog), float(rate))
    assert fig["undrained"] == 0
    assert not fig["over_rate"] and not fig["faster_than_knob"]
    assert fig["shed_honoured"]
    assert (fig["fulls_under_shed"], fig["fulls"], fig["resyncs"],
            fig["stuck"]) == (fulls, fulls, 0, 0) == (1, 1, 0, 0)
    _as_the_smoke("partition", "drain.", fig)


def test_tsdb_blackout_as_the_reference(tmp_path):
    ref_dir, port_dir = _dirs(tmp_path)
    ref_problems, out = _reference(partition_sim.scenario_tsdb_blackout,
                                   ref_dir)
    requests = int(re.search(r"tsdb flap\+slow: (\d+) requests "
                             r"exactly-once", out).group(1))
    dropped, snapshots, survivors = map(int, re.search(
        r"tsdb beyond bounds: (\d+)/(\d+) dropped oldest-first .*?, "
        r"(\d+) survivors delivered", out).groups())
    port = _port(partition.scenario_tsdb_blackout, port_dir)
    assert ref_problems == [] and port.problems == []
    fig = port.figures
    assert fig["requests"] == fig["expected"] == requests == 21
    assert (fig["backlog"], fig["dropped_in_bounds"], fig["empty_cycles"],
            fig["stuck_cycles"]) == (0, 0, 0, 0)
    assert fig["in_order"] and fig["lag_metered"]
    assert (fig["bounds_dropped"], fig["bounds_snapshots"],
            fig["bounds_delivered"]) == (dropped, snapshots, survivors)
    assert dropped + survivors == snapshots == 120 and dropped > 0
    assert fig["bounds_journaled"] and fig["bounds_oldest_first"]
    assert fig["bounds_stuck"] == 0
    _as_the_smoke("partition", "tsdb.", fig)
