"""The port's fleet sim against the reference's ``tools/fleet_sim.py``,
scenario by scenario at the same parameters.

- straggler (3 nodes, 8 refreshes, 0.8 s): both name node 0, the
  reference with its runtime fetch's phase, the port with its NVML
  read's;
- link (a ring of 4, node 1's and node 2's link slowed to 10% with NIC
  drops): the reference names link 1-2 and accuses no node; on H100
  cards no link label maps to an edge, so the port suspects no link,
  accuses no node either, and its doctor names exactly those two
  endpoints as an interconnect slowdown it cannot localize;
- waste (3 nodes, ``train-1`` idle): both name that pod alone as an idle
  reservation from the signed attestation, refuse a wrong key, clear the
  verdict with a journal event and name it again with ``--at``. The
  port's pods come from a kubelet checkpoint, which carries no
  namespace.

The straggler's seconds and the link episode's z-scores are printed.
Where the reference's run fails on a loaded host (its link's rates or a
node's latency lost in the noise), its output is printed and the port is
held to the scenario's own figures: node 0, link 1-2, ``train-1``.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import re
import sys

import pytest

from kube_gpu_stats_tpu_torch.sims import fleet

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import fleet_sim  # noqa: E402  (the reference's scenarios)

pytestmark = pytest.mark.chaos


def _reference(fn, *args) -> str | None:
    """The reference scenario's output, or None where it failed: on a
    loaded host its verdicts can miss (a link's rates or a node's
    latency read through the noise), and the port is then held to the
    scenario's own figures instead."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, verbose=True)
    text = out.getvalue()
    print(text)
    return text if rc == 0 else None


def test_straggler_as_the_reference():
    text = _reference(fleet_sim.run, 3, 8, 0.8)
    if text is not None:
        phase = re.search(r"named the straggler \(\S+, phase (\w+)",
                          text).group(1)
        assert phase in ("fetch_wait", "rpc_port")
    port = fleet.run_straggler(3, 8, 0.8)
    print(port.report("straggler"))
    assert port.problems == []
    assert port.figures == {"straggler_named": True, "phase_is_read": True,
                            "gauge_names_straggler": True}


def test_link_on_h100_names_the_reference_link_endpoints():
    text = _reference(fleet_sim.run_link, 4)
    link = ("1", "2")  # the scenario's degraded link
    if text is not None:
        link = re.search(r"named ICI link (\d+)-(\d+) .*accused zero "
                         r"nodes", text).groups()
    port = fleet.run_link(4)
    print(port.report("link"))
    assert port.problems == []
    fig = port.figures
    assert (fig["links_suspected"], fig["suspect_gauges"], fig["at_links"],
            fig["warmup_suspects"], fig["after_suspects"]) == (0,) * 5
    assert fig["accused_nodes"] == 0
    assert fig["slowdown_nodes"] == sorted(map(int, link)) == [1, 2]


def test_waste_as_the_reference():
    text = _reference(fleet_sim.run_waste, 3)
    pod = "train-1"  # the scenario's idle pod
    if text is not None:
        namespace, pod = re.search(
            r"named (\w*)/([\w-]+) \(idle-reservation, signed attestation "
            r"verified, wrong key FAILed\), zero false accusations",
            text).groups()
        assert namespace == "ml"
    port = fleet.run_waste(3)
    print(port.report("waste"))
    assert port.problems == []
    fig = port.figures
    assert (fig["pod"], fig["reason"], fig["innocents"],
            fig["top_waste"]) == (pod, "idle-reservation", 0, [pod])
    assert fig["signature_verified"] and fig["wrong_key"] == "fail"
    assert fig["gauge_names_pod"] and fig["chips_ranked"]
    assert fig["cleared"] and fig["journaled"] and fig["at_names_pod"]
    assert fig["warmup_suspects"] == 0
