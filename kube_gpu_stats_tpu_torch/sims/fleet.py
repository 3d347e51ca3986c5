"""The fleet lens's verdicts over real NVML daemons and a hub.

The port of the reference's ``tools/fleet_sim.py``: N real daemons (over
``testing.fake_nvml``, pods from a kubelet checkpoint) and one hub
scraping them, through three scenarios:

- **straggler**: each NVML ``utilization`` read of node 0 stalls
  ``delay`` seconds; the fleet lens attributes the slowness to that node
  and its read phase, end to end through the daemons' flight-recorder
  digests, the hub's ``/debug/fleet`` and ``doctor --fleet``;
- **link**: the NVLink traffic of two healthy nodes' cards slows to 10%
  on one link each, with NIC drops rising on both hosts. On an H100
  fleet no link label maps to a torus edge (NVML's ``nvlink<N>`` are a
  card's links to the NVSwitches), so the lens suspects no link, during
  the episode, after it, or in ``--at`` (the known limit
  ``tests/test_torch_linkloc.py`` pins). As in the reference, no node
  is accused: ``doctor --fleet`` names the two nodes whose links slowed
  as an interconnect slowdown it cannot localize, and only them. The
  reference's TPU ring names the shared link and accuses no node;
- **waste**: one pod keeps its cards at 0% utilization while holding
  them. ``doctor --efficiency`` names that pod, and only it, out of the
  hub's signed attestation, refuses a wrong key, the top-K ranking
  exports it, the verdict clears with a ``fleet_waste_cleared`` journal
  event once the pod works again, and ``--at`` names it after the clear.
"""

from __future__ import annotations

import pathlib
import tempfile
import time

from ._common import Result, nvml_daemon
from .host import READ_PHASES

NVLINK_KIB_PER_S = 4_000_000.0  # each healthy link's TX and RX


class _Fleet:
    """N NVML daemons and one hub over them."""

    def __init__(self, tmp: str, nodes: int, prefix: str, hub_kw=None,
                 server_kw=None, daemon_kw=None, straggler_delay=0.0,
                 topology: str = ""):
        """``server_kw(hub)``: the hub server's extra providers;
        ``daemon_kw(root)``: a node's extra daemon settings."""
        from ..exposition import MetricsServer
        from ..hub import Hub

        self.daemons: list = []
        self.fakes: list = []
        self.targets: list[str] = []
        self.roots: list[pathlib.Path] = []
        self.hub = self.server = None
        for node in range(nodes):
            root = pathlib.Path(tmp) / f"{prefix}{node}"
            self.roots.append(root)
            daemon, fake, faults = nvml_daemon(
                root, node, topology=topology,
                pods={f"train-{node}": [0, 1]},
                attribution_interval=0.5, pipeline_fetch=False,
                **(daemon_kw(root) if daemon_kw else {}))
            if node == 0 and straggler_delay:
                faults.stalls = {
                    card: {"utilization": (straggler_delay, 1)}
                    for card in range(len(fake.devices))}
            self.fakes.append(fake)
            daemon.start()
            self.daemons.append(daemon)
            self.targets.append(
                f"http://127.0.0.1:{daemon.server.port}/metrics")
        # Every daemon's first publish first: a hub refresh against a
        # half-started exporter records cold-start reads, not the fault.
        for daemon in self.daemons:
            daemon.registry.wait_for_publish(0, timeout=10)
        self.hub = Hub(self.targets, interval=0.2, expect_workers=nodes,
                       **(hub_kw or {}))
        self.server = MetricsServer(
            self.hub.registry, host="127.0.0.1", port=0,
            trace_provider=self.hub.tracer, fleet_provider=self.hub.fleet,
            **(server_kw(self.hub) if server_kw else {}))
        self.server.start()
        self.base = f"http://127.0.0.1:{self.server.port}"

    def refresh(self, n: int, pause: float = 0.3) -> None:
        for _ in range(n):
            time.sleep(pause)
            self.hub.refresh_once()

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
        if self.hub is not None:
            self.hub.stop()
        for daemon in self.daemons:
            daemon.stop()


def run_straggler(nodes: int = 3, refreshes: int = 8,
                  delay: float = 0.8) -> Result:
    from .. import doctor

    result = Result("straggler")
    with tempfile.TemporaryDirectory() as tmp:
        fleet = None
        try:
            fleet = _Fleet(tmp, nodes, "node", straggler_delay=delay)
            straggler = fleet.targets[0]
            fleet.refresh(refreshes)
            row = doctor.check_fleet(fleet.base)
            attribution = (row.data or {}).get("attribution") or {}
            text = fleet.hub.registry.snapshot().render()
            gauge = any(line.startswith("kts_fleet_worst_tick_seconds")
                        and straggler in line
                        for line in text.splitlines())
            named = attribution.get("target", "") == straggler
            phase = attribution.get("phase", "")
            if not (named and phase in READ_PHASES and gauge):
                result.problems.append(
                    f"straggler {straggler} not attributed: attribution "
                    f"{attribution}, gauge names it {gauge}, doctor "
                    f"{row.detail!r}")
            result.figures.update(straggler_named=named,
                                  phase_is_read=phase in READ_PHASES,
                                  gauge_names_straggler=gauge)
            result.timings.update(phase=phase,
                                  phase_s=attribution.get("seconds"),
                                  blame=attribution.get("blame"))
        finally:
            if fleet is not None:
                fleet.stop()
    return result


def run_link(nodes: int = 4) -> Result:
    from .. import doctor
    from ..history import HistoryStore
    from ..testing.host_fixture import make_host_tree, write_nic

    result = Result("link")
    problems = result.problems
    sick = (1, 2)
    history = HistoryStore()

    def daemon_kw(root):
        host = make_host_tree(root / "host")
        write_nic(root / "sys")
        return dict(sysfs_root=str(root / "sys"),
                    proc_root=str(host["proc"]),
                    cgroup_root=str(host["cgroup"]))

    with tempfile.TemporaryDirectory() as tmp:
        fleet = None
        try:
            fleet = _Fleet(tmp, nodes, "link", hub_kw={"history": history},
                           server_kw=lambda hub: {"history_provider":
                                                  history},
                           daemon_kw=daemon_kw, topology=f"{nodes}x1")
            for fake in fleet.fakes:
                for card in fake.devices:
                    card.set_nvlink_rate({0: NVLINK_KIB_PER_S,
                                          1: NVLINK_KIB_PER_S})
            fleet.refresh(10)
            warm = dict(fleet.hub.fleet.links.suspects())
            if warm:
                problems.append(f"link suspect raised during the healthy "
                                f"warm-up: {warm}")
            # Degrade one NVLink link on each of the two nodes' cards,
            # with NIC drops on both hosts.
            for node in sick:
                for card in fleet.fakes[node].devices:
                    card.set_nvlink_rate({0: NVLINK_KIB_PER_S,
                                          1: NVLINK_KIB_PER_S / 10})
            drops = {node: 0 for node in sick}
            for _ in range(6):
                for _tick in range(3):
                    time.sleep(0.1)
                    for node in sick:
                        drops[node] += 2000
                        write_nic(fleet.roots[node] / "sys",
                                  rx_dropped=drops[node])
                fleet.hub.refresh_once()
            incident_ts = time.time()
            row = doctor.check_fleet(fleet.base)
            data = row.data or {}
            suspects = data.get("link_suspects") or {}
            accused = data.get("anomalous") or {}
            text = fleet.hub.registry.snapshot().render()
            gauge = [line for line in text.splitlines()
                     if line.startswith("kts_fleet_link_suspect")
                     and line.rstrip().endswith(" 1")]
            for node in sick:
                for card in fleet.fakes[node].devices:
                    card.set_nvlink_rate({0: NVLINK_KIB_PER_S,
                                          1: NVLINK_KIB_PER_S})
            fleet.refresh(3)
            after = dict(fleet.hub.fleet.links.suspects())
            at_row = doctor.check_fleet_at(fleet.base, incident_ts)
            at_links = [entry.get("link") for entry in
                        (at_row.data or {}).get("links_suspect") or []]
            rates = [line for line in text.splitlines()
                     if line.startswith("accelerator_interconnect_"
                                        "bandwidth_bytes_per_second")
                     or line.startswith("accelerator_ici_bandwidth")]
            for what, got in (("links suspected", suspects),
                              ("suspect gauges at 1", gauge),
                              ("suspects after repair", after),
                              ("--at links", at_links)):
                if got:
                    problems.append(f"link: {what} on an H100 fleet: "
                                    f"{got}")
            # No node accused, for any reason, as in the reference; the
            # two nodes whose cards' links slowed, and only they, are
            # named as an interconnect slowdown no link can own.
            degraded = {fleet.targets[node] for node in sick}
            unplaced = set(data.get("link_unplaced") or {})
            if accused:
                problems.append(f"link: nodes accused: {accused}")
            if unplaced != degraded:
                problems.append(f"link: want exactly the degraded nodes "
                                f"{sorted(degraded)} named as an "
                                f"interconnect slowdown, got "
                                f"{sorted(unplaced)}")
            result.figures.update(
                links_suspected=len(suspects), suspect_gauges=len(gauge),
                at_links=len(at_links), warmup_suspects=len(warm),
                after_suspects=len(after), accused_nodes=len(accused),
                slowdown_nodes=sorted(fleet.targets.index(t)
                                      for t in unplaced))
            result.timings["accused"] = {
                fleet.targets.index(t): why for t, why in accused.items()}
            result.timings.update(rate_series=len(rates),
                                  doctor=row.detail)
        finally:
            if fleet is not None:
                fleet.stop()
    return result


def run_waste(nodes: int = 3) -> Result:
    from .. import doctor
    from ..history import HistoryStore

    result = Result("waste")
    problems = result.problems
    fig = result.figures
    idle_index = 1  # healthy neighbours on both sides
    idle_pod = f"train-{idle_index}"
    audit_key = "fleet-sim-audit-key"
    history = HistoryStore()
    with tempfile.TemporaryDirectory() as tmp:
        fleet = None
        try:
            fleet = _Fleet(
                tmp, nodes, "waste",
                hub_kw=dict(history=history, waste_warmup_refreshes=4,
                            waste_idle_refreshes=3,
                            energy_audit_key=audit_key),
                server_kw=lambda hub: {
                    "history_provider": history,
                    "efficiency_provider": hub.efficiency_payload})
            fleet.refresh(7)
            warm = dict(fleet.hub.fleet.efficiency.suspects())
            if warm:
                problems.append(f"waste verdict during the healthy "
                                f"warm-up: {warm}")
            for card in fleet.fakes[idle_index].devices:
                card.gpu_util = 0
            fleet.refresh(8)
            incident_ts = time.time()
            row = doctor.check_efficiency(fleet.base, audit_key)
            attestation = (row.data or {}).get("attestation") or {}
            waste = attestation.get("waste") or {}
            suspects = waste.get("suspects") or {}
            ranking = [r.get("pod") for r in waste.get("top_waste") or []]
            text = fleet.hub.registry.snapshot().render()
            gauge = any(line.startswith("kts_fleet_waste_suspect")
                        and f'pod="{idle_pod}"' in line
                        and line.rstrip().endswith(" 1")
                        for line in text.splitlines())
            ranked = any(line.startswith("kts_fleet_waste_chips")
                         and f'pod="{idle_pod}"' in line
                         for line in text.splitlines())
            named = [key for key in suspects
                     if key.rsplit("/", 1)[-1] == idle_pod]
            innocents = [key for key in suspects if key not in named]
            reason = suspects[named[0]].get("reason") if named else None
            verified = "signature verified" in row.detail
            if not (named and reason == "idle-reservation"
                    and not innocents and ranking[:1] == [idle_pod]
                    and verified and gauge and ranked):
                problems.append(
                    f"waste: expected {idle_pod} idle-reservation alone, "
                    f"signed; suspects {suspects}, ranking {ranking}, "
                    f"gauge {gauge}, ranked {ranked}, doctor "
                    f"{row.detail!r}")
            bad = doctor.check_efficiency(fleet.base, "some-other-key")
            if bad.status != doctor.FAIL:
                problems.append(f"waste: a wrong audit key did not fail "
                                f"verification: [{bad.status}] "
                                f"{bad.detail}")
            for card in fleet.fakes[idle_index].devices:
                card.gpu_util = 60
            cleared = False
            for _ in range(12):
                fleet.refresh(1)
                if not fleet.hub.fleet.efficiency.suspects():
                    cleared = True
                    break
            if not cleared:
                problems.append(f"waste: verdict never cleared after "
                                f"recovery: "
                                f"{fleet.hub.fleet.efficiency.suspects()}")
            events = doctor._fetch_json(
                fleet.base + "/debug/events").get("events") or []
            journaled = any(e.get("kind") == "fleet_waste_cleared"
                            and idle_pod in (e.get("detail") or "")
                            for e in events)
            if not journaled:
                problems.append("waste: no fleet_waste_cleared journal "
                                "event naming the recovered pod")
            at_row = doctor.check_efficiency_at(fleet.base, incident_ts)
            at_pods = [e.get("pod") for e in
                       (at_row.data or {}).get("waste_suspects") or []]
            if idle_pod not in at_pods:
                problems.append(f"waste: doctor --efficiency --at did not "
                                f"name the idle pod: {at_pods}")
            fig.update(
                pod=named[0].rsplit("/", 1)[-1] if named else None,
                reason=reason, innocents=len(innocents),
                top_waste=ranking[:1], signature_verified=verified,
                wrong_key=bad.status, gauge_names_pod=gauge,
                chips_ranked=ranked, cleared=cleared, journaled=journaled,
                at_names_pod=idle_pod in at_pods,
                warmup_suspects=len(warm))
        finally:
            if fleet is not None:
                fleet.stop()
    return result


def run(nodes: int = 3, refreshes: int = 8, delay: float = 0.8,
        link_nodes: int = 4, scenario: str = "all") -> Result:
    result = Result("fleet")
    if scenario in ("all", "straggler"):
        result.merge(run_straggler(nodes, refreshes, delay), "straggler")
    if scenario in ("all", "link"):
        result.merge(run_link(link_nodes), "link")
    if scenario in ("all", "waste"):
        result.merge(run_waste(nodes), "waste")
    return result


def add_arguments(parser) -> None:
    parser.add_argument("--nodes", type=int, default=3)
    parser.add_argument("--refreshes", type=int, default=8)
    parser.add_argument("--delay", type=float, default=0.8,
                        help="seconds each NVML utilization read of node "
                             "0 stalls (the straggler)")
    parser.add_argument("--link-nodes", type=int, default=4,
                        help="nodes in the link scenario's ring")
    parser.add_argument("--scenario", default="all",
                        choices=("all", "straggler", "link", "waste"))


def main(args) -> Result:
    result = run(args.nodes, args.refreshes, args.delay, args.link_nodes,
                 args.scenario)
    print(result.report(
        "the straggler named with its read phase, the degraded NVLink "
        "links suspected as no link (the H100 limit) and no node accused, "
        "the idle pod named from the signed attestation and cleared"))
    return result
