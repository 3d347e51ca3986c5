"""Topology-aware link fault localization: name the sick LINK, not the
innocent neighbor.

The port's copy of the reference's localizer. A single degraded link
between two workers shows up as step/fetch slowdowns on BOTH of its
endpoints — per-node views (the node's own exporter, the lens's
per-target baselines) can only accuse the nodes. This module is the
hub's cross-node pass that turns per-node evidence into a link verdict:

- the interconnect graph comes from :class:`topology.InterconnectGraph`
  (torus adjacency from the ``AxBxC`` topology label the exporters
  carry; ring fallback over the worker ids);
- each worker's per-link rates (harvested from its
  ``accelerator_ici_link_bandwidth_bytes_per_second`` exposition by
  ``fleetlens.digest_from_series``) are mapped onto graph edges via the
  axis convention (worker 1's "x1" and worker 2's "x0" are the same
  physical link 1-2), giving TWO independent views per edge;
- :class:`ici.LinkBaselineEngine` baselines every endpoint view
  (EWMA + MAD bands, warmup, counter-reset tolerance); an edge is a
  CANDIDATE only when both endpoints' views degrade together — one
  endpoint alone is a node problem, not a link;
- candidates sharing a common node (>= 2 sick edges into one worker)
  are attributed to the NODE and suppressed: a dead worker degrades
  every link it touches;
- surviving candidates are scored with corroboration before accusing:
  co-occurring device anomalies (ici/steps/fetch z-breaches from the
  fleet lens) and host NIC/IRQ evidence upgrade the reason to
  "host-counter-confirmed";
- verdicts are hysteretic (confirm/clear streaks) and edge-journaled
  (``fleet_link_suspect`` / ``fleet_link_cleared``), exported as
  ``kts_fleet_link_suspect{link,reason}`` +
  ``kts_fleet_link_baseline_*``, surfaced in ``/debug/fleet`` under
  ``links`` and rendered by ``doctor --fleet``.

On an H100 fleet this pass is inert, and that is the faithful port: the
NVML backend labels a card's links ``nvlink<N>`` — its links to the
node's own NVSwitches, not links between workers — and NVML gives no
switch-side view for the two-endpoint check. ``edge_for`` maps no such
label onto an edge, so no edge gets a view and no link is ever accused;
the per-target ``ici`` signal (the sum of a node's NVLink rates) still
scores in the fleet lens.

Single-writer: :meth:`observe` runs under the FleetLens lock on the
hub's refresh thread; the read accessors return copies.
"""

from __future__ import annotations

from typing import Mapping

from . import ici, topology

# Verdict hysteresis, in refreshes: an edge must stay a candidate this
# many consecutive refreshes to raise, and stay clean this many to
# clear — a one-refresh rate dip (GC pause on one worker) must not
# journal a link accusation.
CONFIRM_REFRESHES = 2
CLEAR_REFRESHES = 2

# Endpoint-view baselines idle past this are swept (workers departed,
# graph reshaped) — the stale-link analog of RateTracker.forget_device.
STALE_LINK_SECONDS = 900.0

# Device-side anomaly kinds that a degraded link explains at its
# endpoints (the lens's z-breach names): the localization pass treats
# these as corroboration, and doctor suppresses node accusations made
# of nothing else.
LINK_EXPLAINED_KINDS = frozenset({"ici", "steps", "fetch"})


class LinkLocalizer:
    """Cross-correlates per-worker ICI/step/fetch/host evidence over
    the interconnect graph into per-link suspicion verdicts."""

    def __init__(self, *, engine: ici.LinkBaselineEngine | None = None,
                 confirm: int = CONFIRM_REFRESHES,
                 clear: int = CLEAR_REFRESHES) -> None:
        self.engine = engine if engine is not None \
            else ici.LinkBaselineEngine()
        self.confirm = max(1, confirm)
        self.clear = max(1, clear)
        self._graph: topology.InterconnectGraph | None = None
        self._graph_key: tuple | None = None
        # link -> consecutive candidate / clean refresh counts.
        self._streak: dict[str, int] = {}
        self._clean: dict[str, int] = {}
        # Active verdicts: link -> {reason, endpoints, targets, since,
        # observed_bps, baseline_bps, drop}.
        self._suspects: dict[str, dict] = {}
        # Every (link, reason) identity ever raised -> currently-active
        # reason string, for series-continuity rows (a cleared suspect
        # keeps exporting 0.0 under its old reasons so nearest-sample
        # history reads don't resurrect the stale 1.0).
        self._known_reasons: dict[str, set] = {}
        # Last per-edge summary (for baseline export/rollup).
        self._edges: dict[str, dict] = {}

    # -- scoring (refresh thread, FleetLens lock held) -----------------------

    def observe(self, now: float,
                nodes: Mapping[str, dict]) -> list[tuple[str, str, dict]]:
        """Score one refresh. ``nodes`` maps worker id -> evidence:
        ``links`` ({local label: bytes/s}), ``topology`` (label
        string), ``anomalies`` (device-side anomalous kinds),
        ``host`` (host_* anomaly active), ``target`` (URL, display
        only). Returns journal events (kind, detail, attrs) for the
        caller to emit outside its lock."""
        events: list[tuple[str, str, dict]] = []
        workers = tuple(sorted(nodes))
        topo = next((n.get("topology", "") for n in nodes.values()
                     if n.get("topology")), "")
        key = (workers, topo)
        if key != self._graph_key:
            self._graph_key = key
            self._graph = topology.InterconnectGraph(workers, topo)
            valid = set(self._graph.links())
            for link in [s for s in self._suspects if s not in valid]:
                self._drop_suspect(link, events, "graph changed")
            self._streak = {k: v for k, v in self._streak.items()
                            if k in valid}
            self._clean = {k: v for k, v in self._clean.items()
                           if k in valid}
            self._edges = {k: v for k, v in self._edges.items()
                           if k in valid}
        graph = self._graph
        if graph is None or not graph.links():
            return events
        # Per-edge endpoint views: each worker's local link labels map
        # onto graph edges; both endpoints of an edge see it.
        views: dict[str, dict[str, float]] = {}
        for worker, evidence in nodes.items():
            for label, rate in (evidence.get("links") or {}).items():
                edge = graph.edge_for(worker, label)
                if edge is not None:
                    view = views.setdefault(edge, {})
                    view[worker] = view.get(worker, 0.0) + rate
        candidates: dict[str, dict] = {}
        for edge in sorted(views):
            view = views[edge]
            assessments = {
                worker: self.engine.observe(f"{edge}|{worker}", rate, now)
                for worker, rate in sorted(view.items())
            }
            scored = {w: a for w, a in assessments.items() if a is not None}
            observed = (sum(a.rate for a in scored.values())
                        / len(scored)) if scored else 0.0
            baseline = (sum(a.mean for a in scored.values())
                        / len(scored)) if scored else 0.0
            band = (sum(a.band for a in scored.values())
                    / len(scored)) if scored else 0.0
            degraded = [w for w, a in scored.items() if a.degraded]
            self._edges[edge] = {
                "observed_bps": observed,
                "baseline_bps": baseline,
                "band_bps": band,
                "views": len(scored),
                "degraded_views": len(degraded),
            }
            ends = graph.endpoints(edge) or ()
            # A link is a candidate only when BOTH endpoints' own
            # counters degrade: one-sided evidence is that node's
            # problem (its per-target baselines already flag it).
            if len(ends) == 2 and all(w in degraded for w in ends):
                drop = max(0.0, 1.0 - observed / baseline) \
                    if baseline > 0 else 0.0
                candidates[edge] = {"endpoints": list(ends),
                                    "drop": round(drop, 4),
                                    "observed_bps": observed,
                                    "baseline_bps": baseline}
        # Node-vs-link disambiguation: a worker with >= 2 candidate
        # edges is itself the suspect (a sick NODE degrades every link
        # it touches) — drop its edges from the accusation set; the
        # per-target anomaly path names the node.
        incident: dict[str, int] = {}
        for edge in candidates:
            for worker in candidates[edge]["endpoints"]:
                incident[worker] = incident.get(worker, 0) + 1
        sick_nodes = {w for w, count in incident.items() if count >= 2}
        accused = {edge: info for edge, info in candidates.items()
                   if not sick_nodes.intersection(info["endpoints"])}
        # Streak accounting + verdict edges.
        for edge in graph.links():
            info = accused.get(edge)
            if info is not None:
                self._streak[edge] = self._streak.get(edge, 0) + 1
                self._clean[edge] = 0
                reason = self._reason(info["endpoints"], nodes)
                active = self._suspects.get(edge)
                if active is None:
                    if self._streak[edge] >= self.confirm:
                        verdict = dict(info)
                        verdict["reason"] = reason
                        verdict["since"] = now
                        verdict["targets"] = sorted(
                            nodes[w].get("target", "")
                            for w in info["endpoints"] if w in nodes)
                        self._suspects[edge] = verdict
                        self._known_reasons.setdefault(
                            edge, set()).add(reason)
                        events.append((
                            "fleet_link_suspect",
                            f"ICI link {edge} suspect: workers "
                            f"{','.join(info['endpoints'])} both "
                            f"{info['drop']:.0%} below baseline "
                            f"({reason})",
                            {"link": edge, "reason": reason,
                             "drop": info["drop"],
                             "endpoints": ",".join(info["endpoints"])}))
                else:
                    # Live verdict: track the current drop and let the
                    # reason upgrade as corroboration lands (host
                    # evidence often trails the rate drop by a refresh).
                    active.update(info)
                    active["reason"] = reason
                    self._known_reasons.setdefault(edge, set()).add(reason)
            else:
                self._streak[edge] = 0
                if edge in self._suspects:
                    self._clean[edge] = self._clean.get(edge, 0) + 1
                    if self._clean[edge] >= self.clear:
                        self._drop_suspect(edge, events, "rates recovered")
        self.engine.sweep(now, STALE_LINK_SECONDS)
        return events

    def _drop_suspect(self, link: str, events: list, why: str) -> None:
        verdict = self._suspects.pop(link, None)
        self._clean.pop(link, None)
        if verdict is not None:
            events.append((
                "fleet_link_cleared",
                f"ICI link {link} cleared: {why}",
                {"link": link, "reason": verdict.get("reason", "")}))

    @staticmethod
    def _reason(endpoints: list, nodes: Mapping[str, dict]) -> str:
        """The accusation's evidence trail, stable-ordered. Base
        evidence is always the two-sided rate drop; device-side
        z-breaches and host NIC/IRQ anomalies at the endpoints append
        their corroboration."""
        parts = ["ici-rate"]
        if any(LINK_EXPLAINED_KINDS.intersection(
                nodes.get(w, {}).get("anomalies") or ())
               for w in endpoints):
            parts.append("anomaly-correlated")
        if any(nodes.get(w, {}).get("host") for w in endpoints):
            parts.append("host-counter-confirmed")
        return "+".join(parts)

    # -- read side (copies; caller holds the FleetLens lock) -----------------

    def suspects(self) -> dict[str, dict]:
        return {link: dict(v) for link, v in self._suspects.items()}

    def explained_targets(self) -> dict[str, str]:
        """target URL -> suspect link, for every endpoint of an active
        verdict — what doctor uses to suppress node accusations that a
        named link fully explains."""
        out: dict[str, str] = {}
        for link, verdict in self._suspects.items():
            for target in verdict.get("targets", ()):
                if target:
                    out[target] = link
        return out

    def rows(self) -> list[tuple[str, str, float]]:
        """(link, reason, value) for every (link, reason) identity ever
        raised: 1.0 while that identity is the active verdict, 0.0
        otherwise — series continuity so history nearest-sample reads
        see the recovery, not a frozen accusation."""
        out: list[tuple[str, str, float]] = []
        for link in sorted(self._known_reasons):
            active = self._suspects.get(link)
            active_reason = active.get("reason") if active else None
            for reason in sorted(self._known_reasons[link]):
                out.append((link, reason,
                            1.0 if reason == active_reason else 0.0))
        return out

    def summary(self) -> dict:
        """The /debug/fleet ``links`` payload."""
        graph = self._graph
        return {
            "graph": graph.describe() if graph is not None
            else {"kind": "none", "topology": "", "nodes": 0, "links": 0},
            "suspects": {
                link: {
                    "reason": v.get("reason", ""),
                    "endpoints": list(v.get("endpoints", ())),
                    "targets": list(v.get("targets", ())),
                    "since": v.get("since", 0.0),
                    "drop": v.get("drop", 0.0),
                    "observed_bps": round(v.get("observed_bps", 0.0), 3),
                    "baseline_bps": round(v.get("baseline_bps", 0.0), 3),
                }
                for link, v in sorted(self._suspects.items())
            },
            "baselines": {
                link: {
                    "observed_bps": round(e["observed_bps"], 3),
                    "baseline_bps": round(e["baseline_bps"], 3),
                    "band_bps": round(e["band_bps"], 3),
                    "views": e["views"],
                    "degraded_views": e["degraded_views"],
                }
                for link, e in sorted(self._edges.items())
            },
        }

    def baseline_rows(self) -> list[tuple[str, float, float, float]]:
        """(link, baseline_bps, band_bps, observed_bps) per modeled
        edge — the kts_fleet_link_baseline_* export."""
        return [(link, e["baseline_bps"], e["band_bps"],
                 e["observed_bps"])
                for link, e in sorted(self._edges.items())]

    def link_count(self) -> int:
        return len(self._graph.links()) if self._graph is not None else 0
