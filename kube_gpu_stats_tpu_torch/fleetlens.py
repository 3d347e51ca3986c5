"""Fleet lens — cross-node anomaly detection, slow-node attribution,
and SLO burn windows, driven from the hub's refresh cycle.

The port's copy of the reference's fleet lens, for an H100 fleet. A
node's exporter answers "what are this node's cards doing"; the flight
recorder (tracing.py) answers "why was this *process* slow" — but on an
SPMD job over many nodes the question operators ask is "which *node* is
dragging the job, and since when", which no single-process view can
answer. The hub is the only component that sees every worker, so the
lens lives behind its refresh loop, three layers deep:

- **Baselines** — per-target EWMA mean/variance over the signals a
  straggling or sick node moves first (duty, memory used, power, step
  rate, scrape latency or push gap, stale-card fraction, the summed
  NVLink rate). A reading whose z-score against its own baseline
  breaches the threshold raises an anomaly into the shared event
  journal (``fleet_anomaly``, stamped with the causing target and
  refresh seq — the same journal /debug/events and ``doctor`` already
  read); recovery journals ``fleet_recovered``. Edge-detected: one
  event per transition, never one per refresh. Freshness is its own
  anomaly kind: a target missing several refreshes running is flagged
  even though it produces no readings to z-score.
- **Slow-node attribution** — each daemon self-exports a compact
  flight-recorder digest (``kts_tick_phase_seconds{phase,quantile}`` +
  ``kts_slowest_tick_seconds{phase,blame}``, contributed by
  :func:`contribute_trace_digest` from the poll loop's snapshot tail).
  The hub already holds every target's parsed exposition, so the lens
  harvests the digests for free (:func:`digest_from_series`, cached on
  the target's ingest cache entry) and folds them into the fleet-wide
  worst node: which target, which phase, which card to blame —
  exported as ``kts_fleet_worst_tick_seconds{target,phase}`` and the
  headline of ``doctor --fleet``.
- **SLO burn windows** — two objectives over two windows (5m/1h, the
  classic multiwindow burn-rate shape): *freshness* (observed cards
  serving fresh data: a stale card, or an unreachable target's
  last-known cards, count against the error budget) and *straggler*
  (refreshes whose slice straggler ratio met ``--slo-straggler-ratio``).
  Exported as ``kts_fleet_slo_burn_rate{objective,window}`` /
  ``kts_fleet_slo_bad_ratio``; burn > 1.0 on both windows is the page
  condition.

Everything is exact arithmetic over injected timestamps — no wall-clock
reads, no randomness — so baselines and burn rates are deterministic
under seeded inputs. The exported names and payload keys keep the
reference's "chip" wording, so both packages read alike.

Read three ways: ``kts_fleet_*`` gauges on the hub's /metrics
(:meth:`FleetLens.contribute`), the ``/debug/fleet`` JSON rollup
(:meth:`FleetLens.rollup`, served by exposition.py), and
``doctor --fleet`` (doctor.py), which joins the rollup into a post-mortem.

Concurrency contract: :meth:`observe`/:meth:`evict` run on the hub's
refresh thread (single writer); :meth:`rollup` is called from HTTP
handler threads and :meth:`contribute` from the refresh thread — a
small lock guards the shared state, never held across anything slower
than dict walks.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Mapping, Sequence

from . import linkloc, schema
from . import efficiency as efficiency_mod

# Default SLO knobs (--slo-* flags; config.py re-exports these as the
# shared flag surface). Freshness: 99% of observed card-refreshes serve
# fresh data. Straggler: 95% of rate-bearing refreshes keep the slice's
# straggler ratio at or above 0.75 (min/max per-worker step rate — in
# SPMD the slowest worker gates everyone, so a persistently low ratio
# IS lost goodput even while every card reads healthy).
DEFAULT_FRESHNESS_TARGET = 0.99
DEFAULT_STRAGGLER_TARGET = 0.95
DEFAULT_STRAGGLER_RATIO = 0.75

# Burn windows: (seconds, label). 5m catches a fast burn while it's
# happening; 1h keeps a slow leak visible after the spike scrolls off.
SLO_WINDOWS: tuple[tuple[float, str], ...] = ((300.0, "5m"), (3600.0, "1h"))

# Baseline shape: EWMA with ~20% weight on the newest reading settles in
# a few refreshes and forgets a deployment's old operating point within
# ~a minute at the 10 s cadence; z-scores only fire once MIN_SAMPLES
# readings have folded (a cold baseline flags nothing).
BASELINE_ALPHA = 0.2
MIN_BASELINE_SAMPLES = 8
DEFAULT_Z_THRESHOLD = 4.0

# A target missing this many refreshes running raises the 'freshness'
# anomaly (distinct from the breaker: the breaker manages fetch cost,
# this names the telemetry gap in the journal/doctor view).
FRESHNESS_MISS_THRESHOLD = 3

# Anomaly ring served by rollup(): bounded like the tracer's journal.
_RECENT_ANOMALIES_CAP = 64

# Absolute standard-deviation floors, in each signal's own units, for
# the signals with a bounded natural scale: the relative (2%-of-mean)
# floor is ~0 when a baseline sits flat at zero (idle duty, healthy
# stale fraction), where any nonzero blip would otherwise z-score to
# the astronomical. One duty point, 5% stale cards, 5 ms of fetch —
# changes smaller than these are operationally noise regardless of how
# flat the history was. Signals without a natural scale (hbm, power,
# steps) instead re-seed on first activity (see _score).
_SD_FLOORS: dict[str, float] = {
    "duty": 1.0,
    "stale_fraction": 0.05,
    "fetch": 0.005,
    # Host signals: PSI shares are 0-100 points, drop/
    # throttle rates are per-second counts — changes below these are
    # host noise regardless of how flat the (healthy, usually zero)
    # history was.
    "host_mem_stall": 2.0,
    "host_cpu_stall": 5.0,
    "host_io_stall": 2.0,
    "host_nic_drops": 5.0,
    "host_throttle": 0.5,
}

# Host signals harvested from a target's kts_host_* exposition into its
# digest (digest_from_series) and scored as baselines (observe): the
# digest key doubles as the display source for doctor's joined verdict.
# signal name -> digest key under digest["host"].
HOST_SIGNALS: dict[str, str] = {
    "host_mem_stall": "mem_full_avg10",
    "host_cpu_stall": "cpu_some_avg10",
    "host_io_stall": "io_full_avg10",
    "host_nic_drops": "nic_drop_rate",
    "host_throttle": "throttle_rate",
}

# kts_host_pressure_share (resource, kind) pairs harvested into the
# digest at the avg10 window — the strongest stall evidence per PSI
# semantics: memory/io 'full' (nothing ran), cpu 'some' (cpu has no
# full line on most kernels).
_HOST_PSI_KEYS: dict[tuple[str, str], str] = {
    ("memory", "full"): "mem_full_avg10",
    ("cpu", "some"): "cpu_some_avg10",
    ("io", "full"): "io_full_avg10",
}


class EwmaBaseline:
    """Exponentially-weighted mean/variance over one per-target signal.

    Driven as a score-then-fold pair: ``score`` rates a reading against
    the baseline BEFORE it folds in (the reading must not defend
    itself), then ``fold`` absorbs it — with a variance floor of 2% of
    the rolling mean (plus an optional absolute floor) so a perfectly
    flat signal (an idle card's power) doesn't turn measurement jitter
    into infinite z."""

    __slots__ = ("mean", "var", "count")

    def __init__(self) -> None:
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def score(self, value: float, sd_floor_abs: float = 0.0) -> float:
        """z-score of ``value`` against the current baseline, without
        folding it in (0.0 while the baseline is cold).
        ``sd_floor_abs`` is an absolute floor in the signal's own units
        (per-signal, _SD_FLOORS) — the relative floor alone is ~0 for a
        baseline flat at zero, where any blip would z-score to the
        astronomical."""
        if self.count == 0:
            return 0.0
        delta = value - self.mean
        sd_floor = max(0.02 * abs(self.mean), sd_floor_abs, 1e-9)
        return delta / max(math.sqrt(self.var), sd_floor)

    def fold(self, value: float, alpha: float = BASELINE_ALPHA) -> None:
        """West's incremental EWMA update: variance folds the same
        delta the caller just scored, then the mean moves."""
        if self.count == 0:
            self.mean = value
            self.var = 0.0
            self.count = 1
            return
        delta = value - self.mean
        self.var = (1.0 - alpha) * (self.var + alpha * delta * delta)
        self.mean += alpha * delta
        self.count += 1



class _SloTracker:
    """One objective's multi-window burn accounting: a bounded deque of
    (at, bad, total) per refresh, pruned past the longest window."""

    __slots__ = ("target", "_events", "_horizon")

    def __init__(self, target: float,
                 windows: Sequence[tuple[float, str]]) -> None:
        self.target = target
        self._events: collections.deque = collections.deque()
        self._horizon = max(seconds for seconds, _ in windows)

    def update(self, at: float, bad: float, total: float) -> None:
        self._events.append((at, bad, total))
        cutoff = at - self._horizon
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def window_state(self, now: float,
                     windows: Sequence[tuple[float, str]]) -> dict:
        """{window label: {"bad_ratio", "burn_rate", "events"}}. An
        empty window reports 0.0 (no data = no burn, and the freshness
        objective always has data while targets exist)."""
        budget = max(1.0 - self.target, 1e-9)
        out = {}
        for seconds, label in windows:
            cutoff = now - seconds
            bad = total = 0.0
            for at, b, t in self._events:
                if at >= cutoff:
                    bad += b
                    total += t
            ratio = bad / total if total else 0.0
            out[label] = {
                "bad_ratio": round(ratio, 6),
                "burn_rate": round(ratio / budget, 3),
                "events": int(total),
            }
        return out


class _TargetState:
    """Everything the lens remembers about one target."""

    __slots__ = ("baselines", "missed", "anomalous", "last_signals",
                 "last_z", "digest", "chips", "last_seen_seq")

    def __init__(self) -> None:
        self.baselines: dict[str, EwmaBaseline] = {}
        self.missed = 0          # consecutive refreshes without an answer
        self.anomalous: dict[str, float] = {}  # kind -> z at raise time
        self.last_signals: dict[str, float] = {}
        self.last_z: dict[str, float] = {}
        self.digest: dict = {}
        self.chips = 0           # last observed card count (freshness SLO)
        self.last_seen_seq = 0


def digest_from_series(series: Sequence) -> dict:
    """Harvest a target's flight-recorder digest from its parsed
    exposition ((name, labels-dict, value) triples — the hub's
    series_dicts view). Cached per ingest-cache entry, so an unchanged
    body replays this for free. Empty dict when the target exports no
    digest (older exporter, --no-trace)."""
    phases: dict[str, dict[str, float]] = {}
    slowest: dict | None = None
    burst_max: float | None = None
    host: dict[str, float] = {}
    ici_links: dict[str, float] = {}
    ici_worker = ""
    ici_topology = ""
    energy_pods: dict[tuple[str, str], float] = {}
    energy_coverage: float | None = None
    for name, labels, value in series:
        if name == schema.TICK_PHASE_SECONDS.name:
            phase = labels.get("phase", "")
            phases.setdefault(phase, {})[labels.get("quantile", "")] = value
        elif name == schema.SLOWEST_TICK_SECONDS.name:
            slowest = {
                "seconds": value,
                "phase": labels.get("phase", ""),
                "blame": labels.get("blame", ""),
            }
        elif (name == schema.BURST_WATTS.name
              and labels.get("stat") == "max"):
            # Burst-aware power baseline: the node's sub-tick
            # power peak, max over its cards — the 1 Hz power sum the
            # lens also scores samples AT tick instants and aliases
            # exactly the transients this surfaces.
            if burst_max is None or value > burst_max:
                burst_max = value
        elif name == schema.HOST_PRESSURE.name:
            # Host root-cause signals: the strongest PSI
            # shares join the node's digest so the lens can baseline
            # them and doctor can print them in the joined verdict.
            if labels.get("window") == "avg10":
                key = _HOST_PSI_KEYS.get(
                    (labels.get("resource", ""), labels.get("kind", "")))
                if key is not None:
                    host[key] = value
        elif name == schema.HOST_NIC_DROP_RATE.name:
            host["nic_drop_rate"] = value
        elif name == schema.HOST_THROTTLE_RATE.name:
            host["throttle_rate"] = value
        elif name == schema.ICI_BANDWIDTH.name:
            # Interconnect evidence: the target's per-link rates,
            # summed over its cards by link label, plus the
            # worker/topology identity the localization pass needs to
            # place this node on the interconnect graph. An H100 node's
            # labels are "nvlink<N>" (its links to the node's own
            # NVSwitches): they sum into the per-target ici signal, and
            # the localizer maps none of them onto a graph edge.
            link = labels.get("link", "")
            if link:
                ici_links[link] = ici_links.get(link, 0.0) + value
                ici_worker = ici_worker or labels.get("worker", "")
                ici_topology = ici_topology or labels.get("topology", "")
        elif name == schema.ENERGY_POD.name:
            # Per-pod energy evidence: the node's attributed
            # joules counters join its digest so the efficiency lens can
            # score goodput-per-watt — and so the federation rollup can
            # fold per-pod totals without refetching /debug/energy.
            pod = labels.get("pod", "")
            if pod:
                pod_key = (pod, labels.get("namespace", ""))
                energy_pods[pod_key] = energy_pods.get(pod_key, 0.0) + value
        elif name == schema.ENERGY_COVERAGE.name:
            energy_coverage = value
    out: dict = {}
    if phases:
        out["phases"] = phases
    if slowest is not None:
        out["slowest"] = slowest
    if burst_max is not None:
        out["burst_max_watts"] = burst_max
    if host:
        out["host"] = host
    if ici_links:
        out["ici"] = {"links": ici_links, "worker": ici_worker,
                      "topology": ici_topology}
    if energy_pods or energy_coverage is not None:
        # JSON-safe shape (the digest embeds in /debug/fleet): pods as
        # [pod, namespace, joules] lists, never tuple keys.
        out["energy"] = {
            "pods": [[pod, ns, joules]
                     for (pod, ns), joules in sorted(energy_pods.items())],
            "coverage": (energy_coverage
                         if energy_coverage is not None else 0.0),
        }
    return out


def contribute_trace_digest(builder, tracer) -> None:
    """Fold a flight recorder's phase digest into a snapshot — the
    node-side half of slow-node attribution (poll.py calls this from
    the snapshot tail). Emits nothing
    until a trace has recorded, and nothing at all when tracing is
    disabled (the families are documented as absent under --no-trace,
    and a disabled recorder has no data to digest)."""
    if not getattr(tracer, "enabled", False):
        return
    for phase, (p50, p99, mx) in tracer.phase_quantiles().items():
        for quantile, value in (("p50", p50), ("p99", p99), ("max", mx)):
            builder.add(schema.TICK_PHASE_SECONDS, value,
                        (("phase", phase), ("quantile", quantile)))
    slow = tracer.slowest_tick()
    if slow is not None:
        builder.add(schema.SLOWEST_TICK_SECONDS, slow["seconds"],
                    (("phase", slow["phase"]), ("blame", slow["blame"])))


def worker_step_rates(rows) -> dict[str, float]:
    """Mean step rate per worker over ONE slice's frame rows (SPMD:
    every card of a worker reports the same counter, so mean, not sum;
    workers with no label count individually by target — row.key leads
    with the target). The hub's slice_worker_steps_per_second rollup
    calls this."""
    per_worker: dict[str, list[float]] = {}
    for row in rows:
        if row.steps_per_s is None:
            continue
        worker = row.key[2] or str(row.key[0])
        per_worker.setdefault(worker, []).append(row.steps_per_s)
    return {worker: sum(values) / len(values)
            for worker, values in per_worker.items()}


def straggler_ratios(rows: Mapping) -> dict[str, float]:
    """Per-slice min/max of per-worker step rates from a frame's rows
    (worker_step_rates per slice — one definition with the hub's
    slice_straggler_ratio rollup). Slices with no rates yet are
    absent."""
    per_slice: dict[str, list] = {}
    for row in rows.values():
        per_slice.setdefault(row.key[1], []).append(row)
    out: dict[str, float] = {}
    for slice_name, slice_rows in per_slice.items():
        rates = list(worker_step_rates(slice_rows).values())
        if rates and max(rates) > 0:
            out[slice_name] = min(rates) / max(rates)
    return out


class FleetLens:
    """The hub's fleet-observability brain. One instance per hub;
    ``observe`` is called once per refresh from the refresh thread."""

    def __init__(self, tracer=None, *,
                 freshness_target: float = DEFAULT_FRESHNESS_TARGET,
                 straggler_target: float = DEFAULT_STRAGGLER_TARGET,
                 straggler_ratio: float = DEFAULT_STRAGGLER_RATIO,
                 z_threshold: float = DEFAULT_Z_THRESHOLD,
                 min_samples: int = MIN_BASELINE_SAMPLES,
                 miss_threshold: int = FRESHNESS_MISS_THRESHOLD,
                 alpha: float = BASELINE_ALPHA,
                 windows: Sequence[tuple[float, str]] = SLO_WINDOWS,
                 efficiency: bool = True,
                 waste_warmup_refreshes: int =
                 efficiency_mod.DEFAULT_WARMUP_REFRESHES,
                 waste_idle_refreshes: int =
                 efficiency_mod.DEFAULT_IDLE_REFRESHES,
                 waste_idle_duty: float = efficiency_mod.DEFAULT_IDLE_DUTY,
                 waste_top_k: int = efficiency_mod.DEFAULT_TOP_K) -> None:
        # Journal feed (tracing.Tracer, duck-typed; None = no journal).
        self._tracer = tracer
        # Burst auto-arm hook: called as hook(target, kind, z)
        # on every power/duty-shaped anomaly RAISE (outside the lock,
        # alongside the journal emit). Colocated/sim topologies wire it
        # straight at a daemon's BurstSampler.arm; distributed setups
        # rely on the journal-scan path instead (the daemon's sampler
        # watches its own journal for fleet_anomaly events).
        self.arm_hook = None
        self.z_threshold = z_threshold
        self.min_samples = min_samples
        self.miss_threshold = miss_threshold
        self.alpha = alpha
        self._windows = tuple(windows)
        self._freshness = _SloTracker(freshness_target, self._windows)
        self._straggler = _SloTracker(straggler_target, self._windows)
        self.straggler_ratio_min = straggler_ratio
        self._lock = threading.Lock()
        self._targets: dict[str, _TargetState] = {}
        # Cumulative raise counts per (target, kind): the
        # kts_fleet_anomalies_total counter state.
        self._anomalies_total: dict[tuple[str, str], int] = {}
        self._recent: collections.deque = collections.deque(
            maxlen=_RECENT_ANOMALIES_CAP)
        # Fleet-wide slow-node attribution from the last refresh that
        # had any digest: {"target", "seconds", "phase", "blame"}.
        self._worst: dict | None = None
        # Topology-aware link localization: the pass that
        # names a sick LINK from the cross-node evidence this lens
        # already holds. Guarded by self._lock like everything else.
        self.links = linkloc.LinkLocalizer()
        # Fleet efficiency scoring: who is wasting cards.
        # None under --no-efficiency — the rollup then reports the
        # layer disabled rather than silently absent. Guarded by
        # self._lock like the localizer.
        self.efficiency = efficiency_mod.EfficiencyLens(
            warmup_refreshes=waste_warmup_refreshes,
            idle_refreshes=waste_idle_refreshes,
            idle_duty=waste_idle_duty,
            top_k=waste_top_k) if efficiency else None
        self._last_seq = 0
        self._last_now = 0.0

    # -- scoring (refresh thread) --------------------------------------------

    def observe(self, seq: int, now: float, targets: Sequence[str],
                reachable: Mapping[str, bool],
                fetch_seconds: Mapping[str, float],
                frame, digests: Mapping[str, dict]) -> None:
        """Score one refresh: fold every answered target's signals into
        its baselines, flag z/freshness anomalies into the journal,
        advance the SLO windows, and recompute slow-node attribution.
        ``now`` is injected (the refresh's own wall stamp) so scoring is
        deterministic under scripted inputs."""
        rows_by_target: dict[str, list] = {}
        for row in frame.rows.values():
            rows_by_target.setdefault(str(row.key[0]), []).append(row)
        events: list[tuple[str, str, dict]] = []  # journaled outside the lock
        with self._lock:
            self._last_seq = seq
            self._last_now = now
            fresh_bad = fresh_total = 0.0
            for target in targets:
                state = self._targets.get(target)
                if state is None:
                    state = self._targets[target] = _TargetState()
                answered = bool(reachable.get(target))
                rows = rows_by_target.get(target, [])
                if answered:
                    state.missed = 0
                    state.last_seen_seq = seq
                    if target in digests:
                        # Empty replaces too: a target restarted with
                        # --no-trace must not keep serving its
                        # pre-restart digest into attribution.
                        state.digest = digests[target]
                    signals = self._signals(target, rows,
                                            fetch_seconds.get(target))
                    burst_max = digests.get(target, {}).get(
                        "burst_max_watts")
                    if burst_max is not None:
                        # Burst-aware power baseline: the target's
                        # sub-tick peak joins its scored signals, so a
                        # transient regime change (a card starting to
                        # spike between ticks) raises an anomaly even
                        # while the tick-sampled power sum stays flat.
                        signals["power_burst"] = burst_max
                    host = digests.get(target, {}).get("host")
                    if host:
                        # Host-pressure baselines: PSI
                        # full-stall shares, NIC drop rate, throttle
                        # edges — the signals production stragglers
                        # actually root-cause to. Healthy state is flat
                        # zero, so these are exempt from the first-
                        # activity re-seed (like stale_fraction):
                        # nonzero-from-zero IS the anomaly.
                        for name, key in HOST_SIGNALS.items():
                            value = host.get(key)
                            if value is not None:
                                signals[name] = value
                    ici_info = digests.get(target, {}).get("ici") \
                        or (state.digest.get("ici")
                            if state.digest else None)
                    if ici_info and ici_info.get("links"):
                        # Aggregate link throughput joins the scored
                        # signals (NOT re-seed exempt: a job starting
                        # moves it 0 -> big, which is a regime change,
                        # not a fault). Per-LINK scoring with the
                        # two-endpoint cross-check lives in the
                        # localizer below.
                        signals["ici"] = sum(
                            ici_info["links"].values())
                    state.chips = len(rows) or state.chips
                    stale_chips = sum(1 for r in rows if r.up != 1.0)
                    fresh_bad += stale_chips
                    fresh_total += len(rows)
                    self._score(target, state, signals, events)
                    self._set_anomaly(target, state, "freshness", None,
                                      events)
                else:
                    state.missed += 1
                    # An unreachable target's cards serve nothing fresh:
                    # its last-known card count burns the budget (at
                    # least 1 so a never-seen target still counts).
                    chips = max(state.chips, 1)
                    fresh_bad += chips
                    fresh_total += chips
                    if state.missed >= self.miss_threshold:
                        self._set_anomaly(
                            target, state, "freshness",
                            float(state.missed), events)
            if fresh_total:
                self._freshness.update(now, fresh_bad, fresh_total)
            ratios = straggler_ratios(frame.rows)
            if ratios:
                worst_ratio = min(ratios.values())
                self._straggler.update(
                    now, 1.0 if worst_ratio < self.straggler_ratio_min
                    else 0.0, 1.0)
            self._attribute(targets)
            # Interconnect localization: assemble each
            # answered worker's evidence — per-link rates, its
            # device-side anomaly kinds (ici/steps/fetch corroborate a
            # link verdict), and whether its host signals are also
            # anomalous — and let the localizer score the graph.
            link_nodes: dict[str, dict] = {}
            for target in targets:
                state = self._targets.get(target)
                if state is None or state.missed or not state.digest:
                    continue
                ici_info = state.digest.get("ici")
                if not ici_info or not ici_info.get("links"):
                    continue
                worker = str(ici_info.get("worker", ""))
                if not worker:
                    continue
                link_nodes[worker] = {
                    "links": ici_info["links"],
                    "topology": ici_info.get("topology", ""),
                    "anomalies": set(state.anomalous),
                    "host": any(k.startswith("host_")
                                for k in state.anomalous),
                    "target": target,
                }
            if link_nodes:
                events.extend(self.links.observe(now, link_nodes))
            if self.efficiency is not None:
                events.extend(self.efficiency.observe(
                    seq, now, self._pod_evidence(frame)))
        self._journal(events)

    def _pod_evidence(self, frame) -> dict[tuple[str, str], dict]:
        """Per-(pod, namespace) card evidence for the efficiency lens
        (lock held): duty/power/steps folded from the frame's attributed
        rows, joined with per-pod joules and coverage from the hosting
        targets' energy digests. Pods without attribution can't be
        scored — waste attribution IS pod attribution."""
        pod_rows: dict[tuple[str, str], list] = {}
        for row in frame.rows.values():
            if row.pod:
                pod_rows.setdefault((row.pod, row.namespace or ""),
                                    []).append(row)
        out: dict[tuple[str, str], dict] = {}
        for key, rows in pod_rows.items():
            duties = [r.duty for r in rows if r.duty is not None]
            powers = [r.power for r in rows if r.power is not None]
            steps = [r.steps_per_s for r in rows
                     if r.steps_per_s is not None]
            joules: float | None = None
            coverage = 0.0
            for target in sorted({str(r.key[0]) for r in rows}):
                state = self._targets.get(target)
                energy = (state.digest.get("energy")
                          if state is not None and state.digest else None)
                if not energy:
                    continue
                for entry in energy.get("pods") or []:
                    if (len(entry) >= 3 and entry[0] == key[0]
                            and entry[1] == key[1]):
                        joules = (joules or 0.0) + float(entry[2])
                # A multi-node pod is covered if ANY hosting node still
                # has energy evidence — UNKNOWN means fully blind.
                coverage = max(coverage,
                               float(energy.get("coverage") or 0.0))
            out[key] = {
                "duty": sum(duties) / len(duties) if duties else None,
                "power": sum(powers) if powers else None,
                "steps": sum(steps) if steps else None,
                "chips": len(rows),
                "joules": joules,
                "coverage": coverage,
            }
        return out

    def _signals(self, target: str, rows: list,
                 fetch: float | None) -> dict[str, float]:
        """The per-target readings the baselines track. Deterministic
        order; a signal the target doesn't report this refresh is simply
        absent (its baseline neither moves nor fires)."""
        signals: dict[str, float] = {}
        duties = [r.duty for r in rows if r.duty is not None]
        if duties:
            signals["duty"] = sum(duties) / len(duties)
        used = [r.mem_used for r in rows if r.mem_used is not None]
        if used:
            signals["hbm"] = sum(used)
        power = [r.power for r in rows if r.power is not None]
        if power:
            signals["power"] = sum(power)
        steps = [r.steps_per_s for r in rows if r.steps_per_s is not None]
        if steps:
            signals["steps"] = sum(steps) / len(steps)
        if fetch is not None:
            signals["fetch"] = fetch
        if rows:
            signals["stale_fraction"] = (
                sum(1 for r in rows if r.up != 1.0) / len(rows))
        return signals

    def _score(self, target: str, state: _TargetState,
               signals: Mapping[str, float], events: list) -> None:
        state.last_signals = dict(signals)
        for name in sorted(signals):
            value = signals[name]
            baseline = state.baselines.get(name)
            if baseline is None:
                baseline = state.baselines[name] = EwmaBaseline()
            if (baseline.count and value != 0.0
                    and baseline.mean == 0.0 and baseline.var == 0.0
                    and name != "stale_fraction"
                    and name not in HOST_SIGNALS):
                # First activity on a signal that idled at exactly zero
                # through warmup (duty/power/memory/steps before the job
                # starts): a state change, not a fault — re-seed rather
                # than flag every target of the slice the moment a job
                # launches. stale_fraction and the host_* pressure
                # signals are the inversions: their healthy state IS
                # flat zero, and nonzero-from-zero is precisely their
                # anomaly. Count resets to 1: the
                # min_samples warmup gate must re-run under the new
                # regime, or the signal's ramp (model still loading,
                # duty climbing) would z-explode against the re-seeded
                # zero-variance point on the very next refresh.
                baseline.mean = value
                baseline.var = 0.0
                baseline.count = 1
                state.last_z[name] = 0.0
                self._set_anomaly(target, state, name, None, events)
                continue
            warm = baseline.count >= self.min_samples
            z = baseline.score(value, _SD_FLOORS.get(name, 0.0))
            state.last_z[name] = round(z, 3)
            breach = warm and abs(z) >= self.z_threshold
            # Anomalous readings fold 16x slower: an outlier must not
            # drag the baseline toward itself and self-clear within a
            # couple of refreshes. A genuinely recovered signal clears
            # immediately (its reading lands back near the barely-moved
            # baseline), while a persistent regime change — a legit
            # redeployment's new operating point — adapts, and clears,
            # over minutes instead of sticking forever.
            baseline.fold(value, self.alpha / 16.0
                          if breach or name in state.anomalous
                          else self.alpha)
            if breach:
                self._set_anomaly(target, state, name, z, events)
            elif abs(z) < self.z_threshold / 2.0:
                # Hysteresis: clear only once the signal is well back
                # inside its baseline (half the raise threshold) — a z
                # oscillating around the threshold must not flap
                # raise/clear pairs into the journal and inflate the
                # edge-counted incident counter every refresh.
                self._set_anomaly(target, state, name, None, events)
            # else: in the hysteresis band — latch the current state.
        # A latched anomaly on a signal the target no longer reports
        # (the job ended and its step-rate series vanished) must clear,
        # or kts_fleet_targets_anomalous — and the alert on it — sticks
        # forever on data that no longer exists. 'freshness' is managed
        # by the reachability path, never here.
        for name in [k for k in state.anomalous
                     if k != "freshness" and k not in signals]:
            self._set_anomaly(target, state, name, None, events)

    def _set_anomaly(self, target: str, state: _TargetState, kind: str,
                     z: float | None, events: list) -> None:
        """Edge-detected raise/clear; appends journal payloads to
        ``events`` for emission outside the lock."""
        active = kind in state.anomalous
        if z is not None and not active:
            state.anomalous[kind] = round(z, 3)
            self._anomalies_total[(target, kind)] = (
                self._anomalies_total.get((target, kind), 0) + 1)
            record = {"seq": self._last_seq, "at": self._last_now,
                      "target": target, "kind": kind, "z": round(z, 3)}
            self._recent.append(record)
            # Journal attr is named 'anomaly' (Tracer.event's first
            # positional is already called kind).
            events.append((
                "fleet_anomaly",
                f"{target}: {kind} breached its baseline (z={z:.1f})"
                if kind != "freshness" else
                f"{target}: missed {int(z)} refreshes running",
                {"target": target, "anomaly": kind, "z": round(z, 3)}))
        elif z is None and active:
            del state.anomalous[kind]
            events.append((
                "fleet_recovered",
                f"{target}: {kind} back within baseline",
                {"target": target, "anomaly": kind}))

    def _attribute(self, targets: Sequence[str]) -> None:
        """Cross-node slow-node attribution: the worst slowest-tick
        digest across the fleet (lock held)."""
        worst: dict | None = None
        for target in targets:
            state = self._targets.get(target)
            if state is None:
                continue
            if state.missed >= self.miss_threshold:
                # A dead target's frozen pre-crash digest must not pin
                # fleet attribution forever while live nodes' rings age
                # their own maxima out — its unreachability is already
                # the louder signal (freshness anomaly + burn).
                continue
            slow = state.digest.get("slowest") if state.digest else None
            if slow and (worst is None
                         or slow["seconds"] > worst["seconds"]):
                worst = {"target": target, "seconds": slow["seconds"],
                         "phase": slow.get("phase", ""),
                         "blame": slow.get("blame", "")}
        self._worst = worst

    def _journal(self, events: list) -> None:
        hook = self.arm_hook
        for kind, detail, attrs in events:
            if self._tracer is not None:
                self._tracer.event(kind, detail, **attrs)
            if (hook is not None and kind == "fleet_anomaly"
                    and attrs.get("anomaly") in ("power", "duty",
                                                 "power_burst")):
                try:
                    hook(attrs.get("target", ""), attrs["anomaly"],
                         attrs.get("z"))
                except Exception:  # noqa: BLE001 - observer must not
                    # kill the refresh that raised the anomaly.
                    pass

    def evict(self, alive: set) -> None:
        """Drop state for departed targets (the hub's target-churn
        eviction path — discovered pod churn must not grow baselines or
        counter state forever). Cumulative anomaly counts go with the
        target: their series leave the exposition like every other
        per-target family."""
        with self._lock:
            for target in [t for t in self._targets if t not in alive]:
                del self._targets[target]
            for key in [k for k in self._anomalies_total
                        if k[0] not in alive]:
                del self._anomalies_total[key]
            if self._worst is not None and \
                    self._worst["target"] not in alive:
                self._worst = None

    # -- export (refresh thread) ---------------------------------------------

    def contribute(self, builder) -> None:
        """Fold the kts_fleet_* families into a snapshot."""
        with self._lock:
            anomalous = sum(1 for s in self._targets.values()
                            if s.anomalous)
            totals = sorted(self._anomalies_total.items())
            fresh = self._freshness.window_state(self._last_now,
                                                 self._windows)
            straggler = self._straggler.window_state(self._last_now,
                                                     self._windows)
            worst = dict(self._worst) if self._worst else None
            link_count = self.links.link_count()
            link_rows = self.links.rows()
            link_baselines = self.links.baseline_rows()
        builder.add(schema.FLEET_TARGETS_ANOMALOUS, float(anomalous))
        for (target, kind), count in totals:
            builder.add(schema.FLEET_ANOMALIES, float(count),
                        (("target", target), ("kind", kind)))
        for objective, state in (("freshness", fresh),
                                 ("straggler", straggler)):
            for _, label in self._windows:
                window = state[label]
                labels = (("objective", objective), ("window", label))
                builder.add(schema.FLEET_SLO_BURN,
                            window["burn_rate"], labels)
                builder.add(schema.FLEET_SLO_BAD,
                            window["bad_ratio"], labels)
        if worst is not None:
            builder.add(schema.FLEET_WORST_TICK, worst["seconds"],
                        (("target", worst["target"]),
                         ("phase", worst["phase"])))
        builder.add(schema.FLEET_LINKS, float(link_count))
        for link, reason, value in link_rows:
            # Cleared/superseded identities keep exporting 0.0
            # (series continuity: history nearest-sample reads must
            # see the recovery, not a frozen accusation).
            builder.add(schema.FLEET_LINK_SUSPECT, value,
                        (("link", link), ("reason", reason)))
        for link, baseline, band, observed in link_baselines:
            labels = (("link", link),)
            builder.add(schema.FLEET_LINK_BASELINE_BPS, baseline, labels)
            builder.add(schema.FLEET_LINK_BASELINE_BAND, band, labels)
            builder.add(schema.FLEET_LINK_OBSERVED_BPS, observed, labels)
        if self.efficiency is not None:
            # Engine state is single-writer (this thread) but read by
            # HTTP rollup threads, so the fold runs under the lock too.
            with self._lock:
                self.efficiency.contribute(builder)

    def link_history_rows(self) -> list[tuple[str, str, float]]:
        """(link, reason, value) suspect rows for the hub's history
        ring — recorded every publish so `doctor --fleet --at` can
        localize retroactively (1.0 while accused, 0.0 tombstones
        after)."""
        with self._lock:
            return self.links.rows()

    def waste_history_rows(self) -> list[tuple[str, str, str, float]]:
        """(pod, namespace, reason, value) waste rows for the hub's
        history ring — recorded every publish so `doctor --efficiency
        --at` answers "who was wasting cards during the incident"
        retroactively (1.0 while accused, 0.0 tombstones after)."""
        if self.efficiency is None:
            return []
        with self._lock:
            return self.efficiency.rows()

    def efficiency_summary(self) -> dict:
        """The efficiency engine's waste ledger (for the attestation
        fold and /debug/fleet). {"enabled": False} under
        --no-efficiency."""
        if self.efficiency is None:
            return {"enabled": False}
        with self._lock:
            return self.efficiency.summary()

    # -- read side (HTTP threads) --------------------------------------------

    def rollup(self) -> dict:
        """The /debug/fleet payload: per-target health, the anomaly
        ring, SLO burn state, and slow-node attribution — everything
        doctor --fleet needs in one fetch."""
        with self._lock:
            targets = {}
            for target in sorted(self._targets):
                state = self._targets[target]
                entry: dict = {
                    "up": state.missed == 0,
                    "missed": state.missed,
                    "last_seen_seq": state.last_seen_seq,
                    "chips": state.chips,
                    "signals": {
                        name: {
                            "value": round(state.last_signals[name], 6),
                            "mean": round(
                                state.baselines[name].mean, 6)
                            if name in state.baselines else None,
                            "z": state.last_z.get(name, 0.0),
                        }
                        for name in sorted(state.last_signals)
                    },
                    # CURRENT severity per latched kind (live z, or the
                    # live missed count for freshness) — the raise-edge
                    # value would understate a worsening incident for
                    # as long as it stays latched.
                    "anomalous": {
                        kind: (float(state.missed)
                               if kind == "freshness"
                               else state.last_z.get(kind, z))
                        for kind, z in sorted(state.anomalous.items())
                    },
                }
                if state.digest:
                    entry["digest"] = state.digest
                targets[target] = entry
            payload = {
                "enabled": True,
                "seq": self._last_seq,
                "generated_at": self._last_now,
                "targets": targets,
                "anomalies": list(self._recent),
                "slo": {
                    "freshness": {
                        "target": self._freshness.target,
                        "windows": self._freshness.window_state(
                            self._last_now, self._windows),
                    },
                    "straggler": {
                        "target": self._straggler.target,
                        "ratio_min": self.straggler_ratio_min,
                        "windows": self._straggler.window_state(
                            self._last_now, self._windows),
                    },
                },
                "attribution": dict(self._worst) if self._worst else None,
                "links": self.links.summary(),
                "efficiency": (self.efficiency.summary()
                               if self.efficiency is not None
                               else {"enabled": False}),
            }
        return payload
