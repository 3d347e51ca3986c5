"""Fleet efficiency lens: who is wasting cards.

The port's copy of the reference's efficiency lens. The pipeline
collects duty, power, memory, step rate and per-pod energy fleet-wide,
but none of it answers the fleet owner's question: which pod is holding
H100s it is not using? This module is the hub's cross-node scoring pass:

- **Per-pod scores** — each refresh folds every pod's card evidence
  (mean duty, summed power, step rate, cards held) plus the per-pod
  joules/coverage harvested from its node's signed energy families into
  EWMA baselines (the :class:`fleetlens.EwmaBaseline` discipline, so
  scores are deterministic under seeded inputs), and derives
  goodput-per-watt (steps per joule) and goodput-per-card-hour alongside
  a [0, 1] efficiency score.
- **Waste verdicts** — *idle-reservation* (cards held with duty ~0 for
  ``idle_refreshes`` consecutive refreshes, gated behind a
  ``warmup_refreshes`` grace so a legitimately-starting pod is never
  accused while its model loads) and *low-goodput* (power drawn, duty
  up, step counter flat). Verdicts are hysteretic (a clear streak must
  complete) and edge-journaled (``fleet_waste`` /
  ``fleet_waste_cleared`` naming the pod), exported as
  ``kts_fleet_waste_*`` with 0.0 tombstones for history reads, and
  bounded to a top-K ranking so a big fleet can't label-bomb the hub's
  own exposition.
- **UNKNOWN is not waste** — a pod with no duty evidence and zero
  energy coverage (collector degraded, burst disarmed) scores UNKNOWN:
  counted, never ranked, never accused. A degraded telemetry store
  must not page a healthy tenant.
- **Signed attestation** — :func:`build_attestation` folds the leaves'
  ``/debug/energy`` governance digests (verbatim, their HMACs intact)
  plus this hub's waste ledger into one canonical-JSON HMAC-signed
  payload, served at ``/debug/efficiency`` and verified by
  ``doctor --efficiency`` (OK verified, FAIL on tamper or wrong key,
  WARN unsigned).

The exported names keep the reference's "chip" wording (the
``kts_fleet_waste_chips`` family, the journal's detail lines), so a
dashboard or alert reads both packages alike.

Single-writer: :meth:`EfficiencyLens.observe` runs under the FleetLens
lock on the hub's refresh thread; the read accessors return copies.
"""

from __future__ import annotations

from typing import Mapping

from . import energy as energy_mod
from . import schema

ATTESTATION_VERSION = 1

# Verdict knobs (config.add_efficiency_flags re-exports these as the
# shared flag surface). A pod must be seen WARMUP_REFRESHES refreshes
# before any verdict may form (model loading / compilation legitimately
# idles the chips), then hold the waste condition IDLE_REFRESHES
# consecutive refreshes to raise, and stay healthy CLEAR_REFRESHES to
# clear — one busy refresh mid-incident must not flap the journal.
DEFAULT_WARMUP_REFRESHES = 12
DEFAULT_IDLE_REFRESHES = 6
CLEAR_REFRESHES = 2

# Duty points at or below which a chip-holding pod counts as idle (the
# fake-idle floor: a truly parked card still jitters fractions of a
# point), and the step rate below which a step counter reads "flat".
DEFAULT_IDLE_DUTY = 1.0
STEP_FLAT_EPS = 1e-3

# Top-K bound on the per-pod kts_fleet_efficiency_* / kts_fleet_waste_
# chips exports: ranking, not census — the full ledger rides
# /debug/fleet.
DEFAULT_TOP_K = 10

# EWMA weight for the per-pod signal smoothing (the fleetlens alpha).
SCORE_ALPHA = 0.2


class _PodState:
    """Everything the lens remembers about one (pod, namespace)."""

    __slots__ = ("seen", "chips", "duty", "power", "steps",
                 "idle_streak", "flat_streak", "clear_streak",
                 "verdict", "verdict_since", "last_joules",
                 "joules_rate", "coverage", "unknown", "last_seen_seq",
                 "last_duty", "last_power", "last_steps")

    def __init__(self) -> None:
        from .fleetlens import EwmaBaseline

        self.seen = 0              # refreshes with any evidence
        self.chips = 0
        self.duty = EwmaBaseline()
        self.power = EwmaBaseline()
        self.steps = EwmaBaseline()
        self.idle_streak = 0       # consecutive idle-reservation shape
        self.flat_streak = 0       # consecutive low-goodput shape
        self.clear_streak = 0      # consecutive healthy refreshes
        self.verdict: str | None = None
        self.verdict_since = 0.0
        self.last_joules: float | None = None  # cumulative, from digest
        self.joules_rate = 0.0     # J/s over the last refresh interval
        self.coverage = 0.0
        self.unknown = False
        self.last_seen_seq = 0
        self.last_duty: float | None = None
        self.last_power: float | None = None
        self.last_steps: float | None = None


class EfficiencyLens:
    """Per-pod waste scoring over the hub's per-refresh pod evidence.

    Driven by :meth:`observe` under the FleetLens lock (the linkloc
    sub-engine pattern); everything is exact arithmetic over injected
    timestamps, no wall-clock reads, no randomness."""

    def __init__(self, *,
                 warmup_refreshes: int = DEFAULT_WARMUP_REFRESHES,
                 idle_refreshes: int = DEFAULT_IDLE_REFRESHES,
                 idle_duty: float = DEFAULT_IDLE_DUTY,
                 top_k: int = DEFAULT_TOP_K,
                 clear_refreshes: int = CLEAR_REFRESHES,
                 alpha: float = SCORE_ALPHA) -> None:
        self.warmup_refreshes = max(1, warmup_refreshes)
        self.idle_refreshes = max(1, idle_refreshes)
        self.idle_duty = idle_duty
        self.top_k = max(1, top_k)
        self.clear_refreshes = max(1, clear_refreshes)
        self.alpha = alpha
        self._pods: dict[tuple[str, str], _PodState] = {}
        # Every (pod, ns, reason) identity ever raised: cleared verdicts
        # keep exporting 0.0 tombstones (series continuity — history
        # nearest-sample reads must see the recovery, not a frozen
        # accusation).
        self._known_reasons: dict[tuple[str, str], set] = {}
        self._waste_raised_total = 0
        self._last_seq = 0
        self._last_now = 0.0

    # -- scoring (refresh thread, FleetLens lock held) -----------------------

    def observe(self, seq: int, now: float,
                pods: Mapping[tuple[str, str], dict]
                ) -> list[tuple[str, str, dict]]:
        """Score one refresh. ``pods`` maps (pod, namespace) -> evidence:
        ``duty`` (mean duty points over the pod's chips, None when no
        chip reported one), ``power`` (summed watts, None likewise),
        ``steps`` (summed steps/s, None when the pod exports no step
        counter), ``chips`` (chips held), ``joules`` (cumulative
        attributed joules from the node's energy digest, None when the
        node exports none), ``coverage`` (the node's energy coverage
        ratio). Returns journal events for the caller to emit outside
        its lock; prunes state for pods absent this refresh only after
        their verdict clears through the normal path."""
        self._last_seq = seq
        dt = now - self._last_now if self._last_now else 0.0
        self._last_now = now
        events: list[tuple[str, str, dict]] = []
        for key in sorted(pods):
            evidence = pods[key]
            state = self._pods.get(key)
            if state is None:
                state = self._pods[key] = _PodState()
            state.seen += 1
            state.last_seen_seq = seq
            state.chips = int(evidence.get("chips") or 0) or state.chips
            duty = evidence.get("duty")
            power = evidence.get("power")
            steps = evidence.get("steps")
            joules = evidence.get("joules")
            state.coverage = float(evidence.get("coverage") or 0.0)
            state.last_duty = duty
            state.last_power = power
            state.last_steps = steps
            if duty is not None:
                state.duty.fold(duty, self.alpha)
            if power is not None:
                state.power.fold(power, self.alpha)
            if steps is not None:
                state.steps.fold(steps, self.alpha)
            if joules is not None:
                if state.last_joules is not None and dt > 0:
                    delta = joules - state.last_joules
                    if delta >= 0:  # counter reset = skip the interval
                        state.joules_rate = delta / dt
                state.last_joules = joules
            # UNKNOWN gate (the zero-coverage bugfix): with no duty
            # evidence from any chip AND no energy coverage there is
            # nothing to distinguish "idle" from "blind collector" —
            # refuse to score rather than default to maximally-wasteful.
            state.unknown = duty is None and state.coverage <= 0.0
            if state.unknown:
                state.idle_streak = 0
                state.flat_streak = 0
                continue
            idle = (duty is not None and duty <= self.idle_duty
                    and (steps is None or steps <= STEP_FLAT_EPS))
            # Low-goodput needs a step counter to be FLAT (not merely
            # absent): power drawn and duty up while the workload makes
            # no progress. An absent counter is unknowable, not flat.
            flat = (steps is not None and steps <= STEP_FLAT_EPS
                    and duty is not None and duty > self.idle_duty
                    and power is not None and power > 0.0)
            state.idle_streak = state.idle_streak + 1 if idle else 0
            state.flat_streak = state.flat_streak + 1 if flat else 0
            warm = state.seen > self.warmup_refreshes
            reason = None
            if warm and state.idle_streak >= self.idle_refreshes:
                reason = "idle-reservation"
            elif warm and state.flat_streak >= self.idle_refreshes:
                reason = "low-goodput"
            if reason is not None:
                state.clear_streak = 0
                if state.verdict is None:
                    state.verdict = reason
                    state.verdict_since = now
                    self._waste_raised_total += 1
                    self._known_reasons.setdefault(key, set()).add(reason)
                    pod, namespace = key
                    streak = (state.idle_streak
                              if reason == "idle-reservation"
                              else state.flat_streak)
                    events.append((
                        "fleet_waste",
                        f"{namespace}/{pod}: {reason} — holding "
                        f"{state.chips} chip(s) with duty "
                        f"{duty if duty is not None else 0.0:.1f} for "
                        f"{streak} refreshes",
                        {"pod": pod, "namespace": namespace,
                         "reason": reason, "chips": state.chips}))
                elif state.verdict != reason:
                    # Verdict shape changed mid-incident (idle pod
                    # started drawing power without stepping): track it
                    # under the new reason, tombstone the old.
                    state.verdict = reason
                    self._known_reasons.setdefault(key, set()).add(reason)
            elif not idle and not flat:
                state.clear_streak += 1
                if (state.verdict is not None
                        and state.clear_streak >= self.clear_refreshes):
                    pod, namespace = key
                    events.append((
                        "fleet_waste_cleared",
                        f"{namespace}/{pod}: {state.verdict} cleared — "
                        f"chips back in use",
                        {"pod": pod, "namespace": namespace,
                         "reason": state.verdict}))
                    state.verdict = None
            # else: in the hysteresis band — latch the current state.
        # Departed pods (job ended, chips released): an active verdict
        # clears with the pod — held chips were returned, which IS the
        # recovery — and the tombstone rows keep history reads clean.
        for key in [k for k in self._pods if k not in pods]:
            state = self._pods[key]
            if state.verdict is not None:
                pod, namespace = key
                events.append((
                    "fleet_waste_cleared",
                    f"{namespace}/{pod}: {state.verdict} cleared — pod "
                    f"departed, chips released",
                    {"pod": pod, "namespace": namespace,
                     "reason": state.verdict}))
            del self._pods[key]
        return events

    # -- derived scores (lock held by caller) --------------------------------

    def _score(self, state: _PodState) -> float | None:
        """[0, 1] efficiency score, None while UNKNOWN. Duty fraction
        is the base (the card earning its reservation); a present step
        counter scales it by progress so a busy-looking-but-stuck pod
        scores low too."""
        if state.unknown or state.duty.count == 0:
            return None
        score = min(1.0, max(0.0, state.duty.mean / 100.0))
        if state.steps.count:
            s = max(0.0, state.steps.mean)
            # Saturating progress factor: ~0 when the counter is flat,
            # ->1 once the pod sustains a step per second.
            score *= s / (s + 1.0) if s > 0 else 0.0
        return score

    def _steps_per_joule(self, state: _PodState) -> float | None:
        if state.steps.count == 0:
            return None
        watts = (state.power.mean if state.power.count else
                 (state.joules_rate or None))
        if not watts or watts <= 0:
            return None
        return max(0.0, state.steps.mean) / watts

    def _steps_per_chip_hour(self, state: _PodState) -> float | None:
        if state.steps.count == 0 or not state.chips:
            return None
        return max(0.0, state.steps.mean) * 3600.0 / state.chips

    def _ranked(self) -> list[tuple[tuple[str, str], _PodState, float]]:
        """Scoreable pods by wasted chips, descending, deterministic
        tie-break on the pod key. UNKNOWN pods never rank."""
        rows = []
        for key, state in self._pods.items():
            score = self._score(state)
            if score is None:
                continue
            waste = (1.0 - score) * max(state.chips, 1)
            rows.append((key, state, waste))
        rows.sort(key=lambda r: (-r[2], r[0]))
        return rows

    # -- export (refresh thread, lock held by FleetLens) ---------------------

    def contribute(self, builder) -> None:
        """Fold the kts_fleet_efficiency_* / kts_fleet_waste_* families
        into a snapshot. Per-pod series are bounded to the top-K."""
        unknown = sum(1 for s in self._pods.values() if s.unknown)
        active = sum(1 for s in self._pods.values()
                     if s.verdict is not None)
        builder.add(schema.FLEET_EFFICIENCY_UNKNOWN, float(unknown))
        builder.add(schema.FLEET_WASTE_PODS, float(active))
        for (pod, namespace), state, waste in self._ranked()[:self.top_k]:
            labels = (("pod", pod), ("namespace", namespace))
            score = self._score(state)
            if score is not None:
                builder.add(schema.FLEET_EFFICIENCY_SCORE, round(score, 6),
                            labels)
            builder.add(schema.FLEET_WASTE_CHIPS, round(waste, 6), labels)
            spj = self._steps_per_joule(state)
            if spj is not None:
                builder.add(schema.FLEET_EFFICIENCY_STEPS_PER_JOULE,
                            round(spj, 9), labels)
            spch = self._steps_per_chip_hour(state)
            if spch is not None:
                builder.add(schema.FLEET_EFFICIENCY_STEPS_PER_CHIP_HOUR,
                            round(spch, 6), labels)
        for pod, namespace, reason, value in self.rows():
            builder.add(schema.FLEET_WASTE_SUSPECT, value,
                        (("pod", pod), ("namespace", namespace),
                         ("reason", reason)))

    def rows(self) -> list[tuple[str, str, str, float]]:
        """(pod, namespace, reason, value) for every identity ever
        raised: 1.0 while that reason is the pod's active verdict, 0.0
        otherwise — the tombstone discipline history nearest-sample
        reads rely on."""
        out: list[tuple[str, str, str, float]] = []
        for key in sorted(self._known_reasons):
            state = self._pods.get(key)
            active = state.verdict if state is not None else None
            for reason in sorted(self._known_reasons[key]):
                out.append((key[0], key[1], reason,
                            1.0 if reason == active else 0.0))
        return out

    def summary(self) -> dict:
        """The /debug/fleet ``efficiency`` block and the attestation's
        waste ledger (copies; caller holds the FleetLens lock)."""
        suspects = {}
        pods = {}
        for key in sorted(self._pods):
            state = self._pods[key]
            name = f"{key[1]}/{key[0]}"
            score = self._score(state)
            entry = {
                "chips": state.chips,
                "seen": state.seen,
                "warm": state.seen > self.warmup_refreshes,
                "unknown": state.unknown,
                "score": round(score, 6) if score is not None else None,
                "duty": (round(state.duty.mean, 3)
                         if state.duty.count else None),
                "power_watts": (round(state.power.mean, 3)
                                if state.power.count else None),
                "steps_per_s": (round(state.steps.mean, 6)
                                if state.steps.count else None),
                "joules_total": state.last_joules,
                "coverage_ratio": round(state.coverage, 6),
            }
            spj = self._steps_per_joule(state)
            if spj is not None:
                entry["steps_per_joule"] = round(spj, 9)
            spch = self._steps_per_chip_hour(state)
            if spch is not None:
                entry["steps_per_chip_hour"] = round(spch, 6)
            pods[name] = entry
            if state.verdict is not None:
                suspects[name] = {
                    "reason": state.verdict,
                    "since": state.verdict_since,
                    "chips": state.chips,
                    "duty": (round(state.duty.mean, 3)
                             if state.duty.count else None),
                }
        ranking = [
            {"pod": key[0], "namespace": key[1],
             "wasted_chips": round(waste, 6),
             "score": round(self._score(state) or 0.0, 6)}
            for key, state, waste in self._ranked()[:self.top_k]
        ]
        return {
            "enabled": True,
            "seq": self._last_seq,
            "generated_at": self._last_now,
            "pods": pods,
            "suspects": suspects,
            "top_waste": ranking,
            "unknown_pods": sum(1 for s in self._pods.values()
                                if s.unknown),
            "waste_raised_total": self._waste_raised_total,
            "knobs": {
                "warmup_refreshes": self.warmup_refreshes,
                "idle_refreshes": self.idle_refreshes,
                "idle_duty": self.idle_duty,
                "top_k": self.top_k,
            },
        }

    def suspects(self) -> dict[str, dict]:
        return {f"{key[1]}/{key[0]}": {"reason": state.verdict,
                                       "chips": state.chips,
                                       "since": state.verdict_since}
                for key, state in sorted(self._pods.items())
                if state.verdict is not None}


def build_attestation(waste_summary: dict, leaves: Mapping[str, dict],
                      audit_key: str, *, node: str = "",
                      generated_at: float = 0.0,
                      targets_total: int | None = None) -> dict:
    """The federation-wide energy/waste rollup served at
    /debug/efficiency: the leaves' /debug/energy governance digests
    verbatim (their own HMACs intact, so per-leaf attestations stay
    independently verifiable), folded totals, and this hub's waste
    ledger — canonical-JSON HMAC-signed with the hub-side audit key
    (energy.sign_payload: the same signing contract `doctor --energy`
    already verifies). ``leaves`` maps target identity -> digest dict
    (or an {"error": ...} stub for an unreadable leaf)."""
    total_joules = 0.0
    pod_totals = 0
    coverage_values = []
    leaves_signed = 0
    for digest in leaves.values():
        if not isinstance(digest, dict) or "error" in digest:
            continue
        for row in digest.get("per_pod") or []:
            if len(row) >= 3:
                try:
                    total_joules += float(row[2])
                    pod_totals += 1
                except (TypeError, ValueError):
                    continue
        if "coverage_ratio" in digest:
            coverage_values.append(float(digest["coverage_ratio"]))
        if digest.get("signed"):
            leaves_signed += 1
    payload: dict = {
        "version": ATTESTATION_VERSION,
        "role": "hub",
        "node": node,
        "generated_at": generated_at,
        "leaves": {target: dict(digest)
                   for target, digest in sorted(leaves.items())},
        "totals": {
            "joules": round(total_joules, 6),
            "pod_totals": pod_totals,
            "leaves": len(leaves),
            "leaves_signed": leaves_signed,
            # A truncated fold (fan-out cap) is attested, not silent.
            "targets_total": (targets_total if targets_total is not None
                              else len(leaves)),
            "coverage_min": (round(min(coverage_values), 6)
                             if coverage_values else None),
        },
        "waste": {
            "suspects": waste_summary.get("suspects", {}),
            "top_waste": waste_summary.get("top_waste", []),
            "unknown_pods": waste_summary.get("unknown_pods", 0),
            "waste_raised_total": waste_summary.get(
                "waste_raised_total", 0),
        },
        "enabled": True,
        "signed": bool(audit_key),
    }
    if audit_key:
        payload["hmac"] = energy_mod.sign_payload(payload, audit_key)
    return payload
