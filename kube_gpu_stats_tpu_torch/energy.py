"""Audit-grade energy accounting: per-pod joules, a write-ahead
checkpoint, and a signed digest.

The port's copy of the reference's ``energy.py``; its checkpoint and
digest formats are the reference's, so a checkpoint written by one
package loads in the other and each verifies the other's digest.

``accelerator_energy_joules_total`` answers "how much energy has this
card drawn since the exporter started" — good enough for dashboards,
useless for a bill or an attestation: it resets on every restart, it
integrates tick rectangles over transients the gauge never saw, and
nothing signs it. This module is the missing half:

- **Per-pod joules** — each tick's per-device energy delta is
  attributed to the pod the kubelet mapping names at that moment and
  accumulated per (pod, namespace) (``kts_energy_pod_joules_total``).
  Integration is trapezoidal over the burst sampler's sub-tick samples
  when a window is armed (the transient's true area), rectangle over
  the tick gauge otherwise; the fraction of integrated time that rode
  burst samples exports as ``kts_energy_coverage_ratio`` — an auditor
  can see exactly how much of a bill is high-fidelity.
- **Write-ahead checkpoint** — totals persist via write-to-``.wal`` +
  fsync + atomic rename (``wal.write_state``) on a configurable
  cadence, and a restarting daemon replays them, so the counters are
  monotone across restarts (Prometheus ``increase()`` never sees a
  phantom reset, and a bill never loses a partial day).
- **Governance digest** — ``/debug/energy`` serves a snapshot of the
  per-pod totals + coverage, HMAC-SHA256-signed with ``--energy-audit-
  key`` over a canonical JSON encoding; ``doctor --energy`` re-derives
  the MAC and fails loudly on a tampered payload. The key never rides
  the wire — both ends hold it out of band.

Single-writer discipline: every mutating method runs on the poll
thread; :meth:`digest`/:meth:`status` snapshot under the small lock for
HTTP handler threads.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import logging
import threading
import time
from typing import Callable, Sequence

from . import schema, wal

log = logging.getLogger(__name__)

CHECKPOINT_VERSION = 1
# The most a checkpoint's per-pod joules, rounded to nearest at 6
# decimals, sit below the value they were written from (plus a margin
# for the double's own rounding).
_ROUNDING_PAD = 5e-7 + 1e-9

# A burst-sample gap wider than this is not "covered" by the burst
# window (the sampler was disarmed / the device unreadable mid-window):
# the segment still integrates, it just doesn't count as high-fidelity.
DEFAULT_COVER_GAP = 0.1


def canonical_payload(payload: dict) -> bytes:
    """The byte string the digest MAC covers: the payload minus its own
    ``hmac`` field, canonically encoded (sorted keys, no whitespace) so
    signer and verifier can never disagree on serialization."""
    body = {k: v for k, v in payload.items() if k != "hmac"}
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()


def sign_payload(payload: dict, key: str) -> str:
    return hmac_mod.new(key.encode(), canonical_payload(payload),
                        hashlib.sha256).hexdigest()


def verify_payload(payload: dict, key: str) -> bool:
    """True when the payload's hmac field matches the key (constant-
    time compare). A payload with no hmac never verifies."""
    mac = payload.get("hmac")
    if not isinstance(mac, str) or not mac:
        return False
    return hmac_mod.compare_digest(sign_payload(payload, key), mac)


class EnergyAccountant:
    """Per-pod joules integration + checkpoint + signed digest."""

    def __init__(self, *, checkpoint_path: str = "",
                 checkpoint_interval: float = 10.0,
                 audit_key: str = "", node: str = "",
                 max_gap: float = 10.0,
                 cover_gap: float = DEFAULT_COVER_GAP,
                 wall: Callable[[], float] = time.time) -> None:
        self._path = checkpoint_path
        self._interval = checkpoint_interval
        self._audit_key = audit_key
        self._node = node
        # Longest single segment the integrator will fund: after an
        # outage, integrating the whole gap at the newest power reading
        # would fabricate energy the card may not have drawn (same cap
        # as poll.py's per-device rectangle).
        self._max_gap = max_gap
        self._cover_gap = cover_gap
        self._wall = wall
        self._lock = threading.Lock()
        # Serializes whole checkpoint passes: the poll loop submits
        # rate-limited writes to its pool, and Daemon.stop forces a
        # final one on the main thread AFTER the pool is shut down
        # without waiting — a write still in flight there must not
        # interleave its truncate/fsync/rename with the forced one
        # (two writers on one .wal can publish a torn main file, losing
        # exactly the monotone-across-restarts guarantee).
        self._io_lock = threading.Lock()
        # (pod, namespace) -> joules. "" keys = unattributed draw.
        self._per_pod: dict[tuple[str, str], float] = {}
        # (pod, namespace) -> the least joules served for a pod replayed
        # from a checkpoint: what it was written as plus half a
        # micro-joule. The checkpoint rounds to nearest at 6 decimals,
        # so the value last served before the restart can sit up to
        # that much above the replayed one, and a counter served below
        # its last scrape is a reset to Prometheus.
        self._served_floor: dict[tuple[str, str], float] = {}
        # device_id -> (t, watts): the newest integrated point.
        self._last: dict[str, tuple[float, float]] = {}
        self.covered_seconds = 0.0
        self.total_seconds = 0.0
        self.burst_samples_used = 0
        self.ticks_observed = 0
        self.checkpoint_writes = 0
        self.checkpoint_loaded = False
        self._last_write = 0.0
        self._dirty = False
        self._seq = 0
        if checkpoint_path:
            self._load()

    # -- integration (poll thread) --------------------------------------------

    def observe(self, device_id: str, pod: str, namespace: str,
                now: float, watts: float | None,
                samples: Sequence[tuple] = ()) -> float:
        """Fold one device-tick: ``watts`` is the tick gauge reading
        (None on a stale tick that observed no power), ``samples`` the
        burst drain for the gap, (t, watts) pairs on the same clock as
        ``now``. Returns the joules this call added (tests)."""
        points: list[tuple[float, float]] = []
        last = self._last.get(device_id)
        if last is not None:
            points.append(last)
        horizon = last[0] if last is not None else float("-inf")
        burst_used = 0
        # Same integrand guard as poll.py's rectangle path: one NaN or
        # inf sample must not poison the per-pod += forever (and the
        # checkpoint's JSON with it).
        for t, w in samples:
            if t > horizon and t <= now and 0.0 <= w < float("inf"):
                points.append((t, w))
                horizon = t
                burst_used += 1
        if (watts is not None and 0.0 <= watts < float("inf")
                and now > horizon):
            points.append((now, watts))
        if len(points) < 2:
            # First sight of this device (or nothing new): anchor only.
            if points:
                self._last[device_id] = points[-1]
            return 0.0
        joules = covered = total = 0.0
        for (t0, w0), (t1, w1) in zip(points, points[1:]):
            dt = t1 - t0
            if dt <= 0:
                continue
            capped = min(dt, self._max_gap)
            joules += (w0 + w1) / 2.0 * capped
            total += capped
            if dt <= self._cover_gap:
                covered += dt
        self._last[device_id] = points[-1]
        with self._lock:
            key = (pod, namespace)
            self._per_pod[key] = self._per_pod.get(key, 0.0) + joules
            self.covered_seconds += covered
            self.total_seconds += total
            self.burst_samples_used += burst_used
            self.ticks_observed += 1
            self._seq += 1
            self._dirty = True
        return joules

    def forget_device(self, device_id: str) -> None:
        """Drop a departed device's anchor point (rediscovery): a
        renumbered card must not integrate against another card's last
        reading. Accumulated pod totals stay — energy already drawn
        was drawn."""
        self._last.pop(device_id, None)

    # -- persistence ----------------------------------------------------------

    @property
    def coverage_ratio(self) -> float:
        return (self.covered_seconds / self.total_seconds
                if self.total_seconds > 0 else 0.0)

    def _state(self) -> dict:
        return {
            "version": CHECKPOINT_VERSION,
            "node": self._node,
            "wall": self._wall(),
            "seq": self._seq,
            "per_pod": [
                [pod, namespace, round(joules, 6)]
                for (pod, namespace), joules in sorted(self._per_pod.items())
            ],
            "covered_seconds": round(self.covered_seconds, 6),
            "total_seconds": round(self.total_seconds, 6),
            "burst_samples_used": self.burst_samples_used,
            "ticks_observed": self.ticks_observed,
        }

    def _load(self) -> None:
        # Both candidates, newest seq wins (the shared wal.py recovery
        # rule): a crash between the wal's fsync and the rename leaves
        # the NEWER state in the .wal behind an older (or absent) main —
        # loading main alone would restart counters below values
        # Prometheus already scraped, exactly the phantom-reset the
        # write-ahead discipline exists to prevent.
        state = wal.load_newest(self._path, CHECKPOINT_VERSION,
                                label="energy")
        if state is None:
            return
        # Pruned-keys tolerance: an older build
        # wrote fewer keys and shorter per_pod records — default and
        # warn, never a KeyError/ValueError on the restart path (a
        # crash-loop here would cost exactly the monotone-across-
        # restarts guarantee the checkpoint exists for).
        missing = [key for key in ("per_pod", "covered_seconds",
                                   "total_seconds")
                   if key not in state]
        if missing:
            log.warning("energy checkpoint missing %s (older build?); "
                        "defaulting", ", ".join(missing))
        for record in state.get("per_pod", ()):
            if len(record) < 3:
                log.warning("energy checkpoint per_pod record %r too "
                            "short; skipping", record)
                continue
            pod, namespace, joules = record[:3]
            self._per_pod[(str(pod), str(namespace))] = float(joules)
            self._served_floor[(str(pod), str(namespace))] = \
                float(joules) + _ROUNDING_PAD
        self.covered_seconds = float(state.get("covered_seconds", 0.0))
        self.total_seconds = float(state.get("total_seconds", 0.0))
        self.burst_samples_used = int(state.get("burst_samples_used", 0))
        self.ticks_observed = int(state.get("ticks_observed", 0))
        self._seq = int(state.get("seq", 0))
        self.checkpoint_loaded = True
        log.info("energy checkpoint replayed: %d pod totals, seq %d",
                 len(self._per_pod), self._seq)

    def checkpoint(self, force: bool = False) -> bool:
        """Write-ahead persist: full state to ``<path>.wal``, fsync,
        atomic rename over ``<path>``. Rate-limited to the checkpoint
        interval unless forced (daemon stop forces a final write so the
        last partial interval is never lost)."""
        if not self._path:
            return False
        with self._io_lock:
            now = self._wall()
            if not force and (not self._dirty
                              or now - self._last_write < self._interval):
                return False
            with self._lock:
                state = self._state()
                self._dirty = False
            # Shared write-ahead discipline (wal.py): .wal + fsync +
            # atomic rename, one implementation for every checkpoint.
            if not wal.write_state(self._path, state, label="energy"):
                self._dirty = True
                return False
            self._last_write = now
            self.checkpoint_writes += 1
            return True

    # -- export ---------------------------------------------------------------

    def contribute(self, builder) -> None:
        """Fold the kts_energy_* families into a snapshot (poll
        thread). Counters are unconditional-from-zero so increase()
        alerting works from the first scrape."""
        with self._lock:
            totals = sorted(
                (key, max(joules, self._served_floor.get(key, joules)))
                for key, joules in self._per_pod.items())
            ratio = self.coverage_ratio
        for (pod, namespace), joules in totals:
            builder.add(schema.ENERGY_POD, joules,
                        (("pod", pod), ("namespace", namespace)))
        builder.add(schema.ENERGY_COVERAGE, ratio)
        builder.add(schema.ENERGY_CHECKPOINT_WRITES,
                    float(self.checkpoint_writes))
        if self._path and self._last_write:
            builder.add(schema.ENERGY_CHECKPOINT_AGE,
                        max(0.0, self._wall() - self._last_write))

    # -- read side (/debug/energy, doctor --energy) ---------------------------

    def digest(self) -> dict:
        """The governance digest: per-pod totals + coverage, signed
        with the audit key when one is configured. ``signed`` says
        which case the reader is in — an unsigned digest is still
        useful telemetry, it just attests nothing."""
        with self._lock:
            payload = self._state()
        payload["coverage_ratio"] = round(self.coverage_ratio, 6)
        payload["signed"] = bool(self._audit_key)
        if self._audit_key:
            payload["hmac"] = sign_payload(payload, self._audit_key)
        return payload

    def status(self) -> dict:
        """Checkpoint/attribution health for debugging (rides the
        digest endpoint's payload via digest(); kept separate so tests
        can assert on internals without a signature in the way)."""
        with self._lock:
            return {
                "pods": len(self._per_pod),
                "seq": self._seq,
                "coverage_ratio": round(self.coverage_ratio, 6),
                "checkpoint_path": self._path,
                "checkpoint_writes": self.checkpoint_writes,
                "checkpoint_loaded": self.checkpoint_loaded,
            }
