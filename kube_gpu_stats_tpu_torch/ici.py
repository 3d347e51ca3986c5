"""Interconnect counter → bandwidth rate math, and per-link baselines.

The port's copy of the reference's :class:`RateTracker`: a counter that
goes backwards means the device or runtime restarted — emit no rate for
that interval rather than a huge negative/positive spike. Below it, the
reference's :class:`LinkBaselineEngine`, which the hub's link localizer
(linkloc.py) scores each endpoint's view of a graph edge against.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics


@dataclasses.dataclass
class _Last:
    value: int
    monotonic: float


class RateTracker:
    """Turns cumulative per-(device, link) counters into byte/s rates.

    Single-writer (the poll loop); no locking needed. Keys are opaque
    (device_id, link) tuples so the tracker also serves collective-op rates.
    """

    # Link-name churn guard: per-device entries beyond this are not
    # tracked (no rate, no stored state) — the poll loop caps exported
    # links separately, but churn WITHIN its cap must not grow this dict
    # for the device's lifetime either.
    MAX_LINKS_PER_DEVICE = 128

    def __init__(self) -> None:
        self._last: dict[tuple[str, str], _Last] = {}
        self._per_device: dict[str, int] = {}

    def rate(self, device_id: str, link: str, value: int, now: float) -> float | None:
        """Return bytes/sec since the previous observation, or None when no
        rate can be computed (first sample, reset/wraparound, zero dt,
        or the device's link-name budget is exhausted)."""
        key = (device_id, link)
        prev = self._last.get(key)
        if prev is None:
            if self._per_device.get(device_id, 0) >= self.MAX_LINKS_PER_DEVICE:
                return None
            self._per_device[device_id] = self._per_device.get(device_id, 0) + 1
        self._last[key] = _Last(value, now)
        if prev is None:
            return None
        dt = now - prev.monotonic
        if dt <= 0:
            return None
        delta = value - prev.value
        if delta < 0:
            # Counter reset (the device or its runtime restarted):
            # drop this interval; next tick re-establishes the baseline.
            return None
        return delta / dt

    def forget_device(self, device_id: str) -> None:
        for key in [k for k in self._last if k[0] == device_id]:
            del self._last[key]
        self._per_device.pop(device_id, None)


# --- Per-link baseline engine ----------------------------------------------

# Baseline shape: an EWMA reference rate plus a MAD band over a bounded
# window of recent healthy readings. Warmup gates flagging (a cold
# baseline degrades nothing); the MAD band absorbs scheduler jitter in
# the observed rates; the drop-fraction floor keeps a near-zero MAD
# (perfectly steady traffic) from flagging operational noise.
LINK_WARMUP_SAMPLES = 6
LINK_WINDOW = 32
LINK_MAD_K = 6.0
LINK_DROP_FRACTION = 0.25
LINK_ALPHA = 0.2
# 1.4826 * MAD estimates sigma for a normal population — the standard
# robust scale factor.
_MAD_SIGMA = 1.4826


@dataclasses.dataclass
class LinkAssessment:
    """One observation scored against its link's baseline."""

    rate: float
    mean: float
    band: float
    samples: int
    degraded: bool
    drop: float  # fraction below the baseline mean (0.0 when at/above)


class _LinkBaseline:
    __slots__ = ("mean", "samples", "window", "degraded", "last_seen",
                 "last_rate")

    def __init__(self, window: int) -> None:
        self.mean = 0.0
        self.samples = 0
        self.window: collections.deque = collections.deque(maxlen=window)
        self.degraded = False
        self.last_seen = 0.0
        self.last_rate = 0.0


class LinkBaselineEngine:
    """Rolling per-link reference rates with warmup, EWMA + MAD bands,
    and counter-reset tolerance (a ``None`` rate — RateTracker's
    reset/first-sample answer — is a no-op, never a zero).

    Keys are opaque strings (the localizer uses graph-edge names and
    per-endpoint views); single-writer like RateTracker. Degradation is
    hysteretic: a rate must fall below ``mean - max(mad_k * band,
    drop_fraction * mean)`` to flag, and recover past half that gap to
    clear — and while degraded the reference folds 16x slower and the
    MAD window freezes, so a sick link cannot drag its own baseline
    down and self-clear."""

    MAX_LINKS = 4096

    def __init__(self, *, warmup: int = LINK_WARMUP_SAMPLES,
                 alpha: float = LINK_ALPHA,
                 window: int = LINK_WINDOW,
                 mad_k: float = LINK_MAD_K,
                 drop_fraction: float = LINK_DROP_FRACTION) -> None:
        self.warmup = max(2, warmup)
        self.alpha = alpha
        self.window = window
        self.mad_k = mad_k
        self.drop_fraction = drop_fraction
        self._links: dict[str, _LinkBaseline] = {}

    def observe(self, key: str, rate: float | None,
                now: float) -> LinkAssessment | None:
        """Fold one observation; returns the assessment, or None when
        the observation carries no rate (reset interval) or the link
        budget is exhausted. A reset interval keeps the existing
        baseline intact — the next real rate scores against it."""
        state = self._links.get(key)
        if rate is None:
            if state is not None:
                state.last_seen = now
            return None
        if state is None:
            if len(self._links) >= self.MAX_LINKS:
                return None
            state = self._links[key] = _LinkBaseline(self.window)
        state.last_seen = now
        state.last_rate = rate
        if state.samples == 0:
            state.mean = rate
            state.samples = 1
            state.window.append(rate)
            return LinkAssessment(rate, rate, 0.0, 1, False, 0.0)
        band = self._band(state)
        gap = max(self.mad_k * band,
                  self.drop_fraction * max(state.mean, 0.0))
        warm = state.samples >= self.warmup
        drop = max(0.0, 1.0 - rate / state.mean) if state.mean > 0 else 0.0
        if state.degraded:
            # Clear at half the raise gap (hysteresis).
            if rate >= state.mean - 0.5 * gap:
                state.degraded = False
        elif warm and gap > 0 and rate < state.mean - gap:
            state.degraded = True
        alpha = self.alpha / 16.0 if state.degraded else self.alpha
        state.mean += alpha * (rate - state.mean)
        state.samples += 1
        if not state.degraded:
            state.window.append(rate)
        return LinkAssessment(rate, state.mean, band, state.samples,
                              state.degraded, round(drop, 4))

    def _band(self, state: _LinkBaseline) -> float:
        values = list(state.window)
        if len(values) < 2:
            return 0.0
        med = statistics.median(values)
        mad = statistics.median(abs(v - med) for v in values)
        # Floor at 2% of the reference so a perfectly flat window
        # (identical readings) still tolerates measurement jitter.
        return max(_MAD_SIGMA * mad, 0.02 * abs(state.mean))

    def degraded(self, key: str) -> bool:
        state = self._links.get(key)
        return bool(state is not None and state.degraded)

    def forget(self, key: str) -> None:
        self._links.pop(key, None)

    def sweep(self, now: float, max_age: float) -> list[str]:
        """Drop links not observed for ``max_age`` seconds (the
        stale-device forget semantics, applied to graph edges whose
        workers departed). Returns the forgotten keys."""
        stale = [k for k, s in self._links.items()
                 if now - s.last_seen > max_age]
        for key in stale:
            del self._links[key]
        return stale

    def snapshot(self) -> dict[str, dict]:
        """{key: baseline state} for export/rollup (read-only copy)."""
        out = {}
        for key, state in self._links.items():
            out[key] = {
                "mean": state.mean,
                "band": self._band(state),
                "samples": state.samples,
                "degraded": state.degraded,
                "last": state.last_rate,
            }
        return out
