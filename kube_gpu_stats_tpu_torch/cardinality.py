"""Cardinality and memory admission: the hub's series ledger, and the
daemon's label-churn fence.

The port's copy of the reference's admission layer, enforced at the
three sites where series state is born:

- **delta.py FULL/DELTA apply** — a FULL over its source's series
  budget has its *new* series dropped-and-counted (the admitted prefix
  keeps updating: series are slot-positional and born in body order, so
  clamping keeps a stable prefix and the source's DELTAs stay
  applicable); past the global hard cap a frame that would GROW the
  ledger draws a 413-style shed the publisher treats like 429 (defer +
  re-diff, never a FULL promotion). Existing series always update.
- **hub.py pull-parse install** — the same budget clamps a pulled
  body's parse before it becomes a _TargetCache entry.
- **poll.py plan compile** — :class:`LabelFence` caps distinct values
  per label key at the plan compiler, so a bad kubelet join degrades to
  ``pod="overflow"`` aggregation (one series) instead of a series
  explosion, with a ``cardinality_fenced`` journal event.

Above the high watermark :class:`SeriesAccountant` LRU-evicts *idle*
sources (no update for >= N hub refreshes) through the hub's churn path
— parse cache and delta session prune together — with the loss
accounted (``kts_cardinality_evicted_total{reason}``).

Everything is off by default (0 = no limit): in-process users keep the
accept-everything contract; the hub CLI turns the knobs on.
"""

from __future__ import annotations

import threading
from typing import Iterable, Mapping

# Reasons the admission layer can shed a series (the
# kts_cardinality_shed_total{reason} enum — born at 0 under
# source="other" so increase()-based alerting sees the first shed):
#   source_budget  over the per-source series budget (soft: the frame
#                  still lands, clamped to the admitted prefix)
#   hard_cap       the global ledger is at the hard cap and the frame
#                  would grow it (413 to the publisher)
SHED_REASONS = ("source_budget", "hard_cap")
EVICT_REASONS = ("idle",)

# Distinct sources carried in the shed ledger before aggregating under
# "other" — bounds the kts_cardinality_shed_total label cardinality the
# admission layer itself mints (a spoofed-source flood must not grow
# the accountant while it defends everything else).
_SHED_SOURCES_MAX = 64
# Distinct label KEYS the fence tracks (attribution emits a handful;
# far beyond any real join, well below a churn blowup — the
# _MAX_RAW_FAMILIES discipline).
_FENCE_KEYS_MAX = 64


class CardinalityShed(Exception):
    """A frame refused at the series hard cap — the 413 class. Carries
    the Retry-After the response should advertise; the publisher
    treats it exactly like a 429/503 shed (defer + re-diff, the acked
    diff base survives)."""

    def __init__(self, reason: str, retry_after: float = 30.0) -> None:
        super().__init__(reason)
        self.reason = reason
        self.retry_after = retry_after


class _SourceEntry:
    """Per-source ledger line: live series + estimated bytes + the hub
    refresh seq of the last update (the idle-eviction clock)."""

    __slots__ = ("series", "bytes", "seq", "clamped", "kind")

    def __init__(self, series: int, nbytes: int, seq: int,
                 kind: str) -> None:
        self.series = series
        self.bytes = nbytes
        self.seq = seq
        self.clamped = False
        self.kind = kind


class SeriesAccountant:
    """Global series ledger with admission: per-source budgets, a hard
    cap, and watermark-driven idle eviction. One instance per hub,
    shared by the ingest handler threads and the refresh thread — every
    mutation is under one small lock (admission is O(1) per frame; the
    per-series work it saves dwarfs it).

    ``bytes`` is an *estimate*: each entry is charged its exposition
    body length, which tracks the interned parse + merge-plan footprint
    to within a small factor without walking any series on the hot
    path."""

    def __init__(self, *, budget_per_source: int = 0, hard_cap: int = 0,
                 high_watermark: int = 0, low_watermark: int = 0,
                 idle_refreshes: int = 5, tracer=None) -> None:
        # Config generation: bumped by every knob write —
        # construction and the runtime raises/lowers the operator makes
        # (``hub.cardinality.hard_cap = N``). The ingest hot path
        # caches its enabled/disabled verdict against this stamp
        # instead of re-deriving it per frame.
        self.config_gen = 0
        self.budget_per_source = max(0, budget_per_source)
        self.hard_cap = max(0, hard_cap)
        self.high_watermark = max(0, high_watermark)
        # low defaults to 90% of high: eviction needs hysteresis or the
        # ledger would oscillate across the watermark every refresh.
        self.low_watermark = (max(0, low_watermark) or
                              int(self.high_watermark * 0.9))
        self.idle_refreshes = max(1, idle_refreshes)
        self._tracer = tracer
        self._lock = threading.Lock()
        self._entries: dict[str, _SourceEntry] = {}
        self._live_series = 0
        self._live_bytes = 0
        self._seq = 0
        # (source, reason) -> series shed; sources past the bound
        # aggregate under "other" so the ledger's own label cardinality
        # is bounded.
        self._shed: dict[tuple[str, str], int] = {}
        self._evicted: dict[str, int] = {}

    # The admission knobs are properties so a runtime write (tests and
    # operators assign them directly) bumps config_gen — the hot path's
    # cached verdict refreshes on the very next frame.
    @property
    def budget_per_source(self) -> int:
        return self._budget_per_source

    @budget_per_source.setter
    def budget_per_source(self, value: int) -> None:
        self._budget_per_source = value
        self.config_gen += 1

    @property
    def hard_cap(self) -> int:
        return self._hard_cap

    @hard_cap.setter
    def hard_cap(self, value: int) -> None:
        self._hard_cap = value
        self.config_gen += 1

    @property
    def high_watermark(self) -> int:
        return self._high_watermark

    @high_watermark.setter
    def high_watermark(self, value: int) -> None:
        self._high_watermark = value
        self.config_gen += 1

    @property
    def enabled(self) -> bool:
        """Any knob on? False = the accept-everything contract (no
        per-frame lock taken on the ingest path at all)."""
        return bool(self._budget_per_source or self._hard_cap
                    or self._high_watermark)

    # -- refresh clock --------------------------------------------------------

    def tick(self) -> int:
        """Advance the idle clock — called once per hub refresh."""
        with self._lock:
            self._seq += 1
            return self._seq

    # -- admission (ingest handler threads, hub fetch pool) -------------------

    def admit(self, source: str, n_series: int) -> int:
        """Admission verdict for a FULL install (push frame or pull
        parse) of ``n_series`` from ``source``: the number of series
        admitted (a prefix count — the caller clamps its parsed list),
        counting every dropped series. Raises :class:`CardinalityShed`
        when the ledger is at the hard cap and this install would grow
        it from a source with nothing installed (an established
        source's replace is instead clamped to its headroom: existing
        series always update)."""
        with self._lock:
            admitted = n_series
            shed_budget = 0
            shed_cap = 0
            if self.budget_per_source and admitted > self.budget_per_source:
                shed_budget = admitted - self.budget_per_source
                admitted = self.budget_per_source
            entry = self._entries.get(source)
            current = entry.series if entry is not None else 0
            if self.hard_cap and admitted > current:
                # Headroom = what the ledger can hold once this
                # source's old footprint is released.
                headroom = self.hard_cap - (self._live_series - current)
                if admitted > headroom:
                    if headroom <= 0 and current == 0:
                        # Nothing installed and no room at all: refuse
                        # the frame outright (413) — the publisher
                        # defers; a budget raise or an eviction
                        # re-admits it on its next FULL, no resync.
                        self._count_shed_locked(source, "hard_cap",
                                                n_series)
                        raise CardinalityShed(
                            f"series hard cap ({self.hard_cap}) reached "
                            f"({self._live_series} live)")
                    floor = max(current, headroom)
                    shed_cap = admitted - floor
                    admitted = floor
            if shed_budget:
                self._count_shed_locked(source, "source_budget",
                                        shed_budget)
            if shed_cap:
                self._count_shed_locked(source, "hard_cap", shed_cap)
            clamped = admitted < n_series
            if entry is not None and clamped != entry.clamped:
                entry.clamped = clamped
                self._journal_clamp(source, clamped, n_series, admitted)
            elif entry is None and clamped:
                self._journal_clamp(source, True, n_series, admitted)
            return admitted

    def install(self, source: str, n_series: int, est_bytes: int,
                kind: str = "push", clamped: bool = False) -> None:
        """Record a completed FULL install — the ledger replaces the
        source's previous footprint."""
        with self._lock:
            entry = self._entries.get(source)
            if entry is None:
                entry = _SourceEntry(0, 0, self._seq, kind)
                self._entries[source] = entry
            self._live_series += n_series - entry.series
            self._live_bytes += est_bytes - entry.bytes
            entry.series = n_series
            entry.bytes = est_bytes
            entry.seq = self._seq
            entry.kind = kind
            entry.clamped = clamped

    def touch(self, source: str) -> None:
        """Stamp the idle clock — a DELTA apply or an unchanged pull
        body both mean the source is alive."""
        entry = self._entries.get(source)  # GIL-atomic read
        if entry is not None:
            entry.seq = self._seq

    def forget(self, source: str) -> None:
        """Release a source's footprint (target churned out, session
        expired) — the churn path's half of the ledger contract."""
        with self._lock:
            self._forget_locked(source)

    def _forget_locked(self, source: str) -> None:
        entry = self._entries.pop(source, None)
        if entry is not None:
            self._live_series -= entry.series
            self._live_bytes -= entry.bytes

    def is_clamped(self, source: str) -> bool:
        entry = self._entries.get(source)  # GIL-atomic read
        return entry is not None and entry.clamped

    def at_hard_cap(self) -> bool:
        """Cheap pre-parse fence: True when a NEW source's FULL cannot
        possibly be admitted — checked before any decode work so a
        label-bomb flood costs a comparison per frame, not a parse."""
        return bool(self.hard_cap) and self._live_series >= self.hard_cap

    # -- shed / eviction accounting -------------------------------------------

    def count_shed(self, source: str, reason: str, n: int = 1) -> None:
        with self._lock:
            self._count_shed_locked(source, reason, n)

    def _count_shed_locked(self, source: str, reason: str, n: int) -> None:
        key = (source, reason)
        if key not in self._shed:
            distinct = {s for s, _ in self._shed}
            if source not in distinct and len(distinct) >= _SHED_SOURCES_MAX:
                key = ("other", reason)
        self._shed[key] = self._shed.get(key, 0) + n

    def _journal_clamp(self, source: str, clamped: bool, offered: int,
                       admitted: int) -> None:
        if self._tracer is None:
            return
        if clamped:
            self._tracer.event(
                "cardinality_clamped",
                f"{source}: {offered} series offered, {admitted} admitted "
                f"(budget {self.budget_per_source or 'off'}, "
                f"hard cap {self.hard_cap or 'off'})",
                source=source)
        else:
            self._tracer.event(
                "cardinality_unclamped",
                f"{source}: full series set re-admitted ({admitted})",
                source=source)

    def evict_idle(self) -> list[str]:
        """LRU-evict idle sources while the ledger sits above the high
        watermark — called by the hub's refresh (the churn path owner),
        which prunes its caches/sessions/baselines for every returned
        source. Only sources idle >= idle_refreshes qualify: a source
        that is still updating is never evicted for pressure (evicting
        it would convert memory pressure into a resync storm)."""
        with self._lock:
            if (not self.high_watermark
                    or self._live_series <= self.high_watermark):
                return []
            horizon = self._seq - self.idle_refreshes
            # Idle-est first, then LARGEST footprint first: when a
            # whole cohort goes idle in the same refresh (a quiet hub
            # ticking with no traffic), the tie must evict one label
            # bomb, not fourteen healthy 6-series workers whose dict
            # insertion order happened to be older.
            idle = sorted(
                ((entry.seq, -entry.series, source)
                 for source, entry in self._entries.items()
                 if entry.seq <= horizon))
            evicted: list[str] = []
            for _seq, _neg, source in idle:
                if self._live_series <= self.low_watermark:
                    break
                freed = self._entries[source].series
                self._forget_locked(source)
                self._evicted["idle"] = (self._evicted.get("idle", 0)
                                         + freed)
                evicted.append(source)
            if evicted and self._tracer is not None:
                self._tracer.event(
                    "cardinality_evicted",
                    f"{len(evicted)} idle source(s) evicted above the "
                    f"high watermark ({self.high_watermark}); "
                    f"{self._live_series} series live",
                )
            return evicted

    # -- read side ------------------------------------------------------------

    def live_series(self) -> int:
        return self._live_series

    def live_bytes(self) -> int:
        return self._live_bytes

    def source_count(self) -> int:
        return len(self._entries)

    def ledger_sources(self) -> list[str]:
        """Snapshot of the sources currently carried — the churn
        path's iteration surface (list(), so a concurrent handler
        install can't blow up the refresh thread's sweep)."""
        return list(self._entries)

    def top_sources(self, k: int = 10) -> list[tuple[str, int]]:
        """Top-k offenders by live series (the kts_source_series
        export and the doctor's naming evidence). Bounded output: the
        full per-source ledger is /debug-only."""
        with self._lock:
            ranked = sorted(self._entries.items(),
                            key=lambda item: item[1].series,
                            reverse=True)
            return [(source, entry.series)
                    for source, entry in ranked[:max(0, k)]]

    def shed_totals(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self._shed)

    def evicted_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._evicted)

    def shed_series_total(self) -> int:
        with self._lock:
            return sum(self._shed.values())

    def debug_payload(self, top_k: int = 10) -> dict:
        """The /debug/cardinality document (doctor --cardinality reads
        it): totals, limits, top offenders by series AND by shed, and
        the full shed/evicted ledgers."""
        with self._lock:
            ranked = sorted(self._entries.items(),
                            key=lambda item: item[1].series,
                            reverse=True)
            shed_by_source: dict[str, dict[str, int]] = {}
            for (source, reason), count in self._shed.items():
                shed_by_source.setdefault(source, {})[reason] = count
            top_shed = sorted(shed_by_source.items(),
                              key=lambda item: sum(item[1].values()),
                              reverse=True)
            return {
                "live_series": self._live_series,
                "live_bytes_estimate": self._live_bytes,
                "sources": len(self._entries),
                "refresh_seq": self._seq,
                "limits": {
                    "budget_per_source": self.budget_per_source,
                    "hard_cap": self.hard_cap,
                    "high_watermark": self.high_watermark,
                    "low_watermark": self.low_watermark,
                    "idle_refreshes": self.idle_refreshes,
                },
                "clamped_sources": sorted(
                    source for source, entry in self._entries.items()
                    if entry.clamped),
                "top_sources": [
                    {"source": source, "series": entry.series,
                     "bytes_estimate": entry.bytes,
                     "idle_refreshes": max(0, self._seq - entry.seq),
                     "kind": entry.kind, "clamped": entry.clamped}
                    for source, entry in ranked[:top_k]],
                "shed_total": sum(self._shed.values()),
                "shed": [
                    {"source": source, "reasons": dict(reasons)}
                    for source, reasons in top_shed[:top_k]],
                "evicted": dict(self._evicted),
            }


class LabelFence:
    """At most ``value_cap`` distinct values per label key; the
    (cap+1)-th and later values map to ``overflow``. Known values keep
    passing — series identity for everything admitted before the storm is
    stable. 0 = unfenced.

    Single-threaded writes (the poll loop owns plan compilation);
    counter reads from the exposition path are GIL-atomic."""

    overflow = "overflow"

    def __init__(self, value_cap: int = 0, tracer=None) -> None:
        self.value_cap = max(0, value_cap)
        self._tracer = tracer
        self._seen: dict[str, set[str]] = {}
        self._fenced: dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.value_cap > 0

    def fence(self, labels: Mapping[str, str]) -> Mapping[str, str]:
        """Admit or overflow each label value. Returns the input
        mapping untouched when nothing fenced (the common case costs a
        set lookup per label, no copy)."""
        if not self.value_cap:
            return labels
        replaced: dict[str, str] | None = None
        for key, value in labels.items():
            if not value or value == self.overflow:
                continue
            seen = self._seen.get(key)
            if seen is None:
                if len(self._seen) >= _FENCE_KEYS_MAX:
                    continue
                seen = self._seen[key] = set()
            if value in seen:
                continue
            if len(seen) < self.value_cap:
                seen.add(value)
                continue
            first = key not in self._fenced
            self._fenced[key] = self._fenced.get(key, 0) + 1
            if replaced is None:
                replaced = dict(labels)
            replaced[key] = self.overflow
            if first and self._tracer is not None:
                self._tracer.event(
                    "cardinality_fenced",
                    f"label {key!r}: distinct-value cap "
                    f"({self.value_cap}) reached; new values degrade to "
                    f"{key}={self.overflow!r} aggregation",
                )
        return replaced if replaced is not None else labels

    def fenced_totals(self) -> dict[str, int]:
        return dict(self._fenced)

    def admitted_values(self, key: str) -> int:
        """Distinct values of ``key`` admitted so far (at most the cap)."""
        seen = self._seen.get(key)
        return len(seen) if seen is not None else 0


def clamp_series(series: list, admitted: int) -> list:
    """Clamp a parsed FULL to its admitted prefix. A helper (not a
    slice at the call site) so both enforcement sites — push apply and
    pull install — share one definition of "the admitted prefix is the
    first N series in body order", the property that keeps a clamped
    source's DELTA slots < N applicable."""
    if admitted >= len(series):
        return series
    return series[:admitted]
