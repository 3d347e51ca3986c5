"""Snapshot registry — lock-light bridge between poll loop and scrape.

Concurrency contract: the poll loop is the *single writer*. Each tick it
builds a complete immutable :class:`Snapshot` and publishes it with one
reference assignment (atomic under CPython). Scrapes and textfile writes
render whichever snapshot was last published and never block — a scrape
can never stall the poll budget.

The port's copy of the reference's registry on its pure-Python render path
(the reference's ``Registry(native=False)``): the bytes are the same,
which ``tests/test_torch_registry.py`` pins.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import math
import os
import threading
import time
from typing import Iterable, Mapping, NamedTuple, Sequence

from . import schema
from .schema import MetricSpec, MetricType


@functools.lru_cache(maxsize=8192)
def _series_prefix(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    """Cached "name{label="v",...} " prefix: label sets repeat verbatim
    every tick, so a scrape's render cost should be value formatting, not
    label escaping. LRU-bounded for label churn (reallocation)."""
    return name + schema.render_labels(labels) + " "


def format_value(value: float) -> str:
    """Render a sample value in Prometheus text format."""
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


class Series(NamedTuple):
    """One (family, labelset, value) sample.

    NamedTuple, not frozen dataclass: a poll tick builds hundreds of
    these, and frozen-dataclass construction (object.__setattr__ per
    field) was measurable on the tick hot path."""

    spec: MetricSpec
    labels: tuple[tuple[str, str], ...]
    value: float


@dataclasses.dataclass(frozen=True)
class HistogramState:
    """Cumulative histogram state owned by its writer, published by value.
    ``labels`` dimension the family (e.g. collector_scrape_duration_seconds
    per output path); () renders the classic bare le-only form."""

    spec: MetricSpec
    buckets: tuple[float, ...]
    counts: tuple[int, ...]  # len(buckets) + 1, cumulative-by-render not stored
    total: int
    sum: float
    labels: tuple[tuple[str, str], ...] = ()

    @staticmethod
    def empty(spec: MetricSpec, buckets: Sequence[float],
              labels: Iterable[tuple[str, str]] = ()) -> "HistogramState":
        return HistogramState(spec, tuple(buckets), (0,) * (len(buckets) + 1),
                              0, 0.0, tuple(labels))

    def observe(self, value: float, count: int = 1) -> "HistogramState":
        """Record `count` observations of `value` (weighted observe: one
        allocation regardless of count — batched reporters like
        embedded.record_step(n, seconds) fold n same-valued steps)."""
        counts = list(self.counts)
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                counts[i] += count
                break
        else:
            counts[-1] += count
        return HistogramState(
            self.spec, self.buckets, tuple(counts), self.total + count,
            self.sum + value * count, self.labels
        )

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket bounds (upper bound of the bucket
        containing the q-th observation). Used by bench/latency tests."""
        if self.total == 0:
            return math.nan
        rank = q * self.total
        seen = 0
        for i, bound in enumerate(self.buckets):
            seen += self.counts[i]
            if seen >= rank:
                return bound
        return math.inf


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Immutable rendering source for one poll tick."""

    series: tuple[Series, ...]
    histograms: tuple[HistogramState, ...]
    timestamp: float  # unix seconds at publish

    def render(self, openmetrics: bool = False) -> str:
        """Serialize to the Prometheus text format (0.0.4), or OpenMetrics
        1.0 when ``openmetrics`` (counter families declared without the
        ``_total`` suffix, mandatory ``# EOF`` terminator).

        Families render in schema order so output is byte-stable for golden
        tests; series within a family keep insertion order (device order).
        """
        by_family: dict[str, list[Series]] = {}
        for s in self.series:
            by_family.setdefault(s.spec.name, []).append(s)

        out: list[str] = []
        for spec in schema.ALL_METRICS:
            if spec.type is MetricType.HISTOGRAM:
                continue
            group = by_family.get(spec.name)
            if not group:
                continue
            family = spec.name
            if openmetrics and spec.type is MetricType.COUNTER:
                family = spec.name.removesuffix("_total")
            out.append(f"# HELP {family} {spec.help}")
            out.append(f"# TYPE {family} {spec.type.value}")
            for s in group:
                out.append(
                    _series_prefix(s.spec.name, s.labels)
                    + format_value(s.value)
                )
        # Histograms grouped by family: one HELP/TYPE header even when the
        # family is dimensioned into several labeled states (e.g.
        # collector_scrape_duration_seconds{output=...}).
        hists_by_family: dict[str, list[HistogramState]] = {}
        for hist in self.histograms:
            hists_by_family.setdefault(hist.spec.name, []).append(hist)
        for group in hists_by_family.values():
            spec = group[0].spec
            out.append(f"# HELP {spec.name} {spec.help}")
            out.append(f"# TYPE {spec.name} histogram")
            bucket_name = spec.name + "_bucket"
            for hist in group:
                # _series_prefix-cached like plain series: bucket label
                # tuples repeat verbatim every render.
                cumulative = 0
                for i, bound in enumerate(hist.buckets):
                    cumulative += hist.counts[i]
                    le = hist.labels + (("le", format_value(bound)),)
                    out.append(_series_prefix(bucket_name, le)
                               + str(cumulative))
                le = hist.labels + (("le", "+Inf"),)
                out.append(_series_prefix(bucket_name, le) + str(hist.total))
                out.append(_series_prefix(spec.name + "_sum", hist.labels)
                           + format_value(hist.sum))
                out.append(_series_prefix(spec.name + "_count", hist.labels)
                           + str(hist.total))
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n" if out else ""


EMPTY_SNAPSHOT = Snapshot(series=(), histograms=(), timestamp=0.0)


class Registry:
    """Holds the latest published snapshot.

    `publish` is called only by the poll loop; `snapshot` by any reader.
    The event lets tests and the textfile writer wait for a fresh tick
    without polling.
    """

    def __init__(self) -> None:
        self._snapshot: Snapshot = EMPTY_SNAPSHOT
        self._published = threading.Condition()
        self._generation = 0
        # Boot-scoped nonce embedded in every ETag: the
        # generation counter restarts at 0 with the process, so a
        # generation-only ETag would let a reader's If-None-Match from
        # the PREVIOUS boot draw a stale 304 off a restarted exporter.
        # Per-instance (not per-process) so in-process restart tests
        # see the real contract.
        self.boot_id = os.urandom(4).hex()
        # One render per generation: every reader of a given
        # (format, compression) shape between two publishes gets the same
        # memoized bytes — N concurrent scrapers plus the textfile and
        # pushgateway followers cost ONE render+compress per publish, not
        # N+2. Keyed (openmetrics, gzip_level); at most ~4 live entries,
        # each invalidated by the generation bump. Plain dict, GIL-atomic
        # get/set: a racing pair of readers at worst both render (byte-
        # identical output either way) and one wins the store.
        self._render_cache: dict[tuple[bool, int],
                                 tuple[int, bytes]] = {}
        # Cumulative seconds readers spent WAITING to acquire the
        # publish lock inside rendered() (the
        # scrape-p99 creep watch item). The lock-held region is a
        # two-field read, so in a healthy process this stays ~0;
        # growth means scrapes are queueing behind publishes or the
        # render pre-warmer — exported as
        # kts_render_prewarm_wait_seconds_total and surfaced in
        # /debug/ticks meta, so the next creep is diagnosable without
        # a profiler. Accumulated while holding the lock (no race).
        self.render_wait_seconds = 0.0

    def publish(self, snapshot: Snapshot) -> None:
        with self._published:
            self._snapshot = snapshot
            self._generation += 1
            self._published.notify_all()

    def snapshot(self) -> Snapshot:
        return self._snapshot

    def rendered(self, openmetrics: bool = False,
                 gzip_level: int = 0) -> tuple[bytes, bool]:
        """(bytes, cache_hit) for the current snapshot in the requested
        shape. ``gzip_level`` 0 returns the plain encoded render; nonzero
        gzips it (mtime pinned to 0 so the compressed bytes are
        deterministic — the render-cache golden test diffs them against
        an uncached compress). The text entry is filled on the way to a
        gzip entry, so the two shapes share one serialization per
        generation."""
        body, cache_hit, _generation = self.rendered_versioned(
            openmetrics, gzip_level)
        return body, cache_hit

    def rendered_versioned(self, openmetrics: bool = False,
                           gzip_level: int = 0) -> tuple[bytes, bool, int]:
        """``rendered`` plus the generation THESE BYTES render — read
        under the publish lock as a coherent pair with the snapshot, so
        an ETag minted from it can never name a different generation's
        body (the conditional-scrape contract)."""
        wait_start = time.perf_counter()
        with self._published:
            # One lock-held read so (generation, snapshot) is a coherent
            # pair; the render itself runs outside the lock and can never
            # stall a publish. A publish racing this render only strands
            # a stale cache entry, which the generation check rejects.
            # Goes through snapshot(), not _snapshot: subclasses (and
            # tests) that override the accessor must see their snapshot
            # rendered, cache or no cache.
            self.render_wait_seconds += time.perf_counter() - wait_start
            generation = self._generation
            snapshot = self.snapshot()
        key = (openmetrics, gzip_level)
        entry = self._render_cache.get(key)
        if entry is not None and entry[0] == generation:
            return entry[1], True, generation
        text_key = (openmetrics, 0)
        entry = self._render_cache.get(text_key)
        if entry is not None and entry[0] == generation:
            body = entry[1]
        else:
            body = snapshot.render(openmetrics=openmetrics).encode()
            self._render_cache[text_key] = (generation, body)
        if gzip_level:
            body = gzip.compress(body, compresslevel=gzip_level, mtime=0)
            self._render_cache[key] = (generation, body)
        return body, False, generation

    @property
    def generation(self) -> int:
        return self._generation

    def wait_for_publish(self, after_generation: int, timeout: float) -> bool:
        """Block until a snapshot newer than `after_generation` is published."""
        deadline = time.monotonic() + timeout
        with self._published:
            while self._generation <= after_generation:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._published.wait(remaining)
        return True


class SnapshotBuilder:
    """Accumulates series for one tick; used only by the poll loop."""

    def __init__(self) -> None:
        self._series: list[Series] = []
        self._histograms: list[HistogramState] = []

    def reset(self) -> None:
        """Drop accumulated state so the instance (and its backing lists)
        can be reused for another build — per-tick scratch discipline;
        build() already materialized the previous snapshot's tuples."""
        self._series.clear()
        self._histograms.clear()

    @property
    def count(self) -> int:
        """Series accumulated so far (tick-plan allocation accounting)."""
        return len(self._series)

    def add(
        self,
        spec: MetricSpec,
        value: float,
        labels: Mapping[str, str] | Iterable[tuple[str, str]] = (),
    ) -> None:
        # duck-typed (not isinstance Mapping): typing-protocol subclass
        # checks are measurably slow on the per-series hot path.
        items = getattr(labels, "items", None)
        labels = tuple(items()) if items is not None else tuple(labels)
        self._series.append(Series(spec, labels, float(value)))

    def add_series(self, series: Series) -> None:
        """Append an already-built (immutable) Series — the poll loop's
        plan slots re-emit their cached Series while a value is
        unchanged; this entry point skips the per-add label
        normalization that add() pays."""
        self._series.append(series)

    def extend_series(self, series: Iterable[Series]) -> None:
        """Bulk add_series — one C-level extend for the hub's replayed
        merge plan instead of a method call per series."""
        self._series.extend(series)

    def add_histogram(self, state: HistogramState) -> None:
        self._histograms.append(state)

    def build(self) -> Snapshot:
        return Snapshot(
            series=tuple(self._series),
            histograms=tuple(self._histograms),
            timestamp=time.time(),
        )


# (generation stamp, prepared (spec, value, labels) rows): one entry,
# process-global like the store registry it mirrors.
_store_metrics_cache: tuple[int, tuple] = (0, ())


def contribute_store_metrics(builder: SnapshotBuilder) -> None:
    """Fold the local-fault-survival families from the
    process-global store registry (wal.store_report): durability state,
    per-errno fault counts and lost-record accounting for every
    disk-backed store this process opened (plus the accept-loop fence).
    A process with no stores contributes nothing.

    Edge-cached: every value here changes only on journaled
    edges (fault, recovery, loss, new store), so the registry walk
    reruns only when wal.health_generation() has moved — a quiet
    publish replays the previous rows without touching a single
    StoreHealth lock."""
    from . import wal

    global _store_metrics_cache
    generation = wal.health_generation()
    cached_generation, rows = _store_metrics_cache
    if generation != cached_generation:
        built: list = []
        for store, info in sorted(wal.store_report().items()):
            label = (("store", store),)
            built.append((schema.STORE_STATE,
                          wal.STORE_STATE_VALUES.get(info.get("state"),
                                                     0.0),
                          label))
            built.append((schema.STORE_LOST,
                          float(info.get("lost_records", 0)), label))
            for name in sorted(info.get("fault_counts", {})):
                built.append((schema.DISK_FAULTS,
                              float(info["fault_counts"][name]),
                              (("store", store), ("errno", name))))
        rows = tuple(built)
        _store_metrics_cache = (generation, rows)
    for spec, value, labels in rows:
        builder.add(spec, value, labels)


def contribute_push_stats(builder: SnapshotBuilder, stats) -> None:
    """Fold push-sender shipping-health counters (mode ->
    {pushes, failures, dropped}) into a snapshot as the collector_push_*
    families. One definition for every exposition that ships them, so
    the families cannot drift."""
    for mode in sorted(stats):
        entry = stats[mode]
        mode_label = (("mode", mode),)
        builder.add(schema.SELF_PUSH_TOTAL,
                    float(entry.get("pushes", 0)), mode_label)
        builder.add(schema.SELF_PUSH_FAILURES,
                    float(entry.get("failures", 0)), mode_label)
        builder.add(schema.SELF_PUSH_DROPPED,
                    float(entry.get("dropped", 0)), mode_label)
        if "shed_honored" in entry:
            # Delta publishers only: frames the
            # hub refused at admission that this publisher deferred
            # per the Retry-After instead of retrying or FULL-resyncing.
            builder.add(schema.DELTA_SHED_HONORED,
                        float(entry.get("shed_honored", 0)), mode_label)


def contribute_egress_stats(builder: SnapshotBuilder, stats) -> None:
    """Fold the egress-durability self-metrics into a
    snapshot: the delta publisher's spill-queue status under "spill"
    (DeltaPublisher.spill_status()) and the durable remote-write
    exporter's per-shard status under "remote_write"
    (RemoteWriter.egress_status()). One definition for every
    exposition that ships them, so the families cannot drift; absent/None
    sections contribute nothing (the families only exist where the
    feature is on — enabling it is a deliberate series-set change)."""
    spill = (stats or {}).get("spill")
    if spill:
        builder.add(schema.SPILL_FRAMES,
                    float(spill.get("spooled_total", 0)),
                    (("state", "spooled"),))
        builder.add(schema.SPILL_FRAMES,
                    float(spill.get("drained_total", 0)),
                    (("state", "drained"),))
        builder.add(schema.SPILL_FRAMES,
                    float(spill.get("reencoded_total", 0)),
                    (("state", "reencoded"),))
        builder.add(schema.SPILL_FRAMES,
                    float(spill.get("undecodable_total", 0)),
                    (("state", "undecodable"),))
        builder.add(schema.SPILL_DROPPED,
                    float(spill.get("dropped_total", 0)))
        builder.add(schema.SPILL_DEPTH,
                    float(spill.get("depth_frames", 0)))
        builder.add(schema.SPILL_BYTES, float(spill.get("bytes", 0)))
        builder.add(schema.SPILL_OLDEST,
                    float(spill.get("oldest_age_seconds", 0.0)))
    remote = (stats or {}).get("remote_write")
    if remote:
        shards = remote.get("shards") or []
        builder.add(schema.REMOTE_WRITE_SHARDS, float(len(shards)))
        for shard in shards:
            label = (("shard", str(shard.get("shard", 0))),)
            builder.add(schema.REMOTE_WRITE_WAL_BYTES,
                        float(shard.get("wal_bytes", 0)), label)
            builder.add(schema.REMOTE_WRITE_LAG,
                        float(shard.get("lag_seconds", 0.0)), label)
            builder.add(schema.REMOTE_WRITE_PARKED,
                        float(shard.get("parked_total", 0)), label)
            builder.add(schema.REMOTE_WRITE_DROPPED,
                        float(shard.get("dropped_total", 0)), label)




def contribute_cardinality(builder: SnapshotBuilder, accountant,
                           exposition_series: int | None = None,
                           top_k: int = 10) -> None:
    """Fold the cardinality-admission ledger into a snapshot: the
    live-series gauge, per-source/per-reason shed counters (reasons
    born at 0 under source="other" so increase()-based alerting sees
    the first shed), eviction counters, and the top-K offenders as
    kts_source_series. One definition for every accountant owner, so
    the exported ledger cannot drift from the in-process one."""
    from .cardinality import EVICT_REASONS, SHED_REASONS

    builder.add(schema.SERIES_LIVE, float(accountant.live_series()),
                (("component", "entries"),))
    if exposition_series is not None:
        builder.add(schema.SERIES_LIVE, float(exposition_series),
                    (("component", "exposition"),))
    shed = accountant.shed_totals()
    for reason in SHED_REASONS:
        shed.setdefault(("other", reason), 0)
    for source, reason in sorted(shed):
        builder.add(schema.CARDINALITY_SHED,
                    float(shed[(source, reason)]),
                    (("source", source), ("reason", reason)))
    evicted = accountant.evicted_totals()
    for reason in EVICT_REASONS:
        builder.add(schema.CARDINALITY_EVICTED,
                    float(evicted.get(reason, 0)),
                    (("reason", reason),))
    for source, live in accountant.top_sources(top_k):
        builder.add(schema.SOURCE_SERIES, float(live),
                    (("source", source),))


class FilteredSnapshotBuilder(SnapshotBuilder):
    """SnapshotBuilder that drops families the operator disabled
    (``--metrics-include``/``--metrics-exclude``, schema.FILTERABLE_METRICS).
    Filtering at build time — not render time — keeps every output path
    (scrape, textfile, pushgateway, remote_write) consistent and skips the
    per-series label work for disabled families on the poll hot path."""

    def __init__(self, disabled: frozenset[str]) -> None:
        super().__init__()
        self._disabled = disabled

    def add(self, spec, value, labels=()) -> None:
        if spec.name not in self._disabled:
            super().add(spec, value, labels)

    def add_series(self, series: Series) -> None:
        if series.spec.name not in self._disabled:
            super().add_series(series)

    def extend_series(self, series: Iterable[Series]) -> None:
        super().extend_series(
            s for s in series if s.spec.name not in self._disabled)

    def add_histogram(self, state: HistogramState) -> None:
        if state.spec.name not in self._disabled:
            super().add_histogram(state)
