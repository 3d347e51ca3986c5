"""`hub` — slice-level aggregation service for H100 nodes.

The port's copy of the reference's hub core. Per-node DaemonSet pods
each export only their local cards; when there is no Prometheus — dev
clusters, ad-hoc multi-VM runs, CI — the hub fills that gap: it merges
every node's per-card ``accelerator_*`` series into one exposition, on a
fixed cadence, and computes slice-level rollups no single node can see:

- ``slice_target_up{target}`` — which nodes answered the last refresh;
- ``slice_chips`` / ``slice_chips_up`` / ``slice_workers`` (+ expected);
- duty-cycle mean/min/max, memory, power and energy sums, aggregate
  link bandwidth;
- ``slice_worker_steps_per_second{worker}`` and ``slice_straggler_ratio``
  — per-worker step rates from frame-over-frame counter deltas; in an
  SPMD job the slowest worker gates everyone, so a low straggler ratio
  is the signal the job is wedged or unbalanced.

Nodes reach it two ways, mixed freely: **push** (daemons, embedded
exporters and leaf hubs POST delta frames to ``/ingest/delta``, applied
by ``delta.DeltaIngest`` onto the hub's per-target state, with its
admission guards and warm-restart checkpoint) and **pull** (positional
targets, ``--targets-file`` or ``--targets-dns``, scraped concurrently
under a refresh deadline; a push session silent past the fence falls
back to pull). ``cardinality.SeriesAccountant`` bounds the series both
paths may install. ``--federate`` makes the targets leaf hubs whose
``slice_*`` rollups are re-exported.

The hub is a composition of existing parts: fetch/parse from validate.py,
per-card folding + rate math from top.py, and the exposition stack
(Registry, MetricsServer with TLS/auth/gzip, RenderStats) — so `top`,
`validate`, Prometheus, and plain HTTP clients all work against the
hub's own ``/metrics`` unchanged. /healthz turns 503 when refreshes
stop; /readyz holds NotReady while a warm restart replays.

Self-metric families re-exported from the source exporters
(``collector_*``/``process_*``) are deliberately NOT merged: they carry
no worker identity, so series from different targets would collide.

Every published rollup series, and each target's ``slice_target_up``,
also feeds the history ring (``history.HistoryStore``), which ``/query``
serves. ``--ingest-procs N`` hands the public port to N acceptor
processes (``ingestproc.py``) that relay each frame to this process, the
one owner of the push sessions.

Each refresh also feeds the fleet lens (``fleetlens.FleetLens``, on by
default, ``--no-fleet-lens`` turns it off): per-target baselines and
anomalies, slow-node attribution from the daemons' trace digests, SLO
burn windows, the link localizer and the efficiency lens, served as the
``kts_fleet_*`` families, ``/debug/fleet`` and the signed
``/debug/efficiency`` attestation. Delta frames patch their entries
through the host extension's batch slot store, and each refresh folds the
frame with its ``fold_rows`` (``native/wirefast.cc``);
``--no-native-ingest`` runs the Python paths, which stay as their oracle.
The hub path imports no torch: it runs from the DaemonSet image.
"""


from __future__ import annotations

import concurrent.futures
import logging
import os
import threading
import time
from typing import Mapping, Sequence

from . import delta as delta_mod
from . import efficiency as efficiency_mod
from . import fleetlens, procstats, schema
from . import native as native_pkg
from . import wal as wal_mod
from .cardinality import SeriesAccountant, clamp_series
from .registry import (HistogramState, Registry, Series, SnapshotBuilder,
                       contribute_cardinality, contribute_egress_stats,
                       contribute_push_stats, contribute_store_metrics)
from .resilience import CircuitBreaker
from .supervisor import spawn
from .top import (_COUNTER_BY_NAME, _GAUGE_BY_NAME, ChipRow, Frame,
                  fold_target)
from .tracing import Tracer, log_every
from .validate import (bounded_memo, fetch_exposition,
                       parse_exposition_interned)
from .workers import DaemonSamplerPool

log = logging.getLogger(__name__)

# Per-chip families the hub re-exports verbatim. Histogram families go
# through _merge_histograms instead: their _bucket/_sum/_count series
# are summed across targets into one slice-level distribution.
PER_CHIP_SPECS: dict[str, schema.MetricSpec] = {
    m.name: m
    for m in schema.PER_DEVICE_METRICS
    if m.type is not schema.MetricType.HISTOGRAM
}

# Workload histogram families the hub merges (schema-fixed buckets, so
# summing per-bucket cumulative counts across targets is exact).
HIST_SPECS: dict[str, schema.MetricSpec] = {
    m.name: m for m in schema.WORKLOAD_HISTOGRAMS
}

# Slice-rollup families a FEDERATION root re-exports verbatim from its
# leaf-hub targets (--federate): every family here is dimensioned by a
# leaf-owned label (slice / target / worker), so series from different
# leaves are disjoint by construction and compose under the same
# first-wins dedup as per-chip series. Unlabeled hub families
# (slice_targets, slice_workers_expected, slice_duplicate_series) and
# the kts_*/hub_* self families stay leaf-local — they carry no leaf
# identity and would collide at the root.
FEDERATED_SPECS: dict[str, schema.MetricSpec] = {
    m.name: m
    for m in schema.HUB_METRICS
    if m.type is not schema.MetricType.HISTOGRAM
    and ({"slice", "target"} & set(m.extra_labels))
    and not m.name.startswith("kts_")
}

DEFAULT_PORT = 9401

# File-target stat sweeps split across this many pool workers: os.stat
# releases the GIL, so the syscall waits overlap (measured 6.6 -> 4.4 ms
# over 64 file targets at 4 ways; more ways just burns pool wakeups).
_SWEEP_WAYS = 4

# A stat signature is only trusted once its mtime granule has closed:
# coarse-mtime filesystems (NFSv3/ext3/FAT store whole seconds) can take
# an in-place, same-size rewrite in the same granule AFTER our read,
# which (mtime_ns, size, inode) equality can never see — the
# racily-clean rule from git/rsync. Until the granule is safely old the
# body-hash check does the short-circuiting (exact, just one read
# dearer), so actively-written targets lose only the stat fast path,
# never freshness. 2 s covers the coarsest mainstream case (FAT).
_STAT_SIG_SETTLE_NS = 2_000_000_000


def _trusted_stat_sig(st: os.stat_result) -> tuple | None:
    """(mtime_ns, size, inode) if the mtime granule is closed, else None
    (future mtimes — NFS server clock skew — also land here)."""
    if time.time_ns() - st.st_mtime_ns < _STAT_SIG_SETTLE_NS:
        return None
    return (st.st_mtime_ns, st.st_size, st.st_ino)

# Histogram families render as <fam>_bucket/_sum/_count; map each rendered
# name back to (family, part) once at import, not per refresh.
_HIST_SUFFIXES: dict[str, tuple[str, str]] = {}
for _fam in HIST_SPECS:
    _HIST_SUFFIXES[_fam + "_bucket"] = (_fam, "bucket")
    _HIST_SUFFIXES[_fam + "_sum"] = (_fam, "sum")
    _HIST_SUFFIXES[_fam + "_count"] = (_fam, "count")
del _fam

# Families feeding the cached fleet digest (fleetlens.digest_from_series):
# a delta touching one of these invalidates the digest, nothing else does.
_DIGEST_PHASE = schema.TICK_PHASE_SECONDS.name
_DIGEST_SLOWEST = schema.SLOWEST_TICK_SECONDS.name
_DIGEST_BURST = schema.BURST_WATTS.name  # burst-aware power baseline
# Host-pressure signals: deltas to these patch the cached digest's host
# dict, so the invalidation set must cover them too.
_DIGEST_HOST = frozenset((schema.HOST_PRESSURE.name,
                          schema.HOST_NIC_DROP_RATE.name,
                          schema.HOST_THROTTLE_RATE.name))

# Compiled patch-action kinds (_TargetCache._compile_patch): what a
# delta to a given slot must touch beyond the series views and plans.
_PATCH_PLAIN = 0    # nothing derived consumes this family's value
_PATCH_ROW = 1      # frame-fold ChipRow gauge/counter column
_PATCH_ICI = 2      # frame-fold ChipRow summed ICI rate
_PATCH_ROLLUP = 3   # frame-fold slice_* rollup cell
_PATCH_HIST = 4     # drop the cached histogram fold
_PATCH_DIGEST = 5   # drop the cached fleet digest

# Merge-plan skeletons are pure functions of (target, interned series
# shape), so they live in a hub-level memo instead of dying with the
# _TargetCache entry — a worker that warm-restarts (new FULL, same shape)
# or churns out of DNS and back re-parses its body but never rebuilds
# its plan. Cleared wholesale at the cap, the bounded_memo idiom: churn
# that large means the memo isn't helping anyway. Compiled patch programs
# (_TargetCache._compile_program) are pure functions of (target, shape,
# wants_rollup) too, and live in _PROGRAM_MEMO under the same cap.
_PLAN_MEMO_MAX = 4096
_PROGRAM_MEMO: dict[tuple, tuple] = {}


class _TargetCache:
    """One target's zero-reparse ingest state.

    An idle chip's exposition is byte-identical from refresh to refresh
    (gauges flat, counters parked), so the hub keeps, per target, the
    last response body alongside everything derived from it:

    - ``series``: the interned parse (label tuples pointer-shared across
      targets and cycles via validate's pools);
    - ``series_dicts``: the dict-label view build_frame consumes — built
      once per parse, not once per refresh;
    - ``chip_plan``: pre-built (dedup-key, Series) pairs for the per-chip
      merge — replayed by _merge_chip_series with set-membership + append
      as the only per-refresh work;
    - ``hist_local``: the target's folded histogram contribution for
      _merge_histograms;
    - ``frame_rows``/``frame_rollups``: the target's build_frame fold
      (top.fold_target) — row keys lead with the target so folds are
      disjoint, and each refresh stitches the frame from per-target
      copies (the cached originals stay pristine; Frame.rates mutates
      only the copies);
    - ``stat_sig``: for ``.prom`` file targets, the (mtime_ns, size,
      inode) the body was read under — an unchanged signature skips the
      read syscall entirely (taken BEFORE the read, so a write racing
      the read can only cause an extra re-read next refresh, never a
      stale reuse). None for network targets AND while the mtime
      granule is still open (_trusted_stat_sig): a coarse-mtime
      filesystem could take a same-size in-place rewrite the signature
      can't see, so fresh files stay on the body-hash check.

    A changed body replaces the whole entry (the full-rebuild fallback:
    any series-shape change is just a new parse), and _refresh_targets
    evicts entries with their target, on the same path as _hist_cache.
    ``series``/``series_dicts`` are transient: refresh_once drops both
    (None) once the merge phases have cached every derived artifact —
    only ``body`` must stay resident to fund the byte-compare.
    chip_plan/hist_local/frame_rows are filled lazily by the merge phase
    (refresh thread); fetch pool threads only ever install fresh entries,
    which is a GIL-atomic dict store.

    A push entry's lazy builds race its delta patches: a frame landing
    between a build's read of the values and the install of its view
    finds no view to patch. ``version`` is a seqlock against that, with
    ``apply_patch`` (one writer: the ingest applies a source's frames
    under its lane's lock) as the write side and ``view`` as the read
    side; neither side ever waits for the other."""

    __slots__ = ("body", "body_hash", "series", "series_dicts",
                 "chip_plan", "rollup_plan", "hist_local", "frame_rows",
                 "frame_rollups", "fleet_digest", "stat_sig", "pushed",
                 "wants_rollup", "patch_actions", "patch_program",
                 "value_slab", "shape", "version")

    def __init__(self, body: str, series: list,
                 stat_sig: tuple | None = None,
                 pushed: bool = False,
                 wants_rollup: bool = False) -> None:
        self.body = body
        self.body_hash = hash(body)
        self.series = series
        # A ~10-pair dict build is ~10x cheaper than tokenizing the line,
        # and doing it here means a body-cache hit skips even that.
        self.series_dicts = [(name, dict(labels), value)
                             for name, labels, value in series]
        self.chip_plan: tuple | None = None
        # Federation-root re-export plan (slice_* families from a leaf
        # hub target) — same shape as chip_plan, built only under
        # --federate.
        self.rollup_plan: tuple | None = None
        self.hist_local: dict | None = None
        self.frame_rows: dict[tuple, ChipRow] | None = None
        self.frame_rollups: dict[tuple, float] | None = None
        # Flight-recorder digest harvested from the body (fleetlens):
        # cached like the other derived artifacts, so an unchanged body
        # replays it with zero re-extraction.
        self.fleet_digest: dict | None = None
        self.stat_sig = stat_sig
        # Delta-push entries: series/series_dicts stay
        # resident (they ARE the session state deltas patch), body is
        # synthetic, and refresh_once's parse-view drop skips them.
        self.pushed = pushed
        # True on a --federate hub: this entry will also carry a
        # rollup_plan, so compiled patch actions must not be cached
        # until BOTH plans exist (a -1 rollup index frozen in while the
        # refresh thread was still building the rollup plan would
        # permanently stop patching that slot's re-exported series).
        self.wants_rollup = wants_rollup
        # Per-slot compiled patch actions (lazy): a slot's name/labels
        # are fixed for the entry's life (shape changes arrive as full
        # replacements), so which fold a value change feeds — and under
        # which pre-sorted key — is computed once, not per delta.
        self.patch_actions: dict[int, tuple] = {}
        # Native patch program: the whole-entry flat compilation of
        # patch_actions — per-slot kind bytes, plan pair indices, fold
        # keys/columns — plus the per-entry float slab of current slot
        # values, consumed by the extension's apply_slots in one C call
        # per delta frame. Compiled lazily once both plans exist (same
        # gate as patch_actions caching); None until then and on the
        # Python path.
        self.patch_program: tuple | None = None
        self.value_slab = None
        # Interned schema shape: the per-slot (name, labels)
        # identity of this entry's series, values excluded — the key
        # under which compiled merge plans and patch programs survive
        # target churn. Lazy: computed the first time a plan or program
        # wants it, while ``series`` is still resident.
        self.shape: tuple | None = None
        # Odd while apply_patch runs; see view().
        self.version = 0

    def shape_key(self) -> tuple:
        """Two flat tuples of interned objects (names, label tuples):
        cheap to hash (string hashes are memoized, label tuples are
        pointer-shared via validate's pools) and equal exactly when a
        rebuilt parse has the same series shape slot-for-slot — the
        condition under which a memoized plan skeleton or patch
        program is valid for this entry."""
        shape = self.shape
        if shape is None:
            series = self.series
            shape = self.shape = (
                tuple(entry[0] for entry in series),
                tuple(entry[1] for entry in series))
        return shape

    def apply_patch(self, slots, values, target: str,
                    native_mod=None) -> bool:
        """Apply delta (slot, value) changes in place: the series views,
        any built merge plans, AND the cached frame fold are patched
        slot-wise (labels never change in a delta — shape changes
        arrive as full replacements), so the per-refresh cost of an
        active push target is proportional to its churn, not its series
        count. Only the folds a change actually feeds are touched: a
        histogram slot drops the cached histogram fold, a trace-digest
        slot drops the cached fleet digest, and accelerator_*/slice_*
        slots update the pristine cached ChipRow/rollup entries
        directly — the same values a full refold
        would compute.

        With ``native_mod`` (the host extension) the per-slot loop runs
        as ONE C call over the entry's compiled patch program + value
        slab — semantics identical to the Python loop (``_patch``),
        which stays as the differential oracle and carries the frames
        while the program isn't compiled yet (plans still building).
        Either runs inside the version bumps. Returns True when the
        extension faulted and the frame was patched in Python."""
        self.version += 1
        try:
            if native_mod is not None:
                program = self.patch_program
                if program is None:
                    program = self._compile_program(target)
                if program is not None:
                    try:
                        flags = native_mod.apply_slots(self, tuple(slots),
                                                       tuple(values))
                    except Exception as exc:
                        # A native fault must degrade to the oracle, not
                        # drop the frame: recompile next time (the slab
                        # may be mid-write), drop every fold cache (a
                        # partial C apply may have fed some folds and
                        # not others; the next refresh refolds from the
                        # series views the Python loop repairs), and
                        # patch this frame in Python.
                        log.warning("native apply_slots failed; falling "
                                    "back to the Python patch loop",
                                    exc_info=True)
                        native_pkg.note_fault("apply_slots", exc)
                        self.patch_program = None
                        self.value_slab = None
                        self.hist_local = None
                        self.fleet_digest = None
                        self.frame_rows = None
                        self.frame_rollups = None
                        self._patch(slots, values, target)
                        return True
                    if flags:
                        if flags & 1:
                            self.hist_local = None
                        if flags & 2:
                            self.fleet_digest = None
                        if flags & 4:
                            self.frame_rows = None
                            self.frame_rollups = None
                    return False
            self._patch(slots, values, target)
            return False
        finally:
            self.version += 1

    def view(self, names: tuple[str, ...], build) -> tuple:
        """The derived views ``names`` (attributes), from ``build()``
        when one is missing. A build that a patch overlapped (the
        version moved, or was odd when the build read the values) is
        used by this refresh, which may show a frame landing during it
        half applied, but is not kept: the patch found no view to
        update. The next refresh builds again."""
        views = tuple(getattr(self, name) for name in names)
        if None not in views:
            return views
        before = self.version
        views = build()
        if before % 2 == 0:
            for name, built in zip(names, views):
                setattr(self, name, built)
            if self.version != before:
                for name in names:
                    setattr(self, name, None)
        return views

    def _patch(self, slots, values, target: str) -> None:
        """apply_patch's work, inside its version bumps."""
        series = self.series
        dicts = self.series_dicts
        actions = self.patch_actions
        actions_get = actions.get
        chip_plan = self.chip_plan
        rollup_plan = self.rollup_plan
        chip_pairs = chip_plan[1] if chip_plan is not None else None
        rollup_pairs = rollup_plan[1] if rollup_plan is not None else None
        for slot, value in zip(slots, values):
            action = actions_get(slot)
            if action is None:
                action = self._compile_patch(slot, target)
            entry_tuple = series[slot]
            series[slot] = (entry_tuple[0], entry_tuple[1], value)
            dict_entry = dicts[slot]
            dicts[slot] = (dict_entry[0], dict_entry[1], value)
            kind, fold_key, column, chip_index, rollup_index = action
            if chip_index >= 0 and chip_pairs is not None:
                pair = chip_pairs[chip_index]
                pair_series = pair[1]
                chip_pairs[chip_index] = (
                    pair[0],
                    Series(pair_series.spec, pair_series.labels, value))
            if rollup_index >= 0 and rollup_pairs is not None:
                pair = rollup_pairs[rollup_index]
                pair_series = pair[1]
                rollup_pairs[rollup_index] = (
                    pair[0],
                    Series(pair_series.spec, pair_series.labels, value))
            if kind == _PATCH_PLAIN:
                continue
            if kind == _PATCH_ROLLUP:
                if self.frame_rollups is not None:
                    self.frame_rollups[fold_key] = value
                continue
            if kind == _PATCH_HIST:
                self.hist_local = None
                continue
            if kind == _PATCH_DIGEST:
                self.fleet_digest = None
                continue
            rows = self.frame_rows
            if rows is None:
                continue
            row = rows.get(fold_key)
            if row is None:
                # A folded family with no row would mean the fold and
                # the series disagree about shape — refold lazily.
                self.frame_rows = None
                self.frame_rollups = None
            elif kind == _PATCH_ICI:
                # Per-link rates SUM into the row; patch by the delta
                # against the old value (exact: the old value is this
                # slot's prior contribution).
                row.ici_bps += value - entry_tuple[2]
            else:
                setattr(row, column, value)

    def _compile_patch(self, slot: int, target: str) -> tuple:
        """(kind, fold key, row column, chip-plan pair index,
        rollup-plan pair index) for one slot — which caches a value
        change feeds, with lookup keys and plan positions pre-resolved
        (the per-delta sorted-labels key build was the hot line of the
        4096-worker root refresh before this memo). Cached on the entry
        only once both relevant plans exist: pair positions are
        deterministic for a fixed series shape, so a rebuilt plan lands
        the same indices."""
        name = self.series[slot][0]
        label_dict = self.series_dicts[slot][1]
        chip_index = (self.chip_plan[3].get(slot, -1)
                      if self.chip_plan is not None else -1)
        rollup_index = (self.rollup_plan[3].get(slot, -1)
                        if self.rollup_plan is not None else -1)
        if name in _HIST_SUFFIXES:
            action = (_PATCH_HIST, None, None, chip_index, rollup_index)
        elif (name in (_DIGEST_PHASE, _DIGEST_SLOWEST, _DIGEST_BURST)
              or name in _DIGEST_HOST):
            action = (_PATCH_DIGEST, None, None, chip_index, rollup_index)
        elif name.startswith("slice_"):
            action = (_PATCH_ROLLUP,
                      (target, name, tuple(sorted(label_dict.items()))),
                      None, chip_index, rollup_index)
        elif name.startswith("accelerator_"):
            row_key = (target, label_dict.get("slice", ""),
                       label_dict.get("worker", ""),
                       label_dict.get("chip", ""))
            column = _GAUGE_BY_NAME.get(name)
            counter = _COUNTER_BY_NAME.get(name)
            if column is not None:
                action = (_PATCH_ROW, row_key, column,
                          chip_index, rollup_index)
            elif counter is not None:
                action = (_PATCH_ROW, row_key, f"{counter}_total",
                          chip_index, rollup_index)
            elif name == schema.ICI_BANDWIDTH.name:
                action = (_PATCH_ICI, row_key, None,
                          chip_index, rollup_index)
            else:
                action = (_PATCH_PLAIN, None, None,
                          chip_index, rollup_index)
        else:
            action = (_PATCH_PLAIN, None, None, chip_index, rollup_index)
        if self.chip_plan is not None and (
                self.rollup_plan is not None or not self.wants_rollup):
            self.patch_actions[slot] = action
        return action

    def _compile_program(self, target: str) -> tuple | None:
        """Flatten every slot's patch action into the arrays the native
        apply_slots loop consumes — per-slot kind byte, chip/rollup
        plan pair index, fold key, ChipRow column — plus the per-entry
        float slab seeded with the CURRENT slot values (the ICI-delta
        old-value source, kept in sync by the C store from then on).
        Compiled once per entry life, under the same both-plans-exist
        gate as patch_actions caching: pair indices compiled against a
        half-built plan set would freeze wrong positions in. Returns
        None while the gate isn't met (the Python oracle carries those
        frames).

        Memoized across entry lives keyed by (target, interned shape,
        wants_rollup): every component of the program (kind bytes,
        plan pair indices, fold keys, columns) is a pure function of
        that key, because pair positions are deterministic for a fixed
        series shape. A source that resyncs with a FULL of the same
        shape (warm restart, churn-and-return) gets its program back
        without recompiling; only the value slab — the one
        value-dependent piece — is rebuilt from the live series."""
        if self.chip_plan is None or (
                self.rollup_plan is None and self.wants_rollup):
            return None
        import array as array_mod
        import sys as sys_mod

        memo_key = (target, self.shape_key(), self.wants_rollup)
        cached = _PROGRAM_MEMO.get(memo_key)
        if cached is not None:
            self.value_slab = array_mod.array(
                "d", (entry[2] for entry in self.series))
            self.patch_program = cached
            return cached
        n = len(self.series)
        kinds = bytearray(n)
        chip_idx = array_mod.array("i")
        rollup_idx = array_mod.array("i")
        keys: list = []
        cols: list = []
        actions_get = self.patch_actions.get
        for slot in range(n):
            action = actions_get(slot)
            if action is None:
                action = self._compile_patch(slot, target)
            kind, fold_key, column, ci, ri = action
            kinds[slot] = kind
            chip_idx.append(ci)
            rollup_idx.append(ri)
            keys.append(fold_key)
            cols.append(sys_mod.intern(column)
                        if isinstance(column, str) else None)
        self.value_slab = array_mod.array(
            "d", (entry[2] for entry in self.series))
        # Index arrays ship as immutable bytes (int32 little-endian via
        # array('i')): the C side reads them pointer-direct with no
        # per-call buffer acquisition.
        self.patch_program = (bytes(kinds), chip_idx.tobytes(),
                              rollup_idx.tobytes(),
                              tuple(keys), tuple(cols))
        if len(_PROGRAM_MEMO) >= _PLAN_MEMO_MAX:
            _PROGRAM_MEMO.clear()
        _PROGRAM_MEMO[memo_key] = self.patch_program
        return self.patch_program


class Hub:
    """Owns the refresh loop and the merged registry.

    Single-writer discipline: only the refresh loop (or refresh_once in
    tests/--once) builds and publishes snapshots; the HTTP server only
    reads — the same concurrency contract as the exporter daemon
    (registry.py).
    """

    def __init__(self, targets: Sequence[str], interval: float = 10.0,
                 expect_workers: int = 0, rollups_only: bool = False,
                 fetch_timeout: float = 5.0,
                 registry: Registry | None = None,
                 render_stats=None, push_stats=None, egress_stats=None,
                 headers_provider=None,
                 target_ca_file: str = "",
                 target_insecure_tls: bool = False,
                 targets_provider=None,
                 tracer: Tracer | None = None,
                 delta_ingest: bool = True,
                 push_fence: float | None = None,
                 federate: bool = False,
                 fleet_lens: bool = True,
                 slo_freshness_target: float =
                 fleetlens.DEFAULT_FRESHNESS_TARGET,
                 slo_straggler_target: float =
                 fleetlens.DEFAULT_STRAGGLER_TARGET,
                 slo_straggler_ratio: float =
                 fleetlens.DEFAULT_STRAGGLER_RATIO,
                 ingest_lanes: int = 0,
                 ingest_delta_rate: float = 0.0,
                 ingest_max_inflight: int = 0,
                 ingest_max_sessions: int = 0,
                 ingest_quarantine_threshold: int = 5,
                 ingest_quarantine_window: float = 60.0,
                 ingest_checkpoint: str = "",
                 ingest_checkpoint_interval: float = 10.0,
                 ingest_proto_min: int = 0,
                 ingest_proto_max: int = 0,
                 native_ingest: bool = True,
                 series_budget_per_source: int = 0,
                 series_hard_cap: int = 0,
                 series_high_watermark: int = 0,
                 series_low_watermark: int = 0,
                 series_idle_refreshes: int = 5,
                 history=None,
                 efficiency: bool = True,
                 waste_warmup_refreshes: int =
                 efficiency_mod.DEFAULT_WARMUP_REFRESHES,
                 waste_idle_refreshes: int =
                 efficiency_mod.DEFAULT_IDLE_REFRESHES,
                 waste_idle_duty: float = efficiency_mod.DEFAULT_IDLE_DUTY,
                 waste_top_k: int = efficiency_mod.DEFAULT_TOP_K,
                 energy_audit_key: str = "") -> None:
        if not targets and targets_provider is None and not delta_ingest:
            raise ValueError("hub needs at least one target")
        # Order-preserving dedup: a target listed twice (positional +
        # --targets-file overlap) would emit duplicate slice_target_up
        # series and make the whole exposition invalid to Prometheus.
        self._targets = list(dict.fromkeys(targets))
        if len(self._targets) < len(targets):
            log.warning("hub: %d duplicate target(s) dropped",
                        len(targets) - len(self._targets))
        # The CONFIGURED list (static flags or last provider result):
        # push sources join the effective target list on top of it each
        # refresh, so a push-only fleet needs no target config at all.
        self._configured = list(self._targets)
        # History ring (history.HistoryStore): each refresh stages its
        # rollup series on this thread and commits them once its
        # snapshot is published. None keeps no lookback (bare hubs in
        # tests); a disabled store (--no-history) records nothing.
        self.history = history
        # Federation root (--federate): targets are leaf hubs — their
        # slice_* rollup series (FEDERATED_SPECS) are re-exported
        # alongside any per-chip series, so a root hub serves the whole
        # tree's slices in one exposition.
        self._federate = federate
        # A push session older than the fence is not trusted for this
        # refresh: the target falls back to pull-scrape automatically
        # (mixed fleets and old daemons keep working), and a session
        # silent past the ingest expiry leaves the target list.
        self._push_fence = (push_fence if push_fence is not None
                            else max(3.0 * interval, 3.0))
        # Dynamic discovery (DNS over a headless Service): called at the
        # top of each refresh; returned targets REPLACE the static list.
        # A provider failure keeps the previous list — a DNS blip must
        # not blank the slice view.
        self._targets_provider = targets_provider
        self._interval = interval
        self._expect_workers = expect_workers
        self._rollups_only = rollups_only
        self._fetch_timeout = fetch_timeout
        self._render_stats = render_stats
        # Shipping-health counters from attached push senders (same shape
        # as daemon._push_stats: mode -> {pushes, failures, dropped}).
        self._push_stats = push_stats
        # Egress-durability status provider: a callable
        # returning {"spill": ..., "remote_write": ...} status dicts
        # from the hub's senders (leaf->root spill queue, durable
        # remote-write shards) — folded as kts_spill_*/
        # kts_remote_write_* on every publish.
        self._egress_stats = egress_stats
        # Credentials for hardened exporters: called once per refresh
        # (file-backed tokens rotate without a restart) and sent to every
        # target. TLS options pass through to fetch_exposition.
        self._headers_provider = headers_provider
        self._target_ca_file = target_ca_file
        self._target_insecure_tls = target_insecure_tls
        self.registry = (registry if registry is not None
                         else Registry(native=native_ingest))
        self._previous: Frame | None = None
        # Last-known histogram contribution per target: a target that
        # misses one refresh keeps contributing its last state, so the
        # merged cumulative counters never dip on a transient fetch
        # failure (Prometheus would read the dip as a counter reset and
        # rate() a phantom spike on recovery).
        self._hist_cache: dict[str, dict] = {}
        # Zero-reparse ingest state per target (_TargetCache): body hash
        # short-circuit + cached parse/merge-plan. Evicted with the
        # target (_refresh_targets) so churn can't leak entries. With
        # delta ingest on, this is a LaneStore — one dict slab per
        # ingest lane, routed by the same source hash the session lanes
        # use, so a lane's POST-thread applies never touch another
        # lane's slab; the refresh thread merges the lane views at
        # render-generation time simply by reading through it. 0 lanes
        # = auto (a few, bounded by the core count).
        self._ingest_lanes = (ingest_lanes if ingest_lanes > 0
                              else delta_mod.DEFAULT_INGEST_LANES)
        self._parse_cache = (delta_mod.LaneStore(self._ingest_lanes)
                             if delta_ingest
                             else {})
        self._body_cache_hits = 0
        self._parse_hist = HistogramState.empty(
            schema.HUB_PARSE_SECONDS, schema.HUB_PARSE_BUCKETS)
        self._refresh_hist = HistogramState.empty(
            schema.HUB_REFRESH_DURATION, schema.HUB_REFRESH_BUCKETS)
        # Daemon-thread pool (workers.py), not ThreadPoolExecutor: a fetch
        # wedged in a slow-drip target must not make shutdown unkillable.
        # Dynamic modes (DNS/file re-read) size the pool for growth: the
        # discovered target count can climb far past the startup snapshot,
        # and a pool sized from it would serialize fetches into waves.
        self._pool_size = (32 if targets_provider is not None
                           else min(32, len(self._targets) or 32))
        self._pool = DaemonSamplerPool(
            self._pool_size, thread_name_prefix="hub-fetch")
        # Fetches that blew the refresh deadline but are still running:
        # a running future can't be cancelled, so until it finishes we
        # must not submit another fetch for that target or one wedged
        # target would leak a pool worker per refresh (poll.py's
        # stuck-sampler guard, applied to scraping).
        self._outstanding: dict[str, concurrent.futures.Future] = {}
        # Per-target circuit breakers (the shared resilience policy,
        # replacing bespoke retry pacing): a target that fails several
        # refreshes running is skipped — no pool submit, no
        # fetch_timeout burned on it — until the recovery probe admits
        # one fetch. The wedged-future guard above stays: a breaker
        # can't un-wedge a running future. State exports as
        # kts_breaker_state{component="target:<url>"}.
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breaker_recovery = max(2.0 * interval, 1.0)
        # Dedup-key memo: a series' label tuple is identical from
        # refresh to refresh (only values change), so the per-series
        # sorted() in _merge_chip_series re-sorts the same few thousand
        # tuples every cycle. Bounded like validate's label cache.
        self._key_cache: dict[tuple, tuple] = {}
        # Merge-plan skeleton memo: value-free plan skeletons
        # keyed by (target, spec set, interned series shape), surviving
        # _TargetCache eviction so target churn / same-shape resyncs
        # re-stamp values instead of recompiling. Deliberately NOT
        # pruned with departed targets in _refresh_targets — surviving
        # churn is the point; the wholesale cap bounds it instead.
        self._plan_memo: dict[tuple, tuple] = {}
        # Flight recorder: each refresh is one "cycle" trace —
        # fetch / frame_fold / merge / publish phases plus per-target
        # fetch+parse aux spans from the pool threads — and per-target
        # breaker transitions land in the event journal. The hub main()
        # hands the same tracer to its MetricsServer as the /debug
        # provider.
        self.tracer = tracer if tracer is not None else Tracer()
        # Fleet lens: per-target rolling baselines + anomaly flagging
        # into the event journal, cross-node slow-node attribution from
        # the daemons' flight-recorder digests, and multi-window SLO
        # burn rates — scored once per refresh, served as kts_fleet_*
        # gauges, /debug/fleet, and doctor --fleet. None when disabled
        # (--no-fleet-lens): /debug/fleet 404s.
        self.fleet = fleetlens.FleetLens(
            tracer=self.tracer,
            freshness_target=slo_freshness_target,
            straggler_target=slo_straggler_target,
            straggler_ratio=slo_straggler_ratio,
            efficiency=efficiency,
            waste_warmup_refreshes=waste_warmup_refreshes,
            waste_idle_refreshes=waste_idle_refreshes,
            waste_idle_duty=waste_idle_duty,
            waste_top_k=waste_top_k,
        ) if fleet_lens else None
        # Federation energy/waste attestation: the hub-side audit key
        # signs the /debug/efficiency rollup (the daemon-side key signs
        # /debug/energy; they are usually the same secret). Leaves'
        # /debug/energy digests are fetched lazily from the HTTP handler
        # thread with a short TTL cache — never from the refresh loop,
        # which must not block on N extra fetches.
        self._energy_audit_key = energy_audit_key
        self._efficiency_enabled = efficiency and fleet_lens
        self._energy_digest_cache: tuple[float, dict] | None = None
        self._energy_digest_lock = threading.Lock()
        # Injectable for tests: fetcher(url) -> digest dict (raises on
        # failure). None = the default urllib fetch.
        self._energy_fetcher = None
        # Delta-push ingest: daemons and leaf hubs
        # POST seq-numbered change-sets to /ingest/delta; the refresh
        # drains them straight onto the _TargetCache interned state,
        # bypassing fetch AND parse for push-fresh targets. None
        # (--no-delta-ingest) keeps the hub pull-only.
        # Survival knobs ride straight through: admission
        # control + quarantine + the warm-restart checkpoint live in
        # DeltaIngest; the hub only owns the cadence (checkpoint per
        # refresh, replay kicked at start) and the /readyz gate.
        # Cardinality & memory admission: one ledger over
        # BOTH state-birth sites (push apply, pull-parse install). The
        # accountant always exists — kts_series_live/kts_source_series
        # meter a hub with every knob at 0 — but with no limits set the
        # admission calls degenerate to accounting.
        self.cardinality = SeriesAccountant(
            budget_per_source=series_budget_per_source,
            hard_cap=series_hard_cap,
            high_watermark=series_high_watermark,
            low_watermark=series_low_watermark,
            idle_refreshes=series_idle_refreshes,
            tracer=self.tracer)
        self.delta = (delta_mod.DeltaIngest(
            tracer=self.tracer,
            accountant=self.cardinality,
            expiry=max(10.0 * self._push_fence, 60.0),
            entry_factory=lambda series: _TargetCache(
                "", series, pushed=True, wants_rollup=federate),
            entry_store=self._parse_cache,
            lanes=self._ingest_lanes,
            delta_rate=ingest_delta_rate,
            max_inflight=ingest_max_inflight,
            max_sessions=ingest_max_sessions,
            quarantine_threshold=ingest_quarantine_threshold,
            quarantine_window=ingest_quarantine_window,
            checkpoint_path=ingest_checkpoint,
            checkpoint_interval=ingest_checkpoint_interval,
            # Version-skew window: 0 = this build's bound;
            # --ingest-proto-min raises the floor for census-gated
            # rollouts, frames outside draw 426 + hello.
            proto_min=ingest_proto_min,
            proto_max=ingest_proto_max,
            native=native_ingest)
            if delta_ingest else None)
        # Native frame fold: the refresh's fold-replay inner loop
        # (rows[key] = row.clone_at(at)) in one C call per target;
        # clone_at stays the differential oracle. Gated on the same flag
        # as native ingest, so --no-native-ingest runs the hub's Python
        # paths.
        self._fold_native = (native_pkg.load_fold() if native_ingest
                             else None)
        self._push_served = 0  # targets served by push, last refresh
        # Federated slice_* series dropped because two leaves claimed
        # the same slice identity (kts_hub_dup_slice_total).
        self._dup_slice_total = 0
        self._cycle_seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Thread supervisor: hub main() wires
        # one and registers the refresh loop / senders / pre-warmer;
        # when set, its kts_component_* self-metrics ride every publish
        # and the refresh loop beats it per cycle.
        self._supervisor = None
        self.heartbeat = None
        # Extra self-metric contributors: components wired
        # OUTSIDE the hub — today the SO_REUSEPORT IngestProcPool's
        # kts_ingest_proc_* families — append series onto every
        # publish without hub.py importing them.
        self._extra_metrics: list = []
        # Store-fault journal feed: disk_fault /
        # store_recovered events from every WAL store land in this
        # process's shared journal.
        wal_mod.set_journal(self.tracer)

    def _breaker(self, target: str) -> CircuitBreaker:
        breaker = self._breakers.get(target)
        if breaker is None:
            # Two trip conditions: consecutive failures (target down),
            # plus a failure-rate window for the flaky target that
            # answers just often enough to keep resetting the
            # consecutive count while wasting a fetch most refreshes.
            breaker = CircuitBreaker(
                f"target:{target}", failure_threshold=3,
                recovery_time=self._breaker_recovery,
                window=10, failure_rate_threshold=0.6)
            # No supervisor in the hub process: the journal feed is
            # wired right here in the factory.
            breaker.on_transition = self.tracer.breaker_listener
            self._breakers[target] = breaker
        return breaker

    # -- one refresh ---------------------------------------------------------

    def refresh_once(self) -> Frame:
        start = time.monotonic()
        tracer = self.tracer
        self._cycle_seq += 1
        tracer.begin("cycle", self._cycle_seq)
        if self.delta is not None:
            # Warm-restart replay: idempotent kick, so the
            # --once/test paths (which never call start()) replay too.
            self.delta.start_replay()
        self._refresh_targets()
        if not self._targets:
            # Discovery never succeeded, or the target list was
            # deliberately emptied. Publish a MINIMAL snapshot (config
            # gauges only, no slice data): the shipped Deployment's
            # liveness probe hits /healthz, and publishing nothing would
            # go health-stale and restart-loop the pod — turning an
            # empty ConfigMap (a configuration state the hub is meant to
            # survive) into a crash loop. Zero targets stays alertable
            # as `slice_targets == 0`; --once still exits nonzero via
            # the frame error.
            frame = Frame({}, ["target discovery yielded no targets"])
            self._previous = frame
            builder = SnapshotBuilder()
            builder.add(schema.HUB_TARGETS, 0.0)
            builder.add(schema.HUB_WORKERS_EXPECTED,
                        float(self._expect_workers))
            self._publish(builder, start)
            tracer.end(targets=0)
            if log_every("hub:no-targets", 60.0):
                log.warning("hub refresh: %s (repeats suppressed for "
                            "60s; alert on slice_targets == 0)",
                            frame.errors[0])
            return frame
        errors: list[str] = []
        ats: list[float] = []
        entries: list[tuple[str, _TargetCache]] = []
        reachable: dict[str, bool] = {}

        headers = (self._headers_provider()
                   if self._headers_provider is not None else None)

        # Delta-push drain: sessions fresh within the fence
        # are applied straight onto their _TargetCache entries — no
        # fetch submitted, no parse run. Stale sessions are simply
        # absent here, so those targets fall through to the pull path
        # below (the automatic per-target fallback).
        delta_mark = tracer.mark()
        push_entries = self._sync_push_entries()
        self._push_served = len(push_entries)
        if push_entries:
            tracer.add_span("delta_apply", delta_mark,
                            targets=len(push_entries))

        def fetch(target: str):
            """(cache entry, done-at, fetch+parse seconds, parse seconds
            or None on a body-cache hit). Two short circuits, cheapest
            first: for file targets an unchanged (mtime_ns, size, inode)
            signature skips even the read syscall (one stat is ~25x
            cheaper than open+read here); otherwise the body hash is
            compared (rejects a changed body without a memcmp), then the
            bytes themselves — exact, so a hash collision can never
            serve a stale parse. The stat is taken BEFORE the read: a
            write landing between them leaves a signature older than
            the body, which forces a re-read next refresh — an extra
            read, never a stale reuse. Runs in pool threads: installing
            a fresh entry is one GIL-atomic dict store, and the refresh
            thread only touches entries it collected."""
            fetch_start = time.monotonic()
            entry = self._parse_cache.get(target)
            stat_sig = None
            if "://" not in target:
                st = os.stat(target)
                stat_sig = _trusted_stat_sig(st)
                if (stat_sig is not None and entry is not None
                        and entry.stat_sig == stat_sig):
                    done = time.monotonic()
                    return entry, done, done - fetch_start, None
            body = fetch_exposition(target, timeout=self._fetch_timeout,
                                    headers=headers,
                                    ca_file=self._target_ca_file,
                                    insecure_tls=self._target_insecure_tls)
            if (entry is not None and entry.body_hash == hash(body)
                    and entry.body == body):
                # Touched but unchanged: adopt the new signature so the
                # stat path resumes short-circuiting next refresh.
                entry.stat_sig = stat_sig
                self.cardinality.touch(target)
                done = time.monotonic()
                return entry, done, done - fetch_start, None
            parse_start = time.monotonic()
            parse_ns = self.tracer.clock_ns() if self.tracer.enabled else 0
            series = parse_exposition_interned(body)
            # Pull-parse admission, the second state-birth
            # site: the same budgets that clamp a push FULL clamp a
            # pulled body before it becomes cached state. A
            # CardinalityShed (hard cap, nothing installed yet)
            # propagates as this target's fetch failure — counted and
            # breaker-struck per target, already shed-accounted by the
            # accountant.
            offered = len(series)
            admitted = self.cardinality.admit(target, offered)
            series = clamp_series(series, admitted)
            entry = _TargetCache(body, series, stat_sig)
            parse_seconds = time.monotonic() - parse_start
            if parse_ns:
                self.tracer.aux_span("parse", parse_ns, target=target)
            self._parse_cache[target] = entry
            self.cardinality.install(target, admitted, len(body),
                                     kind="pull",
                                     clamped=admitted < offered)
            done = time.monotonic()
            return entry, done, done - fetch_start, parse_seconds

        # Submit all before collecting any: one slow target must not
        # serialize the rest (same shape as top.snapshot_frame). The
        # refresh as a whole is deadlined too — urlopen's timeout bounds
        # individual socket operations, so a slow-drip target (headers,
        # then a byte every few seconds) would otherwise wedge the loop
        # forever while each recv stays under the per-op timeout.
        def fetch_chunk(chunk: list[str], progress: list) -> list[tuple]:
            # Per-target outcomes appended to a SHARED list as they
            # complete (GIL-atomic appends): if one member's read hangs,
            # the deadline handler salvages every outcome produced
            # before the hang and can identify the hung member (the
            # first one with no outcome) instead of guarding the whole
            # chunk. Exceptions caught per member so one bad file
            # degrades one target, not the chunk.
            for member in chunk:
                try:
                    progress.append((member, *fetch(member), None))
                except Exception as exc:  # noqa: BLE001 - per-target
                    progress.append((member, None, None, None, None, exc))
            return progress

        def stat_sweep(members: list[str], progress: list) -> list:
            """One pass of stat short-circuit checks over every file
            target: (member, hit-outcome or None) per member, where a
            hit carries the full cached-entry outcome and None means
            "needs a read" (changed, unknown, or stat failed — the read
            path re-raises with full per-target context). Appends to a
            SHARED progress list as it goes, same salvage contract as
            fetch_chunk. A few pool round trips replace per-chunk reads
            in the steady state: on an idle slice EVERY target resolves
            here, with one stat syscall apiece — and the stats release
            the GIL, so splitting the sweep across workers
            (_SWEEP_WAYS) overlaps the syscall waits."""
            for member in members:
                try:
                    start = time.monotonic()
                    hit = None
                    entry = self._parse_cache.get(member)
                    if entry is not None and entry.stat_sig is not None:
                        st = os.stat(member)
                        if (st.st_mtime_ns, st.st_size,
                                st.st_ino) == entry.stat_sig:
                            done = time.monotonic()
                            hit = (entry, done, done - start, None)
                    progress.append((member, hit))
                except OSError:
                    progress.append((member, None))
            return progress

        # Network targets submit FIRST (they block on sockets; get them
        # in flight). File targets go through the pooled stat sweep;
        # only the misses pay a read+parse, in CHUNKS: one pool wakeup
        # per ~16 files instead of per file (orchestration was ~half
        # the 64-target refresh wall, measured), while still running
        # under the pool + deadline so a target on a hung NFS/FUSE
        # mount wedges one pool worker's worth of targets — never the
        # refresh loop itself.
        fetch_mark = tracer.mark()
        futures: list[tuple[str, concurrent.futures.Future]] = []
        chunk_futures: list[tuple[list[str], list,
                                  concurrent.futures.Future]] = []
        fetch_seconds: dict[str, float] = {}
        local_targets: list[str] = []
        for target in self._targets:
            if target in push_entries:
                # Served by push this refresh: no pool submit, no
                # breaker consultation. A finished straggler fetch from
                # an earlier (pull-era) refresh still gets pruned.
                stuck = self._outstanding.get(target)
                if stuck is not None and stuck.done():
                    del self._outstanding[target]
                continue
            stuck = self._outstanding.get(target)
            if stuck is not None:
                if not stuck.done():
                    # Still wedged: counts against the breaker too, so a
                    # target that wedges refresh after refresh opens its
                    # circuit and stops being submitted once it drains.
                    self._breaker(target).record_failure(
                        "previous fetch still running")
                    reachable[target] = False
                    errors.append(f"{target}: previous fetch still running")
                    continue
                del self._outstanding[target]  # finished late; result stale
            breaker = self._breaker(target)
            if not breaker.allow():
                # Circuit open: marked down without burning a pool
                # worker or fetch_timeout on a known-dead target; the
                # recovery probe re-admits one fetch per recovery window.
                reachable[target] = False
                errors.append(f"{target}: circuit open ({breaker.describe()})")
                continue
            if "://" not in target:
                local_targets.append(target)
            else:
                futures.append((target, self._pool.submit(fetch, target)))
        CHUNK = 16
        # The sweep splits across a few pool workers: os.stat releases
        # the GIL, so 4 workers statting 16 files each finish in ~the
        # wall time one worker spends on 20 — measured 6.6 -> 4.4 ms on
        # the 64-target fixture. More ways than this just burns wakeups.
        sweeps: list[tuple[list[str], list,
                           concurrent.futures.Future]] = []
        if local_targets:
            ways = min(_SWEEP_WAYS, len(local_targets))
            per = -(-len(local_targets) // ways)
            for i in range(0, len(local_targets), per):
                members = local_targets[i:i + per]
                progress: list = []
                sweeps.append((members, progress,
                               self._pool.submit(stat_sweep, members,
                                                 progress)))
        # Prefetch the hub's own process_* readings on the pool too:
        # _publish's ~20 /proc syscalls (~2 ms here) overlap the fetch
        # phase instead of extending the refresh tail.
        proc_future = self._pool.submit(procstats.read)
        # Deadline scales with pool waves: more targets than workers run
        # in batches, and wave N's fetches only START after wave N-1 —
        # a flat 2x budget would mark healthy targets of a >32-worker
        # slice down every refresh just for queueing.
        # Deadline scales with the pool's critical path: network
        # fetches run pool-wide (waves of pool_size), while a chunk
        # SERIALIZES its members on one worker — so the budget must
        # grant a slow-but-alive filesystem (degraded NFS at ~1 s/read)
        # one fetch_timeout per chunk member, or healthy targets would
        # be marked down for queueing behind their chunk-mates. The
        # stat sweep serializes too — ceil(N/_SWEEP_WAYS) stats on one
        # worker — so it gets one slot per serialized stat, not a flat
        # one; the +1 covers the sweep-to-chunk handoff. The budget is
        # a cap, not a wait: healthy refreshes return as the futures
        # complete.
        waves = max(1, -(-len(futures) // self._pool_size))
        chunk_depth = min(CHUNK, len(local_targets))
        sweep_depth = (-(-len(local_targets)
                         // min(_SWEEP_WAYS, len(local_targets)))
                       if local_targets else 0)
        budget = ((waves + chunk_depth + sweep_depth + 1)
                  * self._fetch_timeout)
        deadline = time.monotonic() + budget

        def record_success(target: str, entry: _TargetCache, at: float,
                           took: float, parse_seconds: float | None) -> None:
            ats.append(at)
            entries.append((target, entry))
            reachable[target] = True
            fetch_seconds[target] = took
            if parse_seconds is None:
                self._body_cache_hits += 1
            else:
                self._parse_hist = self._parse_hist.observe(parse_seconds)
            if self.tracer.enabled:
                # Reconstructed from the measured wall time (the read
                # ran on a pool thread): the "which target" span of a
                # slow cycle's post-mortem.
                dur_ns = int(took * 1e9)
                self.tracer.aux_span(
                    "target_fetch", self.tracer.clock_ns() - dur_ns,
                    dur_ns=dur_ns, target=target,
                    cached=parse_seconds is None)
            self._breaker(target).record_success()

        # Push-served targets are already-collected outcomes: recorded
        # before the pull futures drain (order is normalized by target-
        # list position below). fetch_seconds 0.0 — the hub paid no
        # fetch; the publisher paid the diff on its own node.
        push_at = time.monotonic()
        target_set = set(self._targets)
        for target, entry in push_entries.items():
            if target not in target_set:
                continue  # evicted between sync and here (provider churn)
            ats.append(push_at)
            entries.append((target, entry))
            reachable[target] = True
            fetch_seconds[target] = 0.0
            self._breaker(target).record_success()

        def salvage_stalled(members: list[str], future, seen: set,
                            what: str) -> None:
            """Shared tail of a pool-worker stall (hung NFS/FUSE stat or
            read, FIFO): guard ONLY the hung member — the first with no
            outcome, it owns the blocked pool thread — and mark the
            unstarted rest down for this refresh; they resubmit cleanly
            next time without the guarded one. Only the hung member
            feeds its breaker: the others were victims of queueing, not
            failures of their own."""
            hung = next((m for m in members if m not in seen), None)
            if hung is not None:
                self._breaker(hung).record_failure(
                    f"{what} stalled past the refresh deadline "
                    f"({budget:g}s)")
                if not future.cancel():
                    self._outstanding[hung] = future
                self._blame_failed_fetch(hung, what, budget)
            for member in members:
                if member not in seen:
                    reachable[member] = False
                    errors.append(
                        f"{member}: {what} stalled past the refresh "
                        f"deadline ({budget:g}s)")

        # Resolve the sweeps before draining network futures, in
        # COMPLETION order: each sweep's miss read-chunks are submitted
        # the moment that sweep resolves, so they overlap the network
        # waits below — and one sweep hung on a dead mount can't hold
        # the healthy sweeps' misses hostage until the deadline (which
        # would time out their reads and charge breaker failures to
        # targets whose only fault was sharing a refresh with the hang).
        def record_sweep_outcomes(outcomes) -> None:
            misses = [member for member, hit in outcomes if hit is None]
            for i in range(0, len(misses), CHUNK):
                chunk = misses[i:i + CHUNK]
                progress = []
                chunk_futures.append(
                    (chunk, progress,
                     self._pool.submit(fetch_chunk, chunk, progress)))
            for member, hit in outcomes:
                if hit is not None:
                    record_success(member, *hit)

        sweep_by_future = {future: (members, progress)
                           for members, progress, future in sweeps}
        pending = set(sweep_by_future)
        try:
            for future in concurrent.futures.as_completed(
                    pending, timeout=max(0.0, deadline - time.monotonic())):
                pending.discard(future)
                record_sweep_outcomes(future.result())
        except concurrent.futures.TimeoutError:
            # A hung stat (dead NFS mount): for each still-unresolved
            # sweep, salvage what its progress list holds. Stat HITS
            # are complete outcomes and record directly; statted MISSES
            # would need reads the expired deadline can't fund —
            # chunking them now would just time the reads out and
            # charge a spurious breaker failure to the first member —
            # so they go down for this refresh with no breaker charge
            # (queueing victims, not failures) and re-read cleanly
            # next refresh, without the guarded hung member.
            for future in pending:
                members, progress = sweep_by_future[future]
                outcomes = list(progress)
                salvage_stalled(members, future,
                                {member for member, _ in outcomes}, "stat")
                for member, hit in outcomes:
                    if hit is not None:
                        record_success(member, *hit)
                    else:
                        reachable[member] = False
                        errors.append(
                            f"{member}: read skipped — stat sweep "
                            f"stalled past the refresh deadline "
                            f"({budget:g}s)")

        for target, future in futures:
            try:
                entry, at, took, parse_seconds = future.result(
                    timeout=max(0.0, deadline - time.monotonic()))
                record_success(target, entry, at, took, parse_seconds)
            except concurrent.futures.TimeoutError:
                if not future.cancel():
                    self._outstanding[target] = future
                reachable[target] = False
                self._breaker(target).record_failure(
                    f"fetch exceeded the refresh deadline ({budget:g}s)")
                errors.append(
                    f"{target}: fetch exceeded the refresh deadline "
                    f"({budget:g}s)")
                self._blame_failed_fetch(target, "deadline", budget)
            except Exception as exc:  # noqa: BLE001 - per-target degradation
                reachable[target] = False
                self._breaker(target).record_failure(exc)
                errors.append(f"{target}: {exc}")
        def record_outcomes(outcomes) -> set:
            seen = set()
            for member, entry, at, took, parse_seconds, exc in outcomes:
                seen.add(member)
                if exc is not None:
                    reachable[member] = False
                    self._breaker(member).record_failure(exc)
                    errors.append(f"{member}: {exc}")
                else:
                    record_success(member, entry, at, took, parse_seconds)
            return seen

        for chunk, progress, future in chunk_futures:
            try:
                outcomes = future.result(
                    timeout=max(0.0, deadline - time.monotonic()))
            except concurrent.futures.TimeoutError:
                # A hung filesystem read: salvage the outcomes produced
                # before the hang.
                salvage_stalled(chunk, future,
                                record_outcomes(list(progress)),
                                "file read")
                continue
            record_outcomes(outcomes)
        tracer.add_span("fetch", fetch_mark, targets=len(self._targets),
                        answered=len(entries))

        # Deterministic merge order: recording order depends on which
        # targets were cache hits this refresh (sweep hits land before
        # the network futures drain, sweep misses after), so the
        # "first target wins" duplicate resolution must not inherit it
        # — a colliding chip identity would flap between exporters as
        # their cache state changed. Order by position in this
        # refresh's target list instead; ats rides along (zip-aligned).
        if entries:
            order = {t: i for i, t in enumerate(self._targets)}
            paired = sorted(
                zip(entries, ats),
                key=lambda pair: order.get(pair[0][0], len(order)))
            entries = [pair[0] for pair in paired]
            ats = [pair[1] for pair in paired]

        # Frame assembly from cached per-target folds (fold_target keys
        # every row by target, so folds are disjoint and merge by dict
        # update). The frame gets per-row COPIES stamped with this
        # refresh's fetch timestamp: Frame.rates mutates rows in place,
        # and the pristine cached originals must replay next refresh.
        fold_mark = tracer.mark()
        rows: dict[tuple, ChipRow] = {}
        rollups: dict[tuple, float] = {}
        fold_native = self._fold_native
        for (target, entry), at in zip(entries, ats):
            trows, trollups = self._entry_fold(target, entry)
            if fold_native is not None:
                fold_native.fold_rows(rows, trows, at)
            else:
                for key, row in trows.items():
                    rows[key] = row.clone_at(at)
            rollups.update(trollups)
        frame = Frame(rows, errors, rollups)
        frame.rates(self._previous)
        self._previous = frame
        tracer.add_span("frame_fold", fold_mark)

        merge_mark = tracer.mark()
        builder = SnapshotBuilder()
        for target in self._targets:
            up = 1.0 if reachable.get(target) else 0.0
            builder.add(schema.HUB_TARGET_UP, up, (("target", target),))
            if self.history is not None:
                # Reachability per target goes into the ring too, so a
                # look back names the targets that were down then.
                self.history.record(schema.HUB_TARGET_UP.name,
                                    (("target", target),), up)
            took = fetch_seconds.get(target)
            if took is not None:
                builder.add(schema.HUB_TARGET_FETCH_SECONDS, took,
                            (("target", target),))
        builder.add(schema.HUB_TARGETS, float(len(self._targets)))
        builder.add(schema.HUB_WORKERS_EXPECTED, float(self._expect_workers))
        if not self._federate:
            # A federation root re-exports its LEAVES' slice_* rollups
            # (FEDERATED_SPECS, via the merge below) — the leaf closest
            # to each slice owns its rollup. Computing them again here
            # from any per-chip series the leaves forward would emit a
            # second, conflicting copy of every slice_* series.
            self._add_rollups(builder, frame)
        self._merge_chip_series(builder, entries,
                                emit_series=not self._rollups_only)
        if not self._rollups_only:
            self._merge_histograms(builder, entries)
        # Fleet lens scoring (before the parse views drop below: the
        # digest harvest is the last consumer of series_dicts, cached on
        # the entry like every other derived artifact).
        if self.fleet is not None:
            fleet_mark = tracer.mark()
            digests: dict[str, dict] = {}
            for target, entry in entries:
                digests[target] = self._entry_digest(entry)
            # Push-aware fetch signal: a push-served target's 0.0
            # fetch_seconds says the HUB paid nothing, but scoring it
            # would blind the lens to a publisher falling behind — feed
            # the delta-frame inter-arrival gap as that target's
            # freshness signal instead (same units: seconds of telemetry
            # latency the fleet actually experienced).
            fetch_signal = fetch_seconds
            if self.delta is not None and push_entries:
                gaps = self.delta.frame_gaps()
                fetch_signal = dict(fetch_seconds)
                for target in push_entries:
                    gap = gaps.get(target)
                    if gap:
                        fetch_signal[target] = gap
            self.fleet.observe(self._cycle_seq, time.time(),
                               self._targets, reachable, fetch_signal,
                               frame, digests)
            tracer.add_span("fleet_score", fleet_mark)
        # The parse views are consumed exactly once: every derived
        # artifact this hub's mode replays (frame fold, chip plan,
        # histogram fold) is now cached on the entry, so drop them — at
        # 256 targets a few thousand series each, the per-series label
        # dicts and tuples are tens of MB of RSS that the body
        # byte-compare and the cached plans never touch again. PUSHED
        # entries keep theirs: the interned series views ARE the state
        # the next delta frame patches.
        for _target, entry in entries:
            if not entry.pushed:
                entry.series = entry.series_dicts = None
        tracer.add_span("merge", merge_mark)
        try:
            proc_readings = proc_future.result(
                timeout=max(0.0, deadline - time.monotonic()))
        except Exception:  # noqa: BLE001 - fall back to an inline read
            proc_readings = None
        publish_mark = tracer.mark()
        self._publish(builder, start, proc_readings)
        tracer.add_span("publish", publish_mark)
        tracer.end(targets=len(self._targets), answered=len(entries),
                   errors=len(errors))
        for err in errors:
            # One line per target per 30 s, not per refresh: a sustained
            # outage at the 10 s cadence is 360 identical lines/hour per
            # target otherwise (slice_target_up carries the state).
            # Split on ": " (the f"{target}: {message}" separator), not
            # ":" — URL targets contain colons, and splitting on the
            # bare colon would collapse every http target onto one
            # "http" key, suppressing all but one target's reason.
            key = err.split(": ", 1)[0]
            if log_every(f"hub:refresh:{key}", 30.0):
                log.warning("hub refresh: %s (repeats suppressed for "
                            "30s)", err)
        return frame

    def _sync_push_entries(self) -> dict[str, "_TargetCache"]:
        """target -> ready entry for every push-served target this
        refresh. Frames already applied themselves onto the entries at
        POST time (DeltaIngest.apply, on the handler threads — spread
        over the refresh interval); the refresh only asks which
        sessions are fresh within the fence and picks their entries up.
        A fresh session whose entry is missing (eviction race, pull
        fallback replaced it) is skipped: its next delta frame draws a
        409 -> FULL resync, and this refresh falls back to pull."""
        if self.delta is None:
            return {}
        out: dict[str, _TargetCache] = {}
        for source in self.delta.fresh_sources(self._push_fence):
            entry = self._parse_cache.get(source)
            if entry is not None and entry.pushed:
                out[source] = entry
        return out

    # -- federation energy/waste attestation ---------------------------------

    # Leaves folded per attestation: bounds the handler-thread fetch
    # fan-out on a big fleet (the bound is attested — totals carries
    # targets_total vs leaves so a truncated fold is visible, never
    # silent). The TTL keeps a scrape storm on /debug/efficiency from
    # re-fetching every leaf per request.
    _ENERGY_FOLD_CAP = 8
    _ENERGY_FOLD_TTL = 30.0

    def _fetch_energy_digest(self, url: str) -> dict:
        import json
        import urllib.request

        request = urllib.request.Request(url)
        if self._headers_provider is not None:
            try:
                for key, value in (self._headers_provider() or {}).items():
                    request.add_header(key, value)
            except Exception:  # noqa: BLE001 - a token-file hiccup must
                # not kill the fold; the leaf then answers 401 and rides
                # the attestation as an {"error": ...} stub.
                pass
        with urllib.request.urlopen(
                request, timeout=self._fetch_timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _leaf_energy_digests(self) -> tuple[dict[str, dict], int]:
        """(target -> /debug/energy digest, eligible-target count) for
        the attestation fold. Runs on HTTP handler threads (never the
        refresh loop — N extra fetches must not blow the refresh
        deadline), TTL-cached so scrapes amortize. Unreachable leaves
        ride along as {"error": ...} stubs: a partial fold is still an
        attestation, and the stub names the gap."""
        http_targets = [t for t in self._targets
                        if t.startswith(("http://", "https://"))]
        with self._energy_digest_lock:
            cached = self._energy_digest_cache
            if (cached is not None
                    and time.monotonic() - cached[0] < self._ENERGY_FOLD_TTL):
                return cached[1], len(http_targets)
        fetcher = self._energy_fetcher or self._fetch_energy_digest
        leaves: dict[str, dict] = {}
        for target in http_targets[:self._ENERGY_FOLD_CAP]:
            base = target.rstrip("/")
            if base.endswith("/metrics"):
                base = base[:-len("/metrics")]
            try:
                leaves[target] = fetcher(base + "/debug/energy")
            except Exception as exc:  # noqa: BLE001 - the stub is the
                # evidence; the leaf's reachability already has its own
                # freshness anomaly on the lens side.
                leaves[target] = {"error": str(exc)}
        with self._energy_digest_lock:
            self._energy_digest_cache = (time.monotonic(), leaves)
        return leaves, len(http_targets)

    def efficiency_payload(self) -> dict:
        """The /debug/efficiency provider: the leaves' signed
        /debug/energy digests folded with this hub's waste ledger into
        one canonical-JSON HMAC-signed attestation (efficiency.py owns
        the shape; `doctor --efficiency` verifies the signature)."""
        if not self._efficiency_enabled or self.fleet is None:
            return {"enabled": False, "reason": "--no-efficiency"}
        leaves, targets_total = self._leaf_energy_digests()
        return efficiency_mod.build_attestation(
            self.fleet.efficiency_summary(), leaves,
            self._energy_audit_key,
            node=os.environ.get("HOSTNAME", ""),
            generated_at=time.time(),
            targets_total=targets_total)

    def _blame_failed_fetch(self, target: str, what: str,
                            budget: float) -> None:
        """Record a target_fetch aux span for a fetch that blew the
        refresh deadline: successful fetches already
        record target-attributed spans, so without this the one fetch
        that actually MADE the cycle slow was the only one missing from
        the slowest-cycle table's blame — the hub-side parity of the
        daemon's device/port blame. The span is stamped with the whole
        budget: that is what the wedged fetch cost this cycle."""
        if not self.tracer.enabled:
            return
        dur_ns = int(budget * 1e9)
        self.tracer.aux_span("target_fetch", self.tracer.clock_ns() - dur_ns,
                             dur_ns=dur_ns, target=target, error=what)

    def _publish(self, builder: SnapshotBuilder, start: float,
                 proc_readings: dict | None = None) -> None:
        """Shared publish tail for every refresh outcome (normal and
        zero-targets): self-metrics must never vanish from one branch —
        push senders keep shipping while decommissioned, so their
        collector_push_* health counters must keep rendering too.
        ``proc_readings`` is a procstats.read() the refresh prefetched
        on the pool (overlapped with the fetch phase); None reads
        inline (the cold zero-target branch)."""
        self._refresh_hist = self._refresh_hist.observe(
            time.monotonic() - start)
        builder.add_histogram(self._refresh_hist)
        # Ingest-cache self-metrics: hits say how often the zero-reparse
        # short circuit fired; the parse histogram prices the misses.
        builder.add(schema.HUB_BODY_CACHE_HITS, float(self._body_cache_hits))
        builder.add_histogram(self._parse_hist)
        # Flight-recorder health: nonzero means /debug/trace truncates.
        builder.add(schema.TRACE_DROPPED_SPANS,
                    float(self.tracer.dropped_spans_total))
        # The hub's own cycle digest (same families the daemons export),
        # so a hub-of-hubs attributes slow hubs exactly like slow nodes.
        fleetlens.contribute_trace_digest(builder, self.tracer)
        # Fleet-lens gauges: anomaly counts, SLO burn windows, worst
        # node. Contributed on EVERY publish branch (zero-targets too):
        # the burn state must not vanish mid-incident.
        if self.fleet is not None:
            self.fleet.contribute(builder)
            # Link-suspect verdicts ride the history ring so
            # `doctor --fleet --at` can name a sick link after the
            # incident cleared. Tombstone rows (0.0) are recorded too:
            # nearest-sample reads must see the recovery.
            if self.history is not None:
                for link, reason, value in self.fleet.link_history_rows():
                    self.history.record(
                        schema.FLEET_LINK_SUSPECT.name,
                        (("link", link), ("reason", reason)), value)
                # Waste verdicts ride the ring too: `doctor --efficiency
                # --at` answers "who was wasting cards during the
                # incident" after the pod recovered.
                for pod, namespace, reason, value in \
                        self.fleet.waste_history_rows():
                    self.history.record(
                        schema.FLEET_WASTE_SUSPECT.name,
                        (("pod", pod), ("namespace", namespace),
                         ("reason", reason)), value)
        # Delta-ingest self-metrics: frame mix, wire bytes,
        # resync rate, and how much of the fleet rides push vs pull.
        if self.delta is not None:
            builder.add(schema.DELTA_FRAMES,
                        float(self.delta.full_frames_total),
                        (("kind", "full"),))
            builder.add(schema.DELTA_FRAMES,
                        float(self.delta.delta_frames_total),
                        (("kind", "delta"),))
            builder.add(schema.DELTA_BYTES, float(self.delta.bytes_total))
            builder.add(schema.HUB_RESYNC, float(self.delta.resyncs_total))
            builder.add(schema.DELTA_PUSH_TARGETS,
                        float(self._push_served))
            # Sharded-ingest health: lane count + native
            # path in effect, and per-lane session spread / frame
            # volume / handler-thread apply seconds — the evidence the
            # "Scaling ingest" runbook keys on (one lane hot while the
            # rest idle = a pathological source hash or one chatty
            # publisher, not an undersized hub).
            builder.add(schema.INGEST_LANES, float(self.delta.lanes))
            builder.add(schema.INGEST_NATIVE,
                        1.0 if self.delta.native_active else 0.0)
            # Overload-survival self-metrics. Shed reasons
            # are born at 0 for every reason the guard can emit, so
            # increase()-based IngestShedHigh alerting sees the first
            # shed of each class.
            shed = self.delta.shed_total
            for reason in ("delta_rate", "inflight", "memory",
                           "quarantined"):
                builder.add(schema.INGEST_SHED,
                            float(shed.get(reason, 0)),
                            (("reason", reason),))
            builder.add(schema.INGEST_QUARANTINED,
                        float(self.delta.quarantined))
            builder.add(schema.HUB_WARM_RESTART_SESSIONS,
                        float(self.delta.warm_restart_sessions))
            builder.add(schema.HUB_WARM_RESTART_PENDING,
                        float(self.delta.warm_restart_pending))
            if self.delta.warm_restart_replay_seconds:
                builder.add(schema.HUB_WARM_RESTART_REPLAY_SECONDS,
                            self.delta.warm_restart_replay_seconds)
            builder.add(schema.HUB_WARM_RESTART_CHECKPOINT_WRITES,
                        float(self.delta.checkpoint_writes))
            age = self.delta.checkpoint_age()
            if age is not None:
                builder.add(schema.HUB_WARM_RESTART_CHECKPOINT_AGE, age)
            for index, lane in enumerate(self.delta.lane_stats()):
                labels = (("lane", str(index)),)
                builder.add(schema.INGEST_LANE_SESSIONS,
                            lane["sessions"], labels)
                builder.add(schema.INGEST_LANE_FRAMES,
                            lane["frames"], labels)
                builder.add(schema.INGEST_LANE_APPLY_SECONDS,
                            lane["apply_seconds"], labels)
            # Fleet version census + skew refusals: the
            # census-gated-rollout gauge (one series per live publisher
            # build; on a federation root the leaves' sessions census
            # the whole tree) and the refused-peer counter doctor
            # --skew explains.
            for version, count in sorted(
                    self.delta.fleet_versions().items()):
                builder.add(schema.FLEET_VERSION_COUNT, float(count),
                            (("version", version),))
        # Cardinality admission self-metering: the series
        # ledger, its sheds/evictions and the top-K offenders — on
        # EVERY publish branch (a mid-bomb zero-target refresh must not
        # blank the evidence). 'exposition' is the previous publish's
        # series count (tick N exports N-1's size, the trace-digest
        # convention — the first publish omits it rather than lie 0).
        snapshot = self.registry.snapshot()
        contribute_cardinality(
            builder, self.cardinality,
            exposition_series=(len(snapshot.series)
                               if snapshot.timestamp > 0 else None))
        if self._federate:
            # Born at 0 on every federation root (increase() alerting):
            # non-federate hubs never re-export slice_* series, so the
            # collision class cannot exist there and the series stays
            # absent.
            builder.add(schema.HUB_DUP_SLICE,
                        float(self._dup_slice_total))
        # Per-target breaker state: the hub's resilience self-metrics,
        # same families the daemon exports for its edges.
        for target in sorted(self._breakers):
            breaker = self._breakers[target]
            labels = (("component", f"target:{target}"),)
            builder.add(schema.BREAKER_STATE, breaker.state_value(), labels)
            builder.add(schema.BREAKER_TRIPS, float(breaker.trips_total),
                        labels)
        if self._render_stats is not None:
            self._render_stats.contribute(builder)
        push_stats = (self._push_stats()
                      if self._push_stats is not None else None)
        if push_stats is not None:
            contribute_push_stats(builder, push_stats)
        if self._egress_stats is not None:
            contribute_egress_stats(builder, self._egress_stats())
        # Rolling-upgrade census inputs: this hub's build +
        # wire range on its own exposition, skew refusals it issued
        # (ingest) PLUS any it drew as a leaf pushing upstream (one
        # unlabeled counter — summed at the source so the series stays
        # unique), and persisted formats quarantined at startup.
        from . import __version__ as _build

        builder.add(
            schema.BUILD_INFO, 1.0,
            [("version", _build),
             ("proto_min", str(delta_mod.PROTO_MIN)),
             ("proto_max", str(delta_mod.PROTO_MAX))])
        skew_refused = (self.delta.skew_refused_total
                        if self.delta is not None else 0)
        if push_stats is not None:
            skew_refused += sum(entry.get("skew_refused", 0)
                                for entry in push_stats.values())
        builder.add(schema.SKEW_REFUSED, float(skew_refused))
        for store, count in sorted(wal_mod.quarantine_counts().items()):
            builder.add(schema.WAL_QUARANTINED, float(count),
                        (("store", store),))
        # Local fault survival: per-store durability state +
        # fault/loss accounting for the ingest checkpoint, any spill
        # queue / remote-write WAL this hub runs, and the accept fence.
        contribute_store_metrics(builder)
        if self._supervisor is not None:
            # Thread supervision self-metrics (kts_component_* +
            # restart storms) on the hub's own exposition, the daemon
            # contract.
            self._supervisor.contribute(builder)
        # The hub's own process health (CPU, RSS, fds) — same process_*
        # families the daemon exports, so one dashboard covers both.
        procstats.contribute(builder, proc_readings)
        # Render-lock contention: the pre-warmer's cumulative wait on
        # the publish lock (also in /debug/ticks meta).
        builder.add(schema.RENDER_PREWARM_WAIT,
                    self.registry.render_wait_seconds)
        for contribute in self._extra_metrics:
            try:
                contribute(builder)
            except Exception:  # noqa: BLE001 - a broken contributor
                # must cost its own families, never the publish.
                log.exception("extra metrics provider failed")
        if self.history is not None:
            # The ring's own families ride the snapshot they describe.
            self.history.contribute(builder)
        self.registry.publish(builder.build())
        if self.history is not None:
            # After the publish: the ring serves the generation readers
            # see, so /query's and /metrics' ETags move together.
            self.history.commit(time.time(), self.registry.generation)
        if self.delta is not None:
            # Warm-restart checkpoint: written HERE, on the
            # refresh thread, never on a handler thread — rate-limited
            # inside (one fsync per checkpoint interval at most).
            self.delta.checkpoint()

    def ready(self) -> tuple[bool, str]:
        """Readiness for /readyz: a hub is ready to serve traffic only
        when it has targets AND has published. Deliberate decommission
        (empty targets file) goes NotReady — scrapers drain — while
        /healthz stays 200 so the liveness probe never restart-loops;
        a discovery endpoint broken from boot never goes Ready, so a
        rollout cannot replace a working hub with a blind one."""
        if self.registry.snapshot().timestamp <= 0:
            return False, "no snapshot published yet"
        if self.delta is not None and self.delta.replaying:
            # Warm restart in progress: live (refreshing, /healthz 200)
            # but not ready — scrapers drain to fully-resumed hubs
            # instead of reading a partially-replayed fleet view.
            return False, (f"warm restart: "
                           f"{self.delta.warm_restart_pending} session(s) "
                           f"awaiting replay")
        if not self._targets:
            return False, "no targets (discovery empty or decommissioned)"
        return True, "ready"

    def _refresh_targets(self) -> None:
        """Re-resolve dynamic targets, merge live delta-push sources,
        and prune per-target state for departed ones (pod churn under
        DNS discovery must not grow the histogram cache or the
        outstanding-fetch map forever)."""
        if self._targets_provider is not None:
            try:
                resolved = list(dict.fromkeys(self._targets_provider()))
                # An empty SUCCESS is accepted: an operator emptying the
                # targets file has decommissioned the slice — the hub
                # must stop scraping the dead targets (publishing the
                # minimal snapshot: /readyz 503 drains scrapers,
                # /healthz stays 200), not hold them forever. Only a
                # provider *failure* keeps the previous list.
                if resolved != self._configured:
                    log.info("targets: %d -> %d after discovery",
                             len(self._configured), len(resolved))
                self._configured = resolved
            except Exception as exc:  # noqa: BLE001 - keep the previous list
                log.warning(
                    "target discovery failed, keeping %d target(s): %s",
                    len(self._configured), exc)
        targets = list(self._configured)
        if self.delta is not None:
            # Live push sources ARE targets: a worker that announces
            # itself over the delta protocol needs no entry in any
            # target list (push-only fleets run a hub with zero
            # configured targets). sources() drops sessions silent past
            # the expiry, so a decommissioned worker leaves the slice
            # view — and its cached state is evicted just below.
            known = set(targets)
            targets += [s for s in self.delta.sources() if s not in known]
        # Cardinality ledger churn: advance the idle clock,
        # release departed sources' footprints, then — above the high
        # watermark — LRU-evict idle sources. Evicted PUSH sources
        # leave the target list right here, so the prune loops below
        # (parse cache, breakers, fleet baselines, delta session) sweep
        # their state on the one churn path that already exists;
        # evicted CONFIGURED pull targets stay listed (the operator
        # chose them — only their cached state is released, and the
        # next fetch re-admits them).
        self.cardinality.tick()
        alive_now = set(targets)
        for source in self.cardinality.ledger_sources():
            if source not in alive_now:
                self.cardinality.forget(source)
        evicted = set(self.cardinality.evict_idle())
        if evicted:
            keep = set(self._configured)
            targets = [t for t in targets
                       if t not in evicted or t in keep]
            for target in evicted & keep:
                self._hist_cache.pop(target, None)
                try:
                    del self._parse_cache[target]
                except KeyError:
                    pass
        if targets != self._targets:
            self._targets = targets
        alive = set(targets)
        for target in [t for t in self._hist_cache if t not in alive]:
            del self._hist_cache[target]
        # The body/parse caches evict on the same path:
        # a churning discovered target list must not pin dead targets'
        # bodies and merge plans forever. list() first: a timed-out
        # fetch still running on a pool thread can insert a key
        # mid-iteration (fetch() stores fresh entries), and iterating
        # the live dict would raise and abort the whole refresh.
        for target in [t for t in list(self._parse_cache) if t not in alive]:
            del self._parse_cache[target]
        # Breakers for departed targets go with them (pod churn under
        # DNS discovery must not grow this map forever).
        for target in [t for t in self._breakers if t not in alive]:
            del self._breakers[target]
        # Fleet baselines and anomaly counters evict on the same path —
        # and so does delta-session state: a target
        # churned out of the list must not keep a live seq chain that a
        # restarted worker's frames could splice onto.
        if self.fleet is not None:
            self.fleet.evict(alive)
        if self.delta is not None:
            self.delta.evict(alive)
        # The stuck-fetch map prunes only FINISHED futures: a target
        # that flaps out of DNS and back must still be guarded against
        # its wedged fetch, or each flap would pin another pool worker.
        for target, future in list(self._outstanding.items()):
            if target not in alive and future.done():
                del self._outstanding[target]

    @staticmethod
    def _disambiguate_worker(labels: Mapping[str, str],
                             target: str) -> Mapping[str, str]:
        """Present-but-empty worker labels get the target as their
        worker value: two dev-VM/embedded exporters both exporting chip
        0 are different hardware. Unconditional (not gated on target
        count): under DNS discovery the count churns, and series
        identity must not flip between worker="" and worker=<target> as
        pods come and go — Prometheus would see new series + phantom
        resets. One rule for gauges AND histograms, so the merged
        exposition stays internally consistent."""
        if labels.get("worker", None) == "":
            labels = dict(labels)
            labels["worker"] = str(target)
        return labels

    @staticmethod
    def _disambiguate_worker_tuple(
            labels: tuple[tuple[str, str], ...],
            target: str) -> tuple[tuple[str, str], ...]:
        """_disambiguate_worker over the interned label-tuple form the
        chip plans are built from. Returns the input tuple untouched
        (pointer-shared pool object) unless a present-but-empty worker
        pair needs replacing — the tuple copy happens once per plan
        build, never per refresh."""
        for i, (name, value) in enumerate(labels):
            if name == "worker":
                if value == "":
                    return (labels[:i] + (("worker", str(target)),)
                            + labels[i + 1:])
                return labels
        return labels

    @staticmethod
    def _worker_id(row) -> str:
        """Worker identity for rollups: the worker topology label, or the
        target itself when the exporter carries no worker label (dev VMs,
        embedded exporters) — two unlabeled targets are still two
        workers."""
        return row.key[2] or str(row.key[0])

    def _add_rollups(self, builder: SnapshotBuilder, frame: Frame) -> None:
        """Slice rollups over the chips that ANSWERED this refresh —
        the deliberate dip policy: summed
        gauges (slice_memory_used_bytes, slice_power_watts, slice_chips,
        aggregate ICI) drop by a missing worker's share for exactly the
        refreshes it misses, with slice_target_up naming the target as
        the explainer. The alternative — holding last-known values —
        would report a dead worker's power and HBM as live data for as
        long as the staleness bound, which is fabrication, not
        telemetry. Alert design follows from the policy: threshold
        alerts on sums must use `for:` windows longer than one refresh
        (the shipped rules do), and presence alerting belongs on
        slice_target_up / slice_workers, not on sum levels. Cumulative
        HISTOGRAMS get the opposite treatment (_hist_cache holds the
        last contribution) because a dipping counter is semantically a
        reset — Prometheus would rate() a phantom spike — while a
        dipping gauge is simply the current truth."""
        hist = self.history
        if hist is None:
            add = builder.add
        else:
            # One seam for both: each rollup series goes into the
            # snapshot and is staged for the ring, so the ring holds
            # exactly what the exposition said.
            def add(spec, value, labels=()):
                builder.add(spec, value, labels)
                hist.record(spec.name, labels, value)
        by_slice: dict[str, list] = {}
        for row in frame.rows.values():
            by_slice.setdefault(row.key[1], []).append(row)
        for slice_name in sorted(by_slice):
            rows = by_slice[slice_name]
            labels = (("slice", slice_name),)
            add(schema.HUB_CHIPS, float(len(rows)), labels)
            add(schema.HUB_CHIPS_UP,
                        float(sum(1 for r in rows if r.up == 1.0)), labels)
            workers = {self._worker_id(r) for r in rows}
            add(schema.HUB_WORKERS, float(len(workers)), labels)
            duties = [r.duty for r in rows if r.duty is not None]
            if duties:
                add(schema.HUB_DUTY_MEAN,
                            sum(duties) / len(duties), labels)
                add(schema.HUB_DUTY_MIN, min(duties), labels)
                add(schema.HUB_DUTY_MAX, max(duties), labels)
            mfus = [r.mfu for r in rows if r.mfu is not None]
            if mfus:
                add(schema.HUB_MFU_MEAN,
                            sum(mfus) / len(mfus), labels)
                add(schema.HUB_MFU_MIN, min(mfus), labels)
            used = [r.mem_used for r in rows if r.mem_used is not None]
            if used:
                add(schema.HUB_MEMORY_USED, sum(used), labels)
            total = [r.mem_total for r in rows if r.mem_total is not None]
            if total:
                add(schema.HUB_MEMORY_TOTAL, sum(total), labels)
            power = [r.power for r in rows if r.power is not None]
            if power:
                add(schema.HUB_POWER, sum(power), labels)
            # Per-slice joules: sum of the per-chip energy
            # counters over answered chips — a gauge under the dip
            # policy (see the docstring); audit-grade per-pod totals
            # live in each node's signed /debug/energy digest.
            energies = [r.energy_total for r in rows
                        if r.energy_total is not None]
            if energies:
                add(schema.HUB_ENERGY, sum(energies), labels)
            # Gate on series presence, not value: an idle interconnect is
            # a 0 reading, not a vanished series (absent() alerting).
            if any(r.ici_links for r in rows):
                add(schema.HUB_ICI_BANDWIDTH,
                            sum(r.ici_bps for r in rows), labels)
            # Per-worker step rate = mean over the worker's chips (SPMD:
            # every chip participates in each step, so chips of one
            # worker report the same counter — mean, not sum). One
            # definition shared with the fleet lens's straggler SLO
            # (fleetlens.worker_step_rates), so the SLO can never
            # desynchronize from the exported rollup.
            worker_rates = fleetlens.worker_step_rates(rows)
            rates = []
            for worker in sorted(worker_rates):
                rate = worker_rates[worker]
                rates.append(rate)
                add(schema.HUB_WORKER_STEPS, rate,
                            labels + (("worker", worker),))
            if rates and max(rates) > 0:
                add(schema.HUB_STRAGGLER_RATIO,
                            min(rates) / max(rates), labels)

    def _build_merge_plan(self, target: str, entry: "_TargetCache",
                          specs: Mapping[str, schema.MetricSpec]) -> tuple:
        """Pre-resolve one target's re-export merge work for the given
        spec set — the per-target series index of the incremental
        merge: (dedup-key frozenset, (dedup key, ready-to-emit Series)
        pairs, self-collision flag, series-slot -> pair-index map).
        Built once per PARSE or push resync (not per refresh): label
        tuples arrive interned from validate's pools, so the sorted-key
        memo and the Series objects are shared across every refresh the
        state stays unchanged, and a changed body simply rebuilds this
        target's plan (the full-rebuild fallback for any series-shape
        change). The slot map lets a delta patch rebuild exactly the
        changed pairs in place (labels can't change in a delta).

        The value-free SKELETON of the plan — dedup keys, specs,
        disambiguated label tuples, slot map — is a pure function of
        (target, interned series shape, spec set) and is memoized
        across entry lives: a rebuilt parse with the same
        shape (body changed values only, or the target churned out and
        back) re-stamps current values into fresh Series pairs and
        skips the per-slot spec lookup / worker disambiguation /
        sorted-key build entirely. The ``pairs`` list is always fresh
        per plan (apply_patch replaces its cells in place); the
        frozenset/slot_map are immutable-by-convention and shared.

        The frozenset is the replay fast path: a target whose keys are
        disjoint from every earlier target's merges with two C-level set
        ops and one list extend. ``self_dup`` (a target colliding with
        ITSELF — duplicate series in one exposition) forces the per-key
        path, because the frozenset would silently swallow the
        duplicate instead of counting and dropping it."""
        series = entry.series
        # id(specs) is a safe key component: the only spec sets reaching
        # this path are the PER_CHIP_SPECS / FEDERATED_SPECS module
        # constants, which live for the process.
        memo_key = (target, id(specs), entry.shape_key())
        skeleton = self._plan_memo.get(memo_key)
        if skeleton is not None:
            keys, pair_meta, self_dup, slot_map, pair_slots = skeleton
            pairs = [(key, Series(spec, label_tuple,
                                  float(series[slot][2])))
                     for (key, spec, label_tuple), slot
                     in zip(pair_meta, pair_slots)]
            return keys, pairs, self_dup, slot_map
        pairs: list[tuple[tuple, Series]] = []
        slot_map: dict[int, int] = {}
        pair_meta: list[tuple] = []
        pair_slots: list[int] = []
        for slot, (name, labels, value) in enumerate(series):
            spec = specs.get(name)
            if spec is None:
                continue
            label_tuple = self._disambiguate_worker_tuple(labels, target)
            key = (name, bounded_memo(
                self._key_cache, label_tuple,
                lambda: tuple(sorted(label_tuple))))
            slot_map[slot] = len(pairs)
            pairs.append((key, Series(spec, label_tuple, float(value))))
            pair_meta.append((key, spec, label_tuple))
            pair_slots.append(slot)
        keys = frozenset(key for key, _ in pairs)
        self_dup = len(keys) != len(pairs)
        if len(self._plan_memo) >= _PLAN_MEMO_MAX:
            self._plan_memo.clear()
        self._plan_memo[memo_key] = (keys, tuple(pair_meta), self_dup,
                                     slot_map, tuple(pair_slots))
        return keys, pairs, self_dup, slot_map

    @staticmethod
    def _replay_plan(plan: tuple, seen: set, emit: list | None,
                     dup_sink: list | None = None) -> int:
        """Replay one built plan into ``emit`` against the cross-target
        ``seen`` set; returns dropped-duplicate count. ``dup_sink``
        collects the dropped keys (the federated-rollup replay wants to
        name the colliding slice, not just count it)."""
        keys, pairs, self_dup, _slot_map = plan
        if not self_dup and seen.isdisjoint(keys):
            # The common case: this target claims no series identity
            # any earlier target claimed — merge it wholesale.
            seen |= keys
            if emit is not None:
                emit.extend(series for _, series in pairs)
            return 0
        duplicates = 0
        seen_add = seen.add
        for key, series in pairs:
            if key in seen:
                duplicates += 1
                if dup_sink is not None:
                    dup_sink.append(key)
                continue
            seen_add(key)
            if emit is not None:
                emit.append(series)
        return duplicates

    @staticmethod
    def _entry_fold(target: str, entry: _TargetCache) -> tuple[dict, dict]:
        """The target's cached frame fold (rows, rollups)."""
        def build() -> tuple[dict, dict]:
            rows: dict[tuple, ChipRow] = {}
            rollups: dict[tuple, float] = {}
            fold_target(entry.series_dicts, target, 0.0, rows, rollups)
            return rows, rollups
        return entry.view(("frame_rows", "frame_rollups"), build)

    @staticmethod
    def _entry_digest(entry: _TargetCache) -> dict:
        """The target's cached fleet digest."""
        return entry.view(("fleet_digest",), lambda: (
            fleetlens.digest_from_series(entry.series_dicts),))[0]

    def _replay_chip_plans(self, entries, emit: list | None,
                           rollup_emit: list | None = None) -> int:
        """Replay every answered target's chip plan into ``emit`` and,
        under --federate, its slice-rollup re-export plan into
        ``rollup_emit`` (separate sinks: --rollups-only silences the
        per-chip series while the federated rollups keep flowing),
        deduplicating across targets (first target wins). Returns the
        duplicate count. The cross-target ``seen`` set is rebuilt every
        refresh on purpose — it is the one piece of state that depends
        on which targets answered, so recomputing it keeps target churn
        trivially correct."""
        seen: set[tuple] = set()
        duplicates = 0
        rollup_dups: list = []
        for target, entry in entries:
            plan, = entry.view(("chip_plan",), lambda: (
                self._build_merge_plan(target, entry, PER_CHIP_SPECS),))
            duplicates += self._replay_plan(plan, seen, emit)
            if self._federate:
                rollup, = entry.view(("rollup_plan",), lambda: (
                    self._build_merge_plan(target, entry, FEDERATED_SPECS),))
                duplicates += self._replay_plan(rollup, seen, rollup_emit,
                                                rollup_dups)
        if rollup_dups:
            self._note_dup_slices(rollup_dups)
        return duplicates

    def _note_dup_slices(self, dup_keys: list) -> None:
        """Two leaves re-exported the same slice_* series identity
        (shared slice label — misconfigured KTS_SLICE, or a leaf listed
        twice): first-wins silently drops the second leaf's series, so
        this is the ONLY evidence. Counted in
        kts_hub_dup_slice_total and journaled per slice, rate-limited —
        a persistent misconfig collides every refresh and must not
        flood the bounded journal out of its rarer events."""
        self._dup_slice_total += len(dup_keys)
        per_slice: dict[str, int] = {}
        for _name, key in dup_keys:
            labels = dict(key)
            slice_name = labels.get("slice") or labels.get("target", "")
            per_slice[slice_name] = per_slice.get(slice_name, 0) + 1
        for slice_name in sorted(per_slice):
            if log_every(f"hub:dup_slice:{slice_name}", 60.0):
                self.tracer.event(
                    "delta_dup_slice",
                    f"slice {slice_name!r}: {per_slice[slice_name]} "
                    f"federated rollup series dropped (two leaves share "
                    f"the slice label; first leaf wins)",
                    slice=slice_name, dropped=per_slice[slice_name])
                log.warning(
                    "hub: %d federated rollup series for slice %r "
                    "dropped — two leaves share the slice label "
                    "(repeats suppressed for 60s, kts_hub_dup_slice_total "
                    "carries the count)",
                    per_slice[slice_name], slice_name)

    def _merge_chip_series(self, builder: SnapshotBuilder,
                           entries: Sequence[tuple[str, _TargetCache]],
                           emit_series: bool = True) -> None:
        """Re-export every known per-chip series, first target wins on
        identity collisions (Prometheus rejects an exposition with
        duplicate series, so dedup is correctness, not tidiness).
        With ``emit_series`` False (--rollups-only) the merge still runs
        for its collision count — slice_duplicate_series is the
        documented detector for two targets claiming one chip, and the
        rollups-only mode is where the per-chip series can't reveal it.

        Incremental: each target's tokenize/disambiguate/sort
        work lives in its cached chip plan; the per-refresh cost here is
        two set operations per non-colliding target (_replay_chip_plans).

        Two disambiguation rules keep legitimate setups collision-free:
        series whose ``worker`` label is present-but-empty get the target
        as their worker value (two dev-VM/embedded exporters both
        exporting chip 0 are different hardware — same rule _worker_id
        applies to rollups; unconditional so series identity is stable
        under target-count churn), and the
        dedup key sorts labels so a third-party exporter rendering the
        same label set in a different order still collides instead of
        slipping through as a Prometheus-identical duplicate."""
        out: list[Series] = []
        duplicates = self._replay_chip_plans(
            entries,
            out if emit_series else None,
            # A --federate --rollups-only root serves ONLY the leaves'
            # slice_* rollups: the re-export must flow even when the
            # per-chip series are silenced.
            out if self._federate else None)
        if out:
            builder.extend_series(out)
        builder.add(schema.HUB_DUPLICATE_SERIES, float(duplicates))
        if duplicates and log_every("hub:duplicates", 60.0):
            log.warning(
                "hub: dropped %d duplicate per-chip series (two targets "
                "export the same chip identity — check topology labels; "
                "repeats suppressed for 60s, slice_duplicate_series "
                "carries the count)",
                duplicates)

    def _build_hist_local(self, target: str, series: Sequence) -> dict:
        """Fold one target's histogram series into its per-target
        contribution — cached on the target's _TargetCache, so an
        unchanged body replays the fold for free."""
        local: dict[tuple, dict] = {}
        for name, labels, value in series:
            hit = _HIST_SUFFIXES.get(name)
            if hit is None:
                continue
            fam, part = hit
            items = self._disambiguate_worker(labels, target)
            key = (fam, tuple(sorted(
                (k, v) for k, v in items.items() if k != "le")))
            entry = local.setdefault(
                key, {"buckets": {}, "sum": 0.0, "count": 0.0})
            if part == "bucket":
                try:
                    entry["buckets"][float(labels.get("le", ""))] = value
                except ValueError:
                    continue  # malformed le: drop the line, not the hub
            elif part == "sum":
                entry["sum"] += value
            else:
                entry["count"] += value
        return local

    def _merge_histograms(self, builder: SnapshotBuilder,
                          entries: Sequence[tuple[str, "_TargetCache"]],
                          ) -> None:
        """Sum workload histograms (step-duration) across targets into one
        slice-level distribution. Valid because cumulative bucket counts
        with identical bounds add; a target whose bounds differ (older
        schema) poisons only that family, which is skipped with a
        warning — never merged wrong. Targets that missed this refresh
        contribute their cached last state (monotonicity guard — see
        _hist_cache). The cross-target sum below never mutates a cached
        per-target fold (buckets are copied into the accumulator), so
        replaying a fold across refreshes is safe."""
        for target, entry in entries:
            local, = entry.view(("hist_local",), lambda: (
                self._build_hist_local(target, entry.series_dicts),))
            # An answered target replaces its cached contribution (its
            # own counter reset is a legitimate reset downstream); a
            # failed target keeps its previous entry.
            self._hist_cache[target] = local
        acc: dict[tuple, dict] = {}
        mismatched: set[tuple] = set()
        for target in self._targets:
            local = self._hist_cache.get(target)
            if not local:
                continue
            for key, entry in local.items():
                bounds = tuple(sorted(entry["buckets"]))
                merged = acc.get(key)
                if merged is None:
                    acc[key] = {"bounds": bounds,
                                "buckets": dict(entry["buckets"]),
                                "sum": entry["sum"],
                                "count": entry["count"]}
                elif merged["bounds"] != bounds:
                    mismatched.add(key)
                else:
                    for le, count in entry["buckets"].items():
                        merged["buckets"][le] += count
                    merged["sum"] += entry["sum"]
                    merged["count"] += entry["count"]
        for key in sorted(acc, key=repr):
            if key in mismatched:
                log.warning(
                    "hub: histogram %s has different bucket bounds across "
                    "targets (mixed exporter versions?); not merged", key[0])
                continue
            fam, labels = key
            merged = acc[key]
            finite = [b for b in merged["bounds"]
                      if not (b == float("inf"))]
            counts = []
            cumulative = 0.0
            for bound in finite:
                count = merged["buckets"][bound]
                counts.append(max(0, int(count - cumulative)))
                cumulative = count
            total = int(merged["count"]) if merged["count"] else int(
                merged["buckets"].get(float("inf"), cumulative))
            counts.append(max(0, total - int(cumulative)))
            builder.add_histogram(HistogramState(
                HIST_SPECS[fam], tuple(finite), tuple(counts),
                total, merged["sum"], labels))

    # -- loop ----------------------------------------------------------------

    def run_forever(self) -> None:
        # Fixed-cadence like poll.py: sleep the remainder of the interval
        # so a slow refresh doesn't push the next one further out.
        while not self._stop.is_set():
            if self._thread is not threading.current_thread():
                # A supervisor respawn replaced this thread while it
                # was wedged: retire rather than run two
                # refresh loops over one cache/session state.
                log.info("hub refresh thread superseded by respawn; "
                         "retiring")
                return
            if self.heartbeat is not None:
                self.heartbeat()
            started = time.monotonic()
            try:
                self.refresh_once()
            except Exception:  # noqa: BLE001 - the hub must never die
                log.exception("hub refresh failed")
            elapsed = time.monotonic() - started
            self._stop.wait(max(0.1, self._interval - elapsed))

    def start(self) -> None:
        if self.delta is not None:
            self.delta.start_replay()
        self.respawn()

    def thread_alive(self) -> bool:
        """Liveness probe for the supervisor's hub-refresh row
       ."""
        return self._thread is not None and self._thread.is_alive()

    def respawn(self) -> None:
        """(Re)start the refresh thread — the supervisor's crash-only
        restart closure: a wedged previous thread is abandoned (it
        retires at its next stop-check), warm state (caches, sessions,
        baselines) survives on self."""
        self._thread = spawn(self.run_forever, name="hub-refresh")
        self._thread.start()

    def attach_supervisor(self, supervisor) -> None:
        """Wire the process supervisor (hub main): its kts_component_*
        rows + restart storms ride every publish, and the refresh loop
        beats it once per cycle."""
        self._supervisor = supervisor
        self.heartbeat = supervisor.beater("hub-refresh")

    def add_metrics_provider(self, contribute) -> None:
        """Register a ``contribute(builder)`` callable appended to
        every publish — how out-of-hub components (the SO_REUSEPORT
        ingest pool) get their families onto this exposition."""
        self._extra_metrics.append(contribute)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._pool.shutdown()
        if self.delta is not None:
            # Clean shutdown keeps the newest state: a drain-and-
            # restart (pod reschedule) warm-resumes every session, not
            # just those up to the last periodic write.
            self.delta.checkpoint(force=True)


def file_targets_provider(path: str, static: Sequence[str] = ()):
    """Targets provider with Prometheus file_sd semantics: the file is
    re-read on every call (a mounted-ConfigMap edit applies live), one
    target per line, # comments and blanks skipped, appended to the
    static (positional) targets. An unreadable file raises OSError —
    _refresh_targets keeps the previous list for that refresh."""
    def provider() -> list[str]:
        with open(path, encoding="utf-8") as handle:
            lines = [line.strip() for line in handle
                     if line.strip() and not line.strip().startswith("#")]
        return list(static) + lines

    return provider


def parse_dns_endpoint(endpoint: str) -> tuple[str, str]:
    """Syntax-only split of ``host:port`` (brackets around an IPv6 host
    accepted and stripped) — no network, so startup validation is
    instant even when cluster DNS is degraded."""
    host, _, port = endpoint.rpartition(":")
    host = host.strip("[]")
    if not host or not port.isdigit():
        raise ValueError(f"--targets-dns {endpoint!r} must be host:port")
    if "/" in host:
        # A pasted URL ('http://svc:9400', 'svc:9400/metrics') would pass
        # the split above and then fail DNS resolution on every refresh
        # with only log-line evidence; fail at startup like other flag
        # errors instead.
        raise ValueError(
            f"--targets-dns {endpoint!r} must be bare host:port, not a "
            f"URL (scheme is fixed by --targets-dns-scheme, path is "
            f"/metrics)")
    return host, port


def resolve_dns_targets(endpoint: str, scheme: str = "http",
                        path: str = "/metrics") -> list[str]:
    """Resolve ``host:port`` to one target URL per A/AAAA record —
    Kubernetes DNS discovery: a headless Service over the DaemonSet
    returns every pod IP, so the hub follows pod churn with no target
    file to maintain. Sorted for stable series identity."""
    import ipaddress
    import socket

    host, port = parse_dns_endpoint(endpoint)
    addresses = set()
    for info in socket.getaddrinfo(host, int(port), proto=socket.IPPROTO_TCP):
        address = info[4][0]
        if isinstance(ipaddress.ip_address(address),
                      ipaddress.IPv6Address):
            address = f"[{address}]"
        addresses.add(address)
    return [f"{scheme}://{address}:{port}{path}"
            for address in sorted(addresses)]


# -- CLI ---------------------------------------------------------------------


def file_targets_provider(path: str, static: Sequence[str] = ()):
    """Targets provider with Prometheus file_sd semantics: the file is
    re-read on every call (a mounted-ConfigMap edit applies live), one
    target per line, # comments and blanks skipped, appended to the
    static (positional) targets. An unreadable file raises OSError —
    _refresh_targets keeps the previous list for that refresh."""
    def provider() -> list[str]:
        with open(path, encoding="utf-8") as handle:
            lines = [line.strip() for line in handle
                     if line.strip() and not line.strip().startswith("#")]
        return list(static) + lines

    return provider


def parse_dns_endpoint(endpoint: str) -> tuple[str, str]:
    """Syntax-only split of ``host:port`` (brackets around an IPv6 host
    accepted and stripped) — no network, so startup validation is
    instant even when cluster DNS is degraded."""
    host, _, port = endpoint.rpartition(":")
    host = host.strip("[]")
    if not host or not port.isdigit():
        raise ValueError(f"--targets-dns {endpoint!r} must be host:port")
    if "/" in host:
        # A pasted URL ('http://svc:9400', 'svc:9400/metrics') would pass
        # the split above and then fail DNS resolution on every refresh
        # with only log-line evidence; fail at startup like other flag
        # errors instead.
        raise ValueError(
            f"--targets-dns {endpoint!r} must be bare host:port, not a "
            f"URL (scheme is fixed by --targets-dns-scheme, path is "
            f"/metrics)")
    return host, port


def resolve_dns_targets(endpoint: str, scheme: str = "http",
                        path: str = "/metrics") -> list[str]:
    """Resolve ``host:port`` to one target URL per A/AAAA record —
    Kubernetes DNS discovery: a headless Service over the DaemonSet
    returns every pod IP, so the hub follows pod churn with no target
    file to maintain. Sorted for stable series identity."""
    import ipaddress
    import socket

    host, port = parse_dns_endpoint(endpoint)
    addresses = set()
    for info in socket.getaddrinfo(host, int(port), proto=socket.IPPROTO_TCP):
        address = info[4][0]
        if isinstance(ipaddress.ip_address(address),
                      ipaddress.IPv6Address):
            address = f"[{address}]"
        addresses.add(address)
    return [f"{scheme}://{address}:{port}{path}"
            for address in sorted(addresses)]


# -- CLI ---------------------------------------------------------------------


def main(argv: Sequence[str] | None = None) -> int:
    import argparse
    import sys

    from .exposition import MetricsServer, RenderStats

    parser = argparse.ArgumentParser(
        prog="python -m kube_gpu_stats_tpu_torch hub",
        description="aggregate per-node exporters into one slice-level "
                    "/metrics with rollups and straggler detection")
    parser.add_argument("targets", nargs="*",
                        help="per-node exporter /metrics URLs or .prom files")
    parser.add_argument("--targets-file", default="",
                        help="file with one target per line (# comments "
                             "ok); appended to positional targets and "
                             "RE-READ every refresh (file_sd semantics: "
                             "a mounted-ConfigMap edit applies live, no "
                             "pod roll). Unreadable mid-run keeps the "
                             "previous list")
    parser.add_argument("--targets-dns", default="",
                        help="host:port resolved to one target per A/AAAA "
                             "record at every refresh (point it at a "
                             "headless Service over the DaemonSet and the "
                             "hub follows pod churn); scheme http, path "
                             "/metrics (--targets-dns-scheme for https)")
    parser.add_argument("--targets-dns-scheme", choices=("http", "https"),
                        default="http")
    parser.add_argument("--interval", type=float, default=10.0,
                        help="refresh cadence in seconds (default 10)")
    parser.add_argument("--fetch-timeout", type=float, default=5.0)
    parser.add_argument("--expect-workers", type=int, default=0,
                        help="workers the slice should have; exported as "
                             "slice_workers_expected for alerting")
    parser.add_argument("--rollups-only", action="store_true",
                        help="serve only slice_* rollups, not the merged "
                             "per-chip accelerator_* series")
    parser.add_argument("--federate", action="store_true",
                        help="targets are LEAF HUBS, not node exporters: "
                             "re-export their slice_* rollup series "
                             "(disjoint per slice/target label) alongside "
                             "any per-chip series — the root of a "
                             "leaf/root federation tree. Combine with "
                             "leaf hubs running --hub-url pointed here")
    parser.add_argument("--no-delta-ingest", action="store_true",
                        help="disable the push ingest endpoint "
                             "(/ingest/delta): every target is served by "
                             "pull-scrape only")
    parser.add_argument("--push-fence", type=float, default=0.0,
                        help="seconds a delta-push session may be silent "
                             "before the target falls back to pull-scrape "
                             "for the refresh (default 3x --interval)")
    parser.add_argument("--ingest-lanes", type=int, default=0,
                        help="shared-nothing delta-ingest lanes (sources "
                             "hash to a lane; each has its own lock, "
                             "session table and entry slab, so POST "
                             "handler threads stop convoying behind one "
                             "lock at high pusher fan-in). 0 = auto "
                             "(bounded by the core count); 1 restores "
                             "the single-lock behavior")
    parser.add_argument("--ingest-procs", type=int, default=0,
                        help="SO_REUSEPORT acceptor processes on the "
                             "public port. 0 = off (ingest in this "
                             "process). N>0 starts N children that each "
                             "bind the public port with SO_REUSEPORT, so "
                             "the kernel spreads publisher connections "
                             "over them and their socket and HTTP work "
                             "leaves this process's interpreter lock; "
                             "each relays frames to this hub (the one "
                             "owner of the sessions) over unix sockets, "
                             "and proxies scrapes and probes to it. "
                             "Linux/BSD only")
    parser.add_argument("--listen-host", default="0.0.0.0")
    parser.add_argument("--listen-port", type=int, default=DEFAULT_PORT)
    parser.add_argument("--once", action="store_true",
                        help="one refresh, print the merged exposition to "
                             "stdout, exit (rates need two refreshes)")
    parser.add_argument("--tls-cert-file", default="")
    parser.add_argument("--tls-key-file", default="")
    parser.add_argument("--tls-client-ca-file", default="",
                        help="require + verify client certificates (mTLS) "
                             "on the hub's own scrape endpoint")
    parser.add_argument("--auth-username", default="")
    parser.add_argument("--auth-password-sha256", default="")
    parser.add_argument("--target-auth-username", default="",
                        help="basic-auth username sent to every target "
                             "(exporters started with --auth-username)")
    parser.add_argument("--target-auth-password-file", default="",
                        help="file holding the basic-auth password "
                             "(re-read each refresh; rotations apply "
                             "without a restart)")
    parser.add_argument("--target-bearer-token-file", default="",
                        help="file holding a bearer token sent to every "
                             "target (re-read each refresh)")
    parser.add_argument("--target-ca-file", default="",
                        help="CA bundle verifying the targets' TLS certs "
                             "(exporters started with --tls-cert-file "
                             "signed by a private CA)")
    parser.add_argument("--target-insecure-tls", action="store_true",
                        help="skip TLS verification of targets "
                             "(self-signed dev certs; prefer "
                             "--target-ca-file)")
    parser.add_argument("--pushgateway-url", default="",
                        help="push each merged snapshot to a Prometheus "
                             "Pushgateway (slice-level egress for "
                             "unscrapeable clusters); empty disables")
    parser.add_argument("--pushgateway-job", default="kube-tpu-stats-hub",
                        help="Pushgateway job; Pushgateway replaces a "
                             "whole job/instance group per PUT, so give "
                             "EACH hub its own job (e.g. the slice name) "
                             "when several hubs share one gateway, or "
                             "they silently overwrite each other")
    parser.add_argument("--pushgateway-instance", default="",
                        help="Pushgateway grouping-key instance; defaults "
                             "to the job name, NOT the hostname — a hub "
                             "Deployment's pod name changes every restart "
                             "and would strand a stale group per "
                             "reschedule")
    parser.add_argument("--remote-write-url", default="",
                        help="ship each merged snapshot via Prometheus "
                             "remote_write (Mimir/Thanos/GMP receivers); "
                             "empty disables")
    parser.add_argument("--remote-write-job", default="kube-tpu-stats-hub",
                        help="job label stamped on every remote-written "
                             "series; give each hub its own (e.g. the "
                             "slice name) when several hubs share a "
                             "receiver")
    parser.add_argument("--remote-write-instance", default="",
                        help="instance label for remote-written series; "
                             "defaults to the job name, NOT the hostname "
                             "(a Deployment pod name churns identity "
                             "every reschedule)")
    parser.add_argument("--remote-write-interval", type=float, default=15.0)
    parser.add_argument("--remote-write-extra-labels", default="",
                        help="name=value,... stamped on every "
                             "remote-written series (e.g. the slice "
                             "name: 'tpu_slice=v5p-a')")
    parser.add_argument("--remote-write-protocol",
                        choices=("1.0", "2.0"), default="1.0")
    parser.add_argument("--remote-write-bearer-token-file", default="")
    parser.add_argument("--remote-write-wal-dir", default="",
                        help="durable exporter: per-shard "
                             "write-ahead rings under this directory; "
                             "snapshots journal to disk before sending "
                             "and a receiver outage becomes late "
                             "delivery, bounded and accounted. Empty = "
                             "legacy best-effort")
    parser.add_argument("--remote-write-shards", type=int, default=1,
                        help="send shards for the durable exporter "
                             "(series hash by identity; per-shard WAL, "
                             "backoff, parked-poison ring). Needs "
                             "--remote-write-wal-dir when > 1")
    parser.add_argument("--remote-write-wal-max-bytes", type=int,
                        default=64 * 1024 * 1024,
                        help="per-shard WAL byte bound; past it the "
                             "oldest segment is evicted, counted in "
                             "kts_remote_write_dropped_total and "
                             "journaled")
    parser.add_argument("--remote-write-drain-max", type=int, default=64,
                        help="max backlogged requests per shard per "
                             "push cycle while catching up")
    parser.add_argument("--log-level", default="info",
                        choices=("debug", "info", "warning", "error"))
    # Fleet-lens / SLO + delta-push knobs: the SAME flag definitions the
    # daemon parser carries (config.add_fleet_lens_flags /
    # add_delta_push_flags), so spellings, env vars and defaults cannot
    # drift between the two CLIs. On a hub, --hub-url points at the
    # PARENT (root) hub of a federation tree.
    from .config import (add_cardinality_flags, add_delta_push_flags,
                         add_efficiency_flags, add_fleet_lens_flags,
                         add_history_flags, add_native_ingest_flag,
                         add_ingest_guard_flags,
                         validate_cardinality_args,
                         validate_delta_push_args,
                         validate_efficiency_args,
                         validate_fleet_lens_args,
                         validate_history_args,
                         validate_ingest_guard_args)

    add_fleet_lens_flags(parser)
    add_delta_push_flags(parser)
    add_ingest_guard_flags(parser)
    add_cardinality_flags(parser)
    add_history_flags(parser)
    add_efficiency_flags(parser)
    # Hub-side audit key: signs the /debug/efficiency energy/waste
    # attestation — same spelling, env var and caveat as the daemon's
    # /debug/energy key (usually the same secret).
    parser.add_argument("--energy-audit-key",
                        default=os.environ.get("KTS_ENERGY_AUDIT_KEY", ""),
                        help="HMAC-SHA256 key signing the "
                             "/debug/efficiency energy/waste rollup; "
                             "the same key verifies it via `doctor "
                             "--efficiency`. Empty serves it unsigned. "
                             "Prefer the KTS_ENERGY_AUDIT_KEY env var "
                             "(a flag value is visible in `ps`)")
    add_native_ingest_flag(parser)
    args = parser.parse_args(argv)
    fleet_error = validate_fleet_lens_args(args)
    if fleet_error:
        parser.error(fleet_error)
    push_error = validate_delta_push_args(args)
    if push_error:
        parser.error(push_error)
    guard_error = validate_ingest_guard_args(args)
    if guard_error:
        parser.error(guard_error)
    cardinality_error = validate_cardinality_args(args)
    if cardinality_error:
        parser.error(cardinality_error)
    history_error = validate_history_args(args)
    if history_error:
        parser.error(history_error)
    efficiency_error = validate_efficiency_args(args)
    if efficiency_error:
        parser.error(efficiency_error)
    if args.ingest_lanes < 0 or args.ingest_lanes > 256:
        parser.error("--ingest-lanes must be 0 (auto) or 1..256")
    if args.ingest_procs < 0 or args.ingest_procs > 64:
        parser.error("--ingest-procs must be 0 (off) or 1..64")
    if args.ingest_procs > 0:
        import socket as socket_mod

        if not hasattr(socket_mod, "SO_REUSEPORT"):
            parser.error("--ingest-procs needs SO_REUSEPORT "
                         "(Linux/BSD); this platform has no such "
                         "socket option")
        if args.no_delta_ingest:
            parser.error("--ingest-procs without delta ingest makes no "
                         "sense (drop --no-delta-ingest or set "
                         "--ingest-procs 0)")
        if args.tls_cert_file or args.tls_key_file:
            parser.error("--ingest-procs serves plain HTTP acceptors "
                         "and cannot terminate TLS; drop the TLS flags "
                         "or run single-process ingest")
    if not 1 <= args.remote_write_shards <= 64:
        parser.error("--remote-write-shards must be 1..64")
    if args.remote_write_shards > 1 and not args.remote_write_wal_dir:
        parser.error("--remote-write-shards > 1 needs "
                     "--remote-write-wal-dir")

    # A long-running service needs visible logs (refresh failures, dropped
    # duplicates, credential problems); mirrors the daemon's text format.
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    if args.no_native_ingest:
        native_pkg.use_python_paths("--no-native-ingest")
    else:
        # Build (or load) the extension before anything starts: a failed
        # build stops the hub here, with g++'s output.
        try:
            native_pkg.load_ingest()
            native_pkg.load_render()
        except native_pkg.NativeUnavailable as exc:
            print(f"hub: {exc}", file=sys.stderr)
            return 1

    targets = list(args.targets)
    targets_provider = None
    if args.targets_file:
        if args.targets_dns:
            parser.error("--targets-file and --targets-dns are mutually "
                         "exclusive")
        targets_provider = file_targets_provider(args.targets_file,
                                                 args.targets)
        try:
            targets = targets_provider()  # fail fast on an unreadable file
        except OSError as exc:
            print(f"--targets-file: {exc}", file=sys.stderr)
            return 2

    if args.targets_dns:
        if targets:
            parser.error("--targets-dns replaces the target list; combine "
                         "with positional targets/--targets-file is "
                         "ambiguous")
        try:
            # Syntax-only check: no resolution at startup (degraded
            # cluster DNS must not stall the container; the provider
            # resolves — and retries — every refresh).
            parse_dns_endpoint(args.targets_dns)
        except ValueError as exc:
            parser.error(str(exc))

        def targets_provider() -> list[str]:
            return resolve_dns_targets(args.targets_dns,
                                       scheme=args.targets_dns_scheme)
    elif not targets and targets_provider is None and args.no_delta_ingest:
        # A file provider with an empty-for-now file is allowed: the
        # shipped ConfigMap starts with only comments, and the hub must
        # serve (live but NotReady, slice_targets 0) until targets are
        # added, not CrashLoop. With delta ingest on (the default), an
        # empty target list is the PUSH-ONLY mode: workers announce
        # themselves over /ingest/delta and need no target config.
        parser.error("no targets (positional, --targets-file, or "
                     "--targets-dns) and --no-delta-ingest leaves no "
                     "push path either")

    from .validate import fetch_options

    try:
        # One definition of the credential/TLS flag rules (validate.
        # fetch_options), applied to the hub's target_ spellings.
        fetch_options(args, prefix="target_")
    except ValueError as exc:
        parser.error(str(exc))

    headers_provider = None
    if args.target_auth_username or args.target_bearer_token_file:

        def headers_provider() -> dict:
            return fetch_options(args, prefix="target_")["headers"] or {}

    render_stats = RenderStats()
    senders: list = []

    def push_stats() -> dict:
        # Same shape as daemon._push_stats; resolved per refresh so the
        # collector_push_* self metrics ride the hub's own exposition.
        stats = {}
        for mode, sender in senders:
            stats[mode] = {"pushes": sender.pushes_total,
                           "failures": sender.failures_total,
                           "dropped": sender.dropped_total}
            if hasattr(sender, "shed_honored_total"):
                # A leaf hub pushing into a shedding root honors its
                # Retry-After exactly like a daemon does.
                stats[mode]["shed_honored"] = sender.shed_honored_total
            if hasattr(sender, "skew_refused_total"):
                # Root-hub skew refusals this leaf drew:
                # folded into the leaf's own kts_skew_refused_total.
                stats[mode]["skew_refused"] = sender.skew_refused_total
        return stats

    def egress_payload() -> dict:
        # /debug/egress for the hub: same shape as the daemon's (doctor
        # --egress reads both), senders included.
        payload = dict(egress_stats())
        payload["enabled"] = bool(payload)
        payload["senders"] = {
            mode: {
                "pushes_total": sender.pushes_total,
                "failures_total": sender.failures_total,
                "dropped_total": sender.dropped_total,
                "consecutive_failures": sender.consecutive_failures,
            }
            for mode, sender in senders
        }
        return payload

    def skew_payload() -> dict:
        # /debug/skew for the hub: the receiver half (fleet
        # version census + refused peers from the ingest) plus — on a
        # federation leaf — the publisher half against the root, plus
        # any persisted formats quarantined at startup. Same shape
        # doctor --skew reads from daemons, with the hub extras.
        from . import __version__, wal
        from .delta import PROTO_MAX, PROTO_MIN

        payload: dict = {
            "role": "hub",
            "build": __version__,
            "proto_min": PROTO_MIN,
            "proto_max": PROTO_MAX,
            "publisher": None,
            "wal_quarantined": wal.quarantine_counts(),
            "wal_quarantine_events": wal.quarantine_events(),
        }
        if hub.delta is not None:
            payload["ingest"] = hub.delta.skew_status()
        for mode, sender in senders:
            status_fn = getattr(sender, "skew_status", None)
            if mode == "delta" and callable(status_fn):
                payload["publisher"] = status_fn()
        return payload

    def egress_stats() -> dict:
        # Spill-queue + durable remote-write status, same
        # shape as daemon._egress_stats — folded as kts_spill_*/
        # kts_remote_write_* on the hub's own exposition.
        out = {}
        for _mode, sender in senders:
            spill_fn = getattr(sender, "spill_status", None)
            if callable(spill_fn):
                status = spill_fn()
                if status is not None:
                    out["spill"] = status
            egress_fn = getattr(sender, "egress_status", None)
            if callable(egress_fn):
                status = egress_fn()
                if status is not None:
                    out["remote_write"] = status
        return out

    # Built even under --no-history: /query then answers enabled:false
    # rather than 404, and the disabled store holds no ring.
    from .history import HistoryStore

    history_store = HistoryStore(
        enabled=not args.no_history,
        max_series=args.history_series_max,
        query_qps=args.history_query_qps,
        query_burst=args.history_query_burst)

    hub = Hub(targets, interval=args.interval,
              expect_workers=args.expect_workers,
              rollups_only=args.rollups_only,
              fetch_timeout=args.fetch_timeout,
              render_stats=render_stats,
              push_stats=push_stats if (args.pushgateway_url
                                        or args.remote_write_url
                                        or args.hub_url) else None,
              egress_stats=egress_stats if (args.remote_write_wal_dir
                                            or args.hub_spill_dir)
              else None,
              headers_provider=headers_provider,
              target_ca_file=args.target_ca_file,
              target_insecure_tls=args.target_insecure_tls,
              targets_provider=targets_provider,
              delta_ingest=not args.no_delta_ingest,
              push_fence=args.push_fence or None,
              federate=args.federate,
              fleet_lens=not args.no_fleet_lens,
              slo_freshness_target=args.slo_freshness_target,
              slo_straggler_target=args.slo_straggler_target,
              slo_straggler_ratio=args.slo_straggler_ratio,
              ingest_lanes=args.ingest_lanes,
              ingest_delta_rate=args.ingest_delta_rate,
              ingest_max_inflight=args.ingest_max_inflight,
              ingest_max_sessions=args.ingest_max_sessions,
              ingest_quarantine_threshold=args.ingest_quarantine_threshold,
              ingest_quarantine_window=args.ingest_quarantine_window,
              ingest_checkpoint=args.ingest_checkpoint,
              ingest_checkpoint_interval=args.ingest_checkpoint_interval,
              ingest_proto_min=args.ingest_proto_min,
              ingest_proto_max=args.ingest_proto_max,
              native_ingest=not args.no_native_ingest,
              series_budget_per_source=args.series_budget_per_source,
              series_hard_cap=args.series_hard_cap,
              series_high_watermark=args.series_high_watermark,
              series_low_watermark=args.series_low_watermark,
              series_idle_refreshes=args.series_idle_refreshes,
              history=history_store,
              efficiency=not args.no_efficiency,
              waste_warmup_refreshes=args.waste_warmup_refreshes,
              waste_idle_refreshes=args.waste_idle_refreshes,
              waste_idle_duty=args.waste_idle_duty,
              waste_top_k=args.waste_top_k,
              energy_audit_key=args.energy_audit_key)

    # Push senders follow registry publishes, so they ship each merged
    # snapshot unmodified — the hub as a slice-level egress point.
    # Constructed before the --once branch: a cron-run `--once
    # --pushgateway-url ...` must push, not silently succeed at nothing.
    if args.pushgateway_url:
        from .exposition import PushgatewayPusher

        senders.append(("pushgateway", PushgatewayPusher(
            hub.registry, args.pushgateway_url, job=args.pushgateway_job,
            instance=args.pushgateway_instance or args.pushgateway_job,
            render_stats=render_stats)))
    if args.remote_write_url:
        from .config import parse_extra_labels
        from .remote_write import RemoteWriter

        try:
            extra_labels = parse_extra_labels(args.remote_write_extra_labels)
        except ValueError as exc:
            parser.error(f"--remote-write-extra-labels: {exc}")
        senders.append(("remote_write", RemoteWriter(
            hub.registry, args.remote_write_url,
            job=args.remote_write_job,
            instance=args.remote_write_instance or args.remote_write_job,
            min_interval=args.remote_write_interval,
            protocol=args.remote_write_protocol,
            bearer_token_file=args.remote_write_bearer_token_file,
            extra_labels=extra_labels,
            render_stats=render_stats,
            shards=args.remote_write_shards,
            wal_dir=args.remote_write_wal_dir,
            wal_max_bytes=args.remote_write_wal_max_bytes,
            drain_max_per_push=args.remote_write_drain_max,
            tracer=hub.tracer)))
    if args.hub_url:
        # Federation leaf: push this hub's merged rollup exposition to
        # the parent (root) hub over the same delta protocol the
        # daemons use against us. Source defaults to this hub's own
        # scrape URL so the root's pull fallback lands here.
        import socket as socket_mod

        from .delta import DeltaPublisher, push_headers_provider

        # Partition survival: a leaf hub spools its rollup
        # snapshots while the root is unreachable exactly like a daemon
        # spools for its leaf — the same flags, the same drain contract.
        spill = None
        if args.hub_spill_dir:
            from .spillq import SpillQueue

            spill = SpillQueue(args.hub_spill_dir,
                               max_bytes=args.hub_spill_max_bytes,
                               tracer=hub.tracer)
        senders.append(("delta", DeltaPublisher(
            hub.registry, args.hub_url,
            source=args.hub_push_source or (
                f"http://{socket_mod.gethostname()}:"
                f"{args.listen_port}/metrics"),
            min_interval=args.hub_push_interval,
            render_stats=render_stats,
            headers_provider=push_headers_provider(
                args.hub_auth_username, args.hub_auth_password_file),
            ca_file=args.hub_ca_file,
            insecure_tls=args.hub_insecure_tls,
            tracer=hub.tracer,
            spill=spill,
            drain_rate=args.hub_drain_rate,
            proto_max=args.hub_proto_max)))

    if args.once:
        frame = hub.refresh_once()
        for mode, sender in senders:
            sender.push_once()
            if sender.failures_total or sender.dropped_total:
                print(f"! {mode} push failed", file=sys.stderr)
        sys.stdout.write(hub.registry.snapshot().render())
        if any(s.failures_total or s.dropped_total for _, s in senders):
            return 1
        # All targets down = nothing aggregated: signal it like top --once.
        return 2 if not frame.rows and frame.errors else 0

    # Thread supervisor: the hub's refresh
    # loop, push senders and render pre-warmer get the same liveness/
    # hang/restart-storm coverage the daemon's workers have had since
    # — a silently dead refresh thread used to mean a frozen
    # rollup until the liveness probe killed the pod.
    from .supervisor import Supervisor

    supervisor = Supervisor(check_interval=1.0, tracer=hub.tracer)
    hub.attach_supervisor(supervisor)

    def stores_payload() -> dict:
        # /debug/stores: per-store durability states +
        # restarted/storm-latched threads — what doctor --stores reads.
        from . import wal

        return {
            "enabled": True,
            "role": "hub",
            "stores": wal.store_report(),
            "accept_fence": server.accept_fence_status(),
            "threads": supervisor.restart_report(),
        }

    def cardinality_payload() -> dict:
        # /debug/cardinality: the admission ledger — totals
        # vs limits, top offenders by series and by shed — what doctor
        # --cardinality reads to name a label bomb's source.
        payload = hub.cardinality.debug_payload()
        payload["enabled"] = hub.cardinality.enabled
        return payload

    # With --ingest-procs the acceptor children hold the public port and
    # this process's server moves to an ephemeral loopback port, which
    # the children proxy every non-ingest request to.
    ingest_procs = max(0, args.ingest_procs)
    serve_host = "127.0.0.1" if ingest_procs else args.listen_host
    serve_port = 0 if ingest_procs else args.listen_port
    server = MetricsServer(
        hub.registry, host=serve_host, port=serve_port,
        healthz_max_age=max(3 * args.interval, 30.0),
        tls_cert_file=args.tls_cert_file, tls_key_file=args.tls_key_file,
        tls_client_ca_file=args.tls_client_ca_file,
        auth_username=args.auth_username,
        auth_password_sha256=args.auth_password_sha256,
        render_stats=render_stats,
        ready_check=hub.ready,
        health_provider=supervisor.health_report,
        trace_provider=hub.tracer,
        fleet_provider=hub.fleet,
        ingest_provider=hub.delta.handle if hub.delta is not None else None,
        egress_provider=egress_payload,
        skew_provider=skew_payload,
        stores_provider=stores_payload,
        cardinality_provider=cardinality_payload,
        history_provider=history_store,
        # Wired even under --no-efficiency: the provider then answers
        # enabled:false (config diagnosis), while a hub with the lens
        # off 404s — the established debug-endpoint contract.
        efficiency_provider=hub.efficiency_payload
        if hub.fleet is not None else None)
    # SIGTERM/SIGINT stop cleanly like the daemon (daemon.run): the push
    # senders flush the final snapshot on stop, so a pod reschedule is
    # not a data gap upstream.
    import signal

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    pool = None
    try:
        server.start()
        if ingest_procs and hub.delta is not None:
            from .ingestproc import IngestProcPool

            pool = IngestProcPool(
                hub.delta.handle, host=args.listen_host,
                port=args.listen_port, procs=ingest_procs,
                parent_port=server.port,
                auth=((args.auth_username, args.auth_password_sha256)
                      if args.auth_username else None))
            # Raises when a child does not come up: the hub exits
            # non-zero rather than fall back to ingest in-process.
            pool.start()
            hub.add_metrics_provider(pool.contribute)
            log.info("ingest sharded over %d SO_REUSEPORT acceptor "
                     "process(es) on %s:%d (exposition proxied to "
                     "127.0.0.1:%d)", ingest_procs, args.listen_host,
                     pool.port, server.port)
        for _, sender in senders:
            sender.start()
        hub.start()
        # Registered started-components-only, supervisor last (the
        # daemon.start discipline: no watchdog pass may see a component
        # before its thread exists).
        supervisor.register(
            "hub-refresh", is_alive=hub.thread_alive,
            restart=hub.respawn,
            heartbeat_timeout=max(30.0, 5 * args.interval))
        for mode, sender in senders:
            has_heartbeat = hasattr(sender, "heartbeat")
            if has_heartbeat:
                sender.heartbeat = supervisor.beater(mode)
            supervisor.register(
                mode, is_alive=sender.thread_alive,
                # respawn (not start) for heartbeat-supervised senders:
                # a hang restart must abandon the wedged thread, and
                # start() no-ops on a live one (daemon.start contract).
                restart=getattr(sender, "respawn", sender.start)
                if has_heartbeat else sender.start,
                heartbeat_timeout=60.0 if has_heartbeat else 0.0)
        supervisor.register(
            "render-warmer", is_alive=server.warm_thread_alive,
            restart=server.respawn_warm)
        supervisor.start()
        public_port = pool.port if pool is not None else server.port
        if args.targets_dns:
            log.info("hub serving DNS-discovered targets (%s) on %s:%d",
                     args.targets_dns, args.listen_host, public_port)
        else:
            log.info("hub serving %d target(s)%s on %s:%d",
                     len(targets),
                     " (targets file re-read per refresh)"
                     if args.targets_file else "",
                     args.listen_host, public_port)
        stop.wait()
        return 0
    finally:
        # Supervisor first: a watchdog pass mid-teardown would respawn
        # the very threads being joined (the daemon.stop discipline).
        supervisor.stop()
        if pool is not None:
            pool.stop()
        hub.stop()
        for _, sender in senders:
            sender.stop()
        server.stop()


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
