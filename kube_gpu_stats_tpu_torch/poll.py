"""Device-poll loop — the latency-critical hot loop.

Design rules, the reference's:

- per-device sampling fans out in parallel with a hard per-tick deadline —
  never serialized across devices;
- attribution is a cached in-memory join (refreshed on its own cadence) —
  no RPC on this path;
- publishing is one snapshot swap — scrape traffic can't block a tick;
- any per-device failure marks that device stale (accelerator_up 0) and the
  loop keeps running.

Tick plans: per-device *series plans* — label tuples pre-joined, series
prefixes pre-rendered into the render cache, per-slot Series objects
reused while their value is unchanged — are compiled once per device and
invalidated only on device churn (rediscover) or an attribution change for
that device. The snapshot build then writes values into plan slots
instead of rebuilding every label list per tick.

Pipelined sampling (default on): for split backends (the NVML one) a
tick dispatches the next round of per-device reads and assembles from
the last COMPLETED round, so a read that stalls runs on during the
inter-tick idle instead of inside the tick's deadline. Freshness fence:
completed state older than 2x the interval re-engages the blocking
fan-out (and every deadline/staleness mechanism with it), so values lag
the tick by at most two intervals and a wedged backend degrades exactly
as in blocking mode, within two ticks of when blocking mode would have
flagged it. ``pipeline_fetch=False`` restores the
join-this-tick's-reads contract (the doctor uses it for honest timing).

The port's copy of the reference's ``PollLoop`` on its tick-plan path,
its generic sampling path (one ``Collector.sample`` per device on the
pool) and its split/pipelined path, with what the daemon wires: pod
attribution behind the label fence, process holders, the supervisor's
health self-metrics and heartbeat, label dropping, backend replacement
between ticks, crash-only respawn, the sub-tick power burst sampler's
per-tick fold (``burstsampler.py``), the per-pod energy accountant
(``energy.py``: each device-tick integrated and attributed, its
checkpoint written on the pool), host signals read on the pool
(``hoststats.py``) and the push senders' shipping health and egress
durability (``collector_push_*``, ``kts_spill_*``, ``kts_remote_write_*``).
Not ported: ``reconfigure``. The reference's pre-plan emit path is not copied
either: the reference itself is this loop's oracle
(``tests/test_torch_poll.py``, ``tests/test_torch_pipeline.py``,
``tests/test_torch_daemon.py``).
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Callable, Mapping, NamedTuple, Protocol, Sequence

from . import procstats, schema, wal
from .cardinality import LabelFence
from .collectors import Collector, CollectorError, Device, Sample
from .delta import PROTO_MAX, PROTO_MIN
from .fleetlens import contribute_trace_digest
from .ici import RateTracker
from .registry import (FilteredSnapshotBuilder, HistogramState, Registry,
                       Series, SnapshotBuilder, _series_prefix,
                       contribute_egress_stats, contribute_push_stats,
                       contribute_store_metrics)
from .resilience import DeadlineBudget
from .supervisor import spawn
from .tracing import Tracer, log_every
from .workers import DaemonSamplerPool

log = logging.getLogger(__name__)


class AttributionProvider(Protocol):
    """Cached device→pod mapping. ``lookup`` must be RPC-free."""

    def lookup(self, device: Device) -> Mapping[str, str]:
        """Return {"pod": ..., "namespace": ..., "container": ...} or {}."""
        ...


class NullAttribution:
    def lookup(self, device: Device) -> Mapping[str, str]:
        return {}


class _SeriesSlot:
    """One compiled emit slot: the label tuples for a (device, family)
    pair in both healthy and stale shapes, plus the last Series emitted
    per shape. While the value is unchanged tick over tick the cached
    (immutable) Series object is re-emitted — zero allocation; on change
    one Series is built and the shared alloc cell counts it."""

    __slots__ = ("spec", "labels", "labels_stale", "_last", "_last_stale",
                 "_cell")

    def __init__(self, spec: schema.MetricSpec,
                 labels: tuple[tuple[str, str], ...],
                 labels_stale: tuple[tuple[str, str], ...],
                 cell: list[int]) -> None:
        self.spec = spec
        self.labels = labels
        self.labels_stale = labels_stale
        self._last: Series | None = None
        self._last_stale: Series | None = None
        self._cell = cell
        # Pre-render the series prefixes now (compile time, off the tick
        # path) so the first scrape of a fresh plan is a render-cache
        # hit, not a label-escaping pass.
        _series_prefix(spec.name, labels)
        if labels_stale is not labels:
            _series_prefix(spec.name, labels_stale)

    def emit(self, value: float, stale: bool) -> Series:
        value = float(value)
        if stale:
            s = self._last_stale
            if s is None or s.value != value:
                s = Series(self.spec, self.labels_stale, value)
                self._last_stale = s
                self._cell[0] += 1
            return s
        s = self._last
        if s is None or s.value != value:
            s = Series(self.spec, self.labels, value)
            self._last = s
            self._cell[0] += 1
        return s


class _DevicePlan:
    """Compiled per-device tick plan: the base/stale label tuples, one
    slot per known metric family (including percentile expansions), and
    lazily-grown slot maps for the per-link / passthrough / process-
    holder families whose label dimensions are only known at runtime.
    Valid for exactly one attribution key; the loop recompiles on any
    change (device churn, attribution)."""

    # Lazy slot maps are bounded: link/raw dimensions are already capped
    # upstream (_MAX_ICI_LINKS / _MAX_RAW_FAMILIES), process holders by
    # procopen's per-device cap — this is a second fence so a churning
    # dimension can never grow a plan without bound (overflow emits
    # uncached, still correct).
    _MAX_LAZY_SLOTS = 512

    __slots__ = ("key", "base", "gbase", "emit", "up", "restarts", "energy",
                 "collectives", "memory_total", "_ici", "_raw", "_holders",
                 "_cell", "ici_traffic_on", "ici_bw_on", "raw_on",
                 "holders_on")

    def __init__(self, dev: Device, key: tuple,
                 attribution: Mapping[str, str],
                 topology: Mapping[str, str],
                 drop_labels: frozenset[str],
                 disabled: frozenset[str],
                 cell: list[int]) -> None:
        labels = [
            ("accel_type", dev.accel_type),
            ("chip", str(dev.index)),
            ("device_path", dev.device_path),
            ("uuid", dev.uuid),
        ]
        for k in schema.ATTRIBUTION_LABELS:
            labels.append((k, attribution.get(k, "")))
        for k in schema.TOPOLOGY_LABELS:
            labels.append((k, topology.get(k, "")))
        if drop_labels:
            labels = [
                (k, "" if k in drop_labels else v) for k, v in labels
            ]
        self.key = key
        self.base = tuple(labels)
        self.gbase = self.base + (("stale", "true"),)
        self._cell = cell
        gauge = schema.MetricType.GAUGE
        # Operator-disabled families are omitted at COMPILE time, not
        # just dropped by the filtered builder at add time: a slot that
        # exists would still construct a Series per changing value per
        # tick only to have it discarded, which both wastes the work the
        # plan path exists to avoid and corrupts the series_built/
        # series_reused accounting (built > emitted).
        emit: dict[str, _SeriesSlot] = {}
        for spec in schema.PER_DEVICE_METRICS:
            if spec.type is schema.MetricType.HISTOGRAM:
                continue
            if spec.name in disabled:
                continue
            stale_labels = self.gbase if spec.type is gauge else self.base
            emit[spec.name] = _SeriesSlot(spec, self.base, stale_labels, cell)
        for value_key, (pct_spec, pct) in schema.PERCENTILE_VALUE_KEYS.items():
            if pct_spec.name in disabled:
                continue
            pair = (("percentile", pct),)
            emit[value_key] = _SeriesSlot(
                pct_spec, self.base + pair, self.gbase + pair, cell)
        self.emit = emit
        self.up = emit[schema.DEVICE_UP.name]  # never filterable
        self.restarts = emit.get(schema.RUNTIME_RESTARTS.name)
        self.energy = emit.get(schema.ENERGY.name)
        self.collectives = emit.get(schema.COLLECTIVE_OPS.name)
        self.memory_total = emit.get(schema.MEMORY_TOTAL.name)
        self.ici_traffic_on = schema.ICI_TRAFFIC_TOTAL.name not in disabled
        self.ici_bw_on = schema.ICI_BANDWIDTH.name not in disabled
        self.raw_on = schema.PASSTHROUGH.name not in disabled
        self.holders_on = schema.PROCESS_OPEN.name not in disabled
        self._ici: dict[str, tuple[_SeriesSlot, _SeriesSlot]] = {}
        self._raw: dict[tuple[str, str], _SeriesSlot] = {}
        self._holders: dict[tuple[str, str, str], _SeriesSlot] = {}

    def ici_slots(self, link: str) -> tuple[_SeriesSlot, _SeriesSlot]:
        slots = self._ici.get(link)
        if slots is None:
            pair = (("link", link),)
            slots = (
                _SeriesSlot(schema.ICI_TRAFFIC_TOTAL, self.base + pair,
                            self.base + pair, self._cell),
                _SeriesSlot(schema.ICI_BANDWIDTH, self.base + pair,
                            self.gbase + pair, self._cell),
            )
            if len(self._ici) < self._MAX_LAZY_SLOTS:
                self._ici[link] = slots
        return slots

    def raw_slot(self, family: str, link: str) -> _SeriesSlot:
        slot = self._raw.get((family, link))
        if slot is None:
            pair = (("family", family), ("link", link))
            slot = _SeriesSlot(schema.PASSTHROUGH, self.base + pair,
                               self.gbase + pair, self._cell)
            if len(self._raw) < self._MAX_LAZY_SLOTS:
                self._raw[(family, link)] = slot
        return slot

    def holder_slot(self, pid: str, comm: str, pod_uid: str) -> _SeriesSlot:
        key = (pid, comm, pod_uid)
        slot = self._holders.get(key)
        if slot is None:
            labels = self.base + (("pid", pid), ("comm", comm),
                                  ("pod_uid", pod_uid))
            slot = _SeriesSlot(schema.PROCESS_OPEN, labels, labels,
                               self._cell)
            if len(self._holders) >= self._MAX_LAZY_SLOTS:
                # Holder keys churn (pids of dead processes linger for
                # the plan's life). At saturation, dump the map and let
                # the live holders re-cache over the next ticks.
                self._holders.clear()
            self._holders[key] = slot
        return slot


class _TickDevice(NamedTuple):
    """One device's derived per-tick data: everything the emitter needs,
    computed (with all state mutation) once in _update_tick_state so the
    emitter is a pure function of it."""

    dev: Device
    sample: Sample | None
    plan: _DevicePlan
    stale: bool
    retained_total: float | None  # emit MEMORY_TOTAL from retained state
    restarts: float
    energy: float | None          # None = never observed power: no series
    ici: tuple[tuple[str, int, float | None], ...]  # (link, counter, rate)
    raw: tuple[tuple[str, str, float], ...]  # admitted (family, link, value)
    holders: Sequence[tuple[str, str, str, float]] | None


class PollLoop:
    def __init__(
        self,
        collector: Collector,
        registry: Registry,
        *,
        interval: float = 1.0,
        deadline: float = 0.050,
        attribution: AttributionProvider | None = None,
        topology_labels: Mapping[str, str] | None = None,
        version: str = "dev",
        rediscovery_interval: float = 60.0,
        drop_labels: Sequence[str] = (),
        disabled_metrics: frozenset[str] = frozenset(),
        process_openers: Callable[[str], Sequence[tuple[str, str, str, float]]] | None = None,
        push_stats: Callable[[], Mapping[str, Mapping[str, int]]] | None = None,
        egress_stats: Callable[[], Mapping] | None = None,
        render_stats: Callable[[SnapshotBuilder], None] | None = None,
        health_stats: Callable[[SnapshotBuilder], None] | None = None,
        heartbeat: Callable[[], None] | None = None,
        pipeline_fetch: bool = True,
        tracer: Tracer | None = None,
        burst_sampler=None,
        energy=None,
        host_stats=None,
        label_value_cap: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._collector = collector
        self._registry = registry
        self._interval = interval
        self._deadline = deadline
        self._attribution = attribution or NullAttribution()
        self._topology = dict(topology_labels or {})
        self._version = version
        # Seconds between re-enumerations of the devices (off the tick
        # path); 0 disables.
        self._rediscovery_interval = rediscovery_interval
        # Cardinality control: listed keys are emitted as "" rather than
        # removed — the label SET stays constant so series identity is
        # stable regardless of operator config.
        self._drop_labels = frozenset(drop_labels)
        # Family selection (--metrics-include/--metrics-exclude): names
        # the builder silently drops. Resolved + validated by
        # schema.resolve_metric_filter at config time.
        self._disabled_metrics = frozenset(disabled_metrics)
        # Cached device→holding-process map (procopen.py); a dict read,
        # same off-hot-path contract as attribution. None = disabled.
        self._process_openers = process_openers
        # Shipping-health counters from the push senders (daemon-wired
        # callable; reads plain ints, safe from this thread).
        self._push_stats = push_stats
        # Egress-durability status from the spill queue / durable
        # remote-write exporter (daemon-wired callable returning
        # {"spill": ..., "remote_write": ...} status dicts).
        self._egress_stats = egress_stats
        # Scrape/render self-observability contributor (RenderStats.
        # contribute): folds scrape-duration histograms and rendered-bytes
        # counters into each snapshot.
        self._render_stats = render_stats
        # Resilience self-observability contributor (the daemon wires
        # Supervisor.contribute): kts_breaker_state / kts_component_*
        # families ride every snapshot.
        self._health_stats = health_stats
        # Supervisor heartbeat: called once per run_forever iteration so
        # a tick wedged inside a blocking call no timeout covers is
        # detected (and the loop respawned) by the watchdog.
        self._heartbeat = heartbeat
        # Pipelined reads (split backends advertising pipelined_wait): a
        # tick serves the last COMPLETED read round while this tick's
        # round lands during the inter-tick idle, so a stalled read stops
        # living inside the tick budget. The freshness fence: completed
        # state older than 2 intervals re-engages the blocking join (and
        # with it the deadline/staleness machinery), so a wedged backend
        # degrades exactly as in blocking mode, within two ticks of when
        # blocking mode would have flagged it (2x, not 1x, so jitter in
        # read completion does not flap the fast path off). False
        # restores join-this-tick's-reads.
        self._fetch_max_age = 2.0 * interval if pipeline_fetch else None
        self._clock = clock
        # Flight recorder: every tick records phase spans (fetch_wait,
        # env_round, fold, plan_write, publish) plus the per-device reads
        # from the pool as aux spans, and state transitions (plan
        # compiles, pipeline fence expiries/demotions) into the event
        # journal. A disabled recorder (--no-trace) makes every call a
        # cheap no-op.
        self.tracer = tracer if tracer is not None else Tracer()
        # Label-churn fence: caps distinct values per attribution label
        # key at the plan compiler, so a kubelet join minting a fresh pod
        # per tick degrades to pod="overflow" aggregation instead of a
        # per-tick series (and plan) explosion. 0 = unfenced.
        self._label_fence = LabelFence(label_value_cap, tracer=self.tracer)
        # Burst sampler: the tick drains each device's sub-tick power ring
        # and folds it into the kts_power_burst_* stats in the snapshot
        # tail. None = the families stay absent (burst mode off / bare
        # test loops).
        self._burst = burst_sampler
        # Energy accountant (energy.py): the tick integrates each
        # device's power (trapezoid over the drained burst samples when
        # armed, the tick rectangle otherwise) into per-pod joules and
        # folds kts_energy_* into the snapshot tail; its checkpoint runs
        # on the pool, at most one in flight. None = the families stay
        # absent (bare test loops).
        self._energy_acct = energy
        self._ckpt_future: concurrent.futures.Future | None = None
        # Host-signals collector: read once per tick on the pool, so
        # PSI/IRQ/NIC/cgroup file IO never lives inside the tick budget.
        # The snapshot tail folds the last COMPLETED read; its per-read
        # parse errors count under collector_poll_errors_total. None (or
        # a disabled instance) keeps the kts_host_* families absent.
        self._host = (host_stats if host_stats is not None
                      and getattr(host_stats, "enabled", True) else None)
        self._host_future: concurrent.futures.Future | None = None
        self._host_snap = None
        self._tick_seq = 0
        # Pipeline-fence edge detection: the journal records the fence
        # EXPIRING and the fast path re-arming, not one event per tick of
        # a long outage (the journal is a ring; a per-tick repeat would
        # evict the rare events a post-mortem wants).
        self._fence_expired = False

        self._devices: list[Device] = list(collector.discover())
        workers = max(4, len(self._devices))
        # Daemon-thread pool, NOT ThreadPoolExecutor: its non-daemon workers
        # are joined by an interpreter-exit hook, so one sample wedged in a
        # sick backend would make the process unkillable (workers.py).
        self._pool = DaemonSamplerPool(workers, thread_name_prefix="sampler")
        self._rates = RateTracker()
        # Per-device (read generation, ((link, counter, rate), ...)) from
        # the last tick that fed this device's counters: a pipelined tick
        # re-serving the same read round replays the tuple instead of
        # feeding the rate tracker a duplicate observation (which would
        # emit a bogus zero rate and reset the baseline under the
        # genuinely-new counters that follow). Generation-stamped so a
        # device that missed a generation's first fold (stuck) is fed,
        # not replayed from an older generation. This tick's captured
        # generation lives on _tls (set at each sampling path's
        # wait_ready join, consumed by _update_tick_state): per-thread,
        # so a superseded loop thread unwedging mid-tick cannot overwrite
        # the fresh thread's capture.
        self._ici_memo: dict[str, tuple] = {}
        self._runtime_seq_seen: int | None = None
        # The backend's library session (``NvmlCollector.session``): a
        # fresh session after a driver reload or a GPU reset restarts the
        # cards' counters, so no rate may span it.
        self._session_seen: int | None = None
        # Futures for samples that missed their deadline but are still
        # running: future.cancel() cannot stop a running call, so until it
        # finishes we must not submit another sample for that device or a
        # wedged backend would leak one pool worker per tick.
        self._outstanding: dict[str, concurrent.futures.Future] = {}
        self._hist = HistogramState.empty(
            schema.SELF_POLL_DURATION, schema.POLL_DURATION_BUCKETS
        )
        self._errors: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Backend swap requested by replace_collector; applied between
        # ticks on whichever thread runs tick().
        self._pending_collector: Collector | None = None
        # Retained last-known MEMORY_TOTAL per device so a stale tick keeps
        # capacity gauges stable instead of dropping series.
        self._last_totals: dict[str, float] = {}
        # Runtime-restart detection: uptime going backwards between
        # ticks means the runtime reinitialized the device. The derived
        # counter makes it alertable with increase().
        self._last_uptime: dict[str, float] = {}
        self._restarts: dict[str, int] = {}
        # Energy integration: joules += watts * tick-gap, rectangle rule
        # at the poll cadence. Per-device last-seen timestamp, not the
        # loop interval: a stale tick must not integrate power it didn't
        # observe.
        self._energy: dict[str, float] = {}
        self._last_power_at: dict[str, float] = {}
        # Compiled tick plans, one per device, keyed by device_id; the
        # stored attribution key detects a changed join for the SAME
        # device.
        self._plans: dict[str, _DevicePlan] = {}
        self._plan_compiles: dict[str, int] = {}
        self._plan_cache_hits = 0
        # Shared allocation cell: slots bump [0] when they CONSTRUCT a
        # Series (a changed value); unchanged values re-emit the cached
        # object. Reset per tick; last_tick_stats reports it.
        self._built_cell: list[int] = [0]
        # Process self-metrics, pipelined: a pool task reads /proc while
        # the device fan-out is in flight and the snapshot folds the last
        # COMPLETED reading. First tick reads inline so the families exist
        # from the first snapshot.
        self._procstats: Mapping[str, float] | None = None
        self._proc_future: concurrent.futures.Future | None = None
        # Pipelined read rounds (split backends, pipeline_fetch): the
        # per-device reads of round N run on the pool while tick N
        # assembles from round N-1's completed results, behind the age
        # fence above. device_id -> (env, error); at == 0 means never
        # completed.
        self._env_round: dict[str, concurrent.futures.Future] | None = None
        self._env_results: dict[str, tuple[dict, Exception | None]] = {}
        self._env_results_at = 0.0
        self.last_tick_stats: dict[str, float] = {}
        # Per-thread snapshot builder, reset per tick: a superseded loop
        # thread can wedge inside the build and resume after the
        # watchdog's replacement has started its own build, and a shared
        # builder would interleave two ticks' series.
        self._tls = threading.local()
        # Emit order: results are assembled by slot (rank of the
        # device's index) instead of sorted per tick.
        self._slot_of: dict[str, int] = {}
        self._rebuild_slots()
        # Passthrough families (Sample.raw_values) admitted so far, capped
        # so a buggy backend can't mint unbounded series or grow this set
        # unboundedly via unique-name churn (over-cap names are dropped,
        # counted, and never stored).
        self._raw_families: set[str] = set()
        self._raw_cap_warned = False

    # -- public --------------------------------------------------------------

    @property
    def devices(self) -> list[Device]:
        return self._devices

    @property
    def poll_histogram(self) -> HistogramState:
        return self._hist

    def replace_collector(self, collector: Collector) -> None:
        """Hand the loop a new backend; applied at the top of the next
        tick, never mid-tick (the auto-mode backend upgrade: the daemon's
        re-probe watcher swaps the null backend for NVML when the driver
        appears after startup). Intended for upgrading FROM the null
        backend, which never has samples outstanding; the old collector
        is closed on the loop thread."""
        self._pending_collector = collector

    def _apply_pending_collector(self) -> None:
        pending = self._pending_collector
        if pending is None:
            return
        self._pending_collector = None
        old = self._collector
        self._collector = pending
        # The new backend's read generations are unrelated to the old
        # one's (a coinciding value must not replay the old collector's
        # memoized interconnect tuples as this backend's rates).
        self._ici_memo.clear()
        self._runtime_seq_seen = None
        self._tls.tick_runtime_seq = None
        try:
            old.close()
        except Exception:  # noqa: BLE001 - old backend teardown is best-effort
            log.warning("old backend close failed during upgrade", exc_info=True)
        log.info("backend upgraded: %s -> %s", old.name, pending.name)
        self.rediscover()

    def _rebuild_slots(self) -> None:
        """Map device_id -> emit slot (rank by device index, ties keeping
        discovery order): _sample_all assembles results straight into
        their slots."""
        order = sorted(range(len(self._devices)),
                       key=lambda i: self._devices[i].index)
        self._slot_of = {
            self._devices[i].device_id: slot
            for slot, i in enumerate(order)
        }

    def rediscover(self) -> None:
        """Re-enumerate devices (periodic, never on the tick hot path).
        Purges per-device rate/capacity state for devices that disappeared
        so a renumbered device never inherits another device's counter
        baseline. A failing discover keeps the old device list."""
        try:
            self._devices = list(self._collector.discover())
        except Exception as exc:
            self._count_error("rediscover")
            log.warning("rediscovery failed, keeping %d known devices: %s",
                        len(self._devices), exc)
            return
        # Device identity (path, uuid, index) may have changed for a
        # surviving device_id; recompile all tick plans rather than
        # reason about which survived (off hot path).
        self._plans.clear()
        self._rebuild_slots()
        # Pipelined state is per-device-identity too: drop completed
        # results wholesale (a renumbered card must not serve another
        # card's readings) and demote the in-flight round's unfinished
        # reads to the outstanding guard so a wedged backend can't be
        # handed a second worker by the next blocking fan-out.
        self._env_results.clear()
        self._env_results_at = 0.0
        if self._env_round is not None:
            for device_id, future in self._env_round.items():
                if not future.done():
                    self._outstanding.setdefault(device_id, future)
            self._env_round = None
        alive = {dev.device_id for dev in self._devices}
        # Purge over the UNION of per-device state: a device may exist in
        # one dict and not another, and a renumbered card must never
        # inherit another card's counter baseline.
        state_dicts = (self._last_totals, self._last_uptime,
                       self._restarts, self._energy, self._last_power_at,
                       self._ici_memo)
        known = set().union(*(d.keys() for d in state_dicts))
        for device_id in known - alive:
            self._rates.forget_device(device_id)
            for state in state_dicts:
                state.pop(device_id, None)
            # The burst ring and histogram and the energy anchor go with
            # the device: a renumbered card must not inherit another
            # card's sub-tick distribution or integrate against its last
            # reading.
            if self._burst is not None:
                self._burst.forget_device(device_id)
            if self._energy_acct is not None:
                self._energy_acct.forget_device(device_id)
        for device_id in [d for d in self._outstanding if d not in alive]:
            self._outstanding.pop(device_id).cancel()

    def tick(self) -> float:
        """Run one poll over all devices; publish a snapshot; return tick
        duration in seconds."""
        return self._tick_as(None)

    def settle(self, timeout: float) -> bool:
        """Wait up to ``timeout`` seconds for the reads still running past
        an earlier tick's deadline; True when none is left. The loop's
        own interval gives such a read that time before the next tick; a
        caller that ticks back to back gives it here, or every later
        tick finds the read stuck and serves its card down."""
        pending = [f for f in list(self._outstanding.values())
                   if not f.done()]
        if not pending:
            return True
        _, not_done = concurrent.futures.wait(pending, timeout=timeout)
        return not not_done

    def _tick_as(self, owner: threading.Thread | None) -> float:
        """One tick on behalf of ``owner`` (the loop thread, or None for
        direct callers). A thread superseded by a respawn mid-tick — it
        was wedged inside sampling when the watchdog gave up on it —
        must not touch shared per-device state or publish a stale
        snapshot over the fresh thread's: it discards its results at the
        first post-sample check and retires."""
        if owner is not None and self._thread is not owner:
            return 0.0  # superseded before starting: don't sample at all
        self._apply_pending_collector()
        tracer = self.tracer
        self._tick_seq += 1
        tracer.begin("tick", self._tick_seq)
        start = self._clock()
        results = self._sample_all()
        duration = self._clock() - start
        if owner is not None and self._thread is not owner:
            return duration  # superseded while sampling: discard
        self._hist = self._hist.observe(duration)
        snapshot = self._build_snapshot(results, now=start + duration)
        if owner is not None and self._thread is not owner:
            return duration  # superseded during the build: don't publish
        mark = tracer.mark()
        self._registry.publish(snapshot)
        tracer.add_span("publish", mark)
        meta = {"devices": len(results),
                "duration_ms": round(duration * 1000.0, 3),
                "series": self.last_tick_stats.get("series", 0)}
        if self._host is not None and self._host_snap is not None:
            # Time-align the tick with the host's state: the trace ring
            # carries the strongest host signals, so a /debug/ticks
            # post-mortem of a slow tick shows the PSI/NIC/throttle
            # picture it co-occurred with.
            note = self._host.trace_note(self._host_snap)
            if note:
                meta["host"] = note
        tracer.end(**meta)
        return duration

    def run_forever(self) -> None:
        """Drift-free fixed-rate loop until stop(); re-enumerates devices on
        its own (slower) cadence so hotplug and renumbering heal without a
        restart."""
        me = threading.current_thread()
        next_fire = self._clock()
        next_rediscovery = next_fire + self._rediscovery_interval
        while not self._stop.is_set():
            if self._thread is not None and self._thread is not me:
                # Crash-only supervision: a respawn replaced this thread
                # while it was wedged. Now that it unwedged, retire
                # quietly — the fresh thread owns the loop.
                log.info("poll loop thread %s superseded by respawn; "
                         "retiring", me.name)
                return
            if (self._rediscovery_interval > 0
                    and self._clock() >= next_rediscovery):
                self.rediscover()
                next_rediscovery = self._clock() + self._rediscovery_interval
            try:
                self._tick_as(me)
            except Exception:
                # A tick must never kill the loop: an exception escaping a
                # collector would otherwise leave the HTTP server serving a
                # stale snapshot while /healthz went on passing until its
                # max age. Count, log, keep ticking.
                self._count_error("tick_crash")
                log.exception("poll tick crashed; continuing")
            if self._heartbeat is not None:
                # After the tick, crash or not: only a HUNG tick must
                # starve the watchdog into a respawn.
                try:
                    self._heartbeat()
                except Exception:  # noqa: BLE001 - observer must not kill us
                    log.debug("poll heartbeat raised", exc_info=True)
            next_fire += self._interval
            delay = next_fire - self._clock()
            if delay <= 0:
                # Ticks are overrunning the interval; resynchronize rather
                # than firing a burst of catch-up ticks.
                next_fire = self._clock()
                continue
            self._stop.wait(delay)

    def start(self) -> None:
        self.respawn()

    def respawn(self) -> None:
        """(Re)start the loop thread — the supervisor's crash-only restart
        path: a wedged previous thread is abandoned and retires itself at
        its next loop check. State carried by self (rate baselines,
        restart counters, energy) survives, so a respawn is not a
        telemetry reset."""
        thread = spawn(self.run_forever, name="poll-loop")
        self._thread = thread
        thread.start()

    def thread_alive(self) -> bool:
        """Liveness probe for the supervisor."""
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self._pool.shutdown()

    # -- internals -----------------------------------------------------------

    def _traced_read(self, name: str, inner):
        """Wrap a per-device sampling callable so each pool-thread read
        records an aux span carrying the device id — the flight
        recorder's "which device" answer."""
        tracer = self.tracer

        def read(dev):
            start_ns = tracer.clock_ns()
            try:
                return inner(dev)
            finally:
                tracer.aux_span(name, start_ns, device=dev.device_id)

        return read

    def _sample_all(self) -> list[tuple[Device, Sample | None]]:
        if self._proc_future is None:
            self._proc_future = self._pool.submit(procstats.read)
        if self._host is not None and self._host_future is None:
            # At most one host read in flight: the dozens of /proc, /sys
            # and cgroup reads overlap the device fan-out like the
            # procstats prefetch.
            self._host_future = self._pool.submit(self._host.read)
        if not self._devices:
            return []
        self._collector.begin_tick()
        # Split path (NVML): pool workers run only the blocking reads; the
        # loop thread assembles every device in memory, from this tick's
        # reads (blocking) or the last completed round (pipelined).
        split = (
            hasattr(self._collector, "read_environment")
            and hasattr(self._collector, "assemble")
        )
        work = (self._collector.read_environment if split
                else self._collector.sample)
        tracer = self.tracer
        if tracer.enabled:
            work = self._traced_read("env_read" if split else "sample",
                                     work)
        slot_of = self._slot_of
        results: list = [None] * len(self._devices)
        futures: dict[concurrent.futures.Future, Device] = {}
        # Single gate for both the fast-path entry and the blocking
        # fallback's age-fenced wait below — they must always agree.
        pipelined = (split and self._fetch_max_age is not None
                     and getattr(self._collector, "pipelined_wait", False))
        if pipelined:
            fast = self._sample_pipelined(results)
            if fast is not None:
                return fast
        for dev in self._devices:
            stuck = self._outstanding.get(dev.device_id)
            if stuck is not None:
                if not stuck.done():
                    # Previous sample is still wedged inside the backend;
                    # mark stale again rather than stacking another worker.
                    self._count_error("stuck")
                    results[slot_of[dev.device_id]] = (dev, None)
                    continue
                # pop, not del: an abandoned (superseded) loop thread
                # can race this check-then-remove with the fresh thread.
                self._outstanding.pop(dev.device_id, None)
            futures[self._pool.submit(work, dev)] = dev
        # One shared budget for the whole tick: every wait draws down the
        # same remainder, so one slow device can only consume what's
        # left — the deadline is a property of the TICK, not of each child.
        budget = DeadlineBudget(self._deadline, clock=self._clock)
        runtime_ready = False
        if split:
            mark = tracer.mark()
            try:
                if pipelined:
                    self._collector.wait_ready(
                        budget.take(), max_age=self._fetch_max_age)
                else:
                    self._collector.wait_ready(budget.take())
                runtime_ready = True
            except Exception as exc:
                # The join missed the tick deadline (or died): assemble
                # from the reads alone, never a crash.
                self._count_error("fetch_deadline")
                if log_every("poll:fetch_deadline", 30.0):
                    log.warning("runtime fetch not ready within %gs: %s "
                                "(repeats suppressed for 30s; rate in "
                                "collector_poll_errors_total)",
                                self._deadline, exc)
            tracer.add_span("fetch_wait", mark, ready=runtime_ready)
            # Capture the read generation the assembles below will serve —
            # the fold keys its interconnect rate-feed dedup on it.
            # Captured HERE, right after the join and before any assemble:
            # reading it at fold time instead would race the read threads.
            self._tls.tick_runtime_seq = getattr(
                self._collector, "runtime_fetch_seq", None)
        env_fresh = False
        mark = tracer.mark()
        for future, dev in futures.items():
            slot = slot_of[dev.device_id]
            try:
                outcome = future.result(timeout=budget.take())
                if split:
                    # Feed the pipelined path's completed-state map so
                    # the NEXT tick can assemble without waiting.
                    self._env_results[dev.device_id] = (outcome, None)
                    env_fresh = True
                    outcome = self._assemble(dev, outcome, None,
                                             runtime_ready)
                results[slot] = (dev, outcome)
            except concurrent.futures.TimeoutError:
                if not future.cancel():
                    self._outstanding[dev.device_id] = future
                # This device has NO completed read this round: drop any
                # older entry so the pipelined path degrades it honestly
                # instead of serving frozen values fenced only by the
                # round-global freshness stamp.
                if split:
                    self._env_results.pop(dev.device_id, None)
                self._count_error("deadline")
                if log_every(f"poll:deadline:{dev.device_id}", 30.0):
                    log.warning("sample of %s missed the %gs deadline "
                                "(repeats suppressed for 30s)",
                                dev.device_path, self._deadline)
                results[slot] = (dev, None)
            except Exception as exc:  # CollectorError and anything else
                if split and not isinstance(
                        exc, concurrent.futures.CancelledError):
                    # The read failed: assemble decides what survives. A
                    # CollectorError is expected degradation (a lost
                    # card); anything else is a bug and must stay
                    # visible to alerting.
                    if not isinstance(exc, CollectorError):
                        self._count_error(type(exc).__name__)
                        if log_every(f"poll:env:{dev.device_id}", 30.0):
                            log.warning("environment read of %s failed: %s "
                                        "(repeats suppressed for 30s)",
                                        dev.device_path, exc)
                    self._env_results[dev.device_id] = ({}, exc)
                    env_fresh = True
                    results[slot] = (
                        dev, self._assemble(dev, {}, exc, runtime_ready))
                    continue
                self._count_error(type(exc).__name__)
                if log_every(f"poll:sample:{dev.device_id}", 30.0):
                    log.warning("sample of %s failed: %s "
                                "(repeats suppressed for 30s)",
                                dev.device_path, exc)
                results[slot] = (dev, None)
        tracer.add_span("env_round", mark)
        if split and env_fresh:
            # Move the pipelined path's freshness fence only when a read
            # actually completed this tick (success or answered failure):
            # a tick where EVERY read timed out must leave the fence
            # expired so the next tick blocks again, rather than re-arm
            # the fast path around entries that never got refreshed.
            self._env_results_at = self._clock()
        if not split:
            # Generic path: each sample() did its own reads — the
            # generation is settled once the gather above has drained.
            self._tls.tick_runtime_seq = getattr(
                self._collector, "runtime_fetch_seq", None)
        return results

    def _harvest_env(self, device_id: str,
                     future: concurrent.futures.Future) -> None:
        """Fold one COMPLETED read into the pipelined state map, with the
        same accounting as the blocking path's read-failure branch: a
        CollectorError is expected degradation, but anything else must
        hit collector_poll_errors_total and the log, or the outage is
        invisible to the counter operators are told to alert on."""
        try:
            self._env_results[device_id] = (future.result(), None)
        except Exception as exc:  # noqa: BLE001 - per-device, via assemble
            if not isinstance(exc, CollectorError):
                self._count_error(type(exc).__name__)
                if log_every(f"poll:env:{device_id}", 30.0):
                    log.warning("environment read of device %s failed: %s "
                                "(repeats suppressed for 30s)",
                                device_id, exc)
            self._env_results[device_id] = ({}, exc)

    def _sample_pipelined(
        self, results: list
    ) -> list[tuple[Device, Sample | None]] | None:
        """Zero-wait tick for split backends: assemble every device from
        the last COMPLETED read round while the next round runs on the
        pool. Returns None when the completed state is cold (startup) or
        older than the freshness fence — the caller then runs the
        blocking fan-out, which re-engages every deadline/staleness
        mechanism exactly as without pipelining."""
        now = self._clock()
        tracer = self.tracer
        round_ = self._env_round
        if round_ is not None and all(f.done() for f in round_.values()):
            for device_id, future in round_.items():
                self._harvest_env(device_id, future)
            self._env_results_at = now
            self._env_round = round_ = None
        if (self._env_results_at == 0.0
                or now - self._env_results_at > self._fetch_max_age):
            # Cold or stale (a read is wedged, or the backend is slower
            # than the fence): surrender to the blocking path. Still-
            # running reads are demoted to the per-device outstanding
            # guard so the blocking fan-out cannot stack another worker
            # onto a wedged backend.
            if self._env_results_at > 0.0 and not self._fence_expired:
                # Journaled on the EDGE (expiry, matched by the re-arm
                # event below), never per tick of an outage.
                self._fence_expired = True
                tracer.event(
                    "pipeline_fence",
                    f"completed env state older than "
                    f"{self._fetch_max_age:g}s; blocking fan-out "
                    f"re-engaged",
                    age_s=round(now - self._env_results_at, 3))
            if round_ is not None:
                self._env_round = None
                for device_id, future in round_.items():
                    if not future.done():
                        self._outstanding.setdefault(device_id, future)
                        tracer.event(
                            "pipeline_demote",
                            f"device {device_id}: wedged env read demoted "
                            f"to the outstanding guard",
                            device=device_id)
                        # Its completed entry is now older than the fence;
                        # a later pipelined tick must see "no read has
                        # completed yet", not serve the frozen pre-wedge
                        # values as fresh forever.
                        self._env_results.pop(device_id, None)
                    else:
                        # A slow sibling pushed the round past the fence,
                        # but THIS read finished — record it (the blocking
                        # tick's re-read then overwrites it on success).
                        # No stamp move: the fence stays expired.
                        self._harvest_env(device_id, future)
            return None
        if round_ is None:
            # Reap outstanding (previously wedged) reads that have since
            # finished — the blocking path does this per device; without
            # it a device demoted once would be excluded from every
            # pipelined round until the next cold tick.
            for device_id in [d for d, f in self._outstanding.items()
                              if f.done()]:
                self._outstanding.pop(device_id, None)
            read = self._collector.read_environment
            if tracer.enabled:
                read = self._traced_read("env_read", read)
            self._env_round = {
                dev.device_id: self._pool.submit(read, dev)
                for dev in self._devices
                if dev.device_id not in self._outstanding
            }
        runtime_ready = True
        mark = tracer.mark()
        try:
            # Age-bounded join: in steady state it returns at once.
            self._collector.wait_ready(self._deadline,
                                       max_age=self._fetch_max_age)
        except Exception:  # noqa: BLE001 - degraded tick, never a crash
            self._count_error("fetch_deadline")
            runtime_ready = False
        tracer.add_span("fetch_wait", mark, ready=runtime_ready)
        # Same capture point as the blocking path: the generation the
        # assembles below will serve, fixed before any assemble runs.
        self._tls.tick_runtime_seq = getattr(
            self._collector, "runtime_fetch_seq", None)
        mark = tracer.mark()
        slot_of = self._slot_of
        empty_env: dict = {}
        for dev in self._devices:
            entry = self._env_results.get(dev.device_id)
            if entry is None:
                stuck = self._outstanding.get(dev.device_id)
                if stuck is not None and not stuck.done():
                    # Same contract as the blocking path's stuck branch:
                    # a read still wedged inside the backend keeps the
                    # device visibly down (up 0) and counting every tick.
                    self._count_error("stuck")
                    results[slot_of[dev.device_id]] = (dev, None)
                    continue
                # New device (or one just reaped, awaiting its first
                # round): no completed read yet.
                env, env_err = empty_env, CollectorError(
                    "no environment read has completed yet")
            else:
                env, env_err = entry
            results[slot_of[dev.device_id]] = (
                dev, self._assemble(dev, env, env_err, runtime_ready))
        tracer.add_span("env_round", mark, pipelined=True)
        if self._fence_expired:
            # The fast path served again: close the expiry edge so the
            # next outage journals a fresh pair.
            self._fence_expired = False
            tracer.event("pipeline_resume",
                         "pipelined fast path re-armed (completed env "
                         "state fresh again)")
        return results

    def _assemble(self, dev: Device, env, env_err,
                  runtime_ready: bool) -> Sample | None:
        """In-memory merge for the split path; None marks stale."""
        try:
            return self._collector.assemble(dev, env, env_err,
                                            runtime_ready=runtime_ready)
        except Exception as exc:
            self._count_error(type(exc).__name__)
            if log_every(f"poll:sample:{dev.device_id}", 30.0):
                log.warning("sample of %s failed: %s "
                            "(repeats suppressed for 30s)",
                            dev.device_path, exc)
            return None

    def _count_error(self, reason: str) -> None:
        self._errors[reason] = self._errors.get(reason, 0) + 1

    def _harvest_procstats(self) -> Mapping[str, float]:
        """Last completed /proc reading. Non-blocking on warm ticks; the
        COLD snapshot joins its own read (never reads inline *after* the
        pool read was submitted — a fresher first point would make the
        process_* counters go backwards on the second scrape)."""
        future = self._proc_future
        if future is not None and (future.done() or self._procstats is None):
            self._proc_future = None
            try:
                self._procstats = future.result(timeout=5.0)
            except Exception:  # noqa: BLE001 - self-metrics must not kill a tick
                log.debug("procstats read failed", exc_info=True)
        if self._procstats is None:
            self._procstats = procstats.read()
        return self._procstats

    def _harvest_hoststats(self):
        """Last completed host-signals read (hoststats.py). Strictly
        non-blocking — unlike procstats there is no cold inline read:
        the kts_host_* families are absent until the first pool read
        completes (a tick must never wait on a wedged /proc)."""
        future = self._host_future
        if future is not None and future.done():
            self._host_future = None
            try:
                snap = future.result()
            except Exception:  # noqa: BLE001 - host stats must not kill a tick
                self._count_error("hoststats")
                log.debug("host-stats read failed", exc_info=True)
            else:
                # Per-read parse errors (a garbage PSI line, a hostile
                # cgroup file) surface on the counter operators are told
                # to alert on — the same contract as the read path.
                for reason in snap.errors:
                    self._count_error(reason)
                self._host_snap = snap
        return self._host_snap

    _MAX_RAW_FAMILIES = 64
    # Real topologies have a handful of interconnect links per device; 64
    # is far beyond any hardware and well below a churn blowup.
    _MAX_ICI_LINKS = 64

    def _admit_raw_family(self, family: str) -> bool:
        """Cap the distinct passthrough family names. Over-cap names are
        dropped, counted as raw_family_cap poll errors, and never stored."""
        if family in self._raw_families:
            return True
        if len(self._raw_families) >= self._MAX_RAW_FAMILIES:
            if not self._raw_cap_warned:
                self._raw_cap_warned = True
                log.warning(
                    "passthrough family cap (%d) reached; dropping %r and "
                    "any further new families (counted as raw_family_cap "
                    "poll errors)", self._MAX_RAW_FAMILIES, family)
            return False
        self._raw_families.add(family)
        return True

    def _plan_for(self, dev: Device) -> _DevicePlan:
        """Current compiled plan for this device — compile-on-miss. The
        attribution key (sorted items) is the validity condition: a value
        change for the SAME key set (pod rescheduled, empty→populated→
        empty transitions) recompiles exactly this device's plan."""
        attribution = self._attribution.lookup(dev)
        # Cardinality fence BEFORE the plan key: an over-cap label value
        # degrades to the "overflow" aggregate here, so churned values
        # share one plan (and one series set) per device.
        attribution = self._label_fence.fence(attribution)
        key = tuple(sorted(attribution.items()))
        plan = self._plans.get(dev.device_id)
        if plan is not None and plan.key == key:
            self._plan_cache_hits += 1
            return plan
        reason = "device" if plan is None else "attribution"
        self._plan_compiles[reason] = self._plan_compiles.get(reason, 0) + 1
        self.tracer.event(
            "plan_compile",
            f"device {dev.device_id}: tick plan compiled ({reason})",
            device=dev.device_id, reason=reason)
        plan = _DevicePlan(dev, key, attribution, self._topology,
                           self._drop_labels, self._disabled_metrics,
                           self._built_cell)
        self._plans[dev.device_id] = plan
        return plan

    def _observe_energy(self, plan: _DevicePlan, device_id: str,
                        now: float, watts: float | None,
                        bsamples) -> None:
        """One device-tick into the energy accountant, attributed to
        the pod the plan's kubelet join names RIGHT NOW (a rescheduled
        pod's draw lands on the new owner from this tick on)."""
        attribution = dict(plan.key)
        self._energy_acct.observe(
            device_id, attribution.get("pod", ""),
            attribution.get("namespace", ""), now, watts, bsamples)

    # -- tick state update (the only mutating phase) -------------------------

    def _update_tick_state(
        self, results: list[tuple[Device, Sample | None]], now: float
    ) -> list[_TickDevice]:
        """Fold one tick's samples into persistent per-device state
        (retained totals, restart detection, energy integration, rate
        baselines, passthrough admission) and return the derived per-
        device records. All mutation lives here; the emitter below is a
        pure function of the returned records."""
        # Attribution staleness: the kubelet breaker is open / refreshes
        # persistently failing, so lookups serve the retained last-good
        # mapping. Evaluated once per snapshot.
        attr_stale = bool(getattr(self._attribution, "stale", False))
        openers = self._process_openers
        # Rate-feed dedup for pipelined ticks: when the collector exposes
        # a read generation and it hasn't advanced since the last fold,
        # this tick is re-serving the SAME counters — replay the
        # previously computed rates rather than hand the tracker a
        # duplicate observation. The generation was captured at the
        # sampling path's join, NOT here: reading it at fold time would
        # race the read threads. Collectors without the attribute always
        # count as fresh; direct _build_snapshot callers see None too.
        runtime_seq = getattr(self._tls, "tick_runtime_seq", None)
        runtime_fresh = (runtime_seq is None
                         or runtime_seq != self._runtime_seq_seen)
        self._runtime_seq_seen = runtime_seq
        session = getattr(self._collector, "session", None)
        if session != self._session_seen:
            if self._session_seen is not None:
                # Counters restarted with the session: every baseline
                # goes; the first read after it sets the new one.
                for dev in self._devices:
                    self._rates.forget_device(dev.device_id)
                self._ici_memo.clear()
            self._session_seen = session
        burst = self._burst
        energy_acct = self._energy_acct
        if burst is not None:
            # Auto-arm on power/duty-shaped anomaly events that landed in
            # the shared journal since the last tick (one cheap walk of
            # the new entries; the arm itself edge-journals back).
            burst.scan_journal()
        tick: list[_TickDevice] = []
        for dev, sample in results:
            plan = self._plan_for(dev)
            device_id = dev.device_id
            bsamples = burst.drain(device_id) if burst is not None else ()
            holders = (tuple(openers(dev.device_path))
                       if openers is not None else None)
            stale = attr_stale or (sample is not None and sample.stale)
            if sample is None:
                if energy_acct is not None and bsamples:
                    # A stale tick observed no gauge power, but armed
                    # burst samples ARE observations: integrate them (no
                    # endpoint at `now` — the gauge saw nothing).
                    self._observe_energy(plan, device_id, now, None,
                                         bsamples)
                if burst is not None:
                    burst.fold(device_id, bsamples)
                tick.append(_TickDevice(
                    dev, None, plan, stale,
                    self._last_totals.get(device_id),
                    float(self._restarts.get(device_id, 0)),
                    (self._energy.get(device_id, 0.0)
                     if device_id in self._last_power_at else None),
                    (), (), holders,
                ))
                continue
            retained_total = None
            power_value: float | None = None
            if schema.MEMORY_TOTAL.name not in sample.values:
                # Degraded samples lack capacity; the retained total keeps
                # used/total ratios and capacity recording rules from
                # flapping on slow ticks.
                retained_total = self._last_totals.get(device_id)
            for name, value in sample.values.items():
                if name == schema.MEMORY_TOTAL.name:
                    self._last_totals[device_id] = value
                elif name == schema.UPTIME.name:
                    prev = self._last_uptime.get(device_id)
                    # 1 s tolerance: clock jitter between the runtime's
                    # uptime source and our tick must not fake a bounce.
                    if prev is not None and value < prev - 1.0:
                        self._restarts[device_id] = (
                            self._restarts.get(device_id, 0) + 1)
                    self._last_uptime[device_id] = value
                elif name == schema.POWER.name:
                    # Guard the integrand: one negative sample must not
                    # un-monotone the counter and one NaN must not poison
                    # every subsequent += forever.
                    if not (value >= 0.0 and value != float("inf")):
                        continue
                    prev_at = self._last_power_at.get(device_id)
                    if prev_at is not None and now > prev_at:
                        # Cap the gap at 10 ticks: after a long outage,
                        # integrating the whole gap at the just-observed
                        # power would fabricate energy the device may not
                        # have drawn.
                        gap = min(now - prev_at, 10 * self._interval)
                        self._energy[device_id] = (
                            self._energy.get(device_id, 0.0)
                            + value * gap)
                    self._last_power_at[device_id] = now
                    power_value = value
            if energy_acct is not None and (power_value is not None
                                            or bsamples):
                # Per-pod accounting: trapezoid over the drained burst
                # samples when armed, tick rectangle otherwise
                # (power_value None = no gauge endpoint: the burst
                # readings integrate alone, as on a stale tick).
                self._observe_energy(plan, device_id, now, power_value,
                                     bsamples)
            if burst is not None:
                burst.fold(device_id, bsamples)
            ici_items = sorted(sample.ici_counters.items())
            if len(ici_items) > self._MAX_ICI_LINKS:
                # A buggy backend minting unique link names per tick must
                # not mint unbounded series (or grow the rate tracker
                # unboundedly). Sorted-first-N keeps a stable subset.
                self._count_error("ici_link_cap")
                ici_items = ici_items[:self._MAX_ICI_LINKS]
            if not ici_items:
                ici: tuple = ()
            else:
                memo = self._ici_memo.get(device_id)
                # Replay only a memo from THIS generation: a device that
                # was stuck (sample None) on the generation's first fold
                # has a previous-generation memo, and its now-unstuck
                # counters must be fed, not shadowed by older values.
                if (runtime_fresh or memo is None
                        or memo[0] != runtime_seq):
                    ici = tuple(
                        (link, counter,
                         self._rates.rate(device_id, link, counter, now))
                        for link, counter in ici_items
                    )
                    self._ici_memo[device_id] = (runtime_seq, ici)
                else:
                    # Same read generation as the memo: identical
                    # counters by construction — the replayed tuple IS
                    # this tick's truth.
                    ici = memo[1]
            raw: tuple[tuple[str, str, float], ...] = ()
            if sample.raw_values:
                admitted = []
                for key in sorted(sample.raw_values):
                    family, link = key
                    if not self._admit_raw_family(family):
                        self._count_error("raw_family_cap")
                        continue
                    admitted.append((family, link, sample.raw_values[key]))
                raw = tuple(admitted)
            tick.append(_TickDevice(
                dev, sample, plan, stale,
                retained_total,
                # Unconditional, born at 0 (increase() discipline): the
                # series must exist before the first restart or the alert
                # misses a burst that starts the series at N.
                float(self._restarts.get(device_id, 0)),
                # Energy appears once power has (born at 0 on the first
                # power observation — never for collectors with no power
                # source, like the embedded one).
                (self._energy.get(device_id, 0.0)
                 if device_id in self._last_power_at else None),
                ici, raw, holders,
            ))
        return tick

    # -- emitter (pure) ------------------------------------------------------

    def _emit_device_plan(self, builder: SnapshotBuilder,
                          rec: _TickDevice) -> None:
        """Write one device's values into its compiled plan slots."""
        plan = rec.plan
        sample = rec.sample
        stale = rec.stale
        add = builder.add_series
        if sample is None:
            add(plan.up.emit(0.0, False))
            if rec.retained_total is not None and plan.memory_total is not None:
                # stale="true" rides GAUGES only (never counters — a label
                # flip mid-outage would blind increase(); never
                # accelerator_up — the health contract keeps one identity).
                add(plan.memory_total.emit(rec.retained_total, stale))
            # The restart and energy counters stay emitted through an
            # outage (like MEMORY_TOTAL): a counter series must not
            # vanish and blind increase().
            if plan.restarts is not None:
                add(plan.restarts.emit(rec.restarts, False))
            if rec.energy is not None and plan.energy is not None:
                add(plan.energy.emit(rec.energy, False))
            return
        # A stale sample is NOT up: accelerator_up is the contract that
        # says "this device is being collected", and it isn't.
        add(plan.up.emit(0.0 if sample.stale else 1.0, False))
        if rec.retained_total is not None and plan.memory_total is not None:
            add(plan.memory_total.emit(rec.retained_total, stale))
        emit = plan.emit
        for name, value in sample.values.items():
            slot = emit.get(name)
            if slot is not None:
                add(slot.emit(value, stale))
        if plan.restarts is not None:
            add(plan.restarts.emit(rec.restarts, False))
        if rec.energy is not None and plan.energy is not None:
            add(plan.energy.emit(rec.energy, False))
        if rec.ici and (plan.ici_traffic_on or plan.ici_bw_on):
            for link, counter, rate in rec.ici:
                total_slot, bw_slot = plan.ici_slots(link)
                if plan.ici_traffic_on:
                    add(total_slot.emit(float(counter), False))
                if rate is not None and plan.ici_bw_on:
                    add(bw_slot.emit(rate, stale))
        if sample.collective_ops is not None and plan.collectives is not None:
            add(plan.collectives.emit(float(sample.collective_ops), False))
        if rec.raw and plan.raw_on:
            for family, link, value in rec.raw:
                add(plan.raw_slot(family, link).emit(value, stale))

    def _contribute_shared(self, builder: SnapshotBuilder,
                           tick: list[_TickDevice]) -> None:
        """Self-observability tail of every snapshot."""
        builder.add(schema.SELF_DEVICES, float(len(tick)))
        if self._burst is not None:
            # kts_power_burst_* per device: the tick fold above already
            # updated the stats; the chip label comes from the tick's
            # device records so a renumbered card re-labels with them.
            self._burst.contribute(builder, {
                rec.dev.device_id: (("chip", str(rec.dev.index)),)
                for rec in tick
            })
        if self._energy_acct is not None:
            self._energy_acct.contribute(builder)
            # Checkpoint on the pool, never the tick path (the fsync is
            # worth milliseconds); rate-limited inside the accountant,
            # at most one write in flight.
            if self._ckpt_future is None or self._ckpt_future.done():
                self._ckpt_future = self._pool.submit(
                    self._energy_acct.checkpoint)
        if self._host is not None:
            # kts_host_* families from the last completed host read
            # (absent until one exists).
            snap = self._harvest_hoststats()
            if snap is not None:
                self._host.contribute(builder, snap)
        allocatable = getattr(self._attribution, "allocatable", None)
        if allocatable is not None:
            for resource, count in sorted(allocatable().items()):
                builder.add(
                    schema.SELF_ALLOCATABLE,
                    float(count),
                    [("resource", resource)],
                )
        for reason in sorted(self._errors):
            builder.add(
                schema.SELF_POLL_ERRORS,
                float(self._errors[reason]),
                [("reason", reason)],
            )
        for reason in sorted(self._plan_compiles):
            builder.add(
                schema.TICK_PLAN_COMPILES,
                float(self._plan_compiles[reason]),
                [("reason", reason)],
            )
        builder.add(schema.TICK_PLAN_CACHE_HITS,
                    float(self._plan_cache_hits))
        # Unconditional, born at 0: a nonzero rate means the recorder is
        # truncating (span cap hit) and the recorded traces are partial.
        builder.add(schema.TRACE_DROPPED_SPANS,
                    float(self.tracer.dropped_spans_total))
        # Flight-recorder digest: kts_tick_phase_seconds +
        # kts_slowest_tick_seconds. Absent until a first trace has
        # recorded (this tick's own trace ends after the build, so tick N
        # exports ticks 1..N-1's fold).
        contribute_trace_digest(builder, self.tracer)
        push_stats = (self._push_stats()
                      if self._push_stats is not None else None)
        if push_stats is not None:
            contribute_push_stats(builder, push_stats)
        if self._egress_stats is not None:
            # Spill / durable remote-write health: the kts_spill_* and
            # kts_remote_write_* families ride every snapshot where the
            # features are on.
            contribute_egress_stats(builder, self._egress_stats())
        # Render-lock contention: cumulative seconds readers waited to
        # enter Registry.rendered().
        builder.add(schema.RENDER_PREWARM_WAIT,
                    self._registry.render_wait_seconds)
        # The last published snapshot's series count (what a scraper
        # receives — tick N exports tick N-1's size).
        builder.add(schema.SERIES_LIVE,
                    float(len(self._registry.snapshot().series)),
                    (("component", "exposition"),))
        # The label fence's per-key hit counters when the fence is on
        # (enabling it is a deliberate series-set change).
        if self._label_fence.enabled:
            fenced = self._label_fence.fenced_totals()
            for label_key in sorted(fenced):
                builder.add(schema.CARDINALITY_FENCED,
                            float(fenced[label_key]),
                            (("label", label_key),))
        builder.add(
            schema.SELF_INFO,
            1.0,
            [("version", self._version), ("backend", self._collector.name)],
        )
        # The wire-protocol range this build speaks rides every
        # exposition so a scrape-side version census never needs the
        # push path.
        builder.add(
            schema.BUILD_INFO,
            1.0,
            [("version", self._version),
             ("proto_min", str(PROTO_MIN)),
             ("proto_max", str(PROTO_MAX))],
        )
        # Future-format files quarantined at startup stay visible for as
        # long as the process runs: the degradation they mean must never
        # be silent.
        for store, count in sorted(wal.quarantine_counts().items()):
            builder.add(schema.WAL_QUARANTINED, float(count),
                        (("store", store),))
        # Per-store durability state (the energy checkpoint's and the
        # HTTP accept fence's among them).
        contribute_store_metrics(builder)
        procstats.contribute(builder, self._harvest_procstats())
        builder.add_histogram(self._hist)
        # Collector-owned histograms (embedded mode's step-duration family).
        extra_hists = getattr(self._collector, "extra_histograms", None)
        if extra_hists is not None:
            for hist in extra_hists():
                builder.add_histogram(hist)
        if self._render_stats is not None:
            self._render_stats(builder)
        if self._health_stats is not None:
            # Supervisor.contribute: kts_breaker_state / kts_component_*
            # resilience self-metrics ride every snapshot.
            self._health_stats(builder)

    def _emit_snapshot(self, tick: list[_TickDevice]):
        tls = self._tls
        builder = getattr(tls, "builder", None)
        if builder is None:
            builder = tls.builder = (
                FilteredSnapshotBuilder(self._disabled_metrics)
                if self._disabled_metrics else SnapshotBuilder())
        else:
            builder.reset()
        for rec in tick:
            self._emit_device_plan(builder, rec)
        if self._process_openers is not None:
            for rec in tick:
                if not rec.plan.holders_on:
                    continue
                # Holder entries are (pid, comm, pod_uid, value): 1 per
                # real holder, the fold count on the capped
                # {comm="_overflow"} series (procopen.scan).
                for pid, comm, pod_uid, value in rec.holders or ():
                    builder.add_series(
                        rec.plan.holder_slot(pid, comm, pod_uid)
                        .emit(value, False))
        device_series = builder.count
        self._contribute_shared(builder, tick)
        total = builder.count
        # Allocation accounting: series_built counts Series objects
        # actually constructed this tick — plan slots re-emit their cached
        # object while the value is unchanged; the self-metrics tail
        # builds every object fresh.
        built_device = self._built_cell[0]
        self.last_tick_stats = {
            "series": total,
            "series_built": built_device + (total - device_series),
            "series_reused": device_series - built_device,
            "plan_compiles": sum(self._plan_compiles.values()),
            "plan_cache_hits": self._plan_cache_hits,
        }
        return builder.build()

    def _build_snapshot(
        self, results: list[tuple[Device, Sample | None]], now: float
    ):
        self._built_cell[0] = 0
        tracer = self.tracer
        mark = tracer.mark()
        tick = self._update_tick_state(results, now)
        tracer.add_span("fold", mark)
        mark = tracer.mark()
        snapshot = self._emit_snapshot(tick)
        tracer.add_span("plan_write", mark)
        return snapshot
