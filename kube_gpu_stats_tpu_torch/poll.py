"""Device-poll loop — the latency-critical hot loop.

Design rules, the reference's:

- per-device sampling fans out in parallel with a hard per-tick deadline —
  never serialized across devices;
- publishing is one snapshot swap — scrape traffic can't block a tick;
- any per-device failure marks that device stale (accelerator_up 0) and the
  loop keeps running.

Tick plans: per-device *series plans* — label tuples pre-joined, series
prefixes pre-rendered into the render cache, per-slot Series objects
reused while their value is unchanged — are compiled once per device and
invalidated only on device churn (rediscover). The snapshot build then
writes values into plan slots instead of rebuilding every label list per
tick.

The port's copy of the reference's ``PollLoop`` on its tick-plan path and
its generic sampling path (one ``Collector.sample`` per device on the
pool). Left for the daemon slice: pod attribution, process holders, the
split/pipelined sampling of runtime backends, push/egress self-metrics,
the burst sampler, the energy accountant, host signals and supervised
respawn. The reference's pre-plan emit path is not copied either: the
reference itself is this loop's oracle (``tests/test_torch_poll.py``).
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Callable, Mapping, NamedTuple

from . import procstats, schema
from .collectors import Collector, Device, Sample
from .delta import PROTO_MAX, PROTO_MIN
from .fleetlens import contribute_trace_digest
from .ici import RateTracker
from .registry import (FilteredSnapshotBuilder, HistogramState, Registry,
                       Series, SnapshotBuilder, _series_prefix,
                       contribute_store_metrics)
from .resilience import DeadlineBudget
from .supervisor import spawn
from .tracing import Tracer, log_every
from .workers import DaemonSamplerPool

log = logging.getLogger(__name__)


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
    lazily-grown slot maps for the per-link and passthrough families
    whose label dimensions are only known at runtime. Valid until the
    device list changes (rediscover)."""

    # Lazy slot maps are bounded: link/raw dimensions are already capped
    # upstream (_MAX_ICI_LINKS / _MAX_RAW_FAMILIES) — this is a second
    # fence so a churning dimension can never grow a plan without bound
    # (overflow emits uncached, still correct).
    _MAX_LAZY_SLOTS = 512

    __slots__ = ("base", "gbase", "emit", "up", "restarts", "energy",
                 "collectives", "memory_total", "_ici", "_raw", "_cell",
                 "ici_traffic_on", "ici_bw_on", "raw_on")

    def __init__(self, dev: Device, topology: Mapping[str, str],
                 disabled: frozenset[str], cell: list[int]) -> None:
        labels = [
            ("accel_type", dev.accel_type),
            ("chip", str(dev.index)),
            ("device_path", dev.device_path),
            ("uuid", dev.uuid),
        ]
        # No attribution join in the embedded exporter: the label set
        # stays constant with empty values.
        for k in schema.ATTRIBUTION_LABELS:
            labels.append((k, ""))
        for k in schema.TOPOLOGY_LABELS:
            labels.append((k, topology.get(k, "")))
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
        self._ici: dict[str, tuple[_SeriesSlot, _SeriesSlot]] = {}
        self._raw: dict[tuple[str, str], _SeriesSlot] = {}

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


class PollLoop:
    # Seconds between re-enumerations of the devices (off the tick path).
    REDISCOVERY_INTERVAL = 60.0

    def __init__(
        self,
        collector: Collector,
        registry: Registry,
        *,
        interval: float = 1.0,
        deadline: float = 0.050,
        topology_labels: Mapping[str, str] | None = None,
        version: str = "dev",
        disabled_metrics: frozenset[str] = frozenset(),
        render_stats: Callable[[SnapshotBuilder], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._collector = collector
        self._registry = registry
        self._interval = interval
        self._deadline = deadline
        self._topology = dict(topology_labels or {})
        self._version = version
        # Family selection (--metrics-include/--metrics-exclude): names
        # the builder silently drops. Resolved + validated by
        # schema.resolve_metric_filter at config time.
        self._disabled_metrics = frozenset(disabled_metrics)
        # Scrape/render self-observability contributor (RenderStats.
        # contribute): folds scrape-duration histograms and rendered-bytes
        # counters into each snapshot.
        self._render_stats = render_stats
        self._clock = clock
        # Flight recorder: every tick records phase spans (sample round,
        # fold, plan_write, publish) plus the per-device reads from the
        # pool as aux spans.
        self.tracer = Tracer()
        self._tick_seq = 0

        self._devices: list[Device] = list(collector.discover())
        workers = max(4, len(self._devices))
        # Daemon-thread pool, NOT ThreadPoolExecutor: its non-daemon workers
        # are joined by an interpreter-exit hook, so one sample wedged in a
        # sick backend would make the process unkillable (workers.py).
        self._pool = DaemonSamplerPool(workers, thread_name_prefix="sampler")
        self._rates = RateTracker()
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
        # Compiled tick plans, one per device, keyed by device_id.
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
        self.last_tick_stats: dict[str, float] = {}
        # One builder, reset per tick (build() materializes the
        # snapshot's tuples, so clearing the backing lists is safe); the
        # filter set is fixed for the loop's life.
        self._builder = (FilteredSnapshotBuilder(self._disabled_metrics)
                         if self._disabled_metrics else SnapshotBuilder())
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
        alive = {dev.device_id for dev in self._devices}
        state_dicts = (self._last_totals, self._last_uptime,
                       self._restarts, self._energy, self._last_power_at)
        known = set().union(*(d.keys() for d in state_dicts))
        for device_id in known - alive:
            self._rates.forget_device(device_id)
            for state in state_dicts:
                state.pop(device_id, None)
        for device_id in [d for d in self._outstanding if d not in alive]:
            self._outstanding.pop(device_id).cancel()

    def tick(self) -> float:
        """Run one poll over all devices; publish a snapshot; return tick
        duration in seconds."""
        tracer = self.tracer
        self._tick_seq += 1
        tracer.begin("tick", self._tick_seq)
        start = self._clock()
        results = self._sample_all()
        duration = self._clock() - start
        self._hist = self._hist.observe(duration)
        snapshot = self._build_snapshot(results, now=start + duration)
        mark = tracer.mark()
        self._registry.publish(snapshot)
        tracer.add_span("publish", mark)
        tracer.end(devices=len(results),
                   duration_ms=round(duration * 1000.0, 3),
                   series=self.last_tick_stats.get("series", 0))
        return duration

    def run_forever(self) -> None:
        """Drift-free fixed-rate loop until stop(); re-enumerates devices on
        its own (slower) cadence."""
        next_fire = self._clock()
        next_rediscovery = next_fire + self.REDISCOVERY_INTERVAL
        while not self._stop.is_set():
            if self._clock() >= next_rediscovery:
                self.rediscover()
                next_rediscovery = self._clock() + self.REDISCOVERY_INTERVAL
            try:
                self.tick()
            except Exception:
                # A tick must never kill the loop: an exception escaping a
                # collector would otherwise leave the HTTP server serving a
                # stale snapshot while /healthz went on passing until its
                # max age. Count, log, keep ticking.
                self._count_error("tick_crash")
                log.exception("poll tick crashed; continuing")
            next_fire += self._interval
            delay = next_fire - self._clock()
            if delay <= 0:
                # Ticks are overrunning the interval; resynchronize rather
                # than firing a burst of catch-up ticks.
                next_fire = self._clock()
                continue
            self._stop.wait(delay)

    def start(self) -> None:
        self._thread = spawn(self.run_forever, name="poll-loop")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self._pool.shutdown()

    # -- internals -----------------------------------------------------------

    def _traced_read(self, inner):
        """Wrap the per-device sampling callable so each pool-thread read
        records an aux span carrying the device id — the flight
        recorder's "which device" answer."""
        tracer = self.tracer

        def read(dev):
            start_ns = tracer.clock_ns()
            try:
                return inner(dev)
            finally:
                tracer.aux_span("sample", start_ns, device=dev.device_id)

        return read

    def _sample_all(self) -> list[tuple[Device, Sample | None]]:
        if self._proc_future is None:
            self._proc_future = self._pool.submit(procstats.read)
        if not self._devices:
            return []
        self._collector.begin_tick()
        work = self._collector.sample
        tracer = self.tracer
        if tracer.enabled:
            work = self._traced_read(work)
        slot_of = self._slot_of
        results: list = [None] * len(self._devices)
        futures: dict[concurrent.futures.Future, Device] = {}
        for dev in self._devices:
            stuck = self._outstanding.get(dev.device_id)
            if stuck is not None:
                if not stuck.done():
                    # Previous sample is still wedged inside the backend;
                    # mark stale again rather than stacking another worker.
                    self._count_error("stuck")
                    results[slot_of[dev.device_id]] = (dev, None)
                    continue
                self._outstanding.pop(dev.device_id, None)
            futures[self._pool.submit(work, dev)] = dev
        # One shared budget for the whole tick: every wait draws down the
        # same remainder, so one slow device can only consume what's
        # left — the deadline is a property of the TICK, not of each child.
        budget = DeadlineBudget(self._deadline, clock=self._clock)
        mark = tracer.mark()
        for future, dev in futures.items():
            slot = slot_of[dev.device_id]
            try:
                results[slot] = (dev, future.result(timeout=budget.take()))
            except concurrent.futures.TimeoutError:
                if not future.cancel():
                    self._outstanding[dev.device_id] = future
                self._count_error("deadline")
                if log_every(f"poll:deadline:{dev.device_id}", 30.0):
                    log.warning("sample of %s missed the %gs deadline "
                                "(repeats suppressed for 30s)",
                                dev.device_path, self._deadline)
                results[slot] = (dev, None)
            except Exception as exc:  # CollectorError and anything else
                self._count_error(type(exc).__name__)
                if log_every(f"poll:sample:{dev.device_id}", 30.0):
                    log.warning("sample of %s failed: %s "
                                "(repeats suppressed for 30s)",
                                dev.device_path, exc)
                results[slot] = (dev, None)
        tracer.add_span("env_round", mark)
        return results

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
        """Current compiled plan for this device — compile-on-miss."""
        plan = self._plans.get(dev.device_id)
        if plan is not None:
            self._plan_cache_hits += 1
            return plan
        self._plan_compiles["device"] = self._plan_compiles.get("device", 0) + 1
        plan = _DevicePlan(dev, self._topology, self._disabled_metrics,
                           self._built_cell)
        self._plans[dev.device_id] = plan
        return plan

    # -- tick state update (the only mutating phase) -------------------------

    def _update_tick_state(
        self, results: list[tuple[Device, Sample | None]], now: float
    ) -> list[_TickDevice]:
        """Fold one tick's samples into persistent per-device state
        (retained totals, restart detection, energy integration, rate
        baselines, passthrough admission) and return the derived per-
        device records. All mutation lives here; the emitter below is a
        pure function of the returned records."""
        tick: list[_TickDevice] = []
        for dev, sample in results:
            plan = self._plan_for(dev)
            device_id = dev.device_id
            if sample is None:
                tick.append(_TickDevice(
                    dev, None, plan, False,
                    self._last_totals.get(device_id),
                    float(self._restarts.get(device_id, 0)),
                    (self._energy.get(device_id, 0.0)
                     if device_id in self._last_power_at else None),
                    (), (),
                ))
                continue
            retained_total = None
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
            ici_items = sorted(sample.ici_counters.items())
            if len(ici_items) > self._MAX_ICI_LINKS:
                # A buggy backend minting unique link names per tick must
                # not mint unbounded series (or grow the rate tracker
                # unboundedly). Sorted-first-N keeps a stable subset.
                self._count_error("ici_link_cap")
                ici_items = ici_items[:self._MAX_ICI_LINKS]
            ici = tuple(
                (link, counter,
                 self._rates.rate(device_id, link, counter, now))
                for link, counter in ici_items
            )
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
                dev, sample, plan, sample.stale,
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
                ici, raw,
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
        # Render-lock contention: cumulative seconds readers waited to
        # enter Registry.rendered().
        builder.add(schema.RENDER_PREWARM_WAIT,
                    self._registry.render_wait_seconds)
        # The last published snapshot's series count (what a scraper
        # receives — tick N exports tick N-1's size).
        builder.add(schema.SERIES_LIVE,
                    float(len(self._registry.snapshot().series)),
                    (("component", "exposition"),))
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
        # Per-store durability state (the HTTP accept fence's among them).
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

    def _emit_snapshot(self, tick: list[_TickDevice]):
        builder = self._builder
        builder.reset()
        for rec in tick:
            self._emit_device_plan(builder, rec)
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
