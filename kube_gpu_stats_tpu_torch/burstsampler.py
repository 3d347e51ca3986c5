"""Sub-tick power burst sampler.

The poll loop reads power once per tick, and NVML's plain power figure
(``nvmlDeviceGetPowerUsage``) is itself a one-second average: a 50 ms
inrush spike that trips a datacenter breaker, or a duty burst that skews
a per-pod energy bill, lands *between* ticks and never appears in
``accelerator_power_watts`` (PAPERS.md, "Part-time Power Measurements").
This module closes that gap without asking Prometheus to scrape any
faster: a dedicated thread samples the collector's cheap per-device
power read (``Collector.read_burst`` — on the NVML backend one
``nvmlDeviceGetFieldValues`` call for the instantaneous power field) at
100 Hz+, into a bounded per-device ring, and the poll tick FOLDS the
ring into per-device min/mean/max gauges plus a fixed-bucket histogram
(``kts_power_burst_*``) — sub-tick *shape* at scrape-rate cost.

Arming (the sampler is not meant to run hot forever on every node):

- **demand** — ``/debug/burst?arm=<seconds>`` (operators), or
  :meth:`arm` in process. Disarms itself after the hold window.
- **anomaly** — :meth:`scan_journal` watches the shared flight-recorder
  event journal for ``fleet_anomaly`` events whose breached signal is
  power/duty-shaped and auto-arms.
- **continuous** — always armed (``--burst-mode continuous``): for the
  nodes where sub-tick power is the point, e.g. breaker-budget
  validation.

Arm/disarm transitions are journaled (``burst_arm``/``burst_disarm``
events with the reason), so a post-mortem can tell exactly which
windows of a day carry sub-tick data and why.

The ring is the concurrency boundary: the sampler thread appends under
the lock, the poll tick drains under the lock, and everything derived
(cumulative histogram, last-fold stats) is touched only by the poll
thread — the same single-writer discipline as the rest of poll.py.
Tests drive the fold deterministically via :meth:`inject` with the
thread never started.

The port's copy of the reference's ``burstsampler.py``; it imports no
torch. A backend whose ``read_burst`` returns None (a card that answers
``NVML_ERROR_NOT_SUPPORTED`` for the instantaneous field) takes no
samples; :meth:`BurstSampler.status` then carries the collector's
reason under ``read``.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Mapping, Sequence

from . import schema
from .registry import HistogramState
from .supervisor import spawn

log = logging.getLogger(__name__)

MODES = ("off", "auto", "continuous")

# Journal anomaly kinds that auto-arm the sampler: the power/duty-shaped
# signals where sub-tick shape answers "what did the 1 Hz gauge miss".
_AUTO_ARM_KINDS = frozenset(("power", "duty", "power_burst"))


class BurstSampler:
    """High-rate power sampling ring + per-tick fold state.

    ``collector_fn`` resolves the CURRENT collector at each sampling
    pass (the daemon's auto-mode backend upgrade swaps collectors
    mid-life); ``devices_fn`` the current device list. Backends without
    ``read_burst`` simply produce no samples — the sampler never
    crashes a node that can't serve it.
    """

    def __init__(self, collector_fn: Callable[[], object],
                 devices_fn: Callable[[], Sequence],
                 *, hz: float = 100.0, ring: int = 4096,
                 hold: float = 30.0, mode: str = "auto",
                 tracer=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if mode not in MODES:
            raise ValueError(f"burst mode must be one of {MODES}")
        if hz <= 0:
            raise ValueError("burst hz must be > 0")
        self._collector_fn = collector_fn
        self._devices_fn = devices_fn
        self.hz = hz
        self.hold = hold
        self.mode = mode
        self._tracer = tracer
        self._clock = clock
        self._lock = threading.Lock()
        self._rings: dict[str, collections.deque] = {}
        self._ring_cap = ring
        # Armed-until stamp on the injected clock; continuous mode pins
        # it to +inf. 0.0 = disarmed.
        self._armed_until = float("inf") if mode == "continuous" else 0.0
        self._arm_reason = "continuous" if mode == "continuous" else ""
        self.arms_total: dict[str, int] = (
            {"continuous": 1} if mode == "continuous" else {})
        # Fold state (poll thread only): per-device cumulative histogram
        # counts, sample totals, and the last fold's min/mean/max.
        self._hist: dict[str, list] = {}  # id -> [counts, total, sum]
        self.samples_total: dict[str, int] = {}
        self.last_fold: dict[str, dict] = {}
        # Cumulative wall seconds the sampling thread spent inside
        # read_burst — the sampler's own cost.
        self.read_seconds_total = 0.0
        self._last_event_id = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Optional supervisor heartbeat: the daemon sets this to
        # Supervisor.beater("burst") so a sampler wedged inside an NVML
        # call is detected as a HANG, not only outright thread death.
        # Beaten once per loop pass.
        self.heartbeat = None

    # -- arming ---------------------------------------------------------------

    @property
    def armed(self) -> bool:
        return self._clock() < self._armed_until

    def arm(self, seconds: float | None = None,
            reason: str = "demand") -> float:
        """Arm (or extend) the sampling window; returns the hold length.
        A later expiry never shortens an earlier one. Arm-state writes
        hold the lock: arm() runs on HTTP handler threads (/debug/burst)
        and the poll thread (journal scan) while the sampler thread's
        expiry check runs beside them."""
        hold = seconds if seconds and seconds > 0 else self.hold
        with self._lock:
            until = self._clock() + hold
            newly = not self.armed
            if until > self._armed_until:
                self._armed_until = until
            self._arm_reason = reason
            if newly:
                # Transition-counted like the journal (the metric help
                # documents arm TRANSITIONS): extending an open window
                # must not inflate the incident counter.
                self.arms_total[reason] = self.arms_total.get(reason, 0) + 1
        if newly and self._tracer is not None:
            self._tracer.event(
                "burst_arm",
                f"burst sampler armed for {hold:g}s ({reason})",
                reason=reason, hold_s=round(hold, 3))
        self._wake.set()
        return hold

    def disarm(self, reason: str = "demand") -> None:
        if self.mode == "continuous":
            return  # continuous mode has no disarmed state
        with self._lock:
            was_armed = self.armed
            self._armed_until = 0.0
        if was_armed and self._tracer is not None:
            self._tracer.event("burst_disarm",
                               f"burst sampler disarmed ({reason})",
                               reason=reason)

    def scan_journal(self) -> None:
        """Auto-arm on power/duty-shaped anomaly events in the shared
        journal (poll calls this once per tick — one cheap list walk of
        events newer than the last scan). Only ``auto`` mode scans:
        continuous is already armed, off never samples."""
        if self.mode != "auto" or self._tracer is None:
            return
        payload = self._tracer.events(since=self._last_event_id)
        self._last_event_id = payload.get("last_id", self._last_event_id)
        for event in payload.get("events", ()):
            if (event.get("kind") == "fleet_anomaly"
                    and event.get("attrs", {}).get("anomaly")
                    in _AUTO_ARM_KINDS):
                self.arm(reason="anomaly")
                return

    # -- sampling (dedicated thread) ------------------------------------------

    def _read_once(self) -> int:
        """One sampling pass over every device; returns samples taken."""
        collector = self._collector_fn()
        read = getattr(collector, "read_burst", None)
        if not callable(read):
            return 0
        taken = 0
        now = self._clock()
        start = time.monotonic()
        for dev in self._devices_fn():
            try:
                watts = read(dev)
            except Exception:  # noqa: BLE001 - a sick chip degrades itself
                continue
            if watts is None:
                continue
            self.inject(dev.device_id, now, float(watts))
            taken += 1
        self.read_seconds_total += time.monotonic() - start
        return taken

    def inject(self, device_id: str, t: float, watts: float) -> None:
        """Append one sample (sampler thread; tests drive the fold
        deterministically through this with the thread never started).
        The chokepoint guard: a NaN/negative/inf reading (a garbled
        power read) must not poison the
        cumulative histogram sum or the joules integral downstream —
        the same integrand discipline as poll.py's rectangle path."""
        if not (0.0 <= watts < float("inf")):
            return
        with self._lock:
            ring = self._rings.get(device_id)
            if ring is None:
                ring = self._rings[device_id] = collections.deque(
                    maxlen=self._ring_cap)
            ring.append((t, watts))

    def run_forever(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.is_set():
            if self._thread is not threading.current_thread():
                # Replaced by a respawn while wedged: retire — two
                # sampler threads would double every ring's sample
                # rate.
                log.info("burst sampler thread superseded by respawn; "
                         "retiring")
                return
            if self.heartbeat is not None:
                self.heartbeat()
            if not self.armed:
                expired = False
                with self._lock:
                    # Re-checked under the lock: an arm() landing from
                    # an HTTP thread between the armed peek above and
                    # here must not have its fresh window clobbered and
                    # mis-journaled as an expiry.
                    if (self._armed_until and not self.armed
                            and self.mode != "continuous"):
                        self._armed_until = 0.0
                        expired = True
                if expired and self._tracer is not None:
                    # Hold window lapsed between passes: close the edge.
                    self._tracer.event("burst_disarm",
                                       "burst sampler hold window expired",
                                       reason="expired")
                if expired:
                    continue  # re-peek: an arm may have raced the expiry
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            started = time.monotonic()
            self._read_once()
            # Drift-tolerant: sleep the remainder; an overrunning read
            # pass simply lowers the achieved rate (reported via
            # samples_total) instead of spinning.
            self._stop.wait(max(0.0, period - (time.monotonic() - started)))

    def start(self) -> None:
        """Start the sampling thread. A live thread is left alone; a
        DEAD one is replaced (the pre-fix `is not None` check made a
        died-once sampler unrestartable forever)."""
        if self.mode == "off" or self.thread_alive():
            return
        self.respawn()

    def respawn(self) -> None:
        """The supervisor's restart closure:
        ALWAYS spawns — a HUNG thread (heartbeat missed, still alive
        in a D-state read) is abandoned and retires itself at its next
        superseded check; start() alone could never recover a hang."""
        if self.mode == "off":
            return
        self._thread = spawn(self.run_forever, name="burst-sampler")
        self._thread.start()

    def thread_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # -- fold (poll thread) ---------------------------------------------------

    def drain(self, device_id: str) -> tuple:
        """Take every buffered sample for one device, oldest first
        ((t, watts) pairs on the injected clock)."""
        with self._lock:
            ring = self._rings.get(device_id)
            if not ring:
                return ()
            samples = tuple(ring)
            ring.clear()
        return samples

    def fold(self, device_id: str, samples: Sequence[tuple]) -> None:
        """Fold one tick's drained samples into the cumulative
        histogram + the last-fold stats (poll thread only). An empty
        drain keeps the previous fold's stats — the gauges hold their
        last observed window rather than flapping to absent between
        armed windows (the histogram/counter already carry "no new
        data" exactly)."""
        if not samples:
            return
        state = self._hist.get(device_id)
        if state is None:
            state = self._hist[device_id] = [
                [0] * (len(schema.BURST_WATTS_BUCKETS) + 1), 0, 0.0]
        counts, _, _ = state
        lo = hi = total = None
        for _t, watts in samples:
            for i, bound in enumerate(schema.BURST_WATTS_BUCKETS):
                if watts <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            if lo is None or watts < lo:
                lo = watts
            if hi is None or watts > hi:
                hi = watts
            total = (total or 0.0) + watts
        state[1] += len(samples)
        state[2] += total
        self.samples_total[device_id] = (
            self.samples_total.get(device_id, 0) + len(samples))
        self.last_fold[device_id] = {
            "min": lo, "max": hi, "mean": total / len(samples),
            "n": len(samples)}

    def contribute(self, builder,
                   chip_labels: Mapping[str, tuple]) -> None:
        """Emit the kts_power_burst_* families for every device that
        has ever folded samples (poll snapshot tail). ``chip_labels``
        maps device_id -> the label pairs to stamp (the poll loop
        passes the chip index). Arm-state families are unconditional so
        increase()/absent() alerting works from first scrape."""
        builder.add(schema.BURST_ARMED, 1.0 if self.armed else 0.0)
        for reason in sorted(self.arms_total):
            builder.add(schema.BURST_ARMS,
                        float(self.arms_total[reason]),
                        (("reason", reason),))
        for device_id in sorted(self._hist):
            labels = chip_labels.get(device_id)
            if labels is None:
                continue  # device departed; state purged on rediscover
            counts, total, watt_sum = self._hist[device_id]
            stats = self.last_fold.get(device_id)
            if stats:
                for stat in ("min", "mean", "max"):
                    builder.add(schema.BURST_WATTS, stats[stat],
                                labels + (("stat", stat),))
            builder.add(schema.BURST_SAMPLES,
                        float(self.samples_total.get(device_id, 0)),
                        labels)
            builder.add_histogram(HistogramState(
                schema.BURST_HIST, schema.BURST_WATTS_BUCKETS,
                tuple(counts), total, watt_sum, labels))

    def forget_device(self, device_id: str) -> None:
        """Purge one device's ring + fold state (poll rediscovery: a
        renumbered chip must not inherit another chip's histogram)."""
        with self._lock:
            self._rings.pop(device_id, None)
        self._hist.pop(device_id, None)
        self.samples_total.pop(device_id, None)
        self.last_fold.pop(device_id, None)

    # -- read side (/debug/burst) ---------------------------------------------

    def status(self) -> dict:
        now = self._clock()
        with self._lock:
            # Snapshot the per-device views: status() answers HTTP
            # threads while the poll thread folds new devices in.
            device_ids = sorted(self._hist)
            samples_total = dict(self.samples_total)
            last_fold = dict(self.last_fold)
        # Why a device takes no samples, per the collector (the NVML
        # backend: "not supported" where the card refuses the
        # instantaneous power field); {} when every read answers.
        reasons = getattr(self._collector_fn(), "burst_state", None)
        return {
            "enabled": self.mode != "off",
            "mode": self.mode,
            "armed": self.armed,
            "armed_for_s": round(max(0.0, self._armed_until - now), 3)
            if self.armed and self._armed_until != float("inf") else None,
            "arm_reason": self._arm_reason if self.armed else "",
            "hz": self.hz,
            "hold_s": self.hold,
            "arms_total": dict(self.arms_total),
            "devices": {
                device_id: {
                    "samples_total": samples_total.get(device_id, 0),
                    "last_fold": last_fold.get(device_id),
                }
                for device_id in device_ids
            },
            "read": dict(reasons) if reasons else {},
        }
