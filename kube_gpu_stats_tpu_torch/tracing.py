"""Flight recorder: per-tick span tracing.

The port's copy of the reference's recorder, cut to what the poll loop
uses: ``begin``/``end`` bracket one tick into a ring of recent traces,
``mark``/``add_span`` record its phases and ``aux_span`` the per-device
reads from the sampler threads. The snapshot tail exports the cumulative phase digest
(``phase_quantiles``, ``slowest_tick``) as ``kts_tick_phase_seconds`` and
``kts_slowest_tick_seconds``, and the dropped-span count as
``kts_trace_dropped_spans_total``.

``log_every(key, interval)`` also lives here: the shared rate limiter for
warning sites that can emit one line per tick during a sustained outage.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Mapping, NamedTuple, Sequence

# Phase-duration histogram bounds in NANOSECONDS, log-spaced from 1 µs
# (a warm plan-write) to 1 s (a wedged blocking join): wide enough that
# p50/p99 resolve both the ~100 µs steady-state tick and a 50 ms budget
# blowout from the same fixed table.
PHASE_BUCKETS_NS: tuple[int, ...] = (
    1_000, 10_000, 100_000, 1_000_000, 5_000_000, 10_000_000,
    25_000_000, 50_000_000, 100_000_000, 1_000_000_000,
)

# Span attribute keys that name a *responsible party* — the slowest span
# carrying one of these becomes the slowest tick's "blame" entry (the
# "which device" answer of kts_slowest_tick_seconds).
_BLAME_KEYS = ("device", "port", "target")


class TickTrace(NamedTuple):
    """One recorded tick/cycle: immutable once in the ring."""

    kind: str                  # "tick" (poll)
    seq: int                   # the loop's tick/cycle sequence number
    at: float                  # wall-clock seconds at begin()
    start_ns: int              # perf_counter_ns at begin()
    dur_ns: int
    # ((name, start_ns, dur_ns, attrs-or-None), ...) — loop-thread spans
    # in record order, then the aux spans drained at end().
    spans: tuple
    meta: Mapping


class Tracer:
    """The flight recorder. One instance per poll loop."""

    # Traces kept in the ring, and spans per trace (past the cap spans are
    # counted as dropped instead of growing memory).
    CAPACITY = 128
    MAX_SPANS = 256

    def __init__(self) -> None:
        self.enabled = True
        self.clock_ns = time.perf_counter_ns
        self._max_spans = self.MAX_SPANS
        self._ring: "collections.deque[TickTrace]" = collections.deque(
            maxlen=self.CAPACITY)
        # Cold-path lock: aux buffer, phase fold. Never taken by
        # add_span() — the loop-thread hot path.
        self._lock = threading.Lock()
        self._aux: list = []
        # phase name -> [bucket counts (len+1), total, sum_ns, max_ns]
        self._phases: dict[str, list] = {}
        self._tls = threading.local()
        self.dropped_spans_total = 0

    # -- recording (hot path) ------------------------------------------------

    def begin(self, kind: str, seq: int) -> None:
        """Open a trace for one tick/cycle on the calling thread. An
        unfinished trace on this thread (superseded/crashed tick) is
        discarded — abandon, not merge, matching crash-only loops."""
        if not self.enabled:
            return
        tls = self._tls
        tls.kind = kind
        tls.seq = seq
        tls.at = time.time()
        tls.start = self.clock_ns()
        tls.spans = []

    def mark(self) -> int:
        """Start stamp for the ``mark()``/``add_span()`` pair — the
        non-indenting form the loop bodies use. 0 = inactive."""
        if getattr(self._tls, "spans", None) is None:
            return 0
        return self.clock_ns()

    def add_span(self, name: str, start_ns: int, **attrs) -> None:
        """Close a ``mark()``: record [start_ns, now] as one span on the
        calling thread's open trace. A 0 mark (trace inactive at mark
        time) records nothing."""
        if not start_ns:
            return
        spans = getattr(self._tls, "spans", None)
        if spans is None:
            return
        if len(spans) < self._max_spans:
            spans.append((name, start_ns, self.clock_ns() - start_ns,
                          attrs or None))
        else:
            with self._lock:  # cold drop branch; see _Span.__exit__
                self.dropped_spans_total += 1

    def aux_span(self, name: str, start_ns: int, dur_ns: int | None = None,
                 **attrs) -> None:
        """Record a completed span observation from ANY thread (the
        sampler pool). Buffered and drained
        into the next trace that finishes — cross-thread work lands in
        the tick it completed under (or the one right after), which is
        what a post-mortem needs."""
        if not self.enabled or not start_ns:
            return
        if dur_ns is None:
            dur_ns = self.clock_ns() - start_ns
        with self._lock:
            if len(self._aux) < self._max_spans:
                self._aux.append((name, start_ns, dur_ns, attrs or None))
            else:
                self.dropped_spans_total += 1

    def end(self, **meta) -> TickTrace | None:
        """Close the calling thread's trace: drain the aux buffer, fold
        phase durations, push onto the ring. Returns the trace (tests,
        tools) or None when no trace was open."""
        tls = self._tls
        spans = getattr(tls, "spans", None)
        if spans is None:
            return None
        end_ns = self.clock_ns()
        tls.spans = None
        with self._lock:
            if self._aux:
                # The per-trace cap bounds the TOTAL, aux included — a
                # drain that ignored it would let one trace carry up to
                # 2x max_spans and silently undo the bound it documents.
                room = self._max_spans - len(spans)
                if room > 0:
                    spans.extend(self._aux[:room])
                overflow = len(self._aux) - max(0, room)
                if overflow > 0:
                    self.dropped_spans_total += overflow
                self._aux.clear()
            trace = TickTrace(tls.kind, tls.seq, tls.at, tls.start,
                              end_ns - tls.start, tuple(spans), meta)
            self._fold(trace.kind, trace.dur_ns)
            for name, _start, dur, _attrs in trace.spans:
                self._fold(name, dur)
        self._ring.append(trace)
        return trace

    def _fold(self, name: str, dur_ns: int) -> None:
        """Cumulative per-phase histogram update (lock held). One list
        mutation per span per trace end — never on the span path."""
        state = self._phases.get(name)
        if state is None:
            state = self._phases[name] = [
                [0] * (len(PHASE_BUCKETS_NS) + 1), 0, 0, 0]
        counts, _total, _sum, _max = state
        for i, bound in enumerate(PHASE_BUCKETS_NS):
            if dur_ns <= bound:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        state[1] += 1
        state[2] += dur_ns
        if dur_ns > state[3]:
            state[3] = dur_ns

    # -- read side (cold) ----------------------------------------------------

    @staticmethod
    def _quantile_ms(counts: Sequence[int], total: int, q: float,
                     max_ns: int) -> float:
        """Upper bucket bound (ms) holding the q-th observation — the
        same bucketed-quantile shape as registry.HistogramState. A rank
        landing in the overflow bucket reports the observed max, never
        infinity: json.dumps would serialize inf as the bare token
        ``Infinity``, making /debug/ticks invalid JSON exactly when a
        wedged >1 s tick happened — the incident the recorder exists
        to diagnose."""
        if total <= 0:
            return 0.0
        rank = q * total
        seen = 0
        for i, bound in enumerate(PHASE_BUCKETS_NS):
            seen += counts[i]
            if seen >= rank:
                return bound / 1e6
        return max_ns / 1e6

    @staticmethod
    def _worst_span(trace: TickTrace) -> tuple:
        """(worst phase span, blame span): the slowest span overall, and
        the slowest span carrying a responsible-party attr."""
        worst = None
        blame = None
        for span in trace.spans:
            if worst is None or span[2] > worst[2]:
                worst = span
            attrs = span[3]
            if attrs and any(k in attrs for k in _BLAME_KEYS):
                if blame is None or span[2] > blame[2]:
                    blame = span
        return worst, blame

    def phase_quantiles(self) -> dict[str, tuple[float, float, float]]:
        """{phase: (p50_s, p99_s, max_s)} from the cumulative fold — the
        compact digest the poll loop exports as
        ``kts_tick_phase_seconds{phase,quantile}`` so a fleet view can
        attribute cross-node slowness from the expositions it scrapes.
        p50/p99 are bucket upper bounds; max is exact."""
        with self._lock:
            items = sorted(self._phases.items())
            return {
                name: (
                    self._quantile_ms(state[0], state[1], 0.50,
                                      state[3]) / 1e3,
                    self._quantile_ms(state[0], state[1], 0.99,
                                      state[3]) / 1e3,
                    state[3] / 1e9,
                )
                for name, state in items
            }

    def slowest_tick(self) -> dict | None:
        """Summary of the slowest trace in the ring: duration, its worst
        phase, and the blame span rendered as one ``key=value`` string
        (the ``kts_slowest_tick_seconds`` digest). None when nothing has
        recorded yet."""
        traces = list(self._ring)
        if not traces:
            return None
        trace = max(traces, key=lambda t: t.dur_ns)
        worst, blame = self._worst_span(trace)
        blame_text = ""
        if blame is not None and blame[3]:
            for key in _BLAME_KEYS:
                if key in blame[3]:
                    blame_text = f"{key}={blame[3][key]}"
                    break
        return {
            "kind": trace.kind,
            "seq": trace.seq,
            "at": trace.at,
            "seconds": trace.dur_ns / 1e9,
            "phase": worst[0] if worst is not None else "",
            "phase_seconds": worst[2] / 1e9 if worst is not None else 0.0,
            "blame": blame_text,
        }

# -- rate-limited logging ----------------------------------------------------

_LOG_MARKS: dict[str, float] = {}
_LOG_LOCK = threading.Lock()
_LOG_MARKS_CAP = 4096


def log_every(key: str, interval: float = 60.0,
              clock: Callable[[], float] = time.monotonic) -> bool:
    """True when ``key`` hasn't been granted a log line within
    ``interval`` seconds — the shared limiter for warning sites that
    fire once per tick/refresh during a sustained outage (a wedged
    device at 1 Hz is 3600 identical lines per hour of DaemonSet logs;
    the counters already carry the rate). Keys are bounded: at the cap
    the mark table resets wholesale (one early repeat per key beats
    unbounded growth under key churn)."""
    now = clock()
    with _LOG_LOCK:
        last = _LOG_MARKS.get(key)
        if last is not None and now - last < interval:
            return False
        if len(_LOG_MARKS) >= _LOG_MARKS_CAP:
            _LOG_MARKS.clear()
        _LOG_MARKS[key] = now
        return True


def reset_log_marks() -> None:
    """Forget all rate-limit state (tests)."""
    with _LOG_LOCK:
        _LOG_MARKS.clear()
