"""Flight recorder: per-tick span tracing and an event journal.

The port's copy of the reference's recorder. Three pieces:

- **Spans** — ``with tracer.span(name, **attrs)``, or the non-indenting
  ``mark()``/``add_span()`` pair the poll loop uses, and ``aux_span()``
  for the per-device reads on the sampler threads. Per-trace span count
  is capped; overflow counts in ``dropped_spans_total``
  (``kts_trace_dropped_spans_total``) instead of growing memory.
- **Trace ring** — ``begin(kind, seq)`` … ``end(**meta)`` brackets one
  poll tick into an immutable :class:`TickTrace`, kept in a ring of the
  last ``capacity``. Read as per-phase p50/p99 plus a slowest-tick table
  (:meth:`ticks_summary`, served as ``/debug/ticks``), as Chrome
  trace-event JSON (:meth:`chrome_trace`, ``/debug/trace?last=N``), and
  as the cumulative digest the snapshot tail exports
  (:meth:`phase_quantiles`, :meth:`slowest_tick`:
  ``kts_tick_phase_seconds`` and ``kts_slowest_tick_seconds``).
- **Event journal** — :meth:`event` records state transitions (breaker
  trips, supervisor health flips, restart storms, plan compiles, the
  label fence's first overflow), each stamped with the tick seq current
  when it fired. Served as ``/debug/events?since=<id>``; ``doctor
  --trace`` joins it with the slowest-tick table into a post-mortem.

Concurrency: the in-progress span list is thread-local, so an abandoned
wedged loop thread can never interleave its spans into the fresh
thread's trace. Sampler threads record completed observations through
``aux_span`` into a small locked buffer that ``end()`` drains into the
finishing trace. The ring and journal are deques; the read side and the
journal take the cold-path lock, never the span path.

``measure_overhead_ns()`` prices one enabled span for the bench.
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


class Event(NamedTuple):
    """One journal entry. ``tick_seq`` is the trace seq current when the
    event fired — the join key the doctor uses against the slowest-tick
    table."""

    id: int
    tick_seq: int
    at: float
    kind: str
    detail: str
    attrs: Mapping


class _Span:
    """Context-manager shape of the span API. One short-lived object per
    span; everything hot is __slots__ attribute access."""

    __slots__ = ("_tracer", "_spans", "_name", "_attrs", "_start")

    def __init__(self, tracer: "Tracer", spans: list, name: str,
                 attrs: dict | None) -> None:
        self._tracer = tracer
        self._spans = spans
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._start = self._tracer.clock_ns()
        return self

    def __exit__(self, *_exc) -> None:
        tracer = self._tracer
        spans = self._spans
        if len(spans) < tracer._max_spans:
            spans.append((self._name, self._start,
                          tracer.clock_ns() - self._start, self._attrs))
        else:
            # Cold branch (past the cap): take the lock so the unlocked
            # += can't race a pool thread's locked increment.
            with tracer._lock:
                tracer.dropped_spans_total += 1


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *_exc) -> None:
        pass


_NOOP = _NoopSpan()


class Tracer:
    """The flight recorder. One instance per daemon: the poll loop records
    into it, the supervisor and the label fence journal into it, and the
    MetricsServer serves its read side on ``/debug/*``. ``clock_ns`` and
    ``wall`` are injectable so tests drive it on fake clocks."""

    def __init__(self, *, enabled: bool = True, capacity: int = 128,
                 max_spans: int = 256, journal_capacity: int = 512,
                 clock_ns: Callable[[], int] = time.perf_counter_ns,
                 wall: Callable[[], float] = time.time) -> None:
        # False (the daemon's --no-trace) turns every recording call into
        # a cheap no-op and keeps the digest families absent; the /debug
        # endpoints stay up and say so.
        self.enabled = enabled
        self.clock_ns = clock_ns
        self._wall = wall
        self._max_spans = max_spans
        self._ring: "collections.deque[TickTrace]" = collections.deque(
            maxlen=capacity)
        self._events: "collections.deque[Event]" = collections.deque(
            maxlen=journal_capacity)
        # Cold-path lock: aux buffer, journal ids, phase fold. Never
        # taken by span()/add_span() — the loop-thread hot path.
        self._lock = threading.Lock()
        self._aux: list = []
        self._event_id = 0
        # phase name -> [bucket counts (len+1), total, sum_ns, max_ns]
        self._phases: dict[str, list] = {}
        self._tls = threading.local()
        # Trace seq of the most recent begin(): the journal's tick stamp.
        # Plain int, GIL-atomic — written by the loop thread, read by
        # whatever thread fires an event.
        self.current_seq = 0
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
        tls.at = self._wall()
        tls.start = self.clock_ns()
        tls.spans = []
        self.current_seq = seq

    def span(self, name: str, **attrs) -> _Span | _NoopSpan:
        """``with tracer.span("fold"):`` — records one span into the
        calling thread's open trace; a no-op (shared singleton, zero
        allocation) when disabled or no trace is open."""
        spans = getattr(self._tls, "spans", None)
        if spans is None:
            return _NOOP
        return _Span(self, spans, name, attrs or None)

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

    # -- journal -------------------------------------------------------------

    def event(self, kind: str, detail: str = "", **attrs) -> None:
        """Append one journal entry, stamped with the current tick seq.
        Callers own flood control (emit on a transition, never per tick):
        the journal is a bounded ring, and a per-tick repeat would evict
        the rare events a post-mortem wants."""
        if not self.enabled:
            return
        with self._lock:
            self._event_id += 1
            self._events.append(Event(
                self._event_id, self.current_seq, self._wall(), kind,
                str(detail), attrs or {}))

    def breaker_listener(self, breaker, old: str, new: str) -> None:
        """``CircuitBreaker.on_transition``-shaped hook: journals every
        breaker state change with the breaker's name and, for trips, its
        flattened last error. The supervisor attaches it to every breaker
        it can see."""
        name = getattr(breaker, "name", "") or "breaker"
        detail = f"{name}: {old} -> {new}"
        if new == "open":
            last = getattr(breaker, "last_error", None)
            if last is not None:
                text = " ".join(str(last).split())
                detail += f" ({text[:200]})"
        self.event("breaker", detail, component=name, state=new)

    # -- read side (cold) ----------------------------------------------------

    def traces(self, last: int | None = None) -> list[TickTrace]:
        out = list(self._ring)
        if last is not None and last > 0:
            out = out[-last:]
        return out

    def spans_per_trace(self) -> float:
        """Mean spans per recorded trace."""
        traces = list(self._ring)
        if not traces:
            return 0.0
        return sum(len(t.spans) for t in traces) / len(traces)

    def events(self, since: int = 0) -> dict:
        """Journal entries with id > ``since`` (the /debug/events
        payload; pass the previous response's ``last_id`` to tail)."""
        rows = [e for e in list(self._events) if e.id > since]
        return {
            "enabled": self.enabled,
            "events": [
                {"id": e.id, "tick_seq": e.tick_seq, "at": e.at,
                 "kind": e.kind, "detail": e.detail,
                 "attrs": dict(e.attrs)}
                for e in rows
            ],
            "last_id": self._event_id,
        }

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

    def ticks_summary(self) -> dict:
        """The /debug/ticks payload: cumulative per-phase p50/p99 (from
        the fixed-bucket fold — the whole process lifetime, not just the
        ring window) plus a slowest-tick table from the ring, each row
        pre-joined with its worst phase and blame span so a post-mortem
        needs no client-side trace parsing."""
        with self._lock:
            phases = {
                name: {
                    "count": state[1],
                    "p50_ms": round(self._quantile_ms(state[0], state[1],
                                                      0.50, state[3]), 3),
                    "p99_ms": round(self._quantile_ms(state[0], state[1],
                                                      0.99, state[3]), 3),
                    "max_ms": round(state[3] / 1e6, 3),
                    "mean_ms": round(state[2] / state[1] / 1e6, 3)
                    if state[1] else 0.0,
                }
                for name, state in sorted(self._phases.items())
            }
        traces = list(self._ring)
        slowest = []
        for trace in sorted(traces, key=lambda t: t.dur_ns,
                            reverse=True)[:5]:
            worst, blame = self._worst_span(trace)
            row = {
                "kind": trace.kind,
                "seq": trace.seq,
                "at": trace.at,
                "dur_ms": round(trace.dur_ns / 1e6, 3),
                "spans": len(trace.spans),
                "meta": dict(trace.meta),
                "worst_phase": worst[0] if worst else None,
                "worst_phase_ms": round(worst[2] / 1e6, 3) if worst
                else None,
            }
            if blame is not None:
                row["blame"] = {"span": blame[0],
                                "dur_ms": round(blame[2] / 1e6, 3),
                                "attrs": dict(blame[3])}
            slowest.append(row)
        return {
            "enabled": self.enabled,
            "current_seq": self.current_seq,
            "ticks_recorded": len(traces),
            "dropped_spans_total": self.dropped_spans_total,
            "phases": phases,
            "slowest": slowest,
        }

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

    def chrome_trace(self, last: int | None = None) -> dict:
        """Chrome trace-event JSON (``chrome://tracing`` / Perfetto "load
        trace"): one complete ("X") event per trace and per span, ts/dur
        in microseconds relative to the earliest recorded start so the
        viewer opens at t=0."""
        traces = self.traces(last)
        starts = [t.start_ns for t in traces]
        starts.extend(s[1] for t in traces for s in t.spans)
        base = min(starts) if starts else 0
        events: list[dict] = []
        for trace in traces:
            args = {"seq": trace.seq}
            args.update(trace.meta)
            events.append({
                "name": trace.kind, "cat": trace.kind, "ph": "X",
                "pid": 1, "tid": 1,
                "ts": (trace.start_ns - base) / 1000.0,
                "dur": trace.dur_ns / 1000.0,
                "args": args,
            })
            for name, start_ns, dur_ns, attrs in trace.spans:
                events.append({
                    "name": name, "cat": "span", "ph": "X",
                    "pid": 1, "tid": 1,
                    "ts": (start_ns - base) / 1000.0,
                    "dur": dur_ns / 1000.0,
                    "args": dict(attrs) if attrs else {},
                })
        # "enabled" rides every /debug payload (--no-trace keeps the
        # endpoints up and says so): an empty traceEvents must be told
        # apart from tracing disabled. The viewers ignore unknown keys.
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "enabled": self.enabled}


def measure_overhead_ns(spans: int = 4000) -> float:
    """Mean wall nanoseconds per enabled no-op span (enter + exit on an
    open trace). ``bench.measure_collector`` reports it as
    ``trace_overhead_ns_per_span``: tracing is on by default, so its cost
    is part of every tick."""
    tracer = Tracer(capacity=4, max_spans=128)
    tracer.begin("bench", 0)
    per_trace = 100  # under the span cap; end/begin cost amortizes
    start = time.perf_counter_ns()
    done = 0
    while done < spans:
        for _ in range(per_trace):
            with tracer.span("overhead"):
                pass
        done += per_trace
        tracer.end()
        tracer.begin("bench", 0)
    return (time.perf_counter_ns() - start) / done


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
