"""The port's flight recorder against the JAX package's.

Both ``Tracer``s run on the same fake ``clock_ns``/``wall`` through the
same scripted sequence — begin, ``span``, ``mark``/``add_span``,
``aux_span``, end, ``event``, ``breaker_listener`` — made from a seed with
numpy, including ticks past the span cap (dropped spans from the loop
thread and from the aux buffer) and a disabled recorder. Every read-side
call must then give the reference's payload exactly. The breakers'
``on_transition`` hook is held the same way: the two packages'
``CircuitBreaker``s on one fake clock journal the same transitions.
"""

import numpy as np
import pytest

from kube_gpu_stats_tpu import resilience as ref_resilience
from kube_gpu_stats_tpu import tracing as ref_tracing
from kube_gpu_stats_tpu_torch import resilience as port_resilience
from kube_gpu_stats_tpu_torch import tracing as port_tracing


class _Clock:
    """A nanosecond counter and a wall clock that move only when told."""

    def __init__(self) -> None:
        self.ns = 1_000_000_000
        self.wall_s = 1_700_000_000.0

    def clock_ns(self) -> int:
        return self.ns

    def wall(self) -> float:
        return self.wall_s

    def advance(self, ns: int) -> None:
        self.ns += int(ns)
        self.wall_s += ns / 1e9


class _Breaker:
    """What breaker_listener reads off a breaker."""

    def __init__(self, name: str, last_error) -> None:
        self.name = name
        self.last_error = last_error


def _script(seed: int, ticks: int = 24) -> list:
    """The recording sequence: (op, args) steps with every duration drawn
    from the seed, so both recorders replay the same calls."""
    rng = np.random.default_rng(seed)
    steps: list = []
    for seq in range(1, ticks + 1):
        steps.append(("begin", seq))
        # Some ticks carry more spans than the cap (6 below).
        for k in range(int(rng.integers(1, 9))):
            kind = ("span", "mark")[int(rng.integers(0, 2))]
            attrs = {"device": str(int(rng.integers(0, 4)))} if k % 2 else {}
            steps.append((kind, f"phase{k % 3}",
                          int(rng.integers(1_000, 60_000_000)), attrs))
        for _ in range(int(rng.integers(0, 5))):
            steps.append(("aux", int(rng.integers(1_000, 5_000_000)),
                          str(int(rng.integers(0, 4))),
                          bool(rng.integers(0, 2))))
        if rng.random() < 0.3:
            steps.append(("event", "plan_compile",
                          f"device {seq % 4}: tick plan compiled (device)",
                          {"device": str(seq % 4), "reason": "device"}))
        if rng.random() < 0.2:
            error = "connect failed:\n  socket closed" if seq % 2 else None
            steps.append(("breaker", f"kubelet{seq % 2}",
                          ("closed", "open", "half_open")[seq % 3],
                          ("open", "half_open", "closed")[seq % 3], error))
        steps.append(("end", int(rng.integers(1_000, 2_000_000)),
                      {"devices": 4, "series": int(rng.integers(1, 200))}))
    # An aux span with no trace open lands in the next trace: leave one
    # pending, then a last tick drains it.
    steps.append(("aux", 7_000, "3", False))
    steps.append(("begin", ticks + 1))
    steps.append(("end", 5_000, {}))
    # end() with no trace open records nothing.
    steps.append(("end", 1_000, {}))
    return steps


def _replay(module, steps, *, enabled: bool = True, capacity: int = 16,
            max_spans: int = 6, journal_capacity: int = 6):
    clock = _Clock()
    tracer = module.Tracer(enabled=enabled, capacity=capacity,
                           max_spans=max_spans,
                           journal_capacity=journal_capacity,
                           clock_ns=clock.clock_ns, wall=clock.wall)
    ended = []
    for step in steps:
        op = step[0]
        if op == "begin":
            tracer.begin("tick", step[1])
            clock.advance(10_000)
        elif op == "span":
            _, name, dur, attrs = step
            with tracer.span(name, **attrs):
                clock.advance(dur)
        elif op == "mark":
            _, name, dur, attrs = step
            mark = tracer.mark()
            clock.advance(dur)
            tracer.add_span(name, mark, **attrs)
        elif op == "aux":
            _, dur, device, explicit = step
            start = tracer.clock_ns()
            clock.advance(dur)
            if explicit:
                tracer.aux_span("sample", start, dur, device=device)
            else:
                tracer.aux_span("sample", start, device=device)
        elif op == "event":
            _, kind, detail, attrs = step
            tracer.event(kind, detail, **attrs)
        elif op == "breaker":
            _, name, old, new, error = step
            tracer.breaker_listener(_Breaker(name, error), old, new)
        elif op == "end":
            _, dur, meta = step
            clock.advance(dur)
            ended.append(tracer.end(**meta))
    return tracer, ended


def _reads(tracer) -> dict:
    return {
        "ticks_summary": tracer.ticks_summary(),
        "chrome_trace": {str(last): tracer.chrome_trace(last)
                         for last in (None, 1, 5)},
        "events": {since: tracer.events(since) for since in (0, 1, 3, 100)},
        "phase_quantiles": tracer.phase_quantiles(),
        "slowest_tick": tracer.slowest_tick(),
        "traces": [tuple(t) for t in tracer.traces()],
        "traces_last_3": [tuple(t) for t in tracer.traces(3)],
        "spans_per_trace": tracer.spans_per_trace(),
        "current_seq": tracer.current_seq,
        "dropped_spans_total": tracer.dropped_spans_total,
    }


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_read_side_equals_the_reference(seed):
    steps = _script(seed)
    ref, ref_ended = _replay(ref_tracing, steps)
    port, port_ended = _replay(port_tracing, steps)
    assert [t and tuple(t) for t in port_ended] == \
        [t and tuple(t) for t in ref_ended]
    got, want = _reads(port), _reads(ref)
    assert got == want
    # The script reaches what it is for: dropped spans, a full journal
    # ring, a wrapped trace ring, blame rows.
    assert got["dropped_spans_total"] > 0
    assert got["events"][0]["last_id"] > 6 == len(got["events"][0]["events"])
    assert got["ticks_summary"]["ticks_recorded"] == 16
    assert any("blame" in row for row in got["ticks_summary"]["slowest"])


def test_disabled_recorder_equals_the_reference():
    steps = _script(5)
    ref, _ = _replay(ref_tracing, steps, enabled=False)
    port, ended = _replay(port_tracing, steps, enabled=False)
    assert ended == [None] * len(ended)
    assert _reads(port) == _reads(ref)
    assert port.ticks_summary()["enabled"] is False
    assert port.events()["events"] == []
    # Spans outside an open trace are the shared no-op.
    assert port.span("x") is port.span("y")


def test_wedged_tick_quantile_stays_finite():
    """A rank in the overflow bucket reports the observed max, so
    /debug/ticks stays valid JSON after a > 1 s tick."""
    steps = [("begin", 1), ("mark", "fetch", 3_000_000_000, {}),
             ("end", 1_000, {})]
    ref, _ = _replay(ref_tracing, steps)
    port, _ = _replay(port_tracing, steps)
    assert port.ticks_summary() == ref.ticks_summary()
    assert port.ticks_summary()["phases"]["fetch"]["p99_ms"] == 3000.0


def _breaker_events(module, resilience, seed: int) -> tuple:
    """One breaker of each package on a fake clock, its transitions
    journalled, driven by the seed's outcome sequence."""
    now = [0.0]
    tracer = module.Tracer(clock_ns=lambda: int(now[0] * 1e9),
                           wall=lambda: 1_700_000_000.0 + now[0])
    breaker = resilience.CircuitBreaker(
        "kubelet", failure_threshold=2, recovery_time=5.0,
        clock=lambda: now[0])
    breaker.on_transition = tracer.breaker_listener
    rng = np.random.default_rng(seed)
    admitted = []
    for step in range(60):
        now[0] += float(rng.integers(0, 4))
        tracer.begin("tick", step)
        if breaker.allow():
            admitted.append(step)
            if rng.random() < 0.6:
                breaker.record_failure(
                    OSError(f"connect failed\n(step {step})"))
            else:
                breaker.record_success()
        tracer.end()
    return tracer.events(), admitted, breaker.trips_total, breaker.state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breaker_transitions_journal_like_the_reference(seed):
    got = _breaker_events(port_tracing, port_resilience, seed)
    want = _breaker_events(ref_tracing, ref_resilience, seed)
    assert got == want
    kinds = {(e["attrs"]["state"]) for e in got[0]["events"]}
    assert {"open", "half_open", "closed"} <= kinds


def test_a_failing_hook_does_not_break_the_edge():
    breaker = port_resilience.CircuitBreaker("x", failure_threshold=1)

    def hook(*_):
        raise RuntimeError("observer bug")

    breaker.on_transition = hook
    breaker.record_failure("down")
    assert breaker.state == port_resilience.OPEN
