"""In-process statistical profiler behind ``/debug/profile``.

The port's copy of the reference's sampler. It samples every thread's
stack through ``sys._current_frames()`` on a fixed interval and
aggregates identical stacks into folded-stack text (``thread;caller;callee
count`` per line), which ``flamegraph.pl`` and speedscope read. Pure
stdlib: no signal handlers, and no cost to the profiled threads beyond the
interpreter-lock wakeups of the sampling thread.

``profile_ingest`` is the other profiler here: a cProfile of the hub's
delta apply path under a synthesized wave of pushers.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter


def _frame_id(frame) -> str:
    code = frame.f_code
    filename = code.co_filename.rsplit("/", 1)[-1]
    # co_firstlineno, not f_lineno: the aggregation key must be stable
    # across samples or every loop iteration becomes its own stack.
    return f"{code.co_name} ({filename}:{code.co_firstlineno})"


def sample_stacks(seconds: float, interval: float = 0.010) -> Counter:
    """Counter of folded stacks over the window. The sampler's own thread
    is left out (it would otherwise dominate with its sleep frame)."""
    counts: Counter = Counter()
    own = threading.get_ident()
    names = {t.ident: t.name for t in threading.enumerate()}
    deadline = time.monotonic() + seconds
    iteration = 0
    while time.monotonic() < deadline:
        iteration += 1
        for ident, frame in sys._current_frames().items():
            if ident == own:
                continue
            stack = []
            f = frame
            while f is not None:
                stack.append(_frame_id(f))
                f = f.f_back
            thread_name = names.get(ident) or str(ident)
            counts[";".join([thread_name, *reversed(stack)])] += 1
        if iteration % 50 == 0:
            # Refresh names now and then: new threads get named without
            # paying an enumerate() per sample.
            names = {t.ident: t.name for t in threading.enumerate()}
        time.sleep(interval)
    return counts


def render_folded(counts: Counter) -> str:
    """Folded-stack text, hottest first."""
    return "".join(
        f"{stack} {count}\n"
        for stack, count in counts.most_common()
    )


def profile_ingest(sources: int = 1000, waves: int = 5,
                   native: bool = True, sort: str = "cumulative",
                   top: int = 20) -> tuple[str, dict]:
    """cProfile of the hub's handler-thread delta apply path: seed
    ``sources`` synthesized push sessions, let one refresh build the merge
    plans (so the steady state is what gets profiled, not the one-off
    builds), then profile ``waves`` full waves of per-source delta frames
    through ``DeltaIngest.handle``. The bench says that ingest moved; this
    says where (decode, session validation, slot patch, fold updates).

    ``native`` is kept for the reference's signature: the port has no
    native ingest, so the Python per-slot path runs either way and the
    summary's ``path`` says ``"python"``.

    Returns (pstats report text, summary dict)."""
    import cProfile
    import io
    import pstats
    import time as time_mod

    from .bench import build_pusher_body
    from .delta import encode_delta, encode_full
    from .hub import Hub
    from .validate import parse_exposition_interned

    del native  # one path in the port
    hub = Hub([], targets_provider=lambda: [], interval=10.0)
    try:
        names = [f"http://node-{i:05d}:9400/metrics"
                 for i in range(sources)]
        bodies = [build_pusher_body(i) for i in range(sources)]
        probe = parse_exposition_interned(bodies[0])
        churn_slots = sorted(
            slot for slot, (name, _labels, _value) in enumerate(probe)
            if name in ("accelerator_duty_cycle",
                        "accelerator_power_watts"))
        for i, source in enumerate(names):
            code, _resp, _hdrs = hub.delta.handle(
                encode_full(source, i + 1, 1, bodies[i]))
            assert code == 200, code
        hub.refresh_once()  # build the merge plans

        def wave_wires(seq: int, offset: float) -> list[bytes]:
            return [encode_delta(source, i + 1, seq,
                                 [(churn_slots[0], 50.0 + offset + i * 1e-3),
                                  (churn_slots[1], 300.0 + offset)])
                    for i, source in enumerate(names)]

        # One unprofiled warm-up wave: the first delta per entry pays
        # one-off costs that would otherwise dominate the report. The
        # handle() call stays outside the assert, so that under python -O
        # the warm-up still runs.
        for wire in wave_wires(2, 0.0):
            code, _resp, _hdrs = hub.delta.handle(wire)
            assert code == 200, code
        # Encode every profiled wave up front: encoding is the pushing
        # node's cost, not the hub's.
        prepared = [wave_wires(3 + wave, 1.0 + wave)
                    for wave in range(waves)]
        handle = hub.delta.handle
        profile = cProfile.Profile()
        start = time_mod.monotonic()
        profile.enable()
        for wave in prepared:
            for wire in wave:
                handle(wire)
        profile.disable()
        wall = time_mod.monotonic() - start
        summary = {
            "sources": sources,
            "waves": waves,
            "path": "python",
            "lanes": hub.delta.lanes,
            "ms_per_wave": round(wall * 1000.0 / max(1, waves), 2),
            "ingest": hub.delta.stats(),
        }
    finally:
        hub.stop()
    out = io.StringIO()
    pstats.Stats(profile, stream=out).sort_stats(sort).print_stats(top)
    return out.getvalue(), summary
