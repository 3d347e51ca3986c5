"""In-process statistical profiler behind ``/debug/profile``.

The port's copy of the reference's sampler. It samples every thread's
stack through ``sys._current_frames()`` on a fixed interval and
aggregates identical stacks into folded-stack text (``thread;caller;callee
count`` per line), which ``flamegraph.pl`` and speedscope read. Pure
stdlib: no signal handlers, and no cost to the profiled threads beyond the
interpreter-lock wakeups of the sampling thread.
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
