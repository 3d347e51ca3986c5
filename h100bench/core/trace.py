"""Reduction of a profiler trace (Chrome trace JSON from ``torch.profiler``)
to the device's kernels, its busy time and its idle gaps.

The traced window runs from the first device operation's start to the last
one's end. Busy time is the union of the device operations' intervals;
an idle gap is a hole in that union, named by the host call (CUDA runtime
or CPU operation) that was running when the gap opened.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cuda_runtime", "cuda_driver", "cpu_op"})


@dataclass(frozen=True)
class Trace:
    ops: list  # (name, start_us, dur_us) of device operations, by start
    host: list  # (name, start_us, dur_us) of host calls, by start

    @property
    def window_us(self) -> float:
        if not self.ops:
            return 0.0
        return max(s + d for _, s, d in self.ops) - self.ops[0][1]

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, start, dur in self.ops:
            end = start + dur
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> list[tuple[float, float]]:
        spans = self.busy_intervals()
        return [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]

    def time_by_name(self, match=None) -> dict[str, float]:
        """Device microseconds by operation name (those ``match`` keeps)."""
        out: dict[str, float] = {}
        for name, _, dur in self.ops:
            if match is None or match(name):
                out[name] = out.get(name, 0.0) + dur
        return out

    def host_at(self, t: float) -> str:
        """The innermost host call running at ``t``."""
        best = None
        for name, start, dur in self.host:
            if start > t:
                break
            if start + dur >= t and (best is None or start >= best[1]):
                best = (name, start)
        return best[0] if best else "no host call traced"


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, host = [], []
    for event in events:
        if event.get("ph") != "X" or "dur" not in event:
            continue
        row = (event.get("name", "?"), float(event["ts"]), float(event["dur"]))
        cat = event.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append(row)
        elif cat in HOST_CATS:
            host.append(row)
    ops.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return Trace(ops=ops, host=host)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, in seconds, at most ``top`` of each."""
    ops = sorted(trace.time_by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[name[:200], us / 1e6] for name, us in ops],
        "idle_gaps": [[trace.host_at(a)[:200], (b - a) / 1e6] for a, b in gaps],
    }
