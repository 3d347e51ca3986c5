"""The monitored job in a process of its own, for deployments whose
exporter runs outside the job (the NVML DaemonSet).

    python h100bench/core/burn_child.py

Line protocol: the child writes what torch sees of the cards (JSON,
``core/card.describe``) before it touches any; the parent writes the job (JSON: ``size``, ``seed``,
``device``, ``trace``, ``trace_path``, ``start``: the parent's start on
time.monotonic) on stdin; the child makes its inputs,
warms up and writes ``ready``; the parent writes the window (JSON: ``t0``,
``seconds``, ``profile_window``); the child runs the program's ``run_burn``
from ``t0`` for ``seconds`` and, after the window, judges its sampled steps
against the reference and writes its result (JSON) as its last line.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    import torch

    from h100bench.core import card, common
    from h100bench.core.burnjob import BurnJob
    from h100bench.core.isolation import forbidden_modules
    from h100bench.reference import burn_step
    from kube_gpu_stats_tpu_torch.loadgen import burn

    print(json.dumps(card.describe()), flush=True)
    line = sys.stdin.readline()
    if not line:
        return 0  # the parent found no card to run on
    spec = json.loads(line)
    common.START = spec["start"]
    common.mark("burn child: job received")
    dev = torch.device(spec["device"])
    program_device = None if dev.type == "cuda" else spec["device"]
    job = BurnJob(spec["size"], spec["seed"], dev)
    common.mark("burn child: inputs made")
    job.warm(profiler=spec["trace"])
    print("ready", flush=True)
    window = json.loads(sys.stdin.readline())
    if window.get("profile_window"):
        job.profile_window = tuple(window["profile_window"])
    t0 = window["t0"]
    time.sleep(max(0.0, t0 - time.monotonic()))
    with job.installed(), contextlib.redirect_stdout(sys.stderr):
        burn.run_burn(window["seconds"], spec["size"], kernel="cuda",
                      device=program_device)
    t1 = time.monotonic()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = bool(spec["trace"]) and job.export_trace(spec["trace_path"])
    gaps = burn_step.step_gaps([(x, job.w, out) for x, out, _ in job.samples])
    print(json.dumps({"t0": t0, "t1": t1, "steps": job.calls,
                      "memory_peak_bytes": peak, "gaps": gaps,
                      "traced": traced, "forbidden": forbidden_modules()}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
