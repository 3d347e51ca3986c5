"""Readings the burn step's limit is set from: the program's widest gap to
the reference and the fp8 control's, on the same sampled steps.

    python h100bench/control.py --size 4096 --seeds 1,2,3 [--seconds 2]

For each seed, one process-wide set-up: the job's inputs from the seed, a
short window of the program's ``run_burn`` on them (the cell's own step and
size), then the reference's gap of each sampled step and the control's gap
on the same inputs. One JSON line per seed; the benchmark's runs do not run
this. On the CPU (``--device cpu``) the program's step is its plain
version; a test runs it there at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(size: int, seed: int, seconds: float, device: str) -> dict:
    import torch

    from h100bench.core.burnjob import BurnJob
    from h100bench.reference import burn_step
    from kube_gpu_stats_tpu_torch.loadgen import burn

    dev = torch.device(device)
    job = BurnJob(size, seed, dev)
    job.warm(profiler=False)
    with job.installed(), contextlib.redirect_stdout(sys.stderr):
        burn.run_burn(seconds, size, kernel="cuda",
                      device=None if dev.type == "cuda" else device)
    pairs = [(x, job.w, out) for x, out, _ in job.samples]
    program = burn_step.step_gaps(pairs)
    control = burn_step.control_gaps(pairs)
    job.release()
    return {"size": size, "seed": seed, "steps": job.calls,
            "program_gap": max(program), "control_gap": min(control)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.size, seed, args.seconds, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
