"""Dump a Chrome trace of N poll ticks of the NVML daemon.

The port's counterpart of the reference's ``tools/trace_dump.py`` (``make
trace-tick``): the same harness as ``profile_tick`` (``NvmlCollector``
over ``testing.fake_nvml``, the production ``PollLoop``) with the flight
recorder's ring sized to hold every tick, then the Chrome trace-event
JSON written to ``--out``. Open it in ``chrome://tracing`` or Perfetto's
UI ("Open trace file") to see where tick time goes — the visual
companion to ``profile_tick``'s cProfile table. Pipelined (the default),
a tick's ``env_round`` only assembles the round read between ticks;
with ``--blocking`` each tick joins its own round and the per-card NVML
reads show inside it as ``env_read`` spans.

Run: ``python -m kube_gpu_stats_tpu_torch.tools.trace_dump --ticks 200
--out trace.json``. No torch is imported.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..tracing import Tracer
from .profile_tick import tick_harness


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m kube_gpu_stats_tpu_torch.tools.trace_dump",
        description="dump a Chrome trace of NVML daemon poll ticks")
    parser.add_argument("--ticks", type=int, default=200)
    parser.add_argument("--cards", type=int, default=8)
    parser.add_argument("--stall-ms", type=float, default=0.0,
                        help="scripted stall of every card's memory read "
                             "(0 = exporter CPU dominates, like "
                             "profile_tick)")
    parser.add_argument("--out", default="kts-trace.json")
    parser.add_argument("--blocking", action="store_true",
                        help="--no-pipeline-fetch: every tick joins its "
                             "own read round, so the reads show inside "
                             "the tick")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    tracer = Tracer(capacity=args.ticks + 8)
    loop, collector = tick_harness(args.cards, stall_ms=args.stall_ms,
                                   pipeline_fetch=not args.blocking,
                                   tracer=tracer)
    try:
        for _ in range(args.ticks):
            loop.tick()
            loop.settle(5.0)  # the inter-tick idle: the round finishes
    finally:
        loop.stop()
        collector.close()

    out = pathlib.Path(args.out)
    out.write_text(json.dumps(tracer.chrome_trace(), sort_keys=True))
    summary = tracer.ticks_summary()
    print(f"wrote {out} ({summary['ticks_recorded']} ticks, "
          f"{sum(p['count'] for p in summary['phases'].values())} spans; "
          f"dropped {summary['dropped_spans_total']})")
    print("open in chrome://tracing or https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
