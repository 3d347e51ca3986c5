"""Profile the poll-tick hot path of the NVML daemon.

The port's counterpart of the reference's ``tools/profiler.py`` (``make
profile-tick``): runs the production stack — ``NvmlCollector`` over
``testing.fake_nvml`` (an 8-card H100 node, 18 NVLink links a card
carrying traffic, GPM on) and the production ``PollLoop`` (pipelined, the
daemon's default) — for N ticks under cProfile and prints the top-K
functions by cumulative time. The bench says *that* a tick moved; this
says *where*.

Defaults favor localization over realism: no scripted NVML stall
(``--stall-ms`` adds one to every card's memory read), so exporter CPU
dominates the report instead of time.sleep.

cProfile instruments only the calling thread, which is the tick's
orchestration: the wait on the read round, sample assembly, the tick-state
fold and the snapshot build. The per-card NVML reads run on the loop's
pool and are invisible here (``trace_dump --blocking`` shows them as
``env_read`` spans).

Run: ``python -m kube_gpu_stats_tpu_torch.tools.profile_tick --ticks 200
--top 20``. No torch is imported.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys

from ..collectors.nvml import NvmlCollector
from ..poll import PollLoop
from ..registry import Registry
from ..testing.fake_nvml import FakeDevice, FakeNvml
from ..tracing import Tracer

NVLINK_LINKS = 18  # an H100 SXM card's NVLink count
NVLINK_KIB_PER_S = 4.0e6


def fake_node(cards: int, stall_ms: float = 0.0) -> FakeNvml:
    """An H100 node of ``cards`` busy cards, each with its NVLink links
    moving traffic and GPM supported."""
    devices = []
    for i in range(cards):
        dev = FakeDevice(
            uuid=f"GPU-{i:08x}-0000-0000-0000-000000000000", minor=i,
            gpu_util=90, mem_util=40, memory_used=40 * 1024**3,
            power_mw=600_000, temperature=60, energy_mj=1_000_000 * i,
            nvlink_kib={link: (0, 0) for link in range(NVLINK_LINKS)},
            gpm_supported=True, tensor_util=55.0, dram_bw_util=35.0)
        dev.set_nvlink_rate({link: NVLINK_KIB_PER_S
                             for link in range(NVLINK_LINKS)})
        if stall_ms:
            dev.stalls["memory"] = (stall_ms / 1000.0, 1)
        devices.append(dev)
    return FakeNvml(devices)


def tick_harness(cards: int, *, stall_ms: float = 0.0,
                 pipeline_fetch: bool = True,
                 tracer: Tracer | None = None
                 ) -> tuple[PollLoop, NvmlCollector]:
    """The daemon's poll loop over the NVML collector on a fake node."""
    collector = NvmlCollector(fake_node(cards, stall_ms))
    loop = PollLoop(collector, Registry(), deadline=10.0,
                    pipeline_fetch=pipeline_fetch, tracer=tracer)
    return loop, collector


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m kube_gpu_stats_tpu_torch.tools.profile_tick",
        description=__doc__.split("\n\n", 1)[0])
    parser.add_argument("--ticks", type=int, default=200,
                        help="profiled ticks (default 200)")
    parser.add_argument("--warmup", type=int, default=10,
                        help="unprofiled warmup ticks: plans compile, "
                             "rate baselines fill (default 10)")
    parser.add_argument("--cards", type=int, default=8)
    parser.add_argument("--top", type=int, default=20,
                        help="rows in the report (default 20)")
    parser.add_argument("--stall-ms", type=float, default=0.0,
                        help="scripted stall of every card's memory read "
                             "(default 0: pure exporter CPU)")
    parser.add_argument("--sort", default="cumulative",
                        choices=("cumulative", "tottime"),
                        help="pstats sort key (default cumulative)")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    loop, collector = tick_harness(args.cards, stall_ms=args.stall_ms)
    try:
        for _ in range(args.warmup):
            loop.tick()
            loop.settle(5.0)
        profile = cProfile.Profile()
        for _ in range(args.ticks):
            # The inter-tick idle (the reads of the next round finishing
            # on the pool) stays out of the profile, as the daemon's
            # interval keeps it out of the tick.
            profile.enable()
            loop.tick()
            profile.disable()
            loop.settle(5.0)
    finally:
        loop.stop()
        collector.close()

    out = io.StringIO()
    stats = pstats.Stats(profile, stream=out)
    stats.sort_stats(args.sort).print_stats(args.top)
    print(f"# profile-tick: {args.ticks} ticks x {args.cards} cards, "
          f"stall={args.stall_ms:g} ms")
    print(f"# last_tick_stats: {loop.last_tick_stats}")
    print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
