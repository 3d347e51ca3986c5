"""Where the DaemonSet exporter's sampling round goes on card 0, read off
its own flight recorder.

    python -m kube_gpu_stats_tpu_torch.testing.tick_probe [--seconds 12]

Each row starts the exporter over NVML at 10 Hz (its recorder's ring of
128 ticks then spans 12.8 s) and, after ``--seconds``, reads every
recorded tick from ``/debug/trace``: the tick's sampling round
(``env_round``; a blocking round is cut at the 50 ms deadline, a
pipelined one only assembles the last completed reads) and the card's
``env_read`` spans (the NVML reads on the sampler pool; a read that
outlives its tick lands in a later one with its whole duration), then
the journal's ``pipeline_fence``/``pipeline_resume`` events and the
exporter's ``deadline``/``stuck`` counts. Rows:

- ``idle``: no burn, read 1 s in (its first ticks hold the cold reads)
  and again at the end;
- ``burn``: the ``cuda`` burn on card 0 in this process;
- ``burn, --no-pipeline-fetch``: the same with each tick joining its own
  reads (the blocking path, where a stalled read serves the card down);
- ``burn+scrape``: the burn and, in another thread, what the smoke's
  daemon phase does without pause (``duty_probe.load``): wait for the
  next tick, read NVML's energy counter, run ``nvidia-smi``;
- ``burn+scrape, no holders scan``: the same with the exporter's
  ``--device-processes off`` (no ``/proc`` scan for the cards' holders);
- ``calls``: no exporter, no burn: each NVML call of a sample, made in
  this process every 100 ms as a 10 Hz tick makes it, timed one by one;
  and ``read_burst`` (the instantaneous power field) every 10 ms, as the
  burst sampler makes it at 100 Hz.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per row.
"""

from __future__ import annotations

import argparse
import json
import signal
import statistics
import sys
import threading
import time
import urllib.request

import torch

from .. import schema, validate
from ..collectors.nvml import NvmlCollector
from ..loadgen import burn
from ..native import nvml as nvml_binding
from .duty_probe import SIZE, load, smi, start_daemon, ticks

INTERVAL_S = 0.1
DEADLINE_MS = 50.0


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.read()


def recorded(port: int) -> list[dict]:
    """Per recorded tick: seq, sampling round ms, whether it pipelined,
    its env_read spans' ms."""
    events = json.loads(_get(port, "/debug/trace?last=128"))["traceEvents"]
    rows: list[dict] = []
    for event in events:
        if event["cat"] == "tick":
            rows.append({"seq": event["args"]["seq"], "reads_ms": []})
        elif event["name"] == "env_round":
            rows[-1]["env_round_ms"] = event["dur"] / 1e3
            rows[-1]["pipelined"] = bool(event["args"].get("pipelined"))
        elif event["name"] == "env_read":
            rows[-1]["reads_ms"].append(event["dur"] / 1e3)
    return rows


def journal(port: int) -> dict:
    """The pipeline fence events the exporter journaled, and its deadline
    and stuck counts."""
    events = json.loads(_get(port, "/debug/events"))["events"]
    text = _get(port, "/metrics").decode()
    errors = {labels["reason"]: value for family, labels, value
              in validate.parse_exposition(text)
              if family == schema.SELF_POLL_ERRORS.name}
    return {"fence_events": [(e["kind"], e["tick_seq"]) for e in events
                             if e["kind"].startswith("pipeline_")],
            "deadline": errors.get("deadline", 0.0),
            "stuck": errors.get("stuck", 0.0)}


def summary(rows: list[dict]) -> dict:
    rounds = [r["env_round_ms"] for r in rows if "env_round_ms" in r]
    reads = [ms for r in rows for ms in r["reads_ms"]]
    late = [r for r in rows if r.get("env_round_ms", 0) >= DEADLINE_MS]
    return {"ticks": len(rows),
            "pipelined_ticks": sum(r.get("pipelined", False) for r in rows),
            "env_round_ms": {"p50": statistics.median(rounds),
                             "max": max(rounds)},
            "env_read_ms": {"p50": statistics.median(reads),
                            "max": max(reads),
                            "over_deadline": sum(ms >= DEADLINE_MS
                                                 for ms in reads)},
            "late_ticks": late,
            "longest_reads_ms": sorted(reads)[-5:]}


def one_row(name: str, seconds: float, extra: tuple, burning: bool,
            scraping: bool, nvml, handle: int) -> dict:
    proc, port = start_daemon(INTERVAL_S, extra)
    stop = threading.Event()
    worker = threading.Thread(target=load, args=(
        "scrape" if scraping else "quiet", stop, port, nvml, handle))
    try:
        deadline = time.monotonic() + 10
        while ticks(port) < 2:
            if time.monotonic() > deadline:
                raise RuntimeError("the daemon never ticked twice")
            time.sleep(0.02)
        row: dict = {"row": name}
        if not burning:
            time.sleep(1.0)
            row["first_ticks"] = recorded(port)[:3]
        worker.start()
        if burning:
            burn.run_burn(seconds=seconds, size=SIZE, report_every=1e9,
                          kernel="cuda", device="cuda:0")
        else:
            time.sleep(seconds)
        row.update(summary(recorded(port)))
        row.update(journal(port))
        return row
    finally:
        stop.set()
        if worker.is_alive():
            worker.join()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)


def call_times(seconds: float, nvml, handle: int) -> dict:
    """Per NVML call of a sample: median and max ms and the count of calls
    of 20 ms or more, over 10 Hz rounds for ``seconds``."""
    [(_, links)] = nvml.field_values(
        handle, [(nvml_binding.NVML_FI_DEV_NVLINK_LINK_COUNT, 0)])
    link_fields = [(field, link) for link in range(int(links or 0))
                   for field in (nvml_binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                                 nvml_binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX)]
    calls = {"utilization": lambda: nvml.utilization(handle),
             "memory": lambda: nvml.memory(handle),
             "power_mw": lambda: nvml.power_mw(handle),
             "temperature": lambda: nvml.temperature(handle),
             f"field_values({len(link_fields)} NVLink fields)":
                 lambda: nvml.field_values(handle, link_fields)}
    times: dict[str, list[float]] = {name: [] for name in calls}
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        for name, call in calls.items():
            t0 = time.perf_counter()
            call()
            times[name].append((time.perf_counter() - t0) * 1e3)
        time.sleep(INTERVAL_S)
    return {name: {"rounds": len(ms), "p50_ms": statistics.median(ms),
                   "max_ms": max(ms), "at_least_20ms": sum(t >= 20 for t in ms)}
            for name, ms in times.items()}


def read_burst_times(seconds: float, uuid: str) -> dict:
    """``NvmlCollector.read_burst`` on the card, every 10 ms for
    ``seconds`` (the burst sampler's 100 Hz), timed one by one: median,
    p99 and max ms, and the share of reads of 20 ms or more."""
    collector = NvmlCollector()
    try:
        (dev,) = [d for d in collector.discover() if d.uuid == uuid]
        ms: list[float] = []
        answered = None
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            t0 = time.perf_counter()
            answered = collector.read_burst(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            time.sleep(0.01)
        state = collector.burst_state.get(dev.device_id)
    finally:
        collector.close()
    ms.sort()
    slow = sum(t >= 20 for t in ms)
    return {"calls": len(ms), "p50_ms": statistics.median(ms),
            "p99_ms": ms[int(0.99 * (len(ms) - 1))], "max_ms": ms[-1],
            "at_least_20ms": slow, "share_at_least_20ms": slow / len(ms),
            "last_watts": answered, "refused": state}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=12.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the probe burns card 0: CUDA is not available")
    print(smi("name,power.limit").splitlines()[0], flush=True)
    nvml = nvml_binding.Nvml()
    nvml.init()
    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    handle = next(h for h in (nvml.handle(i)
                              for i in range(nvml.device_count()))
                  if nvml.uuid(h) == uuid)
    try:
        # Build the kernel and warm the allocator before the first row.
        burn.run_burn(seconds=1.0, size=SIZE, report_every=1e9,
                      kernel="cuda", device="cuda:0")
        for name, extra, burning, scraping in (
                ("idle", (), False, False),
                ("burn", (), True, False),
                ("burn, --no-pipeline-fetch", ("--no-pipeline-fetch",),
                 True, False),
                ("burn+scrape", (), True, True),
                ("burn+scrape, no holders scan",
                 ("--device-processes", "off"), True, True)):
            print(json.dumps(one_row(name, args.seconds, extra, burning,
                                     scraping, nvml, handle)), flush=True)
        calls = call_times(args.seconds, nvml, handle)
        calls["read_burst (100 Hz)"] = read_burst_times(args.seconds, uuid)
        print(json.dumps({"row": "calls", **calls}), flush=True)
    finally:
        nvml.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
