"""Where the DaemonSet exporter's sampling round goes on card 0, read off
its own flight recorder.

    python -m kube_gpu_stats_tpu_torch.testing.tick_probe [--seconds 12]

Each row starts the exporter over NVML at 10 Hz (its recorder's ring of
128 ticks then spans 12.8 s) and, after ``--seconds``, reads every
recorded tick from ``/debug/trace``: the tick's sampling round
(``env_round``, cut at the 50 ms deadline) and the card's ``sample``
spans (the NVML reads on the sampler thread; a sample that outlives the
deadline lands in a later tick with its whole duration). Rows:

- ``idle``: no burn, read 1 s in (its first ticks hold the cold reads)
  and again at the end;
- ``burn``: the ``cuda`` burn on card 0 in this process;
- ``burn+scrape``: the burn and, in another thread, what the smoke's
  daemon phase does without pause (``duty_probe.load``): wait for the
  next tick, read NVML's energy counter, run ``nvidia-smi``;
- ``burn+scrape, no holders scan``: the same with the exporter's
  ``--device-processes off`` (no ``/proc`` scan for the cards' holders);
- ``calls``: no exporter, no burn: each NVML call of a sample, made in
  this process every 100 ms as a 10 Hz tick makes it, timed one by one.

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

from ..loadgen import burn
from ..native import nvml as nvml_binding
from .duty_probe import SIZE, load, smi, start_daemon, ticks

INTERVAL_S = 0.1
DEADLINE_MS = 50.0


def recorded(port: int) -> list[dict]:
    """Per recorded tick: seq, sampling round ms, its sample spans' ms."""
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/trace?last=128",
            timeout=10) as resp:
        events = json.loads(resp.read())["traceEvents"]
    rows: list[dict] = []
    for event in events:
        if event["cat"] == "tick":
            rows.append({"seq": event["args"]["seq"], "samples_ms": []})
        elif event["name"] == "env_round":
            rows[-1]["env_round_ms"] = event["dur"] / 1e3
        elif event["name"] == "sample":
            rows[-1]["samples_ms"].append(event["dur"] / 1e3)
    return rows


def summary(rows: list[dict]) -> dict:
    rounds = [r["env_round_ms"] for r in rows if "env_round_ms" in r]
    samples = [ms for r in rows for ms in r["samples_ms"]]
    late = [r for r in rows if r.get("env_round_ms", 0) >= DEADLINE_MS]
    return {"ticks": len(rows),
            "env_round_ms": {"p50": statistics.median(rounds),
                             "max": max(rounds)},
            "sample_ms": {"p50": statistics.median(samples),
                          "max": max(samples),
                          "over_deadline": sum(ms >= DEADLINE_MS
                                               for ms in samples)},
            "late_ticks": late,
            "longest_samples_ms": sorted(samples)[-5:]}


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
                ("burn+scrape", (), True, True),
                ("burn+scrape, no holders scan",
                 ("--device-processes", "off"), True, True)):
            print(json.dumps(one_row(name, args.seconds, extra, burning,
                                     scraping, nvml, handle)), flush=True)
        print(json.dumps({"row": "calls", **call_times(args.seconds, nvml,
                                                       handle)}), flush=True)
    finally:
        nvml.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
