"""The ``cuda`` burn's duty cycle on card 0 under what else its process
does, with each batch boundary as the burn has it and as a full drain.

    python -m kube_gpu_stats_tpu_torch.testing.duty_probe [--seconds 7]

The burn bounds its queue at every 32nd step. ``queued`` is ``run_burn``
as it is: the boundary waits for the boundary before it, so the card
keeps a batch of work while the host comes back. ``drain`` swaps in a
wait for everything queued, which leaves the card idle from the end of
each batch until the host has queued the next step.

Beside the burn, in another thread of the same process:

- ``quiet``: nothing;
- ``scrape``: what the smoke's daemon phase does, without pause: wait
  for the DaemonSet exporter's next tick (scraping ``/metrics`` every
  20 ms, each scrape parsed), read NVML's energy counter, run
  ``nvidia-smi``;
- ``busy``: pure Python arithmetic that never waits.

NVML's ``utilization.gpu`` of the card is read every 0.5 s from 2 s into
each burn. Prints the card's ``nvidia-smi`` name and power limit, then
one JSON line per burn, ABBA over the two boundaries in each load.
"""

from __future__ import annotations

import argparse
import json
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import torch

from .. import schema, validate
from ..device import synchronize
from ..loadgen import burn
from ..native import nvml as nvml_binding

SIZE = 4096
SAMPLE_S = 0.5
SAMPLE_FROM_S = 2.0
TICKS = schema.SELF_POLL_DURATION.name + "_count"


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def start_daemon(interval: float = 0.5, extra: tuple = ()
                 ) -> tuple[subprocess.Popen, int]:
    """The DaemonSet exporter over NVML, ticking every ``interval`` s
    (2 Hz unless told), with ``extra`` flags."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "--backend",
         "nvml", "--listen-port", "0", "--interval", str(interval),
         "--attribution", "off", "--textfile-dir",
         tempfile.mkdtemp(prefix="kts-probe-"), *extra],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)
    for line in proc.stderr:
        match = re.search(r"listening on \S+:(\d+)", line)
        if match:
            # Keep reading its log so the pipe never fills.
            threading.Thread(target=proc.stderr.read, daemon=True).start()
            return proc, int(match.group(1))
    raise RuntimeError(f"the daemon exited {proc.wait()} before serving")


def ticks(port: int) -> float:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        text = resp.read().decode()
    return sum(value for family, _, value in validate.parse_exposition(text)
               if family == TICKS)


def load(mode: str, stop: threading.Event, port: int, nvml,
         handle: int) -> None:
    while not stop.is_set():
        if mode == "scrape":
            after = ticks(port)
            while ticks(port) <= after and not stop.is_set():
                time.sleep(0.02)
            nvml.energy_mj(handle)
            smi("utilization.gpu,memory.used,power.draw")
        elif mode == "busy":
            total = 0
            for i in range(200_000):
                total += i * i
        else:
            stop.wait(0.05)


def drain_mark(devices) -> list:
    """A boundary that waits for everything queued (no events)."""
    synchronize(devices)
    return []


def one_burn(boundary: str, mode: str, seconds: float, port: int, nvml,
             handle: int) -> dict:
    stop = threading.Event()
    utils: list[int] = []
    t0 = time.monotonic()

    def sample() -> None:
        while not stop.wait(SAMPLE_S):
            if SAMPLE_FROM_S < time.monotonic() - t0 < seconds - SAMPLE_S:
                utils.append(nvml.utilization(handle)[0])

    threads = [threading.Thread(target=load,
                                args=(mode, stop, port, nvml, handle)),
               threading.Thread(target=sample)]
    queued_mark = burn.mark
    burn.mark = drain_mark if boundary == "drain" else queued_mark
    try:
        for thread in threads:
            thread.start()
        result: dict = {}
        burn.run_burn(seconds=seconds, size=SIZE, report_every=1e9,
                      kernel="cuda", result=result, device="cuda:0")
    finally:
        burn.mark = queued_mark
        stop.set()
        for thread in threads:
            thread.join()
    return {"boundary": boundary, "load": mode, "utilization_gpu": utils,
            "min": min(utils), "mean": sum(utils) / len(utils),
            "steps_per_s": result["steps_per_s"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=7.0)
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
    proc, port = start_daemon()
    try:
        # Build the kernel and warm the allocator before the first row.
        burn.run_burn(seconds=1.0, size=SIZE, report_every=1e9,
                      kernel="cuda", device="cuda:0")
        for mode in ("quiet", "scrape", "busy"):
            for boundary in ("drain", "queued", "queued", "drain"):
                print(json.dumps(one_burn(boundary, mode, args.seconds, port,
                                          nvml, handle)), flush=True)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        nvml.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
