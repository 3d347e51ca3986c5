"""The smoke's ``burst`` phase conditions on card 0, held for minutes:
does a DaemonSet exporter die under them?

    python -m kube_gpu_stats_tpu_torch.testing.burst_soak [--seconds 300]
        [--continuous 2] [--lifetime S]

Starts exporters over NVML at 10 Hz under ``-X faulthandler``:
``--continuous`` of them with the burst sampler at ``--burst-mode
continuous`` (100 Hz), and one at ``auto`` armed through
``/debug/burst?arm=6`` every 7.5 s. Meanwhile, in
this process: the ``cuda`` burn at 4096 pulsed 100 ms on, 100 ms off;
``NvmlCollector.read_burst`` at 100 Hz in a fresh collector every 5 s;
each exporter's ``/metrics`` read every 30 ms (and ``/debug/trace`` and
``/debug/ticks`` every 200th read); ``nvidia-smi`` sampling the
instantaneous and average power every 50 ms. A wave of exporters ends
at the first one that exits. With ``--lifetime`` the exporters are
replaced by fresh ones every S seconds (a daemon's first seconds, when
it opens NVML and starts sampling, come round again and again), until
``--seconds`` have passed. Prints the card's ``nvidia-smi`` name and
power limit, one JSON line (waves, exporter lives, lives that ended in
an exit, seconds held, burn steps, reads that failed; without
``--lifetime`` each exporter's exit code or null), and the whole log of
each exporter that exited (a native abort leaves its Python stacks
there). Exits 1 if one did.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

from ..collectors.nvml import NvmlCollector
from ..loadgen import burn
from .duty_probe import SIZE, smi

INTERVAL_S = 0.1
BURST_HZ = 100.0
PULSE_MS = 100.0
ARM_S = 6
ARM_EVERY_S = 7.5
SCRAPE_GAP_S = 0.03
READ_BURST_ROUND_S = 5.0


class Exporter:
    """One exporter process and its whole log, read on a thread."""

    def __init__(self, mode: str) -> None:
        self.mode = mode
        self.log: list[str] = []
        self.proc = subprocess.Popen(
            [sys.executable, "-X", "faulthandler", "-m",
             "kube_gpu_stats_tpu_torch", "--backend", "nvml",
             "--listen-port", "0", "--interval", str(INTERVAL_S),
             "--attribution", "off", "--textfile-dir", "",
             "--burst-mode", mode, "--burst-hz", str(BURST_HZ)],
            stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)
        for line in self.proc.stderr:
            self.log.append(line.rstrip("\n"))
            match = re.search(r"listening on \S+:(\d+)", line)
            if match:
                self.port = int(match.group(1))
                break
        else:
            raise RuntimeError(f"exporter exited {self.proc.wait()}: "
                               f"{self.log[-20:]}")
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stderr:
            self.log.append(line.rstrip("\n"))

    def get(self, path: str) -> bytes:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=30) as resp:
            return resp.read()

    def stop(self) -> int | None:
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            return self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
            return None


def wave(seconds: float, continuous: int) -> dict:
    """One set of fresh exporters under the load for ``seconds``, or
    until one of them exits."""
    exporters = [Exporter(mode) for mode in
                 ["continuous"] * continuous + ["auto"]]
    stop = threading.Event()
    failed: list[str] = []

    def guarded(name: str, body) -> None:
        try:
            while not stop.is_set():
                body()
        except Exception as exc:  # noqa: BLE001 - reported in the row
            failed.append(f"{name}: {exc!r}")

    def watcher(exporter: Exporter):
        count = [0]

        def body() -> None:
            exporter.get("/metrics")
            count[0] += 1
            if count[0] % 200 == 0:
                exporter.get("/debug/trace?last=128")
                exporter.get("/debug/ticks")
            stop.wait(SCRAPE_GAP_S)
        return body

    def armer() -> None:
        exporters[-1].get(f"/debug/burst?arm={ARM_S}")
        stop.wait(ARM_EVERY_S)

    def reader() -> None:
        collector = NvmlCollector()
        try:
            (device, *_) = collector.discover()
            end = time.monotonic() + READ_BURST_ROUND_S
            while time.monotonic() < end and not stop.is_set():
                collector.read_burst(device)
                time.sleep(1.0 / BURST_HZ)
        finally:
            collector.close()

    bodies = [(f"scrape {e.mode} {e.port}", watcher(e)) for e in exporters]
    bodies += [("arm", armer), ("read_burst", reader)]
    threads = [threading.Thread(target=guarded, args=item, daemon=True)
               for item in bodies]
    smi_power = subprocess.Popen(
        ["nvidia-smi", "-i", "0",
         "--query-gpu=power.draw.instant,power.draw.average",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    for thread in threads:
        thread.start()
    t0 = time.monotonic()
    steps = 0
    try:
        while (time.monotonic() - t0 < seconds
               and all(e.proc.poll() is None for e in exporters)):
            steps += burn.run_burn(seconds=min(2.0, seconds), size=SIZE,
                                   report_every=1e9, kernel="cuda",
                                   pulse_ms=PULSE_MS, device="cuda:0")
    finally:
        held = time.monotonic() - t0
        stop.set()
        for thread in threads:
            thread.join(timeout=30)
        smi_power.terminate()
        smi_power.wait(timeout=30)
        exits = {f"{e.mode} {e.port}": e.proc.poll() for e in exporters}
        logs = {name: e.log for name, e in zip(exits, exporters)
                if exits[name] is not None}
        for exporter in exporters:
            exporter.stop()
        # A scrape that lost its exporter is that exit, not another fault.
        failed = [f for f in failed
                  if not any(name.split()[-1] in f for name in logs)]
    return {"seconds": held, "steps": steps, "exits": exits,
            "failed": failed, "logs": logs}


def soak(seconds: float, continuous: int, lifetime: float | None) -> dict:
    """Waves of fresh exporters, each living ``lifetime`` s (the whole
    soak when None), until ``seconds`` have passed."""
    t0 = time.monotonic()
    out: dict = {"waves": 0, "lives": 0, "exited": 0, "seconds": 0.0,
                 "steps": 0, "failed": [], "logs": {}}
    while (left := seconds - (time.monotonic() - t0)) > 0:
        row = wave(min(lifetime or left, left), continuous)
        out["waves"] += 1
        out["lives"] += len(row["exits"])
        out["exited"] += len(row["logs"])
        out["seconds"] += row["seconds"]
        out["steps"] += row["steps"]
        out["failed"] += row["failed"]
        out["logs"].update(row["logs"])
        if lifetime is None:
            out["exits"] = row["exits"]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=300.0)
    parser.add_argument("--continuous", type=int, default=2)
    parser.add_argument("--lifetime", type=float, default=None)
    args = parser.parse_args(argv)
    print(smi("name,power.limit"), flush=True)
    row = soak(args.seconds, args.continuous, args.lifetime)
    logs = row.pop("logs")
    print(json.dumps(row), flush=True)
    for name, lines in logs.items():
        print(f"--- exporter {name} exited; its log:", flush=True)
        print("\n".join(lines), flush=True)
    return 1 if logs or row["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
