"""``daemon-nvml-1card``: the program's DaemonSet entry,
``python -m kube_gpu_stats_tpu_torch --backend nvml`` at its defaults, as a
child process on a port of its own (started through
``core/daemon_child.py``, which reports the modules it held on its way
out), beside the monitored job in another child (``core/burn_child.py``),
with the scrape fan-in from a third.

The window is the job's ``run_burn`` call; ``steps_per_s`` counts the steps
the card ran in it. A quarter into the window, the daemon's served memory,
duty cycle and power of the card are held to ``nvidia-smi``'s readings of
the same moment. The daemon's figures from before the burn
started, held to the same readings, are what a daemon that never updated
its sample would serve: they are printed as the stale fault's readings.
"""

from __future__ import annotations

import json
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

from h100bench.core import card, common, expo

BURN_CHILD = Path(__file__).resolve().parents[1] / "core" / "burn_child.py"
READY_TIMEOUT_S = 240.0
# Where in the window the card's figures are compared: a quarter in, with
# the burn steady and before a traced run's profiled sub-window, whose
# end stalls the job while the profiler gathers its events.
FIGURES_AT = 0.25


def read_card() -> dict:
    """``nvidia-smi``'s memory used (MiB), utilization (%) and power (W)
    of card 0."""
    used, util, power = common.smi("memory.used,utilization.gpu,power.draw")
    return {"memory_mib": float(used), "duty": float(util),
            "power_w": float(power)}


def served_card(samples, labels: dict) -> dict:
    def value(family):
        return expo.total(samples, family, labels) or 0.0

    return {"memory_mib": value("accelerator_memory_used_bytes") / 2 ** 20,
            "duty": value("accelerator_duty_cycle"),
            "power_w": value("accelerator_power_watts")}


def figure_gaps(served: dict, smi: dict) -> dict:
    return {
        "memory_gap_mib": abs(served["memory_mib"] - smi["memory_mib"]),
        "duty_gap": abs(served["duty"] - smi["duty"]),
        "power_gap_pct": (100.0 * abs(served["power_w"] - smi["power_w"])
                          / smi["power_w"] if smi["power_w"] > 0 else 100.0),
    }


def start_daemon(args: list, log_path: str,
                 report_path: str) -> tuple[subprocess.Popen, int]:
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "h100bench.core.daemon_child", report_path,
         *args, "--listen-port", "0"], stdout=subprocess.DEVNULL, stderr=log,
        env=common.child_env(), cwd=common.ROOT)
    log.close()
    deadline = time.monotonic() + READY_TIMEOUT_S
    while time.monotonic() < deadline:
        found = re.search(r"listening on \S+:(\d+)", Path(log_path).read_text())
        if found:
            return proc, int(found[1])
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    stop(proc)
    raise RuntimeError("the daemon did not start:\n"
                       + Path(log_path).read_text()[-2000:])


def stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
    proc.wait()


def held(report_path: str) -> list[str]:
    """The forbidden modules the daemon reported on its way out; a daemon
    that wrote no report proves nothing, and counts as holding one."""
    try:
        return json.loads(Path(report_path).read_text())
    except (OSError, ValueError):
        return ["(no report from the daemon)"]


def _start_job() -> tuple[subprocess.Popen, dict]:
    """The job's child and what its torch sees of the cards. The child
    imports torch while the daemon starts and touches the card only once
    it has its job, after the idle reading."""
    child = subprocess.Popen(
        [sys.executable, str(BURN_CHILD)], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True, env=common.child_env(),
        cwd=common.ROOT)
    line = child.stdout.readline()
    if not line:
        common.end(child)
        raise RuntimeError(f"the burn child exited {child.returncode}")
    return child, json.loads(line)


# The job's child that check_card started, for run to take over: this
# process asks the child, not its own torch, so it never imports torch.
_started: list = []


def check_card(chips: int) -> str:
    child, seen = _start_job()
    try:
        name = card.judge(seen, chips)
    except card.NoCard:
        common.end(child)
        raise
    _started.append(child)
    return name


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        tmpdir: str) -> dict:
    size = cell.traffic["job"]["size"]
    labels = cell.config["card_labels"]
    limits = cell.config["limits"]
    burner = _started.pop() if _started else _start_job()[0]
    daemon = fanin = None
    report = f"{tmpdir}/daemon.modules.json"
    try:
        daemon, port = start_daemon(cell.config["daemon_args"],
                                    f"{tmpdir}/daemon.log", report)
        common.mark("daemon listening")
        url = f"http://127.0.0.1:{port}/metrics"
        fanin = common.ScrapeFanIn(url, cell.traffic, seed, labels)
        idle = served_card(common.wait_ticks(url, 0.0), labels)
        common.mark("daemon ticked")
        trace_path = f"{tmpdir}/trace.json"
        burner.stdin.write(json.dumps({
            "size": size, "seed": seed, "device": device, "trace": trace,
            "trace_path": trace_path, "start": common.START}) + "\n")
        burner.stdin.flush()
        if burner.stdout.readline().strip() != "ready":
            raise RuntimeError("the burn child did not come up")
        common.mark("job warmed")
        t0 = common.after_tick(url)
        mid = t0 + seconds / 2
        fanin.go(t0, seconds)
        burner.stdin.write(json.dumps({
            "t0": t0, "seconds": seconds,
            "profile_window": [mid - 0.5, mid + 0.5] if trace else None}) + "\n")
        burner.stdin.close()
        time.sleep(max(0.0, t0 + FIGURES_AT * seconds - time.monotonic()))
        served = served_card(common.scrape(url), labels)
        smi = read_card()
        lines = burner.stdout.read().strip().splitlines()
        if burner.wait(timeout=120) != 0 or not lines:
            raise RuntimeError(f"the burn child exited {burner.returncode}")
        job = json.loads(lines[-1])
        scrapes, scraper_held = fanin.result(timeout=seconds + 60)
        inside = common.window_scrapes(scrapes, t0, seconds)
    finally:
        if fanin is not None:
            fanin.close()
        common.end(burner)
        if daemon is not None:
            stop(daemon)
    forbidden = {"burn child": job["forbidden"], "daemon": held(report),
                 "scraper child": scraper_held}
    for name, value in figure_gaps(idle, smi).items():
        print(f"stale fault reading {name} {value!r}", file=sys.stderr)
    checks = {name: [value, limits[name]]
              for name, value in figure_gaps(served, smi).items()}
    checks["step_gap"] = [max(job["gaps"]), limits["step_gap"]]
    return {"t0": job["t0"], "t1": job["t1"], "steps": job["steps"],
            "size": size, "scrapes": inside,
            "memory_peak_bytes": job["memory_peak_bytes"], "checks": checks,
            "trace_path": trace_path if job["traced"] else None,
            "forbidden": forbidden}
