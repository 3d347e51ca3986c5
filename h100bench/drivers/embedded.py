"""``embedded-1card``: the program's ``embedded.EmbeddedExporter`` at its
defaults inside the training process, the burn's step hook feeding it, and
the scrape fan-in from a child process of its own.

The window is one call of the program's ``run_burn`` for ``seconds``;
``steps_per_s`` counts the steps the card ran in it. After the window the
exporter's served steps, FLOPs and memory are held to what the job reported
and holds, and the reference judges the sampled steps.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from h100bench.core import card, common, expo
from h100bench.core.burnjob import BurnJob
from h100bench.reference import burn_step


# The job and the exporter share this process, which asks torch itself.
check_card = card.check


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        tmpdir: str) -> dict:
    from kube_gpu_stats_tpu_torch import embedded
    from kube_gpu_stats_tpu_torch.loadgen import burn

    dev = torch.device(device)
    # The program's own device choice on the card (every visible card);
    # the CPU only where a test asks for it.
    program_device = None if dev.type == "cuda" else device
    size = cell.traffic["job"]["size"]
    labels = cell.config["card_labels"]
    common.mark("program imported")
    exporter = embedded.EmbeddedExporter(port=0, device=program_device,
                                         **cell.config["exporter"])
    common.mark("exporter built")
    exporter.start()
    common.mark("exporter started")
    fanin = None
    try:
        url = f"http://127.0.0.1:{exporter.port}/metrics"
        fanin = common.ScrapeFanIn(url, cell.traffic, seed, labels)
        job = BurnJob(size, seed, dev)
        common.mark("inputs made")
        job.warm(profiler=trace)
        common.mark("job warmed")
        # Two published ticks, so the window opens on a rendered body.
        common.wait_ticks(url, 0.0)
        common.mark("exporter ticked")
        t0 = common.after_tick(url)
        if trace:
            mid = t0 + seconds / 2
            job.profile_window = (mid - 0.5, mid + 0.5)
        fanin.go(t0, seconds)
        hooked = {"steps": 0}

        def hook(n, seconds=None, flops=None):
            hooked["steps"] += n
            exporter.record_step(n, seconds=seconds, flops=flops)

        time.sleep(max(0.0, t0 - time.monotonic()))
        with job.installed(), contextlib.redirect_stdout(sys.stderr):
            burn.run_burn(seconds, size, kernel="cuda", step_hook=hook,
                          device=program_device)
        t1 = time.monotonic()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        scrapes, scraper_held = fanin.result(timeout=seconds + 60)
        inside = common.window_scrapes(scrapes, t0, seconds)
        # Served totals from a tick that started after the window closed:
        # two past the count published now. The window's last scrape can
        # lie many seconds before its end.
        published = expo.total(common.scrape(url),
                               common.KEEP["poll_count"][0]) or 0.0
        served = common.wait_ticks(url, published)
        checks = served_checks(served, labels, hooked["steps"], size,
                               job.live_bytes() if dev.type == "cuda" else None,
                               cell.config["limits"])
        trace_path = f"{tmpdir}/trace.json"
        if not (trace and job.export_trace(trace_path)):
            trace_path = None
    finally:
        if fanin is not None:
            fanin.close()
        exporter.stop()
    gaps = burn_step.step_gaps([(x, job.w, out) for x, out, _ in job.samples])
    job.release()
    checks["step_gap"] = [max(gaps), cell.config["limits"]["step_gap"]]
    return {"t0": t0, "t1": t1, "steps": job.calls, "size": size,
            "scrapes": inside, "memory_peak_bytes": peak, "checks": checks,
            "trace_path": trace_path,
            "forbidden": {"scraper child": scraper_held}}


def served_checks(samples, labels: dict, hooked_steps: int, size: int,
                  live_bytes: int | None, limits: dict) -> dict:
    """What the exporter serves after the window against the steps the job
    reported through the hook, the FLOPs those steps take (2 * size^3 each)
    and, on the card, the bytes the job holds there."""
    steps = expo.total(samples, "accelerator_workload_steps_total", labels)
    flops = expo.total(samples, "accelerator_workload_flops_total", labels)
    checks = {
        "steps_off": [abs((steps or 0.0) - hooked_steps), limits["steps_off"]],
        "flops_off": [abs((flops or 0.0) - 2 * size ** 3 * hooked_steps),
                      limits["flops_off"]],
    }
    if live_bytes is not None:
        used = expo.total(samples, "accelerator_memory_used_bytes", labels)
        checks["memory_off"] = [abs((used or 0.0) - live_bytes),
                                limits["memory_off"]]
    return checks
