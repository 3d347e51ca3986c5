#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``kube_gpu_stats_tpu_torch``).

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

Phases, each raising on failure (so the script exits non-zero and never
prints its result line after one):

1. the card: ``nvidia-smi`` name and power limit, capability; TF32 off;
2. build the tiled GEMM kernel from ``csrc/`` (nvcc, first use) and print
   what ptxas reports for it: registers, shared memory, spills, warnings;
3. hold the kernel against its plain version at small shapes, at the
   shapes that reach the edges of its design (K shorter than the ring, a
   partial last wave, the 128-wide instance, several tiles per block, two
   launches back to back) and at every shape the main path gives it (up to
   8192^3); hold the Python mirror of its plan against the kernel's own;
   check its ValueError/TypeError contract;
4. the main path at full width: ``run_burn`` at size 4096 through the
   kernel and through the torch chain (the card's SM clock and power draw
   sampled meanwhile), then the size sweep up to 8192,
   with the launch counter set to 0 before and read after, then the
   per-card burn step against its plain version;
5. trace 100 steps of the ``cuda`` burn at size 4096 with torch.profiler:
   device time per step by kernel, and the device's busy share;
6. ``entry()`` once on the card;
7. the embedded exporter: ``python -m kube_gpu_stats_tpu_torch.loadgen
   --kernel cuda --size 4096 --embedded-port 0`` as a subprocess, its
   ``/metrics`` scraped while it burns (per-card steps, MFU, peak FLOPs,
   memory) and its ``/healthz``; then the same burn in this process under
   ``embedded.start(0)`` with ``step_hook=exporter.record_step`` (launch
   counter set to 0 before, read after), its exported counters held
   against the burn's own, and the burn without the exporter beside it;
8. the DaemonSet exporter: ``python -m kube_gpu_stats_tpu_torch
   --backend nvml --listen-port 0 --interval 0.5 --attribution off
   --textfile-dir <tmp>`` as a subprocess, scraped once while the card
   idles and three times during the ``cuda`` burn on card 0 in this
   process (launch counter set to 0 before, read after), each scrape
   held against ``nvidia-smi`` and NVML's energy counter read beside it:
   one ``accelerator_up 1`` per card with the same UUIDs, duty cycle,
   memory, power, temperature, energy, this process among the card's
   holders; the textfile, ``/healthz``, exit 0 on SIGTERM; then the tick,
   render and scrape costs and the median time of each bound NVML call;
9. time the kernel, its plain version and one library call
   (``torch.mm`` with f32 out) at the main path's and the sweep's sizes,
   each as the median of batches of back-to-back calls;
10. one JSON line describing every kernel of the path; last, the ``ok``
    line with the device.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import collections
import json
import math
import os
import pathlib
import queue
import re
import signal
import stat
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import torch

from kube_gpu_stats_tpu_torch import _build, config, daemon, embedded, schema
from kube_gpu_stats_tpu_torch.kinds import _kind_lookup, _kind_peak_flops
from kube_gpu_stats_tpu_torch.entry import entry
from kube_gpu_stats_tpu_torch.loadgen import tiled_burn
from kube_gpu_stats_tpu_torch.loadgen.burn import (make_all_device_burn,
                                                   run_burn, sweep_burn)
from kube_gpu_stats_tpu_torch.loadgen.tiled_burn import (
    tiled_all_device_burn, tiled_matmul, tiled_matmul_reference)
from kube_gpu_stats_tpu_torch.native import nvml as nvml_binding

MAIN_SIZE = 4096
SWEEP_SIZES = (1024, 2048, 4096, 8192)
BURN_SECONDS = 5.0
SWEEP_SECONDS = 3.0
TORCH_DEPTH = 16
# Kernel vs plain version: both sum exact bf16 products in f32 and differ
# only in the order of the sums.
REL_TOL = 1e-4
# Burn step vs its plain version: one bf16 ulp of a tanh output in [0.5, 1)
# is 2**-8; a product that rounds across a bf16 edge moves the output by one.
STEP_ATOL = 1e-2
# Timing: each batch replays one captured call back to back for at least
# BATCH_MS, so neither launch gaps nor the host's own time per call count;
# the median over TIMING_BATCHES batches, with their min and max.
BATCH_MS = 10.0
TIMING_BATCHES = 7
TIMING_WARMUP = 3
TRACE_STEPS = 100
SAMPLE_MS = 200
# Device memory rate per card (NVIDIA H100 datasheet), for the bound; the
# peak FLOP/s comes from the port's own device-kind table.
HBM_BYTES_PER_S = (("h100 nvl", 3.9e12), ("h100 pcie", 2.0e12),
                   ("h100", 3.35e12))
# The embedded phase: the CLI's burn length, the wait between its scrapes
# (the poll loop ticks at 1 Hz), and how long the CLI may take to come up.
EMBEDDED_SECONDS = 8.0
SCRAPE_GAP_S = 1.5
CLI_START_S = 180.0
# MFU may read a little over 100 where a tick window's FLOPs land late.
MFU_MAX = 105.0
# The daemon phase: its poll interval, the burn it watches (its three
# scrapes come 1.5 s apart, each on a fresh tick, from 3 s into the burn,
# once NVML's one-second power average has left the ramp), the checks'
# limits, the NVML calls timed, and the collection budget the tick is held
# against (BASELINE.md).
DAEMON_INTERVAL_S = 0.5
DAEMON_BURN_S = 8.0
DAEMON_SCRAPE_START_S = 3.0
DAEMON_SCRAPE_GAP_S = 1.5
DAEMON_SCRAPES = 3
DUTY_MIN = 90.0
POWER_TOL = 0.15
ENERGY_TOL = 0.15
NVML_CALLS = 200
TICK_BUDGET_MS = 50.0
MIB = 1024**2
ROOT = pathlib.Path(__file__).resolve().parent
KERNEL_NAME = "tiled_gemm_bf16_f32"
KERNEL_SOURCE = "kube_gpu_stats_tpu_torch/csrc/tiled_gemm.cu"
KERNEL_REPLACES = "kube_gpu_stats_tpu/loadgen/pallas_burn.py:46"
KERNEL_DESIGN = ("wgmma m64n256k16 / m64n128k16 + TMA, 4- or 6-stage mbarrier"
                 " ring, warp-specialised, persistent grouped tiles")


def require(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def emit(tag: str, payload) -> None:
    print(json.dumps({tag: payload}), flush=True)


def randn_bf16(shape, seed: int) -> torch.Tensor:
    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _batch_ms(run, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_ms(fn) -> dict:
    """Device time of one call of ``fn``: a CUDA graph of one call, replayed
    back to back in TIMING_BATCHES batches of at least BATCH_MS, one event
    pair around each batch. Returns the median, min and max per call, and
    the calls per batch. ``eager_ms`` is the same over eager calls, where
    the host's time per call shows whenever it exceeds the device's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(TIMING_WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    calls = max(1, math.ceil(BATCH_MS / _batch_ms(graph.replay, 1)))
    per_call = [_batch_ms(graph.replay, calls)
                for _ in range(TIMING_BATCHES)]
    eager = statistics.median(_batch_ms(fn, calls) for _ in range(3))
    del graph
    return {"ms": statistics.median(per_call), "min_ms": min(per_call),
            "max_ms": max(per_call), "calls_per_batch": calls,
            "eager_ms": eager}


class CardSampler:
    """The card's SM clock and power draw from ``nvidia-smi``, sampled every
    SAMPLE_MS while the with-block runs; ``summary`` holds their medians and
    extremes afterwards."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", str(SAMPLE_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc) -> None:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        mhz, watts = [], []
        for line in out.splitlines():
            try:
                clock, power = map(float, line.split(","))
            except ValueError:  # "[N/A]" or a cut line
                continue
            mhz.append(clock)
            watts.append(power)
        self.summary = {"samples": len(mhz)}
        if mhz:
            self.summary.update(
                sm_mhz=statistics.median(mhz), sm_mhz_min=min(mhz),
                power_w=statistics.median(watts), power_w_max=max(watts))


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    capability = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("card", {"nvidia_smi": card, "torch_name": name,
                  "capability": list(capability),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "python": sys.version.split()[0]})
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    tiled_burn._kernel()
    seconds = time.perf_counter() - t0
    report = _build.ptxas_report(_build.build_log())
    emit("build", {"seconds": seconds, **report})
    require(report["kernels"], "ptxas reported no kernel")
    for line in report["warnings"]:
        print(f"build warning: {line}", flush=True)


def check(got: torch.Tensor, want: torch.Tensor, what: dict) -> float:
    """max |got - want|, which must be within REL_TOL * max |want|."""
    m, n = want.shape
    require(got.dtype == torch.float32 and got.shape == (m, n),
            f"bad output {got.dtype} {tuple(got.shape)}")
    require(bool(torch.isfinite(got).all()), "non-finite output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    emit("check", {**what, "max_abs_err": err, "max_abs_plain": scale,
                   "limit": REL_TOL * scale})
    require(err <= REL_TOL * scale,
            f"kernel disagrees at {what}: {err} > {REL_TOL * scale}")
    return err


def phase_correctness() -> float:
    """Returns max |kernel - plain| at the main path's shape."""
    cases = [  # (m, k, n, tiles)
        (256, 512, 384, dict(tile_m=128, tile_n=128, tile_k=128)),
        (128, 1024, 128, dict(tile_m=128, tile_n=128, tile_k=256)),
        (384, 384, 384, {}),  # the 128-wide instance
        (128, 128, 128, {}),  # K shorter than the ring
        # 9 x 10 tiles of 128 x 128 on a partial wave; 10 K stages, not a
        # multiple of the ring's 6
        (1152, 640, 1280, {}),
    ] + [(size, size, size, {}) for size in SWEEP_SIZES]  # the main path's
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main_err = None
    for seed, (m, k, n, tiles) in enumerate(cases):
        plan = tiled_burn.gemm_plan(m, n, sms)
        require(plan == tiled_burn.kernel_plan(m, n, sms),
                f"plan mirror {plan} != the kernel's at {(m, k, n)}")
        a = randn_bf16((m, k), 2 * seed)
        b = randn_bf16((k, n), 2 * seed + 1)
        before = tiled_burn.launches
        got = tiled_matmul(a, b, **tiles)
        want = tiled_matmul_reference(a, b)
        torch.cuda.synchronize()
        require(tiled_burn.launches == before + 1,
                "the launch counter did not move")
        err = check(got, want, {"m": m, "k": k, "n": n, "tiles": tiles,
                                "block_n": plan[0], "grid": plan[1]})
        if (m, k, n) == (MAIN_SIZE,) * 3:
            main_err = err
        del a, b, got, want

    # Two launches back to back on new inputs, no synchronisation between.
    pairs = [(randn_bf16((2048, 1024), 50 + i), randn_bf16((1024, 1536), 60 + i))
             for i in range(2)]
    outs = [tiled_matmul(a, b) for a, b in pairs]
    for i, ((a, b), got) in enumerate(zip(pairs, outs)):
        check(got, tiled_matmul_reference(a, b),
              {"m": 2048, "k": 1024, "n": 1536, "back_to_back": i})
    del pairs, outs

    def raises(exc, fn) -> bool:
        try:
            fn()
        except exc:
            return True
        return False

    z = torch.zeros
    bf16 = dict(dtype=torch.bfloat16, device="cuda")
    require(raises(ValueError, lambda: tiled_matmul(
        z((128, 128), **bf16), z((256, 128), **bf16))), "K mismatch passed")
    require(raises(ValueError, lambda: tiled_matmul(
        z((100, 128), **bf16), z((128, 128), **bf16), tile_m=100)),
        "tile_m=100 passed")
    require(raises(TypeError, lambda: tiled_matmul(
        z((128, 128), device="cuda"), z((128, 128), device="cuda"))),
        "f32 inputs passed")
    require(raises(ValueError, lambda: tiled_matmul(
        z((256, 256), **bf16).t()[:128], z((256, 128), **bf16))),
        "a non-contiguous input passed")
    emit("contract", "ok")
    return main_err


class StepCounter:
    """Stands in for the embedded exporter's record_step."""

    def __init__(self) -> None:
        self.steps = 0
        self.flops = 0.0
        self.seconds = 0.0

    def __call__(self, n: int, *, seconds: float, flops: float) -> None:
        self.steps += n
        self.seconds += seconds
        self.flops += flops


def run_main_burn(kernel: str, depth: int) -> tuple[int, int, float]:
    """One run_burn at MAIN_SIZE; returns (steps, devices, steps/s)."""
    hook = StepCounter()
    result: dict = {}
    with CardSampler() as sampler:
        steps = run_burn(seconds=BURN_SECONDS, size=MAIN_SIZE,
                         report_every=1e9, kernel=kernel, step_hook=hook,
                         depth=depth, result=result)
    per_step = 2 * MAIN_SIZE**3 * result["devices"]
    if kernel == "torch":
        per_step *= depth
    emit("run_burn", {"kernel": kernel, "steps": steps,
                      "hook_steps": hook.steps, "hook_flops": hook.flops,
                      "hook_seconds": hook.seconds, "card": sampler.summary,
                      **result})
    require(steps > 0, f"{kernel}: no steps")
    require(set(result) == {"steps_per_s", "tflops_per_s", "devices", "size",
                            "depth"}, f"{kernel}: result keys {sorted(result)}")
    require(result["depth"] == (depth if kernel == "torch" else None),
            f"{kernel}: depth {result['depth']}")
    require(hook.steps == steps, f"{kernel}: hook saw {hook.steps} steps")
    require(math.isclose(hook.flops, per_step * steps, rel_tol=1e-12),
            f"{kernel}: hook FLOPs {hook.flops} != {per_step} x {steps}")
    require(result["tflops_per_s"] > 0, f"{kernel}: no throughput")
    return steps, result["devices"], result["steps_per_s"]


def phase_main_path() -> tuple[int, float]:
    """The port's main path; returns the kernel launches it made and the
    ``cuda`` burn's steps/s."""
    tiled_burn.launches = 0
    steps, n_devices, cuda_steps_per_s = run_main_burn("cuda", TORCH_DEPTH)
    cuda_launches = tiled_burn.launches
    run_main_burn("torch", TORCH_DEPTH)
    torch_launches = tiled_burn.launches - cuda_launches
    rows = sweep_burn(SWEEP_SIZES, seconds_per_size=SWEEP_SECONDS,
                      kernel="cuda")
    launches = tiled_burn.launches
    for row in rows:
        emit("sweep", row)
    emit("launches", {"run_burn_cuda": cuda_launches,
                      "run_burn_torch": torch_launches,
                      "main_path": launches})
    # One launch per card per step, plus the first (warm-up) step.
    require(cuda_launches == (steps + 1) * n_devices,
            f"{cuda_launches} launches for {steps} steps on {n_devices} cards")
    require(torch_launches == 0, "the torch chain launched the tiled kernel")
    for row in rows:
        require("error" not in row and "skipped" not in row,
                f"sweep row failed: {row}")
        require(row["tflops_per_s"] > 0 and "mfu_pct" in row,
                f"sweep row incomplete: {row}")
    require(launches > cuda_launches, "the sweep did not launch the kernel")

    # What comes out: the per-card step against its plain version, and the
    # torch chain's output finite.
    step, xs, ws, _, _ = tiled_all_device_burn(MAIN_SIZE)
    outs = step(xs, ws)
    for x, w, out in zip(xs, ws, outs):
        want = torch.tanh(tiled_matmul_reference(x, w)).to(torch.bfloat16)
        err = (out.float() - want.float()).abs().max().item()
        require(out.shape == x.shape and out.dtype == torch.bfloat16,
                f"step output {out.dtype} {tuple(out.shape)}")
        require(err <= STEP_ATOL, f"burn step disagrees: {err}")
    step, xs, ws, _, _ = make_all_device_burn(MAIN_SIZE, TORCH_DEPTH)
    outs = step(xs, ws)
    torch.cuda.synchronize()
    for out in outs:
        require(bool(torch.isfinite(out.float()).all()),
                "torch chain output not finite")
    emit("step_outputs", "ok")
    return launches, cuda_steps_per_s


def phase_trace() -> None:
    """Where the ``cuda`` burn step's device time goes at MAIN_SIZE."""
    step, xs, ws, _, _ = tiled_all_device_burn(MAIN_SIZE)
    for _ in range(10):
        xs = step(xs, ws)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACE_STEPS):
            xs = step(xs, ws)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        emit("trace", "not measured: the profiler saw no device time")
        return
    per_kernel: collections.Counter = collections.Counter()
    for e in kernels:
        per_kernel[e.name[:80]] += e.time_range.elapsed_us()
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    emit("trace", {
        "steps": TRACE_STEPS, "size": MAIN_SIZE,
        "step_ms_host_clock": wall_s / TRACE_STEPS * 1e3,
        "device_busy_share": sum(per_kernel.values()) / span_us,
        "device_us_per_step": {k: v / TRACE_STEPS
                               for k, v in per_kernel.most_common()}})


def phase_entry() -> None:
    fn, (x, w) = entry()
    y = fn(x, w)
    torch.cuda.synchronize()
    require(y.shape == (512, 512) and y.dtype == torch.bfloat16
            and y.is_cuda, f"entry output {y.dtype} {tuple(y.shape)}")
    require(bool(torch.isfinite(y.float()).all()), "entry output not finite")
    emit("entry", {"shape": list(y.shape), "dtype": str(y.dtype)})


_SERIES = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_metrics(text: str) -> list[tuple[str, dict, float]]:
    """(name, labels, value) for every sample line of a Prometheus text
    exposition."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        match = _SERIES.match(line)
        require(match is not None, f"unparsable exposition line {line!r}")
        name, labels, value = match.groups()
        out.append((name, dict(_LABEL.findall(labels or "")), float(value)))
    return out


def scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        require(resp.status == 200, f"{path} answered {resp.status}")
        return resp.read().decode()


def per_card(series, name: str) -> dict[int, float]:
    """chip index -> value of one per-device family."""
    return {int(labels["chip"]): value
            for family, labels, value in series if family == name}


def one(series, name: str) -> float:
    values = [value for family, _, value in series if family == name]
    require(len(values) == 1, f"{name}: {len(values)} series")
    return values[0]


def check_card_families(series, n_cards: int) -> dict:
    """What the embedded exporter must serve for every card during the
    ``cuda`` burn at MAIN_SIZE; returns chip -> steps."""
    ups = [labels for family, labels, value in series
           if family == schema.DEVICE_UP.name and value == 1.0]
    require(len(ups) == n_cards, f"{len(ups)} accelerator_up series at 1 "
            f"for {n_cards} cards")
    for labels in ups:
        require(labels["accel_type"] == "gpu-h100",
                f"accel_type {labels['accel_type']!r}")
        require(labels["device_path"].startswith("/dev/nvidia"),
                f"device_path {labels['device_path']!r}")
    info = [labels for family, labels, _ in series
            if family == schema.SELF_INFO.name]
    require(len(info) == 1 and info[0]["backend"] == "torch-embedded",
            f"exporter info {info}")
    steps = per_card(series, schema.WORKLOAD_STEPS.name)
    require(len(steps) == n_cards and min(steps.values()) > 0,
            f"steps {steps}")
    peak = per_card(series, schema.PEAK_FLOPS.name)
    require(set(peak.values()) == {989e12}, f"peak FLOP/s {peak}")
    used = per_card(series, schema.MEMORY_USED.name)
    total = per_card(series, schema.MEMORY_TOTAL.name)
    high = per_card(series, schema.MEMORY_PEAK.name)
    # Between two steps the burn holds x and w (bf16, size^2 each): the
    # fresh output has just replaced x. Within a step it also holds the
    # f32 product and its f32 tanh, so the allocator's peak is at least
    # x + w + 2 f32 blocks.
    live = 2 * MAIN_SIZE**2 * 2
    step_peak = live + 2 * MAIN_SIZE**2 * 4
    for chip in range(n_cards):
        free_total = torch.cuda.mem_get_info(chip)[1]
        require(used[chip] >= live, f"card {chip}: used {used[chip]} < {live}")
        require(used[chip] <= total[chip], f"card {chip}: used > total")
        require(high[chip] >= max(used[chip], step_peak),
                f"card {chip}: peak {high[chip]}")
        require(total[chip] == free_total,
                f"card {chip}: total {total[chip]} != mem_get_info "
                f"{free_total}")
    count = one(series, schema.WORKLOAD_STEP_DURATION.name + "_count")
    require(all(v == count for v in steps.values()),
            f"step histogram count {count} != steps {steps}")
    return steps


def embedded_cli() -> dict:
    """The user's entry point: the loadgen CLI with the embedded exporter,
    scraped over HTTP while it burns."""
    cmd = [sys.executable, "-m", "kube_gpu_stats_tpu_torch.loadgen",
           "--kernel", "cuda", "--size", str(MAIN_SIZE),
           "--seconds", str(EMBEDDED_SECONDS), "--embedded-port", "0"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout] + [
            lines.put(None)], daemon=True)
    reader.start()
    out: list[str] = []

    def next_line(deadline: float) -> str | None:
        line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        if line is not None:
            out.append(line.rstrip("\n"))
        return line

    try:
        deadline = time.monotonic() + CLI_START_S
        port = None
        while port is None:
            line = next_line(deadline)
            require(line is not None, f"the CLI exited before serving: {out}")
            if line.startswith("embedded-exporter-port:"):
                port = int(line.split(":", 1)[1])
        n_cards = torch.cuda.device_count()
        # Scrape 1: the first one with steps counted; then two more,
        # SCRAPE_GAP_S apart, while the burn runs.
        deadline = time.monotonic() + CLI_START_S
        while True:
            series = parse_metrics(scrape(port))
            steps = per_card(series, schema.WORKLOAD_STEPS.name)
            if steps and min(steps.values()) > 0:
                break
            require(time.monotonic() < deadline, "no steps counted")
            time.sleep(0.2)
        scrapes = [(time.monotonic(), series)]
        for _ in range(2):
            time.sleep(SCRAPE_GAP_S)
            scrapes.append((time.monotonic(), parse_metrics(scrape(port))))
        healthz = scrape(port, "/healthz")
        require(healthz == "ok\n", f"/healthz said {healthz!r}")
        steps_seen = [check_card_families(series, n_cards)
                      for _, series in scrapes]
        for before, after in zip(steps_seen, steps_seen[1:]):
            require(all(after[c] > before[c] for c in before),
                    f"steps did not rise between scrapes: {steps_seen}")
        mfu = per_card(scrapes[-1][1], schema.WORKLOAD_MFU.name)
        require(len(mfu) == n_cards
                and all(0 < v <= MFU_MAX for v in mfu.values()),
                f"MFU {mfu}")
        rc = proc.wait(timeout=EMBEDDED_SECONDS + 120)
        while next_line(time.monotonic() + 10) is not None:
            pass
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    require(rc == 0, f"the CLI exited {rc}: {out}")
    steady = [json.loads(line)["steady_state"] for line in out
              if line.startswith('{"steady_state"')]
    require(len(steady) == 1, f"no steady_state line: {out}")
    return {"scrapes": len(scrapes),
            "scrape_gap_s": [b[0] - a[0] for a, b in zip(scrapes,
                                                         scrapes[1:])],
            "steps": [s[0] for s in steps_seen], "mfu_pct": mfu,
            "steps_per_s": steady[0]["steps_per_s"]}


def burn_under_exporter() -> dict:
    """The ``cuda`` burn at MAIN_SIZE in this process with the embedded
    exporter fed by its step hook and scraped like Prometheus would (gzip,
    every half second); its exported counters held against the burn's
    own after the last tick. Returns what it measured."""
    exporter = embedded.start(0)
    n_cards = torch.cuda.device_count()
    hook = StepCounter()

    def tee(n: int, *, seconds: float, flops: float) -> None:
        hook(n, seconds=seconds, flops=flops)
        exporter.record_step(n, seconds=seconds, flops=flops)

    stop = threading.Event()

    def scraper() -> None:
        while not stop.wait(0.5):
            request = urllib.request.Request(
                f"http://127.0.0.1:{exporter.port}/metrics",
                headers={"Accept-Encoding": "gzip"})
            with urllib.request.urlopen(request, timeout=10) as resp:
                resp.read()

    try:
        scraping = threading.Thread(target=scraper, daemon=True)
        scraping.start()
        before = tiled_burn.launches
        result: dict = {}
        steps = run_burn(seconds=BURN_SECONDS, size=MAIN_SIZE,
                         report_every=1e9, kernel="cuda", step_hook=tee,
                         result=result)
        launches = tiled_burn.launches - before
        stop.set()
        scraping.join(timeout=30)
        # Two publishes after the burn: the second tick began after the
        # last record_step.
        generation = exporter.registry.generation
        require(exporter.registry.wait_for_publish(generation + 1, 10),
                "no publish after the burn")
        snapshot = exporter.registry.snapshot()
        poll_hist = exporter.poll.poll_histogram
    finally:
        stop.set()
        exporter.stop()
    series = [(s.spec.name, dict(s.labels), s.value) for s in snapshot.series]
    exported = per_card(series, schema.WORKLOAD_STEPS.name)
    flops = per_card(series, schema.WORKLOAD_FLOPS.name)
    require(launches == (steps + 1) * n_cards,
            f"{launches} launches for {steps} steps on {n_cards} cards")
    require(set(exported.values()) == {float(steps)}
            and len(exported) == n_cards,
            f"exported steps {exported} != run_burn's {steps}")
    require(len(flops) == n_cards
            and all(math.isclose(v, hook.flops / n_cards, rel_tol=1e-12)
                    for v in flops.values()),
            f"exported FLOPs {flops} != hook {hook.flops} / {n_cards}")
    hists = {(h.spec.name, h.labels): h for h in snapshot.histograms}
    step_hist = hists[(schema.WORKLOAD_STEP_DURATION.name, ())]
    require(step_hist.total == steps, f"step histogram {step_hist.total}")
    scrape_hist = hists.get((schema.SELF_SCRAPE_DURATION.name,
                             (("output", "http"),)))
    require(scrape_hist is not None and scrape_hist.total > 0,
            "no scrape observed")
    render_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        snapshot.render()
        render_ms.append((time.perf_counter() - t0) * 1e3)
    return {
        "steps_per_s": result["steps_per_s"], "launches": launches,
        "poll_tick_ms": {
            "ticks": poll_hist.total,
            "mean": poll_hist.sum / poll_hist.total * 1e3,
            "p50_bucket_le": poll_hist.quantile(0.5) * 1e3,
            "p99_bucket_le": poll_hist.quantile(0.99) * 1e3},
        "scrape_ms": {"scrapes": scrape_hist.total,
                      "mean": scrape_hist.sum / scrape_hist.total * 1e3},
        "render_ms": {"median": statistics.median(render_ms),
                      "min": min(render_ms), "max": max(render_ms),
                      "series": len(snapshot.series)}}


def phase_embedded(card: str, main_cuda_steps_per_s: float) -> int:
    """The embedded exporter on the card; returns the kernel launches of
    its in-process burns."""
    cli = embedded_cli()
    emit("embedded_cli", cli)
    # In turns, with and without the exporter: with, without, without,
    # with (the launch counter counts all four).
    tiled_burn.launches = 0
    runs: dict[str, list] = {"with": [], "without": []}
    for turn in ("with", "without", "without", "with"):
        if turn == "with":
            runs["with"].append(burn_under_exporter())
        else:
            result: dict = {}
            run_burn(seconds=BURN_SECONDS, size=MAIN_SIZE, report_every=1e9,
                     kernel="cuda", result=result)
            runs["without"].append(result["steps_per_s"])
    launches = tiled_burn.launches
    emit("embedded_cost", {
        "card": card,
        "poll_tick_ms": [run["poll_tick_ms"] for run in runs["with"]],
        "scrape_ms": [run["scrape_ms"] for run in runs["with"]],
        "render_ms": runs["with"][0]["render_ms"],
        "cuda_steps_per_s": {
            "order": "with, without, without, with",
            "with_exporter": [run["steps_per_s"] for run in runs["with"]],
            "without_exporter": runs["without"],
            "without_exporter_main_path": main_cuda_steps_per_s,
            "with_exporter_cli": cli["steps_per_s"]},
        "launches": {"with_exporter": [run["launches"]
                                       for run in runs["with"]],
                     "all": launches}})
    return launches

def smi(fields: str) -> list[list[str]]:
    """One ``nvidia-smi --query-gpu`` row per card, without units."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [[cell.strip() for cell in line.split(",")]
            for line in out.strip().splitlines()]


def start_daemon(textfile_dir: str) -> tuple[subprocess.Popen, int, list]:
    """The DaemonSet entry point on the card; returns it, the port its
    log names, and its log lines (read on until it exits)."""
    cmd = [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "--backend",
           "nvml", "--listen-port", "0", "--interval",
           str(DAEMON_INTERVAL_S), "--attribution", "off",
           "--textfile-dir", textfile_dir]
    proc = subprocess.Popen(cmd, cwd=ROOT, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL, text=True)
    lines: queue.Queue = queue.Queue()
    log: list[str] = []

    def read() -> None:
        for line in proc.stderr:
            log.append(line.rstrip("\n"))
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    deadline = time.monotonic() + CLI_START_S
    try:
        while True:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            require(line is not None,
                    f"the daemon exited before serving: {log}")
            match = re.search(r"listening on \S+:(\d+)", line)
            if match:
                return proc, int(match.group(1)), log
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        raise


def poll_count(series) -> float:
    """Ticks the daemon has published; 0 before its first publish."""
    name = schema.SELF_POLL_DURATION.name + "_count"
    return sum(value for family, _, value in series if family == name)


def fresh_scrape(port: int, after: float):
    """The first scrape whose tick count passed ``after``: read right at a
    publish, so what is read beside it lines up with the tick."""
    deadline = time.monotonic() + 10
    while True:
        series = parse_metrics(scrape(port))
        if poll_count(series) > after:
            return series
        require(time.monotonic() < deadline, "the daemon stopped ticking")
        time.sleep(0.02)


def card_series(series, uuid: str) -> dict:
    """family -> (labels, value) of one card's per-device series."""
    out = {}
    for family, labels, value in series:
        if labels.get("uuid") == uuid and "pid" not in labels:
            out[family] = (labels, value)
    return out


def holders(series, device_path: str) -> set[str]:
    return {labels["pid"] for family, labels, _ in series
            if family == schema.PROCESS_OPEN.name
            and labels["device_path"] == device_path}


def histogram_summary(series, name: str, labels: dict | None = None) -> dict:
    """count, mean (ms) and the le of the p50 bucket (ms) of one
    histogram in a parsed exposition."""
    want = labels or {}

    def mine(got: dict) -> bool:
        return all(got.get(k) == v for k, v in want.items())

    count = sum(v for f, lab, v in series if f == name + "_count"
                and mine(lab))
    total = sum(v for f, lab, v in series if f == name + "_sum"
                and mine(lab))
    buckets = sorted((float(lab["le"]), v) for f, lab, v in series
                     if f == name + "_bucket" and mine(lab))
    p50 = next(le for le, cum in buckets if cum >= 0.5 * count)
    return {"count": count, "mean_ms": total / count * 1e3,
            "p50_bucket_le_ms": p50 * 1e3}


def tick_phases_ms(series) -> dict:
    """The daemon's own flight-recorder digest: p50/p99/max ms per tick
    phase (``env_round`` is the sampling round, ``sample`` one card's
    reads on the pool, ``fold``/``plan_write``/``publish`` the build)."""
    out: dict = {}
    for family, labels, value in series:
        if family == schema.TICK_PHASE_SECONDS.name:
            out.setdefault(labels["phase"], {})[labels["quantile"]] = \
                value * 1e3
    return out


def nvml_call_us(uuid: str) -> dict:
    """Median microseconds of each bound NVML call over NVML_CALLS calls,
    through the port's binding, on the card named by ``uuid``."""
    nvml = nvml_binding.Nvml()
    nvml.init()
    try:
        handles = [nvml.handle(i) for i in range(nvml.device_count())]
        handle = next(h for h in handles if nvml.uuid(h) == uuid)
        index = handles.index(handle)
        count_field = [(nvml_binding.NVML_FI_DEV_NVLINK_LINK_COUNT, 0)]
        [(_, links)] = nvml.field_values(handle, count_field)
        link_fields = [(f, link) for link in range(int(links or 0))
                       for f in (nvml_binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX,
                                 nvml_binding.NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX)]
        calls = {
            "nvmlDeviceGetCount_v2": nvml.device_count,
            "nvmlDeviceGetHandleByIndex_v2": lambda: nvml.handle(index),
            "nvmlDeviceGetUUID": lambda: nvml.uuid(handle),
            "nvmlDeviceGetName": lambda: nvml.name(handle),
            "nvmlDeviceGetMinorNumber": lambda: nvml.minor_number(handle),
            "nvmlDeviceGetUtilizationRates": lambda: nvml.utilization(handle),
            "nvmlDeviceGetMemoryInfo": lambda: nvml.memory(handle),
            "nvmlDeviceGetPowerUsage": lambda: nvml.power_mw(handle),
            "nvmlDeviceGetTemperature": lambda: nvml.temperature(handle),
            "nvmlDeviceGetTotalEnergyConsumption":
                lambda: nvml.energy_mj(handle),
            "nvmlDeviceGetFieldValues(NVLink link count)":
                lambda: nvml.field_values(handle, count_field),
        }
        if link_fields:
            calls[f"nvmlDeviceGetFieldValues({len(link_fields)} NVLink "
                  f"fields)"] = lambda: nvml.field_values(handle, link_fields)
        out = {}
        for name, call in calls.items():
            times = []
            for _ in range(NVML_CALLS):
                t0 = time.perf_counter()
                call()
                times.append((time.perf_counter() - t0) * 1e6)
            out[name] = statistics.median(times)
        return {"links": int(links or 0), "median_us": out}
    finally:
        nvml.shutdown()


def render_ms() -> dict:
    """Render of the daemon's own snapshot: the same daemon in this
    process, on the card, two ticks in; median of 20."""
    cfg = config.from_args(["--backend", "nvml", "--listen-host",
                            "127.0.0.1", "--listen-port", "0", "--interval",
                            str(DAEMON_INTERVAL_S), "--attribution", "off"])
    instance = daemon.Daemon(cfg)
    instance.start()
    try:
        require(instance.registry.wait_for_publish(1, 10),
                "the in-process daemon did not tick twice")
        snapshot = instance.registry.snapshot()
    finally:
        instance.stop()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        snapshot.render()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "series": len(snapshot.series)}


def burn_scrape_row(series, uuid: str, smi_now: dict,
                    reserved: int) -> dict:
    """The burn's card in one scrape, beside what was read with it."""
    mine = card_series(series, uuid)
    value = {family: mine[family][1] if family in mine else None
             for family in (schema.DEVICE_UP.name, schema.DUTY_CYCLE.name,
                            schema.MEMORY_USED.name, schema.MEMORY_TOTAL.name,
                            schema.POWER.name, schema.TEMPERATURE.name,
                            schema.ENERGY.name)}
    labels = mine.get(schema.DEVICE_UP.name, ({}, None))[0]
    return {"up": value[schema.DEVICE_UP.name],
            "accel_type": labels.get("accel_type"),
            "duty": value[schema.DUTY_CYCLE.name],
            "used": value[schema.MEMORY_USED.name],
            "total": value[schema.MEMORY_TOTAL.name], "reserved": reserved,
            "power_w": value[schema.POWER.name],
            "temperature": value[schema.TEMPERATURE.name],
            "energy_j": value[schema.ENERGY.name],
            "smi_power_w": smi_now["power_w"], "smi_util": smi_now["util"],
            "smi_memory_used_mib": smi_now["memory_used_mib"]}


def check_burn_row(row: dict, card: dict) -> None:
    """What the daemon must serve for the burn's card during the burn."""
    require(row["up"] == 1.0, f"burn card not up: {row}")
    require(row["accel_type"] == "gpu-h100", f"accel_type {row}")
    require(row["duty"] >= DUTY_MIN,
            f"duty cycle {row['duty']} < {DUTY_MIN} in the burn")
    require(row["reserved"] <= row["used"] <= row["total"],
            f"memory used {row['used']} not in [reserved "
            f"{row['reserved']}, {row['total']}]")
    require(abs(row["total"] - card["memory_total_mib"] * MIB) <= MIB,
            f"memory total {row['total']} != nvidia-smi's "
            f"{card['memory_total_mib']} MiB")
    require(0 < row["power_w"] <= card["power_limit_w"],
            f"power {row['power_w']} W not in (0, {card['power_limit_w']}]")
    require(abs(row["power_w"] - row["smi_power_w"])
            <= POWER_TOL * row["smi_power_w"],
            f"power {row['power_w']} W vs nvidia-smi {row['smi_power_w']} W")
    require(20 <= row["temperature"] <= 100,
            f"temperature {row['temperature']}")


def phase_daemon(card_line: str) -> int:
    """The DaemonSet exporter on the card under the ``cuda`` burn; returns
    the kernel launches of the burn."""
    cards = {row[1]: {"index": int(row[0]), "uuid": row[1], "name": row[2],
                      "memory_total_mib": float(row[3]),
                      "power_limit_w": float(row[4])}
             for row in smi("index,uuid,name,memory.total,power.limit")}
    burn_uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    require(burn_uuid in cards, f"card 0 {burn_uuid} not in {sorted(cards)}")
    card = cards[burn_uuid]
    nvml = nvml_binding.Nvml()
    nvml.init()
    textfile_dir = tempfile.mkdtemp(prefix="kts-textfile-")
    proc = None
    try:
        proc, port, log = start_daemon(textfile_dir)
        # Idle: every card up, with nvidia-smi's UUIDs.
        idle = fresh_scrape(port, 0.0)
        ups = {labels["uuid"]: value for family, labels, value in idle
               if family == schema.DEVICE_UP.name}
        require(ups == {uuid: 1.0 for uuid in cards},
                f"accelerator_up {ups} != nvidia-smi's cards {sorted(cards)}")
        device_path = card_series(idle, burn_uuid)[
            schema.DEVICE_UP.name][0]["device_path"]
        require(stat.S_ISCHR(os.stat(device_path).st_mode),
                f"{device_path} is not a character device")
        handle = next(h for h in (nvml.handle(i)
                                  for i in range(nvml.device_count()))
                      if nvml.uuid(h) == burn_uuid)

        # The burn on card 0, scraped from another thread.
        seen: list = []
        failure: list = []

        def scraper(start: float) -> None:
            try:
                after = poll_count(idle)
                for k in range(DAEMON_SCRAPES):
                    time.sleep(max(0.0, start + DAEMON_SCRAPE_START_S
                                   + DAEMON_SCRAPE_GAP_S * k
                                   - time.monotonic()))
                    series = fresh_scrape(port, after)
                    energy_mj = nvml.energy_mj(handle)
                    reserved = torch.cuda.memory_reserved(0)
                    at = time.monotonic()
                    row = {r[0]: r for r in
                           smi("uuid,utilization.gpu,memory.used,"
                               "power.draw")}[burn_uuid]
                    smi_now = {"util": float(row[1]),
                               "memory_used_mib": float(row[2]),
                               "power_w": float(row[3])}
                    seen.append((at, series, energy_mj, smi_now, reserved))
                    after = poll_count(series)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                failure.append(exc)

        tiled_burn.launches = 0
        thread = threading.Thread(target=scraper, args=(time.monotonic(),),
                                  daemon=True)
        thread.start()
        result: dict = {}
        steps = run_burn(seconds=DAEMON_BURN_S, size=MAIN_SIZE,
                         report_every=1e9, kernel="cuda", result=result,
                         device="cuda:0")
        launches = tiled_burn.launches
        thread.join(timeout=30)
        require(not failure, f"scraping failed: {failure}")
        require(len(seen) == DAEMON_SCRAPES,
                f"{len(seen)} scrapes in the burn")
        require(launches == steps + 1,
                f"{launches} launches for {steps} steps on one card")
        burn_rows = [burn_scrape_row(series, burn_uuid, smi_now, reserved)
                     for _, series, _, smi_now, reserved in seen]
        emit("daemon_burn_scrapes", {
            "at_s": [at - seen[0][0] for at, *_ in seen],
            "nvml_energy_mj": [e for _, _, e, _, _ in seen],
            "rows": burn_rows})
        for row in burn_rows:
            check_burn_row(row, card)
        energies = [row["energy_j"] for row in burn_rows]
        require(all(b > a for a, b in zip(energies, energies[1:])),
                f"energy not rising: {energies}")
        served_j = energies[-1] - energies[0]
        nvml_j = (seen[-1][2] - seen[0][2]) / 1000.0
        require(abs(served_j - nvml_j) <= ENERGY_TOL * nvml_j,
                f"energy +{served_j} J vs NVML's +{nvml_j} J")
        pid = str(os.getpid())
        for _, series, _, _, _ in seen:
            require(pid in holders(series, device_path),
                    f"pid {pid} not among {device_path}'s holders")

        # The textfile mirrors a scrape of the same publish.
        textfile = pathlib.Path(textfile_dir) / "accelerator.prom"
        for _ in range(50):
            before = textfile.read_text()
            body = scrape(port)
            if before == body == textfile.read_text():
                break
        else:
            raise RuntimeError("the textfile never matched a scrape")
        require(not list(pathlib.Path(textfile_dir).glob("*.tmp")),
                "a *.tmp was left behind")
        healthz = scrape(port, "/healthz")
        require(healthz.startswith("ok\n"), f"/healthz said {healthz!r}")
        last = seen[-1][1]
        tick = histogram_summary(last, schema.SELF_POLL_DURATION.name)
        phases = tick_phases_ms(last)
        cached_scrape = histogram_summary(
            last, schema.SELF_SCRAPE_DURATION.name, {"output": "http"})
    finally:
        rc = None
        if proc is not None:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        nvml.shutdown()
    require(rc == 0, f"the daemon exited {rc} on SIGTERM: {log[-20:]}")
    n_series = sum(1 for line in body.splitlines()
                   if line and not line.startswith("#"))
    emit("daemon", {
        "card": card_line, "cards": len(cards),
        "tick_ms": {**tick, "budget_ms": TICK_BUDGET_MS},
        "tick_phases_ms": phases,
        "nvml": nvml_call_us(burn_uuid),
        "render_ms": render_ms(),
        "cached_scrape_ms": cached_scrape["mean_ms"],
        "scrapes": cached_scrape["count"],
        "series": n_series,
        "series_per_s_per_card": n_series / DAEMON_INTERVAL_S / len(cards),
        "burn": {"steps": steps, "steps_per_s": result["steps_per_s"],
                 "launches": launches, "scrapes": burn_rows,
                 "energy_served_j": served_j, "energy_nvml_j": nvml_j},
        "device_path": device_path})
    require(tick["p50_bucket_le_ms"] <= TICK_BUDGET_MS,
            f"tick p50 bucket {tick['p50_bucket_le_ms']} ms over the "
            f"{TICK_BUDGET_MS} ms budget")
    return launches


def library_call():
    """The yardstick: one PyTorch call computing the same function. Returns
    (name, fn(a, b))."""
    probe = torch.zeros((128, 128), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(probe, probe, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return "torch.matmul (bf16 out)", torch.matmul
    return ("torch.mm(out_dtype=float32)",
            lambda a, b: torch.mm(a, b, out_dtype=torch.float32))


def bound(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it."""
    name = torch.cuda.get_device_name(0)
    peak = _kind_peak_flops(name)
    rate = _kind_lookup(HBM_BYTES_PER_S, name)
    require(peak is not None and rate is not None,
            f"no datasheet peak for {name}")
    ops_ms = 2 * m * n * k / peak * 1e3
    bytes_ms = (2 * (m * k + k * n) + 4 * m * n) / rate * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_timing(card: str) -> dict:
    library_name, library_fn = library_call()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    at_main = None
    for size in SWEEP_SIZES:
        a = randn_bf16((size, size), 100)
        b = randn_bf16((size, size), 101)
        kernel = time_ms(lambda: tiled_matmul(a, b))
        plain = time_ms(lambda: tiled_matmul_reference(a, b))
        library = time_ms(lambda: library_fn(a, b))
        bound_ms, bound_by = bound(size, size, size)
        block_n, grid = tiled_burn.gemm_plan(size, size, sms)
        row = {"size": size, "ms": kernel["ms"], "plain_ms": plain["ms"],
               "library_ms": library["ms"], "library": library_name,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops_per_s": 2 * size**3 / kernel["ms"] / 1e9,
               "bound_share": bound_ms / kernel["ms"],
               "block_n": block_n, "grid": grid,
               "spread": {"kernel": kernel, "plain": plain,
                          "library": library},
               "card": card}
        emit("timing", row)
        if size == MAIN_SIZE:
            at_main = row
        del a, b
    return at_main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = phase_card()
    phase_build()
    max_abs_err = phase_correctness()
    launches, cuda_steps_per_s = phase_main_path()
    phase_trace()
    phase_entry()
    launches += phase_embedded(card, cuda_steps_per_s)
    launches += phase_daemon(card)
    t = phase_timing(card)
    emit("kernels", [{
        "name": KERNEL_NAME, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "design": KERNEL_DESIGN,
        "bound_share": t["bound_share"]}])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
