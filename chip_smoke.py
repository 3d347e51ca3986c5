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
7. time the kernel, its plain version and one library call
   (``torch.mm`` with f32 out) at the main path's and the sweep's sizes,
   each as the median of batches of back-to-back calls;
8. one JSON line describing every kernel of the path; last, the ``ok``
   line with the device.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from kube_gpu_stats_tpu_torch import _build
from kube_gpu_stats_tpu_torch.embedded import _kind_lookup, _kind_peak_flops
from kube_gpu_stats_tpu_torch.entry import entry
from kube_gpu_stats_tpu_torch.loadgen import tiled_burn
from kube_gpu_stats_tpu_torch.loadgen.burn import (make_all_device_burn,
                                                   run_burn, sweep_burn)
from kube_gpu_stats_tpu_torch.loadgen.tiled_burn import (
    tiled_all_device_burn, tiled_matmul, tiled_matmul_reference)

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


def run_main_burn(kernel: str, depth: int) -> tuple[int, int]:
    """One run_burn at MAIN_SIZE; returns (steps, devices)."""
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
    return steps, result["devices"]


def phase_main_path() -> int:
    """The port's main path; returns the kernel launches it made."""
    tiled_burn.launches = 0
    steps, n_devices = run_main_burn("cuda", TORCH_DEPTH)
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
    return launches


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
    launches = phase_main_path()
    phase_trace()
    phase_entry()
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
