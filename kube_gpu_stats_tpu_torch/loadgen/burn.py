"""Tensor-core load generation on the card — the port of the matmul burn
of ``kube_gpu_stats_tpu/loadgen/burn.py``.

The burn drives EVERY local CUDA card: each card holds one (size, size)
bf16 block of x and its own copy of w, and runs its own chain with no
collectives. ``kernel="torch"`` runs the bf16 ``tanh(acc @ w)`` chain
``depth`` deep through ``torch.matmul`` (the plain large product the JAX
package left to XLA); ``kernel="cuda"`` runs the hand-written tiled GEMM
of ``tiled_burn`` with its tanh epilogue. ``sweep_burn`` measures
steady-state TFLOP/s against matmul size.

Everything runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time

import torch

from ..device import (device_kind, local_devices, per_device, resolve_device,
                      synchronize)


def _randn(shape, seed: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.bfloat16)


def entry_fn(size: int = 1024, depth: int = 4, device=None):
    """Returns (fn, example_args): the single-card burn step.

    fn(x, w) chains ``depth`` bf16 matmuls with a nonlinearity; ``depth``
    sets the device work per Python dispatch.
    """
    dev = resolve_device(device)
    x = _randn((size, size), 0, dev)
    w = _randn((size, size), 1, dev)
    return _matmul_chain(depth), (x, w)


def _matmul_chain(depth: int):
    """The burn computation alone (no example tensors)."""

    def burn(x, w):
        acc = x
        for _ in range(depth):
            acc = torch.tanh(acc @ w)
        return acc

    return burn


def all_device_burn_inputs(size: int, device=None):
    """Shared input construction for the all-device burns (torch chain and
    tiled kernel — they must differ ONLY in who computes the product):
    x of shape (n*size, size) bf16 from seed 0 cut into one row block per
    card, w (size, size) bf16 from seed 1 copied to each card.
    Returns (devices, x_blocks, w_blocks, n)."""
    devices = local_devices(device)
    n = len(devices)
    x = _randn((n * size, size), 0, devices[0])
    w = _randn((size, size), 1, devices[0])
    x_blocks = [blk.to(dev) for blk, dev in zip(x.split(size), devices)]
    w_blocks = [w.to(dev) for dev in devices]
    return devices, x_blocks, w_blocks, n


def make_all_device_burn(size: int, depth: int, device=None):
    """Burn step that drives EVERY local card with its own
    (size, size) @ (size, size) chain, no collectives.

    Returns (step, x_blocks, w_blocks, n_devices, flops_per_step);
    ``step(x_blocks, w_blocks)`` returns the next x blocks. Each step writes
    fresh blocks and drops the old ones, whose memory the caching allocator
    hands straight back (the counterpart of the JAX step's donation).
    """
    _, x_blocks, w_blocks, n = all_device_burn_inputs(size, device)
    flops_per_step = 2 * depth * n * size**3
    return per_device(_matmul_chain(depth)), x_blocks, w_blocks, n, \
        flops_per_step


def _global_scale() -> float:
    """The torch.distributed world size when a process group is up, else 1:
    under the every-host-burns assumption the hook's FLOPs are
    workload-global."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return float(dist.get_world_size())
    return 1.0


def run_burn(seconds: float = 10.0, size: int = 2048,
             report_every: float = 1.0, kernel: str = "torch",
             step_hook=None, depth: int = 16,
             result: dict | None = None,
             pulse_ms: float = 0.0, device=None) -> int:
    """Drive ALL local cards for `seconds`; returns steps executed.
    kernel: "torch" (the bf16 torch.matmul chain on every local card) or
    "cuda" (the hand-written tiled GEMM on the same blocks; ``depth``
    applies to the torch chain only).
    step_hook(n, seconds=dt, flops=f): called at each materialization
    point with the steps since the last call, their combined wall time,
    and their matmul FLOPs times the process-group world size (see
    ``_global_scale``).
    ``result``, when given, receives the steady-state measurement:
    {"steps_per_s", "tflops_per_s", "devices", "size", "depth"} over a
    window that EXCLUDES the first step (kernel build, allocator warm-up)
    and the first materialization batch.
    ``pulse_ms`` > 0 duty-cycles the burn: burn hard for ``pulse_ms``
    milliseconds, idle for the same, repeating — power transients that
    rise and collapse between 1 Hz poll ticks. Throughput figures then
    describe the burning half only in spirit."""
    if kernel == "cuda":
        from .tiled_burn import tiled_all_device_burn

        step, x, w, n_devices, flops_per_step = \
            tiled_all_device_burn(size, device)
    elif kernel == "torch":
        step, x, w, n_devices, flops_per_step = \
            make_all_device_burn(size, depth, device)
    else:
        raise ValueError(f"unknown kernel {kernel!r} (use 'torch' or 'cuda')")
    devices = [blk.device for blk in x]
    hook_flops_per_step = flops_per_step * _global_scale()
    x = step(x, w)
    synchronize(devices)  # first use + one real execution
    steps = 0
    start = time.monotonic()
    last_report = start
    inflight = 0
    pending_steps = 0
    last_hook_t = time.perf_counter()
    # Steady-state window: opened after the first materialized batch,
    # closed at the last materialization.
    steady_from: float | None = None
    steady_steps_base = 0

    def report_pending():
        # Steps are queued asynchronously, so per-iteration wall time is
        # enqueue latency, not device time. Report to the hook only at
        # materialization points: the batch wall time divided over the
        # batch is the honest per-step duration.
        nonlocal pending_steps, last_hook_t, steady_from, steady_steps_base
        now_t = time.perf_counter()
        if step_hook is not None and pending_steps:
            step_hook(pending_steps, seconds=now_t - last_hook_t,
                      flops=hook_flops_per_step * pending_steps)
        pending_steps = 0
        last_hook_t = now_t
        if steady_from is None:
            steady_from = time.monotonic()
            steady_steps_base = steps

    pulse_edge = start + pulse_ms / 1000.0 if pulse_ms > 0 else None
    while time.monotonic() - start < seconds:
        if pulse_edge is not None and time.monotonic() >= pulse_edge:
            # Close the pulse: let the cards finish what is queued (an
            # async queue would smear the pulse), idle one pulse width,
            # reopen.
            synchronize(devices)
            inflight = 0
            report_pending()
            time.sleep(pulse_ms / 1000.0)
            pulse_edge = time.monotonic() + pulse_ms / 1000.0
        x = step(x, w)
        steps += 1
        inflight += 1
        pending_steps += 1
        # Bound the queue of launched work and wait for it before trusting
        # any rate: an unbounded launch loop measures enqueue rate, not
        # FLOPs.
        if inflight >= 32:
            synchronize(devices)
            inflight = 0
            report_pending()
        now = time.monotonic()
        if now - last_report >= report_every:
            synchronize(devices)
            inflight = 0
            report_pending()
            now = time.monotonic()
            rate = steps / (now - start)
            flops = flops_per_step * rate
            print(f"loadgen: {steps} steps, {rate:.1f} steps/s, "
                  f"~{flops / 1e12:.2f} TFLOP/s over {n_devices} device(s)",
                  flush=True)
            last_report = now
    synchronize(devices)
    report_pending()
    if result is not None:
        window = (time.monotonic() - steady_from
                  if steady_from is not None else 0.0)
        steady = steps - steady_steps_base
        if window > 0.05 and steady > 0:
            rate = steady / window
        else:
            # Fewer than one full materialization batch completed: no
            # steady window exists. Fall back to the whole-loop rate (the
            # first step is still excluded) rather than report 0.0.
            elapsed = time.monotonic() - start
            rate = steps / elapsed if elapsed > 0 and steps > 0 else 0.0
        result.update({
            "steps_per_s": rate,
            "tflops_per_s": flops_per_step * rate / 1e12,
            "devices": n_devices,
            "size": size,
            # depth shapes the torch chain only; a cuda row carrying it
            # would fake comparability between the two kernels' rows.
            "depth": depth if kernel == "torch" else None,
        })
    return steps


def sweep_burn(sizes=(1024, 2048, 4096, 8192), seconds_per_size: float = 6.0,
               depth: int = 16, kernel: str = "torch",
               deadline_seconds: float | None = None,
               device=None) -> list[dict]:
    """Size sweep: steady-state TFLOP/s (and MFU where every card's peak
    is known) per matmul size. Rising TFLOP/s with size means the burn
    was launch-bound at the small sizes. The MFU denominator is the sum
    of each card's own peak. ``deadline_seconds`` bounds the whole sweep;
    sizes that don't fit the remaining budget are skipped and marked."""
    from ..embedded import _kind_peak_flops

    kinds = [device_kind(dev) for dev in local_devices(device)]
    peaks = [_kind_peak_flops(kind) for kind in kinds]
    peak = sum(peaks) if all(peaks) else None
    start = time.monotonic()
    rows: list[dict] = []
    for size in sizes:
        if (deadline_seconds is not None
                and time.monotonic() - start > deadline_seconds):
            rows.append({"size": size, "skipped": "sweep deadline"})
            continue
        result: dict = {}
        try:
            run_burn(seconds_per_size, size, report_every=1e9,
                     kernel=kernel, depth=depth, result=result,
                     device=device)
        except Exception as exc:  # noqa: BLE001 - one size must not kill the sweep
            rows.append({"size": size, "error": f"{type(exc).__name__}: {exc}"})
            continue
        if peak:
            result["mfu_pct"] = round(
                100.0 * result["tflops_per_s"] * 1e12 / peak, 2)
        result["device_kind"] = kinds[0]
        rows.append(result)
    return rows


def main(argv=None, device=None) -> int:
    """The load generator's command line. ``device`` is for Python callers
    only (``"cpu"`` in the tests); the CLI always burns every card."""
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="GPU tensor-core load generator for exporter validation"
    )
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--size", type=int, default=4096,
                        help="matmul dimension (multiple of 128 for the "
                             "cuda kernel)")
    parser.add_argument("--depth", type=int, default=16,
                        help="matmuls chained per step of the torch kernel "
                             "(deeper amortizes launches over device time)")
    parser.add_argument("--sweep", default="",
                        help="comma-separated sizes (e.g. 1024,2048,4096,"
                             "8192): run a steady-state size sweep instead "
                             "of one burn and print a JSON row per size")
    parser.add_argument("--kernel", choices=("torch", "cuda"), default="torch")
    parser.add_argument("--pulse-ms", type=float, default=0.0,
                        help="duty-cycle the burn: burn PULSE_MS ms, "
                             "idle PULSE_MS ms, repeat; 0 = sustained burn")
    parser.add_argument("--mode", choices=("mxu",), default="mxu",
                        help="mxu: matmul burn")
    parser.add_argument("--embedded-port", type=int, default=None,
                        help="serve the embedded in-process exporter on "
                             "this port while burning (0 = pick a free "
                             "port, printed on stdout)")
    parser.add_argument("--embedded-textfile", default="",
                        help="embedded exporter textfile output dir")
    args = parser.parse_args(argv)
    exporter = None
    step_hook = None
    if args.embedded_port is not None:
        from .. import embedded

        exporter = embedded.start(
            args.embedded_port,
            textfile=args.embedded_textfile or None,
            device=device,
        )
        step_hook = exporter.record_step
        print(f"embedded-exporter-port: {exporter.port}", flush=True)
    try:
        if args.sweep:
            sizes = tuple(int(s) for s in args.sweep.split(","))
            for row in sweep_burn(sizes, seconds_per_size=args.seconds,
                                  depth=args.depth, kernel=args.kernel,
                                  device=device):
                print(json.dumps(row), flush=True)
        else:
            result: dict = {}
            run_burn(args.seconds, args.size, kernel=args.kernel,
                     step_hook=step_hook, depth=args.depth, result=result,
                     pulse_ms=args.pulse_ms, device=device)
            print(json.dumps({"steady_state": result}), flush=True)
    finally:
        if exporter is not None:
            exporter.stop()
    return 0
