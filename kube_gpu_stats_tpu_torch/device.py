"""Device resolution: the port runs on the CUDA card unless asked for the CPU."""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Raises ``RuntimeError`` when CUDA is
    asked for and absent: the port never carries on quietly on the CPU."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


def one_card_per_process() -> bool:
    """True under a launch of one process per card (torchrun and its
    kind): a process group is up and ``LOCAL_WORLD_SIZE`` > 1. Each
    process then owns its current card only, as a JAX process owns
    ``jax.local_devices()``."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1)


def local_devices(device=None) -> list[torch.device]:
    """The cards this process owns for ``None`` or a bare ``"cuda"``:
    every visible card, or only the current one under one process per
    card (:func:`one_card_per_process`). Else the one device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if one_card_per_process():
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def is_hopper(device) -> bool:
    """True for a CUDA device of compute capability 9.0 (sm_90a), the only
    target the hand-written kernels are built for."""
    dev = torch.device(device)
    return (dev.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.get_device_capability(dev) == (9, 0))


def device_kind(device: torch.device) -> str:
    return "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)


def on_device(device: torch.device):
    """Make ``device`` current for the block (a no-op on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def synchronize(devices) -> None:
    """Wait for all queued work on each card; a no-op on the CPU, where
    PyTorch runs synchronously."""
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def mark(devices) -> list:
    """An event after the work queued so far on each card's current
    stream; none on the CPU, where the work is already done."""
    events = []
    for dev in devices:
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
    return events


def per_device(block_fn):
    """Step over one (x, w) block pair per device: each block runs
    ``block_fn`` on its own device's current stream, with no collectives."""

    def step(x_blocks, w_blocks):
        out = []
        for x, w in zip(x_blocks, w_blocks, strict=True):
            with on_device(x.device):
                out.append(block_fn(x, w))
        return out

    return step
