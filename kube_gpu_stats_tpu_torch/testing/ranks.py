"""Rank functions for ``loadgen.mesh.run_ranks`` that return what the
tests and the on-card smoke compare: each runs in a spawned rank, which
imports only the port, and returns numpy arrays or plain numbers.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..convert import sharded_train_params_from_jax
from ..loadgen.burn import make_sharded_train_step
from ..loadgen.ici_burn import make_ici_burn


def _device(device: str):
    return None if device == "cuda" else device


def train_step(rank: int, n_devices: int, device: str, arrays=None,
               widths: dict | None = None) -> dict:
    """One step of ``make_sharded_train_step`` at ``widths`` (its
    defaults when None). ``arrays``: the full (w1, w2, x) to start from,
    as numpy (the reference's); else the port's seeded ones. Returns this
    rank's mesh coordinates, its shards before and after, and the loss."""
    groups, step, params, x = make_sharded_train_step(
        n_devices, device=_device(device), **(widths or {}))
    if arrays is not None:
        params, x = sharded_train_params_from_jax(
            *arrays, rank, n_devices, groups.device)
    new_params, loss = step(params, x)

    def host(t):
        return t.detach().cpu().numpy()

    return {"data": groups.data_index, "model": groups.model_index,
            "dp": groups.dp, "tp": groups.tp, "loss": float(loss),
            "w1": host(params["w1"]), "w2": host(params["w2"]),
            "x": host(x), "new_w1": host(new_params["w1"]),
            "new_w2": host(new_params["w2"])}


def ring(rank: int, n_devices: int, device: str, shard_mb: float,
         steps: int) -> tuple[np.ndarray, np.ndarray]:
    """This rank's shard before and after one call of the ring."""
    fn, x = make_ici_burn(n_devices, shard_mb=shard_mb, steps=steps,
                          device=_device(device))
    before = x.cpu().numpy().copy()
    return before, fn(x).cpu().numpy()


def one_card_per_process(rank: int, n_devices: int, size: int,
                         seconds: float) -> dict:
    """The embedded collector and the burn under one process per card,
    on the CPU: which cards a process owns when CUDA is made to look
    present (``n_devices`` cards, this rank's current), and the per-card
    FLOPs the collector serves for this rank's own burn."""
    from .. import embedded
    from ..device import local_devices, one_card_per_process as one_each
    from ..loadgen.burn import run_burn

    os.environ["LOCAL_WORLD_SIZE"] = str(n_devices)
    real = (torch.cuda.is_available, torch.cuda.device_count,
            torch.cuda.current_device)
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: n_devices
    torch.cuda.current_device = lambda: rank
    try:
        owned = [(d.type, d.index) for d in local_devices()]
    finally:
        (torch.cuda.is_available, torch.cuda.device_count,
         torch.cuda.current_device) = real
    collector = embedded.TorchIntrospectCollector(device="cpu")
    steps = run_burn(seconds=seconds, size=size, depth=2,
                     report_every=1e9, step_hook=collector.record_step,
                     device="cpu")
    collector.begin_tick()
    (dev,) = collector.discover()
    served = collector.sample(dev).values["accelerator_workload_flops_total"]
    return {"one_each": one_each(), "owned": owned, "steps": steps,
            "served_flops": served, "own_flops": 2.0 * 2 * size**3 * steps}


def fail_on(rank: int, n_devices: int, bad_rank: int) -> None:
    """Rank ``bad_rank`` raises; the others wait for it in a barrier that
    never completes: the caller must fail, not hang."""
    import torch.distributed as dist

    if rank == bad_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()
