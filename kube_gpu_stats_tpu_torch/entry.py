"""Flagship entry points of the port — the counterparts of
``__graft_entry__``'s ``entry()`` and ``dryrun_multichip(n)``.

entry(): the single-card forward step of the flagship workload (the
loadgen burn) at size 512, on the card unless ``device="cpu"``.

dryrun_multichip(n): one step of the FULL sharded load-generator training
step (data-parallel batch x tensor-parallel MLP over a ("data", "model")
mesh of ranks) on tiny shapes, in ``n`` spawned ranks: one per card over
NCCL, or ``n`` gloo ranks with ``device="cpu"``.
"""

from __future__ import annotations

from .device import resolve_device
from .loadgen.burn import entry_fn, make_sharded_train_step


def entry(device=None):
    return entry_fn(size=512, device=device)


def _dryrun_rank(rank: int, n_devices: int, device: str) -> float:
    """One rank of the dry run: one step, its loss checked as the
    reference's dry run checks it."""
    _, train_step, params, x = make_sharded_train_step(
        n_devices, d_model=64, d_hidden=128, batch=32,
        device=None if device == "cuda" else device)
    _, loss = train_step(params, x)
    loss = float(loss)
    if not loss > 0.0:
        raise RuntimeError(f"rank {rank}: loss {loss} is not positive")
    return loss


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Raises unless every rank's step ran and its loss is positive. On the
    card ``n_devices`` may not exceed the visible cards."""
    from .loadgen.mesh import run_ranks

    dev = resolve_device(device)
    run_ranks(_dryrun_rank, n_devices, device=dev.type, args=(dev.type,))
