"""The process-group layer of the multi-card load generator: the port's
stand-in for the ("data", "model") ``jax.sharding.Mesh`` of
``kube_gpu_stats_tpu/loadgen/burn.py``.

One process (rank) per device. Rank r sits at mesh coordinates
``(r // tp, r % tp)``, exactly where ``np.asarray(devices).reshape(dp,
tp)`` puts device r. Two families of subgroups carry the collectives:
the *model* group of a rank holds the ranks of its mesh row (same data
coordinate), the *data* group the ranks of its mesh column (same model
coordinate).

The backend is NCCL on the card (rank r drives ``cuda:r``) and gloo with
``device="cpu"``. :func:`run_ranks` starts the ranks as spawned
processes, joins every one within a deadline and raises if any failed.
"""

from __future__ import annotations

import atexit
import dataclasses
import multiprocessing
import multiprocessing.resource_tracker
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device

# How long run_ranks waits for its ranks by default: a rank that hangs
# (a peer died inside a collective) fails the call instead of hanging it.
RANK_TIMEOUT_S = 600.0
# After one rank failed, how long the others get to report and exit.
FAILURE_GRACE_S = 5.0


def _mesh_shape(n_devices: int) -> tuple[int, int]:
    """(data, model) factorization: model axis gets the largest power-of-2
    divisor up to 4 (matches one-host chip counts), data gets the rest."""
    model = 1
    while model < 4 and n_devices % (model * 2) == 0:
        model *= 2
    return n_devices // model, model


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """This rank's place in the (data, model) mesh and its two subgroups
    (``data_group`` spans the "data" axis, ``model_group`` the "model"
    axis)."""

    dp: int
    tp: int
    rank: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    device: torch.device


def mesh_groups(n_devices: int, device: torch.device) -> MeshGroups:
    """The mesh over the process group's ranks, which must number
    ``n_devices``. Every rank creates every subgroup, in the same order
    (``dist.new_group`` is collective over the world)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is up; start the ranks with "
                           "mesh.run_ranks or init_process_group")
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"need {n_devices} ranks, the group has {world}")
    dp, tp = _mesh_shape(n_devices)
    rank = dist.get_rank()
    data_index, model_index = divmod(rank, tp)
    model_group = data_group = None
    for row in range(dp):
        group = dist.new_group([row * tp + col for col in range(tp)])
        if row == data_index:
            model_group = group
    for col in range(tp):
        group = dist.new_group([row * tp + col for row in range(dp)])
        if col == model_index:
            data_group = group
    return MeshGroups(dp=dp, tp=tp, rank=rank, data_index=data_index,
                      model_index=model_index, data_group=data_group,
                      model_group=model_group, device=device)


def rank_device(device=None) -> torch.device:
    """This rank's device: the current card (``torch.cuda.set_device`` by
    whoever started the rank) for ``None``, else the one named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def init_rank(rank: int, world_size: int, init_method: str,
              device: str) -> torch.device:
    """Join the process group as ``rank``: NCCL on card ``rank`` for
    ``device="cuda"``, gloo for ``device="cpu"``. Returns the rank's
    device."""
    if device == "cuda":
        resolve_device("cuda")
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
        # A CPU rank stands for one device: one intra-op thread each, so
        # n ranks do not oversubscribe the host's cores.
        torch.set_num_threads(1)
    else:
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or "
                         f"'cpu')")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               fn, args: tuple, results) -> None:
    try:
        init_rank(rank, world_size, init_method, device)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def stop_resource_tracker() -> None:
    """Stop and reap the resource tracker that spawning the ranks started.

    A spawned child needs multiprocessing's tracker process. Older
    Pythons (3.12.3 among them) do not stop it at exit: it outlives this
    process until it notices the closed pipe, so a caller that waits for
    every process it started finds it still running. Registered to run
    at exit once ranks were spawned."""
    multiprocessing.resource_tracker._resource_tracker._stop()


def run_ranks(fn, n_ranks: int, *, device: str, args: tuple = (),
              timeout: float = RANK_TIMEOUT_S) -> list:
    """Run ``fn(rank, n_ranks, *args)`` in ``n_ranks`` spawned processes
    joined in one process group (NCCL on the card, one rank per card;
    gloo with ``device="cpu"``). Returns each rank's result, by rank.

    ``fn`` must be importable by name (the children start from a fresh
    interpreter); its result and ``args`` are pickled. Raises
    ``RuntimeError`` naming every rank that failed, exited without a
    result or outlived ``timeout``; no rank is left running, nor, once
    this process exits, the tracker the spawn started."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"{n_ranks} ranks need {n_ranks} cards, "
                         f"{torch.cuda.device_count()} visible")
    ctx = multiprocessing.get_context("spawn")
    atexit.unregister(stop_resource_tracker)
    atexit.register(stop_resource_tracker)
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="kts-ranks-")
    init_method = f"file://{os.path.join(store_dir, 'store')}"
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, n_ranks, init_method, dev.type, fn,
                               args, results),
                         name=f"kts-rank-{rank}")
             for rank in range(n_ranks)]
    got: dict[int, tuple[bool, object]] = {}
    try:
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        # Drain the results before joining: a child blocks on exit until
        # what it put on the queue has been read. After a failure the
        # survivors may wait on the failed rank forever: a short grace
        # for their reports, then the kill below.
        while len(got) < n_ranks and time.monotonic() < deadline:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                if not any(proc.is_alive() for proc in procs):
                    break
                continue
            got[rank] = (ok, out)
            if not ok:
                deadline = min(deadline, time.monotonic() + FAILURE_GRACE_S)
        for proc in procs:
            proc.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    failures = [f"rank {rank}: {out}" for rank, (ok, out) in sorted(
        got.items()) if not ok]
    failures += [f"rank {rank}: exited {procs[rank].exitcode} without a "
                 f"result" for rank in range(n_ranks) if rank not in got]
    failures += [f"rank {rank}: exited {proc.exitcode}"
                 for rank, proc in enumerate(procs)
                 if rank in got and got[rank][0] and proc.exitcode != 0]
    if failures:
        raise RuntimeError(f"{len(failures)} of {n_ranks} rank(s) failed:\n"
                           + "\n".join(failures))
    return [got[rank][1] for rank in range(n_ranks)]
