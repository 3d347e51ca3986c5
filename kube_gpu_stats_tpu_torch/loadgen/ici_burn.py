"""NVLink ring burn: drives card-to-card traffic so the exporter's
``accelerator_ici_link_*`` series (the NVML backend's ``nvlink<N>``
counters) visibly move during validation on a multi-card node. The port
of ``kube_gpu_stats_tpu/loadgen/ici_burn.py``.

A ring of rotations over the process group, one rank per card: each hop
every rank sends its whole shard to rank + 1 and receives rank - 1's,
with one ``dist.batch_isend_irecv``, then adds 1 so nothing can elide
the chain. NCCL carries the hops over NVLink on the card; gloo carries
them on the CPU, where the tests hold the numerics against the
reference's ``ppermute`` ring.

Everything runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..device import resolve_device, synchronize
from .mesh import rank_device, run_ranks

# Ranks agree to stop only at these rounds: a rank that left the ring
# while its neighbour still waited on it would hang the neighbour.
AGREE_EVERY = 8


def make_ici_burn(n_devices: int, *, shard_mb: float = 4.0, steps: int = 8,
                  device=None):
    """Returns (fn, x) for THIS rank of an ``n_devices``-rank process
    group: ``fn`` rotates the ring's shards ``steps`` times, adding 1
    each hop; ``x`` is this rank's shard of ``arange(total)``.

    ``fn`` works in place on two buffers it swaps (no allocation per
    round), so, as the reference's donated input: rebind ``x = fn(x)``;
    the buffer passed in becomes the spare. At one rank the reference's
    ring is ``perm=[(0, 0)]``, the identity: the hop is a copy on the
    device, with no send to itself (gloo refuses one, and NCCL's is not
    relied on)."""
    dev = rank_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group is up; start the ranks with "
                           "mesh.run_ranks or init_process_group")
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"need {n_devices} ranks, the group has {world}")
    rank = dist.get_rank()
    floats_per_shard = max(128, int(shard_mb * 1024 * 1024 / 4) // 128 * 128)
    x = torch.arange(rank * floats_per_shard, (rank + 1) * floats_per_shard,
                     dtype=torch.float32, device=dev)
    spare = torch.empty_like(x)
    to_peer, from_peer = (rank + 1) % n_devices, (rank - 1) % n_devices

    def hop(src: torch.Tensor, dst: torch.Tensor) -> None:
        if n_devices == 1:
            dst.copy_(src)
            return
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, to_peer),
                dist.P2POp(dist.irecv, dst, from_peer)]):
            req.wait()

    def fn(x: torch.Tensor) -> torch.Tensor:
        nonlocal spare
        for _ in range(steps):
            hop(x, spare)
            spare.add_(1.0)
            x, spare = spare, x
        return x

    return fn, x


def _stop_agreed(x: torch.Tensor, stop: bool) -> bool:
    """True when any rank wants to stop: every rank then leaves the ring
    after the same round."""
    if dist.get_world_size() == 1:
        return stop
    flag = torch.tensor([float(stop)], device=x.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def run_ici_burn(seconds: float = 10.0, *, n_devices: int | None = None,
                 shard_mb: float = 4.0, steps: int = 8,
                 report_every: float = 1.0, device=None,
                 result: dict | None = None) -> int:
    """Rotate the ring for ``seconds``; returns the rounds run (one round
    is ``steps`` hops).

    Inside a process group this rank joins the ring of ``n_devices`` (the
    world by default). With no group up it starts one: one rank per
    visible card over NCCL, or ``n_devices`` (default 1) gloo ranks with
    ``device="cpu"`` (``mesh.run_ranks``), and returns rank 0's rounds.
    Rank 0 prints the reference's report line. ``result``, when given,
    receives {"rounds", "seconds", "rounds_per_s", "bytes_per_round",
    "gb_per_s", "devices"} (rank 0's)."""
    if not dist.is_initialized():
        dev = resolve_device(device)
        n = n_devices or (torch.cuda.device_count() if dev.type == "cuda"
                          else 1)
        rounds, measured = run_ranks(
            _ici_rank, n, device=dev.type,
            args=(dev.type, seconds, shard_mb, steps, report_every))[0]
        if result is not None:
            result.update(measured)
        return rounds
    n = n_devices or dist.get_world_size()
    fn, x = make_ici_burn(n, shard_mb=shard_mb, steps=steps, device=device)
    # The reference's x is the whole ring; every shard moves each hop.
    bytes_per_round = x.nbytes * n * steps
    verbose = dist.get_rank() == 0
    x = fn(x)  # first use + one real execution
    synchronize([x.device])
    rounds = 0
    start = time.monotonic()
    last_report = start
    while True:
        x = fn(x)
        rounds += 1
        if rounds % AGREE_EVERY == 0:
            synchronize([x.device])  # force execution; see burn.py rationale
            if _stop_agreed(x, time.monotonic() - start >= seconds):
                break
        now = time.monotonic()
        if verbose and now - last_report >= report_every:
            synchronize([x.device])
            now = time.monotonic()
            rate = rounds / (now - start)
            print(f"ici-burn: {rounds} rounds, {rate:.1f}/s, "
                  f"~{bytes_per_round * rate / 1e9:.2f} GB/s ring traffic "
                  f"({n} devices)", flush=True)
            last_report = now
    synchronize([x.device])
    elapsed = time.monotonic() - start
    if result is not None:
        rate = rounds / elapsed
        result.update({"rounds": rounds, "seconds": elapsed,
                       "rounds_per_s": rate,
                       "bytes_per_round": bytes_per_round,
                       "gb_per_s": bytes_per_round * rate / 1e9,
                       "devices": n})
    return rounds


def _ici_rank(rank: int, world: int, device: str, seconds: float,
              shard_mb: float, steps: int, report_every: float):
    """One rank of a ring that ``run_ici_burn`` started; ``device`` is
    "cuda" (this rank's card) or "cpu"."""
    measured: dict = {}
    rounds = run_ici_burn(seconds, n_devices=world, shard_mb=shard_mb,
                          steps=steps, report_every=report_every,
                          result=measured,
                          device=None if device == "cuda" else device)
    return rounds, measured
