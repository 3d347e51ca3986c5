"""Carry the JAX package's burn inputs and sharded-step weights into the
port.

The caller hands over numpy arrays (``np.asarray(jax_array)``). A JAX
bf16 array comes out with dtype ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so values go through float32, where every
bf16 value is exact, and back to bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def bf16_tensor(array, device) -> torch.Tensor:
    """A bf16 tensor on ``device`` holding the values of ``array``."""
    host = torch.from_numpy(np.asarray(array).astype(np.float32))
    return host.to(device=resolve_device(device), dtype=torch.bfloat16)


def from_jax_arrays(x, w, device):
    """The burn inputs (x of shape (n*size, size), w of shape
    (size, size)) as the port's (x_blocks, w): x split into its n row
    blocks of ``size`` rows, all on ``device``."""
    w_t = bf16_tensor(w, device)
    size = w_t.shape[0]
    if x.shape[0] % size:
        raise ValueError(f"x rows {x.shape[0]} are not a multiple of "
                         f"w's {size}")
    return list(bf16_tensor(x, device).split(size)), w_t


def sharded_train_params_from_jax(w1, w2, x, rank: int, n_devices: int,
                                  device):
    """The reference's full f32 (w1, w2, x) of ``make_sharded_train_step``
    (numpy arrays, ``np.asarray`` of the sharded JAX arrays) as rank
    ``rank``'s ``(params, x)`` of the port's step over ``n_devices``
    ranks: the shards ``NamedSharding`` gives that rank's device."""
    from .loadgen.burn import sharded_train_shards

    def f32(array) -> torch.Tensor:
        return torch.from_numpy(np.asarray(array, dtype=np.float32).copy())

    return sharded_train_shards(f32(w1), f32(w2), f32(x), rank, n_devices,
                                resolve_device(device))
