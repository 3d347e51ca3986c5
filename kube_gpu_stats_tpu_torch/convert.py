"""Carry the JAX package's burn inputs into the port.

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
