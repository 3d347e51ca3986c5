"""Flagship entry point of the port — the counterpart of ``__graft_entry__.entry()``.

entry(): the single-card forward step of the flagship workload (the
loadgen burn) at size 512, on the card unless ``device="cpu"``. The
multi-card dry run comes with the multi-GPU slice.
"""

from __future__ import annotations

from .loadgen.burn import entry_fn


def entry(device=None):
    return entry_fn(size=512, device=device)
