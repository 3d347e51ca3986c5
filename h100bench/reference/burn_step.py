"""Plain reference of the burn step, and its lower-precision control.

The burn step the program runs is ``bf16(tanh(x @ w))`` for bf16 ``x`` and
``w``: the product of exact bf16 values summed in float32 (the tiled GEMM),
then tanh in float32 and a cast to bf16 (the epilogue). The reference
computes ``tanh(x @ w)`` in float32 with plain ``torch`` and TF32 off, so
the only gap a sound step leaves is the bf16 rounding of its output and the
order of the float32 sums. The control takes the step one precision down,
to fp8 (e4m3) inputs, the step a faster kernel would be tempted to take.

Imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def step(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``tanh(x @ w)`` of the bf16 inputs, TF32 off."""
    with _no_tf32():
        return torch.tanh(x.float() @ w.float())


def control_step(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The step with fp8 (e4m3) inputs, products summed in float32, and
    the program's bf16 output: what an fp8 GEMM in the program's place
    would serve."""
    fp8 = torch.float8_e4m3fn
    with _no_tf32():
        acc = x.to(fp8).float() @ w.to(fp8).float()
    return torch.tanh(acc).to(torch.bfloat16)


def widest_gap(served: torch.Tensor, reference: torch.Tensor,
               rows: int = 1024) -> float:
    """The largest ``|served - reference|`` over all elements, taken in
    blocks of ``rows`` rows."""
    gap = 0.0
    for start in range(0, served.shape[0], rows):
        block = served[start:start + rows].float() - reference[start:start + rows]
        gap = max(gap, block.abs().max().item())
    return gap


def step_gaps(pairs) -> list[float]:
    """The widest gap of each served (input, output) pair against the
    reference's step; ``pairs`` holds (x, w, served output)."""
    return [widest_gap(out, step(x, w)) for x, w, out in pairs]


def control_gaps(pairs) -> list[float]:
    """The control's widest gap on the same inputs as ``step_gaps``."""
    return [widest_gap(control_step(x, w), step(x, w)) for x, w, _ in pairs]
