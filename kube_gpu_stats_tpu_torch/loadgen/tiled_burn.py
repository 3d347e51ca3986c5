"""Hand-written CUDA burn kernel — the port of the Pallas variant of the
load generator (``kube_gpu_stats_tpu/loadgen/pallas_burn.py``).

``tiled_matmul`` computes f32 ``a @ b`` for bf16 ``a`` and ``b`` through the
sm_90a GEMM in ``csrc/tiled_gemm.cu`` (wgmma, a 4- or 6-stage TMA/mbarrier
ring, persistent blocks), under the Pallas kernel's contract: dims are
multiples of 128, the public tile sizes snap to 128-multiple divisors and
are validated by the same rules, and a bad shape raises ``ValueError``. The
tiles are validated for parity only: the Hopper kernel picks its own block
shape, 128x256 or 128x128 (``gemm_plan``).

A CPU tensor takes the plain version, ``tiled_matmul_reference``; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..device import is_hopper, per_device

# Kernel launches since the counter was last set to 0 (one per launch).
launches = 0

# M blocks per group of the kernel's tile order (kGroupM in the source).
GROUP_M = 8


def _snap_tile(requested: int, dim: int) -> int:
    """Largest multiple of 128 that divides `dim` and is <= `requested` —
    any 128-multiple dim gets a legal tile, not just multiples of the
    default tile sizes."""
    tile = min(requested, dim)
    tile -= tile % 128
    while tile >= 128 and dim % tile:
        tile -= 128
    return tile


def tiled_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: exact bf16 products summed in f32."""
    return a.float() @ b.float()


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *, tile_m: int = 256,
                 tile_n: int = 256, tile_k: int = 512) -> torch.Tensor:
    """f32 = a @ b with bf16 inputs through the tiled kernel.
    Dims must be multiples of 128."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    tiles = (_snap_tile(tile_m, m), _snap_tile(tile_n, n),
             _snap_tile(tile_k, k))
    # A snapped tile of at least 128 divides its dim, so this one check
    # also rejects every dim that is not a multiple of 128.
    if min(tiles) < 128:
        raise ValueError(f"tiles must be >=128 and divide their dims: "
                         f"shape {(m, k, n)}, snapped tiles {tiles}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"bf16 inputs required, got {a.dtype} @ {b.dtype}")
    if a.device.type == "cpu":
        return tiled_matmul_reference(a, b)
    return _launch(a, b)


def gemm_plan(m: int, n: int, sms: int) -> tuple[int, int]:
    """(block_n, grid) the kernel launches with for an (m, k) @ (k, n)
    product on a card of ``sms`` SMs: the mirror of ``gemm_plan`` in
    ``csrc/tiled_gemm.cu``, which ``kernel_plan`` asks on the card.

    Block tiles are 128 x block_n; the grid is persistent, at most one block
    per SM. The 256-wide instance needs n % 256 == 0 and is taken unless its
    tiles, twice the work each, would leave its busiest block more than half
    the 128-wide instance's share to do (1024^3: 32 tiles against 64)."""
    tiles_128 = m // 128 * (n // 128)
    tiles_256 = 0 if n % 256 else m // 128 * (n // 256)
    wide = tiles_256 > 0 and 2 * -(-tiles_256 // sms) <= -(-tiles_128 // sms)
    tiles = tiles_256 if wide else tiles_128
    return (256 if wide else 128), min(tiles, sms)


def tile_coords(t: int, num_m: int, num_n: int) -> tuple[int, int]:
    """(m_blk, n_blk) of tile ``t`` in the kernel's grouped order: GROUP_M
    M blocks at a time, each group walked column by column. Block ``b`` of
    the persistent grid takes tiles b, b + grid, b + 2 * grid, ..."""
    per_group = GROUP_M * num_n
    first_m = t // per_group * GROUP_M
    rows = min(num_m - first_m, GROUP_M)
    r = t % per_group
    return first_m + r % rows, r // rows


def kernel_plan(m: int, n: int, sms: int) -> tuple[int, int]:
    """The compiled kernel's own (block_n, grid), to hold ``gemm_plan``
    against on the card."""
    fn = _build.load_library().kts_tiled_gemm_plan
    fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))
    fn.restype = ctypes.c_int
    block_n, grid = ctypes.c_int(), ctypes.c_int()
    rc = fn(m, n, sms, ctypes.byref(block_n), ctypes.byref(grid))
    if rc != 0:
        raise ValueError(f"no plan for m={m}, n={n}: CUDA error {rc}")
    return block_n.value, grid.value


@functools.cache
def _kernel():
    fn = _build.load_library().kts_tiled_gemm_bf16_f32
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    return fn


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"a and b must lie on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be row-major contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned")
    if not is_hopper(a.device):
        raise RuntimeError(
            f"the tiled GEMM kernel is built for sm_90a; {a.device} has "
            f"compute capability {torch.cuda.get_device_capability(a.device)}")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _kernel()(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                       stream)
    if rc != 0:
        raise RuntimeError(f"tiled GEMM launch failed with CUDA error {rc}")
    launches += 1
    return c


def _block_step(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # A fresh output buffer: tile (i, j) of the product lands in row block i
    # of x while the other tiles of that row block still read it, so an
    # in-place write would race. The tanh epilogue stays outside the kernel,
    # as jnp.tanh stayed outside the pallas_call.
    return torch.tanh(tiled_matmul(x, w)).to(torch.bfloat16)


# One burn step over every device's (x, w) block pair.
tiled_burn_step = per_device(_block_step)


def tiled_all_device_burn(size: int = 1024, device=None):
    """Tiled-kernel burn over EVERY local card: one (size, size) bf16 block
    of x per card and w copied to each, the kernel plus its tanh epilogue on
    each card's current stream, no collectives — the same inputs as
    burn.make_all_device_burn, so the two kernels differ only in who
    computes the product.

    Returns (step, x_blocks, w_blocks, n_devices, flops_per_step);
    ``step(x_blocks, w_blocks)`` returns the next x blocks.
    """
    from .burn import all_device_burn_inputs

    _, x_blocks, w_blocks, n = all_device_burn_inputs(size, device)
    return tiled_burn_step, x_blocks, w_blocks, n, 2 * n * size**3
