"""The tiled GEMM kernel on the card (sm_90a) against its plain version.

Marked ``cuda``: these skip without a compute-capability-9.0 card. On
one, run them with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
This file imports no JAX, so it also runs where JAX is not installed.
"""

import pytest
import torch

from kube_gpu_stats_tpu_torch.device import is_hopper
from kube_gpu_stats_tpu_torch.loadgen import tiled_burn

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is False")
    if not is_hopper("cuda"):
        pytest.skip("needs compute capability 9.0 (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.bfloat16)


@pytest.mark.parametrize("m,k,n,tiles", [
    (256, 512, 384, dict(tile_m=128, tile_n=128, tile_k=128)),
    (128, 1024, 128, dict(tile_m=128, tile_n=128, tile_k=256)),
    (384, 384, 384, {}),
    (1024, 2048, 512, {}),
])
def test_kernel_matches_plain_version(card, m, k, n, tiles):
    a = _randn((m, k), 0, card)
    b = _randn((k, n), 1, card)
    before = tiled_burn.launches
    got = tiled_burn.tiled_matmul(a, b, **tiles)
    want = tiled_burn.tiled_matmul_reference(a, b)
    torch.cuda.synchronize()
    assert tiled_burn.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    # Same exact bf16 products, f32 sums in another order.
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


def test_kernel_rejects_what_it_cannot_take(card):
    a = torch.zeros((256, 256), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tiled_burn.tiled_matmul(a.t()[:128], a[:, :128].contiguous())
    with pytest.raises(TypeError, match="bf16"):
        tiled_burn.tiled_matmul(a.float(), a.float())
    with pytest.raises(ValueError, match="one CUDA device"):
        tiled_burn.tiled_matmul(a, a.cpu())


def test_burn_step_on_the_card(card):
    step, xs, ws, n, flops = tiled_burn.tiled_all_device_burn(512, card)
    assert n == 1 and flops == 2 * 512**3
    out = step(xs, ws)
    torch.cuda.synchronize()
    want = torch.tanh(tiled_burn.tiled_matmul_reference(xs[0], ws[0]))
    assert out[0].dtype == torch.bfloat16
    assert (out[0].float() - want).abs().max().item() <= 1e-2
