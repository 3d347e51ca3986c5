"""The tiled GEMM kernel on the card (sm_90a) against its plain version,
and the embedded collector's memory and MFU on the card.

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


def _assert_matches_plain(got, a, b):
    want = tiled_burn.tiled_matmul_reference(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    # Same exact bf16 products, f32 sums in another order.
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("m,k,n,tiles", [
    (256, 512, 384, dict(tile_m=128, tile_n=128, tile_k=128)),
    (128, 1024, 128, dict(tile_m=128, tile_n=128, tile_k=256)),
    (384, 384, 384, {}),      # the 128-wide instance
    (1024, 2048, 512, {}),
    (128, 128, 128, {}),      # K shorter than the ring
    # 9 x 10 tiles of 128 x 128 on a partial wave; 10 K stages, not a
    # multiple of the ring's 6
    (1152, 640, 1280, {}),
    # 512 wide tiles on 132 blocks: the ring's barrier phases carry on
    # across the tiles of a block
    (4096, 4096, 4096, {}),
])
def test_kernel_matches_plain_version(card, m, k, n, tiles):
    a = _randn((m, k), 0, card)
    b = _randn((k, n), 1, card)
    before = tiled_burn.launches
    got = tiled_burn.tiled_matmul(a, b, **tiles)
    assert tiled_burn.launches == before + 1
    _assert_matches_plain(got, a, b)


def test_back_to_back_launches_on_new_inputs(card):
    pairs = [(_randn((2048, 1024), 2 + i, card),
              _randn((1024, 1536), 4 + i, card)) for i in range(2)]
    outs = [tiled_burn.tiled_matmul(a, b) for a, b in pairs]
    for (a, b), got in zip(pairs, outs):
        _assert_matches_plain(got, a, b)


def test_plan_mirror_matches_the_kernel(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for m, n in [(128, 128), (384, 384), (1024, 1024), (1152, 1280),
                 (2048, 1536), (4096, 4096), (8192, 8192)]:
        assert tiled_burn.kernel_plan(m, n, sms) == tiled_burn.gemm_plan(
            m, n, sms)


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


class _Clock:
    """Stands in for the ``time`` module inside embedded.py."""

    now = 10.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


def test_embedded_collector_reports_card_memory(card):
    from kube_gpu_stats_tpu_torch import embedded, schema

    col = embedded.TorchIntrospectCollector("cuda:0")
    (dev,) = col.discover()
    assert dev.accel_type == "gpu-h100"
    assert dev.device_path.startswith("/dev/nvidia") or dev.device_path[:4] in (
        "GPU-", "MIG-")
    held = torch.empty(256 << 20, dtype=torch.uint8, device="cuda:0")
    col.begin_tick()
    values = col.sample(dev).values
    used = values[schema.MEMORY_USED.name]
    total = values[schema.MEMORY_TOTAL.name]
    assert used >= held.numel()
    assert used <= total == torch.cuda.mem_get_info(0)[1]
    assert values[schema.MEMORY_PEAK.name] >= used
    del held


def test_embedded_collector_mfu_against_the_h100_peak(card, monkeypatch):
    from kube_gpu_stats_tpu_torch import embedded, schema

    clock = _Clock()
    monkeypatch.setattr(embedded, "time", clock)
    col = embedded.TorchIntrospectCollector("cuda:0")
    (dev,) = col.discover()
    col.record_step(1, seconds=0.5, flops=1e12)
    col.begin_tick()
    clock.now += 2.0
    col.record_step(1, seconds=0.5, flops=989e12)
    col.begin_tick()
    values = col.sample(dev).values
    assert values[schema.PEAK_FLOPS.name] == 989e12
    # 989e12 FLOPs over a 2 s window on one card: 50% of the peak.
    assert values[schema.WORKLOAD_MFU.name] == pytest.approx(50.0, rel=1e-12)
