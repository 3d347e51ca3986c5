"""The port's tiled GEMM module against the JAX package's Pallas kernel.

Both sides get the same inputs, made with numpy from a seed. On the CPU
the port's wrapper takes its plain version; the Pallas kernel runs in
interpret mode, as tests/test_pallas_burn.py runs it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kube_gpu_stats_tpu.loadgen import pallas_burn  # noqa: E402
from kube_gpu_stats_tpu_torch.convert import (bf16_tensor,  # noqa: E402
                                              from_jax_arrays)
from kube_gpu_stats_tpu_torch.device import is_hopper  # noqa: E402
from kube_gpu_stats_tpu_torch.loadgen import tiled_burn  # noqa: E402

# (seed, m, k, n, tiles): the three cases of tests/test_pallas_burn.py —
# explicit 128 tiles, K over several tile steps, default tiles that snap.
CASES = [
    (0, 256, 512, 384, dict(tile_m=128, tile_n=128, tile_k=128)),
    (1, 128, 1024, 128, dict(tile_m=128, tile_n=128, tile_k=256)),
    (2, 384, 384, 384, {}),
]


@pytest.mark.parametrize("seed,m,k,n,tiles", CASES)
def test_tiled_matmul_matches_pallas(seed, m, k, n, tiles):
    rng = np.random.RandomState(seed)
    a = jnp.asarray(rng.randn(m, k), dtype=jnp.bfloat16)
    b = jnp.asarray(rng.randn(k, n), dtype=jnp.bfloat16)
    want = np.asarray(pallas_burn.pallas_matmul(a, b, interpret=True, **tiles))
    got = tiled_burn.tiled_matmul(bf16_tensor(a, "cpu"),
                                  bf16_tensor(b, "cpu"), **tiles)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (m, n)
    # Both sum exact bf16 products in f32; only the order of the sums
    # differs (2.3e-5 at most, measured at 256x512x384).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=5e-4)


@pytest.mark.parametrize("dim", [128, 256, 384, 640, 1024, 1152, 4096])
def test_snap_tile_matches_reference(dim):
    for requested in (64, 100, 127, 128, 200, 256, 384, 512, 1000, 8192):
        assert (tiled_burn._snap_tile(requested, dim)
                == pallas_burn._snap_tile(requested, dim)), (requested, dim)


@pytest.mark.parametrize("a_shape,b_shape,tiles", [
    ((128, 128), (256, 128), {}),                # K mismatch
    ((100, 128), (128, 128), dict(tile_m=100)),  # tile under 128
    ((128, 200), (200, 128), {}),                # dim not a multiple of 128
])
def test_value_errors_match_reference(a_shape, b_shape, tiles):
    with pytest.raises(ValueError):
        pallas_burn.pallas_matmul(jnp.zeros(a_shape, jnp.bfloat16),
                                  jnp.zeros(b_shape, jnp.bfloat16),
                                  interpret=True, **tiles)
    with pytest.raises(ValueError):
        tiled_burn.tiled_matmul(torch.zeros(a_shape, dtype=torch.bfloat16),
                                torch.zeros(b_shape, dtype=torch.bfloat16),
                                **tiles)


def test_non_bf16_inputs_rejected():
    with pytest.raises(TypeError, match="bf16"):
        tiled_burn.tiled_matmul(torch.zeros((128, 128)),
                                torch.zeros((128, 128)))


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    rng = np.random.RandomState(3)
    a = bf16_tensor(rng.randn(128, 256), "cpu")
    b = bf16_tensor(rng.randn(256, 128), "cpu")
    before = tiled_burn.launches
    got = tiled_burn.tiled_matmul(a, b)
    assert tiled_burn.launches == before
    assert torch.equal(got, tiled_burn.tiled_matmul_reference(a, b))


def test_hopper_probe_is_false_off_the_card():
    assert not is_hopper("cpu")
    assert not is_hopper(torch.device("cpu"))


def test_all_device_step_matches_pallas_burn():
    """The whole slice: the JAX package's per-device Pallas burn step over
    the 8-device CPU mesh against the port's per-block step on the same
    inputs, carried across by convert.from_jax_arrays."""
    step, x, w, n, flops = pallas_burn.pallas_all_device_burn(size=128)
    x_np, w_np = np.asarray(x), np.asarray(w)  # before the donating call
    want = np.asarray(step(x, w).astype(jnp.float32))
    x_blocks, w_t = from_jax_arrays(x_np, w_np, "cpu")
    assert len(x_blocks) == n
    got = tiled_burn.tiled_burn_step(x_blocks, [w_t] * n)
    for i, block in enumerate(got):
        assert block.dtype == torch.bfloat16
        # One bf16 ulp of the tanh output.
        np.testing.assert_allclose(block.float().numpy(),
                                   want[i * 128:(i + 1) * 128], atol=1e-2,
                                   rtol=0)


def test_tiled_all_device_burn_contract():
    step, x_blocks, w_blocks, n, flops = tiled_burn.tiled_all_device_burn(
        size=128, device="cpu")
    _, _, _, jax_n, jax_flops = pallas_burn.pallas_all_device_burn(size=128)
    assert n == 1 and len(x_blocks) == len(w_blocks) == 1
    assert flops == 2 * n * 128**3 and jax_flops == 2 * jax_n * 128**3
    out = step(x_blocks, w_blocks)
    assert out[0].shape == (128, 128) and out[0].dtype == torch.bfloat16
    assert torch.isfinite(out[0].float()).all()


def test_from_jax_arrays_is_exact_for_bf16():
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(3 * 128, 128), dtype=jnp.bfloat16)
    w = jnp.asarray(rng.randn(128, 128), dtype=jnp.bfloat16)
    x_np = np.asarray(x)
    with pytest.raises(TypeError):  # the trap the module exists for
        torch.from_numpy(x_np.copy())
    blocks, w_t = from_jax_arrays(x_np, np.asarray(w), "cpu")
    assert len(blocks) == 3 and w_t.dtype == torch.bfloat16
    joined = torch.cat(blocks).float().numpy()
    np.testing.assert_array_equal(joined, x_np.astype(np.float32))
    with pytest.raises(ValueError):
        from_jax_arrays(x_np[:200], np.asarray(w), "cpu")
