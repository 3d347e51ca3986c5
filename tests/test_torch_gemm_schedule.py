"""The tiled GEMM kernel's schedule, off the card: ``gemm_plan`` (the
instance and the persistent grid) and ``tile_coords`` (the grouped tile
order), the Python mirrors that ``csrc/tiled_gemm.cu`` follows and that
``chip_smoke.py`` holds against the compiled kernel's own plan.

For every shape the tests and ``chip_smoke.py`` give the kernel, the
persistent walk (block b takes tiles b, b + grid, ...) must visit each
output tile exactly once and stay in bounds."""

import collections

import pytest

from kube_gpu_stats_tpu_torch.loadgen.tiled_burn import (GROUP_M, gemm_plan,
                                                         tile_coords)

# (m, n) of every product the kernel is given in tests/test_torch_cuda.py
# and chip_smoke.py (k does not enter the schedule).
SHAPES = [(256, 384), (128, 128), (384, 384), (1024, 512), (1152, 1280),
          (2048, 1536), (512, 512), (1024, 1024), (2048, 2048), (4096, 4096),
          (8192, 8192)]
# SMs of an H100 SXM, an H100 PCIe, and two sizes that force several
# tiles on every block or leave some blocks one tile short.
SM_COUNTS = [132, 114, 7, 1]


def _walk(m, n, sms):
    block_n, grid = gemm_plan(m, n, sms)
    num_m, num_n = m // 128, n // block_n
    tiles = num_m * num_n
    visits = collections.Counter()
    per_block = []
    for b in range(grid):
        mine = [tile_coords(t, num_m, num_n) for t in range(b, tiles, grid)]
        visits.update(mine)
        per_block.append(len(mine))
    return block_n, grid, num_m, num_n, visits, per_block


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("m,n", SHAPES)
def test_persistent_walk_covers_every_tile_once(m, n, sms):
    block_n, grid, num_m, num_n, visits, per_block = _walk(m, n, sms)
    assert block_n in (128, 256) and n % block_n == 0
    assert 1 <= grid <= sms
    assert all(0 <= i < num_m and 0 <= j < num_n for i, j in visits)
    assert set(visits) == {(i, j) for i in range(num_m)
                           for j in range(num_n)}
    assert set(visits.values()) == {1}
    # Persistent: every block has work, and no block more than one tile
    # beyond any other.
    assert min(per_block) >= 1 and max(per_block) - min(per_block) <= 1


@pytest.mark.parametrize("m,n", SHAPES)
def test_narrow_instance_whenever_n_is_not_a_multiple_of_256(m, n):
    for sms in SM_COUNTS:
        block_n, _ = gemm_plan(m, n, sms)
        if n % 256:
            assert block_n == 128


@pytest.mark.parametrize("m,n,block_n,grid", [
    (4096, 4096, 256, 132),   # the main path: 512 tiles, ~3.9 per block
    (8192, 8192, 256, 132),
    (2048, 2048, 256, 128),   # one wave of wide tiles
    (1024, 1024, 128, 64),    # 32 wide tiles would idle 100 SMs
    (1152, 1280, 128, 90),
    (384, 384, 128, 9),
])
def test_plan_on_an_h100(m, n, block_n, grid):
    assert gemm_plan(m, n, 132) == (block_n, grid)


def test_grouped_order_keeps_a_group_of_m_blocks_together():
    num_m, num_n = 32, 16
    first = [tile_coords(t, num_m, num_n) for t in range(GROUP_M * num_n)]
    # The first GROUP_M * num_n tiles are exactly the first GROUP_M block
    # rows, walked column by column.
    assert {i for i, _ in first} == set(range(GROUP_M))
    assert first[:GROUP_M] == [(i, 0) for i in range(GROUP_M)]
    # A ragged last group (9 block rows) takes the one row that is left.
    last = [tile_coords(t, 9, 5) for t in range(GROUP_M * 5, 9 * 5)]
    assert last == [(8, j) for j in range(5)]
