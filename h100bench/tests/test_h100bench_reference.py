"""The plain reference against an independent computation of the same
step, and the control against the limit, at small sizes on the CPU; the
control at the cells' own sizes on the card."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from h100bench import control
from h100bench.core import manifest
from h100bench.reference import burn_step

from .conftest import ROOT


def _inputs(size, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((size, size), generator=gen, dtype=torch.bfloat16)
    w = torch.randn((size, size), generator=gen, dtype=torch.bfloat16)
    return x, w


@pytest.mark.parametrize("size,seed", [(128, 1), (256, 2**31 + 3), (384, 5)])
def test_the_reference_agrees_with_numpy_in_float64(size, seed):
    x, w = _inputs(size, seed)
    ref = burn_step.step(x, w).numpy()
    plain = np.tanh(x.float().numpy().astype(np.float64)
                    @ w.float().numpy().astype(np.float64))
    assert np.abs(ref - plain).max() < 1e-5


def test_the_widest_gap_is_taken_over_every_block():
    served = torch.zeros((10, 4), dtype=torch.bfloat16)
    reference = torch.zeros((10, 4))
    reference[9, 3] = 0.25
    assert burn_step.widest_gap(served, reference, rows=3) == 0.25


def _limit():
    return manifest.load(ROOT / "h100bench/configs/embedded-1card.json")[
        "limits"]["step_gap"]


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_the_control_fails_the_limit_the_program_meets_on_the_cpu(seed):
    got = control.readings(256, seed, 0.3, "cpu")
    assert got["program_gap"] < _limit() < got["control_gap"]


def test_every_configuration_holds_the_step_to_one_limit():
    for name in ("embedded-1card", "daemon-nvml-1card"):
        data = manifest.load(ROOT / f"h100bench/configs/{name}.json")
        assert data["limits"]["step_gap"] == _limit()


@pytest.mark.cuda
@pytest.mark.parametrize("size", [4096])
def test_the_control_fails_the_limit_the_program_meets_on_the_card(card, size):
    rows = [control.readings(size, seed, 1.0, "cuda")
            for seed in (2**31 + 21, 22, 23)]
    print(json.dumps(rows))
    for row in rows:
        assert row["program_gap"] < _limit() < row["control_gap"]
