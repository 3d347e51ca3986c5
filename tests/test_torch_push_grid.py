"""The synthetic fleet's push grid (``testing.push_grid``) against a hub
whose period drifts: no round moves every node's frame gap by more than
the grid's slew, and a stall anchors the grid anew once."""

from __future__ import annotations

import numpy as np
import pytest

from kube_gpu_stats_tpu_torch.testing.push_grid import PushGrid

INTERVAL = 1.0
DELAY = 0.35
# The hub's lens scores a pushed node's frame gap against a deviation
# floored at 2% of the mean, and raises at 4 deviations.
GAP_ANOMALY_S = 4 * 0.02 * INTERVAL


def hub_detections(drift: float, rounds: int, seed: int) -> np.ndarray:
    """When the fleet first sees each generation of a hub whose period
    is ``INTERVAL + drift``: the refresh time plus the poll's 0-25 ms."""
    rng = np.random.default_rng(seed)
    refreshes = np.arange(rounds) * (INTERVAL + drift)
    return refreshes + rng.uniform(0.0, 0.025, rounds)


@pytest.mark.parametrize("drift", [-0.008, -0.0025, 0.0, 0.0025, 0.008])
def test_the_grid_follows_a_drifting_hub_without_a_jump(drift):
    seen = hub_detections(drift, 200, seed=7)
    grid = PushGrid(INTERVAL, DELAY)
    due = np.array([grid.next_due(t) for t in seen])
    gaps = np.diff(due)
    assert grid.anchors == 1
    assert np.abs(gaps - INTERVAL).max() <= PushGrid.SLEW + 1e-12
    assert np.abs(gaps - INTERVAL).max() < GAP_ANOMALY_S / 4
    # Each round stays within reach of its own generation: started after
    # it was seen, and done long before the next refresh.
    offset = due - seen
    assert offset.min() > 0.0
    assert offset.max() < DELAY + 0.1


def test_a_fixed_grid_would_jump_every_gap_at_once():
    # What the grid replaces: re-anchoring a fixed 1 s grid when it
    # strays 0.15 s moves that round's gap by 0.15 s, past the lens's
    # 4-deviation threshold, on every node of the round.
    seen = hub_detections(0.0025, 200, seed=7)
    due, fixed = None, []
    for t in seen:
        due = None if due is None else due + INTERVAL
        if due is None or abs(due - (t + DELAY)) > 0.15:
            due = t + DELAY
        fixed.append(due)
    assert np.abs(np.diff(fixed) - INTERVAL).max() > GAP_ANOMALY_S


def test_a_stall_anchors_the_grid_anew():
    seen = list(hub_detections(0.0, 40, seed=3))
    seen[20:] = [t + 1.0 for t in seen[20:]]      # one generation missed
    grid = PushGrid(INTERVAL, DELAY)
    due = [grid.next_due(t) for t in seen]
    assert grid.anchors == 2
    assert due[20] == pytest.approx(seen[20] + DELAY)
    assert max(abs(g - INTERVAL) for g in np.diff(due[21:])) <= PushGrid.SLEW
