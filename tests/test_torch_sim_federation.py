"""The port's federation sim against the reference's
``tools/federation_sim.py``, both at 3 nodes, 8 refreshes, a 0.8 s
straggler.

Asserted are the figures the scenario fixes, equal on both sides: the
chips the root's rollup carries, the worker restart resynced through a
FULL, the partitioned leaf served by pull, the authenticated hop pushed
and the credential-less one refused, the resync storm's 48 sessions kept
and push-served over the same lanes, and the straggler named by
``doctor --fleet``. The doctor's phase and seconds are printed. Where
the reference's run fails on a loaded host, its output is printed and
the port is held to the scenario's own figures (6 chips, 4 lanes).
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import re
import sys

import pytest

from kube_gpu_stats_tpu_torch.sims import federation

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import federation_sim  # noqa: E402  (the reference's scenario)

pytestmark = pytest.mark.chaos


def test_federation_as_the_reference():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = federation_sim.run(3, 8, 0.8, verbose=True)
    text = out.getvalue()
    print(text)
    chips, lanes = 6, 4  # 3 nodes of 2 cards; crc32's lanes of 48 names
    if rc == 0:
        chips, lanes = map(int, re.search(
            r"converged \((\d+) chips\).*resync storm survived over "
            r"(\d+) lanes", text).groups())

    port = federation.run(3, 8, 0.8)
    print(port.report("federation"))
    assert port.problems == []
    fig = port.figures
    assert (fig["root_chips"], fig["storm_lanes"]) == (chips, lanes) \
        == (6, 4)
    assert fig["worker_resynced"] and fig["partitioned_leaf_pulled"]
    assert fig["authed_pushed"] and fig["authed_rollups"]
    assert fig["unauthed_pushes"] == 0 and fig["unauthed_refused"]
    assert (fig["storm_sessions"], fig["storm_served"],
            fig["storm_errors"]) == (48, 48, 0)
    assert fig["straggler_named"]
