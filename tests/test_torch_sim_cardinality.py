"""The port's cardinality sim against the reference's
``tools/cardinality_sim.py``, both at the reference's full size: 14
healthy pushers, 2 bombs of 50,000 unique series x 10 waves (1,000,000
offered), budget 500, hard cap 700, watermark 650.

The port's side runs as ``python -m kube_gpu_stats_tpu_torch.sims
cardinality`` in a child process of its own, started before the
reference's side runs here, so that its RSS growth is the bomb's alone:
the reference reads growth from ``ru_maxrss``, the process's lifetime
peak, which in a test process that has run other work can already sit
above anything the bomb adds, so that its pin cannot fail here. The
child must hold the 384 MB pin and load no torch.

Asserted are the figures the scenario fixes and that they equal the
reference's: the series offered, the series live at the peak (the cap),
the shed ledger's rows and total, each bomb's ``source_budget`` shed
equal to the arithmetic (waves x (offered - budget)), the three views of
the ledger equal, the healthy pushers' series equal to the control
hub's, the intruder's 413 at the cap and its admission after the idle
eviction, and the series evicted. No check of the reference pins the
host's speed. The RSS growth of both sides is printed; the child's is
read from ``VmHWM`` when that is its own peak and from sampled ``VmRSS``
otherwise, and is never below what the samples saw.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys

import pytest

import chip_smoke
from kube_gpu_stats_tpu_torch.sims import cardinality

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import cardinality_sim  # noqa: E402  (the reference's sim)

pytestmark = pytest.mark.chaos


def test_the_label_bomb_as_the_reference():
    child = subprocess.Popen(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch.sims",
         "cardinality"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cardinality_sim.run(verbose=True)
        text = out.getvalue()
        print(text)
        stdout, stderr = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    print(stdout)
    assert rc == 0, text
    attempted, live, shed_total, rows, evicted = map(int, re.search(
        r"bomb: (\d+) unique series attempted, (\d+) live at peak \(cap "
        r"700\), shed ledger (\d+) across (\d+) rows, RSS \+\d+ MB \(pin "
        r"384\), (\d+) series idle-evicted, late joiner admitted",
        text).groups())

    assert child.returncode == 0, stderr[-3000:]
    report = json.loads(stdout.strip().splitlines()[-1])
    assert report["torch_loaded"] is False
    port = report["sims"]["cardinality"]
    assert port["ok"]
    fig = port["figures"]
    assert fig["attempted"] == attempted == 1_000_000
    assert fig["live_at_peak"] == live == cardinality.HARD_CAP
    assert (fig["shed_total"], fig["shed_rows"]) == (shed_total, rows)
    assert fig["bomb_shed"] == [cardinality_sim.WAVES * (
        cardinality_sim.BOMB_SERIES - cardinality_sim.BUDGET)] * 2
    assert fig["exported_equal"] and fig["debug_equal"]
    assert fig["healthy_equal"] and fig["healthy_failed"] == 0
    assert fig["bomb_statuses"] == {"200": 20}
    assert fig["intruder_at_cap"] == [413, True]
    assert fig["late_joiner"] == 200
    assert fig["evicted_idle"] == evicted > 0
    assert fig["live_after"] <= cardinality.HIGH
    assert fig["rss_growth_under_pin"]
    timings = port["timings"]
    assert timings["rss_growth_mb"] < cardinality.RSS_PIN_MB
    # The kernel's peak where the child's own, never below the samples.
    own = timings["hwm_before_mb"] - timings["rss_before_mb"] \
        <= cardinality.HWM_SLACK_MB
    assert timings["rss_source"] == ("VmHWM" if own else "VmRSS sampled")
    assert timings["rss_growth_mb"] >= (timings["rss_sampled_peak_mb"]
                                        - timings["rss_before_mb"])
    want = chip_smoke.SIMS_EXACT["cardinality"]
    assert {key: fig[key] for key in want} == want
    assert (cardinality.BOMBS, cardinality.WAVES, cardinality.BOMB_SERIES,
            cardinality.BUDGET, cardinality.HARD_CAP, cardinality.HIGH,
            cardinality.RSS_PIN_MB) == (
        cardinality_sim.BOMBS, cardinality_sim.WAVES,
        cardinality_sim.BOMB_SERIES, cardinality_sim.BUDGET,
        cardinality_sim.HARD_CAP, cardinality_sim.HIGH,
        cardinality_sim.RSS_PIN_MB)
