"""The port's energy sim against the reference's ``tools/energy_sim.py``.

Asserted are the figures the scenario fixes, equal on both sides: the
burst ring's maximum at the spike's full 900 W, the tick gauge never
seeing it, spike samples in the (750, 1000] W bucket, per-pod joules
monotone across the restart and advancing after it, the digest verified
with the audit key and refused with a wrong one. The joules and the
number of spike samples depend on the host's timing and are printed.
The reference's checkpoint rounds joules to nearest, so its restart can
serve up to 5e-7 J below the scrape before it; that one failure of its
run is allowed, and the port's (rounded up) is held monotone.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import re
import sys

import pytest

from kube_gpu_stats_tpu_torch.sims import energy

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import energy_sim  # noqa: E402  (the reference's scenario)

pytestmark = pytest.mark.chaos


def test_energy_as_the_reference():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = energy_sim.run(verbose=True)
    text = out.getvalue()
    print(text)
    if rc != 0:
        # Only the reference's rounding flaw (not copied): a restart that
        # serves a pod's joules up to 5e-7 J below the scrape before it.
        failures = text.split("energy-sim FAIL:")[1].strip().splitlines()
        for line in failures:
            before, after = map(float, re.search(
                r"not monotone across restart \(([\d.]+) -> ([\d.]+)\)",
                line).groups())
            assert 0 < before - after <= 5e-7, line
    burst_max, gauge_max, bucket = map(float, re.search(
        r"burst_max=([\d.]+) W, gauge_max=([\d.]+) W, spike-bucket="
        r"([\d.]+)", text).groups())
    doctor_ok = re.search(r"\[(\w+)\] energy", text).group(1)

    port = energy.run()
    print(port.report("energy"))
    assert port.problems == []
    fig = port.figures
    assert fig["burst_max"] == burst_max == energy.SPIKE_WATTS
    assert fig["gauge_saw_spike"] is (gauge_max >= 500.0) is False
    assert fig["spike_bucketed"] is (bucket > 0) is True
    assert fig["joined"] and fig["joules_monotone"]
    assert fig["joules_advancing"]
    assert (fig["doctor_right_key"], fig["doctor_wrong_key"]) \
        == (doctor_ok, "fail") == ("ok", "fail")
