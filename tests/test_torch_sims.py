"""The sims' package: its ten sims in the order of the reference's
``make ci``, and the one JSON line the command prints last."""

from __future__ import annotations

import importlib
import json
import pathlib
import re
import subprocess
import sys

from kube_gpu_stats_tpu_torch import sims

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_the_sims_run_in_the_order_of_the_reference_ci():
    """``SIMS`` is the order of the ``tools/*_sim.py`` lines of the
    reference's Makefile (read, not changed), and every one of them has
    its module with the sims' interface."""
    ci = [re.search(r"tools/(\w+)_sim\.py", line).group(1)
          for line in (ROOT / "Makefile").read_text().splitlines()
          if re.match(r"\s+python tools/\w+_sim\.py\s*$", line)]
    assert len(ci) == 10
    assert sims.SIMS == tuple(ci)
    for name in sims.SIMS:
        module = importlib.import_module(f"kube_gpu_stats_tpu_torch.sims."
                                         f"{name}")
        assert callable(module.add_arguments) and callable(module.main)
        assert module.__doc__.splitlines()[0]


def test_the_command_prints_each_sims_result_as_its_last_line():
    proc = subprocess.run(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch.sims", "host"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert lines[0].startswith("host-sim PASS")
    report = json.loads(lines[-1])
    assert set(report) == {"sims", "torch_loaded"}
    assert report["torch_loaded"] is False
    assert list(report["sims"]) == ["host"]
    host = report["sims"]["host"]
    assert host["ok"] is True
    assert host["figures"] and isinstance(host["timings"], dict)
