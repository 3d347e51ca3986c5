"""A whole run on the CPU with the chip check skipped: the last line's
shape, the refusal without a card or with JAX loaded in any of the run's
processes, and ``correct`` coming out false under each fault the cells can
have and under the fp8 control in the program's place."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
import torch

from h100bench import run
from h100bench.reference import burn_step as reference

from .conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture
def burn_step(monkeypatch):
    """Replace the program's burn step for the test."""
    from kube_gpu_stats_tpu_torch.loadgen import tiled_burn

    real = tiled_burn.tiled_burn_step

    def install(make):
        monkeypatch.setattr(tiled_burn, "tiled_burn_step", make(real))

    return install


def test_a_sound_run_is_correct_and_has_the_contract_keys(cpu_cell, measure_cpu):
    out = measure_cpu(cpu_cell("emb.b4096.prom15"))
    assert list(out) == KEYS
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 9 and out["failed"] == 0
    assert set(out["metrics"]) == {"steps_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert set(out["checks"]) == {"step_gap", "steps_off", "flops_off",
                                  "bad_bodies"}
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}


def test_the_served_totals_are_read_after_the_window_at_the_chips_pulls(
        cpu_cell, measure_cpu):
    # At the deployment's own periods a short window's last scrape, if any,
    # lies seconds before its end.
    out = measure_cpu(cpu_cell("emb.b4096.prom15", speedup=1), seconds=4.0)
    assert out["attempted"] <= 2
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["steps_off"]["value"] == 0


def test_a_traced_run_reports_the_program_counters(cpu_cell, measure_cpu):
    out = measure_cpu(cpu_cell("emb.b4096.prom15"), seconds=5.0, trace=True)
    assert list(out)[-1] == "checks" and out["correct"] is True
    # The CPU has no device trace: its readers find nothing and say so.
    assert {"tick_mean_ms", "scrape_p95_ms"} <= set(out["metrics"])
    assert set(out["metrics"]) <= {"tick_mean_ms", "render_mean_ms",
                                   "render_cache_hit_pct", "scrape_p50_ms",
                                   "scrape_p95_ms"}


def test_the_daemon_cell_over_the_mock_backend(cpu_cell, measure_cpu,
                                              monkeypatch):
    from h100bench.drivers import daemon

    def same_as_served():
        return daemon.served_card(_last_scrape["samples"], {"chip": "0"})

    _last_scrape = {}
    real_scrape = daemon.common.scrape

    def scrape(url, timeout=10.0):
        _last_scrape["samples"] = real_scrape(url, timeout)
        return _last_scrape["samples"]

    monkeypatch.setattr(daemon.common, "scrape", scrape)
    monkeypatch.setattr(daemon, "read_card", same_as_served)
    out = measure_cpu(cpu_cell("daemon.b4096.prom15"))
    assert out["correct"] is True, out["checks"]
    assert {"memory_gap_mib", "duty_gap", "power_gap_pct", "step_gap",
            "bad_bodies"} == set(out["checks"])
    # The card's figures off from what the daemon serves: not correct.
    monkeypatch.setattr(daemon, "read_card", lambda: {
        "memory_mib": 1e6, "duty": 0.0, "power_w": 1.0})
    assert measure_cpu(cpu_cell("daemon.b4096.prom15"))["correct"] is False


def _unchanged(real):
    return lambda x_blocks, w_blocks: list(x_blocks)


def _half_batch(real):
    def step(x_blocks, w_blocks):
        out = real([x[: x.shape[0] // 2] for x in x_blocks], w_blocks)
        return [torch.cat([o, o]) for o in out]

    return step


def _altered(real):
    def step(x_blocks, w_blocks):
        out = real(x_blocks, w_blocks)
        for o in out:
            o[0, 0] = -o[0, 0] if o[0, 0] != 0 else 1
        return out

    return step


def _fp8_control(real):
    def step(x_blocks, w_blocks):
        return [reference.control_step(x, w) for x, w in zip(x_blocks, w_blocks)]

    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered,
                                   _fp8_control],
                         ids=["state-unchanged", "half-batch", "answer-altered",
                              "fp8-control"])
def test_a_broken_step_is_not_correct(cpu_cell, measure_cpu, burn_step, fault):
    burn_step(fault)
    out = measure_cpu(cpu_cell("emb.b4096.prom15"), seconds=2.0)
    assert out["correct"] is False
    assert out["checks"]["step_gap"]["value"] > out["checks"]["step_gap"]["limit"]


def test_steps_served_altered_is_not_correct(cpu_cell, measure_cpu,
                                             monkeypatch):
    from kube_gpu_stats_tpu_torch import embedded

    real = embedded.TorchIntrospectCollector.record_step

    def record_step(self, n=1, seconds=None, flops=None):
        real(self, n + 1, seconds=seconds, flops=flops)

    monkeypatch.setattr(embedded.TorchIntrospectCollector, "record_step",
                        record_step)
    out = measure_cpu(cpu_cell("emb.b4096.prom15"), seconds=2.0)
    assert out["correct"] is False
    assert out["checks"]["steps_off"]["value"] > 0


def test_a_body_that_does_not_serve_the_card_is_not_correct(cpu_cell,
                                                            measure_cpu):
    cell = cpu_cell("emb.b4096.prom15")
    cell.config["card_labels"]["chip"] = "7"
    out = measure_cpu(cell, seconds=2.0)
    assert out["correct"] is False and out["checks"]["bad_bodies"]["value"] > 0


@pytest.mark.parametrize("cell", ["emb.b4096.prom15", "daemon.b4096.prom15"])
def test_without_a_card_the_run_fails_and_prints_no_result(cell):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", cell,
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["kube_gpu_stats_tpu_torch.embedded",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "kube_gpu_stats_tpu.bench",
                                  "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "kube_gpu_stats_tpu.bench"]


def test_the_result_line_is_json_with_checks_last(cpu_cell, measure_cpu):
    out = measure_cpu(cpu_cell("emb.b4096.prom15"), seconds=2.0)
    line = json.dumps(out)
    assert list(json.loads(line))[-1] == "checks"


@pytest.fixture
def daemon_on_cpu(monkeypatch):
    """The daemon cell's card readings, which ``nvidia-smi`` gives on the
    card, made up on the CPU."""
    from h100bench.drivers import daemon

    monkeypatch.setattr(daemon, "read_card", lambda: {
        "memory_mib": 0.0, "duty": 0.0, "power_w": 1.0})


@pytest.fixture
def plant_jax(tmp_path, monkeypatch):
    """Make the children whose command line holds ``where`` import a fake
    ``jax`` as they start (a ``sitecustomize`` on their path)."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text(
        "import os, sys\n"
        "if os.environ['H100BENCH_TEST_PLANT'] in ' '.join(sys.orig_argv):\n"
        "    import jax  # noqa: F401\n")

    def plant(where):
        monkeypatch.setenv("PYTHONPATH", str(tmp_path))
        monkeypatch.setenv("H100BENCH_TEST_PLANT", where)

    return plant


@pytest.mark.parametrize("cell,where,child", [
    ("daemon.b4096.prom15", "burn_child.py", "burn child"),
    ("daemon.b4096.prom15", "h100bench.core.daemon_child", "daemon"),
    ("daemon.b4096.prom15", "scrape.py", "scraper child"),
    ("emb.b4096.prom15", "scrape.py", "scraper child"),
], ids=["daemon-burn-child", "daemon-daemon", "daemon-scrapers",
        "emb-scrapers"])
def test_jax_in_any_child_leaves_no_result(cpu_cell, measure_cpu, plant_jax,
                                          daemon_on_cpu, cell, where, child):
    plant_jax(where)
    with pytest.raises(run.Forbidden, match=f"jax in the {child}$"):
        measure_cpu(cpu_cell(cell), seconds=2.0)


def test_the_children_report_no_module_when_none_is_planted(
        cpu_cell, measure_cpu, plant_jax, daemon_on_cpu):
    plant_jax("no child has this on its command line")
    out = measure_cpu(cpu_cell("daemon.b4096.prom15"), seconds=2.0)
    assert out["attempted"] > 0


@pytest.fixture
def main_on_cpu(monkeypatch):
    """``run.main`` with the chip check and ``nvidia-smi`` made up."""
    from h100bench.core import common, manifest

    for kind in ("embedded", "daemon"):
        monkeypatch.setattr(manifest.driver(kind), "check_card",
                            lambda chips: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(common, "smi", lambda fields: ["700.00"])
    argv = ["--workload", "emb.b4096.prom15", "--seed", str(2**31 + 13),
            "--seconds", "1", "--trace", "0"]
    return lambda: run.main(argv)


def test_a_child_that_held_jax_stops_main_with_no_result(main_on_cpu,
                                                         monkeypatch, capsys):
    def measure(*args, **kwargs):
        run.check_children({"daemon": ["jax", "jax.numpy"],
                            "scraper child": []})

    monkeypatch.setattr(run, "measure", measure)
    assert main_on_cpu() == 3
    got = capsys.readouterr()
    assert got.out == ""
    assert "no result: loaded jax, jax.numpy in the daemon" in got.err


def test_jax_in_the_printing_process_stops_main_with_no_result(
        main_on_cpu, monkeypatch, capsys):
    monkeypatch.setattr(run, "measure", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert main_on_cpu() == 3
    got = capsys.readouterr()
    assert got.out == ""
    assert "jax in the process that prints the result" in got.err
