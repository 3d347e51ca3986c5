"""The port's `top` against the reference's on the same expositions.

Seeded node and hub expositions, two frames apart with the clocks
pinned, go through both packages' ``fold_target``, ``build_frame``,
``Frame.rates``, ``render_table`` (the rollup footer included) and
``render_json``; ``main --once --json`` and the table form over saved
``.prom`` files print the same text. Exact throughout: the rates are one
subtraction and one division of the same floats in the same order.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from kube_gpu_stats_tpu import top as ref_top
from kube_gpu_stats_tpu_torch import top
from kube_gpu_stats_tpu_torch.validate import parse_exposition


def _node_text(rng, node: int, cards: int, step: int) -> str:
    lines = []
    for card in range(cards):
        base = (f'accel_type="h100",chip="{card}",slice="h100-a",'
                f'worker="node-{node:02d}"')
        pod = (f',pod="train-{node}",namespace="ml"'
               if rng.random() < 0.5 else "")
        lines += [
            f"accelerator_up{{{base}}} {1 if rng.random() < 0.9 else 0}",
            f"accelerator_duty_cycle{{{base}{pod}}} "
            f"{float(rng.integers(0, 101))}",
            f"accelerator_memory_used_bytes{{{base}}} "
            f"{float(rng.integers(1, 80)) * 2**30}",
            f"accelerator_memory_total_bytes{{{base}}} {80 * 2**30}",
            f"accelerator_memory_peak_bytes{{{base}}} {81 * 2**29}",
            f"accelerator_power_watts{{{base}}} "
            f"{float(rng.uniform(80, 700)):.3f}",
            f"accelerator_temperature_celsius{{{base}}} "
            f"{float(rng.integers(30, 80))}",
            f"accelerator_workload_model_flops_utilization{{{base}}} "
            f"{float(rng.random()):.4f}",
            f"accelerator_workload_steps_total{{{base}}} "
            f"{step * int(rng.integers(5, 40))}",
            f"accelerator_workload_busy_seconds_total{{{base}}} "
            f"{step * 0.7:.3f}",
            f"accelerator_energy_joules_total{{{base}}} {step * 500.5}",
            f"accelerator_runtime_restarts_total{{{base}}} 0",
        ]
        for link in range(int(rng.integers(0, 3))):
            lines.append(
                f"accelerator_ici_link_bandwidth_bytes_per_second"
                f"{{{base},link=\"{link}\"}} {float(rng.integers(0, 10**9))}")
        lines.append(f'accelerator_process_open{{{base},pid="1",'
                     f'comm="python"}} 1')
        lines.append(f'accelerator_process_open{{{base},pid="0",'
                     f'comm="_overflow"}} 3')
    return "\n".join(lines) + "\n"


def _hub_text(rng) -> str:
    return "\n".join([
        'slice_target_up{target="http://a:9400/metrics"} 1',
        'slice_target_up{target="http://b:9400/metrics"} 0',
        "slice_workers_expected 64",
        "slice_duplicate_series 2",
        'slice_chips{slice="h100-a"} 16',
        'slice_chips_up{slice="h100-a"} 15',
        'slice_workers{slice="h100-a"} 2',
        f'slice_duty_cycle_mean{{slice="h100-a"}} {rng.random() * 100}',
        f'slice_straggler_ratio{{slice="h100-a"}} {rng.random()}',
        'slice_worker_steps_per_second{slice="h100-a",worker="node-00"} 3',
        'slice_chips{slice="h100-b"} 8',
    ]) + "\n" + _node_text(rng, 7, 1, 3)


def _texts(seed: int, step: int) -> list[str]:
    rng = np.random.default_rng(seed * 1000 + step)
    return [_node_text(rng, i, 2 + i % 3, step) for i in range(3)] + \
        [_hub_text(rng)]


def _rows(frame) -> dict:
    return {key: dataclasses.asdict(row) for key, row in frame.rows.items()}


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:00:00")


@pytest.mark.parametrize("seed", range(4))
def test_frames_two_apart_equal_the_reference(seed, pinned):
    targets = ["node-a", "node-b", "node-c", "hub"]
    frames = []
    for step, at in ((1, 100.0), (4, 102.5)):
        texts = _texts(seed, step)
        ats = [at + 0.01 * i for i in range(len(texts))]
        port = top.build_frame(texts, [], ats, targets=targets)
        ref = ref_top.build_frame(texts, [], ats, targets=targets)
        if frames:
            port.rates(frames[-1][0])
            ref.rates(frames[-1][1])
        assert _rows(port) == _rows(ref)
        assert port.rollups == ref.rollups
        assert top.render_table(port) == ref_top.render_table(ref)
        assert top.render_json(port) == ref_top.render_json(ref)
        frames.append((port, ref))
    assert any(r.steps_per_s for r in frames[-1][0].rows.values())
    assert "h100-a" in top.render_table(frames[-1][0])


@pytest.mark.parametrize("seed", range(3))
def test_fold_target_equals_the_reference(seed):
    text = _texts(seed, 2)[seed % 4]
    series = parse_exposition(text)
    got_rows, got_rollups, want_rows, want_rollups = {}, {}, {}, {}
    top.fold_target(series, "t", 5.0, got_rows, got_rollups)
    ref_top.fold_target(series, "t", 5.0, want_rows, want_rollups)
    assert {k: dataclasses.asdict(v) for k, v in got_rows.items()} == \
        {k: dataclasses.asdict(v) for k, v in want_rows.items()}
    assert got_rollups == want_rollups
    row = next(iter(got_rows.values()))
    clone = row.clone_at(9.0)
    assert clone.at == 9.0 and clone.key == row.key and clone is not row
    assert top._GAUGE_BY_NAME == ref_top._GAUGE_BY_NAME
    assert top._COUNTER_BY_NAME == ref_top._COUNTER_BY_NAME


def test_a_bad_exposition_is_an_error_line_as_the_reference():
    port = top.build_frame(["garbage line\n", _texts(0, 1)[0]], [],
                           [1.0, 1.0])
    ref = ref_top.build_frame(["garbage line\n", _texts(0, 1)[0]], [],
                              [1.0, 1.0])
    assert port.errors == ref.errors and port.errors
    assert _rows(port) == _rows(ref)


@pytest.mark.parametrize("as_json", [True, False])
def test_main_once_prints_what_the_reference_prints(tmp_path, capsys,
                                                    monkeypatch, pinned,
                                                    as_json):
    monkeypatch.setattr(time, "monotonic", lambda: 42.0)
    paths = []
    for i, text in enumerate(_texts(9, 3)):
        path = tmp_path / f"t{i}.prom"
        path.write_text(text)
        paths.append(str(path))
    argv = ["--once"] + (["--json"] if as_json else []) + paths
    assert top.main(argv) == 0
    got = capsys.readouterr().out
    assert ref_top.main(argv) == 0
    assert got == capsys.readouterr().out
    assert ("chips" in got) if as_json else ("workers" in got)


def test_main_once_with_nothing_answering_exits_2(tmp_path, capsys):
    absent = str(tmp_path / "absent.prom")
    assert top.main(["--once", absent]) == 2
    err = capsys.readouterr().err
    assert ref_top.main(["--once", absent]) == 2
    assert err == capsys.readouterr().err
