"""The port's tick tools (``kube_gpu_stats_tpu_torch/tools/profile_tick.py``
and ``trace_dump.py``, the counterparts of the reference's
``tools/profiler.py`` and ``tools/trace_dump.py``) run for a few ticks
over ``testing.fake_nvml``: the cProfile table names the poll loop's tick,
the Chrome trace holds every tick and, with ``--blocking``, every card's
NVML read, and neither tool loads torch."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from kube_gpu_stats_tpu_torch.tools import profile_tick, trace_dump

ROOT = Path(__file__).resolve().parent.parent


def test_profile_tick_reports_the_poll_loops_tick(capsys):
    assert profile_tick.main(["--ticks", "4", "--warmup", "2", "--cards",
                              "2", "--top", "15"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# profile-tick: 4 ticks x 2 cards, stall=0 ms\n")
    assert "poll.py" in out and "(tick)" in out
    stats = ast.literal_eval(out.splitlines()[1].split(": ", 1)[1])
    assert stats["series"] > 0


def test_profile_tick_over_a_stalled_read(capsys):
    assert profile_tick.main(["--ticks", "2", "--warmup", "1", "--cards",
                              "1", "--stall-ms", "2"]) == 0
    assert "stall=2 ms\n" in capsys.readouterr().out


def test_trace_dump_holds_every_tick_and_card_read(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert trace_dump.main(["--ticks", "5", "--cards", "3", "--blocking",
                            "--out", str(out)]) == 0
    assert f"wrote {out} (5 ticks" in capsys.readouterr().out
    events = json.loads(out.read_text())["traceEvents"]
    names = [event.get("name") for event in events]
    assert names.count("tick") == 5
    assert names.count("env_read") == 5 * 3


def test_the_tools_load_no_torch(tmp_path):
    script = (
        "import sys\n"
        "from kube_gpu_stats_tpu_torch.tools import profile_tick, trace_dump\n"
        "profile_tick.main(['--ticks', '1', '--warmup', '1', '--cards', '1'])\n"
        f"trace_dump.main(['--ticks', '1', '--out', {str(tmp_path / 't.json')!r}])\n"
        "print([m for m in sys.modules if m == 'torch' or m.startswith('torch.')])\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
