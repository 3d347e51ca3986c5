"""The port's package lints (``kube_gpu_stats_tpu_torch/tools/``), held to
the cases of ``tests/test_supervised_threads_lint.py`` and
``tests/test_wal_versions_lint.py``: each flags a bad file fed to it and
passes the good shapes, and both are green on the port's package when run
as ``python -m kube_gpu_stats_tpu_torch.tools.<name>``."""

import pathlib
import subprocess
import sys
import textwrap

import pytest

from kube_gpu_stats_tpu_torch.tools import (check_supervised_threads,
                                            check_wal_versions)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "kube_gpu_stats_tpu_torch"


def _check(lint, tmp_path, source: str, name: str = "module.py"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(source))
    return lint.check_file(path)


@pytest.mark.parametrize("lint", [check_supervised_threads,
                                  check_wal_versions])
def test_the_lint_scans_the_ports_package_and_is_green(lint):
    assert lint.PACKAGE == PORT
    name = lint.__name__.rsplit(".", 1)[1]
    result = subprocess.run(
        [sys.executable, "-m", f"kube_gpu_stats_tpu_torch.tools.{name}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.startswith(f"{name}: ")


# -- check_supervised_threads -------------------------------------------------

def test_bare_threading_thread_flagged(tmp_path):
    problems = _check(check_supervised_threads, tmp_path, """
        import threading
        t = threading.Thread(target=print, name="x", daemon=True)
    """)
    assert len(problems) == 1
    assert "supervisor.spawn" in problems[0]


def test_imported_thread_name_flagged(tmp_path):
    problems = _check(check_supervised_threads, tmp_path, """
        from threading import Thread
        t = Thread(target=print)
    """)
    assert len(problems) == 1


def test_thread_subclass_flagged(tmp_path):
    problems = _check(check_supervised_threads, tmp_path, """
        import threading

        class Worker(threading.Thread):
            pass
    """)
    assert len(problems) == 1
    assert "subclasses" in problems[0]


def test_spawn_helper_usage_passes(tmp_path):
    assert _check(check_supervised_threads, tmp_path, """
        from .supervisor import spawn
        t = spawn(print, name="ok")
        t.start()
    """) == []


def test_unrelated_thread_attribute_passes(tmp_path):
    assert _check(check_supervised_threads, tmp_path, """
        import sdk
        t = sdk.Thread(target=print)
    """) == []


def test_allowlist_covers_supervisor_testing_and_what_the_reference_left_out():
    assert check_supervised_threads.ALLOW_FILES == {"supervisor.py"}
    assert check_supervised_threads.ALLOW_DIRS == {"testing", "sims",
                                                   "tools", "deploy"}


def test_the_allowed_directories_hold_the_only_bare_threads():
    """Without the allow-list only supervisor.py, testing/ and sims/ (the
    reference's tools/*_sim.py) create threads directly; every production
    module is clean."""
    flagged = {path.relative_to(PORT).parts[0]
               for path in sorted(PORT.rglob("*.py"))
               if check_supervised_threads.check_file(path)}
    assert "sims" in flagged
    assert flagged <= {"supervisor.py", "testing", "sims"}


# -- check_wal_versions -----------------------------------------------------------

def test_unstamped_segment_ring_flagged(tmp_path):
    problems = _check(check_wal_versions, tmp_path, """
        from .wal import SegmentRing
        ring = SegmentRing("/d", max_bytes=1)
    """)
    assert len(problems) == 1
    assert "format_version" in problems[0]


def test_stamped_segment_ring_passes(tmp_path):
    assert _check(check_wal_versions, tmp_path, """
        from .wal import SegmentRing
        ring = SegmentRing("/d", max_bytes=1, format_version=2)
    """) == []


def test_write_state_with_literal_stamp_passes(tmp_path):
    assert _check(check_wal_versions, tmp_path, """
        from . import wal
        wal.write_state("/p", {"version": 3, "seq": 1})
    """) == []


def test_write_state_unstamped_literal_flagged(tmp_path):
    problems = _check(check_wal_versions, tmp_path, """
        from . import wal
        wal.write_state("/p", {"seq": 1})
    """)
    assert len(problems) == 1
    assert "version" in problems[0]


def test_write_state_through_local_state_function_passes(tmp_path):
    """The energy.py shape: state built by a method whose returned dict
    literal carries the stamp."""
    assert _check(check_wal_versions, tmp_path, """
        from . import wal

        class Store:
            def _state(self):
                return {"version": 2, "data": []}

            def checkpoint(self):
                wal.write_state("/p", self._state())
    """) == []


def test_write_state_untraceable_without_any_stamp_flagged(tmp_path):
    problems = _check(check_wal_versions, tmp_path, """
        from . import wal

        def save(state):
            wal.write_state("/p", state)
    """)
    assert len(problems) == 1


def test_custom_version_key_respected(tmp_path):
    assert _check(check_wal_versions, tmp_path, """
        from . import wal
        wal.write_state("/p", {"fmt": 1}, version_key="fmt")
    """) == []
    assert len(_check(check_wal_versions, tmp_path, """
        from . import wal
        wal.write_state("/p", {"version": 1}, version_key="fmt")
    """)) == 1


def test_the_ports_writers_are_the_ones_the_lint_reads():
    """The lint's rules name the port's own WAL API: SegmentRing and
    write_state live in the port's wal.py and are called elsewhere in the
    package, so a green run checked real call sites."""
    from kube_gpu_stats_tpu_torch import wal

    assert callable(wal.SegmentRing) and callable(wal.write_state)
    callers = [path for path in PORT.rglob("*.py")
               if path.name != "wal.py" and
               ("SegmentRing(" in path.read_text() or
                "write_state(" in path.read_text())]
    assert len(callers) >= 3
