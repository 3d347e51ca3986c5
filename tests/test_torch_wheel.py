"""The port runs from the project's own wheel.

The counterpart of the wheel and console-script smoke that ends the
reference's ``make ci``: a wheel built from a copy of the tree
(``pip wheel --no-deps --no-build-isolation``, offline) carries the
port's host fast-path source and CUDA source and no library built in the
builder's tree, names the port's console script, and, unpacked and put on
``sys.path`` in place of the repository, builds the host extension at
first use and serves a mock-backed scrape through that script's target
on the native render. A package directory that cannot be written fails
the build with the prebuild step named, and nothing falls back.
"""

import json
import re
import shutil
import subprocess
import sys
import time
import urllib.request
import zipfile
from pathlib import Path

import pytest

from kube_gpu_stats_tpu_torch import native
from kube_gpu_stats_tpu_torch.native import _hostbuild

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = "kube-tpu-stats-h100"
# Libraries a builder's tree holds after a run: the port's host extension
# and CUDA kernels, each in its ignored build directory.
PLANTED = ("kube_gpu_stats_tpu_torch/native/build/_wirefast_0000.so",
           "kube_gpu_stats_tpu_torch/csrc/build/libkts_kernels_0000.so")


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """(wheel file, the wheel unpacked) built from a copy of the tree."""
    base = tmp_path_factory.mktemp("wheel")
    src = base / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    for package in ("kube_gpu_stats_tpu", "kube_gpu_stats_tpu_torch"):
        shutil.copytree(ROOT / package, src / package,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for planted in PLANTED:
        (src / planted).parent.mkdir(parents=True, exist_ok=True)
        (src / planted).write_bytes(b"\x7fELF")
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "-w", str(base / "dist"),
         "."], cwd=src, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (whl,) = (base / "dist").glob("*.whl")
    unpacked = base / "site"
    with zipfile.ZipFile(whl) as archive:
        archive.extractall(unpacked)
    return whl, unpacked


def _names(whl):
    with zipfile.ZipFile(whl) as archive:
        return archive.namelist()


def test_the_wheel_carries_the_sources_and_no_built_library(wheel):
    names = _names(wheel[0])
    assert "kube_gpu_stats_tpu_torch/native/wirefast.cc" in names
    assert "kube_gpu_stats_tpu_torch/csrc/tiled_gemm.cu" in names
    assert "kube_gpu_stats_tpu_torch/native/_hostbuild.py" in names
    assert [n for n in names if n.endswith(".so")] == []
    assert [n for n in names if "/build/" in n] == []


def test_the_wheel_names_the_ports_console_script(wheel):
    (entry,) = [n for n in _names(wheel[0])
                if n.endswith(".dist-info/entry_points.txt")]
    with zipfile.ZipFile(wheel[0]) as archive:
        text = archive.read(entry).decode()
    scripts = dict(re.findall(r"^(\S+) = (\S+)$",
                              text.split("[console_scripts]", 1)[1], re.M))
    assert scripts[SCRIPT] == "kube_gpu_stats_tpu_torch.cli:main"
    assert scripts["kube-tpu-stats"] == "kube_gpu_stats_tpu.cli:main"


# The console script's target from the unpacked wheel, with the wheel
# first on sys.path and the repository off it (-I: no PYTHONPATH, no cwd).
_RUN_SCRIPT = """
import json, sys
site = sys.argv[1]
sys.path.insert(0, site)
from importlib.metadata import distributions
import kube_gpu_stats_tpu_torch as port
from kube_gpu_stats_tpu_torch import native
library = native.load_wirefast().__file__
(entry,) = [e for d in distributions(path=[site]) for e in d.entry_points
            if e.name == %r]
print("wheel:", json.dumps({"package": port.__file__, "library": library,
                           "entry": entry.value}), file=sys.stderr,
      flush=True)
sys.exit(entry.load()(sys.argv[2:]))
""" % SCRIPT


def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.read().decode()


def test_the_unpacked_wheel_builds_its_extension_and_serves(wheel,
                                                             tmp_path):
    site = wheel[1]
    proc = subprocess.Popen(
        [sys.executable, "-I", "-c", _RUN_SCRIPT, str(site),
         "--backend", "mock", "--mock-devices", "2", "--listen-host",
         "127.0.0.1", "--listen-port", "0", "--interval", "0.1",
         "--attribution", "off"],
        cwd=tmp_path, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        report = None
        while report is None:
            line = proc.stderr.readline()
            assert line, "the script exited before its report"
            if line.startswith("wheel: "):
                report = json.loads(line.split(" ", 1)[1])
        assert Path(report["package"]).is_relative_to(site), report
        assert Path(report["library"]).is_relative_to(
            site / "kube_gpu_stats_tpu_torch" / "native" / "build"), report
        assert report["entry"] == "kube_gpu_stats_tpu_torch.cli:main"
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            assert line, "the daemon exited before it listened"
            match = re.search(r"listening on [\d.]+:(\d+)", line)
            port = int(match.group(1)) if match else None
        assert port is not None
        while "accelerator_up{" not in (body := _scrape(port)):
            assert time.monotonic() < deadline, body
            time.sleep(0.05)
        assert body.count("accelerator_up{") == 2
        assert _scrape(port, "/healthz").startswith("ok\n")
        doctor = subprocess.run(
            [sys.executable, "-I", "-c", _RUN_SCRIPT, str(site), "doctor",
             "--backend", "mock", "--json", "--url",
             f"http://127.0.0.1:{port}/metrics"],
            cwd=tmp_path, capture_output=True, text=True, timeout=120)
        rows = {row["name"]: row for row in
                json.loads(doctor.stdout)["checks"]}
        assert rows["native"]["status"] == "ok", rows["native"]
        assert rows["native"]["data"]["library"] == report["library"]
        assert rows["scrape"]["status"] == "ok", rows["scrape"]
    finally:
        proc.terminate()
        rc = proc.wait(timeout=10)
    assert rc == 0, proc.stderr.read()


def test_an_unwritable_package_names_the_prebuild_step(monkeypatch,
                                                       tmp_path):
    blocker = tmp_path / "package"
    blocker.write_text("")  # a file where the build directory's parent is
    monkeypatch.setattr(_hostbuild, "BUILD_DIR", blocker / "build")
    monkeypatch.setattr(_hostbuild, "CXX", "/bin/false")
    monkeypatch.setattr(native, "_cache", {})
    with pytest.raises(native.NativeUnavailable) as caught:
        native.load_wirefast()
    message = str(caught.value)
    assert f"cannot write the build directory {blocker / 'build'}" in message
    assert "python -m kube_gpu_stats_tpu_torch.native._hostbuild" in message
    assert native.SWITCHES in message
    # No fallback: the next call raises the same error.
    with pytest.raises(native.NativeUnavailable):
        native.load_wirefast()
