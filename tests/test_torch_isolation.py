"""The port imports neither JAX nor anything of kube_gpu_stats_tpu.

Checked twice: in a fresh subprocess (tests/conftest.py imports JAX in
this one) that imports every module of the port and inspects
sys.modules, and statically over every import statement of the port's
sources and chip_smoke.py.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "kube_gpu_stats_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    # Exact names or dotted children only: kube_gpu_stats_tpu_torch itself
    # starts with the string "kube_gpu_stats_tpu".
    return any(module == banned or module.startswith(banned + ".")
               for banned in ("jax", "kube_gpu_stats_tpu"))


@pytest.mark.parametrize("name,expected", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", False),
    ("kube_gpu_stats_tpu", True), ("kube_gpu_stats_tpu.loadgen", True),
    ("kube_gpu_stats_tpu_torch", False),
    ("kube_gpu_stats_tpu_torch.loadgen", False),
])
def test_forbidden_matches_exact_names(name, expected):
    assert _forbidden(name) == expected


_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import kube_gpu_stats_tpu_torch as port
names = [port.__name__]
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    if not info.name.endswith("__main__"):  # __main__ runs the CLI
        names.append(info.name)
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_importing_the_port_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("loadgen.tiled_burn", "loadgen.mesh", "loadgen.ici_burn",
                   "validate", "testing.ranks", "doctor", "profiler",
                   "hoststats", "burstsampler", "energy", "wal",
                   "testing.faultfs"):
        assert f"kube_gpu_stats_tpu_torch.{module}" in report["imported"]
    assert [m for m in report["loaded"] if _forbidden(m)] == []


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_import_statement_names_jax_or_the_reference(path):
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []


_IMPORT_DAEMON_PATH = """
import json, sys
import kube_gpu_stats_tpu_torch.cli
import kube_gpu_stats_tpu_torch.collectors.nvml
import kube_gpu_stats_tpu_torch.burstsampler
import kube_gpu_stats_tpu_torch.daemon
import kube_gpu_stats_tpu_torch.doctor
import kube_gpu_stats_tpu_torch.energy
import kube_gpu_stats_tpu_torch.hoststats
import kube_gpu_stats_tpu_torch.profiler
import kube_gpu_stats_tpu_torch.testing.fake_nvml
import kube_gpu_stats_tpu_torch.testing.faultfs
import kube_gpu_stats_tpu_torch.wal
print(json.dumps(sorted(sys.modules)))
"""

# A whole doctor pass on the mock backend, every row that runs without a
# card included (a saved exposition stands in for the live --url).
_RUN_DOCTOR = """
import json, sys
from kube_gpu_stats_tpu_torch import doctor
from kube_gpu_stats_tpu_torch.exposition import MetricsServer
from kube_gpu_stats_tpu_torch.registry import Registry
from kube_gpu_stats_tpu_torch.tracing import Tracer
server = MetricsServer(Registry(), host="127.0.0.1", port=0,
                       trace_provider=Tracer())
server.start()
try:
    rc = doctor.main(["--backend", "mock", "--json", "--trace", "--url",
                      f"http://127.0.0.1:{server.port}/metrics"])
finally:
    server.stop()
print(json.dumps({"rc": rc, "loaded": sorted(sys.modules)}))
"""


# The daemon on the mock backend with the burst sampler armed and host
# signals on: a few ticks fold both, and /debug/burst and /debug/host
# answer.
_RUN_DAEMON_NODE_FEATURES = """
import json, sys, time, urllib.request
from kube_gpu_stats_tpu_torch import config, daemon
cfg = config.from_args(["--backend", "mock", "--mock-devices", "1",
                        "--listen-host", "127.0.0.1", "--listen-port", "0",
                        "--interval", "0.1", "--attribution", "off"])
d = daemon.Daemon(cfg)
d.start()
try:
    base = f"http://127.0.0.1:{d.server.port}"
    urllib.request.urlopen(base + "/debug/burst?arm=5").read()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        text = d.registry.rendered()[0].decode()
        if "kts_power_burst_samples_total" in text and "kts_host_" in text:
            break
        time.sleep(0.05)
    host = json.loads(urllib.request.urlopen(base + "/debug/host").read())
finally:
    d.stop()
print(json.dumps({"burst": "kts_power_burst_samples_total" in text,
                  "host": "kts_host_" in text, "enabled": host["enabled"],
                  "loaded": sorted(sys.modules)}))
"""


def _no_torch(loaded: list[str]) -> list[str]:
    return [m for m in loaded
            if m == "torch" or m.startswith("torch.") or _forbidden(m)]


def test_the_daemon_path_imports_no_torch():
    """The DaemonSet image carries no CUDA userspace beyond NVML: the
    daemon, its CLI, its NVML backend, the doctor and the profiler must
    not pull torch in (nor, as everywhere, JAX or the reference)."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_DAEMON_PATH],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert _no_torch(loaded) == []


def test_a_doctor_pass_imports_no_torch():
    proc = subprocess.run([sys.executable, "-c", _RUN_DOCTOR], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["rc"] == 0
    assert _no_torch(report["loaded"]) == []


def test_the_burst_sampler_and_host_signals_import_no_torch():
    proc = subprocess.run([sys.executable, "-c", _RUN_DAEMON_NODE_FEATURES],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["burst"] and report["host"] and report["enabled"]
    assert _no_torch(report["loaded"]) == []
