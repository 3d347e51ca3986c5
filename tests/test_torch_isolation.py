"""The port imports neither JAX nor anything of kube_gpu_stats_tpu.

Checked twice: in a fresh subprocess (tests/conftest.py imports JAX in
this one) that imports every module of the port and inspects
sys.modules, and statically over every import statement of the port's
sources (the sims and the testing fixtures among them) and
chip_smoke.py.
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
                   "testing.faultfs", "snappy", "spillq", "remote_write",
                   "proto.prompb", "proto.prompb2", "delta",
                   "testing.egress_sink", "hub", "top", "cardinality",
                   "fleetlens", "history", "ingestproc", "efficiency",
                   "linkloc", "ici", "topology", "bench",
                   "testing.host_fixture", "testing.nvml_faults", "sims",
                   "sims.chaos", "sims.localfault", "sims.federation",
                   "sims.energy", "sims.host", "sims.fleet"):
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


# The daemon path's modules, then a daemon (mock backend) with all three
# push senders on — the delta publisher with a spill dir, the durable
# remote writer, the Pushgateway pusher — shipping into the egress sink
# until every path has delivered.
_IMPORT_DAEMON_PATH = """
import json, sys, tempfile, time
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
from kube_gpu_stats_tpu_torch import config, daemon
from kube_gpu_stats_tpu_torch.testing.egress_sink import EgressSink
sink = EgressSink().start()
work = tempfile.mkdtemp()
d = daemon.Daemon(config.from_args([
    "--backend", "mock", "--mock-devices", "1", "--listen-host",
    "127.0.0.1", "--listen-port", "0", "--interval", "0.1",
    "--attribution", "off", "--hub-url", sink.url, "--hub-spill-dir",
    work + "/spill", "--remote-write-url", sink.url + "/api/v1/write",
    "--remote-write-wal-dir", work + "/rw", "--remote-write-shards", "2",
    "--remote-write-protocol", "2.0", "--remote-write-interval", "0.2",
    "--pushgateway-url", sink.url]))
d.start()
try:
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not (
            sink.applied() and sink.writes() and sink.pushes()):
        time.sleep(0.05)
    senders = sorted(d._egress_payload()["senders"])
finally:
    d.stop()
    sink.stop()
shipped = [bool(sink.applied()), bool(sink.writes()), bool(sink.pushes())]
print(json.dumps({"senders": senders, "shipped": shipped,
                  "loaded": sorted(sys.modules)}))
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
    daemon, its CLI, its NVML backend, its push senders, the doctor and
    the profiler must not pull torch in (nor, as everywhere, JAX or the
    reference)."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_DAEMON_PATH],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["senders"] == ["delta", "pushgateway", "remote_write"]
    assert report["shipped"] == [True, True, True]
    assert _no_torch(report["loaded"]) == []
    assert EXTENSION in report["loaded"]  # the render ran through it


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


# The hub and top, each run once through the CLI over a saved exposition
# (the hub with its ingest checkpoint and a push session too).
_RUN_HUB_AND_TOP = """
import contextlib, io, json, os, sys, tempfile
from kube_gpu_stats_tpu_torch import cli, delta, hub
work = tempfile.mkdtemp()
target = os.path.join(work, "node.prom")
with open(target, "w") as handle:
    handle.write('accelerator_up{chip="0",slice="s",worker="w"} 1\\n')
out = io.StringIO()
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    rc_hub = cli.main(["hub", "--once", target, "--ingest-checkpoint",
                       os.path.join(work, "ingest.json")])
    rc_top = cli.main(["top", "--once", "--json", target])
h = hub.Hub([target], interval=1.0)
pushed = h.delta.handle(delta.encode_full("n", 1, 1, "a 1\\n"))[0]
h.refresh_once()
h.stop()
print(json.dumps({"rc": [rc_hub, rc_top, pushed],
                  "loaded": sorted(sys.modules)}))
"""


def test_the_hub_and_top_import_no_torch():
    """The hub runs from the DaemonSet image, which has no torch; so
    does top."""
    proc = subprocess.run([sys.executable, "-c", _RUN_HUB_AND_TOP],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["rc"] == [0, 0, 200]
    assert _no_torch(report["loaded"]) == []
    assert EXTENSION in report["loaded"]  # the slot store and the fold


EXTENSION = "kube_gpu_stats_tpu_torch.native._wirefast"


# The sims' modules and the card's fault wrapper alone, then a daemon
# sim (energy: an NVML daemon over the fake, restarted, the doctor), hub
# sims (chaos's hostile frames: a hub, its ingest, lorises, a quarantine;
# skew's stuck peer: a gated hub, an NVML daemon's publisher, the doctor;
# partition's bounded spool; a small label bomb), and the fault wrapper
# over the fake.
_RUN_SIMS = """
import json, logging, sys, tempfile
import kube_gpu_stats_tpu_torch.sims
import kube_gpu_stats_tpu_torch.sims.cardinality
import kube_gpu_stats_tpu_torch.sims.chaos
import kube_gpu_stats_tpu_torch.sims.energy
import kube_gpu_stats_tpu_torch.sims.federation
import kube_gpu_stats_tpu_torch.sims.fleet
import kube_gpu_stats_tpu_torch.sims.host
import kube_gpu_stats_tpu_torch.sims.localfault
import kube_gpu_stats_tpu_torch.sims.partition
import kube_gpu_stats_tpu_torch.sims.query
import kube_gpu_stats_tpu_torch.sims.skew
import kube_gpu_stats_tpu_torch.testing.nvml_faults
alone = sorted(sys.modules)
logging.disable(logging.CRITICAL)
from kube_gpu_stats_tpu_torch.sims import (cardinality, chaos, energy,
                                           partition, skew)
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml
from kube_gpu_stats_tpu_torch.testing.nvml_faults import NvmlFaults
wrapped = NvmlFaults(FakeNvml([FakeDevice("GPU-a", 0)]))
wrapped.init()
cardinality.BOMB_SERIES = 600  # a small bomb
with tempfile.TemporaryDirectory() as tmp:
    ok = [energy.run().ok, chaos.scenario_hostile().ok,
          skew.scenario_stuck_skew_and_doctor(tmp).ok,
          partition.scenario_beyond_bounds(tmp).ok,
          cardinality.run().ok,
          wrapped.uuid(wrapped.handle(0)) == "GPU-a"]
print(json.dumps({"ok": ok, "alone": alone, "loaded": sorted(sys.modules)}))
"""


def test_the_sims_and_the_fault_wrapper_import_no_torch():
    """The sims run daemons and hubs, which the DaemonSet image runs
    without torch: the sims' modules and ``testing.nvml_faults`` load
    neither torch, nor JAX, nor the reference, alone or while a daemon
    sim and a hub sim run."""
    proc = subprocess.run([sys.executable, "-c", _RUN_SIMS], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] == [True] * 6
    assert _no_torch(report["alone"]) == []
    assert _no_torch(report["loaded"]) == []


def test_the_host_build_reads_no_file_outside_the_port():
    """The extension's g++ command names one source, the port's own
    ``native/wirefast.cc``, which includes only system headers (Python's
    and zlib's): nothing of the reference, nor of any path into it."""
    from kube_gpu_stats_tpu_torch.native import _hostbuild

    out = PORT / "native" / "build" / "probe.so"
    command = _hostbuild.command(out)
    named = [arg for arg in command
             if arg.endswith((".cc", ".cpp", ".c", ".h", ".so", ".o"))]
    assert named == [str(PORT / "native" / "wirefast.cc"), str(out)]
    assert not any("kube_gpu_stats_tpu/" in arg or
                   arg.rstrip("/").endswith("kube_gpu_stats_tpu")
                   for arg in command)
    includes = [line.split()[1] for line in
                _hostbuild.SOURCE.read_text().splitlines()
                if line.startswith("#include")]
    assert includes and all(name.startswith("<") for name in includes)


# The measurement module alone (its import must load no torch: only the
# two real-mode harnesses import it, inside the call), then host
# measurements over the hub, the ingest, the stores and host_fixture, the
# ingest profile, and the NVML harness as far as this machine lets it go.
_RUN_BENCH = """
import json, sys
import kube_gpu_stats_tpu_torch.bench as bench
import kube_gpu_stats_tpu_torch.profiler
import kube_gpu_stats_tpu_torch.testing.host_fixture
alone = sorted(sys.modules)
from kube_gpu_stats_tpu_torch import profiler
results = [bench.measure_quiet_tick_delta(),
           bench.measure_hub_merge(workers=2, chips=1, refreshes=2),
           bench.measure_warm_restart(pushers=8),
           bench.measure_degraded_overhead(ticks=4),
           bench.measure_hoststats(reads=2, pods=2)]
_report, summary = profiler.profile_ingest(sources=4, waves=1)
_real, probe = bench.try_real_harness(ticks=2, warmup=1, colaunch=False)
print(json.dumps({"ok": [r is not None for r in results],
                  "path": summary["path"], "nvml": probe["nvml_init"],
                  "alone": alone, "loaded": sorted(sys.modules)}))
"""


def test_the_measurement_module_imports_no_torch():
    """``import kube_gpu_stats_tpu_torch.bench`` loads no torch, and
    neither do its host measurements, ``profile_ingest`` or the NVML
    harness; bench, profiler and testing.host_fixture load neither JAX
    nor the reference."""
    proc = subprocess.run([sys.executable, "-c", _RUN_BENCH], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] == [True] * 5 and report["path"] == "native"
    assert report["nvml"]
    assert _no_torch(report["alone"]) == []
    assert _no_torch(report["loaded"]) == []


# The fleet lens's five modules alone, then a hub with the lens on over a
# saved exposition, served with /debug/fleet and /debug/efficiency, read
# by the doctor's --fleet, --efficiency and --fleet --at rows.
_RUN_FLEET_LENS = """
import json, os, sys, tempfile
import kube_gpu_stats_tpu_torch.efficiency
import kube_gpu_stats_tpu_torch.fleetlens
import kube_gpu_stats_tpu_torch.ici
import kube_gpu_stats_tpu_torch.linkloc
import kube_gpu_stats_tpu_torch.topology
alone = sorted(sys.modules)
from kube_gpu_stats_tpu_torch import doctor, history, hub
from kube_gpu_stats_tpu_torch.exposition import MetricsServer
work = tempfile.mkdtemp()
target = os.path.join(work, "node.prom")
with open(target, "w") as handle:
    handle.write('accelerator_up{chip="0",pod="p",namespace="n",'
                 'slice="s",worker="w"} 1\\n')
store = history.HistoryStore()
h = hub.Hub([target], interval=1.0, history=store, energy_audit_key="k")
h.refresh_once()
server = MetricsServer(h.registry, host="127.0.0.1", port=0,
                       fleet_provider=h.fleet, history_provider=store,
                       efficiency_provider=h.efficiency_payload)
server.start()
try:
    base = f"http://127.0.0.1:{server.port}"
    rows = [doctor.check_fleet(base).status,
            doctor.check_efficiency(base, "k").status,
            doctor.check_fleet_at(base, 1.0).status]
finally:
    server.stop()
    h.stop()
print(json.dumps({"rows": rows, "alone": alone,
                  "loaded": sorted(sys.modules)}))
"""


def test_the_fleet_lens_imports_no_torch():
    """fleetlens, efficiency, linkloc, ici and topology import neither
    torch, nor JAX, nor the reference: alone, and under a hub refresh
    with the lens on that the doctor's lens rows read."""
    proc = subprocess.run([sys.executable, "-c", _RUN_FLEET_LENS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["rows"] == ["ok", "ok", "warn"]
    assert _no_torch(report["alone"]) == []
    assert _no_torch(report["loaded"]) == []


# A pool of one acceptor child, started as the hub starts it. A
# sitecustomize on the children's PYTHONPATH (the pool keeps the
# caller's entries after its own) writes each child's sys.modules when
# it exits; the pool's stop ends the child with SIGTERM, a clean exit.
# The child installs its SIGTERM handler only once it serves, after the
# pool has seen it ready: until then the probe's own handler makes the
# signal a clean exit too.
_SITECUSTOMIZE = """
import atexit, json, os, signal, sys

def _dump():
    path = os.path.join(os.environ["KTS_MODULES_PROBE"],
                        f"{os.getpid()}.json")
    with open(path, "w") as handle:
        json.dump(sorted(sys.modules), handle)

def _exit(*_):
    sys.exit(0)

atexit.register(_dump)
signal.signal(signal.SIGTERM, _exit)
"""

_RUN_POOL = """
import json, os, sys
probe = sys.argv[1]
os.environ["PYTHONPATH"] = probe
os.environ["KTS_MODULES_PROBE"] = probe
from kube_gpu_stats_tpu_torch import hub
from kube_gpu_stats_tpu_torch.ingestproc import IngestProcPool
h = hub.Hub([], targets_provider=lambda: [], interval=5.0)
pool = IngestProcPool(h.delta.handle, host="127.0.0.1", port=0, procs=1)
pool.start()
try:
    pid = pool._children[0].pid
    with open(f"/proc/{pid}/cmdline", "rb") as handle:
        cmdline = [part.decode() for part in handle.read().split(b"\\0")]
finally:
    pool.stop()
    h.stop()
with open(os.path.join(probe, f"{pid}.json")) as handle:
    child_loaded = json.load(handle)
print(json.dumps({"cmdline": cmdline, "child_loaded": child_loaded,
                  "loaded": sorted(sys.modules)}))
"""


def test_the_ingest_child_is_the_ports_and_imports_no_reference(tmp_path):
    """The pool must start the port's child module: the reference's
    child speaks the same protocol, so a copied module name would pass
    every other test while running the reference under the port's hub
    (the import-statement walk above cannot see a name in an argv)."""
    (tmp_path / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    proc = subprocess.run([sys.executable, "-c", _RUN_POOL, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["cmdline"][1:3] == ["-m",
                                      "kube_gpu_stats_tpu_torch.ingestproc"]
    assert "kube_gpu_stats_tpu_torch.ingestproc" in report["child_loaded"] \
        or "__main__" in report["child_loaded"]
    assert "kube_gpu_stats_tpu_torch.supervisor" in report["child_loaded"]
    assert _no_torch(report["child_loaded"]) == []
    assert _no_torch(report["loaded"]) == []
