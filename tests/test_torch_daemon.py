"""The port's daemon against the JAX package's.

- The two ``PollLoop``s over ``MockCollector(4)``, with what the daemon
  wires (attribution behind the label fence, process holders, the
  supervisor's health self-metrics), ticked together on one injected
  clock: identical per-device series, the same self-metric families, and
  the deterministic self-metrics line for line.
- ``python -m kube_gpu_stats_tpu_torch --backend mock`` end to end, the
  way ``tests/test_daemon_e2e.py`` checks the reference: scrapes advance,
  interconnect rates from the second tick, the textfile mirrors a scrape,
  ``/healthz`` names its components, SIGTERM exits 0.
- ``--backend null``, the null → NVML upgrade through the watcher, the
  flag surface (the reference's defaults; unwired flags rejected, the
  fleet-lens flags accepted with the reference's values) and the
  subcommands' usage errors.
"""

import pathlib
import re
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from kube_gpu_stats_tpu import config as ref_config
from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu.collectors.mock import MockCollector as RefMock
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.resilience import CircuitBreaker as RefBreaker
from kube_gpu_stats_tpu.supervisor import Supervisor as RefSupervisor
from kube_gpu_stats_tpu import wal as ref_wal
from kube_gpu_stats_tpu_torch import cli, config, daemon
from kube_gpu_stats_tpu_torch import wal as port_wal
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.config import Config
from kube_gpu_stats_tpu_torch.native import nvml as binding
from kube_gpu_stats_tpu_torch.native.nvml import NvmlError
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry
from kube_gpu_stats_tpu_torch.resilience import CircuitBreaker
from kube_gpu_stats_tpu_torch.supervisor import Supervisor
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml

ROOT = pathlib.Path(__file__).resolve().parent.parent
PER_DEVICE = {spec.name for spec in ref_schema.PER_DEVICE_METRICS}
DETERMINISTIC = {
    "collector_devices", "collector_poll_errors_total",
    "kts_tick_plan_compiles_total", "kts_tick_plan_cache_hits_total",
    "collector_build_info", "kts_build_info", ref_schema.SELF_ALLOCATABLE.name,
    ref_schema.CARDINALITY_FENCED.name, ref_schema.COMPONENT_HEALTHY.name,
    ref_schema.COMPONENT_RESTARTS.name, ref_schema.THREAD_RESTART_STORMS.name,
    ref_schema.BREAKER_STATE.name, ref_schema.BREAKER_TRIPS.name,
}


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


class Attribution:
    """Device 0's pod changes every tick (the fence caps it), device 1
    keeps one pod, the rest have none."""

    def __init__(self):
        self.tick = 0

    def lookup(self, device):
        if device.index == 0:
            return {"pod": f"pod-{self.tick}", "namespace": "ns",
                    "container": "main"}
        if device.index == 1:
            return {"pod": "steady", "namespace": "ns", "container": "main"}
        return {}

    def allocatable(self):
        return {"nvidia.com/gpu": 4}


def openers(path):
    if path == "/dev/accel0":
        return [("123", "python", "0a1b2c3d-0000-1111-2222-333344445555",
                 1.0)]
    if path == "/dev/accel1":
        return [("7", "train", "", 1.0), ("", "_overflow", "", 3.0)]
    return []


def _families(text: str) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            current = line.split()[2]
        out.setdefault(current, []).append(line)
    return out


def _supervised(supervisor_cls, breaker_cls, clock):
    supervisor = supervisor_cls(clock=clock)
    supervisor.register("poll", is_alive=lambda: True)
    breaker = breaker_cls("kubelet", failure_threshold=1, clock=clock)
    breaker.record_failure("socket gone")
    supervisor.register_breaker_provider(lambda: {"kubelet": breaker})
    return supervisor


def test_poll_loops_agree_over_the_mock_with_the_daemon_wiring():
    # The store-health registries are process-global: a server an earlier
    # test of this worker started would add its accept fence's kts_store_*
    # to one side only.
    ref_wal.reset_store_stats()
    port_wal.reset_store_stats()
    clock = Clock()
    attributions = (Attribution(), Attribution())
    loops = []
    for loop_cls, registry, mock, sup_cls, breaker_cls, attribution in (
            (RefPollLoop, RefRegistry(native=False), RefMock(4),
             RefSupervisor, RefBreaker, attributions[0]),
            (PollLoop, Registry(), MockCollector(4), Supervisor,
             CircuitBreaker, attributions[1])):
        supervisor = _supervised(sup_cls, breaker_cls, clock)
        loops.append((loop_cls(
            mock, registry, interval=1.0, deadline=30.0, version="test",
            attribution=attribution, process_openers=openers,
            health_stats=supervisor.contribute, label_value_cap=2,
            drop_labels=("container",), clock=clock), registry))
    try:
        for tick in range(6):
            for attribution in attributions:
                attribution.tick = tick
            texts = []
            for loop, registry in loops:
                loop.tick()
                texts.append(_families(registry.rendered()[0].decode()))
            want, got = texts
            assert ({f: v for f, v in got.items() if f in PER_DEVICE}
                    == {f: v for f, v in want.items() if f in PER_DEVICE})
            assert sorted(f for f in got if f not in PER_DEVICE) == \
                sorted(f for f in want if f not in PER_DEVICE)
            for family in DETERMINISTIC & set(want):
                assert got[family] == want[family], family
            clock.now += 1.0
    finally:
        for loop, _ in loops:
            loop.stop()
    assert {ref_schema.CARDINALITY_FENCED.name, ref_schema.PROCESS_OPEN.name,
            ref_schema.SELF_ALLOCATABLE.name,
            ref_schema.BREAKER_STATE.name} <= set(want)
    text = "\n".join(got[ref_schema.PROCESS_OPEN.name])
    assert 'comm="_overflow"' in text and 'pid="123"' in text
    assert 'pod="overflow"' in "\n".join(got["accelerator_up"])
    assert 'container=""' in "\n".join(got["accelerator_up"])


def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return resp.read().decode()


def _start_cli(args, env=None):
    proc = subprocess.Popen(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", *args],
        cwd=ROOT, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True, env=env)
    deadline = time.monotonic() + 60
    lines = []
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        match = re.search(r"listening on [^:\s]+:(\d+)", line)
        if match:
            return proc, int(match.group(1))
    proc.kill()
    raise AssertionError(f"daemon never listened: {lines}")


def _info_backend(text: str) -> str:
    line = next(line for line in text.splitlines()
                if line.startswith("collector_build_info{"))
    return re.search(r'backend="([^"]*)"', line).group(1)


def _series_value(text: str, prefix: str) -> float:
    return float(next(line for line in text.splitlines()
                      if line.startswith(prefix)).rsplit(" ", 1)[1])


def test_cli_mock_daemon_end_to_end(tmp_path):
    proc, port = _start_cli(
        ["--backend", "mock", "--mock-devices", "4", "--listen-host",
         "127.0.0.1", "--listen-port", "0", "--interval", "0.1",
         "--attribution", "off", "--textfile-dir", str(tmp_path)])
    try:
        deadline = time.monotonic() + 30
        while True:
            first = _scrape(port)
            if "accelerator_ici_link_bandwidth_bytes_per_second{" in first:
                break
            assert time.monotonic() < deadline, first
            time.sleep(0.05)
        time.sleep(0.35)
        second = _scrape(port)
        assert first.count("accelerator_up{") == 4
        for family in ("accelerator_duty_cycle",
                       "accelerator_memory_used_bytes",
                       "accelerator_memory_total_bytes",
                       "accelerator_power_watts",
                       "accelerator_energy_joules_total",
                       "collector_poll_duration_seconds_bucket",
                       "collector_build_info", "kts_component_healthy"):
            assert family in second, family
        count = 'collector_poll_duration_seconds_count'
        assert _series_value(second, count) > _series_value(first, count)
        assert _info_backend(second) == "mock"
        # The textfile mirrors a scrape of the same publish.
        for _ in range(50):
            before = (tmp_path / "accelerator.prom").read_text()
            body = _scrape(port)
            after = (tmp_path / "accelerator.prom").read_text()
            if before == body == after:
                break
        else:
            raise AssertionError("textfile never matched a scrape")
        assert not list(tmp_path.glob("*.tmp"))
        healthz = _scrape(port, "/healthz")
        assert healthz.startswith("ok\n")
        assert "component=poll state=healthy" in healthz
        assert "component=render-warmer state=healthy" in healthz
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=5)
    assert rc == 0


def test_null_daemon_schema_valid():
    d = daemon.Daemon(Config(backend="null", interval=0.05,
                             listen_host="127.0.0.1", listen_port=0,
                             attribution="off"))
    d.start()
    try:
        assert d.registry.wait_for_publish(0, timeout=5)
        body = _scrape(d.server.port)
        assert "collector_devices 0" in body
        assert "accelerator_up" not in body
        assert _info_backend(body) == "null"
    finally:
        d.stop()


def test_auto_backend_upgrades_from_null_when_the_driver_appears(
        monkeypatch):
    fake = FakeNvml([FakeDevice("GPU-0", 0), FakeDevice("GPU-1", 1)],
                    init_error=binding.NVML_ERROR_DRIVER_NOT_LOADED)
    monkeypatch.setattr(daemon, "_nvml_collector",
                        lambda: NvmlCollector(fake))
    d = daemon.Daemon(Config(backend="auto", interval=0.05,
                             rediscovery_interval=0.1,
                             listen_host="127.0.0.1", listen_port=0,
                             attribution="off"))
    assert d.collector.name == "null"
    assert d.upgrade_watcher is not None
    d.start()
    try:
        assert d.registry.wait_for_publish(0, timeout=5)
        assert "accelerator_up" not in _scrape(d.server.port)
        fake.init_error = None  # the driver is loaded
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            body = _scrape(d.server.port)
            if body.count("accelerator_up{") == 2:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("auto backend never upgraded from null")
        assert _info_backend(body) == "nvml"
        assert d.collector.name == "nvml"
    finally:
        d.stop()
    assert fake.shutdown_calls == 1


def test_auto_backend_with_a_driver_serves_nvml(monkeypatch):
    fake = FakeNvml([FakeDevice("GPU-0", 0)])
    monkeypatch.setattr(daemon, "_nvml_collector",
                        lambda: NvmlCollector(fake))
    d = daemon.Daemon(Config(backend="auto", listen_host="127.0.0.1",
                             listen_port=0, attribution="off"))
    d.start()
    try:
        assert d.collector.name == "nvml"
        assert d.upgrade_watcher is None
    finally:
        d.stop()
    assert fake.shutdown_calls == 1


def test_backend_nvml_failure_exits_non_zero(monkeypatch, caplog):
    def failing():
        raise NvmlError(binding.NVML_ERROR_DRIVER_NOT_LOADED,
                        "Driver Not Loaded")

    monkeypatch.setattr(daemon, "_nvml_collector", failing)
    assert daemon.run(Config(backend="nvml", listen_port=0)) == 1
    assert "Driver Not Loaded" in caplog.text


@pytest.mark.parametrize("argv", [
    ["--passthrough-unknown", "on"],
    ["--libtpu-addr", "127.0.0.2"],
    ["--slo-freshness-target", "0.9"],
    ["--no-native"],
    ["--slo-straggler-target", "0.9"],
    ["--slo-straggler-ratio", "0.5"],
    ["--libtpu-ports", "8431,8432"],
    ["--libtpu-ports", "8431"],
    ["--no-fleet-lens"],
    ["--backend", "tpu"],
    ["--backend", "gpu"],
])
def test_unwired_reference_flags_are_rejected(argv, capsys):
    """The reference accepts each of them. The port refuses the ones it
    does not wire; the fleet-lens flags it carries, as the reference's
    daemon does, so a manifest written for either parses alike."""
    want = ref_config.from_args(argv)
    if argv[0] == "--no-native":
        # Wired: the port's host fast paths (the reference's switch
        # turns off its own).
        assert config.from_args(argv).use_native == want.use_native
        return
    if argv[0].startswith(("--slo-", "--no-fleet-lens")):
        got = config.from_args(argv)
        for field in ("fleet_lens", "slo_freshness_target",
                      "slo_straggler_target", "slo_straggler_ratio"):
            assert getattr(got, field) == getattr(want, field), field
        return
    with pytest.raises(SystemExit) as info:
        config.from_args(argv)
    assert info.value.code == 2
    assert "usage:" in capsys.readouterr().err


@pytest.mark.parametrize("argv,env", [
    (["--slo-freshness-target", "0.9", "--slo-straggler-target", "0.6",
      "--slo-straggler-ratio", "1"], {}),
    (["--no-fleet-lens"], {}),
    ([], {"KTS_SLO_FRESHNESS_TARGET": "0.995",
          "KTS_SLO_STRAGGLER_RATIO": "0.1", "KTS_NO_FLEET_LENS": "1"}),
], ids=range(3))
def test_the_fleet_lens_flags_parse_as_the_reference(monkeypatch, argv, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got, want = config.from_args(argv), ref_config.from_args(argv)
    for field in ("fleet_lens", "slo_freshness_target",
                  "slo_straggler_target", "slo_straggler_ratio"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("argv", [["--slo-freshness-target", "1"],
                                  ["--slo-straggler-target", "0"],
                                  ["--slo-straggler-ratio", "0"],
                                  ["--slo-straggler-ratio", "1.01"]],
                         ids=range(4))
def test_bad_fleet_lens_values_are_refused_as_the_reference(argv, capsys):
    messages = []
    for mod in (config, ref_config):
        with pytest.raises(SystemExit) as info:
            mod.from_args(argv)
        assert info.value.code == 2
        messages.append(capsys.readouterr().err.strip().splitlines()[-1]
                        .split("error: ", 1)[-1])
    assert messages[0] == messages[1]
    assert "must be in" in messages[0]


def test_flags_keep_the_reference_defaults_and_environment(monkeypatch):
    port_args = vars(config.build_parser().parse_args([]))
    ref_args = vars(ref_config.build_parser().parse_args([]))
    for dest, value in port_args.items():
        assert dest in ref_args, dest
        assert value == ref_args[dest], dest
    env = {"KTS_INTERVAL": "2.5", "KTS_LISTEN_PORT": "9555",
           "KTS_DROP_LABELS": "pod,namespace", "KTS_NO_TRACE": "1",
           "KTS_ATTRIBUTION": "checkpoint", "KTS_MAX_PROCESS_SERIES": "8",
           "KTS_METRICS_EXCLUDE": "accelerator_power_*"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port_cfg = config.from_args([])
    ref_cfg = ref_config.from_args([])
    for field in ("interval", "listen_port", "drop_labels", "trace_enabled",
                  "attribution", "max_process_series", "disabled_metrics",
                  "backend", "deadline", "rediscovery_interval",
                  "label_value_cap", "device_processes", "kubelet_socket",
                  "checkpoint_path", "attribution_interval", "mock_devices"):
        assert getattr(port_cfg, field) == getattr(ref_cfg, field), field


def test_config_file_layers_under_flags(tmp_path):
    path = tmp_path / "kts.yaml"
    path.write_text("interval: 3.0\nbackend: mock\ndevice_processes: off\n")
    cfg = config.from_args(["--config", str(path), "--interval", "0.5"])
    assert (cfg.interval, cfg.backend, cfg.device_processes) == \
        (0.5, "mock", "off")
    path.write_text("libtpu_addr: 127.0.0.2\n")
    with pytest.raises(SystemExit):
        config.from_args(["--config", str(path)])


@pytest.mark.parametrize("sub", ["doctor", "top", "hub"])
def test_subcommands_not_ported_exit_2(sub, capsys, tmp_path):
    """Every subcommand runs, and exits 2 on a usage error the
    reference's way: the doctor's ``--at`` with neither ``--fleet`` nor
    ``--efficiency``, the hub's SLO target out of range, top when no
    target answered."""
    argv = {"doctor": ["doctor", "--at", "10m"],
            "hub": ["hub", "--slo-freshness-target", "2", "--once"],
            "top": ["top", "--once", str(tmp_path / "absent.prom")]}[sub]
    try:
        rc = cli.main(argv)
    except SystemExit as exc:
        rc = exc.code
    assert rc == 2
    err = capsys.readouterr().err
    assert {"doctor": "--at only makes sense with --fleet or --efficiency",
            "hub": "--slo-freshness-target must be in (0, 1)",
            "top": "absent.prom"}[sub] in err


@pytest.mark.parametrize("argv", [["validate", "--help"],
                                  ["loadgen", "--help"],
                                  ["doctor", "--help"],
                                  ["hub", "--help"],
                                  ["top", "--help"]])
def test_ported_subcommands_dispatch(argv, capsys):
    # argparse answers --help with exit 0: the subcommand's own parser ran.
    try:
        rc = cli.main(argv)
    except SystemExit as exc:
        rc = exc.code
    assert rc == 0
    assert "usage:" in capsys.readouterr().out


# -- the node-feature flags: defaults, environment, validation ----------------

NODE_FIELDS = ("burst_mode", "burst_hz", "burst_hold", "burst_ring",
               "host_stats", "cgroup_root", "sysfs_root", "proc_root",
               "pipeline_fetch")


@pytest.mark.parametrize("argv", [
    [],
    ["--burst-mode", "continuous", "--burst-hz", "250", "--burst-hold",
     "5", "--burst-ring", "16"],
    ["--burst-mode", "off", "--no-host-stats", "--no-pipeline-fetch"],
    ["--cgroup-root", "/host/cgroup", "--sysfs-root", "/host/sys",
     "--proc-root", "/host/proc"],
])
def test_node_feature_flags_parse_as_the_reference(argv):
    port_cfg, ref_cfg = config.from_args(argv), ref_config.from_args(argv)
    for field in NODE_FIELDS:
        assert getattr(port_cfg, field) == getattr(ref_cfg, field), field


def test_node_feature_flags_read_the_environment(monkeypatch):
    env = {"KTS_BURST_MODE": "continuous", "KTS_BURST_HZ": "50",
           "KTS_BURST_HOLD": "12.5", "KTS_BURST_RING": "64",
           "KTS_NO_HOST_STATS": "true", "KTS_CGROUP_ROOT": "/c",
           "KTS_SYSFS_ROOT": "/s", "KTS_NO_PIPELINE_FETCH": "1"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port_cfg, ref_cfg = config.from_args([]), ref_config.from_args([])
    for field in NODE_FIELDS:
        assert getattr(port_cfg, field) == getattr(ref_cfg, field), field
    assert (port_cfg.burst_mode, port_cfg.burst_ring, port_cfg.host_stats,
            port_cfg.pipeline_fetch) == ("continuous", 64, False, False)


@pytest.mark.parametrize("argv,env", [
    (["--burst-mode", "sometimes"], {}),
    ([], {"KTS_BURST_MODE": "sometimes"}),
    (["--burst-hz", "0"], {}),
    (["--burst-hz", "-5"], {}),
    (["--burst-hold", "0"], {}),
    (["--burst-ring", "15"], {}),
    (["--burst-ring", "many"], {}),
])
def test_bad_node_feature_flags_fail_as_the_reference(argv, env, monkeypatch,
                                                      capsys):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    errors = []
    for module in (ref_config, config):
        with pytest.raises(SystemExit) as info:
            module.from_args(argv)
        assert info.value.code == 2
        # The usage error's message, without the program's name.
        errors.append(capsys.readouterr().err.strip().splitlines()[-1]
                      .split(" error: ", 1)[1])
    assert errors[1] == errors[0]
