"""The port's node doctor against the JAX package's.

- Pure rows on the same inputs give the reference's row, field for
  field: ``trace_post_mortem`` on canned /debug payloads, ``check_scrape``
  on the same saved ``.prom`` text, ``check_live_resilience`` on the same
  exposition, ``resilience_result`` on breakers in the same states, and
  ``check_attribution`` against the reference's fake kubelet and a
  checkpoint file.
- ``check_poll`` on ``--backend mock``: the same device, up and
  ``accelerator_*`` series counts as the reference's.
- The ``nvml`` row on ``testing.fake_nvml``: FAIL under ``--backend nvml``
  when the library is absent or init fails, WARN under ``auto``, OK with
  the versions and per-card UUID/minor; its NVML reference is its own.
- ``_bounded``, ``check_embedded_viability`` and ``main``'s flags, exit
  codes and ``--json`` shape.
- The fleet-lens rows: ``fleet_post_mortem`` on canned rollups (the
  worst node, anomalies, the joined host verdict, a suspect link whose
  endpoints it suppresses, burn over budget, a clean fleet), and
  ``check_fleet`` and ``check_fleet_at`` against live servers (a rollup
  served, a leaf hub walked, 404, unreachable, a ring with a straggler
  and a suspect link, a disabled ring): the reference's status, text
  and data.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

from kube_gpu_stats_tpu import config as ref_config
from kube_gpu_stats_tpu import doctor as ref_doctor
from kube_gpu_stats_tpu import resilience as ref_resilience
from kube_gpu_stats_tpu.proto import podresources as ref_pb
from kube_gpu_stats_tpu.testing.kubelet_server import (FakeKubeletServer,
                                                       tpu_pod)
from kube_gpu_stats_tpu_torch import config as port_config
from kube_gpu_stats_tpu_torch import daemon
from kube_gpu_stats_tpu_torch import doctor
from kube_gpu_stats_tpu_torch import resilience as port_resilience
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.native import nvml as binding
from kube_gpu_stats_tpu_torch.native.nvml import NvmlError
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml

ROOT = pathlib.Path(__file__).resolve().parent.parent
GPU = "nvidia.com/gpu"
UUIDS = [f"GPU-{i:08x}-aaaa-bbbb-cccc-{i:012x}" for i in range(4)]


def _row(result) -> dict:
    return dataclasses.asdict(result)


# -- trace_post_mortem ---------------------------------------------------------

def _ticks_payload(seed: int, blame: bool, dropped: int) -> dict:
    rng = np.random.default_rng(seed)
    seq = int(rng.integers(10, 100))
    row = {"kind": "tick", "seq": seq, "at": 1_700_000_000.5,
           "dur_ms": float(rng.uniform(1, 80)), "spans": 6,
           "meta": {"devices": 4}, "worst_phase": "env_round",
           "worst_phase_ms": float(rng.uniform(1, 40))}
    if blame:
        row["blame"] = {"span": "sample", "dur_ms": float(rng.uniform(1, 30)),
                        "attrs": {"device": "2", "port": 8431}}
    return {"enabled": True, "current_seq": seq + 5, "ticks_recorded": 16,
            "dropped_spans_total": dropped, "phases": {},
            "slowest": [row, dict(row, seq=seq - 7)]}


def _events(seq: int) -> list:
    # Within ±2 ticks of the slow one, and outside; one without a seq.
    return [{"id": i + 1, "tick_seq": seq + offset, "at": 0.0,
             "kind": kind, "detail": f"{kind} detail {i}", "attrs": {}}
            for i, (offset, kind) in enumerate(
                [(-3, "plan_compile"), (-2, "breaker"), (0, "component"),
                 (1, "cardinality_fenced"), (2, "breaker"), (3, "component")])
            ] + [{"id": 99, "tick_seq": None, "kind": "x", "detail": ""}]


@pytest.mark.parametrize("seed,blame,dropped,with_events", [
    (0, True, 0, True), (1, False, 0, True), (2, True, 7, False),
    (3, False, 3, True)])
def test_trace_post_mortem_equals_the_reference(seed, blame, dropped,
                                                with_events):
    ticks = _ticks_payload(seed, blame, dropped)
    events = _events(ticks["slowest"][0]["seq"]) if with_events else []
    got = doctor.trace_post_mortem(ticks, events)
    assert got == ref_doctor.trace_post_mortem(ticks, events)
    detail, data = got
    assert ("responsible: sample[device=2,port=8431]" in detail) == blame
    assert len(data["events"]) == (4 if with_events else 0)


# -- check_scrape / check_live_resilience --------------------------------------

def _exposition(devices: int = 2) -> str:
    registry = Registry()
    loop = PollLoop(MockCollector(num_devices=devices), registry)
    try:
        loop.tick()
    finally:
        loop.stop()
    return registry.snapshot().render()


def _violating(text: str) -> str:
    lines = text.splitlines()
    out = []
    for line in lines:
        if line.startswith("accelerator_duty_cycle{"):
            line = line.rsplit(" ", 1)[0] + " 150"
        if line.startswith("accelerator_memory_used_bytes{"):
            line = line.rsplit(" ", 1)[0] + " -1"
        out.append(line)
        if line.startswith("accelerator_up{"):
            out.append(line)  # a duplicate series
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("kind", ["clean", "violations", "empty"])
def test_check_scrape_equals_the_reference_on_saved_text(tmp_path, kind):
    text = _exposition()
    text = {"clean": text, "violations": _violating(text), "empty": ""}[kind]
    path = tmp_path / "saved.prom"
    path.write_text(text)
    got = doctor.check_scrape(str(path))
    assert _row(got) == _row(ref_doctor.check_scrape(str(path)))
    assert got.status == ("fail" if kind == "violations" else "ok")
    # The --url pair, off one fetch.
    rows = [_row(r) for r in doctor.check_url(str(path))]
    assert rows == [_row(r) for r in ref_doctor.check_url(str(path))]


def test_check_scrape_of_a_missing_file_equals_the_reference(tmp_path):
    target = str(tmp_path / "absent.prom")
    assert _row(doctor.check_scrape(target)) == \
        _row(ref_doctor.check_scrape(target))
    assert [_row(r) for r in doctor.check_url(target)] == \
        [_row(r) for r in ref_doctor.check_url(target)]


_BREAKER_TEXTS = {
    "closed": 'kts_breaker_state{component="kubelet"} 0\n',
    "half_open": ('kts_breaker_state{component="kubelet"} 0\n'
                  'kts_breaker_state{component="nvml"} 1\n'),
    "open": ('kts_breaker_state{component="kubelet"} 2\n'
             'kts_breaker_state{component="nvml"} 1\n'),
    "none": "accelerator_up 1\n",
}


@pytest.mark.parametrize("state", sorted(_BREAKER_TEXTS))
def test_check_live_resilience_equals_the_reference(tmp_path, state):
    text = _BREAKER_TEXTS[state]
    got = doctor.check_live_resilience("t", text=text)
    assert _row(got) == _row(ref_doctor.check_live_resilience("t", text=text))
    assert got.status == {"closed": "ok", "half_open": "warn",
                          "open": "fail", "none": "skip"}[state]
    path = tmp_path / "live.prom"
    path.write_text(text)
    assert _row(doctor.check_live_resilience(str(path))) == \
        _row(ref_doctor.check_live_resilience(str(path)))


# -- resilience_result ---------------------------------------------------------

def _breakers(resilience, states: tuple) -> dict:
    now = [0.0]
    out = {}
    for i, state in enumerate(states):
        b = resilience.CircuitBreaker(f"edge{i}", failure_threshold=2,
                                      recovery_time=5.0,
                                      clock=lambda: now[0])
        if state in ("tripped", "half_open", "open"):
            b.record_failure("first")
            b.record_failure(OSError("connect refused\n  retry later"))
        if state in ("tripped", "half_open"):
            now[0] += 10.0
            assert b.allow()
        if state == "tripped":
            b.record_success()
        out[b.name] = b
    return out


class _Collector:
    def __init__(self, breakers: dict) -> None:
        self._breakers = breakers

    def breakers(self) -> dict:
        return self._breakers


@pytest.mark.parametrize("states", [
    (), ("closed",), ("closed", "tripped"), ("half_open", "closed"),
    ("open", "half_open"), ("tripped", "open", "closed")])
def test_resilience_result_equals_the_reference(states):
    got = doctor.resilience_result(
        _Collector(_breakers(port_resilience, states)))
    want = ref_doctor.resilience_result(
        _Collector(_breakers(ref_resilience, states)))
    assert _row(got) == _row(want)
    assert doctor.resilience_result(object()).status == "skip"


# -- check_attribution ---------------------------------------------------------

def _configs(**fields):
    return port_config.Config(**fields), ref_config.Config(**fields)


def test_check_attribution_against_the_fake_kubelet(tmp_path):
    socket = str(tmp_path / "kubelet.sock")
    server = FakeKubeletServer(socket, allocatable=[
        ref_pb.ContainerDevices(GPU, tuple(UUIDS))])
    server.pods = [
        tpu_pod("train-0", "ml", "trainer", UUIDS[:2], resource=GPU),
        tpu_pod("infer-0", "serve", "server", [UUIDS[2]], resource=GPU)]
    with server:
        for mode in ("podresources", "auto"):
            port_cfg, ref_cfg = _configs(attribution=mode,
                                         kubelet_socket=socket)
            got = doctor.check_attribution(port_cfg)
            assert _row(got) == _row(ref_doctor.check_attribution(ref_cfg))
            assert got.status == "ok"
            assert "3 allocated device(s)" in got.detail


@pytest.mark.parametrize("mode", ["auto", "checkpoint", "podresources",
                                  "off"])
@pytest.mark.parametrize("with_file", [True, False])
def test_check_attribution_checkpoint_equals_the_reference(tmp_path, mode,
                                                            with_file):
    path = tmp_path / "kubelet_internal_checkpoint"
    if with_file:
        path.write_text(json.dumps({"Data": {"PodDeviceEntries": [
            {"PodUID": "uid-a", "ContainerName": "trainer",
             "ResourceName": GPU, "DeviceIDs": {"-1": UUIDS[:2]}},
        ], "RegisteredDevices": {GPU: UUIDS}}, "Checksum": 1}))
    port_cfg, ref_cfg = _configs(
        attribution=mode, kubelet_socket=str(tmp_path / "absent.sock"),
        checkpoint_path=str(path))
    assert _row(doctor.check_attribution(port_cfg)) == \
        _row(ref_doctor.check_attribution(ref_cfg))


def test_check_topology_reads_only_the_kts_environment(monkeypatch):
    for key in ("KTS_SLICE", "KTS_WORKER", "KTS_TOPOLOGY"):
        monkeypatch.delenv(key, raising=False)
    row = doctor.check_topology(port_config.Config())
    assert row.status == "warn"
    assert "KTS_SLICE/KTS_WORKER/KTS_TOPOLOGY)" in row.detail
    monkeypatch.setenv("KTS_SLICE", "h100-pool")
    monkeypatch.setenv("KTS_WORKER", "3")
    row = doctor.check_topology(port_config.Config())
    assert (row.status, row.detail) == \
        ("ok", "slice=h100-pool, topology=(unset), worker=3")


# -- check_poll ----------------------------------------------------------------

def _poll_counts(detail: str) -> str:
    """The row's detail up to its timing: backend, devices, up, series."""
    return detail.split(", tick p50")[0]


@pytest.mark.parametrize("devices", [1, 4, 0])
def test_check_poll_on_mock_counts_like_the_reference(devices):
    # A generous deadline: no wall-clock threshold decides the row here.
    argv = ["--backend", "mock", "--mock-devices", str(devices),
            "--deadline", "30"]
    got = doctor.check_poll(port_config.from_args(argv))
    want = ref_doctor.check_poll(ref_config.from_args(argv))
    assert [r.name for r in got] == [r.name for r in want] == \
        ["poll", "resilience"]
    assert _poll_counts(got[0].detail) == _poll_counts(want[0].detail)
    assert got[0].status == want[0].status
    assert _row(got[1]) == _row(want[1])
    if devices:
        assert got[0].data["up"] == devices
        assert got[0].data["accelerator_series"] == 27 * devices


def test_check_poll_fails_when_the_backend_cannot_start(monkeypatch):
    def failing():
        raise NvmlError(binding.NVML_ERROR_DRIVER_NOT_LOADED,
                        "Driver Not Loaded")

    monkeypatch.setattr(daemon, "_nvml_collector", failing)
    [row] = doctor.check_poll(port_config.Config(backend="nvml"))
    assert row.status == "fail"
    assert "Driver Not Loaded" in row.detail


def test_one_slow_read_does_not_serve_the_card_down_in_later_ticks(
        monkeypatch):
    # The 3rd of the five ticks' memory reads overruns the 50 ms
    # deadline by 70 ms. Back to back, ticks 4 and 5 would find it still
    # running and serve the card down; the doctor lets it finish first.
    fake = FakeNvml([FakeDevice(UUIDS[0], minor=2)])
    fake.devices[0].stalls["memory"] = (0.12, 3)
    monkeypatch.setattr(daemon, "_nvml_collector",
                        lambda: NvmlCollector(fake))
    poll, _ = doctor.check_poll(port_config.Config(backend="nvml"))
    assert fake.devices[0].calls["memory"] == 5
    assert poll.status == "ok"
    assert (poll.data["devices"], poll.data["up"]) == (1, 1)


@pytest.mark.parametrize("stall, ticks_up, late, status", [
    # The 5th memory read overruns the 50 ms deadline: the 5th tick
    # serves the card down, so a 6th follows once the read is in.
    ((0.12, 5), [1, 1, 1, 1, 0, 1], 1, "ok"),
    # Every read overruns it: the one extra tick is late too, and the
    # row serves the card down, its ticks at the deadline.
    ((0.08, 1), [0] * 6, 6, "warn"),
])
def test_a_late_read_in_the_last_tick_gets_one_more_tick(
        monkeypatch, stall, ticks_up, late, status):
    fake = FakeNvml([FakeDevice(UUIDS[0], minor=2)])
    fake.devices[0].stalls["memory"] = stall
    monkeypatch.setattr(daemon, "_nvml_collector",
                        lambda: NvmlCollector(fake))
    poll, _ = doctor.check_poll(port_config.Config(backend="nvml"))
    assert fake.devices[0].calls["memory"] == 6
    assert poll.status == status
    assert poll.data["ticks_up"] == ticks_up
    assert len(poll.data["ticks_ms"]) == 6
    assert poll.data["errors"] == {"deadline": late}
    assert (poll.data["devices"], poll.data["up"]) == (1, ticks_up[-1])
    assert f"poll errors deadline={late}" in poll.detail


def test_settle_waits_only_for_reads_past_their_deadline():
    fake = FakeNvml([FakeDevice(UUIDS[0], minor=2)])
    fake.devices[0].stalls["memory"] = (0.3, 1)
    collector = NvmlCollector(fake)
    loop = PollLoop(collector, Registry(), deadline=0.05,
                    pipeline_fetch=False)
    try:
        assert loop.settle(5.0)              # nothing outstanding
        loop.tick()
        assert not loop.settle(0.01)         # still inside its stall
        assert loop.settle(5.0)
    finally:
        loop.stop()
        collector.close()


# -- the nvml row --------------------------------------------------------------

def _fake(**kwargs) -> FakeNvml:
    return FakeNvml([FakeDevice(UUIDS[0], minor=2),
                     FakeDevice(UUIDS[1], minor=0, name="NVIDIA H100 PCIe")],
                    **kwargs)


@pytest.mark.parametrize("backend,status", [("nvml", "fail"),
                                            ("auto", "warn")])
@pytest.mark.parametrize("code", [binding.NVML_ERROR_LIBRARY_NOT_FOUND,
                                  binding.NVML_ERROR_DRIVER_NOT_LOADED])
def test_nvml_row_without_a_driver(monkeypatch, backend, status, code):
    monkeypatch.setattr(doctor, "_nvml_binding",
                        lambda: _fake(init_error=code))
    row = doctor.check_nvml(port_config.Config(backend=backend))
    assert (row.name, row.status) == ("nvml", status)
    assert row.data["init"] is False
    assert row.data["loaded"] is (code != binding.NVML_ERROR_LIBRARY_NOT_FOUND)
    assert row.data["code"] == code


def test_nvml_row_on_an_answering_driver(monkeypatch):
    fake = _fake(driver_version="580.159.03", cuda_driver_version=13000)
    monkeypatch.setattr(doctor, "_nvml_binding", lambda: fake)
    row = doctor.check_nvml(port_config.Config(backend="nvml"))
    assert row.status == "ok"
    assert row.data == {
        "loaded": True, "init": True, "driver_version": "580.159.03",
        "cuda_driver_version": 13000, "device_count": 2,
        "devices": [
            {"index": 0, "name": "NVIDIA H100 80GB HBM3", "uuid": UUIDS[0],
             "minor": 2},
            {"index": 1, "name": "NVIDIA H100 PCIe", "uuid": UUIDS[1],
             "minor": 0}]}
    assert row.detail.startswith("driver 580.159.03, CUDA 13.0; 2 card(s): ")
    assert f"0: NVIDIA H100 80GB HBM3 {UUIDS[0]} /dev/nvidia2" in row.detail
    assert (fake.init_calls, fake.shutdown_calls) == (1, 1)


def test_nvml_row_with_no_cards_and_a_failing_card(monkeypatch):
    monkeypatch.setattr(doctor, "_nvml_binding", lambda: FakeNvml([]))
    assert doctor.check_nvml(port_config.Config(backend="nvml")).status == \
        "warn"
    lost = _fake()
    lost.devices[1].lost = True
    monkeypatch.setattr(doctor, "_nvml_binding", lambda: lost)
    row = doctor.check_nvml(port_config.Config(backend="auto"))
    assert row.status == "warn"
    assert "GPU is lost" in row.detail
    assert lost.shutdown_calls == 1


@pytest.mark.parametrize("backend", ["mock", "null"])
def test_nvml_row_skips_on_the_card_less_backends(backend):
    assert doctor.check_nvml(port_config.Config(backend=backend)).status == \
        "skip"


def test_the_doctor_keeps_nvml_up_under_a_daemon_in_this_process(monkeypatch):
    fake = _fake()
    collector = NvmlCollector(fake)
    try:
        [dev, _] = collector.discover()
        monkeypatch.setattr(doctor, "_nvml_binding", lambda: fake)
        assert doctor.check_nvml(port_config.Config(backend="nvml")).status \
            == "ok"
        # The doctor paired its init with its shutdown: the collector's
        # reference is still there, and it goes on sampling.
        collector.begin_tick()
        assert collector.sample(dev).values
    finally:
        collector.close()
    assert (fake.init_calls, fake.shutdown_calls) == (2, 2)


# -- _bounded, embedded, run_checks --------------------------------------------

def test_bounded_turns_a_hung_probe_into_one_fail_row():
    release = threading.Event()
    try:
        rows = doctor._bounded("nvml", release.wait, timeout=0.2)
    finally:
        release.set()
    assert [(r.name, r.status) for r in rows] == [("nvml", "fail")]
    assert "probe hung" in rows[0].detail


def test_bounded_turns_a_crashing_probe_into_a_fail_row():
    rows = doctor._bounded("poll", lambda: 1 / 0, timeout=5)
    assert [(r.name, r.status) for r in rows] == [("poll", "fail")]
    assert rows[0].detail == "probe crashed: division by zero"


@pytest.mark.parametrize("answer,status", [("gpu", "warn"), ("cpu", "skip"),
                                           (None, "skip")])
def test_embedded_viability(monkeypatch, answer, status):
    monkeypatch.setattr(doctor, "_probe_torch_cuda", lambda: answer)
    row = doctor.check_embedded_viability(port_config.Config())
    assert (row.name, row.status) == ("embedded", status)
    if answer is None:
        assert "inconclusive" in row.detail


def test_the_torch_probe_is_inconclusive_when_python_fails(monkeypatch):
    monkeypatch.setattr(sys, "executable", "/bin/false")
    assert doctor._probe_torch_cuda(timeout=10) is None


@pytest.mark.parametrize("backend,nvml_ok,reached", [
    ("auto", False, True), ("auto", True, False), ("nvml", False, False),
    ("mock", False, False)])
def test_run_checks_reaches_embedded_only_on_auto_without_nvml(
        monkeypatch, backend, nvml_ok, reached):
    monkeypatch.setattr(doctor, "check_nvml", lambda cfg: doctor._result(
        "nvml", "ok" if nvml_ok else "warn", ""))
    monkeypatch.setattr(doctor, "check_poll", lambda cfg: [])
    monkeypatch.setattr(doctor, "_probe_torch_cuda", lambda: "cpu")
    names = [r.name for r in doctor.run_checks(
        port_config.Config(backend=backend, attribution="off"))]
    assert names[:4] == ["nvml", "native", "attribution", "topology"]
    assert ("embedded" in names) == reached


# -- main ----------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--url"], ["--url="], ["--url", "--json"]])
def test_url_without_a_target_exits_2(argv, capsys):
    assert doctor.main(argv) == 2
    assert ref_doctor.main(argv) == 2
    assert "--url requires a target" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--fleet", "--efficiency", "--at",
                                  "--at=10m", "--fleet=x"])
def test_later_item_flags_exit_2(flag, capsys):
    """The flags whose rows came with the fleet lens: ``--fleet`` and
    ``--efficiency`` run their rows (FAIL with no hub at the --url:
    exit 1); what still exits 2 is what the reference's doctor also
    refuses as usage (``--at`` with no time, ``--at`` without
    ``--fleet``/``--efficiency``, a value on ``--fleet``), with the
    reference's message."""
    argv = ["--backend", "mock", "--json", flag, "--url",
            "http://127.0.0.1:9/metrics"]
    if flag in ("--fleet", "--efficiency"):
        assert doctor.main(argv) == 1
        rows = {r["name"]: r
                for r in json.loads(capsys.readouterr().out)["checks"]}
        assert rows[flag[2:]]["status"] == "fail"
        return
    argv = ["--backend", "mock", flag]
    got = _exit_code(doctor.main, argv)
    got_err = capsys.readouterr().err
    want = _exit_code(ref_doctor.main, argv)
    want_err = capsys.readouterr().err
    assert got == want == 2
    assert got_err.strip().splitlines()[-1].split(": ")[-1] == \
        want_err.strip().splitlines()[-1].split(": ")[-1]
    assert "not ported yet" not in got_err


def _exit_code(main, argv) -> int:
    try:
        return main(argv)
    except SystemExit as exc:
        return exc.code


def _json_shape(payload: dict) -> tuple:
    return (sorted(payload), type(payload["ready"]),
            type(payload["elapsed_seconds"]),
            {tuple(sorted(c)) for c in payload["checks"]},
            {type(c["data"]) for c in payload["checks"]})


def test_json_shape_equals_the_reference(capsys, tmp_path):
    prom = tmp_path / "saved.prom"
    prom.write_text(_exposition())
    argv = ["--backend", "mock", "--attribution", "off", "--json",
            "--url", str(prom)]
    assert doctor.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_doctor.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert _json_shape(got) == _json_shape(want)
    assert got["ready"] is True
    statuses = [c["status"] for c in got["checks"]]
    # Sorted fail, warn, ok, skip — as the reference sorts.
    order = {"fail": 0, "warn": 1, "ok": 2, "skip": 3}
    assert statuses == sorted(statuses, key=order.get)
    assert {c["name"] for c in got["checks"]} == {
        "nvml", "native", "attribution", "topology", "poll", "resilience",
        "scrape", "live-resilience"}


def test_a_fail_row_exits_1(monkeypatch, capsys):
    def failing():
        raise NvmlError(binding.NVML_ERROR_DRIVER_NOT_LOADED,
                        "Driver Not Loaded")

    monkeypatch.setattr(daemon, "_nvml_collector", failing)
    monkeypatch.setattr(doctor, "_nvml_binding", lambda: _fake(
        init_error=binding.NVML_ERROR_DRIVER_NOT_LOADED))
    assert doctor.main(["--backend", "nvml", "--attribution", "off",
                        "--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["ready"] is False
    assert [c["name"] for c in payload["checks"][:2]] == ["nvml", "poll"]
    assert doctor.main(["--backend", "nvml", "--attribution", "off"]) == 1
    assert capsys.readouterr().out.splitlines()[-1].startswith("NOT READY: ")


def test_python_m_doctor_on_mock_exits_0():
    proc = subprocess.run(
        [sys.executable, "-m", "kube_gpu_stats_tpu_torch", "doctor",
         "--backend", "mock", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ready"] is True
    poll = next(c for c in payload["checks"] if c["name"] == "poll")
    assert poll["status"] == "ok" and poll["data"]["up"] == 4


# -- --host: check_host against the reference on the same payload -------------

_HOST_HEALTHY = {
    "enabled": True, "read_at": 1234.5,
    "pressure": {"cpu_some_avg10": 1.0, "memory_full_avg10": 0.0,
                 "io_some_avg60": 0.5},
    "throttle_rate": None, "nic_drop_rate": 0.0, "pods": {},
    "ebpf": {"available": False,
             "reason": "eBPF toolchain (bcc) not importable"},
    "errors": {}}
HOST_PAYLOADS = {
    "healthy": (200, _HOST_HEALTHY),
    "hot_pressure": (200, {**_HOST_HEALTHY, "pressure": {
        "memory_full_avg10": 18.0, "cpu_some_avg10": 6.5,
        "io_some_avg60": 40.0}}),
    "throttle_and_drops": (200, {**_HOST_HEALTHY, "throttle_rate": 2.5,
                                 "nic_drop_rate": 7.0}),
    "no_psi_with_pods_and_ebpf": (200, {
        **_HOST_HEALTHY, "pressure": {},
        "pods": {"uid-a": {"pod": "train-0"}, "uid-b": {}},
        "ebpf": {"available": True, "reason": ""}}),
    "parse_errors": (200, {**_HOST_HEALTHY,
                           "errors": {"hoststats_psi": 3,
                                      "hoststats_nic_cap": 1}}),
    "disabled": (200, {"enabled": False}),
    "not_read_yet": (200, {**_HOST_HEALTHY, "read_at": 0.0}),
    "needs_auth": (401, None),
    "not_served": (404, None),
    "server_error": (500, None),
    "not_json": (200, "not json"),
}


@pytest.fixture(scope="module")
def host_server():
    """A server answering /debug/host with the payload named by the
    first path segment."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            name = self.path.strip("/").split("/")[0]
            code, payload = HOST_PAYLOADS[name]
            body = (payload if isinstance(payload, str)
                    else json.dumps(payload)).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("name", HOST_PAYLOADS)
def test_check_host_equals_the_reference(host_server, name):
    base = f"{host_server}/{name}"
    got = doctor.check_host(base)
    assert _row(got) == _row(ref_doctor.check_host(base))
    want_status = {"healthy": "ok", "no_psi_with_pods_and_ebpf": "ok",
                   "server_error": "fail", "not_json": "fail"}
    assert got.status == want_status.get(name, "warn")


def test_check_host_of_an_unreachable_daemon_fails_as_the_reference():
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    got = doctor.check_host(base)
    assert _row(got) == _row(ref_doctor.check_host(base))
    assert got.status == "fail"


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_doctor_host_reads_a_running_daemon(capsys):
    from kube_gpu_stats_tpu_torch.config import Config

    cfg = Config(backend="mock", mock_devices=1, interval=0.05,
                 listen_host="127.0.0.1", listen_port=0, attribution="off",
                 device_processes="off")
    instance = daemon.Daemon(cfg)
    instance.start()
    try:
        assert instance.registry.wait_for_publish(1, timeout=5)
        url = f"http://127.0.0.1:{instance.server.port}/metrics"
        rc = doctor.main(["--backend", "mock", "--json", "--host",
                          "--url", url])
    finally:
        instance.stop()
    payload = json.loads(capsys.readouterr().out)
    rows = {row["name"]: row for row in payload["checks"]}
    assert rc == 0
    assert rows["host"]["status"] in ("ok", "warn")
    assert rows["host"]["data"]["host"]["enabled"] is True


def test_doctor_energy_still_exits_2(capsys):
    """``--energy``, ``--stores``, ``--egress``, ``--skew``,
    ``--cardinality``, ``--fleet`` and ``--efficiency`` are ported: with
    no server listening they run their rows (FAIL: unreachable) and exit
    1, never 2; ``--fleet --at`` runs its ring row the same way."""
    for flag in ("--energy", "--stores", "--egress", "--skew",
                 "--cardinality", "--fleet", "--efficiency"):
        assert doctor.main(["--backend", "mock", "--json", flag,
                            "--listen-port", "9", "--url",
                            "http://127.0.0.1:9/metrics"]) == 1
        payload = json.loads(capsys.readouterr().out)
        rows = {row["name"]: row for row in payload["checks"]}
        assert rows[flag[2:]]["status"] == "fail"
    assert doctor.main(["--backend", "mock", "--json", "--fleet", "--at",
                        "10m", "--url", "http://127.0.0.1:9/metrics"]) == 1
    rows = {row["name"]: row
            for row in json.loads(capsys.readouterr().out)["checks"]}
    assert rows["fleet-at"]["status"] == "fail"
    assert not hasattr(doctor, "NOT_PORTED_FLAGS")


# -- the fleet-lens rows -------------------------------------------------------

def _canned_rollup() -> dict:
    return {
        "enabled": True, "seq": 42,
        "targets": {
            "http://w0:9400/metrics": {"anomalous": {}, "signals": {}},
            "http://w3:9400/metrics": {
                "anomalous": {"stale_fraction": 9.5, "freshness": 3.0},
                "missed": 5, "signals": {},
                "digest": {"slowest": {"seconds": 0.4,
                                       "phase": "env_round",
                                       "blame": "device=0"}}},
        },
        "anomalies": [],
        "slo": {
            "freshness": {"target": 0.99, "windows": {
                "5m": {"bad_ratio": 0.25, "burn_rate": 25.0, "events": 30},
                "1h": {"bad_ratio": 0.02, "burn_rate": 2.0,
                       "events": 360}}},
            "straggler": {"target": 0.95, "ratio_min": 0.75, "windows": {
                "5m": {"bad_ratio": 0.0, "burn_rate": 0.0, "events": 30},
                "1h": {"bad_ratio": 0.0, "burn_rate": 0.0,
                       "events": 360}}},
        },
        "attribution": {"target": "http://w7:9400/metrics",
                        "seconds": 1.2, "phase": "fetch_wait",
                        "blame": "device=3"},
    }


def _rollup_case(case: str) -> dict:
    payload = _canned_rollup()
    targets = payload["targets"]
    if case == "joined-host":
        targets["http://w7:9400/metrics"] = {
            "anomalous": {"fetch": 6.2, "host_mem_stall": 9.0,
                          "host_throttle": 4.5, "host_weird": 2.0},
            "signals": {},
            "digest": {"slowest": {"seconds": 1.2, "phase": "fetch_wait",
                                   "blame": "device=3"},
                       "host": {"mem_full_avg10": 18.0,
                                "throttle_rate": 2.0}}}
    elif case == "host-only":
        targets["http://w1:9400/metrics"] = {
            "anomalous": {"host_io_stall": 5.0}, "signals": {},
            "digest": {"host": {"io_full_avg10": 7.0}}}
    elif case == "worst-with-host":
        targets["http://w7:9400/metrics"] = {
            "anomalous": {"host_mem_stall": 12.0}, "signals": {},
            "digest": {"host": {}}}
    elif case == "link":
        for worker, kinds in (("1", {"ici": 5.0, "steps": 4.2}),
                              ("2", {"fetch": 7.0, "host_nic_drops": 9.0}),
                              ("4", {"ici": 6.0, "duty": 5.0})):
            targets[f"http://w{worker}:9400/metrics"] = {
                "anomalous": kinds, "signals": {}}
        payload["links"] = {"suspects": {"1-2": {
            "reason": "ici-rate+anomaly-correlated+host-counter-confirmed",
            "endpoints": ["1", "2"],
            "targets": ["http://w1:9400/metrics",
                        "http://w2:9400/metrics"],
            "drop": 0.62}}}
    elif case == "clean":
        targets["http://w3:9400/metrics"]["anomalous"] = {}
        for objective in payload["slo"].values():
            for window in objective["windows"].values():
                window["burn_rate"] = 0.5
    elif case == "empty":
        payload = {"enabled": True, "targets": {"a": {}}}
    return payload


@pytest.mark.parametrize("case", ["canned", "joined-host", "host-only",
                                  "worst-with-host", "link", "clean",
                                  "empty"])
def test_fleet_post_mortem_equals_the_reference(case):
    payload = _rollup_case(case)
    got = doctor.fleet_post_mortem(payload)
    assert got == ref_doctor.fleet_post_mortem(payload)
    status = {"clean": "ok", "empty": "ok"}.get(case, "warn")
    assert got[0] == status, got[1]
    if case == "link":
        assert "shared ICI link 1-2 suspect, host-counter-confirmed" \
            in got[1]
        assert got[2]["link_explained"] == {
            "http://w1:9400/metrics": "1-2", "http://w2:9400/metrics": "1-2"}
        assert "http://w4:9400/metrics" in got[2]["anomalous"]


def _fleet_server(provider=None, history=None):
    from kube_gpu_stats_tpu_torch.exposition import MetricsServer
    from kube_gpu_stats_tpu_torch.registry import Registry

    server = MetricsServer(Registry(), host="127.0.0.1", port=0,
                           fleet_provider=provider,
                           history_provider=history)
    server.start()
    return server


class _Rollup:
    def __init__(self, payload: dict) -> None:
        self.payload = payload

    def rollup(self) -> dict:
        return self.payload


def _fleet_rows(base: str, at: float | None = None) -> tuple:
    if at is None:
        got, want = doctor.check_fleet(base), ref_doctor.check_fleet(base)
    else:
        got = doctor.check_fleet_at(base, at)
        want = ref_doctor.check_fleet_at(base, at)
    assert (got.name, got.status, got.detail, got.data) == \
        (want.name, want.status, want.detail, want.data)
    return got


@pytest.mark.parametrize("case", ["canned", "clean", "no-targets",
                                  "missing", "unreachable", "leaf-hub"])
def test_check_fleet_equals_the_reference(case):
    servers = []
    try:
        if case == "unreachable":
            import socket

            with socket.socket() as probe:
                probe.bind(("127.0.0.1", 0))
                base = f"http://127.0.0.1:{probe.getsockname()[1]}"
            assert _fleet_rows(base).status == "fail"
            return
        if case == "leaf-hub":
            leaf = _fleet_server(_Rollup(_rollup_case("canned")))
            servers.append(leaf)
            root = _rollup_case("clean")
            root["targets"] = {
                f"http://127.0.0.1:{leaf.port}/metrics":
                    {"anomalous": {}, "signals": {}}}
            provider = _Rollup(root)
        else:
            provider = {"canned": _Rollup(_rollup_case("canned")),
                        "clean": _Rollup(_rollup_case("clean")),
                        "no-targets": _Rollup({"enabled": True,
                                               "targets": {}, "seq": 3}),
                        "missing": None}[case]
        server = _fleet_server(provider)
        servers.append(server)
        row = _fleet_rows(f"http://127.0.0.1:{server.port}")
        assert row.status == {"canned": "warn", "clean": "ok",
                              "no-targets": "warn", "missing": "warn",
                              "leaf-hub": "warn"}[case]
        if case == "leaf-hub":
            assert "| leaf http://127.0.0.1:" in row.detail
    finally:
        for server in servers:
            server.stop()


@pytest.mark.parametrize("case", ["straggler", "healthy", "disabled",
                                  "empty"])
def test_check_fleet_at_equals_the_reference(case):
    import time as time_mod

    from kube_gpu_stats_tpu_torch import history

    store = history.HistoryStore(enabled=case != "disabled")
    t0 = time_mod.time() - 900.0
    if case != "empty":
        for worker, rate in (("w0", 10.0), ("w1", 10.0), ("w2", 2.0)):
            store.record("slice_worker_steps_per_second",
                         (("slice", "s0"), ("worker", worker)), rate)
        store.record("slice_target_up", (("target", "node-2:9400"),), 0.0)
        store.record("kts_fleet_link_suspect",
                     (("link", "1-2"), ("reason", "ici-rate")), 1.0)
        store.commit(t0, 1)
        for worker in ("w0", "w1", "w2"):
            store.record("slice_worker_steps_per_second",
                         (("slice", "s0"), ("worker", worker)), 10.0)
        store.record("slice_target_up", (("target", "node-2:9400"),), 1.0)
        store.record("kts_fleet_link_suspect",
                     (("link", "1-2"), ("reason", "ici-rate")), 0.0)
        store.commit(t0 + 600.0, 2)
    server = _fleet_server(history=store)
    try:
        at = t0 + (600.0 if case == "healthy" else 0.0)
        row = _fleet_rows(f"http://127.0.0.1:{server.port}", at)
        assert row.status == {"straggler": "warn", "healthy": "ok",
                              "disabled": "warn", "empty": "warn"}[case]
        if case == "straggler":
            assert "straggler worker w2" in row.detail
            assert "ICI link 1-2 was suspect" in row.detail
    finally:
        server.stop()
