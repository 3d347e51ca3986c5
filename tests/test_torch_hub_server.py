"""The port's hub surfaces against the reference's: its HTTP server,
its command line and its doctor row.

- ``POST /ingest/delta`` on both packages' ``MetricsServer``: the same
  codes with auth off and on (401 without credentials), the 413
  Content-Length fence, 400 on a short body, 408 on a dribbled one, 500
  when the handler raises; ``/readyz`` held NotReady through a warm
  restart's replay with the reference's reason.
- Two hub processes, the port's and the reference's, over the same
  targets and pushes: ``/debug/cardinality``, ``/debug/skew`` and
  ``/debug/stores`` answer the same payloads, build, version, times and
  paths excepted; under ``--no-history`` both answer ``/query`` with
  ``enabled: false``; under ``--no-fleet-lens --no-efficiency`` the
  port answers 404 on ``/debug/fleet`` and ``/debug/efficiency``, and
  with the lenses on both answer a rollup of the same shape and a
  signed attestation that verifies; ``hub --once`` prints the same
  exposition, ``kts_history_*`` and ``kts_query_*`` included, with the
  lenses off and on.
- Two hub processes with ``--ingest-procs 2``: frames through the
  children, ``kts_ingest_proc_*`` and its conservation law, ``/query``
  and ``/readyz`` through the proxy, SIGTERM ending the children too.
- The hub's flag set is the reference's; every hub flag the port wires
  reaches the hub with the reference's value (the history store built
  alike, the ``--slo-*``/``--waste-*`` flags and their ``KTS_*``
  variables too), and bad values are refused by the same checks with
  the same message; the lens flags the port once refused now run as
  the reference's do.
- ``cardinality_verdict``/``check_cardinality`` give the reference's
  status and text on canned payloads and on a live port hub;
  ``check_skew`` and ``stores_verdict`` on a hub's payloads too.

Exact throughout.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import pytest

from kube_gpu_stats_tpu import delta as ref_delta
from kube_gpu_stats_tpu import doctor as ref_doctor
from kube_gpu_stats_tpu import hub as ref_hub
from kube_gpu_stats_tpu.exposition import MetricsServer as RefServer
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu_torch import delta, doctor, hub
from kube_gpu_stats_tpu_torch.exposition import MetricsServer
from kube_gpu_stats_tpu_torch.registry import Registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(port: int, body: bytes, headers: dict | None = None,
          path: str = "/ingest/delta") -> int:
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers=headers or {})
    try:
        with urllib.request.urlopen(request, timeout=5) as resp:
            return resp.status
    except urllib.error.HTTPError as exc:
        return exc.code


def _servers(handle, **kwargs):
    port = MetricsServer(Registry(), host="127.0.0.1", port=0,
                         ingest_provider=handle, **kwargs)
    ref = RefServer(RefRegistry(), host="127.0.0.1", port=0,
                    ingest_provider=handle, prewarm_renders=False, **kwargs)
    port.start()
    ref.start()
    return port, ref


@pytest.mark.parametrize("auth", [False, True])
def test_ingest_post_codes_equal_the_reference(auth):
    def handle(wire, peer=""):
        if wire == b"boom":
            raise RuntimeError("handler fault")
        return 200, b"ok\n", {"X-KTS-Proto-Max": "2"}

    password = "s3cret"
    kwargs = dict(auth_username="hub", auth_password_sha256=hashlib.sha256(
        password.encode()).hexdigest()) if auth else {}
    creds = {"Authorization": "Basic " + base64.b64encode(
        f"hub:{password}".encode()).decode()} if auth else {}
    servers = _servers(handle, **kwargs)
    try:
        codes = []
        for server in servers:
            codes.append([
                _post(server.port, b"frame", creds),
                _post(server.port, b"frame"),
                _post(server.port, b"boom", creds),
                _post(server.port, b"frame", creds, path="/elsewhere"),
                _post(server.port, b"", creds),
            ])
        assert codes[0] == codes[1]
        assert codes[0] == ([200, 401, 500, 404, 413] if auth
                            else [200, 200, 500, 404, 413])
    finally:
        for server in servers:
            server.stop()


def _raw(port: int, head: bytes, body: bytes, linger: float = 0.0) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        sock.sendall(head + body)
        if linger:
            time.sleep(linger)
        sock.shutdown(socket.SHUT_WR) if not linger else None
        chunks = []
        while True:
            try:
                chunk = sock.recv(4096)
            except socket.timeout:
                break
            if not chunk:
                break
            chunks.append(chunk)
    return b"".join(chunks)


def test_short_and_dribbled_bodies_equal_the_reference():
    servers = _servers(lambda wire, peer="": (200, b"ok\n", {}),
                       ingest_read_deadline=0.2)
    try:
        head = (b"POST /ingest/delta HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: 100\r\n\r\n")
        for server in servers:
            short = _raw(server.port, head, b"x" * 10)
            assert short.startswith(b"HTTP/1.1 400"), short[:40]
            dribbled = _raw(server.port, head, b"x" * 10, linger=0.5)
            assert dribbled.startswith(b"HTTP/1.1 408"), dribbled[:40]
    finally:
        for server in servers:
            server.stop()


def _checkpointed(tmp_path) -> str:
    """An ingest checkpoint holding two sessions, written by a port hub."""
    path = str(tmp_path / "ingest.json")
    writer = hub.Hub([], targets_provider=lambda: [], interval=1.0,
                     ingest_checkpoint=path)
    for source in ("node-a", "node-b"):
        assert writer.delta.handle(
            delta.encode_full(source, 1, 1, "a 1\n"))[0] == 200
    writer.stop()
    return path


def test_readyz_gates_on_the_replay_as_the_reference(tmp_path):
    path = _checkpointed(tmp_path)
    port_hub = hub.Hub([], targets_provider=lambda: [], interval=1.0,
                       ingest_checkpoint=path)
    ref = ref_hub.Hub([], targets_provider=lambda: [], interval=1.0,
                      ingest_checkpoint=path, history=None,
                      native_ingest=False)
    servers = [
        MetricsServer(port_hub.registry, host="127.0.0.1", port=0,
                      ready_check=port_hub.ready),
        RefServer(ref.registry, host="127.0.0.1", port=0,
                  ready_check=ref.ready, prewarm_renders=False)]
    for server in servers:
        server.start()

    def readyz():
        out = []
        for server in servers:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{server.port}/readyz") as resp:
                    out.append((resp.status, resp.read()))
            except urllib.error.HTTPError as exc:
                out.append((exc.code, exc.read()))
        assert out[0] == out[1]
        return out[0]

    try:
        assert readyz() == (503, b"no snapshot published yet\n")
        # Publish without replaying: the replay is still pending.
        for h in (port_hub, ref):
            h._publish(hub.SnapshotBuilder() if h is port_hub
                       else ref_hub.SnapshotBuilder(), time.monotonic())
        assert readyz() == (
            503, b"warm restart: 2 session(s) awaiting replay\n")
        for h in (port_hub, ref):
            h.refresh_once()
            h.delta._replay_thread.join(timeout=10)
            h.refresh_once()
        assert readyz() == (200, b"ready\n")
    finally:
        for server in servers:
            server.stop()
        port_hub.stop()
        ref.stop()


# -- two hub processes -------------------------------------------------------

def _start_hub(package: str, args: list[str], log_path: str):
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", package, "hub", "--listen-host",
         "127.0.0.1", "--listen-port", "0", *args],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        text = open(log_path).read()
        match = re.search(r"hub serving .* on 127\.0\.0\.1:(\d+)", text)
        if match:
            return proc, int(match.group(1))
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(open(log_path).read())


def _get_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return json.loads(resp.read())


_VARYING = re.compile(r"(wall|_at|age|seconds|time|build|version|path"
                      r"|last_|refresh_seq|idle_refreshes)")


def _scrub(value, key: str = ""):
    """Drop the fields that differ by construction between two
    processes: build and version strings, wall times and ages, the
    per-process file paths, and the refresh counters (each process
    refreshes on its own clock)."""
    if isinstance(value, dict):
        return {k: _scrub(v, k) for k, v in value.items()
                if not _VARYING.search(k)}
    if isinstance(value, list):
        return [_scrub(v, key) for v in value]
    return value


def test_two_hub_processes_answer_the_same_debug_payloads(tmp_path):
    target = tmp_path / "node.prom"
    target.write_text(
        'accelerator_up{chip="0",slice="s",worker="w0"} 1\n'
        'accelerator_duty_cycle{chip="0",slice="s",worker="w0"} 70\n')
    procs = []
    try:
        ports = []
        for package in ("kube_gpu_stats_tpu_torch", "kube_gpu_stats_tpu"):
            work = tmp_path / package
            work.mkdir()
            proc, port = _start_hub(package, [
                str(target), "--interval", "0.2",
                "--ingest-checkpoint", str(work / "ingest.json"),
                "--ingest-checkpoint-interval", "0.2",
                "--ingest-proto-min", "2",
                "--series-budget-per-source", "3",
                "--no-fleet-lens", "--no-history", "--no-efficiency",
                "--no-native-ingest"], str(work / "log"))
            procs.append(proc)
            ports.append(port)
        for port in ports:
            # One session, one clamped source, one refused v1 peer.
            body = "".join(f"m{i} {i}\n" for i in range(5))
            status = _post(port, delta.encode_full(
                "pusher", 3, 1, body, proto=2, caps=1, build="b"))
            assert status == 200
            assert _post(port, delta.encode_full("old", 1, 1, "a 1\n")) \
                == 426
        time.sleep(1.0)                       # a few refreshes
        payloads = {}
        for path in ("/debug/cardinality", "/debug/skew", "/debug/stores"):
            got, want = (_get_json(port, path) for port in ports)
            assert _scrub(got) == _scrub(want), path
            payloads[path] = got
        assert payloads["/debug/skew"]["role"] == "hub"
        assert payloads["/debug/skew"]["ingest"]["fleet_versions"] == {"b": 1}
        assert payloads["/debug/cardinality"]["clamped_sources"] == \
            ["pusher"]
        assert "ingest" in payloads["/debug/stores"]["stores"]
        for path, verdict in (("/debug/skew", "skew_verdict"),
                              ("/debug/stores", "stores_verdict"),
                              ("/debug/cardinality",
                               "cardinality_verdict")):
            assert getattr(doctor, verdict)(payloads[path]) == \
                getattr(ref_doctor, verdict)(payloads[path])
        # --no-history: both hubs keep a disabled store and say so.
        got, want = (_get_json(port, "/query?family=slice_chips")
                     for port in ports)
        assert got == want == {"enabled": False,
                               "hint": "hub started with --no-history"}
        for port in ports:
            for path in ("/debug/fleet", "/debug/efficiency"):
                try:
                    _get_json(port, path)
                    code = 200
                except urllib.error.HTTPError as exc:
                    code = exc.code
                if port == ports[0]:
                    assert code == 404, path
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            assert proc.wait(timeout=15) == 0


def _shape(value):
    """Keys all the way down, values dropped: two processes' payloads of
    the same make."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(v) for v in value]
    return type(value).__name__


def test_two_hub_processes_serve_the_fleet_lens(tmp_path):
    """The lenses on (the default) with an audit key: both processes
    answer /debug/fleet with a rollup of the same shape over the same
    targets, and /debug/efficiency with a signed attestation that the
    other package's doctor verifies; /metrics carries kts_fleet_*."""
    target = tmp_path / "node.prom"
    target.write_text(
        'accelerator_up{chip="0",slice="s",worker="w0"} 1\n'
        'accelerator_duty_cycle{chip="0",slice="s",worker="w0"} 70\n')
    procs = []
    try:
        ports = []
        for package in ("kube_gpu_stats_tpu_torch", "kube_gpu_stats_tpu"):
            work = tmp_path / package
            work.mkdir()
            proc, port = _start_hub(package, [
                str(target), "--interval", "0.2", "--no-history",
                "--no-native-ingest", "--energy-audit-key", "k"],
                str(work / "log"))
            procs.append(proc)
            ports.append(port)
        time.sleep(1.0)                       # a few refreshes
        fleets = [_get_json(port, "/debug/fleet") for port in ports]
        # Each process scores its own wall-timed fetches on its own
        # refresh count: the payloads agree in shape, not in value.
        assert _shape(fleets[0]) == _shape(fleets[1])
        assert fleets[0]["enabled"] is True
        assert list(fleets[0]["targets"]) == [str(target)]
        effs = [_get_json(port, "/debug/efficiency") for port in ports]
        assert _shape(effs[0]) == _shape(effs[1])
        assert effs[0]["signed"] is True
        for mod in (doctor, ref_doctor):
            for port in ports:
                row = mod.check_efficiency(f"http://127.0.0.1:{port}", "k")
                assert row.status == "ok", row.detail
        for port in ports:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
                text = resp.read().decode()
            assert "kts_fleet_targets_anomalous 0" in text
            assert "kts_fleet_efficiency_unknown_pods 0" in text
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            assert proc.wait(timeout=15) == 0


# Both CLIs always wire a history store (disabled under --no-history),
# and a disabled store serves these at 0: compared like the rest.
HISTORY = {"kts_history_series", "kts_history_bytes",
           "kts_history_samples_total", "kts_history_series_shed_total",
           "kts_history_series_evicted_total", "kts_query_requests_total",
           "kts_query_shed_total", "kts_query_cache_hits_total",
           "kts_query_cache_misses_total"}


def _hub_filter(text: str) -> list[str]:
    timed = {"hub_refresh_duration_seconds", "kts_hub_parse_seconds",
             "slice_target_fetch_seconds", "kts_tick_phase_seconds",
             "kts_slowest_tick_seconds", "process_cpu_seconds_total",
             "process_start_time_seconds", "process_virtual_memory_bytes",
             "process_resident_memory_bytes", "process_open_fds",
             "process_max_fds", "kts_render_prewarm_wait_seconds_total",
             "kts_build_info"}
    out = []
    for line in text.splitlines():
        name = (line.split()[2] if line.startswith("#")
                else re.split(r"[{ ]", line, 1)[0])
        name = re.sub(r"_(bucket|sum|count)$", "", name) \
            if re.sub(r"_(bucket|sum|count)$", "", name) in timed else name
        if name not in timed:
            out.append(line)
    return out


def test_hub_once_prints_the_same_exposition(tmp_path):
    target = tmp_path / "node.prom"
    target.write_text(
        'accelerator_up{chip="0",slice="s",worker="w0"} 1\n'
        'accelerator_duty_cycle{chip="0",slice="s",worker="w0"} 70\n'
        'accelerator_power_watts{chip="0",slice="s",worker="w0"} 312.5\n')
    outs = []
    for package in ("kube_gpu_stats_tpu_torch", "kube_gpu_stats_tpu"):
        # Each in a fresh process, as an operator runs it. The
        # reference's parts the port leaves off are switched off.
        proc = subprocess.run(
            [sys.executable, "-m", package, "hub", "--once", str(target),
             "--expect-workers", "1", "--no-native-ingest",
             "--no-fleet-lens", "--no-history", "--no-efficiency"],
            cwd=ROOT, capture_output=True, text=True, timeout=60,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        outs.append((proc.returncode, _hub_filter(proc.stdout)))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0
    assert 'slice_power_watts{slice="s"} 312.5' in outs[0][1]
    served = {line.split(" ")[0] for line in outs[0][1]
              if not line.startswith("#")}
    assert HISTORY <= served
    assert "kts_history_series 0" in outs[0][1]
    assert not any(line.startswith("kts_fleet_") for line in outs[0][1])


def test_hub_once_with_the_lenses_prints_the_same_exposition(tmp_path):
    """One refresh with the fleet and efficiency lenses on: the
    kts_fleet_* families (cold baselines, one SLO sample, the waste
    ledger of one attributed pod) print alike."""
    target = tmp_path / "node.prom"
    labels = 'chip="0",namespace="ml",pod="train-0",slice="s",worker="w0"'
    target.write_text(
        f'accelerator_up{{{labels}}} 1\n'
        f'accelerator_duty_cycle{{{labels}}} 70\n'
        f'accelerator_power_watts{{{labels}}} 312.5\n')
    outs = []
    for package in ("kube_gpu_stats_tpu_torch", "kube_gpu_stats_tpu"):
        proc = subprocess.run(
            [sys.executable, "-m", package, "hub", "--once", str(target),
             "--expect-workers", "1", "--no-native-ingest", "--no-history",
             "--slo-straggler-ratio", "0.5", "--waste-top-k", "3"],
            cwd=ROOT, capture_output=True, text=True, timeout=60,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        outs.append((proc.returncode, _hub_filter(proc.stdout)))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0
    lines = outs[0][1]
    assert "kts_fleet_targets_anomalous 0" in lines
    assert ('kts_fleet_efficiency_score{pod="train-0",namespace="ml"} 0.7'
            in lines)


# -- flags ---------------------------------------------------------------------

class _Captured(Exception):
    pass


def _parsed(main, module, monkeypatch, argv) -> dict:
    seen = {}

    class FakeHub:
        def __init__(self, targets, **kwargs):
            seen.update(kwargs, targets=targets)
            raise _Captured

    monkeypatch.setattr(module, "Hub", FakeHub)
    with pytest.raises(_Captured):
        main(argv)
    return seen


WIRED = [
    [], ["--interval", "3", "--fetch-timeout", "2", "--expect-workers", "64",
         "--rollups-only", "--federate", "--push-fence", "7",
         "--ingest-lanes", "4"],
    ["--no-delta-ingest", "t.prom"],
    ["--ingest-delta-rate", "5", "--ingest-max-inflight", "9",
     "--ingest-max-sessions", "100", "--ingest-quarantine-threshold", "2",
     "--ingest-quarantine-window", "30", "--ingest-checkpoint", "/x/c.json",
     "--ingest-checkpoint-interval", "3", "--ingest-proto-min", "1",
     "--ingest-proto-max", "2"],
    ["--series-budget-per-source", "100", "--series-hard-cap", "1000",
     "--series-high-watermark", "900", "--series-low-watermark", "800",
     "--series-idle-refreshes", "3"],
    ["--target-auth-username", "u", "--target-auth-password-file", "/p",
     "--target-ca-file", "/ca.pem"],
    ["--no-fleet-lens", "--no-history", "--no-efficiency",
     "--no-native-ingest"],
    ["--history-series-max", "10", "--history-query-qps", "1",
     "--history-query-burst", "1"],
    ["--history-query-qps", "0", "--ingest-procs", "64"],
    ["--slo-freshness-target", "0.9", "--slo-straggler-target", "0.8",
     "--slo-straggler-ratio", "0.5", "--waste-warmup-refreshes", "2",
     "--waste-idle-refreshes", "3", "--waste-idle-duty", "5",
     "--waste-top-k", "4", "--energy-audit-key", "k"],
    ["--no-efficiency", "--slo-straggler-ratio", "1"],
]


@pytest.mark.parametrize("argv", WIRED, ids=range(len(WIRED)))
def test_wired_flags_reach_the_hub_with_the_references_values(
        monkeypatch, argv):
    got = _parsed(hub.main, hub, monkeypatch, argv)
    want = _parsed(ref_hub.main, ref_hub, monkeypatch, argv)
    plain = (int, float, str, bool, list, tuple, type(None))
    for key, value in got.items():
        if isinstance(value, plain):
            assert value == want[key], key
        else:                 # providers and stats objects: same kind
            assert type(value).__name__ == type(want[key]).__name__, key


def _refusal(main, argv) -> tuple[int, str]:
    err = io.StringIO()
    with redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code
    lines = err.getvalue().strip().splitlines() or [""]
    return rc, lines[-1].split(": ", 1)[-1]


@pytest.mark.parametrize("argv", [
    ["--ingest-lanes", "300"],
    ["--ingest-quarantine-threshold", "0"],
    ["--ingest-proto-min", "2", "--ingest-proto-max", "1"],
    ["--series-low-watermark", "5"],
    ["--series-high-watermark", "50", "--series-hard-cap", "10"],
    ["--remote-write-shards", "2", "--remote-write-url", "http://r/w"],
    ["--hub-auth-username", "u"],
    ["--targets-file", "f", "--targets-dns", "h:1"],
    ["--targets-dns", "http://svc:9400"],
    ["--no-delta-ingest"],
    ["--ingest-procs", "65"],
    ["--ingest-procs", "-1"],
    ["--ingest-procs", "2", "--no-delta-ingest", "t.prom"],
    ["--ingest-procs", "2", "--tls-cert-file", "c.pem", "--tls-key-file",
     "k.pem"],
    ["--ingest-procs", "1", "--tls-cert-file", "c.pem"],
    ["--history-series-max", "0"],
    ["--history-query-qps", "-1"],
    ["--history-query-burst", "0.5"],
    ["--slo-freshness-target", "1"],
    ["--slo-straggler-target", "0"],
    ["--slo-straggler-ratio", "1.5"],
    ["--waste-warmup-refreshes", "0"],
    ["--waste-idle-refreshes", "0"],
    ["--waste-idle-duty", "101"],
    ["--waste-top-k", "0"],
])
def test_bad_values_are_refused_by_the_same_checks(argv):
    assert _refusal(hub.main, argv) == _refusal(ref_hub.main, argv)
    assert _refusal(hub.main, argv)[0] == 2


@pytest.mark.parametrize("flag", [
    ["--slo-freshness-target", "0.9"], ["--slo-straggler-target", "0.9"],
    ["--slo-straggler-ratio", "0.5"], ["--waste-warmup-refreshes", "2"],
    ["--waste-idle-refreshes", "2"], ["--waste-idle-duty", "5"],
    ["--waste-top-k", "3"], ["--energy-audit-key", "k"],
])
def test_flags_of_unported_parts_are_refused(flag):
    """The lens flags the port's hub once refused: accepted now, and a
    ``--once`` run over a missing target ends as the reference's does
    (exit 2, no target answered), not as an argparse refusal."""
    out = io.StringIO()
    with redirect_stdout(out):
        got = _refusal(hub.main, flag + ["--once", "x.prom"])
        want = _refusal(ref_hub.main, flag + ["--once", "x.prom"])
    assert got[0] == want[0] == 2
    assert "unrecognized arguments" not in got[1]
    assert "kts_fleet_targets_anomalous" in out.getvalue()


LENS_ENV = [
    {"KTS_SLO_FRESHNESS_TARGET": "0.95", "KTS_SLO_STRAGGLER_TARGET": "0.5",
     "KTS_SLO_STRAGGLER_RATIO": "0.25", "KTS_NO_FLEET_LENS": "1"},
    {"KTS_WASTE_WARMUP_REFRESHES": "3", "KTS_WASTE_IDLE_REFRESHES": "4",
     "KTS_WASTE_IDLE_DUTY": "2.5", "KTS_WASTE_TOP_K": "7",
     "KTS_NO_EFFICIENCY": "1", "KTS_ENERGY_AUDIT_KEY": "s"},
]


@pytest.mark.parametrize("env", LENS_ENV, ids=["slo", "waste"])
def test_the_lens_env_reaches_the_hub_with_the_references_values(
        monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = _parsed(hub.main, hub, monkeypatch, [])
    want = _parsed(ref_hub.main, ref_hub, monkeypatch, [])
    keys = ("fleet_lens", "slo_freshness_target", "slo_straggler_target",
            "slo_straggler_ratio", "efficiency", "waste_warmup_refreshes",
            "waste_idle_refreshes", "waste_idle_duty", "waste_top_k",
            "energy_audit_key")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert (got["fleet_lens"], got["efficiency"]) == \
        ((False, True) if "KTS_NO_FLEET_LENS" in env else (True, False))


@pytest.mark.parametrize("env", [{"KTS_SLO_STRAGGLER_RATIO": "0"},
                                 {"KTS_WASTE_TOP_K": "0"},
                                 {"KTS_SLO_FRESHNESS_TARGET": "1.0"}],
                         ids=range(3))
def test_bad_lens_env_is_refused_as_the_reference(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = _refusal(hub.main, ["--once", "x.prom"])
    assert got == _refusal(ref_hub.main, ["--once", "x.prom"])
    assert got[0] == 2 and "must be" in got[1]


# Every reference hub flag is the port's now.
STILL_REFUSED: set[str] = set()


def _options(main, monkeypatch) -> set[str]:
    import argparse

    seen = {}

    def capture(parser, *args, **kwargs):
        seen["parser"] = parser
        raise _Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured):
        main([])
    return {option for action in seen["parser"]._actions
            for option in action.option_strings}


def test_the_hubs_flags_are_the_references_but_the_refused(monkeypatch):
    got = _options(hub.main, monkeypatch)
    want = _options(ref_hub.main, monkeypatch)
    assert STILL_REFUSED <= want
    assert got == want - STILL_REFUSED
    assert {"--ingest-procs", "--no-history", "--history-series-max",
            "--history-query-qps", "--history-query-burst",
            "--no-fleet-lens", "--no-efficiency", "--slo-straggler-ratio",
            "--waste-top-k", "--energy-audit-key"} <= got


@pytest.mark.parametrize("argv,env", [
    ([], {}),
    (["--no-history"], {}),
    (["--history-series-max", "7", "--history-query-qps", "2.5",
      "--history-query-burst", "3"], {}),
    ([], {"KTS_HISTORY_SERIES_MAX": "9", "KTS_HISTORY_QUERY_QPS": "0",
          "KTS_NO_HISTORY": "1"}),
], ids=range(4))
def test_the_history_flags_build_the_references_store(monkeypatch, argv,
                                                      env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    stores = [_parsed(main, module, monkeypatch, argv)["history"]
              for main, module in ((hub.main, hub),
                                   (ref_hub.main, ref_hub))]
    got, want = ([s.enabled, s.max_series, s.reclaim_age, s.tiers,
                  s.series_bytes, s.gate.rate, s.gate.burst]
                 for s in stores)
    assert got == want


# -- the doctor's cardinality row ---------------------------------------------

CANNED = [
    {"enabled": False, "live_series": 10, "sources": 2, "limits": {}},
    {"enabled": True, "live_series": 100, "sources": 3,
     "limits": {"hard_cap": 100, "high_watermark": 90},
     "clamped_sources": ["a", "b", "c", "d", "e", "f"], "shed_total": 12,
     "shed": [{"source": "a", "reasons": {"source_budget": 10}},
              {"source": "b", "reasons": {"hard_cap": 2}}],
     "evicted": {"idle": 3},
     "top_sources": [{"source": "a", "series": 60}]},
    {"enabled": True, "live_series": 95, "sources": 3,
     "limits": {"hard_cap": 200, "high_watermark": 90},
     "top_sources": [{"source": "z", "series": 50}]},
    {"enabled": True, "live_series": 5, "sources": 1,
     "limits": {"hard_cap": 200}, "shed_total": 4,
     "shed": [{"source": "q", "reasons": {"hard_cap": 4}}]},
    {},
]


@pytest.mark.parametrize("payload", CANNED, ids=range(len(CANNED)))
def test_cardinality_verdicts_equal_the_reference(payload):
    assert doctor.cardinality_verdict(payload) == \
        ref_doctor.cardinality_verdict(payload)


def _row(result) -> tuple:
    return result.name, result.status, result.detail


def test_check_cardinality_on_a_live_port_hub(tmp_path):
    target = tmp_path / "n.prom"
    target.write_text("".join(f'm{i}{{k="{i}"}} {i}\n' for i in range(9)))
    port_hub = hub.Hub([str(target)], interval=1.0,
                       series_budget_per_source=4)
    port_hub.refresh_once()

    def payload():
        out = port_hub.cardinality.debug_payload()
        out["enabled"] = port_hub.cardinality.enabled
        return out

    server = MetricsServer(port_hub.registry, host="127.0.0.1", port=0,
                           cardinality_provider=payload)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        got = doctor.check_cardinality(base)
        want = ref_doctor.check_cardinality(base)
        assert _row(got) == _row(want)
        assert got.status == doctor.WARN and str(target) in got.detail
        # A server with none wired answers 404: WARN, the reference's.
        bare = f"http://127.0.0.1:{server.port}/nothing"
        assert _row(doctor.check_cardinality(bare)) == \
            _row(ref_doctor.check_cardinality(bare))
        # The CLI row.
        out = io.StringIO()
        with redirect_stdout(out):
            rc = doctor.main(["--backend", "mock", "--json",
                              "--cardinality", "--url", base + "/metrics"])
        rows = {r["name"]: r for r in json.loads(out.getvalue())["checks"]}
        assert rc == 0 and rows["cardinality"]["status"] == "warn"
    finally:
        server.stop()
        port_hub.stop()


def test_skew_and_stores_verdicts_on_a_hub_payload():
    ingest = delta.DeltaIngest(build="b", proto_min=2)
    ingest.handle(delta.encode_full("n1", 1, 1, "a 1\n", proto=2, caps=1,
                                    build="b"))
    ingest.handle(delta.encode_full("n2", 1, 1, "a 1\n"), "10.0.0.2")
    skew = {"role": "hub", "build": "b", "proto_min": 1, "proto_max": 2,
            "publisher": None, "wal_quarantined": {},
            "wal_quarantine_events": [], "ingest": ingest.skew_status()}
    assert doctor.skew_verdict(skew) == ref_doctor.skew_verdict(skew)
    stores = {"enabled": True, "role": "hub",
              "stores": {"ingest": {"state": "degraded", "reason": "EIO",
                                    "lost_records": 2}},
              "accept_fence": {"state": "healthy"}, "threads": []}
    assert doctor.stores_verdict(stores) == ref_doctor.stores_verdict(stores)
    assert ref_delta.PROTO_MAX == delta.PROTO_MAX


# -- a hub process with acceptor children ----------------------------------------

def _children_of(pid: int) -> list[int]:
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as handle:
                fields = handle.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def test_two_hub_processes_with_ingest_procs(tmp_path):
    """``--ingest-procs 2`` on both CLIs: frames posted to the public
    port land through the children, ``kts_ingest_proc_*`` keeps the
    conservation law, ``/query`` and ``/readyz`` answer through the
    proxy, and SIGTERM ends the hub and both children."""
    import signal

    def expired(*_):
        raise TimeoutError("test exceeded its 90 s limit")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, 90)
    procs = []
    try:
        ports = []
        for package in ("kube_gpu_stats_tpu_torch", "kube_gpu_stats_tpu"):
            work = tmp_path / package
            work.mkdir()
            proc, port = _start_hub(package, [
                "--interval", "0.2", "--ingest-procs", "2",
                "--no-fleet-lens", "--no-efficiency", "--no-native-ingest"],
                str(work / "log"))
            procs.append(proc)
            ports.append(port)
        kids = [_children_of(proc.pid) for proc in procs]
        assert [len(k) for k in kids] == [2, 2]
        body = ('accelerator_up{chip="0",slice="s",worker="w"} 1\n'
                'accelerator_duty_cycle{chip="0",slice="s",worker="w"} 70\n')
        for port in ports:
            for i in range(6):
                assert _post(port, delta.encode_full(
                    f"http://n{i}:9400/metrics", 1, 1, body)) == 200
            assert _post(port, delta.encode_delta(
                "http://ghost:9400/metrics", 1, 2, [(0, 1.0)])) == 409
        time.sleep(1.0)
        texts = []
        for port in ports:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
                texts.append(resp.read().decode())
        for text in texts:
            assert "kts_ingest_procs 2" in text
            accepted = sum(float(line.rsplit(" ", 1)[1])
                           for line in text.splitlines()
                           if line.startswith(
                               "kts_ingest_proc_accepted_total{"))
            frames = sum(float(line.rsplit(" ", 1)[1])
                         for line in text.splitlines()
                         if line.startswith("kts_ingest_proc_frames_total{"))
            assert (accepted, frames) == (6.0, 7.0)
        queries = [_get_json(port, "/query?family=slice_chips&window=1h")
                   for port in ports]
        for payload in queries:
            assert payload["series"][0]["labels"] == {"slice": "s"}
            assert payload["series"][0]["samples"][-1][1] == 6.0
        for port in ports:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/readyz", timeout=5) as resp:
                assert resp.status == 200
        for proc in procs:
            proc.terminate()
        assert [proc.wait(timeout=30) for proc in procs] == [0, 0]
        for group in kids:
            for pid in group:
                assert not os.path.exists(f"/proc/{pid}") or open(
                    f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[
                        0] == "Z"
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=15)
