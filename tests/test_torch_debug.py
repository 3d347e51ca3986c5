"""The port's MetricsServer over HTTP: basic auth, TLS and mTLS, the
flight recorder's ``/debug/*`` read side, ``/debug/threads``,
``/debug/profile`` and the landing page; the TLS/auth flags against the
reference's parser; the daemon's journal feeds.

The self-signed certificate is made by ``openssl``, as the reference's
doctor tests make theirs.
"""

import base64
import hashlib
import http.client
import json
import socket
import ssl
import subprocess
import threading
import time
import urllib.error
import urllib.request

import pytest

from kube_gpu_stats_tpu import config as ref_config
from kube_gpu_stats_tpu_torch import config as port_config
from kube_gpu_stats_tpu_torch import daemon, doctor, validate
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.config import Config
from kube_gpu_stats_tpu_torch.exposition import MetricsServer
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry
from kube_gpu_stats_tpu_torch.resilience import CircuitBreaker
from kube_gpu_stats_tpu_torch.tracing import Tracer

PASSWORD = "s3cret"
DIGEST = hashlib.sha256(PASSWORD.encode()).hexdigest()


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    """(cert.pem, key.pem): self-signed for 127.0.0.1."""
    root = tmp_path_factory.mktemp("tls")
    cert, key = root / "cert.pem", root / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60,
    )
    return str(cert), str(key)


def _published_registry() -> Registry:
    registry = Registry()
    loop = PollLoop(MockCollector(num_devices=2), registry)
    try:
        loop.tick()
    finally:
        loop.stop()
    return registry


def _serving():
    servers = []

    def start(registry=None, **kwargs):
        server = MetricsServer(registry or _published_registry(),
                               host="127.0.0.1", port=0, **kwargs)
        server.start()
        servers.append(server)
        return server

    return start, servers


@pytest.fixture
def serve():
    """serve(**kwargs) -> a started MetricsServer on 127.0.0.1, stopped
    at teardown."""
    start, servers = _serving()
    yield start
    for server in servers:
        server.stop()


@pytest.fixture(scope="module")
def auth_server():
    """One basic-auth server for the refusal cases (a server's stop waits
    out its accept loop's poll)."""
    start, servers = _serving()
    yield start(auth_username="prom", auth_password_sha256=DIGEST,
                trace_provider=Tracer())
    for server in servers:
        server.stop()


def _get(url: str, headers: dict | None = None, context=None,
         timeout: float = 10.0) -> tuple[int, dict, bytes]:
    request = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(request, timeout=timeout,
                                    context=context) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def _basic(user: str, password: str) -> dict:
    token = base64.b64encode(f"{user}:{password}".encode()).decode()
    return {"Authorization": "Basic " + token}


# -- basic auth ----------------------------------------------------------------

@pytest.mark.parametrize("path", ["/metrics", "/", "/debug/threads",
                                  "/debug/ticks", "/nowhere"])
@pytest.mark.parametrize("headers", [
    {}, _basic("prom", "wrong"), _basic("intruder", PASSWORD),
    _basic("prömetheus", PASSWORD), {"Authorization": "Basic !!!"},
    {"Authorization": "Bearer x"}],
    ids=["none", "wrong-password", "wrong-user", "non-ascii-user",
         "bad-base64", "not-basic"])
def test_basic_auth_refuses(auth_server, path, headers):
    code, got, body = _get(f"http://127.0.0.1:{auth_server.port}{path}",
                           headers)
    assert code == 401
    assert got["WWW-Authenticate"] == 'Basic realm="kube-tpu-stats"'
    assert body == b"unauthorized\n"


def test_basic_auth_admits_and_probes_stay_open(serve):
    server = serve(auth_username="prom",
                   auth_password_sha256=DIGEST.upper(),
                   trace_provider=Tracer())
    base = f"http://127.0.0.1:{server.port}"
    code, _, body = _get(base + "/metrics", _basic("prom", PASSWORD))
    assert code == 200
    assert validate.check(body.decode()) == []
    assert _get(base + "/debug/ticks", _basic("prom", PASSWORD))[0] == 200
    for probe in ("/healthz", "/readyz"):
        code, _, body = _get(base + probe)
        assert code == 200, probe
    # The doctor holds only the hash: its rows say the endpoint is up.
    row = doctor.check_scrape(base + "/metrics")
    assert (row.status, "requires authentication" in row.detail) == \
        ("warn", True)
    row = doctor.check_trace(base)
    assert (row.status, "requires authentication" in row.detail) == \
        ("warn", True)


# -- TLS and mTLS --------------------------------------------------------------

def _trusting(cert: str, client: tuple | None = None) -> ssl.SSLContext:
    context = ssl.create_default_context(cafile=cert)
    if client:
        context.load_cert_chain(*client)
    return context


def test_tls_scrape_conforms_when_the_cert_is_trusted(serve, cert):
    server = serve(tls_cert_file=cert[0], tls_key_file=cert[1])
    url = f"https://127.0.0.1:{server.port}/metrics"
    text = validate.fetch_exposition(url, ca_file=cert[0])
    assert validate.check(text) == []
    rows = doctor.check_url(url)
    assert [(r.name, r.status) for r in rows] == [
        ("scrape", "warn"), ("live-resilience", "skip")]
    assert "TLS handshake failed" in rows[0].detail


def test_a_failed_handshake_closes_only_its_connection(serve, cert, capfd):
    server = serve(tls_cert_file=cert[0], tls_key_file=cert[1])
    # Plain HTTP to the TLS port: that handler's handshake fails, and the
    # server closes the connection (read to its end).
    with socket.create_connection(("127.0.0.1", server.port),
                                  timeout=5) as sock:
        sock.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        received = b""
        try:
            while chunk := sock.recv(1024):
                received += chunk
        except OSError:
            pass
    assert not received.startswith(b"HTTP/1.1 200")
    code, _, body = _get(f"https://127.0.0.1:{server.port}/healthz",
                         context=_trusting(cert[0]))
    assert (code, body) == (200, b"ok\n")
    # Logged at debug, not a traceback on stderr.
    assert "Traceback" not in capfd.readouterr().err


def test_a_silent_client_does_not_block_healthz(serve, cert):
    server = serve(tls_cert_file=cert[0], tls_key_file=cert[1])
    silent = [socket.create_connection(("127.0.0.1", server.port), timeout=5)
              for _ in range(3)]
    try:
        started = time.monotonic()
        code, _, body = _get(f"https://127.0.0.1:{server.port}/healthz",
                             context=_trusting(cert[0]), timeout=5)
        assert (code, body) == (200, b"ok\n")
        assert time.monotonic() - started < 5
    finally:
        for sock in silent:
            sock.close()


def test_mtls_requires_a_client_certificate(serve, cert):
    server = serve(tls_cert_file=cert[0], tls_key_file=cert[1],
                   tls_client_ca_file=cert[0])
    url = f"https://127.0.0.1:{server.port}/metrics"
    with pytest.raises((OSError, http.client.HTTPException)):
        _get(url, context=_trusting(cert[0]), timeout=5)
    code, _, body = _get(url, context=_trusting(cert[0], client=cert))
    assert code == 200
    assert validate.check(body.decode()) == []


@pytest.mark.parametrize("kwargs", [
    {"tls_client_ca_file": "ca.pem"},
    {"tls_cert_file": "cert.pem"},
    {"tls_key_file": "key.pem"}])
def test_an_incomplete_tls_config_is_refused_before_binding(kwargs):
    with pytest.raises(ValueError):
        MetricsServer(Registry(), host="127.0.0.1", port=0, **kwargs)


def test_an_unreadable_cert_does_not_leak_the_listener(tmp_path):
    missing = str(tmp_path / "absent.pem")
    with pytest.raises(OSError):
        MetricsServer(Registry(), host="127.0.0.1", port=0,
                      tls_cert_file=missing, tls_key_file=missing)


_FLAG_CASES = [
    [],
    ["--tls-cert-file", "c.pem", "--tls-key-file", "k.pem"],
    ["--tls-cert-file", "c.pem"],
    ["--tls-key-file", "k.pem"],
    ["--tls-client-ca-file", "ca.pem"],
    ["--tls-cert-file", "c.pem", "--tls-key-file", "k.pem",
     "--tls-client-ca-file", "ca.pem"],
    ["--auth-username", "prom"],
    ["--auth-password-sha256", DIGEST],
    ["--auth-username", "prom", "--auth-password-sha256", DIGEST],
    ["--auth-username", "prom", "--auth-password-sha256", DIGEST.upper()],
    ["--auth-username", "prom", "--auth-password-sha256", DIGEST[:-1]],
    ["--auth-username", "prom", "--auth-password-sha256",
     DIGEST[:-1] + "g"],
    ["--auth-username", "prom", "--auth-password-sha256", PASSWORD],
]


@pytest.mark.parametrize("argv", _FLAG_CASES)
def test_tls_and_auth_flags_validate_like_the_reference(argv, capsys):
    def verdict(module):
        try:
            cfg = module.from_args(argv)
        except SystemExit as exc:
            return ("refused", exc.code)
        return ("accepted", cfg.tls_cert_file, cfg.tls_key_file,
                cfg.tls_client_ca_file, cfg.auth_username,
                cfg.auth_password_sha256)

    assert verdict(port_config) == verdict(ref_config)


def test_tls_and_auth_flags_read_the_environment(monkeypatch):
    for name, value in (("TLS_CERT_FILE", "c.pem"), ("TLS_KEY_FILE", "k.pem"),
                        ("AUTH_USERNAME", "prom"),
                        ("AUTH_PASSWORD_SHA256", DIGEST)):
        monkeypatch.setenv("KTS_" + name, value)
    cfg = port_config.from_args([])
    assert (cfg.tls_cert_file, cfg.tls_key_file, cfg.auth_username,
            cfg.auth_password_sha256) == ("c.pem", "k.pem", "prom", DIGEST)


# -- /debug/ticks|trace|events -------------------------------------------------

def _recorded_tracer(enabled: bool = True) -> Tracer:
    now = [5_000_000]
    tracer = Tracer(enabled=enabled, clock_ns=lambda: now[0],
                    wall=lambda: 1_700_000_000.0 + now[0] / 1e9)
    for seq in range(1, 9):
        tracer.begin("tick", seq)
        mark = tracer.mark()
        now[0] += 1_000 * seq * seq
        tracer.add_span("env_round", mark)
        start = now[0]
        now[0] += 700 * seq
        tracer.aux_span("sample", start, device=str(seq % 2))
        if seq % 3 == 0:
            tracer.event("plan_compile", f"device {seq % 2}: compiled",
                         device=str(seq % 2), reason="device")
        now[0] += 2_000
        tracer.end(devices=2, duration_ms=seq)
    return tracer


@pytest.fixture(scope="module")
def recorder_server():
    start, servers = _serving()
    tracer = _recorded_tracer()
    yield tracer, start(trace_provider=tracer)
    for server in servers:
        server.stop()


@pytest.mark.parametrize("query,call", [
    ("/debug/ticks", lambda t: t.ticks_summary()),
    ("/debug/trace", lambda t: t.chrome_trace()),
    ("/debug/trace?last=3", lambda t: t.chrome_trace(3)),
    ("/debug/trace?last=abc", lambda t: t.chrome_trace()),
    ("/debug/events", lambda t: t.events()),
    ("/debug/events?since=1", lambda t: t.events(1)),
    ("/debug/events?since=x", lambda t: t.events(0))])
def test_debug_endpoints_serve_the_recorders_read_side(recorder_server,
                                                       query, call):
    tracer, server = recorder_server
    code, headers, body = _get(f"http://127.0.0.1:{server.port}{query}")
    assert (code, headers["Content-Type"]) == (200, "application/json")
    payload = json.loads(body)
    if query == "/debug/ticks":
        meta = payload.pop("meta")
        assert meta["render_prewarm_wait_seconds_total"] >= 0
    assert payload == call(tracer)


def test_a_disabled_recorder_says_so(serve):
    server = serve(trace_provider=Tracer(enabled=False))
    base = f"http://127.0.0.1:{server.port}"
    for path in ("/debug/ticks", "/debug/trace", "/debug/events"):
        assert json.loads(_get(base + path)[2])["enabled"] is False
    row = doctor.check_trace(base)
    assert (row.status, "tracing disabled" in row.detail) == ("warn", True)


def test_the_doctors_trace_row_reads_the_recorder(serve):
    tracer = _recorded_tracer()
    base = f"http://127.0.0.1:{serve(trace_provider=tracer).port}"
    row = doctor.check_trace(base)
    assert row.status == "ok"
    want = doctor.trace_post_mortem(tracer.ticks_summary(),
                                    tracer.events()["events"])
    assert (row.detail, row.data) == want
    assert row.detail.startswith("last slow tick: tick seq 8 took ")
    assert "responsible: sample[device=0]" in row.detail
    # Nothing recorded yet; no recorder; nobody listening.
    empty = f"http://127.0.0.1:{serve(trace_provider=Tracer()).port}"
    assert "no ticks recorded" in doctor.check_trace(empty).detail
    bare = serve()
    row = doctor.check_trace(f"http://127.0.0.1:{bare.port}")
    assert (row.status, "no /debug/ticks" in row.detail) == ("warn", True)
    port = bare.port
    bare.stop()
    assert doctor.check_trace(f"http://127.0.0.1:{port}").status == "fail"


# -- /debug/threads, /debug/profile, / ---------------------------------------

@pytest.fixture
def running():
    """A started mock daemon on 127.0.0.1 (its poll loop ticking)."""
    instances = []

    def start(**fields):
        cfg = Config(backend="mock", mock_devices=2, interval=0.05,
                     listen_host="127.0.0.1", listen_port=0,
                     attribution="off", device_processes="off", **fields)
        instance = daemon.Daemon(cfg)
        instance.start()
        instances.append(instance)
        assert instance.registry.wait_for_publish(0, timeout=5)
        return instance

    yield start
    for instance in instances:
        instance.stop()


def test_debug_threads_names_the_poll_thread(running):
    d = running()
    code, _, body = _get(f"http://127.0.0.1:{d.server.port}/debug/threads")
    assert code == 200
    text = body.decode()
    for name in ("poll-loop", "supervisor", "metrics-http"):
        assert f"--- thread {name}\n" in text


def test_debug_profile_folds_stacks_single_flight(running):
    d = running()
    base = f"http://127.0.0.1:{d.server.port}/debug/profile"
    code, _, body = _get(base + "?seconds=0.2")
    assert code == 200
    lines = body.decode().splitlines()
    assert any(line.startswith("poll-loop;") for line in lines)
    assert all(line.rsplit(" ", 1)[1].isdigit() for line in lines)
    first: list = []
    worker = threading.Thread(
        target=lambda: first.append(_get(base + "?seconds=1")))
    worker.start()
    try:
        deadline = time.monotonic() + 5
        while not d.server._profile_lock.locked():
            assert time.monotonic() < deadline
            time.sleep(0.005)
        code, _, body = _get(base + "?seconds=0.1")
        assert (code, body) == (409, b"a profile is already running\n")
    finally:
        worker.join(timeout=10)
    assert not worker.is_alive() and first[0][0] == 200
    # NaN and negative clamp to the 0.1 s floor.
    for raw in ("nan", "-5"):
        started = time.monotonic()
        code, _, body = _get(f"{base}?seconds={raw}")
        assert code == 200 and body
        assert time.monotonic() - started < 1.0


def _links(body: bytes) -> list[str]:
    text = body.decode()
    return [part.split('"', 1)[0] for part in text.split('href="')[1:]]


@pytest.mark.parametrize("with_recorder", [True, False])
def test_landing_page_lists_exactly_what_is_served(serve, with_recorder):
    server = serve(trace_provider=Tracer() if with_recorder else None)
    base = f"http://127.0.0.1:{server.port}"
    links = _links(_get(base + "/")[2])
    expected = ["/metrics", "/healthz", "/readyz", "/debug/threads",
                "/debug/profile?seconds=5"]
    recorder = ["/debug/ticks", "/debug/trace?last=20", "/debug/events"]
    assert links == expected + (recorder if with_recorder else [])
    for link in links:
        link = link.replace("seconds=5", "seconds=0.1")
        assert _get(base + link)[0] == 200, link
    if not with_recorder:
        for link in recorder:
            assert _get(base + link)[0] == 404, link


# -- the daemon: TLS/auth flags and the journal feeds -------------------------

def test_the_daemon_serves_tls_and_auth_from_its_flags(running, cert):
    d = running(tls_cert_file=cert[0], tls_key_file=cert[1],
                auth_username="prom", auth_password_sha256=DIGEST)
    base = f"https://127.0.0.1:{d.server.port}"
    context = _trusting(cert[0])
    code, _, body = _get(base + "/metrics", _basic("prom", PASSWORD),
                         context=context)
    assert code == 200 and validate.check(body.decode()) == []
    assert _get(base + "/metrics", context=context)[0] == 401
    assert _get(base + "/healthz", context=context)[0] == 200
    code, _, body = _get(base + "/debug/events", _basic("prom", PASSWORD),
                         context=context)
    assert code == 200 and json.loads(body)["enabled"] is True


def _events(d, kind: str) -> list:
    return [e for e in d.tracer.events()["events"] if e["kind"] == kind]


def test_the_journal_holds_a_component_flip(running):
    d = running()
    alive = [True]
    d.supervisor.register("probe", is_alive=lambda: alive[0])
    d.supervisor.check_once()
    alive[0] = False
    d.supervisor.check_once()
    [event] = [e for e in _events(d, "component")
               if e["attrs"]["component"] == "probe"]
    assert event["detail"] == "probe: healthy -> stale (thread dead)"
    assert event["attrs"]["state"] == "stale"
    served = json.loads(_get(
        f"http://127.0.0.1:{d.server.port}/debug/events")[2])["events"]
    assert event in served


def test_the_journal_holds_a_breaker_trip(running):
    d = running()
    breaker = CircuitBreaker("probe-edge", failure_threshold=1)
    d.supervisor.register_breaker_provider(lambda: {"probe-edge": breaker})
    d.supervisor.check_once()  # attaches the journal listener
    breaker.record_failure(OSError("connection refused\nby peer"))
    [event] = _events(d, "breaker")
    assert event["detail"] == ("probe-edge: closed -> open "
                               "(connection refused by peer)")
    assert event["attrs"] == {"component": "probe-edge", "state": "open"}


class _ChurningAttribution:
    """A pod per device: two distinct values per label key."""

    def lookup(self, device):
        return {"pod": f"pod-{device.device_id}", "namespace": "ml",
                "container": "trainer"}


def test_the_journal_holds_the_label_fences_first_overflow(running,
                                                           monkeypatch):
    monkeypatch.setattr(daemon, "build_attribution",
                        lambda cfg: _ChurningAttribution())
    d = running(label_value_cap=1)
    assert d.registry.wait_for_publish(1, timeout=5)
    [event] = _events(d, "cardinality_fenced")
    assert event["detail"].startswith("label 'pod': distinct-value cap (1)")
    compiles = _events(d, "plan_compile")
    assert sorted(e["attrs"]["device"] for e in compiles) == ["0", "1"]


# -- /debug/burst and /debug/host ----------------------------------------------

def _burst_and_host():
    from kube_gpu_stats_tpu_torch.burstsampler import BurstSampler
    from kube_gpu_stats_tpu_torch.hoststats import HostStats

    collector = MockCollector(num_devices=1)
    burst = BurstSampler(lambda: collector, collector.discover, hold=30.0)
    host = HostStats(proc_root="/proc", sysfs_root="/sys",
                     cgroup_root="/nonexistent")
    host.read()
    return burst, host


@pytest.mark.parametrize("path", ["/debug/burst", "/debug/burst?arm=5",
                                  "/debug/burst?disarm=1", "/debug/host"])
def test_burst_and_host_sit_behind_basic_auth(serve, path):
    burst, host = _burst_and_host()
    server = serve(auth_username="prom", auth_password_sha256=DIGEST,
                   burst_provider=burst, host_provider=host)
    url = f"http://127.0.0.1:{server.port}{path}"
    code, _, _ = _get(url)
    assert code == 401
    assert not burst.armed  # a refused ?arm arms nothing
    code, headers, body = _get(url, _basic("prom", PASSWORD))
    assert code == 200 and headers["Content-Type"] == "application/json"
    payload = json.loads(body)
    assert payload["enabled"] is True
    if path == "/debug/burst?arm=5":
        assert payload["armed"] and payload["armed_for_s"] == 5.0
        assert burst.armed


def test_debug_burst_arms_disarms_and_reads(serve):
    burst, host = _burst_and_host()
    server = serve(burst_provider=burst, host_provider=host)
    base = f"http://127.0.0.1:{server.port}/debug/burst"
    status = json.loads(_get(base)[2])
    assert (status["armed"], status["mode"], status["hz"]) == \
        (False, "auto", 100.0)
    armed = json.loads(_get(base + "?arm=")[2])  # no length: the hold
    assert armed["armed"] and armed["armed_for_s"] == 30.0
    assert armed["arms_total"] == {"demand": 1}
    disarmed = json.loads(_get(base + "?disarm")[2])
    assert disarmed["disarmed"] is True and not disarmed["armed"]


def test_burst_mode_off_404s_and_host_stats_off_says_so(serve):
    from kube_gpu_stats_tpu_torch.hoststats import HostStats

    server = serve(host_provider=HostStats(enabled=False))
    base = f"http://127.0.0.1:{server.port}"
    assert _get(base + "/debug/burst")[0] == 404
    code, _, body = _get(base + "/debug/host")
    assert code == 200 and json.loads(body) == {"enabled": False}


@pytest.mark.parametrize("burst_on", [True, False])
@pytest.mark.parametrize("host_on", [True, False])
def test_landing_page_lists_burst_and_host_when_served(serve, burst_on,
                                                       host_on):
    burst, host = _burst_and_host()
    server = serve(trace_provider=Tracer(),
                   burst_provider=burst if burst_on else None,
                   host_provider=host if host_on else None)
    base = f"http://127.0.0.1:{server.port}"
    links = _links(_get(base + "/")[2])
    extra = (["/debug/burst"] if burst_on else []) + \
        (["/debug/host"] if host_on else [])
    recorder = ["/debug/ticks", "/debug/trace?last=20", "/debug/events"]
    assert links[5:] == recorder + extra
    for link in ("/debug/burst", "/debug/host"):
        served = link in extra
        assert (_get(base + link)[0] == 200) is served, link


def test_the_daemon_serves_burst_and_host_from_its_flags(running):
    d = running(burst_mode="off", host_stats=False)
    base = f"http://127.0.0.1:{d.server.port}"
    assert _get(base + "/debug/burst")[0] == 404
    assert json.loads(_get(base + "/debug/host")[2]) == {"enabled": False}
    assert "/debug/host" in _links(_get(base + "/")[2])
    assert "/debug/burst" not in _links(_get(base + "/")[2])
