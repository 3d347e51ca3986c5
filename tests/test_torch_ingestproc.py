"""The port's SO_REUSEPORT ingest processes against the reference's.

One stack per package, kept for the module: a hub, its ``MetricsServer``
on a loopback port (with a history store) and an ``IngestProcPool`` of
two children on the public port, basic auth on both. The same frames go
to both public ports: FULL, DELTA, a DELTA out of sequence (409), a
malformed body (400), a declared-oversized one (413 at the child's
edge), wrong and missing credentials (401). Each answer's status, body
and headers are equal, ``Date`` aside and the build string swapped.
Reads through the children's proxy (``/metrics`` with ``If-None-Match``,
``/query``, probes) answer alike. The pools keep the conservation law
(``sum(accepted) == FULL + DELTA + duplicates``), and a child killed
with SIGKILL is started again. The control channel's records cross
between the packages both ways. The reference's own cases
(``tests/test_ingestproc.py``) run on the port the same way, and the
pushers' body is built with the port's ``SnapshotBuilder``, byte for
byte the reference's.

Every test that starts children has a time limit of its own.
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from kube_gpu_stats_tpu import __version__ as REF_VERSION
from kube_gpu_stats_tpu import delta as ref_delta
from kube_gpu_stats_tpu import history as ref_history
from kube_gpu_stats_tpu import hub as ref_hub
from kube_gpu_stats_tpu import ingestproc as ref_ingestproc
from kube_gpu_stats_tpu.bench import build_pusher_body
from kube_gpu_stats_tpu.exposition import MetricsServer as RefServer
from kube_gpu_stats_tpu_torch import __version__ as PORT_VERSION
from kube_gpu_stats_tpu_torch import delta, history, hub, ingestproc, schema
from kube_gpu_stats_tpu_torch.exposition import MetricsServer
from kube_gpu_stats_tpu_torch.registry import SnapshotBuilder
from kube_gpu_stats_tpu_torch.validate import parse_exposition_interned

pytestmark = pytest.mark.skipif(
    not hasattr(socket, "SO_REUSEPORT"),
    reason="SO_REUSEPORT not available on this platform")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USER, PASSWORD = "pusher", "sekrit"
CREDS = {"Authorization": "Basic " + base64.b64encode(
    f"{USER}:{PASSWORD}".encode()).decode()}
AUTH = (USER, hashlib.sha256(PASSWORD.encode()).hexdigest())


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the test, rather than hang the run, when it outlasts
    ``seconds`` (SIGALRM on the main thread)."""
    def expired(*_):
        raise TimeoutError(f"test exceeded its {seconds:g} s limit")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def pusher_body(worker: int, duty: float = 50.0,
                power: float = 300.0) -> str:
    """One pusher's exposition (one card's gauges), built with the
    port's SnapshotBuilder the way the reference's bench builds it."""
    builder = SnapshotBuilder()
    labels = (("accel_type", "tpu-v5p"), ("chip", "0"),
              ("device_path", "/dev/accel0"), ("uuid", ""),
              ("slice", f"s{worker % 32:02d}"),
              ("worker", str(worker)), ("topology", "4x4"))
    builder.add(schema.DEVICE_UP, 1.0, labels)
    builder.add(schema.DUTY_CYCLE, duty, labels)
    builder.add(schema.MEMORY_USED, 1.0e9, labels)
    builder.add(schema.MEMORY_TOTAL, 9.5e10, labels)
    builder.add(schema.POWER, power, labels)
    builder.add(schema.ICI_BANDWIDTH, 1e9, labels + (("link", "0"),))
    return builder.build().render()


BODY = pusher_body(0)
DUTY_SLOT = next(
    slot for slot, (name, _labels, _value)
    in enumerate(parse_exposition_interned(BODY))
    if name == "accelerator_duty_cycle")


@pytest.mark.parametrize("worker", [0, 7, 31, 45])
def test_pusher_body_equals_the_references_bytes(worker):
    assert pusher_body(worker) == build_pusher_body(worker)
    assert pusher_body(worker, 61.5, 412.25) == \
        build_pusher_body(worker, 61.5, 412.25)


def _request(port: int, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None, timeout: float = 10.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _post(port: int, wire: bytes, headers: dict | None = None,
          timeout: float = 10.0):
    all_headers = {"Content-Type": delta.CONTENT_TYPE}
    all_headers.update(headers if headers is not None else CREDS)
    return _request(port, "POST", delta.INGEST_PATH, wire, all_headers,
                    timeout)


def _comparable(answer, port: bool) -> tuple:
    status, body, headers = answer
    headers = {k: v for k, v in headers.items() if k != "Date"}
    if port:
        headers = {k: v.replace(PORT_VERSION, REF_VERSION)
                   for k, v in headers.items()}
    return status, body, headers


class Stack:
    def __init__(self, package) -> None:
        hub_mod, server_cls, history_mod, pool_mod = package
        kwargs = ({} if hub_mod is hub else
                  dict(fleet_lens=False, efficiency=False,
                       native_ingest=False))
        self.history = history_mod.HistoryStore()
        self.hub = hub_mod.Hub([], targets_provider=lambda: [],
                               interval=5.0, push_fence=1e9,
                               history=self.history, **kwargs)
        server_kwargs = {} if server_cls is MetricsServer else dict(
            prewarm_renders=False)
        self.server = server_cls(
            self.hub.registry, host="127.0.0.1", port=0,
            ingest_provider=self.hub.delta.handle,
            history_provider=self.history, auth_username=AUTH[0],
            auth_password_sha256=AUTH[1], **server_kwargs)
        self.server.start()
        self.pool = pool_mod.IngestProcPool(
            self.hub.delta.handle, host="127.0.0.1", port=0, procs=2,
            parent_port=self.server.port, auth=AUTH)
        self.pool.start()
        self.hub.add_metrics_provider(self.pool.contribute)

    def stop(self) -> None:
        self.pool.stop()
        self.server.stop()
        self.hub.stop()


@pytest.fixture(scope="module")
def stacks():
    with time_limit(60):
        built = {}
        try:
            built["port"] = Stack((hub, MetricsServer, history, ingestproc))
            built["ref"] = Stack((ref_hub, RefServer, ref_history,
                                  ref_ingestproc))
        except BaseException:
            for stack in built.values():
                stack.stop()
            raise
    yield built
    with time_limit(60):
        for stack in built.values():
            stack.stop()


def _both(stacks, fn) -> tuple:
    """fn(stack) on each package's stack; the answers, held equal."""
    got = fn(stacks["port"])
    want = fn(stacks["ref"])
    assert _comparable(got, True) == _comparable(want, False)
    return got


def test_the_children_run_the_ports_module(stacks):
    with time_limit(30):
        for name, module in (("port", ingestproc.CHILD_MODULE),
                             ("ref", "kube_gpu_stats_tpu.ingestproc")):
            for child in stacks[name].pool._children:
                cmdline = open(f"/proc/{child.pid}/cmdline",
                               "rb").read().split(b"\0")
                assert cmdline[1:3] == [b"-m", module.encode()]
        assert ingestproc.CHILD_MODULE == "kube_gpu_stats_tpu_torch.ingestproc"


def test_frames_through_the_children_equal_the_reference(stacks):
    with time_limit(60):
        rng = np.random.default_rng(0)
        sources = [f"http://mp-{i}:9400/metrics" for i in range(6)]
        for i, source in enumerate(sources):
            status, _body, headers = _both(stacks, lambda s: _post(
                s.pool.port, delta.encode_full(source, i + 1, 1, BODY)))
            assert status == 200
            # The hub's hello rides the verdict through the relay.
            assert delta.HELLO_PROTO_MAX in headers
        for seq in range(2, 5):
            for i, source in enumerate(sources):
                duty = float(rng.uniform(0, 100))
                status, _b, _h = _both(stacks, lambda s: _post(
                    s.pool.port, delta.encode_delta(
                        source, i + 1, seq, [(DUTY_SLOT, duty)])))
                assert status == 200
        # A DELTA for an unknown source and one out of sequence: 409.
        status, body, headers = _both(stacks, lambda s: _post(
            s.pool.port, delta.encode_delta("http://ghost:9400/metrics", 9,
                                            2, [(0, 1.0)])))
        assert status == 409 and b"resync required" in body and headers
        status, _b, _h = _both(stacks, lambda s: _post(
            s.pool.port, delta.encode_delta(sources[0], 1, 9,
                                            [(DUTY_SLOT, 1.0)])))
        assert status == 409
        # Malformed: the hub's 400 crosses the relay as it is.
        status, body, _h = _both(stacks, lambda s: _post(
            s.pool.port, b"not-a-frame"))
        assert status == 400 and b"bad delta frame" in body
        # Wrong and missing credentials: the pool's gate answers 401.
        wrong = {"Authorization": "Basic " + base64.b64encode(
            b"pusher:nope").decode()}
        for creds in (wrong, {}):
            status, _b, headers = _both(stacks, lambda s: _post(
                s.pool.port, delta.encode_full("http://x:9400/metrics", 1,
                                               1, BODY), creds))
            assert status == 401 and "WWW-Authenticate" in headers
        # Declared oversized: refused at the child's edge, never relayed.
        before = {name: sum(st["frames"] for st in
                            s.pool.proc_stats().values())
                  for name, s in stacks.items()}

        def oversized(stack):
            conn = http.client.HTTPConnection("127.0.0.1", stack.pool.port,
                                              timeout=10)
            try:
                conn.putrequest("POST", delta.INGEST_PATH)
                conn.putheader("Content-Length", str(128 * 1024 * 1024))
                conn.endheaders()
                resp = conn.getresponse()
                return resp.status, resp.read(), dict(resp.getheaders())
            finally:
                conn.close()

        assert _both(stacks, oversized)[0] == 413
        after = {name: sum(st["frames"] for st in
                           s.pool.proc_stats().values())
                 for name, s in stacks.items()}
        assert after == before
        # Elsewhere than the ingest path: 404 at the child.
        assert _both(stacks, lambda s: _request(
            s.pool.port, "POST", "/elsewhere", b"x", CREDS))[0] == 404


def test_the_conservation_law_holds(stacks):
    with time_limit(60):
        for stack in stacks.values():
            stack.hub.refresh_once()
        totals = []
        for name, stack in stacks.items():
            ingest = stack.hub.delta
            accepted = (ingest.full_frames_total + ingest.delta_frames_total
                        + ingest.duplicate_frames_total)
            assert stack.pool.accepted_total() == accepted > 0, name
            stats = stack.pool.proc_stats()
            assert sum(s["bytes"] for s in stats.values()) >= \
                ingest.bytes_total
            totals.append((accepted, sum(s["frames"]
                                         for s in stats.values())))
            # What the hub serves through the children's proxy.
            status, text, _h = _request(stack.pool.port, "GET", "/metrics",
                                        headers=CREDS)
            assert status == 200
            exposition = text.decode()
            assert "kts_ingest_procs 2" in exposition
            for idx in range(2):
                assert f'kts_ingest_proc_up{{proc="{idx}"}} 1' in exposition
            served = sum(
                float(line.rsplit(" ", 1)[1])
                for line in exposition.splitlines()
                if line.startswith("kts_ingest_proc_accepted_total{"))
            assert served == accepted
            assert "kts_history_series " in exposition
        assert totals[0] == totals[1]


def test_proxied_reads_keep_their_conditional_headers(stacks):
    with time_limit(60):
        for stack in stacks.values():
            stack.hub.refresh_once()
        for stack in stacks.values():
            port = stack.pool.port
            status, body, headers = _request(
                port, "GET", "/metrics",
                headers={**CREDS, "Accept-Encoding": "gzip"})
            assert status == 200 and headers["Content-Encoding"] == "gzip"
            assert headers["Vary"] == "Accept-Encoding"
            etag = headers["ETag"]
            status, body, again = _request(
                port, "GET", "/metrics",
                headers={**CREDS, "Accept-Encoding": "gzip",
                         "If-None-Match": etag})
            assert (status, body) == (304, b"") and again["ETag"] == etag
            # The same ETag straight from the hub's own server.
            assert _request(stack.server.port, "GET", "/metrics",
                            headers={**CREDS, "Accept-Encoding": "gzip",
                                     "If-None-Match": etag})[0] == 304
            # /query through the proxy, with its own 304.
            status, body, headers = _request(
                port, "GET", "/query?family=slice_chips&window=1h",
                headers=CREDS)
            assert status == 200
            assert json.loads(body)["series"][0]["labels"] == \
                {"slice": "s00"}
            assert _request(port, "GET",
                            "/query?family=slice_chips&window=1h",
                            headers={**CREDS, "If-None-Match":
                                     headers["ETag"]})[0] == 304
        for path, creds in (("/healthz", {}), ("/readyz", {}),
                            ("/metrics", {}), ("/query?family=nope", CREDS),
                            ("/nothing", CREDS)):
            answers = []
            for name, stack in stacks.items():
                status, body, headers = _request(stack.pool.port, "GET",
                                                 path, headers=creds)
                answers.append((status, body if status != 200 else b"",
                                headers.get("WWW-Authenticate")))
            assert answers[0] == answers[1], path
        head = _both(stacks, lambda s: _request(s.pool.port, "HEAD",
                                                "/healthz"))
        assert head[1] == b""


@pytest.mark.parametrize("which", ["port", "ref"])
def test_a_sigkilled_child_is_respawned(stacks, which):
    with time_limit(60):
        pool = stacks[which].pool
        respawns = pool.respawns_total
        victim = pool._children[0]
        victim.send_signal(signal.SIGKILL)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if pool.respawns_total > respawns and pool.alive():
                break
            time.sleep(0.1)
        assert pool.respawns_total > respawns and pool.alive()
        assert pool._children[0].pid != victim.pid
        # The public port answers again once the new child has bound.
        deadline = time.monotonic() + 20.0
        status = None
        while time.monotonic() < deadline:
            try:
                status, _b, _h = _post(
                    pool.port, delta.encode_full(
                        f"http://respawn-{which}:9400/metrics", 3, 1, BODY),
                    timeout=3.0)
                if status == 200:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert status == 200
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and not all(
                s["up"] for s in pool.proc_stats().values()):
            time.sleep(0.1)
        assert all(s["up"] for s in pool.proc_stats().values())


@pytest.mark.parametrize("module", [ingestproc, ref_ingestproc],
                         ids=["port", "ref"])
def test_the_relay_auth_gate_without_a_parent_server(module):
    with time_limit(60):
        the_hub = hub.Hub([], targets_provider=lambda: [], interval=5.0,
                          push_fence=1e9)
        pool = module.IngestProcPool(the_hub.delta.handle, host="127.0.0.1",
                                     port=0, procs=1, parent_port=0,
                                     auth=AUTH)
        pool.start()
        try:
            wire = delta.encode_full("http://auth:9400/metrics", 1, 1, BODY)
            status, _body, headers = _post(pool.port, wire, {})
            assert status == 401 and "WWW-Authenticate" in headers
            assert _post(pool.port, wire)[0] == 200
            # No parent server: proxied reads answer 503.
            assert _request(pool.port, "GET", "/metrics")[0] == 503
        finally:
            pool.stop()
            the_hub.stop()


# -- the control channel's records ------------------------------------------

def test_the_codec_constants_equal_the_reference():
    for name in ("OP_HELLO", "OP_FRAME", "OP_STATS", "_MAX_RECORD",
                 "CHANNELS_PER_PROC", "_PROXY_REQUEST_HEADERS",
                 "_PROXY_RESPONSE_HEADERS"):
        assert getattr(ingestproc, name) == getattr(ref_ingestproc, name)
    for name in ("_REQ_HEAD", "_RESP_HEAD", "_LEN"):
        assert getattr(ingestproc, name).format == \
            getattr(ref_ingestproc, name).format


@pytest.mark.parametrize("size", [0, 1, 4096, 3 * 1024 * 1024])
def test_records_cross_between_the_packages(size):
    payload = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    for writer, reader in ((ingestproc, ref_ingestproc),
                           (ref_ingestproc, ingestproc)):
        left, right = socket.socketpair()
        try:
            sender = threading.Thread(target=writer._send_record, args=(
                left, payload, threading.Lock()))
            sender.start()
            assert reader._read_record(right) == payload
            sender.join(timeout=10)
            left.close()
            assert reader._read_record(right) is None    # EOF
        finally:
            left.close()
            right.close()


def test_an_oversized_record_is_refused_by_both():
    for module in (ingestproc, ref_ingestproc):
        left, right = socket.socketpair()
        try:
            left.sendall(module._LEN.pack(module._MAX_RECORD + 1))
            with pytest.raises(ValueError, match="control record"):
                module._read_record(right)
        finally:
            left.close()
            right.close()


def test_a_port_frame_record_is_answered_by_the_references_pool():
    """The wire between the packages: a port child's FRAME record into
    the reference's pool and the reverse, over a real control socket."""
    with time_limit(60):
        for pool_mod, channel_mod in ((ref_ingestproc, ingestproc),
                                      (ingestproc, ref_ingestproc)):
            seen = []

            def handle(wire, peer=""):
                seen.append((wire, peer))
                return 200, b"applied\n", {"X-KTS-Caps": "1"}

            pool = pool_mod.IngestProcPool(
                handle, host="127.0.0.1", port=0, procs=1,
                spawn_child=lambda idx: None)
            pool.start(wait_ready=0)
            channel = channel_mod._Channel(pool.ctl_path, 0, os.getpid())
            try:
                answer = channel.call("10.1.2.3", "", b"\x01wire")
                assert answer == (200, b"applied\n", {"X-KTS-Caps": "1"})
                assert seen == [(b"\x01wire", "10.1.2.3")]
                channel.send_stats({"idx": 0, "pid": os.getpid(),
                                    "proxied": 3})
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and not \
                        pool.proc_stats()[0]["child"]:
                    time.sleep(0.02)
                stats = pool.proc_stats()[0]
                assert stats["child"]["proxied"] == 3
                assert (stats["frames"], stats["accepted"], stats["up"]) \
                    == (1, 1, 1.0)
            finally:
                channel.close()
                pool.stop()


def test_a_port_just_left_with_time_wait_connections_binds_again():
    """The reservation socket on a port whose last server closed its
    accepted connections first (TIME_WAIT on the server's side): the
    restart case, a hub coming back on its port."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"

        def do_GET(self):  # noqa: N802 - http.server's name
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for _ in range(5):
            assert _request(port, "GET", "/")[0] == 200
    finally:
        server.shutdown()
        server.server_close()
    sock = ingestproc.reuseport_socket("127.0.0.1", port)
    try:
        assert sock.getsockname()[1] == port
    finally:
        sock.close()


# -- the hub's command line ------------------------------------------------------

_HUB_WITH_A_DEAD_CHILD = """
import sys
sys.executable = "/bin/false"      # every child exits at once
package = sys.argv[1]
cli = __import__(package + ".cli", fromlist=["main"])
sys.exit(cli.main(["hub", "--listen-host", "127.0.0.1", "--listen-port",
                   "0", "--ingest-procs", "1", "--interval", "1"]))
"""


def test_a_child_that_never_comes_up_fails_the_hub():
    """No quiet fall back to ingest in-process: the pool's start raises
    and the hub exits non-zero, as the reference's does."""
    with time_limit(90):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _HUB_WITH_A_DEAD_CHILD, package],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
            for package in ("kube_gpu_stats_tpu_torch", "kube_gpu_stats_tpu")]
        outs = [proc.communicate(timeout=80) for proc in procs]
        rcs = [proc.returncode for proc in procs]
        assert rcs[0] == rcs[1] != 0
        for _out, err in outs:
            assert "did not come up" in err
