"""Delta ingest spread over SO_REUSEPORT acceptor processes.

At a few thousand pushing nodes the hub's ingest cost is no longer the
frame apply but the connections: ``ThreadingHTTPServer`` keeps one
thread per persistent publisher connection, and all their socket reads
and HTTP parsing share one interpreter lock.

``--ingest-procs N`` (0 = off) moves that work out of the hub process.
N acceptor children each bind the public port with ``SO_REUSEPORT``;
the kernel spreads incoming connections over their listening sockets,
so each child serves its own share of the publishers on its own
interpreter. A child applies the same edge fences as
``exposition.MetricsServer`` (the Content-Length fence and the body read
deadline) and relays each frame, with the peer address and the
Authorization header, over a few pipelined unix-socket channels to the
hub. The hub stays the one owner of the sessions: seq chains, admission
sheds, quarantine, the series accountant and the checkpoint run the
code they run without children, so the verdicts cannot differ. A
publisher sends its next frame only after the verdict on the last one,
so each source's frames keep their order.

Any other request on the public port (scrapes, probes, ``/debug/*``,
``/query``) is proxied to the hub's own server on a loopback port.

:class:`IngestProcPool`, on the hub's side, starts the children,
restarts one that dies (with a back-off) and stops them. It sees every
relayed frame and its verdict, so ``kts_ingest_proc_*`` counts exactly,
and ``sum(kts_ingest_proc_accepted_total)`` equals the hub's accepted
FULL, DELTA and duplicate frames.

Control-channel records (little-endian):

- request: ``u32 len | u64 id | u8 op | payload``

  - op 1 HELLO: JSON ``{"idx": int, "pid": int}``, a channel's first
    record; no answer
  - op 2 FRAME: ``u16 peer_len | peer | u16 auth_len | auth | wire``
  - op 3 STATS: JSON of the child's own counters; no answer

- response: ``u32 len | u64 id | u16 status | u32 hdr_len |
  hdr JSON | body``

The child runs as ``python -m kube_gpu_stats_tpu_torch.ingestproc``; it
imports no torch.
"""

from __future__ import annotations

import http.client
import http.server
import itertools
import json
import logging
import os
import pathlib
import signal
import socket
import socketserver
import struct
import subprocess
import sys
import threading
import time

from .supervisor import spawn

log = logging.getLogger(__name__)

# The module the pool runs as each child. Written out in full: the
# reference package's name is a prefix of this one.
CHILD_MODULE = "kube_gpu_stats_tpu_torch.ingestproc"

OP_HELLO = 1
OP_FRAME = 2
OP_STATS = 3

_REQ_HEAD = struct.Struct("<QB")      # id, op (after the u32 length)
_RESP_HEAD = struct.Struct("<QHI")    # id, status, header JSON length
_LEN = struct.Struct("<I")

# A relayed record: up to a 64 MiB frame and its envelope.
_MAX_RECORD = 80 * 1024 * 1024

# Upstream channels per child. With two, a slow FULL on one does not
# hold every other connection's verdict behind it.
CHANNELS_PER_PROC = 2

# Headers the GET proxy passes each way; hop-by-hop headers
# (Connection, Keep-Alive, Transfer-Encoding) stay behind.
# If-None-Match, ETag and Vary carry the conditional reads of /metrics
# and /query: without them a reader behind the children would pay for
# a full body every time.
_PROXY_REQUEST_HEADERS = ("Accept", "Accept-Encoding", "Authorization",
                          "If-None-Match")
_PROXY_RESPONSE_HEADERS = ("Content-Type", "Content-Encoding",
                           "Retry-After", "WWW-Authenticate",
                           "Cache-Control", "ETag", "Vary")


def _recv_exact(sock: socket.socket, count: int) -> bytes | None:
    """Exactly ``count`` bytes off a stream socket, or None on EOF."""
    buf = bytearray(count)
    view = memoryview(buf)
    got = 0
    while got < count:
        n = sock.recv_into(view[got:], count - got)
        if n == 0:
            return None
        got += n
    return bytes(buf)


def _read_record(sock: socket.socket) -> bytes | None:
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (length,) = _LEN.unpack(head)
    if length > _MAX_RECORD:
        raise ValueError(f"control record of {length} bytes (cap "
                         f"{_MAX_RECORD})")
    return _recv_exact(sock, length)


def _send_record(sock: socket.socket, payload: bytes,
                 lock: threading.Lock) -> None:
    with lock:
        sock.sendall(_LEN.pack(len(payload)) + payload)


def reuseport_socket(host: str, port: int) -> socket.socket:
    """A TCP socket bound to (host, port) with SO_REUSEPORT, and
    SO_REUSEADDR so that a port a hub has just left, with its accepted
    connections still in TIME_WAIT, binds again. Raises where the
    platform has no SO_REUSEPORT (the hub's flag check says so first)."""
    if not hasattr(socket, "SO_REUSEPORT"):
        raise OSError("SO_REUSEPORT is not available on this platform")
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    return sock


# -- the child: an SO_REUSEPORT HTTP acceptor and its relay channels ---------


class _Channel:
    """One pipelined unix connection to the hub. Callers on many
    threads share it, told apart by request id; a reader thread hands
    each its answer. When the channel breaks, every call in flight gets
    503 (the publisher defers and retries) and the next call
    reconnects."""

    def __init__(self, ctl_path: str, idx: int, pid: int) -> None:
        self._ctl_path = ctl_path
        self._hello = json.dumps({"idx": idx, "pid": pid}).encode()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()       # connect and teardown
        self._write_lock = threading.Lock()
        self._pending: dict[int, list] = {}  # id -> [event, response]
        self._pending_lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._stopped = False

    def _connect_locked(self) -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(self._ctl_path)
        _send_record(
            sock,
            _REQ_HEAD.pack(0, OP_HELLO) + self._hello,
            self._write_lock)
        self._sock = sock
        spawn(self._read_loop, name="ingestproc-channel-reader",
              args=(sock,)).start()
        return sock

    def _ensure(self) -> socket.socket | None:
        with self._lock:
            if self._stopped:
                return None
            if self._sock is None:
                try:
                    self._connect_locked()
                except OSError:
                    return None
            return self._sock

    def _drop(self, sock: socket.socket) -> None:
        with self._lock:
            if self._sock is sock:
                self._sock = None
        try:
            sock.close()
        except OSError:
            pass
        with self._pending_lock:
            stranded = list(self._pending.values())
            self._pending.clear()
        for waiter in stranded:
            waiter[1] = (503, b"ingest relay lost\n", {"Retry-After": "1"})
            waiter[0].set()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                record = _read_record(sock)
                if record is None:
                    break
                rid, status, hdr_len = _RESP_HEAD.unpack_from(record, 0)
                offset = _RESP_HEAD.size
                headers = json.loads(
                    record[offset:offset + hdr_len].decode())
                body = record[offset + hdr_len:]
                with self._pending_lock:
                    waiter = self._pending.pop(rid, None)
                if waiter is not None:
                    waiter[1] = (status, body, headers)
                    waiter[0].set()
        except (OSError, ValueError):
            pass
        self._drop(sock)

    def call(self, peer: str, auth: str, wire: bytes,
             timeout: float = 30.0) -> tuple[int, bytes, dict]:
        sock = self._ensure()
        if sock is None:
            return 503, b"ingest relay unavailable\n", {"Retry-After": "1"}
        rid = next(self._ids)
        waiter = [threading.Event(), None]
        with self._pending_lock:
            self._pending[rid] = waiter
        peer_b = peer.encode()
        auth_b = auth.encode()
        record = b"".join((
            _REQ_HEAD.pack(rid, OP_FRAME),
            struct.pack("<H", len(peer_b)), peer_b,
            struct.pack("<H", len(auth_b)), auth_b,
            wire))
        try:
            _send_record(sock, record, self._write_lock)
        except OSError:
            self._drop(sock)
            return 503, b"ingest relay lost\n", {"Retry-After": "1"}
        if not waiter[0].wait(timeout):
            with self._pending_lock:
                self._pending.pop(rid, None)
            return 503, b"ingest relay timed out\n", {"Retry-After": "1"}
        return waiter[1]

    def send_stats(self, payload: dict) -> None:
        sock = self._ensure()
        if sock is None:
            return
        try:
            _send_record(
                sock,
                _REQ_HEAD.pack(0, OP_STATS) + json.dumps(payload).encode(),
                self._write_lock)
        except OSError:
            self._drop(sock)

    def close(self) -> None:
        with self._lock:
            self._stopped = True
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class _ReuseportHTTPServer(socketserver.ThreadingMixIn,
                           http.server.HTTPServer):
    daemon_threads = True

    def server_bind(self) -> None:
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        http.server.HTTPServer.server_bind(self)


def child_serve(host: str, port: int, ctl_path: str, parent_port: int,
                idx: int, read_deadline: float = 10.0,
                ready_fd: int | None = None):
    """One acceptor: bind (host, port) with SO_REUSEPORT, relay
    ``POST /ingest/delta`` to the hub over ``ctl_path`` and proxy any
    other request to the hub's server on ``parent_port``. Returns the
    server; the caller runs ``serve_forever`` (tests drive a child in
    their own process this way)."""
    from .delta import INGEST_PATH

    pid = os.getpid()
    channels = [_Channel(ctl_path, idx, pid)
                for _ in range(CHANNELS_PER_PROC)]
    rr = itertools.count()
    stats = {"idx": idx, "pid": pid, "proxied": 0, "proxy_errors": 0,
             "rejected_pre_relay": 0}
    stats_lock = threading.Lock()

    class Handler(http.server.BaseHTTPRequestHandler):
        timeout = 30.0
        protocol_version = "HTTP/1.1"
        # Small request/response pairs on keep-alive connections: with
        # Nagle on, each verdict would wait for the peer's delayed ACK
        # (~40 ms) and a publisher's burst would crawl.
        disable_nagle_algorithm = True

        def log_message(self, fmt: str, *args) -> None:
            log.debug("ingestproc[%d]: " + fmt, idx, *args)

        def _send_plain(self, code: int, body: bytes,
                        headers: dict | None = None) -> None:
            self.send_response(code)
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self) -> None:
            path = self.path.split("?", 1)[0]
            if path != INGEST_PATH:
                self._send_plain(404, b"not found\n")
                return
            # MetricsServer's fences: nothing undeclared, oversized or
            # dribbled costs the hub a record.
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = -1
            if length <= 0 or length > 64 * 1024 * 1024:
                with stats_lock:
                    stats["rejected_pre_relay"] += 1
                self._send_plain(413, b"delta frame missing or oversized\n")
                return
            previous_timeout = self.connection.gettimeout()
            self.connection.settimeout(read_deadline)
            try:
                wire = self.rfile.read(length)
            except (socket.timeout, TimeoutError):
                self.close_connection = True
                with stats_lock:
                    stats["rejected_pre_relay"] += 1
                self._send_plain(408, b"request body read timed out\n")
                return
            finally:
                self.connection.settimeout(previous_timeout)
            if len(wire) < length:
                with stats_lock:
                    stats["rejected_pre_relay"] += 1
                self._send_plain(400, b"truncated request body\n")
                return
            channel = channels[next(rr) % len(channels)]
            code, body, headers = channel.call(
                self.client_address[0],
                self.headers.get("Authorization", ""), wire)
            self._send_plain(code, body, headers or None)

        def _proxy(self, method: str) -> None:
            if parent_port <= 0:
                self._send_plain(503, b"no parent exposition server\n",
                                 {"Retry-After": "1"})
                return
            conn = http.client.HTTPConnection("127.0.0.1", parent_port,
                                              timeout=30.0)
            try:
                headers = {}
                for name in _PROXY_REQUEST_HEADERS:
                    value = self.headers.get(name)
                    if value:
                        headers[name] = value
                conn.request(method, self.path, headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                self.send_response(resp.status)
                for name in _PROXY_RESPONSE_HEADERS:
                    value = resp.getheader(name)
                    if value:
                        self.send_header(name, value)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if method != "HEAD":
                    self.wfile.write(body)
                with stats_lock:
                    stats["proxied"] += 1
            except OSError:
                with stats_lock:
                    stats["proxy_errors"] += 1
                self._send_plain(502, b"parent unreachable\n",
                                 {"Retry-After": "1"})
            finally:
                conn.close()

        def do_GET(self) -> None:
            self._proxy("GET")

        def do_HEAD(self) -> None:
            self._proxy("HEAD")

    server = _ReuseportHTTPServer((host, port), Handler)

    def stats_loop() -> None:
        missed = 0
        while True:
            time.sleep(2.0)
            with stats_lock:
                payload = dict(stats)
            channels[0].send_stats(payload)
            # The orphan fence: the control socket gone and no way back
            # means the hub is gone; exit rather than hold the port's
            # group and the inherited descriptors.
            if channels[0]._sock is None \
                    and not os.path.exists(ctl_path):
                missed += 1
                if missed >= 3:
                    log.warning("parent control socket gone; "
                                "acceptor %d exiting", idx)
                    spawn(server.shutdown,
                          name="ingestproc-shutdown").start()
                    return
            else:
                missed = 0

    spawn(stats_loop, name="ingestproc-stats").start()
    # Say HELLO on channel 0 now: the pool takes it as the sign that
    # this child is up, which is after the bind above succeeded.
    channels[0]._ensure()
    if ready_fd is not None:
        try:
            os.write(ready_fd, b"R")
            os.close(ready_fd)
        except OSError:
            pass
    server._kts_channels = channels  # for tests and teardown
    return server


def child_main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="kube-tpu-stats SO_REUSEPORT ingest acceptor "
                    "(spawned by the hub; not a user-facing entry point)")
    parser.add_argument("--host", required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--ctl", required=True)
    parser.add_argument("--parent-port", type=int, default=0)
    parser.add_argument("--idx", type=int, required=True)
    parser.add_argument("--read-deadline", type=float, default=10.0)
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s ingestproc[{args.idx}] %(levelname)s "
               "%(name)s: %(message)s")
    server = child_serve(args.host, args.port, args.ctl,
                         args.parent_port, args.idx,
                         read_deadline=args.read_deadline)

    def on_term(*_sig) -> None:
        spawn(server.shutdown, name="ingestproc-shutdown").start()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        server.server_close()
        for channel in server._kts_channels:
            channel.close()
    return 0


# -- the hub's side: the pool -----------------------------------------------


class _ProcState:
    """One acceptor's counters as the pool keeps them (it sees each
    relayed frame and its verdict), and the child's own edge counters
    as its last STATS record gave them."""

    def __init__(self) -> None:
        self.frames = 0
        self.accepted = 0
        self.shed = 0
        self.bytes = 0
        self.connected_channels = 0
        self.child_stats: dict = {}
        self.pid = 0


class IngestProcPool:
    """Start, feed and watch N SO_REUSEPORT acceptor children.

    ``handle`` is the hub's ``DeltaIngest.handle`` (any ``(wire, peer)
    -> (status, body, headers)`` will do). The pool listens on a unix
    control socket, each child keeps a couple of pipelined channels to
    it, and every FRAME record is answered with what ``handle`` returns:
    the sessions see exactly the calls they see without children.

    A child that dies is started again, with a back-off, until
    :meth:`stop`. The pool holds a reservation socket on the public
    port (bound with SO_REUSEPORT, never listening), so port 0 resolves
    before the first child starts and no other process can take the
    port while a child restarts."""

    def __init__(self, handle, *, host: str, port: int, procs: int,
                 parent_port: int = 0, ctl_dir: str = "",
                 auth: tuple[str, str] | None = None,
                 read_deadline: float = 10.0,
                 spawn_child=None) -> None:
        if procs < 1:
            raise ValueError("IngestProcPool needs procs >= 1")
        self._handle = handle
        self._host = host
        self._procs = procs
        self._parent_port = parent_port
        self._auth = auth or None
        self._read_deadline = read_deadline
        self._spawn_child = spawn_child or self._spawn_subprocess
        self._stopping = threading.Event()
        self._children: list[subprocess.Popen | None] = [None] * procs
        self._respawn_after = [0.0] * procs
        self._states = [_ProcState() for _ in range(procs)]
        self._states_lock = threading.Lock()
        self._hello = [threading.Event() for _ in range(procs)]
        self._threads: list[threading.Thread] = []
        self.respawns_total = 0

        # The public port's reservation (see the class docstring).
        self._reserve = reuseport_socket(host, port)
        self.port = self._reserve.getsockname()[1]

        if ctl_dir:
            self._ctl_dir = pathlib.Path(ctl_dir)
            self._ctl_dir.mkdir(parents=True, exist_ok=True)
            self._ctl_tmp = None
        else:
            import tempfile

            self._ctl_tmp = tempfile.TemporaryDirectory(prefix="kts-ingest-")
            self._ctl_dir = pathlib.Path(self._ctl_tmp.name)
        self.ctl_path = str(self._ctl_dir / "ingest-ctl.sock")
        self._ctl = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.unlink(self.ctl_path)
        except FileNotFoundError:
            pass
        self._ctl.bind(self.ctl_path)
        self._ctl.listen(2 * procs + 4)

    # -- lifecycle ------------------------------------------------------------

    def start(self, wait_ready: float = 15.0) -> None:
        accept_thread = spawn(self._accept_loop,
                              name="ingestproc-accept")
        accept_thread.start()
        self._threads.append(accept_thread)
        for idx in range(self._procs):
            self._spawn(idx)
        monitor = spawn(self._monitor_loop, name="ingestproc-monitor")
        monitor.start()
        self._threads.append(monitor)
        if wait_ready > 0:
            deadline = time.monotonic() + wait_ready
            for event in self._hello:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not event.wait(remaining):
                    raise TimeoutError(
                        "ingest acceptor processes did not come up in "
                        f"{wait_ready:g}s")

    def _spawn_subprocess(self, idx: int) -> subprocess.Popen:
        package_root = pathlib.Path(__file__).resolve().parent.parent
        env = os.environ.copy()
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = (f"{package_root}{os.pathsep}{existing}"
                             if existing else str(package_root))
        return subprocess.Popen(
            [sys.executable, "-m", CHILD_MODULE,
             "--host", self._host, "--port", str(self.port),
             "--ctl", self.ctl_path,
             "--parent-port", str(self._parent_port),
             "--idx", str(idx),
             "--read-deadline", f"{self._read_deadline:g}"],
            env=env)

    def _spawn(self, idx: int) -> None:
        self._hello[idx].clear()
        self._children[idx] = self._spawn_child(idx)

    def _monitor_loop(self) -> None:
        while not self._stopping.wait(0.5):
            for idx, child in enumerate(self._children):
                if child is None or child.poll() is None:
                    continue
                now = time.monotonic()
                if now < self._respawn_after[idx]:
                    continue
                log.warning(
                    "ingest acceptor %d (pid %s) exited with %s; "
                    "respawning", idx, child.pid, child.returncode)
                self._respawn_after[idx] = now + 1.0
                self.respawns_total += 1
                with self._states_lock:
                    self._states[idx].connected_channels = 0
                self._spawn(idx)

    def stop(self, timeout: float = 5.0) -> None:
        if self._stopping.is_set():
            return
        self._stopping.set()
        for child in self._children:
            if child is not None and child.poll() is None:
                try:
                    child.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for child in self._children:
            if child is None:
                continue
            try:
                child.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait(5.0)
        try:
            self._ctl.close()
        except OSError:
            pass
        try:
            os.unlink(self.ctl_path)
        except OSError:
            pass
        try:
            self._reserve.close()
        except OSError:
            pass
        if self._ctl_tmp is not None:
            self._ctl_tmp.cleanup()

    def alive(self) -> bool:
        return all(child is not None and child.poll() is None
                   for child in self._children)

    # -- control channel -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = self._ctl.accept()
            except OSError:
                return
            thread = spawn(self._serve_channel, name="ingestproc-ctl",
                           args=(conn,))
            thread.start()

    def _check_auth(self, header: str) -> bool:
        import base64
        import hashlib
        import hmac

        expected_user, expected_hash = self._auth
        if not header.startswith("Basic "):
            return False
        try:
            decoded = base64.b64decode(header[6:]).decode("utf-8")
            user, _, password = decoded.partition(":")
        except (ValueError, UnicodeDecodeError):
            return False
        digest = hashlib.sha256(password.encode()).hexdigest()
        return hmac.compare_digest(
            user.encode(), expected_user.encode()
        ) & hmac.compare_digest(
            digest.encode(), expected_hash.lower().encode())

    def _serve_channel(self, conn: socket.socket) -> None:
        write_lock = threading.Lock()
        state: _ProcState | None = None
        try:
            while True:
                record = _read_record(conn)
                if record is None:
                    return
                rid, op = _REQ_HEAD.unpack_from(record, 0)
                offset = _REQ_HEAD.size
                if op == OP_HELLO:
                    meta = json.loads(record[offset:].decode())
                    idx = int(meta.get("idx", -1))
                    if 0 <= idx < self._procs:
                        state = self._states[idx]
                        with self._states_lock:
                            state.pid = int(meta.get("pid", 0))
                            state.connected_channels += 1
                        self._hello[idx].set()
                    continue
                if op == OP_STATS:
                    meta = json.loads(record[offset:].decode())
                    idx = int(meta.get("idx", -1))
                    if 0 <= idx < self._procs:
                        with self._states_lock:
                            self._states[idx].child_stats = meta
                    continue
                if op != OP_FRAME:
                    raise ValueError(f"unknown control op {op}")
                (peer_len,) = struct.unpack_from("<H", record, offset)
                offset += 2
                peer = record[offset:offset + peer_len].decode()
                offset += peer_len
                (auth_len,) = struct.unpack_from("<H", record, offset)
                offset += 2
                auth_header = record[offset:offset + auth_len].decode()
                offset += auth_len
                wire = record[offset:]
                if self._auth is not None and \
                        not self._check_auth(auth_header):
                    status, body, headers = (
                        401, b"unauthorized\n",
                        {"WWW-Authenticate":
                         'Basic realm="kube-tpu-stats"'})
                else:
                    try:
                        status, body, headers = self._handle(
                            wire, peer=peer)
                    except Exception:  # noqa: BLE001 - one frame must
                        # not end the channel: the publisher gets 500
                        # and resyncs, as MetricsServer.do_POST does.
                        log.exception("relayed delta ingest crashed")
                        status, body, headers = 500, b"ingest error\n", {}
                if state is not None:
                    with self._states_lock:
                        state.frames += 1
                        state.bytes += len(wire)
                        if status == 200:
                            state.accepted += 1
                        elif status in (413, 429, 503):
                            state.shed += 1
                hdr = json.dumps(headers or {}).encode()
                _send_record(
                    conn,
                    _RESP_HEAD.pack(rid, status, len(hdr)) + hdr + body,
                    write_lock)
        except (OSError, ValueError) as exc:
            if not self._stopping.is_set():
                log.warning("ingest control channel dropped: %s", exc)
        finally:
            if state is not None:
                with self._states_lock:
                    state.connected_channels = max(
                        0, state.connected_channels - 1)
            try:
                conn.close()
            except OSError:
                pass

    # -- what the hub serves ---------------------------------------------------

    def proc_stats(self) -> dict[int, dict]:
        with self._states_lock:
            return {
                idx: {
                    "frames": st.frames,
                    "accepted": st.accepted,
                    "shed": st.shed,
                    "bytes": st.bytes,
                    "up": 1.0 if st.connected_channels > 0 else 0.0,
                    "pid": st.pid,
                    "child": dict(st.child_stats),
                }
                for idx, st in enumerate(self._states)
            }

    def accepted_total(self) -> int:
        with self._states_lock:
            return sum(st.accepted for st in self._states)

    def contribute(self, builder) -> None:
        """``kts_ingest_proc*`` onto the hub's snapshot (hub main wires
        it with ``Hub.add_metrics_provider``)."""
        from . import schema

        builder.add(schema.INGEST_PROCS, float(self._procs))
        for idx, stats in self.proc_stats().items():
            labels = (("proc", str(idx)),)
            builder.add(schema.INGEST_PROC_UP, stats["up"], labels)
            builder.add(schema.INGEST_PROC_FRAMES,
                        float(stats["frames"]), labels)
            builder.add(schema.INGEST_PROC_ACCEPTED,
                        float(stats["accepted"]), labels)
            builder.add(schema.INGEST_PROC_SHED,
                        float(stats["shed"]), labels)
            builder.add(schema.INGEST_PROC_BYTES,
                        float(stats["bytes"]), labels)


if __name__ == "__main__":
    sys.exit(child_main())
