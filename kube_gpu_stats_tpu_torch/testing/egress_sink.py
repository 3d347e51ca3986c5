"""One receiver for all three push paths, built from the port's decoders.

Test support like ``testing/faultfs.py``: the CPU tests and the on-card
smoke point the daemon's senders at it and read back what arrived.

- ``POST /ingest/delta`` — the delta publisher's frames. Every response
  carries the hello headers (``X-KTS-Proto-Min/Max``, ``X-KTS-Caps``,
  ``X-KTS-Build``) of a configurable protocol range. Frames apply by the
  receiver rules of ``delta.py``: a FULL replaces the session (a
  retransmit of the FULL already applied, same generation and seq, is
  applied again but counted as a duplicate), a DELTA needs the session's
  generation and seq + 1 and slots inside the last FULL's series, else
  409. A version outside the range answers 426 (+ Retry-After), a
  malformed frame 400. Frames decode with ``delta.decode_frame``; FULL
  bodies parse with ``validate.parse_exposition_interned``.
- ``POST /api/v1/write`` — remote write, 1.0 or 2.0 by the
  ``Content-Type``; bodies go through ``snappy.decompress`` and
  ``prompb.decode_write_request`` / ``prompb2.decode_request``, and every
  request is kept in arrival order. Answers 204.
- ``PUT /metrics/job/...`` — the Pushgateway; every body is kept with
  its path. Answers 200.

:meth:`EgressSink.blackout` resets every connection until
:meth:`restore` (what a refusing receiver looks like to the senders);
:meth:`restart` closes the listener and opens it again on the same port,
optionally with a new protocol range. The server runs on threads of the
calling process.
"""

from __future__ import annotations

import http.server
import socket
import struct
import threading
import time
from typing import NamedTuple

from .. import delta, snappy
from ..proto import prompb, prompb2
from ..validate import parse_exposition_interned

V2_CONTENT_TYPE = "proto=io.prometheus.write.v2.Request"


class Applied(NamedTuple):
    """One delta frame the sink applied, with the session's state after
    it: ``series`` holds (name, labels, value) in slot order."""
    source: str
    kind: int
    nbytes: int
    duplicate: bool
    at: float
    series: tuple


class Write(NamedTuple):
    """One remote-write request: its protocol ("1.0" | "2.0"), its
    decoded series [(labels, [(value, ts_ms)], ...)] and its size."""
    protocol: str
    series: list
    nbytes: int


class _Session:
    __slots__ = ("generation", "seq", "series")

    def __init__(self, generation: int, seq: int, series: list) -> None:
        self.generation = generation
        self.seq = seq
        self.series = series


class _Server(http.server.ThreadingHTTPServer):
    """A threaded server that, while ``refusing``, resets each
    connection as it accepts it (SO_LINGER 0: an RST, not a FIN)."""

    daemon_threads = True
    request_queue_size = 128
    refusing = False

    def process_request(self, request, client_address) -> None:
        if self.refusing:
            request.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                               struct.pack("ii", 1, 0))
            self.close_request(request)
            return
        super().process_request(request, client_address)


class EgressSink:
    """Delta ingest, remote-write receiver and Pushgateway in one
    threaded HTTP server. All recorded state is guarded by one lock; read
    it through the accessor methods."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 proto_min: int = delta.PROTO_MIN,
                 proto_max: int = delta.PROTO_MAX,
                 build: str = "egress-sink") -> None:
        self.host = host
        self.port = port
        self.proto_min = proto_min
        self.proto_max = proto_max
        self.build = build
        self._lock = threading.Lock()
        self._sessions: dict[str, _Session] = {}
        self._applied: list[Applied] = []
        self._writes: list[Write] = []
        self._pushes: list[tuple[str, bytes]] = []
        # status code -> count of delta POSTs answered with it
        self.delta_status: dict[int, int] = {}
        # Seconds each remote-write request is held before its answer:
        # a slow receiver.
        self.write_delay = 0.0
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "EgressSink":
        self._httpd = _Server((self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="egress-sink", daemon=True)
        self._thread.start()
        return self

    def blackout(self) -> None:
        """Refuse every sender until :meth:`restore`: the listener stays
        bound and resets each connection it accepts, so each request
        fails at once. Closing the listener would leave the refusal to
        the network stack, and under gVisor a connection made in the
        moments after a listener closes can hang instead of failing: the
        sender then waits out its timeout, as at a blackholed receiver,
        not a refused one."""
        if self._httpd is not None:
            self._httpd.refusing = True

    def restore(self) -> None:
        """Serve again on the same port; sessions and records survive
        the blackout."""
        if self._httpd is None:
            self.start()
        self._httpd.refusing = False

    def restart(self, proto_min: int | None = None,
                proto_max: int | None = None) -> None:
        """Close the listener and open it again on the same port, with a
        new protocol range when given; sessions and records survive."""
        self.stop()
        if proto_min is not None:
            self.proto_min = proto_min
        if proto_max is not None:
            self.proto_max = proto_max
        self.start()

    def stop(self) -> None:
        """Close the listener."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- records --------------------------------------------------------------

    def applied(self, source: str | None = None) -> list[Applied]:
        with self._lock:
            return [a for a in self._applied
                    if source is None or a.source == source]

    def sessions(self) -> dict[str, list]:
        """source -> the series state of each live session."""
        with self._lock:
            return {source: list(s.series)
                    for source, s in self._sessions.items()}

    def writes(self) -> list[Write]:
        with self._lock:
            return list(self._writes)

    def pushes(self) -> list[tuple[str, bytes]]:
        with self._lock:
            return list(self._pushes)

    def hello_headers(self) -> dict[str, str]:
        return {delta.HELLO_PROTO_MIN: str(self.proto_min),
                delta.HELLO_PROTO_MAX: str(self.proto_max),
                delta.HELLO_CAPS: str(delta.CAPS_CURRENT),
                delta.HELLO_BUILD: self.build}

    # -- the delta receiver ---------------------------------------------------

    def handle_delta(self, wire: bytes) -> tuple[int, bytes, dict]:
        """(status, body, headers) for one frame: the receiver rules of
        ``delta.py``, applied to this sink's sessions."""
        hello = self.hello_headers()
        try:
            frame = delta.decode_frame(wire)
        except delta.FrameVersionSkew as exc:
            return self._refuse(exc.version, hello)
        except ValueError as exc:
            return 400, f"bad delta frame: {exc}\n".encode(), {}
        if not self.proto_min <= frame.proto <= self.proto_max:
            return self._refuse(frame.proto, hello)
        if frame.kind == delta.KIND_FULL:
            try:
                series = parse_exposition_interned(frame.body)
            except ValueError as exc:
                return 400, f"bad delta frame: {exc}\n".encode(), {}
        with self._lock:
            session = self._sessions.get(frame.source)
            if frame.kind == delta.KIND_FULL:
                duplicate = (session is not None
                             and session.generation == frame.generation
                             and session.seq == frame.seq)
                session = _Session(frame.generation, frame.seq, series)
                self._sessions[frame.source] = session
            else:
                reason = self._delta_verdict(session, frame)
                if reason:
                    return 409, f"resync required: {reason}\n".encode(), hello
                series = list(session.series)
                for slot, value in zip(frame.slots, frame.values):
                    name, labels, _ = series[slot]
                    series[slot] = (name, labels, value)
                session.series = series
                session.seq = frame.seq
                duplicate = False
            self._applied.append(Applied(
                frame.source, frame.kind, len(wire), duplicate,
                time.monotonic(), tuple(series)))
        return 200, b"ok\n", hello

    @staticmethod
    def _delta_verdict(session: _Session | None, frame) -> str:
        if session is None:
            return "no session state"
        if frame.generation != session.generation:
            return (f"generation mismatch (session {session.generation}, "
                    f"frame {frame.generation})")
        if frame.seq != session.seq + 1:
            return f"seq gap (session at {session.seq}, frame {frame.seq})"
        n = len(session.series)
        for slot in frame.slots:
            if slot >= n:
                return f"slot {slot} out of range ({n})"
        return ""

    def _refuse(self, version: int, hello: dict) -> tuple[int, bytes, dict]:
        hello["Retry-After"] = "60"
        return (426, f"upgrade required: wire protocol v{version} outside "
                     f"accepted range {self.proto_min}..{self.proto_max}\n"
                     .encode(), hello)

    # -- the other two receivers ----------------------------------------------

    def handle_write(self, body: bytes, content_type: str
                     ) -> tuple[int, bytes]:
        if self.write_delay:
            time.sleep(self.write_delay)
        try:
            raw = snappy.decompress(body)
            if V2_CONTENT_TYPE in content_type:
                protocol = "2.0"
                series = prompb2.decode_request(raw)
            else:
                protocol = "1.0"
                series = prompb.decode_write_request(raw)
        except ValueError as exc:
            return 400, f"bad write request: {exc}\n".encode()
        with self._lock:
            self._writes.append(Write(protocol, series, len(body)))
        return 204, b""

    def handle_push(self, path: str, body: bytes) -> tuple[int, bytes]:
        with self._lock:
            self._pushes.append((path, body))
        return 200, b""

    # -- HTTP -----------------------------------------------------------------

    def _handler(self):
        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _body(self) -> bytes:
                return self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))

            def _answer(self, status: int, body: bytes,
                        headers: dict | None = None) -> None:
                self.send_response(status)
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:  # noqa: N802 - http.server's name
                path = self.path.partition("?")[0]
                body = self._body()
                if path == delta.INGEST_PATH:
                    status, out, headers = sink.handle_delta(body)
                    with sink._lock:
                        sink.delta_status[status] = \
                            sink.delta_status.get(status, 0) + 1
                    self._answer(status, out, headers)
                elif path.endswith("/api/v1/write"):
                    status, out = sink.handle_write(
                        body, self.headers.get("Content-Type", ""))
                    self._answer(status, out)
                elif path.startswith("/metrics/job/"):
                    self._answer(*sink.handle_push(path, body))
                else:
                    self._answer(404, b"not found\n")

            def do_PUT(self) -> None:  # noqa: N802 - http.server's name
                path = self.path.partition("?")[0]
                body = self._body()
                if path.startswith("/metrics/job/"):
                    self._answer(*sink.handle_push(path, body))
                else:
                    self._answer(404, b"not found\n")

            def log_message(self, *args) -> None:
                pass

        return Handler
