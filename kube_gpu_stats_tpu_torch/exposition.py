"""Exposition layer: the HTTP scrape endpoint and the textfile writer.

- HTTP ``GET /metrics`` — Prometheus scrape endpoint (text 0.0.4, or
  OpenMetrics on request; gzip when accepted; ``ETag``/``If-None-Match``).
  Renders the last published snapshot; never touches collector state, so
  a scrape storm cannot perturb the poll budget. ``/healthz`` fails when
  no snapshot was published for ``healthz_max_age`` seconds; ``/readyz``
  passes once one was, or as the owner's ``ready_check`` says.
- HTTP ``POST /ingest/delta`` — the hub's delta-push receiver, when an
  ``ingest_provider`` is wired: behind the same auth gate as
  ``/metrics``, with a Content-Length fence (413) and a body read
  deadline (408).
- HTTP ``GET /debug/ticks|trace|events`` — the flight recorder's read
  side (``tracing.Tracer``), when one is wired; ``/debug/threads`` (a
  stack dump of every thread) and ``/debug/profile?seconds=N`` (folded
  stacks sampled over N seconds, ``profiler.py``) always;
  ``/debug/burst`` (the burst sampler's status, ``?arm=N`` and
  ``?disarm``), ``/debug/energy`` (the energy accountant's signed
  digest), ``/debug/stores`` (every disk-backed store's health, the
  accept fence, thread restarts), ``/debug/host`` (the host-signals
  snapshot), ``/debug/egress`` (the push senders' backlog, lag and loss)
  ``/debug/skew`` (build and wire-protocol negotiation),
  ``/debug/cardinality`` (the hub's series ledger), ``/debug/fleet``
  (the hub's fleet-lens rollup) and ``/debug/efficiency`` (the hub's
  signed energy/waste attestation) when those are wired.
- HTTP ``GET /query`` — the hub's history ring (``history.HistoryStore``),
  when a ``history_provider`` is wired: range and ``at=`` reads behind the
  auth gate, with their own ETag, 304 and gzip.
- TLS (``tls_cert_file``/``tls_key_file``), mTLS (``tls_client_ca_file``)
  and basic auth (``auth_username`` + ``auth_password_sha256``) on every
  path but the kubelet probes ``/healthz`` and ``/readyz``.
- node_exporter textfile — ``<dir>/accelerator.prom`` rewritten atomically
  (tmp + rename) after each poll tick.
- Pushgateway — :class:`PushgatewayPusher` PUTs each published snapshot.

The port's copy of the reference's exposition layer.
"""

from __future__ import annotations

import errno
import http.server
import json
import logging
import os
import socket
import ssl
import sys
import threading
import time
from pathlib import Path

from . import schema
from .history import etag_match
from .registry import HistogramState, Registry
from .resilience import BackoffPolicy
from .supervisor import spawn
from .workers import PublishFollower, push_opener
from .wal import store_health

log = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def _gzip_accepted(accept_encoding: str) -> bool:
    """True when the client's Accept-Encoding allows gzip (a listed gzip
    with q=0 is an explicit refusal)."""
    for token in accept_encoding.split(","):
        parts = token.strip().split(";")
        if parts[0].strip().lower() in ("gzip", "*"):
            for param in parts[1:]:
                key, _, value = param.strip().partition("=")
                if key.strip() == "q":
                    try:
                        return float(value) > 0
                    except ValueError:
                        return True
            return True
    return False


def _metrics_etag(boot_id: str, generation: int, openmetrics: bool,
                  gzip_wanted: bool) -> str:
    """Strong ETag for a /metrics representation: boot nonce (a warm
    restart resets the generation counter — without the nonce a reader
    from the previous boot could draw a stale 304), render generation,
    and the negotiated shape (format + encoding), so the same reader
    regenerates the same tag for the same request between publishes."""
    return (f'"{boot_id}-{generation}'
            f'-m{int(openmetrics)}{int(gzip_wanted)}"')


class RenderStats:
    """Scrape-side self-observability shared by every render site (HTTP
    scrape, textfile): the render+compress half of the scrape cost.
    Writers call :meth:`observe` from their own threads; the poll loop
    folds the state into each snapshot via :meth:`contribute`, with a lock
    only around this small accumulator, never around a render."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: dict[str, HistogramState] = {}
        self._bytes: dict[str, int] = {}
        self._rejected = 0
        self._rejected_warned = False
        self._cache_hits = 0
        self._cache_misses = 0
        # Conditional reads answered 304, by path. Seeded so both
        # series are born at 0 on the first contribute — same
        # increase()-alerting reasoning as the rejection counter.
        self._not_modified: dict[str, int] = {"/metrics": 0, "/query": 0}

    def observe(self, output: str, seconds: float, nbytes: int) -> None:
        with self._lock:
            hist = self._hists.get(output)
            if hist is None:
                hist = HistogramState.empty(
                    schema.SELF_SCRAPE_DURATION,
                    schema.SCRAPE_DURATION_BUCKETS,
                    labels=(("output", output),),
                )
            self._hists[output] = hist.observe(seconds)
            self._bytes[output] = self._bytes.get(output, 0) + nbytes

    def observe_cache(self, hit: bool) -> None:
        """Count a Registry.rendered() outcome (kts_render_cache_* —
        the one-render-per-generation cache must be observable, or a
        0% hit rate under scrape fan-in is invisible)."""
        with self._lock:
            if hit:
                self._cache_hits += 1
            else:
                self._cache_misses += 1

    def observe_not_modified(self, path: str) -> None:
        """Count a conditional read answered 304 (the If-None-Match hit
        that cost zero render/gzip/transfer —
        kts_scrape_not_modified_total{path=...})."""
        with self._lock:
            self._not_modified[path] = self._not_modified.get(path, 0) + 1

    def reject(self) -> None:
        """Count a scrape the storm guard answered 503 — the guard must
        be diagnosable from the exposition, not just from gaps."""
        with self._lock:
            self._rejected += 1
            first = not self._rejected_warned
            self._rejected_warned = True
        if first:
            log.warning("scrape-storm guard fired: a /metrics request was "
                        "answered 503 (max-concurrent-scrapes); further "
                        "rejections count in "
                        "collector_scrapes_rejected_total")

    def contribute(self, builder) -> None:
        """Fold current state into a SnapshotBuilder (poll-loop thread)."""
        with self._lock:
            hists = [self._hists[k] for k in sorted(self._hists)]
            sizes = sorted(self._bytes.items())
            rejected = self._rejected
            cache_hits = self._cache_hits
            cache_misses = self._cache_misses
            not_modified = sorted(self._not_modified.items())
        for hist in hists:
            builder.add_histogram(hist)
        for output, total in sizes:
            builder.add(schema.SELF_RENDERED_BYTES, float(total),
                        (("output", output),))
        # Unconditional, born at 0: increase()-based alerting misses a
        # burst entirely if the series first appears already at N.
        builder.add(schema.SELF_SCRAPES_REJECTED, float(rejected))
        builder.add(schema.RENDER_CACHE_HITS, float(cache_hits))
        builder.add(schema.RENDER_CACHE_MISSES, float(cache_misses))
        for path, count in not_modified:
            builder.add(schema.SCRAPE_NOT_MODIFIED, float(count),
                        (("path", path),))


class _AcceptFence:
    """EMFILE/ENFILE fence for an accept loop: when the
    process (or host) runs out of file descriptors, ``accept()`` fails
    — socketserver swallows the OSError, so the loop never *dies*, but
    it spins hot, burning CPU and log lines while serving nobody. The
    fence converts that into shed-with-backoff: each fenced failure
    counts (``kts_disk_faults_total{store="http-accept"}``), journals
    once per episode through the shared store state machine, and sleeps
    an exponentially growing beat (50 ms → 1 s) so in-flight handlers
    get a chance to close sockets and return fds. A successful accept
    re-arms instantly."""

    FENCED_ERRNOS = frozenset(
        getattr(errno, name)
        for name in ("EMFILE", "ENFILE", "ENOBUFS", "ENOMEM")
        if hasattr(errno, name))

    def __init__(self) -> None:
        # Shared state machine => shared metrics (kts_store_state,
        # kts_disk_faults_total{store="http-accept"}).
        self._health = store_health("http-accept")
        # The one backoff implementation (resilience.BackoffPolicy),
        # like every other retry path in the package: 50 ms doubling to
        # a 1 s cap, reset on the first successful accept.
        self._backoff = BackoffPolicy(base=0.05, cap=1.0)
        # Per-fence episode bookkeeping, so two servers in one process
        # report their own accept health at /debug/stores.
        self.fenced_total = 0
        self.episodes = 0
        self.in_episode = False

    def faulted(self, exc: OSError) -> None:
        if not self.in_episode:
            self.episodes += 1
            self.in_episode = True
        self.fenced_total += 1
        self._health.record_fault(exc)
        time.sleep(self._backoff.next_delay())

    def accepted(self) -> None:
        if not self.in_episode:
            return
        self.in_episode = False
        self._backoff.reset()
        self._health.ok()

    def status(self) -> dict:
        return {
            "fenced_total": self.fenced_total,
            "episodes": self.episodes,
            "in_episode": self.in_episode,
            "state": self._health.state,
        }


class _FencedHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer whose accept path survives fd exhaustion:
    ``get_request`` routes EMFILE-class OSErrors through the
    :class:`_AcceptFence` (count + journal + backoff) before re-raising
    into socketserver's own swallow — the accept loop sheds, it never
    dies and never spins."""

    fence: _AcceptFence | None = None

    # socketserver's default listen backlog is 5 — a 256-reader
    # dashboard stampede overflows it instantly and the
    # dropped SYNs come back as multi-second TCP retransmits, which is
    # the whole query p99. The accept loop drains a deeper backlog in
    # microseconds; memory cost is a queue of accepted-socket refs.
    request_queue_size = 256

    def get_request(self):
        try:
            request = super().get_request()
        except OSError as exc:
            fence = self.fence
            if (fence is not None and getattr(exc, "errno", None)
                    in _AcceptFence.FENCED_ERRNOS):
                fence.faulted(exc)
            raise
        fence = self.fence
        if fence is not None:
            fence.accepted()
        return request

    def handle_error(self, request, client_address) -> None:
        """A client that fails the TLS handshake (a plain-HTTP prober, a
        missing client cert), resets, or times out costs only its own
        connection: logged at debug, as requests are, instead of a
        traceback on stderr per such client. Anything else keeps
        socketserver's report."""
        exc = sys.exc_info()[1]
        if isinstance(exc, (ssl.SSLError, ConnectionError, TimeoutError)):
            log.debug("http: connection from %s dropped: %s",
                      client_address, exc)
            return
        super().handle_error(request, client_address)


class MetricsServer:
    """Threaded HTTP server for /metrics, /healthz, /readyz, /debug/* and /.

    ``healthz_max_age`` (seconds) makes /healthz return 503 when no snapshot
    has been published for that long — so a dead poll loop fails the
    liveness probe instead of serving stale data forever. 0 disables the
    staleness check (bare-registry uses in tests/tools).

    Web hardening:

    - ``tls_cert_file``/``tls_key_file`` serve HTTPS; ``tls_client_ca_file``
      also requires a client certificate signed by that CA (mTLS).
    - ``auth_username`` + ``auth_password_sha256`` (hex digest) require
      HTTP basic auth on every path except /healthz and /readyz, which
      kubelet probes hit unauthenticated.

    /metrics responses are gzip-compressed when the scraper advertises
    ``Accept-Encoding: gzip`` (Prometheus always does).
    """

    # Bodies below this size aren't worth the gzip header overhead.
    GZIP_MIN_BYTES = 256

    def __init__(self, registry: Registry, host: str = "0.0.0.0",
                 port: int = 9400, healthz_max_age: float = 0.0,
                 tls_cert_file: str = "", tls_key_file: str = "",
                 tls_client_ca_file: str = "",
                 auth_username: str = "", auth_password_sha256: str = "",
                 max_concurrent_scrapes: int = 16,
                 render_stats: RenderStats | None = None,
                 health_provider=None, trace_provider=None,
                 burst_provider=None, energy_provider=None,
                 host_provider=None, egress_provider=None,
                 skew_provider=None, stores_provider=None,
                 ready_check=None, ingest_provider=None,
                 cardinality_provider=None, history_provider=None,
                 fleet_provider=None, efficiency_provider=None,
                 prewarm_renders: bool = True,
                 ingest_read_deadline: float = 10.0):
        self._registry = registry
        # The hub's history ring: ``handle_query(params, client,
        # gzip_ok, if_none_match) -> (status, body, headers)`` answers
        # /query. A disabled store (--no-history) answers enabled:false;
        # None (daemons, bare test servers) 404s.
        self._history = history_provider
        # Delta-push ingest (delta.DeltaIngest.handle, duck-typed:
        # (bytes, peer) -> (status, body, headers)): serves POST
        # /ingest/delta behind the same auth gate as /metrics. None =
        # POSTs answer 404 (daemons and bare test servers don't
        # ingest). ingest_read_deadline is the slow-loris fence: a POST
        # body that dribbles in slower than this is cut off with 408 —
        # without it, ThreadingHTTPServer donates one thread per loris
        # until the default socket timeout (None: forever).
        self._ingest = ingest_provider
        self._ingest_read_deadline = ingest_read_deadline
        # Optional () -> (ok, reason) overriding /readyz's default
        # "a snapshot exists" test — the hub gates readiness on having
        # targets and on a finished warm-restart replay, so scrapers
        # drain from a blind hub without tripping the liveness probe.
        self._ready_check = ready_check
        # Cardinality admission, () -> dict (/debug/cardinality: the
        # series ledger against its limits, top offenders by series and
        # by shed — what `doctor --cardinality` reads). None (daemons,
        # bare test servers) 404s.
        self._cardinality = cardinality_provider
        # Fleet lens (fleetlens.FleetLens, duck-typed: anything with
        # rollup() -> dict): serves /debug/fleet — per-target health,
        # the anomaly list, SLO burn state, slow-node attribution.
        # None = 404 (the hub wires it; daemons and --no-fleet-lens
        # hubs don't serve a fleet view).
        self._fleet = fleet_provider
        # Fleet efficiency attestation, () -> dict: serves
        # /debug/efficiency — the signed federation-wide energy/waste
        # rollup `doctor --efficiency` verifies. A wired hub with
        # --no-efficiency answers enabled:false (the --no-trace
        # contract); None (daemons, bare test servers, --no-fleet-lens
        # hubs) 404s.
        self._efficiency = efficiency_provider
        # Flight recorder (tracing.Tracer): serves /debug/ticks,
        # /debug/trace and /debug/events behind the same auth gate as
        # /metrics. None = those paths 404.
        self._trace = trace_provider
        # Burst sampler (/debug/burst), energy accountant
        # (/debug/energy), host-signals collector (/debug/host) and the
        # stores payload, () -> dict (/debug/stores); None = that path
        # 404s.
        self._burst = burst_provider
        self._energy = energy_provider
        self._host = host_provider
        self._stores = stores_provider
        # Egress durability, () -> dict (/debug/egress: spill-queue
        # depth/age, durable remote-write shard WAL/lag/parked state,
        # sender health — what `doctor --egress` reads; a daemon with no
        # sender configured answers enabled:false) and version skew,
        # () -> dict (/debug/skew: build, wire-protocol range, the
        # publisher's negotiation state, quarantined persisted formats —
        # what `doctor --skew` reads). None = that path 404s.
        self._egress = egress_provider
        self._skew = skew_provider
        # (user, lower-case sha256 hex of the password), or None = open.
        self._auth = (
            (auth_username, auth_password_sha256.lower())
            if auth_username else None
        )
        # /debug/profile is single-flight: two requests must not double
        # the sampling overhead.
        self._profile_lock = threading.Lock()
        self._healthz_max_age = healthz_max_age
        self._render_stats = render_stats
        # Optional () -> [(component, state, reason)] rows (the
        # supervisor's health_report): /healthz carries per-component
        # reasons so "degraded" is diagnosable from one probe, while the
        # 200/503 verdict stays snapshot-staleness only — a degraded (but
        # collecting) exporter must NOT be liveness-restarted.
        self._health_provider = health_provider
        # Render pre-warmer: a publish-following thread fills the
        # per-generation render cache (text + gzip) the moment a snapshot
        # lands, so a scrape serves pre-rendered, pre-gzipped bytes
        # instead of paying the render inline. On for every server unless
        # the caller turns it off (``prewarm_renders=False``: the query
        # sim and ``bench.measure_query`` time the serving path alone) or
        # the registry cannot signal publishes.
        self._prewarm = (prewarm_renders
                         and callable(getattr(registry,
                                              "wait_for_publish", None))
                         and hasattr(registry, "generation"))
        self._warm_stop = threading.Event()
        self._warm_thread: threading.Thread | None = None
        # Scrape-storm guard (exporter-toolkit web.max-requests analog):
        # ThreadingHTTPServer spawns one thread per connection with no
        # ceiling, so N misbehaving scrapers = N concurrent renders.
        # Renders beyond the cap get an immediate 503 (Retry-After: 1)
        # instead of queueing; /healthz and /readyz stay exempt so
        # kubelet probes always land. 0 disables the cap.
        self._scrape_slots = (
            threading.BoundedSemaphore(max_concurrent_scrapes)
            if max_concurrent_scrapes > 0 else None
        )

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # Header-level slow-loris fence: the socket
            # timeout BaseHTTPRequestHandler applies to every read on
            # the connection, so a client that opens a connection and
            # dribbles (or never sends) the request line can hold its
            # handler thread for at most this long — with the default
            # (None) it holds the thread forever and a few hundred
            # sockets exhaust the thread budget.
            timeout = 30.0

            # Keep-alive: every response path sends
            # Content-Length (the two write sites are _send_plain and
            # the do_GET tail), so HTTP/1.1 persistent connections are
            # safe — and they change the dashboard-stampede cost model
            # from connect+thread-spawn+teardown PER REQUEST (~1 ms of
            # single-core CPU, which saturates at ~1k req/s and turns
            # 256 readers into 200 ms queueing tails) to parse+respond
            # on a long-lived thread. Idle connections are bounded by
            # ``timeout`` above.
            protocol_version = "HTTP/1.1"

            # Scrapes arrive at >= 1/s per Prometheus; default logging to
            # stderr per request would swamp the workload's logs.
            def log_message(self, fmt: str, *args) -> None:
                log.debug("http: " + fmt, *args)

            def _authorized(self) -> bool:
                import base64
                import hashlib
                import hmac

                expected_user, expected_hash = outer._auth
                header = self.headers.get("Authorization", "")
                if not header.startswith("Basic "):
                    return False
                try:
                    decoded = base64.b64decode(header[6:]).decode("utf-8")
                    user, _, password = decoded.partition(":")
                except (ValueError, UnicodeDecodeError):
                    return False
                digest = hashlib.sha256(password.encode()).hexdigest()
                # Compare as bytes (compare_digest raises TypeError on a
                # non-ASCII str — a crafted user name must get 401, not
                # crash the connection). Both comparisons constant-time;
                # & (not `and`) so the user check cannot short-circuit
                # into a timing oracle.
                return hmac.compare_digest(
                    user.encode(), expected_user.encode()
                ) & hmac.compare_digest(
                    digest.encode(), expected_hash.encode()
                )

            def _query(self) -> dict:
                """name -> raw value from the request's query string."""
                params: dict = {}
                for part in self.path.partition("?")[2].split("&"):
                    key, _, value = part.partition("=")
                    params[key] = value
                return params

            def _send_plain(self, code: int, body: bytes,
                            headers: dict | None = None) -> None:
                self.send_response(code)
                content_type = "text/plain"
                for key, value in (headers or {}).items():
                    if key.lower() == "content-type":
                        content_type = value
                        continue
                    self.send_header(key, value)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:
                path = self.path.split("?", 1)[0]
                if outer._auth is not None and not self._authorized():
                    self._send_plain(
                        401, b"unauthorized\n",
                        {"WWW-Authenticate": 'Basic realm="kube-tpu-stats"'})
                    return
                if path != "/ingest/delta" or outer._ingest is None:
                    self._send_plain(404, b"not found\n")
                    return
                # Content-Length fence BEFORE any body read: cap the
                # COMPRESSED read; the decoder separately bounds the
                # decompressed size (delta.MAX_FRAME_BYTES). Absent,
                # garbage or oversized answers without touching the
                # socket again — the frame is never buffered.
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    length = -1
                if length <= 0 or length > 64 * 1024 * 1024:
                    self._send_plain(
                        413, b"delta frame missing or oversized\n")
                    return
                # Body-level slow-loris fence: the read deadline bounds
                # how long a declared-but-dribbled body can hold this
                # handler thread. 408 + connection close — a loris gets
                # no second request on the wedged socket.
                previous_timeout = self.connection.gettimeout()
                self.connection.settimeout(outer._ingest_read_deadline)
                try:
                    wire = self.rfile.read(length)
                except (socket.timeout, TimeoutError):
                    self.close_connection = True
                    self._send_plain(
                        408, b"request body read timed out\n")
                    return
                finally:
                    self.connection.settimeout(previous_timeout)
                if len(wire) < length:
                    # Short read (peer closed mid-body): not a frame.
                    self._send_plain(400, b"truncated request body\n")
                    return
                try:
                    code, body, headers = outer._ingest(
                        wire, peer=self.client_address[0])
                except Exception:  # noqa: BLE001 - a frame must not
                    # kill the connection thread with a stack trace as
                    # the only evidence; the publisher sees a 500 and
                    # resyncs.
                    log.exception("delta ingest crashed")
                    code, body, headers = 500, b"ingest error\n", {}
                self._send_plain(code, body, headers or None)

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                encoding = ""
                if (outer._auth is not None
                        and path not in ("/healthz", "/readyz")
                        and not self._authorized()):
                    self._send_plain(
                        401, b"unauthorized\n",
                        {"WWW-Authenticate": 'Basic realm="kube-tpu-stats"'})
                    return
                if path == "/metrics":
                    # Content negotiation: Prometheus asks for
                    # OpenMetrics with an explicit Accept; default
                    # stays text 0.0.4.
                    accept = self.headers.get("Accept", "")
                    use_om = "application/openmetrics-text" in accept
                    gz_wanted = _gzip_accepted(
                        self.headers.get("Accept-Encoding", ""))
                    # Conditional scrape: the ETag names
                    # (boot, generation, shape), so If-None-Match on an
                    # unchanged generation answers 304 BEFORE the
                    # scrape-slot acquire — zero render, zero gzip, zero
                    # body, and it can't be starved by the storm guard
                    # it relieves. A publish racing this check just
                    # misses (full response with the new ETag).
                    inm = self.headers.get("If-None-Match", "")
                    boot = getattr(outer._registry, "boot_id", "")
                    if inm and boot:
                        etag = _metrics_etag(
                            boot, outer._registry.generation, use_om,
                            gz_wanted)
                        if etag_match(inm, etag):
                            if outer._render_stats is not None:
                                outer._render_stats.observe_not_modified(
                                    "/metrics")
                            self._send_plain(
                                304, b"",
                                {"ETag": etag, "Vary": "Accept-Encoding"})
                            return
                    slots = outer._scrape_slots
                    if slots is not None and not slots.acquire(blocking=False):
                        if outer._render_stats is not None:
                            outer._render_stats.reject()
                        self._send_plain(503, b"too many concurrent scrapes\n",
                                         {"Retry-After": "1"})
                        return
                    try:
                        render_start = time.monotonic()
                        # Memoized per generation (Registry.rendered): N
                        # concurrent scrapers between publishes cost one
                        # render+compress, and the bytes are identical to
                        # an uncached Snapshot.render().
                        body, cache_hit, body_gen = (
                            outer._registry.rendered_versioned(
                                openmetrics=use_om))
                        if len(body) >= outer.GZIP_MIN_BYTES and gz_wanted:
                            # Level 3, not 6: measured on a 32-chip 161 KB
                            # exposition, 0.4 ms vs 1.1 ms for only ~1 KB
                            # more wire (10.0 vs 8.9 KB) — compression
                            # latency sits on the north-star scrape path,
                            # the bytes don't.
                            body, cache_hit, body_gen = (
                                outer._registry.rendered_versioned(
                                    openmetrics=use_om, gzip_level=3))
                            encoding = "gzip"
                        if outer._render_stats is not None:
                            # Render + gzip, post-compression size: the
                            # cost a scrape actually pays and the bytes
                            # it ships.
                            outer._render_stats.observe(
                                "http", time.monotonic() - render_start,
                                len(body))
                            outer._render_stats.observe_cache(cache_hit)
                    finally:
                        if slots is not None:
                            slots.release()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        OPENMETRICS_CONTENT_TYPE if use_om else CONTENT_TYPE,
                    )
                    self.send_header("Vary", "Accept-Encoding")
                    if boot:
                        # The generation rendered_versioned returned IS
                        # the generation of these bytes (coherent read
                        # under the publish lock), so this ETag can
                        # never name a body it doesn't match.
                        self.send_header("ETag", _metrics_etag(
                            boot, body_gen, use_om, gz_wanted))
                    if encoding:
                        self.send_header("Content-Encoding", encoding)
                elif path == "/healthz":
                    max_age = outer._healthz_max_age
                    snapshot = outer._registry.snapshot()
                    stale = (
                        max_age > 0
                        and time.time() - snapshot.timestamp > max_age
                    )
                    if stale:
                        if snapshot.timestamp == 0:
                            verdict = "stale: no snapshot published yet\n"
                        else:
                            age = time.time() - snapshot.timestamp
                            verdict = f"stale: no poll for {age:.1f}s\n"
                        self.send_response(503)
                    else:
                        verdict = "ok\n"
                        self.send_response(200)
                    if outer._health_provider is not None:
                        try:
                            rows = list(outer._health_provider())
                        except Exception as exc:  # noqa: BLE001 - probe-safe
                            rows = [("health-provider", "stale",
                                     f"crashed: {exc}")]
                        for name, state, reason in rows:
                            verdict += f"component={name} state={state}"
                            if reason:
                                verdict += f" reason={reason}"
                            verdict += "\n"
                    body = verdict.encode()
                    self.send_header("Content-Type", "text/plain")
                elif path == "/readyz":
                    # Readiness = at least one snapshot has been published
                    # (liveness/staleness is /healthz's job), unless the
                    # owner installed a stricter ready_check.
                    if outer._ready_check is not None:
                        try:
                            ok, reason = outer._ready_check()
                        except Exception as exc:  # noqa: BLE001 - probe-safe
                            ok, reason = False, f"ready_check: {exc}"
                    else:
                        ok = outer._registry.snapshot().timestamp > 0
                        reason = ("ready" if ok
                                  else "no snapshot published yet")
                    if ok:
                        body = b"ready\n"
                        self.send_response(200)
                    else:
                        body = f"{reason}\n".encode()
                        self.send_response(503)
                    self.send_header("Content-Type", "text/plain")
                elif path == "/debug/profile":
                    # Statistical profile over a bounded window, as
                    # folded stacks (profiler.py).
                    from . import profiler

                    seconds = 5.0
                    try:
                        seconds = float(self._query().get("seconds", ""))
                    except ValueError:
                        pass
                    # Comparison-based clamp: min/max pass NaN through,
                    # and a NaN deadline would return an empty profile.
                    if not seconds >= 0.1:
                        seconds = 0.1
                    if seconds > 30.0:
                        seconds = 30.0
                    if not outer._profile_lock.acquire(blocking=False):
                        self._send_plain(409,
                                         b"a profile is already running\n")
                        return
                    try:
                        body = profiler.render_folded(
                            profiler.sample_stacks(seconds)).encode()
                    finally:
                        outer._profile_lock.release()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                elif path in ("/debug/ticks", "/debug/trace",
                              "/debug/events") and outer._trace is not None:
                    # Flight recorder: per-phase summaries + slowest-tick
                    # table, Chrome trace-event JSON of the recorded
                    # ticks, and the event journal. The read side takes
                    # snapshots of the ring and journal under the
                    # cold-path lock; it never blocks a tick's spans.
                    params = self._query()
                    if path == "/debug/ticks":
                        payload = outer._trace.ticks_summary()
                        # The render pre-warmer's cumulative wait on the
                        # publish lock, beside the slow-tick table.
                        payload.setdefault("meta", {})[
                            "render_prewarm_wait_seconds_total"] = round(
                            getattr(outer._registry,
                                    "render_wait_seconds", 0.0), 6)
                    elif path == "/debug/trace":
                        try:
                            last = int(params.get("last", "0") or 0)
                        except ValueError:
                            last = 0
                        payload = outer._trace.chrome_trace(last or None)
                    else:
                        try:
                            since = int(params.get("since", "0") or 0)
                        except ValueError:
                            since = 0
                        payload = outer._trace.events(since)
                    body = (json.dumps(payload, sort_keys=True)
                            + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/burst" and outer._burst is not None:
                    # Burst-sampler control + status (burstsampler.py):
                    # ?arm=<seconds> opens a demand window, ?disarm=1
                    # closes it, bare GET reads state. A GET with side
                    # effects is deliberate here — the action is bounded
                    # (auto-disarms after the hold window) and auth-gated
                    # like every non-probe path.
                    params = self._query()
                    verdict = {}
                    if "arm" in params:
                        try:
                            seconds = float(params.get("arm") or 0.0)
                        except ValueError:
                            seconds = 0.0
                        verdict["armed_for_s"] = outer._burst.arm(
                            seconds if seconds > 0 else None)
                    elif "disarm" in params:
                        outer._burst.disarm()
                        verdict["disarmed"] = True
                    payload = outer._burst.status()
                    payload.update(verdict)
                    body = (json.dumps(payload, sort_keys=True)
                            + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/energy" and outer._energy is not None:
                    # Governance digest (energy.py): per-pod joules +
                    # coverage, HMAC-signed when an audit key is
                    # configured; `doctor --energy` verifies it.
                    body = (json.dumps(outer._energy.digest(),
                                       sort_keys=True) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/stores" and outer._stores is not None:
                    # Every store's durability state machine + the thread
                    # restart/storm report, behind the same auth gate as
                    # every non-probe path.
                    try:
                        payload = outer._stores()
                    except Exception as exc:  # noqa: BLE001 - a status
                        # walk must not 500 the whole debug surface.
                        payload = {"enabled": False, "error": str(exc)}
                    body = (json.dumps(payload, sort_keys=True)
                            + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/host" and outer._host is not None:
                    # Host-signals snapshot (hoststats.py), behind the
                    # same auth gate as every non-probe path. A disabled
                    # collector answers enabled:false rather than 404 so
                    # a fetch diagnoses config, not absence.
                    body = (json.dumps(outer._host.debug_payload(),
                                       sort_keys=True) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/egress" and outer._egress is not None:
                    # Egress durability: the spill queue's and durable
                    # remote-write shards' backlog/lag/loss accounting,
                    # behind the same auth gate as every non-probe path.
                    # A provider with nothing configured answers
                    # enabled:false so a fetch diagnoses config, not
                    # absence.
                    try:
                        payload = outer._egress()
                    except Exception as exc:  # noqa: BLE001 - a status
                        # walk must not 500 the whole debug surface.
                        payload = {"enabled": False, "error": str(exc)}
                    body = (json.dumps(payload, sort_keys=True)
                            + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/skew" and outer._skew is not None:
                    # Version-skew picture: this process's build +
                    # wire-protocol range, the publisher's negotiation
                    # state, and any quarantined persisted formats — the
                    # payload doctor --skew reads.
                    try:
                        payload = outer._skew()
                    except Exception as exc:  # noqa: BLE001 - a status
                        # walk must not 500 the whole debug surface.
                        payload = {"error": str(exc)}
                    body = (json.dumps(payload, sort_keys=True)
                            + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif (path == "/debug/cardinality"
                        and outer._cardinality is not None):
                    # Cardinality admission: the series ledger vs its
                    # limits + top offenders — the payload doctor
                    # --cardinality reads.
                    try:
                        payload = outer._cardinality()
                    except Exception as exc:  # noqa: BLE001 - a status
                        # walk must not 500 the whole debug surface.
                        payload = {"enabled": False, "error": str(exc)}
                    body = (json.dumps(payload, sort_keys=True)
                            + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif (path == "/debug/efficiency"
                        and outer._efficiency is not None):
                    # Fleet efficiency attestation: the HMAC-signed
                    # energy/waste rollup — leaves' energy digests
                    # folded with the hub's waste ledger — behind the
                    # same auth gate as every non-probe path. doctor
                    # --efficiency verifies the signature.
                    try:
                        payload = outer._efficiency()
                    except Exception as exc:  # noqa: BLE001 - a status
                        # walk must not 500 the whole debug surface.
                        payload = {"enabled": False, "error": str(exc)}
                    body = (json.dumps(payload, sort_keys=True)
                            + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/fleet" and outer._fleet is not None:
                    # Fleet lens rollup (fleetlens.py): per-target
                    # baselines/anomalies, SLO burn windows, slow-node
                    # attribution — the payload doctor --fleet reads.
                    body = (json.dumps(outer._fleet.rollup(),
                                       sort_keys=True) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif path == "/debug/threads":
                    # Live stack dump of every thread: enough to diagnose
                    # a wedged sampler or a stuck attribution refresh from
                    # outside the pod.
                    import traceback

                    frames = sys._current_frames()
                    names = {t.ident: t.name for t in threading.enumerate()}
                    parts = []
                    for ident, frame in frames.items():
                        parts.append(f"--- thread {names.get(ident, ident)}\n")
                        parts.extend(traceback.format_stack(frame))
                    body = "".join(parts).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                elif path == "/query" and outer._history is not None:
                    # The store admits, validates, decides the 304 and
                    # keeps the rendered bodies; this only writes what
                    # it returns.
                    try:
                        code, qbody, qheaders = outer._history.handle_query(
                            self._query(), self.client_address[0],
                            _gzip_accepted(
                                self.headers.get("Accept-Encoding", "")),
                            self.headers.get("If-None-Match", ""))
                    except Exception:  # noqa: BLE001 - a failed query
                        # answers 500 and leaves its stack in the log.
                        log.exception("/query crashed")
                        code, qbody, qheaders = 500, b"query error\n", {}
                    if code == 304 and outer._render_stats is not None:
                        outer._render_stats.observe_not_modified("/query")
                    self._send_plain(code, qbody, qheaders or None)
                    return
                elif path == "/":
                    # Every endpoint this server serves: the landing page
                    # is the endpoint inventory (the recorder's appear
                    # only when one is wired).
                    links = ["/metrics", "/healthz", "/readyz",
                             "/debug/threads", "/debug/profile?seconds=5"]
                    if outer._trace is not None:
                        links += ["/debug/ticks", "/debug/trace?last=20",
                                  "/debug/events"]
                    if outer._fleet is not None:
                        links += ["/debug/fleet"]
                    if outer._efficiency is not None:
                        links += ["/debug/efficiency"]
                    if outer._burst is not None:
                        links += ["/debug/burst"]
                    if outer._energy is not None:
                        links += ["/debug/energy"]
                    if outer._stores is not None:
                        links += ["/debug/stores"]
                    if outer._host is not None:
                        links += ["/debug/host"]
                    if outer._egress is not None:
                        links += ["/debug/egress"]
                    if outer._skew is not None:
                        links += ["/debug/skew"]
                    if outer._cardinality is not None:
                        links += ["/debug/cardinality"]
                    if outer._history is not None:
                        links += ["/query?family=slice_chips&window=1h"]
                    body = ("<html><body>kube-tpu-stats " + " ".join(
                        f'<a href="{link}">{link.partition("?")[0]}</a>'
                        for link in links) + "</body></html>").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        # Validate the TLS config BEFORE binding: raising after the
        # server is built would leak the bound listener socket.
        if tls_client_ca_file and not tls_cert_file:
            raise ValueError(
                "tls_client_ca_file (mTLS) requires tls_cert_file/"
                "tls_key_file — client certs only exist inside TLS"
            )
        if (tls_cert_file or tls_key_file) and not (
                tls_cert_file and tls_key_file):
            raise ValueError("TLS needs both tls_cert_file and tls_key_file")
        # Fenced accept loop: fd exhaustion sheds with backoff + journal
        # instead of spinning the accept thread hot.
        self._server = _FencedHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._fence = _AcceptFence()
        self._server.fence = self._fence
        if tls_cert_file:
            import ssl

            try:
                # Hardened stdlib defaults: TLS >= 1.2, vetted ciphers.
                context = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
                context.load_cert_chain(tls_cert_file, tls_key_file)
                if tls_client_ca_file:
                    # mTLS: every connection must present a cert chaining
                    # to this CA; the handshake itself rejects strangers.
                    context.verify_mode = ssl.CERT_REQUIRED
                    context.load_verify_locations(cafile=tls_client_ca_file)
                # Defer the handshake to the per-connection handler
                # thread (its first read performs it): with the handshake
                # on accept, one client that opens a TCP connection and
                # sends nothing would wedge the single accept loop, and
                # /healthz with it. A failed handshake then ends that
                # handler's connection only. The wrapped listener keeps
                # _FencedHTTPServer.get_request, so the accept fence
                # still sees every accept.
                self._server.socket = context.wrap_socket(
                    self._server.socket, server_side=True,
                    do_handshake_on_connect=False,
                )
            except Exception:
                # An unreadable cert/key/CA must not leak the listener
                # already bound above.
                self._server.server_close()
                raise
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """Actual bound port (useful when constructed with port 0 in tests)."""
        return self._server.server_address[1]

    @property
    def prewarm_enabled(self) -> bool:
        """Whether this server runs a render pre-warmer thread (the
        supervisor registers its row only when one exists)."""
        return self._prewarm

    def accept_fence_status(self) -> dict:
        """The accept loop's fd-exhaustion fence state, for
        /debug/stores — per server, so two servers in one process each
        report their own episode."""
        return self._fence.status()

    def _warm_loop(self) -> None:
        """Fill the per-generation render cache right behind each
        publish: one render + one gzip per generation, charged to this
        thread instead of the first scrape. Failures are contained — a
        render bug must surface on the scrape path (with a client
        attached), not kill the warmer silently."""
        generation = -1
        while not self._warm_stop.is_set():
            current = self._registry.generation
            if current != generation:
                generation = current
                try:
                    self._registry.rendered()
                    self._registry.rendered(gzip_level=3)
                except Exception:  # noqa: BLE001
                    log.debug("render prewarm failed", exc_info=True)
            self._registry.wait_for_publish(generation, timeout=0.5)

    def start(self) -> None:
        self._thread = spawn(self._server.serve_forever,
                             name="metrics-http")
        self._thread.start()
        if self._prewarm:
            self.respawn_warm()

    def warm_thread_alive(self) -> bool:
        """Liveness probe for the supervisor's render-warmer row; False
        when pre-warming is off."""
        return (self._warm_thread is not None
                and self._warm_thread.is_alive())

    def respawn_warm(self) -> None:
        """Crash-only restart for the render pre-warmer: a fresh thread
        over the same registry (the per-generation cache IS the retained
        state). Doubles as the initial start."""
        if (not self._prewarm or self._warm_stop.is_set()
                or self.warm_thread_alive()):
            return
        self._warm_thread = spawn(self._warm_loop, name="render-warmer")
        self._warm_thread.start()

    def stop(self) -> None:
        self._warm_stop.set()
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._warm_thread:
            self._warm_thread.join(timeout=5)


class PushgatewayPusher(PublishFollower):
    """Pushes each published snapshot to a Prometheus Pushgateway
    (PUT <url>/metrics/job/<job>/instance/<instance>) — exposition mode #3
    for nodes/jobs that Prometheus can't scrape directly. Push failures
    are logged and retried with the scaffold's capped backoff (never
    fatal)."""

    def __init__(self, registry: Registry, url: str, job: str = "kube-tpu-stats",
                 instance: str = "", min_interval: float = 1.0,
                 render_stats: RenderStats | None = None) -> None:
        import socket
        import urllib.parse

        super().__init__(registry, min_interval, thread_name="pushgateway")
        self._render_stats = render_stats
        instance = instance or socket.gethostname()
        self._target = (
            url.rstrip("/")
            + "/metrics/job/" + urllib.parse.quote(job, safe="")
            + "/instance/" + urllib.parse.quote(instance, safe="")
        )

    def push_once(self) -> None:
        import urllib.request

        render_start = time.monotonic()
        # Shares the per-generation render cache with the scrape path:
        # a scrape and a push of the same publish serialize once.
        body, cache_hit = self._registry.rendered()
        if self._render_stats is not None:
            self._render_stats.observe(
                "pushgateway", time.monotonic() - render_start, len(body))
            self._render_stats.observe_cache(cache_hit)
        request = urllib.request.Request(
            self._target, data=body, method="PUT",
            headers={"Content-Type": CONTENT_TYPE},
        )
        try:
            # No-redirect opener: a 302 must surface as a failure, not
            # degrade the PUT into a body-less GET (see workers.push_opener).
            with push_opener().open(request, timeout=10):
                pass
            self.consecutive_failures = 0
            self.pushes_total += 1
        except Exception as exc:
            self.consecutive_failures += 1
            self.failures_total += 1
            log.warning("pushgateway push failed (%d consecutive): %s",
                        self.consecutive_failures, exc)




class TextfileWriter:
    """Writes the snapshot to `<dir>/accelerator.prom` atomically.

    node_exporter's textfile collector reads *.prom files; a partially
    written file would be scraped as corrupt, hence tmp + os.replace (atomic
    on POSIX within one filesystem).
    """

    FILENAME = "accelerator.prom"

    def __init__(self, registry: Registry, directory: str | os.PathLike,
                 render_stats: RenderStats | None = None) -> None:
        self._registry = registry
        self._render_stats = render_stats
        self._dir = Path(directory)
        self._path = self._dir / self.FILENAME
        self._tmp = self._dir / (self.FILENAME + ".tmp")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def write_once(self) -> None:
        self._dir.mkdir(parents=True, exist_ok=True)
        render_start = time.monotonic()
        # Rendered bytes come from the per-generation cache (already
        # encoded — the rendered-bytes counter reports true bytes, comm
        # labels can be multi-byte UTF-8): when an HTTP scrape of the
        # same publish got there first, the write costs no render at all.
        data, cache_hit = self._registry.rendered()
        if self._render_stats is not None:
            self._render_stats.observe(
                "textfile", time.monotonic() - render_start, len(data))
            self._render_stats.observe_cache(cache_hit)
        self._tmp.write_bytes(data)
        os.replace(self._tmp, self._path)

    def run_forever(self) -> None:
        generation = self._registry.generation
        while not self._stop.is_set():
            if self._registry.wait_for_publish(generation, timeout=0.5):
                generation = self._registry.generation
                try:
                    self.write_once()
                except OSError as exc:
                    log.warning("textfile write failed: %s", exc)

    def start(self) -> None:
        self._thread = spawn(self.run_forever, name="textfile-writer")
        self._thread.start()

    def thread_alive(self) -> bool:
        """Liveness probe for the supervisor; start() doubles as the
        crash-only restart."""
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
