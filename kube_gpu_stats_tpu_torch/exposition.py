"""Exposition layer: the HTTP scrape endpoint and the textfile writer.

- HTTP ``GET /metrics`` — Prometheus scrape endpoint (text 0.0.4, or
  OpenMetrics on request; gzip when accepted; ``ETag``/``If-None-Match``).
  Renders the last published snapshot; never touches collector state, so
  a scrape storm cannot perturb the poll budget. ``/healthz`` fails when
  no snapshot was published for ``healthz_max_age`` seconds; ``/readyz``
  passes once one was.
- node_exporter textfile — ``<dir>/accelerator.prom`` rewritten atomically
  (tmp + rename) after each poll tick.

The port's copy of the reference's exposition layer without TLS, basic
auth, the ``/debug/*`` endpoints, delta ingest, ``/query`` and the
Pushgateway sender.
"""

from __future__ import annotations

import errno
import http.server
import logging
import os
import threading
import time
from pathlib import Path

from . import schema
from .history import etag_match
from .registry import HistogramState, Registry
from .resilience import BackoffPolicy
from .supervisor import spawn
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
        self.in_episode = False

    def faulted(self, exc: OSError) -> None:
        self.in_episode = True
        self._health.record_fault(exc)
        time.sleep(self._backoff.next_delay())

    def accepted(self) -> None:
        if not self.in_episode:
            return
        self.in_episode = False
        self._backoff.reset()
        self._health.ok()


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


class MetricsServer:
    """Threaded HTTP server for /metrics, /healthz, /readyz and /.

    ``healthz_max_age`` (seconds) makes /healthz return 503 when no snapshot
    has been published for that long — so a dead poll loop fails the
    liveness probe instead of serving stale data forever. 0 disables the
    staleness check (bare-registry uses in tests/tools).

    /metrics responses are gzip-compressed when the scraper advertises
    ``Accept-Encoding: gzip`` (Prometheus always does).
    """

    # Bodies below this size aren't worth the gzip header overhead.
    GZIP_MIN_BYTES = 256
    # Renders in flight at once; more scrapes get 503 (Retry-After: 1).
    MAX_CONCURRENT_SCRAPES = 16

    def __init__(self, registry: Registry, host: str = "0.0.0.0",
                 port: int = 9400, healthz_max_age: float = 0.0,
                 render_stats: RenderStats | None = None):
        self._registry = registry
        self._healthz_max_age = healthz_max_age
        self._render_stats = render_stats
        # Render pre-warmer: a publish-following thread fills the
        # per-generation render cache (text + gzip) the moment a snapshot
        # lands, so a scrape serves pre-rendered, pre-gzipped bytes
        # instead of paying the render inline.
        self._warm_stop = threading.Event()
        self._warm_thread: threading.Thread | None = None
        # Scrape-storm guard (exporter-toolkit web.max-requests analog):
        # ThreadingHTTPServer spawns one thread per connection with no
        # ceiling, so N misbehaving scrapers = N concurrent renders.
        # Renders beyond the cap get an immediate 503 (Retry-After: 1)
        # instead of queueing; /healthz and /readyz stay exempt so
        # kubelet probes always land.
        self._scrape_slots = threading.BoundedSemaphore(
            self.MAX_CONCURRENT_SCRAPES)

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

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                encoding = ""
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
                    if not slots.acquire(blocking=False):
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
                    body = verdict.encode()
                    self.send_header("Content-Type", "text/plain")
                elif path == "/readyz":
                    # Readiness = at least one snapshot has been published
                    # (liveness/staleness is /healthz's job).
                    ok = outer._registry.snapshot().timestamp > 0
                    reason = "ready" if ok else "no snapshot published yet"
                    if ok:
                        body = b"ready\n"
                        self.send_response(200)
                    else:
                        body = f"{reason}\n".encode()
                        self.send_response(503)
                    self.send_header("Content-Type", "text/plain")
                elif path == "/":
                    links = ["/metrics", "/healthz", "/readyz"]
                    body = ("<html><body>kube-tpu-stats " + " ".join(
                        f'<a href="{link}">{link}</a>'
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

        # Fenced accept loop: fd exhaustion sheds with backoff + journal
        # instead of spinning the accept thread hot.
        self._server = _FencedHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._fence = _AcceptFence()
        self._server.fence = self._fence
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """Actual bound port (useful when constructed with port 0 in tests)."""
        return self._server.server_address[1]

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

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
