"""Prometheus remote_write client (exposition mode #4).

The port's copy of the reference's client, whose wire bodies and WAL
format it keeps byte for byte: a shard WAL journalled by one package
drains in the other.

Ships the latest published snapshot (at most once per configured
interval; superseded ticks are deferred-then-dropped) to a remote-write
1.0 receiver
(Mimir, Thanos Receive, VictoriaMetrics, Grafana Cloud, GMP) — no
scraping Prometheus needed, which on ephemeral GPU nodes is often the
difference between having telemetry and not. Spec:
https://prometheus.io/docs/specs/remote_write_spec/

Semantics per the spec: snappy-compressed protobuf WriteRequest, samples
in-order per series, retry on 5xx/transport errors (the next publish is
the retry — the push cadence stretches under consecutive failures via
the shared resilience.BackoffPolicy in the PublishFollower scaffold, so
a down receiver is never hammered), never retry 4xx (drop and
log: the payload is wrong, not the network). The exporter's gauges are
trivially in-order because each push carries exactly one timestamp per
series (the tick's publish time).

Remote-write **2.0** (``io.prometheus.write.v2.Request``, proto/prompb2)
is supported alongside 1.0: symbol-table interning sends every label
string once per request instead of once per series, and each series
carries typed metadata (gauge/counter/histogram + help). Per the 2.0
spec, a 415 from the receiver downgrades the sender to 1.0 for the rest
of the process lifetime.

**Durable sharded mode.** With ``wal_dir`` set the exporter
stops being best-effort: series hash by identity to ``shards`` send
shards, each with its own write-ahead segment ring (the shared
:mod:`wal` SegmentRing — fsynced records, CRC framing, torn tails
truncated on recovery), its own retry/backoff state, and its own
bounded parked-poison ring. A snapshot is first journaled to every
shard's WAL, then the shards drain oldest-first:

- **retryable** failures (5xx, 429, 3xx, transport errors) leave the
  request at the head; the shard backs off (honoring ``Retry-After``
  when the receiver sent one) and the WAL absorbs the backlog — a
  receiver outage becomes late delivery, not a hole in the TSDB.
- **poison** 4xx responses park the request in the shard's parked ring
  (counted, journaled) and the drain continues — one bad payload must
  not wedge the queue forever.
- a WAL past its byte bound evicts the OLDEST segment whole, counted in
  ``kts_remote_write_dropped_total`` and journaled — the loss the spool
  could not absorb is an audited number.
- each delivered request self-meters send-time minus sample-time as
  ``kts_remote_write_lag_seconds`` — how stale the receiver's view is.

Per-series in-order delivery (the spec's one hard ordering rule) holds
because a series' identity always hashes to the same shard and each
shard drains strictly oldest-first.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import zlib

from . import schema, snappy
from .proto import prompb, prompb2
from .registry import Registry, Snapshot, format_value
from .supervisor import spawn
from .validate import classify_push_status, retry_after_seconds
from .wal import SegmentRing
from .workers import PublishFollower, push_opener

log = logging.getLogger(__name__)

HEADERS = {
    "Content-Type": "application/x-protobuf",
    "Content-Encoding": "snappy",
    "X-Prometheus-Remote-Write-Version": "0.1.0",
    "User-Agent": "kube-tpu-stats",
}

HEADERS_V2 = {
    "Content-Type": "application/x-protobuf;proto=io.prometheus.write.v2.Request",
    "Content-Encoding": "snappy",
    "X-Prometheus-Remote-Write-Version": "2.0.0",
    "User-Agent": "kube-tpu-stats",
}

_V2_TYPES = {
    schema.MetricType.GAUGE: prompb2.TYPE_GAUGE,
    schema.MetricType.COUNTER: prompb2.TYPE_COUNTER,
    schema.MetricType.HISTOGRAM: prompb2.TYPE_HISTOGRAM,
}


def build_headers(bearer_token_file: str = "",
                  protocol: str = "1.0") -> dict[str, str] | None:
    """Remote-write request headers, or None when the configured token is
    unreadable — pushing unauthenticated would turn a transient token
    rotation into a permanent-looking 401 sample drop. Shared by the
    sender and doctor's receiver probe."""
    headers = dict(HEADERS_V2 if protocol == "2.0" else HEADERS)
    if bearer_token_file:
        try:
            # Re-read per push: mounted tokens rotate (k8s projected
            # service-account tokens do, hourly).
            with open(bearer_token_file) as f:
                headers["Authorization"] = "Bearer " + f.read().strip()
        except OSError as exc:
            log.warning("remote-write token unreadable (will retry): %s", exc)
            return None
    return headers


def _snapshot_series(snapshot: Snapshot, job: str, instance: str,
                     extra_labels=()):
    """Yield every remote-written sample as (spec, name, labels, value,
    ts_ms) — the one walk both wire protocols consume, so histogram
    expansion can never drift between 1.0 and 2.0. Each sample is stamped
    with the snapshot's publish time and carries the target-identity
    labels (job/instance, plus any operator extra labels — the
    external_labels analog for a push path with no Prometheus to attach
    identity) the spec expects the sender to provide."""
    ts = int(snapshot.timestamp * 1000.0)
    identity = [("job", job), ("instance", instance), *extra_labels]
    for s in snapshot.series:
        yield s.spec, s.spec.name, identity + list(s.labels), s.value, ts
    for hist in snapshot.histograms:
        # hist.labels dimension the family (e.g. scrape duration per
        # output); they ride every expanded series like scrape rendering.
        spec = hist.spec
        labels = identity + list(hist.labels)
        bucket = spec.name + "_bucket"
        cumulative = 0
        for i, bound in enumerate(hist.buckets):
            cumulative += hist.counts[i]
            # format_value, not repr: the le string must match the scrape
            # path's rendering or receivers see two distinct bucket series.
            yield (spec, bucket, labels + [("le", format_value(bound))],
                   float(cumulative), ts)
        yield spec, bucket, labels + [("le", "+Inf")], float(hist.total), ts
        yield spec, spec.name + "_sum", labels, hist.sum, ts
        yield spec, spec.name + "_count", labels, float(hist.total), ts


def build_write_request(snapshot: Snapshot, job: str, instance: str,
                        extra_labels=()) -> bytes:
    """Uncompressed 1.0 WriteRequest for one snapshot."""
    return prompb.encode_write_request([
        prompb.encode_series(name, labels, value, ts)
        for _, name, labels, value, ts
        in _snapshot_series(snapshot, job, instance, extra_labels)
    ])


def build_write_request_v2(snapshot: Snapshot, job: str,
                           instance: str, extra_labels=()) -> bytes:
    """Uncompressed 2.0 Request: same series set as 1.0 plus per-series
    typed metadata, with every string interned once per request. Expanded
    histogram series inherit TYPE_HISTOGRAM from their spec."""
    table = prompb2.SymbolTable()
    series = [
        prompb2.encode_series(
            table, name, labels, value, ts,
            _V2_TYPES.get(spec.type, prompb2.TYPE_UNSPECIFIED), spec.help)
        for spec, name, labels, value, ts
        in _snapshot_series(snapshot, job, instance, extra_labels)
    ]
    return prompb2.encode_request(table, series)


def shard_of(name: str, labels, shards: int) -> int:
    """Stable series-identity -> shard routing: a series must always
    ride the same shard or the spec's per-series in-order rule breaks
    across a resharding-free process lifetime. crc32, not hash()
    (PYTHONHASHSEED-stable, debuggable from logs)."""
    if shards <= 1:
        return 0
    key = name + "\x00" + "\x00".join(f"{k}={v}" for k, v in labels)
    return zlib.crc32(key.encode()) % shards


def encode_shard_request(samples, protocol: str) -> bytes:
    """Uncompressed WriteRequest/Request for one shard's sample list
    (the (spec, name, labels, value, ts) tuples _snapshot_series
    yields) — the same encoders the whole-snapshot builders use, so a
    1-shard durable request is byte-identical to the legacy one."""
    if protocol == "2.0":
        table = prompb2.SymbolTable()
        series = [
            prompb2.encode_series(
                table, name, labels, value, ts,
                _V2_TYPES.get(spec.type, prompb2.TYPE_UNSPECIFIED),
                spec.help)
            for spec, name, labels, value, ts in samples
        ]
        return prompb2.encode_request(table, series)
    return prompb.encode_write_request([
        prompb.encode_series(name, labels, value, ts)
        for _spec, name, labels, value, ts in samples
    ])


# WAL record payload: 1 protocol byte (1 | 2) + the snappy-compressed
# request body. The protocol rides the record because a 415-downgrade
# can land mid-backlog: every queued request knows which wire format
# its bytes already are.
_PROTO_BYTE = {"1.0": b"\x01", "2.0": b"\x02"}

# WAL record payload format, stamped into every segment's
# container header: v1 = one remote-write-protocol byte (_PROTO_BYTE)
# followed by the compressed WriteRequest body. A segment declaring a
# NEWER payload format at recovery (downgrade mid-rollout) is parked
# aside intact by the ring, never fed to this decoder.
RW_WAL_FORMAT_VERSION = 1

# The parked-poison ring's records are raw request payloads kept for
# post-mortem; same format lineage as the WAL records they came from.
RW_PARKED_FORMAT_VERSION = 1


class _Shard:
    """One send shard of the durable exporter: its own WAL ring,
    parked-poison ring, backoff state and lag meter. Pumped from the
    writer's push thread (or a short-lived per-shard drain thread when
    several shards have backlog) — never concurrently with itself."""

    # A shard whose receiver keeps failing backs off its probes up to
    # this many seconds (Retry-After can push past it; it is a floor
    # policy, not a silence cap — retry_after_seconds caps the header).
    BACKOFF_BASE = 1.0
    BACKOFF_CAP = 60.0

    def __init__(self, index: int, directory: str, *, max_bytes: int,
                 fsync: bool = True, tracer=None) -> None:
        self.index = index
        self.ring = SegmentRing(
            os.path.join(directory, f"shard-{index:02d}"),
            max_bytes=max_bytes, segment_bytes=min(1 << 20, max_bytes),
            prefix="rw", fsync=fsync, label=f"remote-write shard {index}",
            format_version=RW_WAL_FORMAT_VERSION)
        # Poison requests, kept (bounded, oldest evicted uncounted —
        # these are already counted as parked) for post-mortem: curl
        # the receiver with one by hand to see WHY it 400s.
        self.parked_ring = SegmentRing(
            os.path.join(directory, f"shard-{index:02d}", "parked"),
            max_bytes=4 << 20, segment_bytes=1 << 20,
            prefix="parked", fsync=False,
            label=f"remote-write shard {index} parked",
            format_version=RW_PARKED_FORMAT_VERSION)
        self._tracer = tracer
        self.parked_total = 0
        self.sent_total = 0
        self.lag_seconds = 0.0
        self.failures = 0       # consecutive, drives the probe backoff
        self.retry_at = 0.0     # monotonic gate on the next probe

    @property
    def dropped_total(self) -> int:
        return self.ring.evicted_records

    def enqueue(self, ts: float, protocol: str, body: bytes) -> None:
        dropped = self.ring.append(ts, _PROTO_BYTE[protocol] + body)
        if dropped and self._tracer is not None:
            self._tracer.event(
                "remote_write_drop",
                f"shard {self.index}: WAL over its byte bound; dropped "
                f"{dropped} oldest request(s) "
                f"(kts_remote_write_dropped_total {self.dropped_total})")

    def park(self, ts: float, payload: bytes, code: int) -> None:
        self.parked_ring.append(ts, payload)
        self.parked_total += 1
        log.warning("remote write rejected (HTTP %d): request parked "
                    "(shard %d, %d parked total) — the payload is "
                    "wrong, not the network", code, self.index,
                    self.parked_total)
        if self._tracer is not None:
            self._tracer.event(
                "remote_write_parked",
                f"shard {self.index}: receiver answered HTTP {code} "
                f"(poison); request parked for post-mortem")

    def note_failure(self, retry_after: float = 0.0) -> None:
        self.failures += 1
        delay = min(self.BACKOFF_CAP,
                    self.BACKOFF_BASE * (2.0 ** min(self.failures - 1, 10)))
        self.retry_at = time.monotonic() + max(delay, retry_after)

    def note_success(self, sample_ts: float) -> None:
        self.failures = 0
        self.retry_at = 0.0
        self.sent_total += 1
        self.lag_seconds = max(0.0, time.time() - sample_ts)

    def lag_now(self) -> float:
        """How stale the receiver's view of this shard is RIGHT NOW:
        with a backlog, the age of the oldest undelivered request (it
        grows through an outage, which is when the lag alert matters);
        drained, the send-minus-sample lag of the newest delivery. The
        delivered-only number would freeze at its last healthy value
        for the whole outage and RemoteWriteLagHigh would never fire."""
        oldest = self.ring.oldest_ts()
        if oldest is not None:
            return max(self.lag_seconds, time.time() - oldest)
        return self.lag_seconds

    def status(self) -> dict:
        ring = self.ring.status()
        return {
            "shard": self.index,
            "wal_records": ring["records"],
            "wal_bytes": ring["bytes"],
            "wal_max_bytes": ring["max_bytes"],
            "lag_seconds": round(self.lag_now(), 3),
            "sent_total": self.sent_total,
            "parked_total": self.parked_total,
            "dropped_total": self.dropped_total,
            "torn_total": self.ring.torn_records,
            # Future-format segments set aside intact at recovery
            # (version skew after a downgrade) — visible so
            # the lag they explain is diagnosable, and replayable by
            # moving the .skew file back under the writing build.
            "skew_segments_total": self.ring.skew_segments,
            "format_version": ring["format_version"],
            # Durability state machine: this shard's WAL
            # store health, for /debug/stores + doctor --stores.
            "health": ring["health"],
            "consecutive_failures": self.failures,
            "retry_in_seconds": round(
                max(0.0, self.retry_at - time.monotonic()), 3),
        }

    def close(self) -> None:
        self.ring.close()
        self.parked_ring.close()


class RemoteWriter(PublishFollower):
    """Publish-following push loop (PublishFollower scaffold, shared with
    PushgatewayPusher): waits for a new snapshot, rate-limits to
    ``min_interval`` with failure backoff, POSTs the compressed
    WriteRequest. Failures never propagate — the DaemonSet must outlive
    its receiver."""

    def __init__(self, registry: Registry, url: str, *,
                 job: str = "kube-tpu-stats", instance: str = "",
                 min_interval: float = 15.0,
                 bearer_token_file: str = "",
                 protocol: str = "1.0",
                 extra_labels=(),
                 render_stats=None,
                 shards: int = 1,
                 wal_dir: str = "",
                 wal_max_bytes: int = 64 * 1024 * 1024,
                 drain_max_per_push: int = 64,
                 wal_fsync: bool = True,
                 tracer=None) -> None:
        import socket

        if protocol not in ("1.0", "2.0"):
            raise ValueError(f"remote-write protocol {protocol!r} "
                             f"(use '1.0' or '2.0')")
        if shards < 1 or shards > 64:
            raise ValueError(f"remote-write shards must be 1..64 "
                             f"(got {shards})")
        super().__init__(registry, min_interval, thread_name="remote-write")
        self._url = url
        self._job = job
        self._instance = instance or socket.gethostname()
        self._bearer_token_file = bearer_token_file
        self._protocol = protocol
        self._extra_labels = tuple(extra_labels)
        self._render_stats = render_stats
        self._tracer = tracer
        # Durable sharded mode: wal_dir set => each shard
        # owns a write-ahead ring and push_once becomes journal-then-
        # drain. Empty wal_dir keeps the legacy best-effort contract
        # (superseded ticks deferred-then-dropped, failures drop the
        # snapshot) byte-for-byte.
        self._shards: list[_Shard] | None = None
        self._drain_max = max(1, drain_max_per_push)
        self._last_enqueued: float | None = None
        # Writer-level counters are bumped from per-shard pump threads
        # when several shards drain concurrently; a bare += would race.
        self._counter_lock = threading.Lock()
        if wal_dir:
            self._shards = [
                _Shard(index, wal_dir, max_bytes=wal_max_bytes,
                       fsync=wal_fsync, tracer=tracer)
                for index in range(shards)
            ]
            pending = sum(s.ring.records_pending() for s in self._shards)
            if pending:
                log.info("remote-write WAL: %d request(s) recovered from "
                         "disk across %d shard(s)", pending, shards)

    @property
    def protocol(self) -> str:
        return self._protocol

    def _headers(self) -> dict[str, str] | None:
        return build_headers(self._bearer_token_file, self._protocol)

    def push_once(self) -> None:
        if self._shards is not None:
            self._push_durable()
        else:
            self._push_legacy()

    # -- durable sharded path ------------------------------------------------

    def _push_durable(self) -> None:
        """Journal the snapshot to every shard's WAL, then drain each
        shard oldest-first (bounded per call so the push thread stays
        responsive; the next publish continues the drain). Failures
        never drop data here — the WAL holds it, bounded, accounted."""
        snapshot = self._registry.snapshot()
        if (snapshot.series or snapshot.histograms) and \
                snapshot.timestamp != self._last_enqueued:
            self._last_enqueued = snapshot.timestamp
            serialize_start = time.monotonic()
            shards = self._shards
            buckets: list[list] = [[] for _ in shards]
            for sample in _snapshot_series(snapshot, self._job,
                                           self._instance,
                                           self._extra_labels):
                buckets[shard_of(sample[1], sample[2],
                                 len(shards))].append(sample)
            nbytes = 0
            for shard, samples in zip(shards, buckets):
                if not samples:
                    continue
                body = snappy.compress(
                    encode_shard_request(samples, self._protocol))
                nbytes += len(body)
                shard.enqueue(snapshot.timestamp, self._protocol, body)
            if self._render_stats is not None and nbytes:
                self._render_stats.observe(
                    "remote_write", time.monotonic() - serialize_start,
                    nbytes)
        # Drain. One shard pumps inline; several with backlog pump on
        # short-lived threads so one slow receiver connection doesn't
        # serialize the others (each shard is single-pumper by
        # construction: only this thread spawns them, and join is
        # unconditional). ``abort`` carries THIS push thread's identity
        # into the pumps: if a supervisor respawn replaces the follower
        # while it is wedged here, the old generation's
        # pumps stop before their next peek/commit — two pumpers on one
        # shard WAL would race the cursor and skip records.
        me = threading.current_thread()

        def abort() -> bool:
            return self._thread is not None and self._thread is not me

        backlogged = [s for s in self._shards
                      if s.ring.records_pending()
                      and time.monotonic() >= s.retry_at]
        if len(backlogged) <= 1:
            for shard in backlogged:
                self._pump(shard, abort)
        else:
            threads = [spawn(self._pump, args=(shard, abort),
                             name=f"rw-shard-{shard.index}")
                       for shard in backlogged]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
        # In durable mode the follower keeps PUBLISH cadence — the WAL
        # is the retry buffer and each shard backs off its own probes
        # (retry_at); stretching the whole loop would also stretch the
        # journaling.
        self.consecutive_failures = 0
        for shard in self._shards:
            shard.ring.save_cursor()

    def _pump(self, shard: _Shard, abort=None) -> None:
        """Send up to drain_max_per_push requests from one shard's WAL
        head. Retry classification is the whole point: retryable leaves
        the record at the head and backs off; poison parks it and moves
        on; ok commits and meters the lag. ``abort`` (from the owning
        push thread) stops the pump before its next peek/commit when a
        respawn superseded that owner."""
        for _ in range(self._drain_max):
            if abort is not None and abort():
                return
            if self.heartbeat is not None:
                # Per-record beat: a deep multi-shard drain can hold
                # push_once well past the loop-level heartbeat window,
                # and honest slow progress must not read as a hang.
                self.heartbeat()
            if time.monotonic() < shard.retry_at:
                return
            record = shard.ring.peek()
            if record is None:
                return
            ts, payload = record
            protocol = "2.0" if payload[:1] == b"\x02" else "1.0"
            headers = build_headers(self._bearer_token_file, protocol)
            if headers is None:
                # Token unreadable: retryable (it rotates back), and
                # pushing unauthenticated would turn it into a
                # permanent-looking 401 parked request.
                with self._counter_lock:
                    self.failures_total += 1
                shard.note_failure()
                return
            code, response_headers = self._post_raw(payload[1:], headers)
            if abort is not None and abort():
                # The wedge was INSIDE the POST and a respawned push
                # thread owns this shard now: committing would advance
                # the cursor past a record the new pumper never saw.
                # The record stays at the head — at-least-once, and
                # same-timestamp re-delivery is idempotent receiver-side.
                return
            verdict = ("retryable" if code is None
                       else classify_push_status(code))
            if verdict == "ok":
                shard.ring.commit()
                shard.note_success(ts)
                with self._counter_lock:
                    self.pushes_total += 1
                continue
            if code == 415 and protocol == "2.0":
                # 2.0 spec: the receiver only speaks 1.0. Downgrade for
                # the process lifetime; THIS request's bytes are 2.0
                # and cannot be re-encoded, so park them (counted, kept
                # for post-mortem) instead of retrying forever.
                self._protocol = "1.0"
                log.warning("receiver rejected remote-write 2.0 "
                            "(HTTP 415); downgrading to 1.0")
                shard.park(ts, payload, code)
                shard.ring.commit()
                with self._counter_lock:
                    self.failures_total += 1
                continue
            if verdict == "poison":
                shard.park(ts, payload, code)
                shard.ring.commit()
                with self._counter_lock:
                    self.dropped_total += 1
                continue
            # Retryable: the record stays at the head; honor the
            # receiver's Retry-After over our own backoff when present.
            with self._counter_lock:
                self.failures_total += 1
            shard.note_failure(
                retry_after_seconds(response_headers, default=0.0)
                if response_headers is not None else 0.0)
            return

    def _post_raw(self, body: bytes,
                  headers: dict) -> tuple[int | None, dict | None]:
        """(status code, response headers); (None, None) on transport
        error. 2xx comes back as the real code — the caller classifies."""
        import urllib.error
        import urllib.request

        request = urllib.request.Request(
            self._url, data=body, method="POST", headers=headers)
        try:
            with push_opener().open(request, timeout=10) as response:
                return response.status, dict(response.headers)
        except urllib.error.HTTPError as exc:
            try:
                exc.read(200)
            except Exception:  # body read can itself die (conn reset)
                pass
            return exc.code, dict(exc.headers or {})
        except Exception as exc:  # noqa: BLE001 - transport failure
            log.warning("remote write failed: %s", exc)
            return None, None

    @property
    def durable(self) -> bool:
        return self._shards is not None

    def backlog_records(self) -> int:
        if self._shards is None:
            return 0
        return sum(s.ring.records_pending() for s in self._shards)

    def egress_status(self) -> dict | None:
        """Per-shard WAL/lag/parked health for /debug/egress and the
        kts_remote_write_* fold; None in legacy best-effort mode (the
        families only exist where durability is on)."""
        if self._shards is None:
            return None
        return {
            "durable": True,
            "protocol": self._protocol,
            "url": self._url,
            "shards": [shard.status() for shard in self._shards],
        }

    def stop(self) -> None:
        super().stop()
        if self._shards is not None:
            for shard in self._shards:
                shard.close()

    # -- legacy best-effort path (no WAL) -------------------------------------

    def _push_legacy(self) -> None:
        import urllib.error
        import urllib.request

        snapshot = self._registry.snapshot()
        if not snapshot.series and not snapshot.histograms:
            return
        headers = self._headers()
        if headers is None:
            self.consecutive_failures += 1  # retryable: token will be back
            self.failures_total += 1
            return
        import time

        serialize_start = time.monotonic()
        build = (build_write_request_v2 if self._protocol == "2.0"
                 else build_write_request)
        body = snappy.compress(build(snapshot, self._job, self._instance,
                                     self._extra_labels))
        if self._render_stats is not None:
            # prompb serialize + snappy: this path's render equivalent.
            self._render_stats.observe(
                "remote_write", time.monotonic() - serialize_start, len(body))
        request = urllib.request.Request(
            self._url, data=body, method="POST", headers=headers)
        try:
            # No-redirect opener: a 302 (e.g. an auth proxy) must land in
            # the failure accounting below, not silently convert the POST
            # into a body-less GET (see workers.push_opener). It also
            # keeps the Authorization header off cross-origin redirects.
            with push_opener().open(request, timeout=10):
                pass
            self.consecutive_failures = 0
            self.pushes_total += 1
        except urllib.error.HTTPError as exc:
            if exc.code == 415 and self._protocol == "2.0":
                # 2.0 spec: an unsupported-media-type receiver means it
                # only speaks 1.0 — downgrade for the process lifetime
                # rather than dropping every subsequent sample set. The
                # next publish retries as 1.0.
                self._protocol = "1.0"
                self.consecutive_failures += 1
                self.failures_total += 1
                log.warning("receiver rejected remote-write 2.0 (HTTP 415); "
                            "downgrading to 1.0")
            elif 400 <= exc.code < 500 and exc.code != 429:
                # Spec: 4xx (except 429) must not be retried.
                self.dropped_total += 1
                try:
                    detail = exc.read(200).decode(errors="replace")
                except Exception:  # body read can itself die (conn reset)
                    detail = "<error body unreadable>"
                log.warning("remote write rejected (HTTP %d), dropping "
                            "sample set: %s", exc.code, detail)
            else:
                self.consecutive_failures += 1
                self.failures_total += 1
                log.warning("remote write failed (HTTP %d, %d consecutive)",
                            exc.code, self.consecutive_failures)
        except Exception as exc:
            self.consecutive_failures += 1
            self.failures_total += 1
            log.warning("remote write failed (%d consecutive): %s",
                        self.consecutive_failures, exc)
