"""The hub's history ring and the ``/query`` read side.

The hub's exposition says what the fleet does now. An operator looking
back at an incident wants what it did an hour ago, without a TSDB. This
module keeps, inside the hub, a bounded and downsampled ring of every
slice rollup series the hub publishes, and serves it:

- ``/query?family=F&window=W`` — the buckets of one rollup family in one
  named window. Each (family, window) response is rendered and gzipped
  once per hub generation and kept, so a dashboard polling it costs a
  dict lookup, not a render.
- ``/query?family=F&at=TS`` — per series, the populated bucket nearest a
  past timestamp (the payload ``doctor --fleet --at`` reads).
- ``kts_history_*`` and ``kts_query_*`` on every publish.

The ring: a fixed set of tiers (named windows), each a preallocated
array of (mean, count, bucket id) per slot. A write is an in-place store
into those arrays, so feeding the ring costs the refresh nothing it would
notice. The refresh thread stages samples with :meth:`HistoryStore.record`
and flushes them once per publish with :meth:`HistoryStore.commit`. A
bucket holds the mean of the samples that fell into it.

Memory is fixed: ``max_series`` identities, each ``series_bytes`` of
slab. A new identity past the cap takes the slab of a series idle longer
than ``reclaim_age`` (counted in ``kts_history_series_evicted_total``)
or is dropped (``kts_history_series_shed_total``).

The ring lives in memory only. It is derived from what the fleet sends,
so a restarted hub starts empty and refills; the ingest checkpoint is
what restores sessions. ETags carry a per-boot nonce, so a dashboard's
``If-None-Match`` from before a restart never draws a 304 from the new
process.

Reads are admitted per client by token buckets (429 with Retry-After,
counted), so one dashboard polling too fast cannot starve scrapes.
No torch on this path: the hub runs from the DaemonSet image.
"""

from __future__ import annotations

import gzip
import json
import math
import os
import threading
import time
from array import array

# Window name -> (bucket seconds, slots). The finest tier has one bucket
# per refresh at the default 10 s interval; the coarser ones average.
DEFAULT_TIERS: tuple[tuple[str, float, int], ...] = (
    ("1h", 10.0, 360),
    ("24h", 300.0, 288),
    ("7d", 3600.0, 168),
)

# A body shorter than this is served uncompressed (the gzip header would
# eat the saving), as on /metrics.
GZIP_MIN_BYTES = 256


class _TierRing:
    """One tier's slots: running mean, sample count, and the absolute
    bucket id that last wrote each slot (a slot whose id is not the
    bucket asked for is empty)."""

    __slots__ = ("step", "slots", "vals", "cnts", "ids")

    def __init__(self, step: float, slots: int) -> None:
        self.step = step
        self.slots = slots
        self.vals = array("d", bytes(8 * slots))
        self.cnts = array("I", bytes(4 * slots))
        self.ids = array("q", (-1,)) * slots

    def reset(self) -> None:
        """Empty every slot in place, for a slab handed to a new
        identity."""
        for i in range(self.slots):
            self.ids[i] = -1
            self.cnts[i] = 0

    def write(self, now: float, value: float) -> None:
        bucket = int(now // self.step)
        i = bucket % self.slots
        if self.ids[i] != bucket:
            self.ids[i] = bucket
            self.cnts[i] = 1
            self.vals[i] = value
        else:
            count = self.cnts[i] + 1
            self.cnts[i] = count
            self.vals[i] += (value - self.vals[i]) / count

    def samples(self, now: float) -> list[list[float]]:
        """``[[bucket start, mean], ...]``, oldest first, of every
        populated bucket in the window that ends at ``now``."""
        newest = int(now // self.step)
        out: list[list[float]] = []
        for bucket in range(newest - self.slots + 1, newest + 1):
            i = bucket % self.slots
            if self.ids[i] == bucket and self.cnts[i]:
                out.append([bucket * self.step, self.vals[i]])
        return out

    def at(self, ts: float) -> tuple[float, float] | None:
        """(bucket start, mean) of the populated bucket nearest ``ts``,
        counted in buckets, the earlier one on a tie; None when no slot
        holds a bucket near it."""
        want = int(ts // self.step)
        for distance in range(self.slots):
            for bucket in (want - distance, want + distance):
                i = bucket % self.slots
                if self.ids[i] == bucket and self.cnts[i]:
                    return bucket * self.step, self.vals[i]
        return None


class _SeriesRings:
    """Every tier of one (family, labels) identity."""

    __slots__ = ("tiers", "last_write")

    def __init__(self, tier_defs) -> None:
        self.tiers = {name: _TierRing(step, slots)
                      for name, step, slots in tier_defs}
        self.last_write = 0.0

    def reset(self) -> None:
        for ring in self.tiers.values():
            ring.reset()
        self.last_write = 0.0


class QueryGate:
    """Per-client token buckets in front of ``/query``: a client over
    its rate gets 429 and a Retry-After, and is counted; nothing waits.
    ``rate <= 0`` admits every request and only counts it."""

    MAX_CLIENTS = 4096

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = rate
        self.burst = max(1.0, burst)
        self.admitted_total = 0
        self.shed_total = 0
        self._clients: dict[str, tuple[float, float]] = {}
        self._lock = threading.Lock()

    def admit(self, client: str,
              now: float | None = None) -> tuple[bool, int]:
        """(admitted, seconds to retry after); the seconds are 0 when
        admitted."""
        if self.rate <= 0:
            self.admitted_total += 1
            return True, 0
        if now is None:
            now = time.monotonic()
        with self._lock:
            tokens, last = self._clients.get(client, (self.burst, now))
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            if tokens >= 1.0:
                self._clients[client] = (tokens - 1.0, now)
                self.admitted_total += 1
                return True, 0
            self._clients[client] = (tokens, now)
            self.shed_total += 1
            retry = max(1, math.ceil((1.0 - tokens) / self.rate))
            if len(self._clients) > self.MAX_CLIENTS:
                # Keep the map bounded: forget the half seen longest
                # ago. A forgotten client comes back with a full bucket.
                for key, _ in sorted(
                        self._clients.items(),
                        key=lambda kv: kv[1][1])[:self.MAX_CLIENTS // 2]:
                    del self._clients[key]
            return False, retry


class HistoryStore:
    """The ring and what ``/query`` serves from it.

    One writer: ``record`` and ``commit`` run on the refresh thread.
    ``handle_query`` runs on handler threads; it takes the lock only to
    build a generation's response, and a cached one is read without it.

    ``enabled=False`` keeps every method: the hub builds the store even
    under ``--no-history``, so ``/query`` answers ``enabled: false``
    rather than 404, while the store records nothing and holds no slab.
    """

    def __init__(self, enabled: bool = True, max_series: int = 1024,
                 query_qps: float = 50.0, query_burst: float = 100.0,
                 reclaim_age: float = 7200.0,
                 tiers: tuple[tuple[str, float, int], ...] | None = None)\
            -> None:
        self.enabled = enabled
        self.max_series = max(1, max_series)
        self.reclaim_age = reclaim_age
        self.tiers = tuple(tiers if tiers is not None else DEFAULT_TIERS)
        # Per identity and slot, in every tier: an f64 mean, a u32
        # count and an i64 bucket id. The bound is max_series times it.
        self.series_bytes = sum(slots * (8 + 4 + 8)
                                for _n, _s, slots in self.tiers)
        self.gate = QueryGate(query_qps, query_burst)
        # family -> labels -> rings; changed only under _lock.
        self._data: dict[str, dict[tuple, _SeriesRings]] = {}
        self._series_count = 0
        self._free: list[_SeriesRings] = []
        self._staged: list[tuple[str, tuple, float]] = []
        self._lock = threading.Lock()
        # Per-boot nonce in every ETag: a restarted hub counts its
        # generations from near 0 again, and without it an ETag kept
        # from the last boot could match and draw a 304.
        self._boot = os.urandom(4).hex()
        self.generation = 0
        self._committed_at = 0.0
        # (family, window) -> (generation, etag, body, gzipped body).
        self._resp_cache: dict[tuple[str, str],
                               tuple[int, str, bytes, bytes]] = {}
        self.samples_total = 0
        self.series_shed_total = 0
        self.series_evicted_total = 0
        self.requests_total = 0
        self.cache_hits_total = 0
        self.cache_misses_total = 0
        self.write_ns_total = 0
        self.commits_total = 0

    # -- writes: the refresh thread only -------------------------------------

    def record(self, family: str, labels: tuple, value: float) -> None:
        """Stage one rollup sample of the refresh in progress (a list
        append)."""
        if self.enabled:
            self._staged.append((family, labels, value))

    def commit(self, now: float, generation: int) -> None:
        """Write the staged samples into every tier at wall time
        ``now`` and move the served generation on; cached responses of
        the old generation stop matching."""
        staged = self._staged
        if not self.enabled:
            staged.clear()
            return
        start = time.perf_counter_ns()
        with self._lock:
            for family, labels, value in staged:
                fam = self._data.get(family)
                if fam is None:
                    fam = self._data[family] = {}
                rings = fam.get(labels)
                if rings is None:
                    rings = self._admit_locked(now)
                    if rings is None:
                        self.series_shed_total += 1
                        continue
                    fam[labels] = rings
                for ring in rings.tiers.values():
                    ring.write(now, value)
                rings.last_write = now
                self.samples_total += 1
            staged.clear()
            self.generation = generation
            self._committed_at = now
        self.write_ns_total += time.perf_counter_ns() - start
        self.commits_total += 1

    def _admit_locked(self, now: float) -> _SeriesRings | None:
        """Rings for a new identity: a freed slab, a new one below the
        cap, else the slab of the identity written longest ago if that
        was more than ``reclaim_age`` back; None sheds the sample."""
        if self._free:
            return self._free.pop()
        if self._series_count < self.max_series:
            self._series_count += 1
            return _SeriesRings(self.tiers)
        stalest: tuple[str, tuple] | None = None
        stale_at = now - self.reclaim_age
        for family, fam in self._data.items():
            for labels, rings in fam.items():
                if rings.last_write <= stale_at:
                    stale_at = rings.last_write
                    stalest = (family, labels)
        if stalest is None:
            return None
        rings = self._data[stalest[0]].pop(stalest[1])
        rings.reset()
        self.series_evicted_total += 1
        return rings

    def bytes(self) -> int:
        """Slab bytes held: never above ``max_series * series_bytes``
        (a freed slab stays allocated and counted)."""
        return self._series_count * self.series_bytes

    # -- reads: handler threads ----------------------------------------------

    def window_names(self) -> list[str]:
        return [name for name, _s, _c in self.tiers]

    def handle_query(self, params: dict, client: str, gzip_ok: bool,
                     if_none_match: str) -> tuple[int, bytes, dict]:
        """(status, body, headers) of one ``GET /query``: admission,
        the parameters, the 304 and the cached body are decided here;
        the HTTP handler writes what comes back."""
        self.requests_total += 1
        if not self.enabled:
            body = json.dumps(
                {"enabled": False,
                 "hint": "hub started with --no-history"},
                sort_keys=True).encode() + b"\n"
            return 200, body, {"Content-Type": "application/json"}
        admitted, retry = self.gate.admit(client)
        if not admitted:
            return (429, b"query rate limited\n",
                    {"Retry-After": str(retry)})
        family = params.get("family", "")
        if not family:
            return (400, b"missing ?family=; tracked families: "
                    + ",".join(sorted(self._data)).encode() + b"\n", {})
        at_raw = params.get("at", "")
        if at_raw:
            try:
                at_ts = float(at_raw)
            except ValueError:
                return 400, b"?at= must be a unix timestamp\n", {}
            body = (json.dumps(self.at_payload(family, at_ts),
                               sort_keys=True) + "\n").encode()
            return 200, body, {"Content-Type": "application/json"}
        window = params.get("window", "") or self.tiers[0][0]
        tier = {name: (step, slots)
                for name, step, slots in self.tiers}.get(window)
        if tier is None:
            return (400, b"unknown ?window=; named windows: "
                    + ",".join(self.window_names()).encode() + b"\n", {})
        step_raw = params.get("step", "")
        if step_raw:
            # The window fixes the step; ``step`` may only confirm it.
            try:
                if float(step_raw.rstrip("s")) != tier[0]:
                    raise ValueError
            except ValueError:
                return (400, f"window {window} serves step "
                        f"{tier[0]:g}s\n".encode(), {})
        if family not in self._data:
            return (404, b"unknown family; tracked: "
                    + ",".join(sorted(self._data)).encode() + b"\n", {})
        generation, etag, body, gz = self._response(family, window)
        if etag_match(if_none_match, etag):
            return 304, b"", {"ETag": etag, "Vary": "Accept-Encoding"}
        headers = {"Content-Type": "application/json", "ETag": etag,
                   "Vary": "Accept-Encoding"}
        if gzip_ok and gz:
            headers["Content-Encoding"] = "gzip"
            return 200, gz, headers
        return 200, body, headers

    def _response(self, family: str,
                  window: str) -> tuple[int, str, bytes, bytes]:
        """(generation, etag, body, gzipped body) of (family, window) at
        the served generation: from the cache, or built once, both
        encodings, under the lock."""
        key = (family, window)
        generation = self.generation
        entry = self._resp_cache.get(key)
        if entry is not None and entry[0] == generation:
            self.cache_hits_total += 1
            return entry
        with self._lock:
            generation = self.generation
            entry = self._resp_cache.get(key)
            if entry is not None and entry[0] == generation:
                self.cache_hits_total += 1
                return entry
            self.cache_misses_total += 1
            step = dict((n, s) for n, s, _c in self.tiers)[window]
            now = self._committed_at
            series = []
            for labels, rings in sorted(
                    self._data.get(family, {}).items()):
                series.append({
                    "labels": dict(labels),
                    "samples": rings.tiers[window].samples(now),
                })
            payload = {"family": family, "window": window,
                       "step_s": step, "generation": generation,
                       "as_of": now, "series": series}
            body = (json.dumps(payload, sort_keys=True) + "\n").encode()
            # One strong ETag for both encodings (the document is the
            # same; Vary tells caches apart), scoped to this boot.
            etag = f'"h{self._boot}-{generation}-{family}-{window}"'
            gz = (gzip.compress(body, compresslevel=3, mtime=0)
                  if len(body) >= GZIP_MIN_BYTES else b"")
            entry = (generation, etag, body, gz)
            self._resp_cache[key] = entry
            return entry

    def at_payload(self, family: str, ts: float) -> dict:
        """Per identity of ``family``, the populated bucket nearest
        ``ts`` in the finest tier whose window still reaches back to
        it."""
        with self._lock:
            now = self._committed_at
            series = []
            for labels, rings in sorted(
                    self._data.get(family, {}).items()):
                hit = None
                window = ""
                for name, step, slots in self.tiers:
                    if now - ts <= step * slots:
                        hit = rings.tiers[name].at(ts)
                        if hit is not None:
                            window = name
                            break
                if hit is not None:
                    series.append({"labels": dict(labels),
                                   "t": hit[0], "v": hit[1],
                                   "window": window})
        return {"family": family, "at": ts, "as_of": now,
                "series": series}

    # -- self-metrics: the refresh thread, every publish ---------------------

    def contribute(self, builder) -> None:
        """``kts_history_*`` and ``kts_query_*`` onto the hub's
        snapshot; every counter is served from 0."""
        from . import schema

        builder.add(schema.HISTORY_SERIES, float(self._series_count))
        builder.add(schema.HISTORY_BYTES, float(self.bytes()))
        builder.add(schema.HISTORY_SAMPLES, float(self.samples_total))
        builder.add(schema.HISTORY_SERIES_SHED,
                    float(self.series_shed_total))
        builder.add(schema.HISTORY_SERIES_EVICTED,
                    float(self.series_evicted_total))
        builder.add(schema.QUERY_REQUESTS, float(self.requests_total))
        builder.add(schema.QUERY_SHED, float(self.gate.shed_total))
        builder.add(schema.QUERY_CACHE_HITS,
                    float(self.cache_hits_total))
        builder.add(schema.QUERY_CACHE_MISSES,
                    float(self.cache_misses_total))


def etag_match(header: str, etag: str) -> bool:
    """True when an If-None-Match header names ``etag`` (or ``*``).
    W/ prefixes compare as their opaque tag: for a 304 the weak
    comparison is the correct one (RFC 9110 §13.1.2)."""
    header = header.strip()
    if not header:
        return False
    if header == "*":
        return True
    for token in header.split(","):
        token = token.strip()
        if token.startswith("W/"):
            token = token[2:]
        if token == etag:
            return True
    return False
