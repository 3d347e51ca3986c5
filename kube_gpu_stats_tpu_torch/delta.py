"""Push-delta wire protocol, publishing half.

The port's copy of the reference's frame codec, encoder and publisher,
whose frames it keeps byte for byte: a frame encoded by one package
decodes in the other, and the port's publisher talks to the reference's
hub. The receiving half (the hub's sessions and lanes) is not ported
yet; ``testing/egress_sink.py`` applies frames by the rules below.

The pull architecture re-fetches and re-parses every worker's FULL
exposition each hub refresh, so hub cost scales with card count even
when nothing changed. This module flips the edge: each publisher keeps
the interned parse of its own exposition (the same
``parse_exposition_interned`` series list the hub would have built from
a scrape) and ships seq-numbered, generation-stamped **change-sets of
series slots** — a quiet tick is a handful of (slot, value) pairs, bytes
proportional to churn, not card count.

Protocol (one HTTP POST per frame to ``/ingest/delta``, snappy block
compression like remote_write):

- **FULL** frame: the complete rendered exposition text. Sent at session
  start, after any series-shape change (device churn, stale-label flip —
  values-only deltas keep slot indexing trivially exact), and whenever
  the receiver demands a resync.
- **DELTA** frame: (slot, value) pairs against the last acked state,
  where slot = index into the series list of the last FULL's parse.
  Labels never travel in a delta — a shape change is a FULL by
  construction.
- Receiver rules: a FULL is always accepted and replaces the session; a
  DELTA must carry the session's generation and exactly seq+1, anything
  else answers **409 resync** and the publisher responds with a FULL.
  Any transport failure (timeout, 5xx, lost response) also promotes the
  next frame to FULL — the publisher never has to reason about whether
  an unacked delta landed.

:class:`DeltaEncoder` owns diffing + framing and is transport-agnostic;
:class:`DeltaPublisher` wraps it in the shared PublishFollower push
scaffold (backoff, final flush, collector_push_* health counters) with
the version negotiation against the receiver's hello, shed honouring
(429/503 + Retry-After) and the disk spill queue (``spillq.py``).

Frames decode on the Python path only: the reference's C slot walk is
host code that stays unported, and its verdicts match this path's.
"""

from __future__ import annotations

import logging
import os
import struct
import time
from typing import NamedTuple, Sequence

from . import snappy
from .resilience import TokenBucket
from .validate import parse_exposition_interned, retry_after_seconds
from .workers import PublishFollower, push_opener

log = logging.getLogger(__name__)

MAGIC = b"KTSD"

# Wire protocol range this build speaks. v1 is the original
# frame layout; v2 adds a capability bitset to the header and
# length-prefixed trailing extension blocks (unknown tags skipped —
# forward tolerance is the contract that lets v2.1 add fields without
# breaking v2.0 receivers). A publisher always OPENS at v1 — every
# receiver ever shipped speaks it — and upgrades only after the
# receiver's hello (the X-KTS-Proto-* headers on its first response)
# proves the far side understands more, so negotiation can never cost
# a frame, a 409 loop, or a quarantine strike. Version skew downgrades
# ENCODING FEATURES, never data: a v1 frame carries the same series
# payload a v2 frame would.
PROTO_MIN = 1
PROTO_MAX = 2
VERSION = PROTO_MIN  # compat alias: the legacy (v1) frame version

# Capability bitset (v2 headers + hello): encoding features a peer may
# use, maskable per connection. A publisher intersects its own caps
# with the receiver's hello caps and encodes with the intersection.
CAP_BUILD_INFO = 1   # FULL frames may carry the build-version extension
CAPS_CURRENT = CAP_BUILD_INFO

# v2 trailing-extension tags. Unknown tags are skipped by length —
# never an error — so future builds can append without a version bump.
EXT_BUILD = 1        # utf-8 build version string (FULL frames)

# Hello headers: the receiver advertises its range/caps/build on every
# /ingest/delta response (200, 409 AND 426 — a refused peer must learn
# what WOULD be accepted), and the publisher negotiates off them.
HELLO_PROTO_MIN = "X-KTS-Proto-Min"
HELLO_PROTO_MAX = "X-KTS-Proto-Max"
HELLO_CAPS = "X-KTS-Caps"
HELLO_BUILD = "X-KTS-Build"

KIND_FULL = 0
KIND_DELTA = 1

INGEST_PATH = "/ingest/delta"
CONTENT_TYPE = "application/x-kts-delta"

# One frame may not decompress past this (a corrupt or hostile length
# preamble must not balloon hub memory; a 4096-worker rollup exposition
# is a few MB at most).
MAX_FRAME_BYTES = 64 * 1024 * 1024

_F64 = struct.Struct("<d")


class ResyncRequired(ValueError):
    """The receiver cannot apply this delta frame; the publisher must
    send a FULL snapshot (answered as HTTP 409)."""


class FrameVersionSkew(ValueError):
    """The frame's protocol version is outside what this receiver
    speaks. Deliberately NOT a malformed-frame verdict: the
    peer is healthy, just from another rollout wave — it gets a
    distinct 426-style refusal with the receiver's (min, max) hello so
    it can renegotiate, never a quarantine strike."""

    def __init__(self, version: int, lo: int, hi: int) -> None:
        super().__init__(
            f"protocol version {version} outside supported "
            f"range {lo}..{hi}")
        self.version = version


class Frame(NamedTuple):
    kind: int
    source: str
    generation: int
    seq: int
    body: str | None                 # FULL frames
    slots: tuple[int, ...]           # DELTA frames: changed slots +
    values: tuple[float, ...]        # their new values (parallel)
    proto: int = 1                   # wire version the frame arrived in
    caps: int = 0                    # publisher capability bitset (v2+)
    build: str = ""                  # publisher build (v2 FULL ext)


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _header(kind: int, source: str, generation: int, seq: int,
            proto: int = PROTO_MIN, caps: int = 0) -> bytearray:
    raw = bytearray(MAGIC)
    raw.append(proto)
    raw.append(kind)
    if proto >= 2:
        raw += _varint(caps)
    encoded = source.encode()
    raw += _varint(len(encoded))
    raw += encoded
    raw += _varint(generation)
    raw += _varint(seq)
    return raw


def _ext_block(tag: int, payload: bytes) -> bytes:
    return _varint(tag) + _varint(len(payload)) + payload


def encode_full(source: str, generation: int, seq: int, body: str, *,
                proto: int = PROTO_MIN, caps: int = 0,
                build: str = "") -> bytes:
    """One snappy-compressed FULL frame carrying the rendered exposition
    text verbatim — the receiver parses it with the same interned
    tokenizer the pull path uses, so push state can never diverge from
    what a scrape of the same bytes would have produced. At proto >= 2
    (and with CAP_BUILD_INFO granted) the frame also carries the
    publisher's build version as a trailing extension — the hub-side
    fleet version census reads it off the session."""
    raw = _header(KIND_FULL, source, generation, seq, proto, caps)
    encoded = body.encode()
    raw += _varint(len(encoded))
    raw += encoded
    if proto >= 2 and build and caps & CAP_BUILD_INFO:
        raw += _ext_block(EXT_BUILD, build.encode())
    return snappy.compress(bytes(raw))


def encode_delta(source: str, generation: int, seq: int,
                 changes: Sequence[tuple[int, float]], *,
                 proto: int = PROTO_MIN, caps: int = 0,
                 build: str = "") -> bytes:
    """One snappy-compressed DELTA frame: ascending (slot, value) pairs,
    slots gap-encoded (varint deltas) so a sparse change-set over a
    large series list stays a couple of bytes per slot. ``build`` (v2 +
    CAP_BUILD_INFO only) appends the build extension — the encoder
    sends it on the first frame after a negotiation so the receiver's
    version census never waits for the next FULL."""
    raw = _header(KIND_DELTA, source, generation, seq, proto, caps)
    raw += _varint(len(changes))
    prev = 0
    for slot, value in changes:
        if slot < prev:
            raise ValueError("delta slots must be ascending")
        raw += _varint(slot - prev)
        prev = slot
        raw += _F64.pack(value)
    if proto >= 2 and build and caps & CAP_BUILD_INFO:
        raw += _ext_block(EXT_BUILD, build.encode())
    return snappy.compress(bytes(raw))


def _declared_size(wire: bytes) -> int:
    """The snappy block preamble (uncompressed-length varint) read
    straight off the compressed stream — so a hostile frame declaring
    gigabytes is rejected BEFORE any decompression work happens, not
    after the bomb has expanded."""
    value = 0
    shift = 0
    for pos in range(min(len(wire), 6)):
        byte = wire[pos]
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value
        shift += 7
    raise ValueError("truncated snappy preamble")


def _read_exts(data: bytes, pos: int) -> tuple[str, int]:
    """Walk v2 trailing extension blocks from ``pos`` to the end of
    the frame: (tag, length)-prefixed, unknown tags skipped whole —
    the forward-tolerance half of the version contract (a v2.x
    publisher may append blocks a v2.0 receiver has never heard of;
    only a block that lies about its length is malformed). Returns the
    build-version extension's value ("" when absent)."""
    build = ""
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        length, pos = _read_varint(data, pos)
        if pos + length > n:
            raise ValueError("truncated extension block")
        if tag == EXT_BUILD:
            build = data[pos:pos + length].decode()
        pos += length
    return build, pos


def decode_frame(wire: bytes) -> Frame:
    """Strict decode of one wire frame; raises ValueError on anything
    malformed (the ingest answers 400, never crashes the hub) and the
    distinct :class:`FrameVersionSkew` on a version outside
    PROTO_MIN..PROTO_MAX (answered 426 + hello, never counted
    hostile)."""
    if _declared_size(wire) > MAX_FRAME_BYTES:
        raise ValueError("frame exceeds the size cap")
    return decode_frame_raw(snappy.decompress(wire))


def decode_frame_raw(data: bytes) -> Frame:
    """:func:`decode_frame` minus the snappy layer — for callers that
    already hold the decompressed bytes (the spill queue's legacy
    wire-frame recovery sniffs the magic off its own decompression and
    must not pay a second one)."""
    if data[:4] != MAGIC:
        raise ValueError("bad magic")
    if len(data) < 6:
        raise ValueError("truncated header")
    proto = data[4]
    if proto < PROTO_MIN or proto > PROTO_MAX:
        raise FrameVersionSkew(proto, PROTO_MIN, PROTO_MAX)
    kind = data[5]
    if kind not in (KIND_FULL, KIND_DELTA):
        raise ValueError(f"unknown frame kind {kind}")
    pos = 6
    caps = 0
    if proto >= 2:
        caps, pos = _read_varint(data, pos)
    n, pos = _read_varint(data, pos)
    if pos + n > len(data):
        raise ValueError("truncated source")
    source = data[pos:pos + n].decode()
    if not source:
        raise ValueError("empty source")
    pos += n
    generation, pos = _read_varint(data, pos)
    seq, pos = _read_varint(data, pos)
    if kind == KIND_FULL:
        n, pos = _read_varint(data, pos)
        if proto < 2:
            if pos + n != len(data):
                raise ValueError("full-frame body length mismatch")
        elif pos + n > len(data):
            raise ValueError("full-frame body length mismatch")
        body = data[pos:pos + n].decode()
        build = ""
        if proto >= 2:
            build, _ = _read_exts(data, pos + n)
        return Frame(kind, source, generation, seq, body, (), (),
                     proto, caps, build)
    count, pos = _read_varint(data, pos)
    n = len(data)
    slots = []
    values = []
    slot = 0
    # Inlined varint walk (single-byte fast path): this loop runs
    # once per changed slot per frame. Bounds surface as IndexError ->
    # the same "truncated varint" verdict the helper raises.
    append_slot = slots.append
    append_value = values.append
    unpack_from = _F64.unpack_from
    try:
        for i in range(count):
            byte = data[pos]
            pos += 1
            if byte < 0x80:
                gap = byte
            else:
                gap = byte & 0x7F
                shift = 7
                while True:
                    byte = data[pos]
                    pos += 1
                    gap |= (byte & 0x7F) << shift
                    if not byte & 0x80:
                        break
                    shift += 7
                    if shift > 63:
                        raise ValueError("varint too long")
            slot = slot + gap if i else gap
            if pos + 8 > n:
                raise ValueError("truncated delta value")
            append_slot(slot)
            append_value(unpack_from(data, pos)[0])
            pos += 8
    except IndexError:
        raise ValueError("truncated varint") from None
    slots_t = tuple(slots)
    values_t = tuple(values)
    build = ""
    if proto >= 2:
        # Trailing extension blocks (skipped by tag unless known):
        # v2's evolution room. A delta CAN carry the build extension —
        # the encoder announces on the first frame after a negotiation
        # so the receiver's version census never waits for a FULL.
        build, pos = _read_exts(data, pos)
    if pos != n:
        raise ValueError("trailing bytes after delta changes")
    return Frame(kind, source, generation, seq, None,
                 slots_t, values_t, proto, caps, build)


def new_generation() -> int:
    """Process-unique, restart-unique session generation. Collision odds
    across a restart are what matter (a reused generation could splice a
    new process's deltas onto old slots) — wall nanoseconds xor pid is
    plenty for that."""
    return ((time.time_ns() ^ (os.getpid() << 40)) & ((1 << 62) - 1)) or 1


class DeltaEncoder:
    """Publisher-side session state: diff the current exposition against
    the last ACKED state and emit the cheapest correct frame. Transport-
    agnostic (the tests drive it with injected drops/reorders/restarts;
    DeltaPublisher adds HTTP)."""

    def __init__(self, source: str, generation: int | None = None, *,
                 build: str = "") -> None:
        self.source = source
        self.generation = (generation if generation is not None
                           else new_generation())
        self.seq = 0
        self._keys: list | None = None    # acked (name, labels) per slot
        self._values: list | None = None  # acked value per slot
        self._pending: tuple | None = None
        self._need_full = True
        self.full_frames = 0
        self.delta_frames = 0
        # Negotiated wire state: open at v1 / no caps — the
        # one encoding every receiver ever shipped accepts — and let
        # set_wire() raise it once the receiver's hello proves more.
        self.proto = PROTO_MIN
        self.caps = 0
        self.build = build
        # Announce-once: after a negotiation raises the
        # wire version, the next frame — FULL or DELTA — carries the
        # build extension so the receiver's census updates immediately
        # instead of waiting for the next FULL. Cleared on ack (a
        # deferred/nacked frame re-announces).
        self._announce_build = False

    def set_wire(self, proto: int, caps: int) -> bool:
        """Adopt a negotiated (proto, caps); True when anything
        changed. No resync needed in either direction: the receiver
        keys session state on (generation, seq), not on the frame
        version, so consecutive frames may legally differ — exactly
        what a mid-chain downgrade against a rolled-back hub needs."""
        proto = max(PROTO_MIN, min(PROTO_MAX, proto))
        caps = caps & CAPS_CURRENT if proto >= 2 else 0
        changed = (proto, caps) != (self.proto, self.caps)
        self.proto = proto
        self.caps = caps
        if changed and proto >= 2:
            self._announce_build = True
        return changed

    def encode_next(self, body: str) -> tuple[bytes, int]:
        """(wire frame, kind) advancing the session to seq+1. The caller
        must follow with ack() (receiver applied it) or nack() (anything
        else) before encoding again."""
        series = parse_exposition_interned(body)
        keys = [(name, labels) for name, labels, _ in series]
        values = [value for _, _, value in series]
        seq = self.seq + 1
        if self._need_full or keys != self._keys:
            # Shape changed (or never synced): values-only deltas can't
            # express it, and a FULL re-anchors slot indexing exactly.
            # The key compare is pointer-cheap: names and label tuples
            # come interned from the shared parse pools.
            wire = encode_full(self.source, self.generation, seq, body,
                               proto=self.proto, caps=self.caps,
                               build=self.build)
            kind = KIND_FULL
        else:
            changes = [(i, v) for i, v in enumerate(values)
                       if v != self._values[i]]
            wire = encode_delta(self.source, self.generation, seq, changes,
                                proto=self.proto, caps=self.caps,
                                build=(self.build if self._announce_build
                                       else ""))
            kind = KIND_DELTA
        # Did THIS frame carry the build extension? ack() may only
        # clear the announce flag then — a negotiation lands between
        # the POST and the ack, so the flag it raises must survive
        # the ack of the pre-negotiation frame in flight.
        announced = (self.proto >= 2 and bool(self.build)
                     and bool(self.caps & CAP_BUILD_INFO)
                     and (kind == KIND_FULL or self._announce_build))
        self._pending = (keys, values, kind, announced)
        return wire, kind

    def ack(self) -> None:
        keys, values, kind, announced = self._pending
        self.seq += 1
        self._keys = keys
        self._values = values
        self._need_full = False
        if announced:
            # The acked frame carried the build extension: the
            # receiver's census has it now.
            self._announce_build = False
        if kind == KIND_FULL:
            self.full_frames += 1
        else:
            self.delta_frames += 1

    def nack(self) -> None:
        """The frame may or may not have been applied (timeout, lost
        response, 409): the only safe resumption is a FULL — the
        receiver accepts one unconditionally."""
        self._need_full = True

    def defer(self) -> None:
        """The frame was DEFINITELY not applied (the receiver refused it
        at admission with 429/503 + Retry-After, before touching session
        state). Unlike nack(), no FULL is needed: the acked state still
        matches the receiver's, so the next encode_next() re-diffs
        against it and ships one delta covering everything that changed
        in the meantime. This distinction is what keeps an overload shed
        from AMPLIFYING load — promoting every shed frame to a FULL
        (the old any-failure behavior) is exactly the resync stampede
        the receiver was shedding to avoid."""
        self._pending = None


def push_headers_provider(username: str, password_file: str):
    """headers_provider for DeltaPublisher from the shared
    --hub-auth-username/--hub-auth-password-file flags: the password
    file is re-read per push (rotations apply without a restart, same
    contract as the hub's pull-side --target-auth-* flags). None when
    no credentials are configured."""
    if not username:
        return None

    def provider() -> dict:
        from .validate import auth_headers

        return auth_headers(username=username,
                            password_file=password_file)

    return provider


class DeltaPublisher(PublishFollower):
    """Publish-following delta push loop: on each registry publish,
    render (a per-generation cache hit — the scrape path pre-warms it),
    parse our own exposition, and POST the diff to the hub's ingest
    endpoint. Runs on daemons (node -> leaf hub) and on leaf hubs
    (leaf -> root) unchanged — the registry is the only dependency.

    Shipping health rides the standard collector_push_* counters
    (mode="delta"); resyncs_total counts 409-forced FULL resends;
    shed_honored_total counts frames the hub refused at admission
    (429/503 + Retry-After) that this publisher deferred — its own
    retry class: a shed frame is known-unapplied, so the next
    push re-diffs instead of promoting to a FULL, and the retry itself
    waits out a decorrelated-jitter spread of the hub's Retry-After so
    10k publishers can't thundering-herd a recovering hub."""

    def __init__(self, registry, url: str, *, source: str,
                 min_interval: float = 1.0, timeout: float = 5.0,
                 headers_provider=None, render_stats=None, tracer=None,
                 ca_file: str = "", insecure_tls: bool = False,
                 generation: int | None = None, rng=None,
                 spill=None, drain_rate: float = 50.0,
                 proto_max: int = PROTO_MAX,
                 build: str | None = None) -> None:
        super().__init__(registry, min_interval, thread_name="delta-push")
        self._url = url.rstrip("/") + INGEST_PATH
        self._https = self._url.startswith("https://")
        self._timeout = timeout
        # Transport hardening: headers_provider is
        # called per push (file-backed credentials rotate without a
        # restart); ca_file/insecure_tls shape the TLS context for an
        # https hub — the same client options the hub's own pull path
        # (validate.fetch_exposition) honors, so a hardened hub is
        # reachable from both directions with one config vocabulary.
        self._headers_provider = headers_provider
        self._ca_file = ca_file
        self._insecure_tls = insecure_tls
        self._render_stats = render_stats
        self._tracer = tracer
        if build is None:
            from . import __version__ as build
        self._encoder = DeltaEncoder(source, generation, build=build)
        self.resyncs_total = 0
        self.auth_failures_total = 0
        self.last_frame_bytes = 0
        self.last_frame_kind: int | None = None
        # Version-skew negotiation state. proto_max pins the
        # ceiling this publisher will negotiate UP to (--hub-proto-max:
        # staged rollouts hold a wave at v1; the skew sim uses it to be
        # an "old" publisher); the encoder still opens at v1 and only
        # the receiver's hello raises it. The counters split the three
        # outcomes apart: negotiated (normal), downgraded (the receiver
        # rolled BACK mid-session and our frames started drawing
        # "unsupported version"), refused (disjoint ranges — 426, the
        # one outcome that cannot self-heal without an operator).
        # 0 = this build's maximum (the --hub-proto-max default).
        self._proto_cap = max(PROTO_MIN,
                              min(PROTO_MAX, proto_max or PROTO_MAX))
        self._hub_hello: dict | None = None
        self.proto_upgrades_total = 0
        self.proto_downgrades_total = 0
        self.skew_refused_total = 0
        # Shed-honoring state: when the hub answers
        # 429/503 + Retry-After, the next push is deferred until a
        # decorrelated-jitter spread of that hint has passed — delay =
        # min(cap, uniform(retry_after, prev * 3)), the AWS recipe
        # BackoffPolicy documents, re-based on each response's hint so a
        # recovering hub's 10k publishers drift apart instead of
        # re-arriving in lockstep. rng injectable so tests pin the
        # spread deterministically.
        import random as random_mod

        self._rng = rng if rng is not None else random_mod.Random()
        self._shed_until = 0.0
        self._shed_prev = 0.0
        self.shed_honored_total = 0
        # Disk spill queue: while the hub link is down every
        # published snapshot spools to the bounded on-disk ring instead
        # of being dropped by the backoff; on reconnect the backlog
        # drains oldest-first through the drain-rate bucket BEFORE live
        # deltas resume — a partition becomes a late-but-complete
        # record, and drain can never stampede a recovering hub.
        self._spill = spill
        # Bucket burst = one publish interval's worth of frames (>= 1 s
        # floor): push_once is publish-gated, so a smaller burst would
        # silently cap the amortized drain below the knob (tokens top
        # out at burst between calls), while a burst this size bounds
        # any single call's blast to ~1-2 s of the configured rate.
        self._drain_bucket = (
            TokenBucket(drain_rate,
                        max(1.0, drain_rate * max(1.0, min_interval)))
            if spill is not None and drain_rate > 0 else None)
        self.drain_rate = drain_rate
        # One spool per published snapshot: push_once must stay
        # idempotent across redundant calls (final flush, tools driving
        # it in a loop) — re-spooling the same generation would inflate
        # the record with duplicates.
        self._last_spooled_gen: int | None = None
        # Snapshots this publisher never took in: the follower renders
        # the newest generation at each push, so every generation
        # published while a push (or a shed window) lasted past the next
        # publish is neither sent nor spooled. The reference leaves
        # them uncounted; the port counts them, so the receiver's record
        # can be reconciled with the ticks exactly (/debug/egress).
        self.skipped_total = 0
        self._last_seen_gen: int | None = None
        # Probe backoff while partitioned: spooling happens at publish
        # cadence (it's a local disk write — the follower's backoff is
        # for receivers), but the NETWORK probe against the dead link
        # backs off on the shared policy via these two.
        self._link_failures = 0
        self._probe_at = 0.0

    @property
    def source(self) -> str:
        return self._encoder.source

    def _note_shed(self, retry_after: float) -> None:
        base = max(0.05, retry_after)
        prev = max(self._shed_prev, base)
        delay = min(max(60.0, 4.0 * base),
                    self._rng.uniform(base, prev * 3.0))
        self._shed_prev = delay
        self._shed_until = time.monotonic() + delay
        self.shed_honored_total += 1
        if self._tracer is not None:
            self._tracer.event(
                "delta_shed",
                f"{self._encoder.source}: hub shed this frame; deferring "
                f"{delay:.2f}s (Retry-After {retry_after:g}s)",
                source=self._encoder.source)

    @staticmethod
    def _parse_hello(headers) -> dict | None:
        """The receiver's advertised (min, max, caps, build) from its
        response headers; None when the receiver predates hellos (an
        old hub — the publisher then stays at v1, the feature-masked
        encoding every build accepts)."""
        if headers is None:
            return None
        raw_max = headers.get(HELLO_PROTO_MAX)
        if raw_max is None:
            return None
        try:
            return {
                "proto_min": int(headers.get(HELLO_PROTO_MIN, "1")),
                "proto_max": int(raw_max),
                "caps": int(headers.get(HELLO_CAPS, "0")),
                "build": headers.get(HELLO_BUILD, ""),
            }
        except ValueError:
            return None

    def _post(self, wire: bytes) -> tuple[str, float, dict | None]:
        """('ok' | 'resync' | 'shed' | 'skew' | 'unsupported' |
        'error', retry-after seconds — meaningful only for 'shed',
        receiver hello when its response carried one) for one frame
        POST."""
        import urllib.error
        import urllib.request

        headers = {"Content-Type": CONTENT_TYPE,
                   "User-Agent": "kube-tpu-stats"}
        if self._headers_provider is not None:
            headers.update(self._headers_provider() or {})
        request = urllib.request.Request(
            self._url, data=wire, method="POST", headers=headers)
        # Shared cached opener (validate._opener): always no-redirect
        # like every push sender — a 302 must be a visible failure (and
        # must never forward an Authorization header to a cross-origin
        # Location) — plus the TLS context for https hubs.
        authed = any(k.lower() == "authorization" for k in headers)
        if self._https or authed:
            from .validate import _opener

            opener = _opener(self._https, self._ca_file,
                             self._insecure_tls, True)
        else:
            opener = push_opener()
        try:
            with opener.open(request, timeout=self._timeout) as response:
                return "ok", 0.0, self._parse_hello(response.headers)
        except urllib.error.HTTPError as exc:
            hello = self._parse_hello(exc.headers)
            if exc.code == 409:
                return "resync", 0.0, hello
            if exc.code == 426:
                # Version skew the receiver refused outright: our
                # frame's protocol version is outside its
                # accepted range. The hello rides the refusal so the
                # caller can renegotiate into range when one exists.
                return "skew", 0.0, hello
            if exc.code in (429, 503) and \
                    exc.headers.get("Retry-After") is not None:
                # Admission shed, not a failure: the hub refused the
                # frame BEFORE touching session state and said when to
                # come back. Known-unapplied => defer + re-diff, never
                # a FULL promotion (that would amplify exactly the load
                # being shed).
                return "shed", retry_after_seconds(exc.headers), hello
            if exc.code == 413:
                # Cardinality admission shed: the hub's
                # series ledger is full. Same contract as 429 —
                # known-unapplied, defer + re-diff, never a FULL
                # promotion or a nack (a nack's forced FULL is the
                # maximally-expensive frame to throw at a full hub).
                # Default pacing even without Retry-After: a pre-hello
                # proxy may strip the header.
                return ("shed",
                        retry_after_seconds(exc.headers, default=15.0),
                        hello)
            if exc.code == 401:
                # Credential problem, not a transport blip: count it
                # separately so "the hub rejects our password" is
                # distinguishable from "the hub is down" at a glance.
                self.auth_failures_total += 1
                log.warning("delta push unauthorized (HTTP 401): check "
                            "--hub-auth-username/--hub-auth-password-file")
                return "error", 0.0, hello
            if exc.code == 400:
                # An OLD receiver (pre-hello) rejecting a v2 frame says
                # "unsupported version" in the body — the one signal a
                # build that predates negotiation can give. Distinct
                # outcome: the caller downgrades to v1 and re-sends
                # INSIDE this push (a rolling hub downgrade costs one
                # frame round-trip, not a quarantine strike per push).
                body = b""
                try:
                    body = exc.read(200)
                except Exception:  # noqa: BLE001 - conn already dead
                    pass
                if b"unsupported version" in body:
                    return "unsupported", 0.0, hello
            log.warning("delta push rejected (HTTP %d)", exc.code)
            return "error", 0.0, hello
        except Exception as exc:  # noqa: BLE001 - transport failure
            log.warning("delta push failed: %s", exc)
            return "error", 0.0, None

    def _negotiate(self, hello: dict | None) -> bool:
        """Adopt the receiver's hello: clamp our wire
        version into the intersection of its advertised range and our
        own ceiling. True when the encoder's wire state changed. A
        disjoint range changes nothing — the 426 path owns that
        refusal's accounting."""
        if not hello:
            return False
        self._hub_hello = hello
        target = min(self._proto_cap, hello["proto_max"])
        if target < hello["proto_min"]:
            return False
        before = self._encoder.proto
        if not self._encoder.set_wire(target, hello["caps"]):
            return False
        if self._encoder.proto > before:
            self.proto_upgrades_total += 1
        elif self._encoder.proto < before:
            self.proto_downgrades_total += 1
        # else: caps-only renegotiation (a hub minor enabled a new
        # feature bit) — a wire change worth the trace event below,
        # but neither an upgrade nor a downgrade: counting it as a
        # downgrade would make doctor --skew cry rollback on a
        # routine feature rollout.
        if self._tracer is not None:
            self._tracer.event(
                "proto_negotiated",
                f"{self._encoder.source}: wire protocol v{before} -> "
                f"v{self._encoder.proto} (hub "
                f"{hello.get('build') or 'unknown build'} speaks "
                f"{hello['proto_min']}..{hello['proto_max']})",
                source=self._encoder.source)
        return True

    def _send_frame(self, body: str) -> tuple[str, float]:
        """Encode + POST one snapshot with bounded in-push recovery:
        409 resync (the hub lost or never had our session — one FULL
        inside this push, not one more interval of gap), old-hub
        "unsupported version" 400 (downgrade the ENCODING to v1 and
        re-send the same data), and 426 version-skew refusal
        (renegotiate into the advertised range when one exists). Owns
        the encoder's ack/defer/nack transition and the
        pushes_total/last_frame accounting; the caller classifies the
        outcome ('ok' | 'shed' | 'skew' | ...) for its own path (live
        vs backlog drain)."""
        encoder = self._encoder
        wire, kind = encoder.encode_next(body)
        outcome, retry_after, hello = self._post(wire)
        for _attempt in range(2):
            if outcome == "resync":
                self.resyncs_total += 1
                encoder.nack()
                if self._tracer is not None:
                    self._tracer.event(
                        "delta_resync",
                        f"{encoder.source}: hub demanded resync; sending "
                        f"full snapshot", source=encoder.source)
            elif outcome == "unsupported" and encoder.proto > PROTO_MIN:
                # A receiver that predates negotiation (or rolled back
                # to one) 400s our v2 frames with "unsupported
                # version" and no hello. Drop the ENCODING to v1 —
                # same data, legacy framing — and re-send now. The
                # frame definitely never touched session state (a 400
                # is pre-apply), so defer + re-diff, never a FULL.
                self.proto_downgrades_total += 1
                if self._tracer is not None:
                    self._tracer.event(
                        "proto_downgrade",
                        f"{encoder.source}: hub rejected wire protocol "
                        f"v{encoder.proto} (pre-negotiation build); "
                        f"downgrading encoding to v{PROTO_MIN}",
                        source=encoder.source)
                encoder.set_wire(PROTO_MIN, 0)
                self._hub_hello = None
                encoder.defer()
            elif outcome == "skew":
                # Distinct 426 refusal: our version is outside the
                # receiver's accepted window (e.g. a census-gated
                # --ingest-proto-min floor). Definitely unapplied.
                # Renegotiate into range when the hello offers one we
                # can speak; a disjoint range stays refused — counted,
                # journaled, and visible in doctor --skew on BOTH ends.
                self.skew_refused_total += 1
                encoder.defer()
                if self._tracer is not None:
                    self._tracer.event(
                        "skew_refused",
                        f"{encoder.source}: hub refused wire protocol "
                        f"v{encoder.proto} (accepts "
                        f"{hello['proto_min']}..{hello['proto_max']})"
                        if hello else
                        f"{encoder.source}: hub refused wire protocol "
                        f"v{encoder.proto} (version skew)",
                        source=encoder.source)
                if not self._negotiate(hello):
                    break
            else:
                break
            wire, kind = encoder.encode_next(body)
            outcome, retry_after, hello = self._post(wire)
        if outcome == "ok":
            # Adopt the receiver's hello for FUTURE frames (the normal
            # upgrade path: first FULL goes v1, the 200's hello raises
            # the session to the common maximum, deltas ride v2).
            self._negotiate(hello)
            encoder.ack()
            self.pushes_total += 1
            self.last_frame_bytes = len(wire)
            self.last_frame_kind = kind
        elif outcome == "shed":
            # Its own retry class: not a failure (the backoff-scaled
            # push interval and the supervisor's failure counters stay
            # untouched), not a resync (the frame never reached session
            # state, so the acked diff base is still valid).
            encoder.defer()
        elif outcome in ("skew", "unsupported"):
            # Refused for version reasons and no renegotiation landed:
            # definitely unapplied, so the acked diff base survives.
            # The caller treats it like a down link (spool when a spill
            # queue exists — the backlog drains complete after the
            # rollout wave that fixes the skew).
            encoder.defer()
        else:
            encoder.nack()
        return outcome, retry_after

    @property
    def negotiated_proto(self) -> int:
        return self._encoder.proto

    def skew_status(self) -> dict:
        """This publisher's side of the version-skew picture: what it
        speaks, what it negotiated, what the hub last
        advertised, and the refusal/downgrade counters — the daemon's
        /debug/skew payload and doctor --skew's node-side evidence."""
        return {
            "source": self._encoder.source,
            "build": self._encoder.build,
            "proto_min": PROTO_MIN,
            "proto_max": self._proto_cap,
            "negotiated_proto": self._encoder.proto,
            "negotiated_caps": self._encoder.caps,
            "hub": dict(self._hub_hello) if self._hub_hello else None,
            "skew_refused_total": self.skew_refused_total,
            "proto_upgrades_total": self.proto_upgrades_total,
            "proto_downgrades_total": self.proto_downgrades_total,
        }

    @property
    def backlog_depth(self) -> int:
        return self._spill.depth() if self._spill is not None else 0

    def spill_status(self) -> dict | None:
        """Spool health for /debug/egress and the kts_spill_* fold;
        None when no spill queue is configured."""
        if self._spill is None:
            return None
        status = self._spill.status()
        status["drain_rate"] = self.drain_rate
        status["draining"] = bool(status["depth_frames"])
        status["link_failures"] = self._link_failures
        return status

    def _enter_spill(self, text: str, generation) -> None:
        """First failed push of a partition: spool the snapshot, start
        the probe backoff, journal the edge. ``generation`` is the
        registry generation of the snapshot being spooled, captured by
        push_once BEFORE the (possibly seconds-long) failed POST — a
        publish landing during that POST must not be dedup-skipped as
        already-spooled."""
        depth_before = self._spill.depth()
        self._spill.spool(time.time(), text)
        self._last_spooled_gen = generation
        self._link_failures += 1
        self._probe_at = (time.monotonic()
                          + self.backoff.interval_for(self._link_failures))
        if depth_before == 0 and self._tracer is not None:
            self._tracer.event(
                "spill_start",
                f"{self._encoder.source}: hub unreachable; spooling "
                f"snapshots to disk", source=self._encoder.source)

    def _drain_backlog(self) -> None:
        """Send spooled frames oldest-first through the drain-rate
        bucket, honoring shed responses and backing the probe off on
        transport failure. Bounded per call by the bucket — the next
        push_once continues — so the publisher thread stays responsive
        and the amortized drain rate never exceeds the knob."""
        spill = self._spill
        if time.monotonic() < self._probe_at:
            return
        try:
            while True:
                if self.superseded():
                    # A respawn replaced this thread while it was
                    # wedged mid-drain: stop BEFORE the next
                    # peek/commit — two drains on one cursor skip
                    # records.
                    return
                if self.heartbeat is not None:
                    # A long rate-paced drain stays inside push_once for
                    # many sends; each loop beat keeps the supervisor's
                    # hang detector honest.
                    self.heartbeat()
                if self._shed_until and time.monotonic() < self._shed_until:
                    return
                if self._drain_bucket is not None and \
                        not self._drain_bucket.try_take():
                    return
                record = spill.peek()
                if record is None:
                    break
                _ts, body = record
                outcome, retry_after = self._send_frame(body)
                if self.superseded():
                    # The wedge was INSIDE the send and a respawned
                    # thread took over meanwhile: committing now would
                    # double-advance the cursor past a record the new
                    # thread never saw. Leave the frame spooled —
                    # at-least-once, the hub's dup detection absorbs
                    # the re-send.
                    return
                if outcome == "ok":
                    spill.commit()
                    self._link_failures = 0
                    self._shed_until = self._shed_prev = 0.0
                    continue
                if outcome == "shed":
                    # The hub is up but shaping load: honor the
                    # Retry-After (decorrelated jitter) and leave the
                    # frame spooled — known-unapplied, it re-sends after
                    # the window. This is the 0-FULL-amplification half
                    # of the drain contract.
                    self._note_shed(retry_after)
                    return
                # Still partitioned (or version-refused — its own
                # counter, not a push failure): the frame stays at the
                # head, the probe backs off, failures stay visible in
                # the push health.
                if outcome not in ("skew", "unsupported"):
                    self.failures_total += 1
                self._link_failures += 1
                self._probe_at = (time.monotonic()
                                  + self.backoff.interval_for(
                                      self._link_failures))
                return
        finally:
            # Persist the cursor on EVERY exit (dirty-gated: a no-op
            # when nothing was committed) — a long drain is paced over
            # many push cycles by the rate bucket, and a crash mid-drain
            # must re-send at most this cycle's window, not replay the
            # whole already-drained prefix.
            spill.save_cursor()
        # Backlog cleared: journal the recovery edge.
        if self._tracer is not None:
            self._tracer.event(
                "spill_drained",
                f"{self._encoder.source}: backlog drained "
                f"({spill.drained_total} total); live deltas resumed",
                source=self._encoder.source)

    def push_once(self) -> None:
        if self._shed_until and time.monotonic() < self._shed_until:
            # Honoring a Retry-After: skip this push entirely (no
            # render, no POST). Nothing is lost — the encoder's acked
            # state is untouched, so the first push after the window
            # ships one delta covering the whole gap (and a spooling
            # publisher keeps spooling the moment the window ends).
            return
        serialize_start = time.monotonic()
        # Generation captured BEFORE the render (and so before any
        # failed POST's timeout): a publish racing this push must err
        # toward re-spooling a duplicate of the same values, never
        # toward dedup-skipping a genuinely new snapshot into a hole.
        generation = getattr(self._registry, "generation", None)
        if generation is not None:
            seen = self._last_seen_gen
            if seen is not None and generation > seen + 1:
                self.skipped_total += generation - seen - 1
            if seen is None or generation > seen:
                self._last_seen_gen = generation
        body, _ = self._registry.rendered()
        if not body:
            return
        text = body.decode()
        if self._spill is not None and self._spill.depth():
            # Partitioned or draining: the live snapshot joins the TAIL
            # of the record (ordering preserved — oldest-first is the
            # whole point) and the head drains through the rate bucket.
            # consecutive_failures is pinned to 0 so the follower keeps
            # PUBLISH cadence: the spool write is local disk, and the
            # backoff belongs to the network probe (_probe_at), not to
            # the record-keeping.
            if generation is None or generation != self._last_spooled_gen:
                self._spill.spool(time.time(), text)
                self._last_spooled_gen = generation
            self.consecutive_failures = 0
            self._drain_backlog()
            return
        # Diff+encode cost only — measured BEFORE the POST like every
        # other render site (remote_write serializes, then sends); a
        # slow hub must not masquerade as serialization cost.
        serialize_seconds = time.monotonic() - serialize_start
        outcome, retry_after = self._send_frame(text)
        if outcome == "ok":
            self._shed_until = self._shed_prev = 0.0
            self.consecutive_failures = 0
            self._link_failures = 0
            # Delivered live = recorded: a redundant push_once for the
            # same generation must not spool it after the fact.
            self._last_spooled_gen = generation
            if self._render_stats is not None:
                # The push path's render-equivalent accounting: bytes on
                # the wire per frame and the serialize+diff cost, shared
                # with the scrape/textfile/remote-write surfaces.
                self._render_stats.observe(
                    "delta", serialize_seconds, self.last_frame_bytes)
        elif outcome == "shed":
            self._note_shed(retry_after)
        elif outcome in ("skew", "unsupported"):
            # Version-refused, NOT a transport failure: it has its own
            # counter (kts_skew_refused_total / downgrades) and its own
            # operator surface (doctor --skew) — counting it into
            # collector_push_failures_total would page the wrong
            # runbook. The DATA still survives the skew: with a spill
            # queue the snapshot spools and the backlog drains complete
            # after the rollout wave that fixes the mismatch; either
            # way the follower's backoff paces the retries.
            if self._spill is not None:
                self._enter_spill(text, generation)
                self.consecutive_failures = 0
            else:
                self.consecutive_failures += 1
        else:
            self.failures_total += 1
            if self._spill is not None:
                # The partition edge: this snapshot (and every one
                # after it) goes to disk instead of the floor.
                self._enter_spill(text, generation)
                self.consecutive_failures = 0
            else:
                self.consecutive_failures += 1

    def stop(self) -> None:
        super().stop()
        if self._spill is not None:
            # Final cursor save + segment close: a clean pod reschedule
            # resumes the drain exactly where it stopped.
            self._spill.close()


