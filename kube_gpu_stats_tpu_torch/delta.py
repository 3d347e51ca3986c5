"""Push-delta wire protocol: the publisher and the hub's receiver.

The port's copy of the reference's frame codec, encoder, publisher and
ingest, whose frames and checkpoints it keeps byte for byte: a frame
encoded by one package decodes in the other, the port's publisher talks
to the reference's hub and the reference's publisher to the port's.

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
:class:`DeltaIngest` owns the hub-side sessions, sharded into lanes
(:func:`lane_of`), which the hub refresh drains into its
``_TargetCache`` entries. It also owns its overload and crash behaviour:

- **Admission control**: a per-lane token bucket rates DELTA frames, a
  bounded in-flight budget caps concurrent applies, and a session-count
  memory fence refuses NEW sessions. Chatty sources lose deltas (429 +
  Retry-After) before a 409-recovery FULL is ever refused, and
  established sessions are never evicted by pressure.
- **Warm restart**: the session table plus each pushed entry's series
  state checkpoints under the WAL discipline (``wal.write_state``); a
  restarted hub replays it and resumes delta chains at the checkpointed
  seq instead of 409ing the whole fleet into a FULL resync.
- **Hostile-pusher quarantine**: repeated malformed frames from one
  peer or source trip a per-key circuit breaker, so a corrupt-frame
  flood costs a dict lookup per frame, not a parse.

Frames decode on the Python path only: the reference's C slot walk is
host code that stays unported, and its verdicts match this path's.
"""

from __future__ import annotations

import itertools
import logging
import os
import struct
import threading
import time
import zlib
from typing import NamedTuple, Sequence

from . import native as native_pkg
from . import snappy, wal
from .cardinality import CardinalityShed, clamp_series
from .resilience import CLOSED, OPEN, CircuitBreaker, TokenBucket
from .supervisor import spawn
from .validate import parse_exposition_interned, retry_after_seconds
from .workers import PublishFollower, push_opener

log = logging.getLogger(__name__)

# Default ingest lane count: enough lanes that handler
# threads of distinct sources rarely share a lock, few enough that the
# per-lane self-metric series stay a rounding error on the exposition.
DEFAULT_INGEST_LANES = max(1, min(8, os.cpu_count() or 1))


def lane_of(source: str, lanes: int) -> int:
    """Deterministic source -> lane routing shared by the session lanes
    and the sharded entry store (the two MUST agree, or a lane would
    lock itself against a session whose entry lives in another lane's
    slab). crc32, not hash(): stable under PYTHONHASHSEED so lane
    assignment is reproducible across runs and debuggable from logs."""
    if lanes <= 1:
        return 0
    return zlib.crc32(source.encode()) % lanes

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
    # Whole-frame fast path: the common-case DELTA (header, source, slot
    # walk, extension walk) in one C call. It answers None for anything
    # unusual (FULLs, skew, malformed bytes, unbounded-int varints): the
    # Python path below owns every error verdict.
    module = native_pkg.fast_path()
    if module is not None:
        decoded = module.decode_delta_frame(data)
        if decoded is not None:
            (source, generation, seq, slots_t, values_t, proto, caps,
             build) = decoded
            return Frame(KIND_DELTA, source, generation, seq, None,
                         slots_t, values_t, proto, caps, build)
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
    # The extension's slot walk, with the Python loop's error strings;
    # None (fall through) for a frame whose slot arithmetic needs
    # Python's unbounded ints.
    decoded = None
    if module is not None and count <= 0xFFFF_FFFF:
        decoded = module.decode_delta_slots(data, pos, count)
    if decoded is not None:
        slots_t, values_t, pos = decoded
    else:
        slots_t, values_t, pos = _walk_slots(data, pos, count)
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


def _walk_slots(data: bytes, pos: int, count: int) -> tuple:
    """The Python slot walk of a DELTA frame: (slots, values, end)."""
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
    return tuple(slots), tuple(values), pos


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
        # The FULLs among full_frames that a change of the series keys
        # forced on a synced session (a family that came or went, a
        # relabel), as against the first FULL and nack() resyncs.
        self.key_change_fulls = 0
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
        # (arguments, wire) of the last FULL encoded. A FULL is a pure
        # function of its arguments, and a publisher probing a down hub
        # encodes the same spooled head at the same seq every cycle:
        # the snappy pass is paid once per head.
        self._last_full: tuple | None = None

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
        key_change = not self._need_full and keys != self._keys
        if self._need_full or key_change:
            # Shape changed (or never synced): values-only deltas can't
            # express it, and a FULL re-anchors slot indexing exactly.
            # The key compare is pointer-cheap: names and label tuples
            # come interned from the shared parse pools.
            args = (self.source, self.generation, seq, body, self.proto,
                    self.caps, self.build)
            if self._last_full is not None and self._last_full[0] == args:
                wire = self._last_full[1]
            else:
                wire = encode_full(self.source, self.generation, seq, body,
                                   proto=self.proto, caps=self.caps,
                                   build=self.build)
                self._last_full = (args, wire)
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
        self._pending = (keys, values, kind, announced, key_change)
        return wire, kind

    def ack(self) -> None:
        keys, values, kind, announced, key_change = self._pending
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
            self.key_change_fulls += key_change
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


class _Session:
    """One source's receiver-side protocol state (generation + seq chain
    + freshness). The SERIES state lives on the hub's ingest-cache entry
    — frames apply straight onto it at POST time, so the refresh thread
    pays replay, never apply."""

    __slots__ = ("source", "generation", "seq", "last_monotonic", "frames",
                 "last_gap", "order", "proto", "caps", "build")

    def __init__(self, source: str, order: int = 0) -> None:
        self.source = source
        self.generation = 0
        self.seq = 0
        self.last_monotonic = 0.0
        self.frames = 0
        # Seconds between the last two frames: the push path's
        # freshness signal (the fleet lens scores it where the pull
        # path scores scrape latency — a publisher falling behind its
        # cadence shows up here refreshes before it goes fence-stale).
        self.last_gap = 0.0
        # Global admission sequence: sources() reports sessions in
        # fleet-wide arrival order even though they live in per-lane
        # tables, so the hub's target order (and its first-wins series
        # dedup) is indistinguishable from the single-table era.
        self.order = order
        # Fleet version census: the wire version + caps of
        # the session's last frame and the publisher build its v2
        # FULLs declared. proto 0 = nothing seen yet (a warm-restart
        # replay; the publisher's next frame stamps the truth).
        self.proto = 0
        self.caps = 0
        self.build = ""

    def stamp(self, now: float) -> None:
        if self.last_monotonic:
            self.last_gap = now - self.last_monotonic
        self.last_monotonic = now


class _Lane:
    """One ingest lane: a shared-nothing shard of the receiver.

    Sources hash here (lane_of) and everything a frame apply touches —
    the lock, the session table, and (via LaneStore) the entry slab —
    is lane-local, so handler threads for sources in different lanes
    never contend. Counters are lane-local too (summed by the
    DeltaIngest properties): a shared counter would re-serialize every
    lane on one cache line's worth of lock."""

    __slots__ = ("lock", "sessions", "full_frames", "delta_frames",
                 "dup_frames", "bytes", "resyncs", "apply_seconds",
                 "bucket")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.sessions: dict[str, _Session] = {}
        self.full_frames = 0
        self.delta_frames = 0
        # FULL retransmits (same generation, same seq, session already
        # counted it): a publisher whose response was lost re-sends the
        # frame it cannot know landed. Re-applied (idempotent; the body
        # may be fresher) but counted HERE, not in full_frames — a
        # spill-queue drain across a flaky link must not double-count
        # the record.
        self.dup_frames = 0
        self.bytes = 0
        self.resyncs = 0
        # Cumulative wall seconds handler threads spent inside apply()
        # (parse + patch). Exported per lane: ingest CPU is the root
        # hub's ceiling at fleet fan-in, and this is what prices it.
        self.apply_seconds = 0.0
        # Per-lane DELTA admission bucket: None = unlimited.
        # Lane-local like the lock and counters, so the rate check
        # never re-serializes the lanes on one shared bucket.
        self.bucket: TokenBucket | None = None


class LaneStore:
    """Sharded target -> _TargetCache mapping: one dict slab per ingest
    lane, routed by the same lane_of() the session lanes use, so a
    lane's frame applies only ever touch its own slab. Presents the
    small dict surface the hub's refresh path uses (get/set/del/
    contains/iter) — the lanes are merged into one coherent view simply
    by iterating the slabs at render-generation time; individual dict
    operations stay GIL-atomic exactly like the single-dict era."""

    __slots__ = ("shards",)

    def __init__(self, lanes: int = 1) -> None:
        self.shards: tuple[dict, ...] = tuple(
            {} for _ in range(max(1, lanes)))

    def _shard(self, key: str) -> dict:
        return self.shards[lane_of(key, len(self.shards))]

    def get(self, key: str, default=None):
        return self._shard(key).get(key, default)

    def __getitem__(self, key: str):
        return self._shard(key)[key]

    def __setitem__(self, key: str, value) -> None:
        self._shard(key)[key] = value

    def __delitem__(self, key: str) -> None:
        del self._shard(key)[key]

    def __contains__(self, key: str) -> bool:
        return key in self._shard(key)

    def __iter__(self):
        for shard in self.shards:
            # list() per shard: a concurrent handler-thread insert must
            # not blow up a refresh-thread iteration (same contract the
            # hub's eviction loop already applies to the parse cache).
            yield from list(shard)

    def __len__(self) -> int:
        return sum(len(shard) for shard in self.shards)


class DeltaIngest:
    """Hub-side receiver for the push protocol.

    HTTP POST threads call :meth:`handle`/:meth:`apply`, which validate
    the seq chain and apply the frame DIRECTLY onto the hub's ingest
    entry (``entry_factory``/``entry_store`` are injected by the hub:
    a FULL builds a fresh pushed entry from the parsed body, a DELTA
    calls the entry's ``apply_patch``). That puts the apply cost on the
    POST threads — spread over the refresh interval, exactly where the
    pull path's parse cost used to overlap the fetch phase — so the
    refresh itself only replays ready entries. The refresh thread calls
    :meth:`fresh_sources` to learn which targets are push-served this
    cycle, :meth:`sources` to merge live push sources into the target
    list, and :meth:`evict` on churn.

    Concurrency: sources hash to shared-nothing LANES
    (lane_of), each with its own lock, session table and — when the hub
    wires a LaneStore — entry slab, so frame applies only serialize
    against the same lane's sources; the refresh thread reads entries
    without any lock and merges the lane views at render-generation
    time. A patch landing mid-refresh can hand that one refresh a mix
    of two adjacent frames' values for ONE target (each slot
    individually consistent) — the next refresh sees the settled state,
    the same freshness contract a pull of a mid-write textfile target
    has always had. The per-slot patch loop runs as one call of the
    host extension (``apply_slots``) per frame; ``native=False``
    (``--no-native-ingest``) keeps the Python per-slot path, its
    differential oracle."""

    def __init__(self, tracer=None, expiry: float = 60.0,
                 entry_factory=None, entry_store=None, lanes: int = 1,
                 delta_rate: float = 0.0, delta_burst: float = 0.0,
                 max_inflight: int = 0, max_sessions: int = 0,
                 quarantine_threshold: int = 5,
                 quarantine_window: float = 60.0,
                 checkpoint_path: str = "",
                 checkpoint_interval: float = 10.0,
                 proto_min: int = PROTO_MIN,
                 proto_max: int = PROTO_MAX,
                 build: str | None = None,
                 accountant=None,
                 native: bool = True) -> None:
        self._tracer = tracer
        self._expiry = expiry
        # Cardinality admission: a SeriesAccountant shared
        # with the hub's pull path, or None — the accept-everything
        # contract every in-process user keeps.
        self._accountant = accountant
        # Generation-stamped admission fast path: the hub
        # always wires an accountant (the ledger powers
        # kts_series_live), but with every knob off the per-frame
        # admission work — admit/clamp on FULLs, touch/is_clamped on
        # DELTAs — is pure tax. Cache the enabled verdict against the
        # accountant's config generation: the hot path pays one int
        # compare per frame, and an operator's runtime knob write
        # (which bumps config_gen) lands on the very next frame.
        self._acct_gen = -1
        self._acct_on = False
        self._refresh_acct_verdict()
        # Accepted wire-version window. The default is
        # everything this build can decode; --ingest-proto-min raises
        # the floor for census-gated rollouts (refuse stragglers with
        # 426 instead of silently carrying v1 forever), and the skew
        # sim pins proto_max below the ceiling to play an old hub.
        # Frames outside the window draw a 426 + hello — a distinct,
        # journaled refusal (kts_skew_refused_total), never a
        # malformed-frame quarantine strike: the peer is healthy, just
        # mid-rollout.
        self._proto_min = max(PROTO_MIN,
                              min(PROTO_MAX, proto_min or PROTO_MIN))
        self._proto_max = max(self._proto_min,
                              min(PROTO_MAX, proto_max or PROTO_MAX))
        if build is None:
            from . import __version__ as build
        self._build = build
        self._hello: dict[str, str] | None = None  # built on first use
        self._skew_lock = threading.Lock()
        self.skew_refused_total = 0
        self._skew_peers: dict[str, dict] = {}
        # Sharded lanes: sources hash to a lane;
        # each lane serializes only its own sources' applies, so at
        # 10k-pusher fan-in the handler threads stop convoying behind
        # one global lock. lane 0 alone reproduces the old behavior.
        self._lanes = tuple(_Lane() for _ in range(max(1, lanes)))
        self._order = itertools.count(1)
        # -- admission control: all off by default (0), so
        # in-process users (tests, benches, the differential oracle)
        # keep the accept-everything contract; the hub CLI turns the
        # knobs on. delta_rate is PER LANE (the lanes are shared-
        # nothing; a global bucket would re-serialize them).
        if delta_rate > 0:
            burst = delta_burst if delta_burst > 0 else 2.0 * delta_rate
            for lane in self._lanes:
                lane.bucket = TokenBucket(delta_rate, burst)
        self._max_inflight = max(0, max_inflight)
        # FULLs may use the whole in-flight budget; DELTAs only up to
        # budget - reserve. Under pressure the deltas shed FIRST, so a
        # 409-recovery FULL always finds headroom (the issue's shed
        # priority: refusing the FULL would strand the session and turn
        # one shed into a retry storm).
        self._inflight_reserve = max(1, self._max_inflight // 4) \
            if self._max_inflight else 0
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._max_sessions = max(0, max_sessions)
        # Shed accounting: reason -> count, under its own small lock
        # (sheds are the slow path by definition; a per-lane split
        # would buy nothing but label cardinality).
        self._shed_lock = threading.Lock()
        self._shed: dict[str, int] = {}
        # -- hostile-pusher quarantine: per-peer/per-source breakers
        # over MALFORMED frames only (a resync is protocol, not
        # hostility). Bounded so a spoofed-source flood can't grow the
        # dict without limit.
        self._quarantine_threshold = max(1, quarantine_threshold)
        self._quarantine_window = quarantine_window
        self._quarantine: dict[str, CircuitBreaker] = {}
        self._quarantine_lock = threading.Lock()
        # -- warm restart: sessions + pushed-entry state
        # checkpoint under the energy.py WAL discipline; a restarted
        # hub loads the index synchronously (cheap JSON) and replays
        # entries in the background / on demand, resuming delta chains
        # instead of 409ing the fleet.
        self._ckpt_path = checkpoint_path
        self._ckpt_interval = checkpoint_interval
        self._ckpt_io_lock = threading.Lock()
        self._ckpt_last_write = 0.0
        self._ckpt_frames_at_write = -1
        # Monotone write epoch, persisted and re-seeded across
        # restarts: the WAL-vs-main recovery rule compares it, so it
        # must never restart from 0 (a fresh process's first .wal,
        # stranded by a crash between fsync and rename, has to beat a
        # previous life's main file).
        self._ckpt_seq = 0
        self.checkpoint_writes = 0
        self.checkpoint_loaded = False
        self._replay_lock = threading.Lock()
        self._pending_replay: dict[str, tuple] = {}
        self._replay_thread: threading.Thread | None = None
        self._replay_loaded_monotonic = 0.0
        self.warm_restart_sessions = 0
        self.warm_restart_replay_seconds = 0.0
        if checkpoint_path:
            self._load_checkpoint()
        # Injected by the hub (delta.py must not import hub.py):
        # entry_factory(series_list) -> pushed ingest entry;
        # entry_store is the hub's target -> entry mapping (a LaneStore
        # sharded with the same lane_of routing when the hub runs
        # sharded ingest; any plain mapping works — dict ops are
        # GIL-atomic either way).
        self._entry_factory = entry_factory
        self._entry_store = entry_store if entry_store is not None else {}
        # The extension's batch slot store, handed to every entry patch;
        # loaded here so that a failed build stops the hub at start.
        # None: the Python per-slot oracle (native=False, or after a
        # native fault sent this instance back to it).
        self._native_mod = native_pkg.load_ingest() if native else None

    @property
    def lanes(self) -> int:
        return len(self._lanes)

    @property
    def native_active(self) -> bool:
        """True while frames apply through the extension's batch slot
        store: False under ``native=False`` and after a native fault."""
        return self._native_mod is not None

    # Fleet-wide counters: summed over lanes on read (the write side is
    # lane-local so lanes never share a hot line; reads happen once per
    # refresh/publish, where a few adds are free).

    @property
    def full_frames_total(self) -> int:
        return sum(lane.full_frames for lane in self._lanes)

    @property
    def delta_frames_total(self) -> int:
        return sum(lane.delta_frames for lane in self._lanes)

    @property
    def duplicate_frames_total(self) -> int:
        """FULL retransmits absorbed without double-counting (the
        publisher's response was lost; the frame already landed)."""
        return sum(lane.dup_frames for lane in self._lanes)

    @property
    def bytes_total(self) -> int:
        return sum(lane.bytes for lane in self._lanes)

    @property
    def resyncs_total(self) -> int:
        return sum(lane.resyncs for lane in self._lanes)

    # -- admission + quarantine ------------------------------------

    # Quarantine keys beyond this are evicted oldest-first: a flood of
    # spoofed sources must not grow the breaker dict without bound.
    MAX_QUARANTINE_KEYS = 1024

    # Refused-peer records beyond this are evicted oldest-first: the
    # doctor needs the skewed peers NAMED, but a spoofed flood must
    # not grow the dict without bound.
    MAX_SKEW_PEERS = 64

    # A peer refused for version skew within this window answers the
    # same 426 from its record, BEFORE any decompression: a 426 is
    # deliberately not a quarantine strike (the peer is healthy, just
    # mid-rollout), so without this fence a version-stamp flood would
    # buy a full snappy decompress per frame forever — exactly the
    # cost class the malformed-frame breaker fences for garbage.
    # last_wall is NOT refreshed by throttled replies, so the window
    # expires one throttle period after the last DECODED refusal: a
    # flood pays at most one decompress per window, and a peer that
    # just upgraded waits at most this long to be decoded again.
    SKEW_THROTTLE_SECONDS = 1.0

    # -- version skew ----------------------------------------------

    def hello_headers(self) -> dict[str, str]:
        """The receiver's capability advertisement, attached to every
        ingest response (200/409/426 alike): the publisher's
        negotiation input. Header cost is a few dozen bytes against a
        snappy frame — cheaper than any scheme that makes the
        publisher ASK. The stamps are fixed at construction, so the
        per-frame cost is one dict copy (hoisted from four str()
        builds per response); a copy because two refusal
        paths attach Retry-After to the returned mapping."""
        hello = self._hello
        if hello is None:
            hello = self._hello = {
                HELLO_PROTO_MIN: str(self._proto_min),
                HELLO_PROTO_MAX: str(self._proto_max),
                HELLO_CAPS: str(CAPS_CURRENT),
                HELLO_BUILD: self._build,
            }
        return dict(hello)

    def _skew_response(self, version: int) -> tuple[int, bytes, dict]:
        """The one 426 refusal shape both the decoded path and the
        throttle fast path answer with — hello + Retry-After attached,
        so a refused peer always learns what WOULD be accepted."""
        headers = self.hello_headers()
        headers["Retry-After"] = "60"
        return (426,
                f"upgrade required: wire protocol v{version} outside "
                f"accepted range {self._proto_min}.."
                f"{self._proto_max}\n".encode(),
                headers)

    def _record_skew_peer(self, key: str, version: int) -> bool:
        """Upsert one refused-peer record (bounded, oldest evicted);
        True when this (key, version) pair is new — the journal-once
        signal. Caller holds _skew_lock."""
        record = self._skew_peers.get(key)
        fresh = record is None or record["version"] != version
        if record is None:
            if len(self._skew_peers) >= self.MAX_SKEW_PEERS:
                self._skew_peers.pop(next(iter(self._skew_peers)))
            record = {"version": version, "count": 0, "last_wall": 0.0}
            self._skew_peers[key] = record
        record["version"] = version
        record["count"] += 1
        record["last_wall"] = time.time()
        return fresh

    def _refuse_skew(self, key: str, version: int,
                     peer: str = "") -> tuple[int, bytes, dict]:
        """426-style refusal for an out-of-range wire version: counted,
        peer recorded for doctor --skew, journaled on the first sight
        of each (peer, version) — NOT per frame, a stuck straggler
        retries every push interval for hours. ``peer`` (when it names
        an address distinct from ``key``) gets its own record so the
        pre-decode throttle covers source-keyed refusals too — the
        count rides the primary key alone."""
        with self._skew_lock:
            self.skew_refused_total += 1
            fresh = self._record_skew_peer(key, version)
            if peer and peer != key:
                # The address record makes the pre-decode throttle
                # cover source-keyed refusals too. Both records count
                # their own sightings (doctor lists both; the overall
                # tally is skew_refused_total, counted once above).
                self._record_skew_peer(peer, version)
        if fresh and self._tracer is not None:
            self._tracer.event(
                "skew_refused",
                f"{key}: refused wire protocol v{version} (this hub "
                f"accepts {self._proto_min}..{self._proto_max}) — "
                f"version skew; see doctor --skew",
                source=key)
        return self._skew_response(version)

    def _skew_throttled(self, key: str) -> tuple[int, bytes,
                                                 dict] | None:
        """Pre-decode fast path: a peer refused for skew TWICE within
        the throttle window answers its recorded 426 (counted, hello
        attached) for a dict lookup — no decompression. The first
        retry after a refusal always decodes: _send_frame renegotiates
        off the 426's hello and re-POSTs inside the same push, and
        that recovery frame may now be in range — throttling it would
        convert the documented one-round-trip recovery into a deferred
        push. None when decode should proceed. last_wall is
        deliberately not refreshed here (see SKEW_THROTTLE_SECONDS)."""
        with self._skew_lock:
            record = self._skew_peers.get(key)
            if record is None or record["count"] < 2 or (
                    time.time() - record["last_wall"]
                    >= self.SKEW_THROTTLE_SECONDS):
                return None
            self.skew_refused_total += 1
            record["count"] += 1
            version = record["version"]
        return self._skew_response(version)

    def _count_shed(self, reason: str) -> None:
        with self._shed_lock:
            self._shed[reason] = self._shed.get(reason, 0) + 1

    @property
    def shed_total(self) -> dict[str, int]:
        with self._shed_lock:
            return dict(self._shed)

    @property
    def quarantined(self) -> int:
        """Keys currently refused at the door (open breakers) — the
        kts_ingest_quarantined gauge."""
        with self._quarantine_lock:
            breakers = list(self._quarantine.values())
        return sum(1 for breaker in breakers if breaker.state != CLOSED)

    def _quarantine_blocked(self, key: str) -> bool:
        """True when ``key`` is quarantined right now. allow() doubles
        as the recovery probe: after the quarantine window one frame is
        admitted, and its outcome (malformed again vs clean) decides
        whether the key stays out. No breaker is CREATED here — healthy
        traffic must stay a dict miss."""
        breaker = self._quarantine.get(key)
        return breaker is not None and not breaker.allow()

    def _record_malformed(self, keys) -> None:
        for key in keys:
            with self._quarantine_lock:
                breaker = self._quarantine.get(key)
                if breaker is None:
                    if len(self._quarantine) >= self.MAX_QUARANTINE_KEYS:
                        # Room is made only from CLOSED (healed or
                        # never-tripped) breakers, oldest first. A live
                        # quarantine is never evicted: a flood rotating
                        # >cap source names would otherwise push real
                        # offenders back into full parse work — and
                        # when the table is all live quarantines, the
                        # new key goes untracked rather than freeing
                        # one (rotating sources never reach the
                        # threshold anyway; the OPEN ones are the
                        # protection worth keeping).
                        victim = next(
                            (k for k, b in self._quarantine.items()
                             if b.state == CLOSED), None)
                        if victim is None:
                            continue
                        del self._quarantine[victim]
                    breaker = CircuitBreaker(
                        f"ingest:{key}",
                        failure_threshold=self._quarantine_threshold,
                        recovery_time=self._quarantine_window)
                    if self._tracer is not None:
                        def _journal(b, old, new, key=key):
                            if new == OPEN:
                                self._tracer.event(
                                    "ingest_quarantine",
                                    f"{key}: quarantined for "
                                    f"{self._quarantine_window:g}s after "
                                    f"repeated malformed frames",
                                    source=key)
                        breaker.on_transition = _journal
                    self._quarantine[key] = breaker
            breaker.record_failure("malformed frame")

    def _absolve(self, keys) -> None:
        """A clean frame clears its keys' malformed streaks (and closes
        a half-open probe). Only touches breakers that already exist —
        the healthy path stays allocation-free."""
        for key in keys:
            breaker = self._quarantine.get(key)
            if breaker is not None and (breaker.consecutive_failures
                                        or breaker.state != CLOSED):
                breaker.record_success()

    def _session_established(self, source: str) -> bool:
        lane = self._lanes[lane_of(source, len(self._lanes))]
        return source in lane.sessions or source in self._pending_replay

    def _refresh_acct_verdict(self) -> None:
        self._acct_live()

    def _acct_live(self) -> bool:
        """Generation-checked admission verdict: True when an
        accountant is wired AND any knob is on. The common case (knobs
        off) costs one attribute read + int compare per frame; a knob
        write bumps the accountant's config_gen and refreshes the
        verdict on the very next frame."""
        acct = self._accountant
        if acct is None:
            return False
        gen = acct.config_gen
        if gen != self._acct_gen:
            self._acct_gen = gen
            self._acct_on = acct.enabled
        return self._acct_on

    def _admit(self, frame: Frame) -> tuple[tuple | None, bool]:
        """(shed verdict or None, in-flight slot acquired). Shed order
        is the survival contract: chatty sources' DELTAs go first (429 —
        one re-diff recovers them for free), concurrency pressure sheds
        DELTAs before FULLs (the reserve), and only NEW sessions are
        refused by the memory fence — an established session is never
        turned away for pressure, because refusing its recovery FULL
        converts one shed into a repeating 409 storm."""
        if frame.kind == KIND_DELTA:
            bucket = self._lanes[lane_of(frame.source,
                                         len(self._lanes))].bucket
            if bucket is not None and not bucket.try_take():
                self._count_shed("delta_rate")
                retry = max(0.1, bucket.retry_after())
                return (429, b"shed: delta rate over lane budget\n",
                        {"Retry-After": f"{retry:.1f}"}), False
        acquired = False
        if self._max_inflight:
            limit = self._max_inflight
            if frame.kind == KIND_DELTA:
                limit -= self._inflight_reserve
            with self._inflight_lock:
                if self._inflight < limit:
                    self._inflight += 1
                    acquired = True
            if not acquired:
                self._count_shed("inflight")
                code = 503 if frame.kind == KIND_FULL else 429
                return (code, b"shed: ingest at the in-flight budget\n",
                        {"Retry-After": "1"}), False
        if (frame.kind == KIND_FULL and self._max_sessions
                and not self._session_established(frame.source)
                and sum(len(lane.sessions) for lane in self._lanes)
                >= self._max_sessions):
            if acquired:
                with self._inflight_lock:
                    self._inflight -= 1
            self._count_shed("memory")
            return (503, b"shed: session table at the memory fence\n",
                    {"Retry-After": "15"}), False
        # Cardinality hard-cap pre-parse fence: a NEW
        # source's FULL cannot be admitted while the series ledger is
        # full, so refuse it before the multi-millisecond parse — a
        # label-bomb flood costs a comparison per frame. Established
        # sources pass: their replace/clamp verdict needs the parsed
        # series count (apply() owns it), and refusing their recovery
        # FULL would convert one shed into a 409 storm.
        if (frame.kind == KIND_FULL and self._acct_live()
                and not self._session_established(frame.source)
                and self._accountant.at_hard_cap()):
            if acquired:
                with self._inflight_lock:
                    self._inflight -= 1
            self._accountant.count_shed(frame.source, "hard_cap")
            return (413, b"shed: series hard cap\n",
                    {"Retry-After": "30"}), False
        return None, acquired

    # -- write side (HTTP POST threads) --------------------------------------

    def handle(self, wire: bytes,
               peer: str = "") -> tuple[int, bytes, dict]:
        """HTTP-facing apply: (status code, response body, response
        headers). 200 applied, 409 resync required, 400 malformed, and
        the shed classes — 429/503 with Retry-After (refused at
        admission, definitely unapplied; the publisher defers and
        re-diffs) — the contract the publisher keys on. ``peer`` is the
        client address when the caller knows it: it keys the
        quarantine check BEFORE any decode work, so a corrupt-frame
        flood costs a dict lookup per frame, not a parse."""
        peer_key = f"peer:{peer}" if peer else None
        if peer_key is not None and self._quarantine_blocked(peer_key):
            self._count_shed("quarantined")
            return (429, b"quarantined: repeated malformed frames\n",
                    {"Retry-After": f"{self._quarantine_window:g}"})
        if peer:
            # Version-skew fast fence (same spirit as the quarantine
            # check above, gentler verdict): a peer refused within the
            # throttle window re-draws its 426 before any decode work,
            # so a skewed flood costs a dict lookup per frame — a
            # healthy co-NAT'd pusher caught by the shared address is
            # deferred (not failed) for at most one window.
            throttled = self._skew_throttled(peer)
            if throttled is not None:
                return throttled
        try:
            frame = decode_frame(wire)
        except FrameVersionSkew as exc:
            # NOT a malformed-frame strike: the peer is a healthy
            # exporter from another rollout wave. Keyed on the peer
            # address (the frame may be undecodable past the header,
            # so the source is untrustworthy) — the refusal carries
            # this hub's hello so the publisher can renegotiate.
            return self._refuse_skew(peer or "unknown-peer", exc.version)
        except ValueError as exc:
            self._record_malformed([peer_key] if peer_key else [])
            return 400, f"bad delta frame: {exc}\n".encode(), {}
        if not self._proto_min <= frame.proto <= self._proto_max:
            # Decodable, but outside THIS hub's accepted window — a
            # census-gated --ingest-proto-min floor refusing a
            # straggler, or a sim playing an old hub. The frame
            # decoded, so key the refusal on the honest source name;
            # the peer address rides along so the pre-decode throttle
            # fences repeats of THIS class too.
            return self._refuse_skew(frame.source, frame.proto,
                                     peer=peer)
        source_key = "source:" + frame.source
        if self._quarantine_blocked(source_key):
            self._count_shed("quarantined")
            return (429, b"quarantined: repeated malformed frames\n",
                    {"Retry-After": f"{self._quarantine_window:g}"})
        verdict, acquired = self._admit(frame)
        if verdict is not None:
            return verdict
        try:
            self.apply(frame, len(wire))
        except ResyncRequired as exc:
            # A 409 is protocol-honest traffic (well-formed frame, seq
            # chain disagreement) — it clears malformed streaks and
            # closes a half-open quarantine probe just like a 200, or a
            # recovering peer whose first frame drew a resync would
            # stay quarantined one extra window.
            self._absolve([k for k in (peer_key, source_key) if k])
            # The hello rides the 409 too: a publisher recovering into
            # a freshly-upgraded hub learns the new range on the very
            # response that triggers its FULL, so the resync frame can
            # already ride the negotiated version.
            return (409, f"resync required: {exc}\n".encode(),
                    self.hello_headers())
        except CardinalityShed as exc:
            # Series hard cap: protocol-honest traffic — the
            # frame was well-formed, the ledger is just full. Absolve
            # like a 409 (a recovering peer's first frame must not stay
            # quarantined), answer 413 + Retry-After: the publisher
            # defers exactly like a 429 (the frame never touched
            # session state, so the acked diff base survives), and a
            # budget raise or an eviction re-admits the next FULL.
            self._absolve([k for k in (peer_key, source_key) if k])
            headers = self.hello_headers()
            headers["Retry-After"] = f"{exc.retry_after:g}"
            return 413, f"shed: {exc}\n".encode(), headers
        except ValueError as exc:  # unparseable FULL body
            # The frame DECODED, so the source identity is reliable —
            # quarantine that alone, never the peer: many pushers share
            # one client IP behind a NAT/service mesh, and keying a
            # parse failure on the address would collateral-quarantine
            # every healthy pusher beside the bad one. (The peer key is
            # reserved for undecodable garbage, where nothing better
            # exists — and even there a healthy frame from the same
            # address resets the streak before it trips.)
            self._record_malformed([source_key])
            return 400, f"bad delta frame: {exc}\n".encode(), {}
        finally:
            if acquired:
                with self._inflight_lock:
                    self._inflight -= 1
        self._absolve([k for k in (peer_key, source_key) if k])
        # Every accepted frame's response is a hello: a few
        # dozen header bytes buy the publisher a zero-round-trip
        # upgrade path — its first v1 FULL's 200 already names the
        # common maximum, so the session's deltas ride the negotiated
        # version from frame two.
        return 200, b"ok\n", self.hello_headers()

    def _route(self, source: str) -> tuple[_Lane, dict]:
        """(lane, entry mapping) for a source — the source is hashed
        ONCE per frame: when the entry store is a LaneStore sharded
        like the session lanes (the hub wiring), the lane's shard dict
        is returned directly instead of re-hashing through the store's
        routing on every get/set."""
        index = lane_of(source, len(self._lanes))
        store = self._entry_store
        if isinstance(store, LaneStore) and \
                len(store.shards) == len(self._lanes):
            return self._lanes[index], store.shards[index]
        return self._lanes[index], store

    def _resync(self, lane: _Lane, source: str,
                reason: str) -> ResyncRequired:
        lane.resyncs += 1
        if self._tracer is not None:
            self._tracer.event("delta_resync", f"{source}: {reason}",
                               source=source)
        return ResyncRequired(reason)

    def apply(self, frame: Frame, nbytes: int) -> None:
        if self._pending_replay:
            # Warm restart, on-demand half: the first frame from a
            # checkpointed source replays that source's session inline
            # (one parse, spread over the handler threads exactly like
            # normal FULL traffic) so its DELTA applies instead of
            # 409ing — the background replay thread sweeps up sources
            # that haven't pushed yet. A FULL supersedes the
            # checkpoint: the publisher's live state is fresher.
            with self._replay_lock:
                record = self._pending_replay.pop(frame.source, None)
            if record is not None and frame.kind != KIND_FULL:
                self._replay_one(frame.source, record)
        start = time.perf_counter()
        # The expensive halves of a FULL — tokenizing the body and
        # building the entry's derived views — run BEFORE the lock: a
        # resync storm (every publisher re-POSTing a FULL after a hub
        # restart) must not convoy N handler threads behind one
        # multi-millisecond parse. With sharded lanes the storm also
        # spreads the post-parse session work over the lane locks.
        entry = None
        admitted_full = -1
        offered_full = 0
        acct_on = self._acct_live()
        if frame.kind == KIND_FULL:
            series = parse_exposition_interned(frame.body)
            offered_full = len(series)
            if acct_on:
                # Cardinality admission, pre-lock like the
                # parse (the budgets are static scalars): clamp the
                # FULL to its admitted prefix — series are born in body
                # order, so the prefix keeps slot indexing stable and
                # the source's DELTAs for admitted slots still apply.
                # Past the hard cap a frame that would GROW the ledger
                # from nothing raises CardinalityShed -> 413.
                admitted_full = self._accountant.admit(frame.source,
                                                       offered_full)
                series = clamp_series(series, admitted_full)
            if self._entry_factory is not None:
                entry = self._entry_factory(series)
        lane, store = self._route(frame.source)
        # The pre-lock span (parse + entry build) is real work; the
        # LOCK WAIT is not — timing across the acquire would inflate
        # kts_ingest_lane_apply_seconds_total by the queueing delay
        # exactly when contention makes the metric matter, and its
        # documented "summed rate = ingest CPU share" reading would
        # mis-trigger the scaling runbook.
        pre_lock_seconds = time.perf_counter() - start
        with lane.lock:
            locked_start = time.perf_counter()
            try:
                self._apply_locked(lane, store, frame, nbytes, entry)
            finally:
                # Accumulated under the lane lock (a plain += would race
                # another handler thread exiting the same lane): the
                # kts_ingest_lane_apply_seconds_total source — what the
                # handler threads actually cost, parse included, lock
                # wait excluded.
                lane.apply_seconds += (pre_lock_seconds
                                      + time.perf_counter() - locked_start)
        if self._accountant is not None:
            # Ledger update AFTER the lane lock released (the
            # accountant's lock is a leaf — never held across lane
            # work): a FULL replaced the source's footprint, a DELTA
            # stamps the idle clock. A raised resync skips both. With
            # every knob off (acct_on False) the install still runs —
            # the ledger powers kts_series_live either way — but the
            # per-DELTA idle-clock stamp is skipped: nothing evicts
            # without a watermark, so the stamp is pure per-frame tax.
            if frame.kind == KIND_FULL:
                self._accountant.install(
                    frame.source, admitted_full if admitted_full >= 0
                    else offered_full, len(frame.body),
                    kind="push",
                    clamped=0 <= admitted_full < offered_full)
            elif acct_on:
                self._accountant.touch(frame.source)

    def _apply_locked(self, lane: _Lane, store: dict, frame: Frame,
                      nbytes: int, entry) -> None:
        lane.bytes += nbytes
        session = lane.sessions.get(frame.source)
        if session is not None:
            # Fleet version census: every frame refreshes
            # the session's observed wire state; a capability frame's
            # build extension names the publisher build (most v2
            # frames omit it — announce-once — so keep the last
            # answer), while a v1 frame CLEARS it: a publisher rolled
            # back to a pre-capability build must not stay listed
            # under its new-build census entry forever, or the
            # operator could never confirm the rollback landed.
            session.proto = frame.proto
            session.caps = frame.caps
            if frame.build:
                session.build = frame.build
            elif frame.proto < 2:
                session.build = ""
        if frame.kind == KIND_FULL:
            if session is None:
                session = _Session(frame.source, next(self._order))
                session.proto = frame.proto
                session.caps = frame.caps
                session.build = frame.build
                lane.sessions[frame.source] = session
            elif (session.generation == frame.generation
                    and frame.seq == session.seq and session.frames):
                # Retransmit of an already-counted FULL: the publisher's
                # response was lost (timeout on a flaky link), so it
                # cannot know the frame landed and must re-send. Apply
                # it (idempotent replace — the re-encoded body may even
                # be fresher) but never re-count: a spill drain across
                # a flap must produce an exactly-once RECORD even when
                # the wire is at-least-once.
                session.stamp(time.monotonic())
                lane.dup_frames += 1
                if entry is not None:
                    store[frame.source] = entry
                return
            elif session.generation not in (0, frame.generation):
                # A worker restarted with a new generation: the FULL
                # replaces everything, but journal the restart — the
                # stale seq chain dies HERE, visibly.
                if self._tracer is not None:
                    self._tracer.event(
                        "delta_restart",
                        f"{frame.source}: new generation "
                        f"{frame.generation} (was {session.generation})",
                        source=frame.source)
            session.generation = frame.generation
            session.seq = frame.seq
            session.stamp(time.monotonic())
            session.frames += 1
            lane.full_frames += 1
            if entry is not None:
                store[frame.source] = entry
            return
        if session is None:
            raise self._resync(
                lane, frame.source,
                "no session state (hub restarted or source evicted)")
        entry = store.get(frame.source)
        if (entry is None or not getattr(entry, "pushed", False)
                or entry.series is None):
            # The entry fell out from under the session (evicted on
            # churn, or a pull fallback replaced it): only a FULL
            # can re-anchor slot indexing.
            raise self._resync(
                lane, frame.source,
                "no ingest entry for this session (evicted or "
                "replaced by a pull)")
        if frame.generation != session.generation:
            raise self._resync(
                lane, frame.source,
                f"generation mismatch (session {session.generation}, "
                f"frame {frame.generation})")
        if frame.seq != session.seq + 1:
            raise self._resync(
                lane, frame.source,
                f"seq gap (session at {session.seq}, frame {frame.seq})")
        n = len(entry.series)
        slots, values = frame.slots, frame.values
        overflow = 0
        if self._acct_on and self._accountant.is_clamped(frame.source):
            # Clamped source: the publisher's slot space is
            # its FULL series set, ours is the admitted prefix — slots
            # past the prefix are the *dropped* series' updates, not
            # corruption. Filter-and-count them instead of resyncing:
            # a resync here would loop forever (the next FULL clamps
            # identically) and re-parse the bomb every interval.
            kept = [(s, v) for s, v in zip(slots, values) if s < n]
            overflow = len(slots) - len(kept)
            if overflow:
                slots = [s for s, _ in kept]
                values = [v for _, v in kept]
        for slot in slots:
            if slot >= n:
                raise self._resync(
                    lane, frame.source, f"slot {slot} out of range ({n})")
        if slots:
            native_mod = self._native_mod
            if entry.apply_patch(slots, values, frame.source,
                                 native_mod=native_mod):
                # The extension faulted on this entry (apply_patch
                # patched the frame in Python): this instance goes back
                # to the Python path, visibly.
                self._native_mod = None
        if overflow:
            self._accountant.count_shed(frame.source, "source_budget",
                                        overflow)
        session.seq = frame.seq
        session.stamp(time.monotonic())
        session.frames += 1
        lane.delta_frames += 1

    # -- read side (hub refresh thread) --------------------------------------

    def sources(self) -> list[str]:
        """Live push sources (fleet-wide admission order — stable for
        the target merge, lane-independent), dropping sessions silent
        past the expiry window so a decommissioned worker eventually
        leaves the target list."""
        now = time.monotonic()
        ordered: list[tuple[int, str]] = []
        for lane in self._lanes:
            with lane.lock:
                dead = [s for s, session in lane.sessions.items()
                        if now - session.last_monotonic > self._expiry]
                for source in dead:
                    del lane.sessions[source]
                ordered.extend((session.order, source)
                               for source, session in lane.sessions.items())
        ordered.sort()
        return [source for _order, source in ordered]

    def fresh_sources(self, fence: float) -> list[str]:
        """Sources whose session produced a frame within ``fence``
        seconds — the targets this refresh serves from push state.
        Everything else falls through to the pull path."""
        now = time.monotonic()
        out: list[str] = []
        for lane in self._lanes:
            with lane.lock:
                out.extend(source
                           for source, session in lane.sessions.items()
                           if now - session.last_monotonic <= fence)
        return out

    def frame_gaps(self) -> dict[str, float]:
        """Last inter-arrival gap per live session, seconds — the
        push-path freshness signal: a pushed target
        pays no hub-side fetch, so scoring its 0.0 'scrape latency'
        would blind the fleet lens to a publisher falling behind; the
        frame gap is the honest equivalent. 0.0 until a session's
        second frame."""
        gaps: dict[str, float] = {}
        for lane in self._lanes:
            with lane.lock:
                for source, session in lane.sessions.items():
                    gaps[source] = session.last_gap
        return gaps

    def fleet_versions(self) -> dict[str, int]:
        """Version census over live sessions, the
        kts_fleet_version_count{version} source: keyed by the
        publisher build its v2 FULLs declared when known, else by the
        bare wire version ("wire-v1" — a pre-capability build), else
        "unknown" (a warm-restart replay whose publisher hasn't pushed
        since this hub started). On a federation root the leaf hubs ARE
        sessions here, so the census covers the whole re-export tree."""
        census: dict[str, int] = {}
        for lane in self._lanes:
            with lane.lock:
                for session in lane.sessions.values():
                    if session.build:
                        key = session.build
                    elif session.proto:
                        key = f"wire-v{session.proto}"
                    else:
                        key = "unknown"
                    census[key] = census.get(key, 0) + 1
        return census

    # Downgraded-peer names listed verbatim in skew_status() are capped;
    # past this the list carries a count, not ten thousand URLs.
    MAX_SKEW_NAMES = 32

    def skew_status(self) -> dict:
        """The receiver's half of the version-skew picture:
        what this hub accepts, the live fleet version census, every
        refused peer (bounded, with the version it offered), and the
        sessions still riding a wire version below this hub's maximum
        (the not-yet-upgraded stragglers a census-gated rollout watches)
        — the hub's /debug/skew payload and doctor --skew's evidence."""
        downgraded: list[dict] = []
        extra = 0
        for lane in self._lanes:
            with lane.lock:
                for source, session in lane.sessions.items():
                    if 0 < session.proto < self._proto_max:
                        if len(downgraded) < self.MAX_SKEW_NAMES:
                            downgraded.append({
                                "source": source,
                                "proto": session.proto,
                                "build": session.build,
                            })
                        else:
                            extra += 1
        with self._skew_lock:
            peers = {key: dict(record)
                     for key, record in self._skew_peers.items()}
            refused = self.skew_refused_total
        return {
            "build": self._build,
            "proto_min": self._proto_min,
            "proto_max": self._proto_max,
            "caps": CAPS_CURRENT,
            "fleet_versions": self.fleet_versions(),
            "skew_refused_total": refused,
            "refused_peers": peers,
            "downgraded_sessions": downgraded,
            "downgraded_sessions_truncated": extra,
        }

    def evict(self, alive: set) -> None:
        """Drop sessions for departed targets on the same refresh path
        that evicts their _TargetCache entries — a worker restarting
        behind a churned target list must start from a FULL resync, not
        a stale seq chain."""
        for lane in self._lanes:
            with lane.lock:
                for source in [s for s in lane.sessions
                               if s not in alive]:
                    del lane.sessions[source]

    def stats(self) -> dict[str, float]:
        return {
            "full_frames": self.full_frames_total,
            "delta_frames": self.delta_frames_total,
            "duplicate_frames": self.duplicate_frames_total,
            "bytes": self.bytes_total,
            "resyncs": self.resyncs_total,
            "sessions": sum(len(lane.sessions) for lane in self._lanes),
            "quarantined": self.quarantined,
            "shed": sum(self.shed_total.values()),
            "warm_restart_pending": len(self._pending_replay),
            "skew_refused": self.skew_refused_total,
        }

    # -- warm restart: WAL checkpoint + replay ---------------------

    # v2 appends each session record's observed wire state
    # (proto, caps, build) so a restarted hub's fleet version census
    # survives the restart. v1 records (5 fields) still load — the
    # wire state defaults to unknown until the publisher's next frame
    # stamps the truth — and a v1 build confronted with a v2 file
    # quarantines it aside intact (wal.read_state's refuse-don't-
    # corrupt rule) instead of corrupting it.
    CHECKPOINT_VERSION = 2

    @staticmethod
    def _render_series(series) -> str:
        """Serialize an entry's current series state back to exposition
        text — the checkpoint's entry encoding, chosen so replay runs
        through parse_exposition_interned exactly like a FULL frame
        (one code path, one set of intern pools; the replayed entry can
        never diverge from what a live FULL of the same values would
        have built)."""
        from . import schema
        from .registry import format_value

        return "\n".join(
            name + schema.render_labels(labels) + " " + format_value(value)
            for name, labels, value in series) + "\n"

    @property
    def replaying(self) -> bool:
        """True while checkpointed sessions are still waiting for
        replay — the hub's /readyz holds NotReady on this (scrapers
        drain to a fully-resumed hub) while /healthz stays live."""
        return bool(self._pending_replay)

    @property
    def warm_restart_pending(self) -> int:
        return len(self._pending_replay)

    def checkpoint_age(self) -> float | None:
        """Seconds since the last successful checkpoint write; None
        when checkpointing is off or nothing has been written yet."""
        if not self._ckpt_path or not self._ckpt_last_write:
            return None
        return max(0.0, time.monotonic() - self._ckpt_last_write)

    def _capture_checkpoint(self) -> dict:
        """Snapshot every lane's sessions + pushed-entry series under
        the lane locks (one lane at a time — apply() mutates both under
        the same lock, so each record is internally consistent: a
        checkpoint taken between a session's FULL and its first DELTA
        replays to exactly the post-FULL seq). Serialization happens
        outside the locks; only list() copies happen inside."""
        raw: list[tuple] = []
        store = self._entry_store
        sharded = (isinstance(store, LaneStore)
                   and len(store.shards) == len(self._lanes))
        for index, lane in enumerate(self._lanes):
            shard = store.shards[index] if sharded else store
            with lane.lock:
                for source, session in lane.sessions.items():
                    entry = shard.get(source)
                    if (entry is None or not getattr(entry, "pushed", False)
                            or entry.series is None):
                        continue
                    raw.append((source, session.generation, session.seq,
                                session.order, list(entry.series),
                                session.proto, session.caps,
                                session.build))
        sessions = [
            [source, generation, seq, order,
             self._render_series(series), proto, caps, build]
            for source, generation, seq, order, series,
            proto, caps, build in raw
        ]
        # Sessions still AWAITING warm replay carry forward verbatim
        # (their records are already in checkpoint form): a checkpoint
        # written mid-replay — or a crash-loop of restarts — must never
        # shrink the fleet to the replayed-so-far fraction, or the
        # next start cold-409s exactly the sessions this file exists
        # to protect. A source both replayed and pending cannot exist
        # (the pending pop is the single hand-off), but the captured
        # set wins on any race.
        captured = {record[0] for record in sessions}
        with self._replay_lock:
            pending = list(self._pending_replay.items())
        for source, record in pending:
            if source not in captured:
                sessions.append([source, *record])
        self._ckpt_seq += 1
        return {
            "version": self.CHECKPOINT_VERSION,
            "wall": time.time(),
            "seq": self._ckpt_seq,
            "frames": self.full_frames_total + self.delta_frames_total,
            "sessions": sessions,
        }

    def checkpoint(self, force: bool = False) -> bool:
        """Write-ahead persist (the energy.py discipline verbatim: full
        state to ``<path>.wal``, fsync, atomic rename over ``<path>``).
        Called from the hub's refresh thread — never a handler thread —
        and rate-limited to the checkpoint interval unless forced
        (clean shutdown forces a final write so a drain-and-restart
        loses nothing at all)."""
        if not self._ckpt_path:
            return False
        with self._ckpt_io_lock:
            now = time.monotonic()
            frames = self.full_frames_total + self.delta_frames_total
            if not force and (
                    frames == self._ckpt_frames_at_write
                    or now - self._ckpt_last_write < self._ckpt_interval):
                return False
            state = self._capture_checkpoint()
            # Shared write-ahead discipline (wal.py): .wal + fsync +
            # atomic rename — the same implementation the energy
            # checkpoint and the egress spill/exporter rings use.
            if not wal.write_state(self._ckpt_path, state, label="ingest"):
                return False
            self._ckpt_last_write = now
            self._ckpt_frames_at_write = frames
            self.checkpoint_writes += 1
            return True

    def _load_checkpoint(self) -> None:
        """Synchronous index load at construction: cheap JSON only, no
        parses. Both candidates, newest write epoch wins — a crash
        between the wal's fsync and the rename leaves the newer state
        in the .wal (the shared wal.py recovery rule)."""
        state = wal.load_newest(self._ckpt_path, self.CHECKPOINT_VERSION,
                                label="ingest")
        # Resume the write epoch past BOTH candidates: this process's
        # first write must out-rank even the one not loaded, or a
        # later crash could resurrect it over newer fsynced state.
        # load_newest already returned the higher-seq candidate, so the
        # winner's seq IS the max across both — no second read pass.
        self._ckpt_seq = int(state.get("seq", 0)) if state is not None else 0
        if state is None:
            return
        if "sessions" not in state:
            # Pruned-keys tolerance: an older (or
            # hand-edited) checkpoint missing the sessions list loads
            # as empty with a warning, never a KeyError on the restart
            # path — the hub starts cold for those sessions, which is
            # exactly what no checkpoint would have meant.
            log.warning("ingest checkpoint has no 'sessions' key "
                        "(older build?); starting with no warm sessions")
        max_order = 0
        for record in state.get("sessions", ()):
            if len(record) < 5:
                log.warning("ingest checkpoint record %r too short; "
                            "skipping (that source pays one FULL "
                            "resync)", record[:1])
                continue
            # v1 records stop at the body; v2 appends (proto, caps,
            # build). Unknown FURTHER fields from a future minor are
            # ignored — forward tolerance, the same rule the wire
            # decoder applies to extension blocks.
            source, generation, seq, order, body = record[:5]
            proto = int(record[5]) if len(record) > 5 else 0
            caps = int(record[6]) if len(record) > 6 else 0
            build = str(record[7]) if len(record) > 7 else ""
            self._pending_replay[str(source)] = (
                int(generation), int(seq), int(order), str(body),
                proto, caps, build)
            max_order = max(max_order, int(order))
        self._order = itertools.count(max_order + 1)
        self.checkpoint_loaded = True
        self._replay_loaded_monotonic = time.monotonic()
        log.info("ingest checkpoint loaded: %d session(s) pending warm "
                 "replay", len(self._pending_replay))

    def _replay_one(self, source: str, record: tuple) -> None:
        """Rebuild one source's session + entry from its checkpoint
        record. Parse runs before the lane lock (the FULL-storm
        discipline); a session that already exists wins — a live FULL
        is always fresher than the checkpoint."""
        generation, seq, order, body, proto, caps, build = record
        series = parse_exposition_interned(body)
        entry = (self._entry_factory(series)
                 if self._entry_factory is not None else None)
        lane, store = self._route(source)
        with lane.lock:
            if source in lane.sessions:
                return
            session = _Session(source, order)
            session.generation = generation
            session.seq = seq
            # Census continuity across the restart: the
            # checkpointed wire state stands in until the publisher's
            # next frame re-stamps the truth.
            session.proto = proto
            session.caps = caps
            session.build = build
            # Stamped now, not at checkpoint time: the session is
            # fresh-for-one-fence-window so the first refresh after a
            # restart serves the checkpointed values (that is the warm
            # part) — the publisher's next delta lands before the
            # fence expires or the target falls back to pull.
            session.stamp(time.monotonic())
            lane.sessions[source] = session
            if entry is not None:
                store[source] = entry
        self.warm_restart_sessions += 1

    def start_replay(self) -> None:
        """Kick the background replay sweep (idempotent). On-demand
        replay in apply() races it safely: the pending dict pop is the
        single hand-off point, so each source replays exactly once."""
        if not self._pending_replay or (
                self._replay_thread is not None
                and self._replay_thread.is_alive()):
            return

        def sweep() -> None:
            while True:
                with self._replay_lock:
                    if not self._pending_replay:
                        break
                    source, record = next(iter(self._pending_replay.items()))
                    del self._pending_replay[source]
                try:
                    self._replay_one(source, record)
                except Exception:  # noqa: BLE001 - one bad record must
                    # not strand the rest of the fleet unreplayed.
                    log.warning("warm replay of %s failed", source,
                                exc_info=True)
            self.warm_restart_replay_seconds = (
                time.monotonic() - self._replay_loaded_monotonic)
            if self._tracer is not None:
                self._tracer.event(
                    "warm_restart",
                    f"warm restart: {self.warm_restart_sessions} "
                    f"session(s) replayed in "
                    f"{self.warm_restart_replay_seconds:.2f}s")

        self._replay_thread = spawn(sweep, name="ingest-replay")
        self._replay_thread.start()

    def lane_stats(self) -> list[dict[str, float]]:
        """Per-lane health for the kts_ingest_lane_* self-metrics: live
        sessions, frames applied, and cumulative handler-thread apply
        seconds. One snapshot per publish — a skewed sessions spread
        (every pusher in one lane) or one lane's apply_seconds running
        hot is the sharding-isn't-helping signal the runbook keys on."""
        out = []
        for lane in self._lanes:
            with lane.lock:
                out.append({
                    "sessions": float(len(lane.sessions)),
                    "frames": float(lane.full_frames + lane.delta_frames),
                    "resyncs": float(lane.resyncs),
                    "apply_seconds": lane.apply_seconds,
                })
        return out
