"""Node-side disk spill queue for the delta publisher.

The port's copy of the reference's queue, whose on-disk format it keeps
byte for byte: a ring spooled by one package drains in the other.

Without it, a daemon whose hub link is down drops every tick it
samples: the publisher's backoff stretches the push cadence, each
failed push loses that snapshot, and the fleet record grows a hole the
width of the partition. The spill queue closes the hole — while the
link is down, every published snapshot spools to a bounded on-disk ring
(the shared :mod:`wal` SegmentRing: CRC-framed segments, fsync per
record, torn tails truncated on recovery) with its publish wall time;
on reconnect the publisher drains the backlog OLDEST-FIRST through a
drain-rate token bucket (a recovering hub must never be stampeded by
its own returning fleet) and then resumes live deltas. A partition thus
produces a late-but-complete record instead of a gap, and a partition
longer than the spool bound loses oldest-first with the loss counted
(``kts_spill_dropped_total``) and journaled — bounded loss is only
acceptable when it is accounted.

Bodies spool snappy-compressed (the rendered exposition text is highly
compressible, so the spool grows by a fraction of the exposition's size
per publish)."""

from __future__ import annotations

import logging
import time

from . import snappy
from .wal import SegmentRing

log = logging.getLogger(__name__)

DEFAULT_MAX_BYTES = 64 * 1024 * 1024

# Spill record payload format, stamped into every segment's
# container header: v1 = one snappy-compressed rendered exposition
# body per record. The DRAIN owns wire-version compatibility — bodies
# re-encode through the publisher's live encoder at whatever version
# the hub negotiated at drain time, so a spool written before an
# upgrade (or before a hub downgrade) replays correctly either way. A
# future-format segment is quarantined whole by the ring at recovery
# (renamed aside intact, outside the accounting), never fed to this
# decoder.
SPILL_FORMAT_VERSION = 1


class SpillQueue:
    """Bounded, crash-recoverable FIFO of (publish wall time, rendered
    exposition body) — DeltaPublisher's offline buffer. Single-writer
    (the publisher thread); ``status()`` snapshots are safe from HTTP
    handler threads (the ring's own lock)."""

    def __init__(self, directory: str, *,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 fsync: bool = True, tracer=None) -> None:
        self._ring = SegmentRing(directory, max_bytes=max_bytes,
                                 segment_bytes=min(1 << 20, max_bytes),
                                 prefix="spill", fsync=fsync,
                                 label="spill",
                                 format_version=SPILL_FORMAT_VERSION)
        self._tracer = tracer
        self.spooled_total = 0
        self.drained_total = 0
        # CRC-valid records that still failed every decode — consumed
        # without delivery, so the loss stays accounted: spooled ==
        # drained + dropped + undecodable + depth. Nonzero is surfaced
        # by doctor --egress with a version-skew hint.
        self.undecodable_total = 0
        # Old-format records recovered by re-encoding: a
        # record that decompresses to a raw v1/v2 WIRE FRAME (an older
        # build spooled encoded frames, not bodies) has its FULL body
        # extracted and re-enters the drain as a plain snapshot — the
        # publisher re-encodes it at the NEGOTIATED wire version
        # instead of counting it undecodable. Counted at COMMIT (the
        # record was delivered), not at peek: a drain stalled on a
        # down/shedding hub re-peeks the same head every probe cycle,
        # and per-peek counting would inflate the metric by the retry
        # count.
        self.reencoded_total = 0
        self._head_reencoded = False
        # (record, re-encoded?, body) of the last head peek decoded. A
        # drain probing a down hub peeks the same head every cycle; the
        # ring hands back the same record object until it is committed,
        # so the decode (a pure-Python snappy pass) is paid once.
        self._head: tuple | None = None
        if self._ring.records_pending():
            # A restart with a backlog on disk resumes the drain where
            # the dead process stopped (minus the at-least-once cursor
            # window) — the crash-mid-partition case.
            log.info("spill queue: %d frame(s) recovered from disk",
                     self._ring.records_pending())

    @property
    def dropped_total(self) -> int:
        """Frames lost oldest-first to the byte bound — the counted,
        journaled data-loss number the partition sim pins."""
        return self._ring.evicted_records

    @property
    def torn_total(self) -> int:
        return self._ring.torn_records

    def spool(self, ts: float, body: str) -> int:
        """Durably append one snapshot; returns (and journals) how many
        OLDEST frames were evicted to stay under the bound."""
        dropped = self._ring.append(ts, snappy.compress(body.encode()))
        self.spooled_total += 1
        if dropped and self._tracer is not None:
            self._tracer.event(
                "spill_drop",
                f"spill queue over its byte bound: dropped {dropped} "
                f"oldest frame(s) (kts_spill_dropped_total "
                f"{self.dropped_total})")
        return dropped

    def peek(self) -> tuple[float, str] | None:
        """Oldest unsent (ts, body) — send first, :meth:`commit` after
        the hub acked, so a crash mid-drain re-sends rather than loses.
        Records that somehow pass CRC but won't decode (version skew)
        are skipped with a warning — a loop, not recursion: a badly
        damaged spool must not blow the stack either."""
        while True:
            record = self._ring.peek()
            if record is None:
                return None
            ts, payload = record
            if self._head is not None and self._head[0] is record:
                self._head_reencoded = self._head[1]
                return ts, self._head[2]
            try:
                raw = snappy.decompress(payload)
            except ValueError as exc:
                self._drop_undecodable(exc)
                continue
            if raw[:4] == b"KTSD":
                body = self._recover_wire_frame(raw)
                if body is not None:
                    self._head_reencoded = True
                    self._head = (record, True, body)
                    return ts, body
                self._drop_undecodable(
                    ValueError("spooled wire frame carries no "
                               "recoverable FULL body"))
                continue
            self._head_reencoded = False
            try:
                body = raw.decode()
            except UnicodeDecodeError as exc:
                # Drop it rather than wedge the drain forever on one
                # frame — counted, never silent (the accounting
                # invariant the partition sim pins).
                self._drop_undecodable(exc)
                continue
            self._head = (record, False, body)
            return ts, body

    @staticmethod
    def _recover_wire_frame(raw: bytes) -> str | None:
        """Old-format spool records: a build that spooled
        ENCODED wire frames instead of bodies left snappy'd KTSD
        frames in the ring. A FULL frame still carries the complete
        rendered body — extract it, and the drain re-encodes it at the
        negotiated wire version (the publisher's encoder owns that).
        ``raw`` is the record ALREADY decompressed (the caller's magic
        sniff paid the snappy pass; decode_frame_raw must not pay a
        second one). None for anything else: a standalone DELTA has no
        base to apply against (its data rides the next FULL's resync),
        and garbage stays undecodable."""
        from . import delta

        try:
            frame = delta.decode_frame_raw(raw)
        except ValueError:  # FrameVersionSkew included
            return None
        if frame.kind == delta.KIND_FULL and frame.body:
            return frame.body
        return None

    def _drop_undecodable(self, exc: Exception) -> None:
        log.warning("spill queue: dropping undecodable frame "
                    "(version skew? see doctor --skew): %s", exc)
        self.undecodable_total += 1
        self._ring.commit()

    def commit(self) -> None:
        self._ring.commit()
        self.drained_total += 1
        if self._head_reencoded:
            # The recovered old-format record was actually DELIVERED
            # (at the negotiated wire version) — count it now, once.
            self.reencoded_total += 1
            self._head_reencoded = False

    def save_cursor(self, force: bool = False) -> None:
        self._ring.save_cursor(force)

    def depth(self) -> int:
        return self._ring.records_pending()

    def bytes_pending(self) -> int:
        return self._ring.bytes_pending()

    def oldest_age(self, now: float | None = None) -> float:
        """Seconds the oldest spooled frame has waited (0 when empty) —
        the 'how far behind is this node's record' gauge."""
        oldest = self._ring.oldest_ts()
        if oldest is None:
            return 0.0
        return max(0.0, (now if now is not None else time.time()) - oldest)

    def status(self) -> dict:
        ring = self._ring.status()
        return {
            "depth_frames": ring["records"],
            "bytes": ring["bytes"],
            "max_bytes": ring["max_bytes"],
            "oldest_age_seconds": round(self.oldest_age(), 3),
            "spooled_total": self.spooled_total,
            "drained_total": self.drained_total,
            "dropped_total": self.dropped_total,
            "undecodable_total": self.undecodable_total,
            "reencoded_total": self.reencoded_total,
            "torn_total": self.torn_total,
            # Version-skew surfaces: future-format segments
            # parked intact at recovery + this writer's payload format
            # + pre-versioning segments still in the ring.
            "skew_segments_total": ring["skew_segments_total"],
            "format_version": ring["format_version"],
            "legacy_segments": ring["legacy_segments"],
            # Durability state machine: degraded/healthy +
            # fault/loss ledger, for /debug/stores + doctor --stores.
            "health": ring["health"],
        }

    def close(self) -> None:
        self._ring.close()
