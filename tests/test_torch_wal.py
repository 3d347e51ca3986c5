"""The port's WAL stores against the JAX package's.

Every case of ``tests/test_wal.py`` that is about ``wal.py`` itself, and
the ``StoreHealth``/``write_state``/``SegmentRing`` cases of
``tests/test_localfault.py``, run here once per package: the
reference's ``wal`` under the reference's ``FaultFS``, the port's
``wal`` under the port's. Then the two packages against each other on
the same inputs: a state file or a ring written by either reads back
identically in the other and the bytes on disk are the same; quarantine
asides are byte-identical; and under either package's ``FaultFS``
(ENOSPC, EIO, EROFS, EMFILE) the two stores step through the same
``StoreHealth`` states with the same ``lost_records``.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import struct
import types
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from kube_gpu_stats_tpu import wal as ref_wal
from kube_gpu_stats_tpu.testing import faultfs as ref_faultfs
from kube_gpu_stats_tpu_torch import wal as port_wal
from kube_gpu_stats_tpu_torch.testing import faultfs as port_faultfs

PACKAGES = {
    "reference": types.SimpleNamespace(wal=ref_wal, faultfs=ref_faultfs),
    "port": types.SimpleNamespace(wal=port_wal, faultfs=port_faultfs),
}
WALS = (ref_wal, port_wal)


class FakeTracer:
    enabled = True

    def __init__(self):
        self.events = []

    def event(self, kind, detail="", **attrs):
        self.events.append({"kind": kind, "detail": detail, **attrs})


@pytest.fixture(autouse=True)
def clean_registries():
    """Both packages' store, quarantine and journal registries are
    process-global; every case starts and ends with them empty."""
    for module in WALS:
        module.reset_store_stats()
        module.reset_quarantine_stats()
        module.set_journal(None)
    yield
    for module in WALS:
        module.reset_store_stats()
        module.reset_quarantine_stats()
        module.set_journal(None)
        module.set_probe_interval(5.0)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture
def fast_probe():
    """Every degraded op probes immediately (tests can't wait 5 s)."""
    for module in WALS:
        module.set_probe_interval(0.0)


# -- atomic JSON state, each package on its own --------------------------

def test_write_then_load_roundtrip(tmp_path, pkg):
    wal = pkg.wal
    path = str(tmp_path / "state.json")
    assert wal.write_state(path, {"version": 1, "seq": 3, "x": [1, 2]})
    assert wal.load_newest(path, 1) == {"version": 1, "seq": 3, "x": [1, 2]}
    assert not os.path.exists(path + ".wal")


def test_crash_between_fsync_and_rename_recovers_from_wal(tmp_path, pkg):
    wal = pkg.wal
    path = str(tmp_path / "state.json")
    wal.write_state(path, {"version": 1, "seq": 5, "value": "old"})
    (tmp_path / "state.json.wal").write_text(
        json.dumps({"version": 1, "seq": 6, "value": "new"}))
    assert wal.load_newest(path, 1)["value"] == "new"
    assert wal.newest_seq(path, 1) == 6


def test_older_wal_never_shadows_newer_main(tmp_path, pkg):
    wal = pkg.wal
    path = str(tmp_path / "state.json")
    wal.write_state(path, {"version": 1, "seq": 9, "value": "current"})
    (tmp_path / "state.json.wal").write_text(
        json.dumps({"version": 1, "seq": 2, "value": "stale"}))
    assert wal.load_newest(path, 1)["value"] == "current"
    assert wal.newest_seq(path, 1) == 9


@pytest.mark.parametrize("garbage", [b"", b"{", b"[1,2]", b"\x00\xff" * 40,
                                     b'{"version": 99, "seq": 1}'])
def test_garbage_and_wrong_version_ignored(tmp_path, pkg, garbage):
    path = str(tmp_path / "state.json")
    (tmp_path / "state.json").write_bytes(garbage)
    assert pkg.wal.load_newest(path, 1) is None
    assert pkg.wal.newest_seq(path, 1) == 0


def test_torn_main_with_good_wal_recovers(tmp_path, pkg):
    path = str(tmp_path / "state.json")
    (tmp_path / "state.json").write_text('{"version": 1, "se')
    (tmp_path / "state.json.wal").write_text(
        json.dumps({"version": 1, "seq": 4, "value": "ok"}))
    assert pkg.wal.load_newest(path, 1)["value"] == "ok"


def test_unwritable_path_returns_false_not_raise(tmp_path, pkg):
    target = tmp_path / "dir"
    target.mkdir()
    assert not pkg.wal.write_state(str(target), {"version": 1, "seq": 1})


def test_write_state_refuses_unstamped_dict(tmp_path, pkg):
    with pytest.raises(ValueError, match="version"):
        pkg.wal.write_state(str(tmp_path / "state.json"), {"seq": 1})


def test_read_state_loads_older_format_with_defaults(tmp_path, pkg):
    path = tmp_path / "state.json"
    path.write_text(json.dumps({"version": 1, "seq": 4}))
    assert pkg.wal.read_state(str(path), 3) == {"version": 1, "seq": 4}
    assert path.exists()


def test_read_state_quarantines_future_major_byte_identical(tmp_path, pkg):
    wal = pkg.wal
    path = tmp_path / "state.json"
    raw = json.dumps({"version": 7, "seq": 9,
                      "field_from_the_future": [1, 2]}).encode()
    path.write_bytes(raw)
    assert wal.read_state(str(path), 2, label="teststore") is None
    assert not path.exists()
    assert (tmp_path / "state.json.skew-v7").read_bytes() == raw
    assert wal.quarantine_counts() == {"teststore": 1}
    assert wal.quarantine_events()[-1]["version"] == 7


def test_read_state_quarantine_never_overwrites_prior_park(tmp_path, pkg):
    path = tmp_path / "state.json"
    for marker in ("first", "second"):
        path.write_text(json.dumps({"version": 9, "m": marker}))
        assert pkg.wal.read_state(str(path), 1) is None
    parked = sorted(p.name for p in tmp_path.glob("state.json.skew-v9*"))
    assert parked == ["state.json.skew-v9", "state.json.skew-v9.1"]


def test_read_state_nonint_version_is_garbage_not_skew(tmp_path, pkg):
    path = tmp_path / "state.json"
    for stamp in ("2", None, True, -1, 0):
        path.write_text(json.dumps({"version": stamp}))
        assert pkg.wal.read_state(str(path), 2) is None
        assert path.exists()
    assert pkg.wal.quarantine_counts() == {}


# -- SegmentRing, each package on its own --------------------------------

def ring(wal, tmp_path, **kw):
    kw.setdefault("max_bytes", 1 << 20)
    kw.setdefault("segment_bytes", 256)
    kw.setdefault("fsync", False)
    return wal.SegmentRing(str(tmp_path / "ring"), **kw)


def drain(r) -> list[tuple[float, bytes]]:
    out = []
    while (record := r.peek()) is not None:
        out.append(record)
        r.commit()
    return out


def test_ring_fifo_roundtrip(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path)
    for i in range(10):
        assert r.append(float(i), f"payload-{i}".encode()) == 0
    assert r.records_pending() == 10
    assert r.oldest_ts() == 0.0
    assert [p for _t, p in drain(r)] == [f"payload-{i}".encode()
                                         for i in range(10)]
    assert r.records_pending() == 0


def test_ring_survives_restart(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path)
    for i in range(20):
        r.append(float(i), b"x" * 40)
    for _ in range(5):
        r.peek()
        r.commit()
    assert r.save_cursor(force=True)
    r.close()
    r2 = ring(pkg.wal, tmp_path)
    assert r2.records_pending() == 15
    assert r2.oldest_ts() == 5.0
    assert r2.torn_records == 0


def test_ring_unsaved_cursor_resends_at_least_once(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path)
    for i in range(4):
        r.append(float(i), b"p%d" % i)
    r.save_cursor(force=True)
    r.peek(), r.commit()
    del r
    assert ring(pkg.wal, tmp_path).records_pending() == 4


def test_ring_torn_tail_truncated_not_fatal(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path)
    for i in range(6):
        r.append(float(i), b"payload-%d" % i)
    r.close()
    segs = sorted((tmp_path / "ring").glob("*.seg"))
    segs[-1].write_bytes(segs[-1].read_bytes()[:-3])
    r2 = ring(pkg.wal, tmp_path)
    assert r2.torn_records >= 1
    assert [p for _t, p in drain(r2)] == [b"payload-%d" % i
                                          for i in range(5)]


def test_ring_orphaned_rewrite_temp_cleaned_on_recovery(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path)
    for i in range(4):
        r.append(float(i), b"payload-%d" % i)
    r.close()
    orphan = tmp_path / "ring" / "wal-00000001.seg.wal"
    orphan.write_bytes(b"half-written rewrite temp")
    r2 = ring(pkg.wal, tmp_path)
    assert not orphan.exists()
    assert r2.records_pending() == 4 and r2.torn_records == 0
    r2.close()
    assert ring(pkg.wal, tmp_path).torn_records == 0


def test_ring_corrupt_middle_record_stops_at_crc(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path, segment_bytes=1 << 20)
    for i in range(6):
        r.append(float(i), b"payload-%d" % i)
    r.close()
    (seg,) = sorted((tmp_path / "ring").glob("*.seg"))
    data = bytearray(seg.read_bytes())
    data[data.index(b"payload-3")] ^= 0xFF
    seg.write_bytes(bytes(data))
    r2 = ring(pkg.wal, tmp_path)
    assert r2.torn_records >= 1
    assert r2.records_pending() == 3


def test_ring_bounded_evicts_oldest_and_reports(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path, max_bytes=400, segment_bytes=100)
    evicted = sum(r.append(float(i), b"z" * 60) for i in range(50))
    assert evicted > 0
    assert r.evicted_records == evicted
    assert r.bytes_pending() <= 400 + 100
    assert r.peek()[0] > 0.0
    assert r.records_pending() + evicted == 50


def test_ring_eviction_survives_restart(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path, max_bytes=300, segment_bytes=100)
    for i in range(30):
        r.append(float(i), b"y" * 50)
    pending, oldest = r.records_pending(), r.oldest_ts()
    r.close()
    r2 = ring(pkg.wal, tmp_path, max_bytes=300, segment_bytes=100)
    assert (r2.records_pending(), r2.oldest_ts()) == (pending, oldest)


def test_ring_empty_dir_and_empty_ring(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path)
    assert r.peek() is None and r.oldest_ts() is None
    assert r.records_pending() == 0
    r.commit()
    status = r.status()
    assert status["records"] == 0 and status["torn_total"] == 0


def test_ring_headerless_legacy_segment_reads_as_v1(tmp_path, pkg):
    directory = tmp_path / "ring"
    directory.mkdir()
    payload = b"legacy-record"
    (directory / "wal-00000001.seg").write_bytes(
        struct.pack("<dII", 1.0, len(payload), zlib.crc32(payload))
        + payload)
    r = ring(pkg.wal, tmp_path, format_version=1)
    assert r.peek() == (1.0, payload)
    assert r.status()["legacy_segments"] == 1
    r.append(2.0, b"new-record")
    r.commit()
    assert r.peek() == (2.0, b"new-record")
    assert r.status()["legacy_segments"] < r.status()["segments"]


def _segment(payload: bytes, container: int = 1, fmt: int = 5,
             ts: float = 2.0) -> bytes:
    return (b"KTSG" + bytes((container, fmt))
            + struct.pack("<dII", ts, len(payload), zlib.crc32(payload))
            + payload)


def test_ring_future_format_segment_quarantined_whole(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path, format_version=1)
    r.append(1.0, b"own-record")
    r.close()
    future = tmp_path / "ring" / "wal-00000009.seg"
    raw = _segment(b"from-the-future")
    future.write_bytes(raw)
    r2 = ring(pkg.wal, tmp_path, format_version=1)
    assert r2.skew_segments == 1
    assert (tmp_path / "ring" / "wal-00000009.seg.skew").read_bytes() == raw
    assert not future.exists()
    assert r2.peek() == (1.0, b"own-record")
    assert pkg.wal.quarantine_counts() == {"segment-ring": 1}


def test_ring_future_container_version_also_quarantined(tmp_path, pkg):
    directory = tmp_path / "ring"
    directory.mkdir()
    (directory / "wal-00000001.seg").write_bytes(
        _segment(b"p", container=9, fmt=1, ts=1.0))
    r = ring(pkg.wal, tmp_path, format_version=1)
    assert r.skew_segments == 1 and r.records_pending() == 0


def test_ring_torn_legacy_segment_rewritten_headerless(tmp_path, pkg):
    directory = tmp_path / "ring"
    directory.mkdir()
    payload = b"intact-legacy"
    (directory / "wal-00000001.seg").write_bytes(
        struct.pack("<dII", 1.0, len(payload), zlib.crc32(payload))
        + payload + b"\x01\x02\x03")
    r = ring(pkg.wal, tmp_path, format_version=1)
    assert r.torn_records == 1 and r.peek() == (1.0, payload)
    r.close()
    assert not (directory / "wal-00000001.seg").read_bytes().startswith(
        b"KTSG")


def test_ring_new_segments_stamp_the_header(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path, format_version=3)
    r.append(1.0, b"abc")
    r.close()
    data = sorted((tmp_path / "ring").glob("*.seg"))[-1].read_bytes()
    assert data[:6] == b"KTSG" + bytes((pkg.wal.SEGMENT_CONTAINER_VERSION,
                                        3))
    r2 = ring(pkg.wal, tmp_path, format_version=3)
    assert r2.records_pending() == 1 and r2.skew_segments == 0


def test_ring_cursor_with_pruned_keys_defaults_not_keyerror(tmp_path, pkg):
    r = ring(pkg.wal, tmp_path)
    for i in range(3):
        r.append(float(i), b"x")
    r.save_cursor(force=True)
    r.close()
    cursor_path = tmp_path / "ring" / "wal-cursor.json"
    state = json.loads(cursor_path.read_text())
    state.pop("record")
    state.pop("seq")
    cursor_path.write_text(json.dumps(state))
    assert ring(pkg.wal, tmp_path).records_pending() == 3


def test_ring_second_quarantine_of_same_seq_keeps_both(tmp_path, pkg):
    directory = tmp_path / "ring"
    directory.mkdir()
    first, second = _segment(b"first", ts=1.0), _segment(b"second", ts=1.0)
    for raw in (first, second):
        (directory / "wal-00000001.seg").write_bytes(raw)
        ring(pkg.wal, tmp_path, format_version=1).close()
    assert {p.read_bytes() for p in directory.glob("*.skew*")} == \
        {first, second}


# -- StoreHealth, each package on its own --------------------------------

def test_store_health_classifies_and_transitions(pkg):
    wal = pkg.wal
    health = wal.StoreHealth("t", clock=lambda: 0.0)
    assert health.record_fault(OSError(errno.ENOSPC, "full"),
                               lost=2) == "disk_full"
    assert (health.state, health.fault_counts, health.lost_records,
            health.episodes) == (wal.STORE_DEGRADED, {"ENOSPC": 1}, 2, 1)
    health.record_fault(OSError(errno.ENOSPC, "full"))
    assert health.fault_counts == {"ENOSPC": 2} and health.episodes == 1
    health.ok()
    assert health.state == wal.STORE_HEALTHY and health.recoveries == 1


def test_store_health_probe_gating_uses_the_interval(pkg):
    now = [0.0]
    health = pkg.wal.StoreHealth("t", clock=lambda: now[0],
                                 probe_interval=10.0)
    assert health.allow_io()
    health.record_fault(OSError(errno.EROFS, "ro"))
    assert not health.allow_io()
    now[0] = 10.5
    assert health.allow_io()
    assert not health.allow_io()
    now[0] = 21.0
    assert health.allow_io()


def test_store_health_logs_once_per_episode(pkg, caplog):
    health = pkg.wal.StoreHealth("quiet-store", clock=lambda: 0.0)
    with caplog.at_level(logging.WARNING):
        for _ in range(50):
            health.record_fault(OSError(errno.ENOSPC, "full"))
    assert len([r for r in caplog.records
                if "quiet-store degraded" in r.getMessage()]) == 1
    assert health.fault_counts["ENOSPC"] == 50


def test_store_health_journals_fault_and_recovery_edges(pkg):
    tracer = FakeTracer()
    pkg.wal.set_journal(tracer)
    health = pkg.wal.StoreHealth("j", clock=lambda: 0.0)
    for _ in range(3):
        health.record_fault(OSError(errno.EIO, "io"))
    health.ok()
    assert [e["kind"] for e in tracer.events] == ["disk_fault",
                                                  "store_recovered"]
    assert tracer.events[0]["store"] == "j"
    assert tracer.events[0]["errno"] == "EIO"


@pytest.mark.parametrize("code", [errno.ENOSPC, errno.EDQUOT, errno.EIO,
                                  errno.EROFS, errno.EACCES, errno.EPERM,
                                  errno.EMFILE, errno.ENFILE, errno.ENOBUFS,
                                  errno.ENOMEM, errno.ENOENT, None])
def test_classify_oserror_taxonomy_is_the_references(code):
    exc = OSError(code, "x") if code is not None else OSError("x")
    assert port_wal.classify_oserror(exc) == ref_wal.classify_oserror(exc)


def test_write_state_fault_degrades_instead_of_raising(tmp_path, pkg,
                                                       fast_probe):
    wal = pkg.wal
    path = str(tmp_path / "ck.json")
    with pkg.faultfs.FaultFS() as fs:
        fs.inject(str(tmp_path), "enospc", ops=("write", "fsync"))
        assert not wal.write_state(path, {"version": 1, "seq": 1},
                                   label="ck-test")
        health = wal.store_health("ck-test")
        assert (health.state, health.reason) == (wal.STORE_DEGRADED,
                                                 "disk_full")
        fs.clear()
        assert wal.write_state(path, {"version": 1, "seq": 2},
                               label="ck-test")
        assert health.state == wal.STORE_HEALTHY
    assert wal.load_newest(path, 1, label="ck-test")["seq"] == 2


def test_write_state_skips_disk_between_probes(tmp_path, pkg):
    health = pkg.wal.store_health("gated")
    health.probe_interval = 3600.0
    health.record_fault(OSError(errno.ENOSPC, "full"))
    with pkg.faultfs.FaultFS() as fs:
        rule = fs.inject(str(tmp_path), "enospc", ops=("open",))
        assert not pkg.wal.write_state(str(tmp_path / "ck.json"),
                                       {"version": 1, "seq": 1},
                                       label="gated")
    assert rule.hits == 0


# -- SegmentRing under faults, each package on its own -------------------

def _ring(wal, tmp_path, **kw):
    kw.setdefault("max_bytes", 1 << 20)
    kw.setdefault("segment_bytes", 256)
    kw.setdefault("label", "ring-test")
    kw.setdefault("format_version", 1)
    return wal.SegmentRing(str(tmp_path / "ring"), **kw)


def test_ring_enospc_goes_memory_only_loss_counted(tmp_path, pkg,
                                                   fast_probe):
    wal = pkg.wal
    with pkg.faultfs.FaultFS() as fs:
        fs.watch(str(tmp_path))
        r = _ring(wal, tmp_path)
        r.append(1.0, b"before")
        fs.inject(str(tmp_path), "enospc", ops=("open", "write", "fsync"))
        for i in range(5):
            r.append(2.0 + i, b"during-%d" % i)
        assert (r.health.state, r.health.reason) == (wal.STORE_DEGRADED,
                                                     "disk_full")
        assert r.records_pending() == 6 and r.health.lost_records == 5
        fs.clear()
        r.append(10.0, b"after")
        assert r.health.state == wal.STORE_HEALTHY
        assert r.health.recoveries == 1
        r.close()
    payloads = [p for _t, p in drain(_ring(wal, tmp_path))]
    assert b"before" in payloads and b"after" in payloads
    assert not any(p.startswith(b"during") for p in payloads)


def test_ring_eio_quarantines_tail_and_recovers(tmp_path, pkg, fast_probe):
    with pkg.faultfs.FaultFS() as fs:
        fs.watch(str(tmp_path))
        r = _ring(pkg.wal, tmp_path)
        r.append(1.0, b"one")
        fs.inject(str(tmp_path / "ring"), "eio", ops=("write",), times=1)
        r.append(2.0, b"two")
        assert r.health.fault_counts.get("EIO") == 1
        assert r.health.state == pkg.wal.STORE_HEALTHY
        assert [n for n in os.listdir(tmp_path / "ring") if ".eioq" in n]
        assert r.records_pending() == 2
        r.close()


def test_ring_erofs_disables_durability_one_journal_event(tmp_path, pkg,
                                                          fast_probe):
    tracer = FakeTracer()
    pkg.wal.set_journal(tracer)
    with pkg.faultfs.FaultFS() as fs:
        fs.watch(str(tmp_path))
        r = _ring(pkg.wal, tmp_path)
        r.append(1.0, b"one")
        fs.inject(str(tmp_path), "erofs", ops=("open", "write", "fsync"))
        pkg.wal.set_probe_interval(3600.0)
        for i in range(10):
            r.append(2.0 + i, b"x%d" % i)
        assert r.health.reason == "read_only"
        assert len([e for e in tracer.events
                    if e["kind"] == "disk_fault"]) == 1
        assert r.records_pending() == 11
        r.close()


def test_ring_enospc_sheds_oldest_segment_to_reclaim(tmp_path, pkg,
                                                     fast_probe):
    with pkg.faultfs.FaultFS() as fs:
        fs.watch(str(tmp_path))
        r = _ring(pkg.wal, tmp_path, segment_bytes=64)
        for i in range(10):
            r.append(float(i), b"p" * 40)
        before = r.status()["segments"]
        fs.inject(str(tmp_path), "enospc", ops=("write", "fsync"))
        dropped = r.append(99.0, b"p" * 40)
        assert dropped > 0 and r.evicted_records == dropped
        assert r.health.lost_records >= dropped
        assert r.status()["segments"] < before + 2
        r.close()


def test_ring_recovery_write_rolls_past_a_gapped_tail(tmp_path, pkg,
                                                          fast_probe):
    with pkg.faultfs.FaultFS() as fs:
        fs.watch(str(tmp_path))
        r = _ring(pkg.wal, tmp_path)
        r.append(1.0, b"A")
        fs.inject(str(tmp_path), "erofs", ops=("write",))
        r.append(2.0, b"B")
        fs.clear()
        r.append(3.0, b"C")
        for want in (b"A", b"B"):
            assert r.peek()[1] == want
            r.commit()
        r.close()
    record = _ring(pkg.wal, tmp_path).peek()
    assert record is not None and record[1] == b"C"


def test_ring_torn_write_truncated_on_recovery(tmp_path, pkg):
    with pkg.faultfs.FaultFS() as fs:
        fs.watch(str(tmp_path))
        r = _ring(pkg.wal, tmp_path)
        r.append(1.0, b"good-record")
        fs.inject(str(tmp_path), "torn", ops=("write",), times=1)
        with pytest.raises(pkg.faultfs.TornWrite):
            r.append(2.0, b"torn-record-payload")
    recovered = _ring(pkg.wal, tmp_path)
    assert recovered.torn_records >= 1
    assert recovered.peek()[1] == b"good-record"


def test_ring_constructor_survives_unwritable_dir(tmp_path, pkg,
                                                  fast_probe):
    with pkg.faultfs.FaultFS() as fs:
        fs.inject(str(tmp_path), "erofs",
                  ops=("makedirs", "open", "write", "fsync"))
        r = pkg.wal.SegmentRing(str(tmp_path / "newdir"),
                                max_bytes=1 << 20, label="ctor-test",
                                format_version=1)
        assert r.health.state == pkg.wal.STORE_DEGRADED
        r.append(1.0, b"x")
        assert r.records_pending() == 1


def test_ring_recover_survives_unlistable_dir(tmp_path, pkg, fast_probe):
    os.makedirs(tmp_path / "ring")
    with pkg.faultfs.FaultFS() as fs:
        fs.inject(str(tmp_path), "eio", ops=("listdir",), times=1)
        r = pkg.wal.SegmentRing(str(tmp_path / "ring"), max_bytes=1 << 20,
                                label="recover-test", format_version=1)
    assert r.health.fault_counts.get("EIO") == 1
    r.close()


# -- the two packages against each other ---------------------------------

def _records(seed: int, n: int = 40) -> list[tuple[float, bytes]]:
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.01, 2.0, n)) + 1.7e9
    sizes = rng.integers(0, 90, n)
    return [(float(t), rng.bytes(int(size))) for t, size in
            zip(times, sizes)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("writer,reader", [(ref_wal, port_wal),
                                           (port_wal, ref_wal)],
                         ids=["ref-to-port", "port-to-ref"])
def test_state_files_cross_load(tmp_path, writer, reader, seed):
    rng = np.random.default_rng(seed)
    state = {"version": 1, "seq": int(rng.integers(1, 1000)),
             "per_pod": [[f"pod-{i}", "ns", float(rng.uniform(0, 1e6))]
                         for i in range(int(rng.integers(0, 6)))],
             "wall": float(rng.uniform(0, 2e9))}
    paths = {module: str(tmp_path / f"{module.__name__}.json")
             for module in WALS}
    for module, path in paths.items():
        assert module.write_state(path, state, label="x")
    # Both writers put the same bytes on disk.
    assert len({open(p, "rb").read() for p in paths.values()}) == 1
    assert reader.load_newest(paths[writer], 1) == state
    assert reader.newest_seq(paths[writer], 1) == state["seq"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("writer,reader", [(ref_wal, port_wal),
                                           (port_wal, ref_wal)],
                         ids=["ref-to-port", "port-to-ref"])
def test_rings_cross_read(tmp_path, writer, reader, seed):
    records = _records(seed)
    consumed = seed + 3
    for module in WALS:
        r = module.SegmentRing(str(tmp_path / module.__name__),
                               max_bytes=1 << 20, segment_bytes=512,
                               fsync=False, format_version=2)
        for ts, payload in records:
            assert r.append(ts, payload) == 0
        for _ in range(consumed):
            r.peek()
            r.commit()
        r.close()
    names = [sorted(os.listdir(tmp_path / m.__name__)) for m in WALS]
    assert names[0] == names[1]
    for name in names[0]:
        assert ((tmp_path / ref_wal.__name__ / name).read_bytes()
                == (tmp_path / port_wal.__name__ / name).read_bytes()), name
    r = reader.SegmentRing(str(tmp_path / writer.__name__),
                           max_bytes=1 << 20, segment_bytes=512,
                           fsync=False, format_version=2)
    assert r.torn_records == 0 and r.skew_segments == 0
    assert drain(r) == records[consumed:]


@pytest.mark.parametrize("future", [7, 99])
def test_quarantine_asides_are_byte_identical(tmp_path, future):
    raw = json.dumps({"version": future, "seq": 3, "new": [1.5]}).encode()
    seg = _segment(b"from-a-newer-build", fmt=future % 256)
    out = {}
    for module in WALS:
        directory = tmp_path / module.__name__
        (directory / "ring").mkdir(parents=True)
        (directory / "state.json").write_bytes(raw)
        (directory / "ring" / "wal-00000004.seg").write_bytes(seg)
        assert module.read_state(str(directory / "state.json"), 1,
                                 label="energy") is None
        module.SegmentRing(str(directory / "ring"), max_bytes=1 << 20,
                           fsync=False, format_version=1).close()
        out[module] = {str(p.relative_to(directory)): p.read_bytes()
                       for p in directory.rglob("*") if p.is_file()}
        assert module.quarantine_counts() == {"energy": 1,
                                              "segment-ring": 1}
    assert out[ref_wal] == out[port_wal]
    assert out[port_wal][f"state.json.skew-v{future}"] == raw
    assert out[port_wal]["ring/wal-00000004.seg.skew"] == seg


def _health_row(health) -> tuple:
    status = health.status()
    return (status["state"], status["reason"], status["errno"],
            status["lost_records"], tuple(sorted(
                status["fault_counts"].items())), status["episodes"],
            status["recoveries"])


def _fault_script(wal, faultfs, tmp_path, fault: str) -> list[tuple]:
    """One ring and one state file through a fault and its recovery;
    the store's health after every step."""
    rows = []
    with faultfs.FaultFS() as fs:
        fs.watch(str(tmp_path))
        r = wal.SegmentRing(str(tmp_path / "ring"), max_bytes=1 << 20,
                            segment_bytes=64, label="xring",
                            format_version=1)
        for i in range(4):
            r.append(float(i), b"p" * 30)
        rows.append(_health_row(r.health))
        fs.inject(str(tmp_path), fault, ops=("open", "write", "fsync"))
        for i in range(5):
            r.append(10.0 + i, b"q" * 30)
            rows.append(_health_row(r.health) + (r.records_pending(),))
        path = str(tmp_path / "state.json")
        wal.write_state(path, {"version": 1, "seq": 1}, label="xstate")
        rows.append(_health_row(wal.store_health("xstate")))
        fs.clear()
        r.append(20.0, b"r" * 30)
        rows.append(_health_row(r.health) + (r.records_pending(),))
        wal.write_state(path, {"version": 1, "seq": 2}, label="xstate")
        rows.append(_health_row(wal.store_health("xstate")))
        r.close()
    rows.append(tuple(p for _t, p in drain(wal.SegmentRing(
        str(tmp_path / "ring"), max_bytes=1 << 20, segment_bytes=64,
        label="xring-reopened", format_version=1))))
    return rows


@pytest.mark.parametrize("fault", ["enospc", "eio", "erofs", "emfile"])
@pytest.mark.parametrize("faultfs", ["reference", "port"])
def test_fault_transitions_match_under_either_faultfs(tmp_path, fast_probe,
                                                      fault, faultfs):
    injector = PACKAGES[faultfs].faultfs
    got = {module: _fault_script(module, injector,
                                 tmp_path / module.__name__, fault)
           for module in WALS}
    assert got[port_wal] == got[ref_wal]
    degraded = got[port_wal][1]
    assert degraded[0] == "degraded"
    assert degraded[2] == fault.upper()


# -- the port's store surfaces -------------------------------------------

def test_store_metrics_contribution():
    from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
    from kube_gpu_stats_tpu.registry import \
        contribute_store_metrics as ref_contribute
    from kube_gpu_stats_tpu_torch.registry import (SnapshotBuilder,
                                                   contribute_store_metrics)

    texts = []
    for module, builder, contribute in (
            (ref_wal, RefBuilder(), ref_contribute),
            (port_wal, SnapshotBuilder(), contribute_store_metrics)):
        module.store_health("m-test").record_fault(
            OSError(errno.ENOSPC, "full"), lost=3)
        contribute(builder)
        texts.append(builder.build().render())
    assert texts[1] == texts[0]
    assert 'kts_store_lost_records_total{store="m-test"} 3' in texts[1]


def _get(url, auth=None):
    request = urllib.request.Request(url)
    if auth:
        import base64

        request.add_header("Authorization", "Basic "
                           + base64.b64encode(auth.encode()).decode())
    with urllib.request.urlopen(request, timeout=5) as response:
        return response.status, response.read()


def test_debug_stores_endpoint_and_auth():
    import hashlib

    from kube_gpu_stats_tpu_torch.exposition import MetricsServer
    from kube_gpu_stats_tpu_torch.registry import Registry

    port_wal.store_health("endpoint-test").record_fault(
        OSError(errno.ENOSPC, "full"))
    server = MetricsServer(
        Registry(), host="127.0.0.1", port=0, auth_username="ops",
        auth_password_sha256=hashlib.sha256(b"pw").hexdigest(),
        stores_provider=lambda: {"enabled": True,
                                 "stores": port_wal.store_report(),
                                 "threads": []})
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/debug/stores")
        assert err.value.code == 401
        payload = json.loads(_get(base + "/debug/stores", auth="ops:pw")[1])
        row = payload["stores"]["endpoint-test"]
        assert (row["state"], row["reason"]) == ("degraded", "disk_full")
    finally:
        server.stop()


def test_accept_loop_survives_fd_exhaustion():
    import time

    from kube_gpu_stats_tpu_torch.exposition import MetricsServer
    from kube_gpu_stats_tpu_torch.registry import Registry, SnapshotBuilder

    registry = Registry()
    registry.publish(SnapshotBuilder().build())
    server = MetricsServer(registry, host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        _get(base + "/healthz")
        proxy = port_faultfs.fence_accepts(server, times=4)
        deadline = time.monotonic() + 10.0
        status = None
        while time.monotonic() < deadline:
            try:
                status, _ = _get(base + "/healthz")
                break
            except (urllib.error.URLError, OSError):
                time.sleep(0.05)
        assert status == 200 and proxy.faults_served == 4
        fence = server.accept_fence_status()
        assert fence["fenced_total"] == 4 and fence["episodes"] >= 1
        assert not fence["in_episode"]
        health = port_wal.store_health("http-accept")
        assert health.fault_counts.get("EMFILE") == 4
        assert health.state == port_wal.STORE_HEALTHY
    finally:
        server.stop()
