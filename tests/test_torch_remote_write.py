"""The port's remote writer and spill queue against the reference's.

- Bodies: the v1 and v2 WriteRequests of the same snapshot (series,
  histograms, empty label values, extra labels; clock and ``instance``
  pinned) are equal bytes; ``shard_of``, ``encode_shard_request`` and
  ``build_headers`` are equal.
- The legacy (best-effort) writer and the durable sharded one answer
  the same receiver scripts with the same counters: 415 downgrades 2.0
  to 1.0 (the durable one parks the 2.0 request), poison 4xx drops or
  parks, 5xx and 429 + Retry-After are retried, an unreadable token is a
  failure.
- ``tools/partition_sim.py``'s TSDB scenario with the port's writer
  against its ``FakeTsdb``: exactly-once, oldest-first through two
  blackouts and a slow stretch, lag metered; a WAL bounded below the
  backlog drops oldest-first with the loss counted and journaled.
- Disk formats: a shard WAL or a spill ring written by one package is
  the other's byte for byte and drains in the other; oldest-first loss
  is accounted exactly (``spooled == drained + dropped``); old-format
  spooled wire frames are recovered and garbage counted undecodable as
  the reference does.
"""

from __future__ import annotations

import dataclasses
import http.server
import os
import pathlib
import sys
import threading
import time

import numpy as np
import pytest

from kube_gpu_stats_tpu import remote_write as ref_rw
from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu import snappy as ref_snappy
from kube_gpu_stats_tpu import spillq as ref_spillq
from kube_gpu_stats_tpu import wal as ref_wal
from kube_gpu_stats_tpu.registry import HistogramState as RefHistogram
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
from kube_gpu_stats_tpu_torch import delta, remote_write, schema, snappy
from kube_gpu_stats_tpu_torch import spillq, wal
from kube_gpu_stats_tpu_torch.registry import HistogramState, Registry
from kube_gpu_stats_tpu_torch.registry import SnapshotBuilder
from kube_gpu_stats_tpu_torch.tracing import Tracer

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import partition_sim  # noqa: E402  (the reference's scenarios)

SIDES = {
    "port": (remote_write, schema, Registry, SnapshotBuilder,
             HistogramState, spillq),
    "reference": (ref_rw, ref_schema, RefRegistry, RefBuilder,
                  RefHistogram, ref_spillq),
}


@pytest.fixture(autouse=True)
def clean_registries():
    for module in (ref_wal, wal):
        module.reset_store_stats()
        module.reset_quarantine_stats()
    yield
    for module in (ref_wal, wal):
        module.reset_store_stats()
        module.reset_quarantine_stats()


def snapshot(side: str, seed: int, ts: float = 1_700_000_000.125):
    """The same seeded snapshot in either package: cards with some empty
    label values, a counter family, two histograms."""
    _, sch, _, builder_cls, hist_cls, _ = SIDES[side]
    rng = np.random.default_rng(seed)
    builder = builder_cls()
    for chip in range(int(rng.integers(1, 5))):
        labels = (("accel_type", "h100"), ("chip", str(chip)),
                  ("device_path", f"/dev/nvidia{chip}"),
                  ("uuid", f"GPU-{chip}" if chip % 2 else ""))
        builder.add(sch.DEVICE_UP, 1.0, labels)
        builder.add(sch.DUTY_CYCLE, float(rng.integers(0, 100)), labels)
        builder.add(sch.POWER, float(rng.normal() * 100 + 400), labels)
        builder.add(sch.ICI_TRAFFIC_TOTAL, float(rng.integers(0, 2**50)),
                    labels + (("link", "0"), ("direction", "tx")))
    for spec, buckets, labels in (
            (sch.SELF_POLL_DURATION, sch.POLL_DURATION_BUCKETS, ()),
            (sch.SELF_SCRAPE_DURATION, sch.SCRAPE_DURATION_BUCKETS,
             (("output", "http"),))):
        hist = hist_cls.empty(spec, buckets, labels=labels)
        for value in rng.exponential(0.01, int(rng.integers(0, 20))):
            hist = hist.observe(float(value))
        builder.add_histogram(hist)
    return dataclasses.replace(builder.build(), timestamp=ts)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("extra", [(), (("cluster", "prod"),
                                        ("region", "eu"))])
def test_write_requests_are_the_references_bytes(seed, extra):
    port_snap, ref_snap = snapshot("port", seed), snapshot("reference", seed)
    for name in ("build_write_request", "build_write_request_v2"):
        got = getattr(remote_write, name)(port_snap, "kts", "node-1", extra)
        want = getattr(ref_rw, name)(ref_snap, "kts", "node-1", extra)
        assert got == want, name


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shards", [1, 2, 3, 16, 64])
def test_shard_routing_and_shard_requests_equal_the_references(seed, shards):
    port_snap, ref_snap = snapshot("port", seed), snapshot("reference", seed)
    port_samples = list(remote_write._snapshot_series(port_snap, "kts", "n"))
    ref_samples = list(ref_rw._snapshot_series(ref_snap, "kts", "n"))
    assert [s[1:] for s in port_samples] == [s[1:] for s in ref_samples]
    for (_, name, labels, _, _) in port_samples:
        assert remote_write.shard_of(name, labels, shards) == \
            ref_rw.shard_of(name, labels, shards)
    for protocol in ("1.0", "2.0"):
        assert remote_write.encode_shard_request(port_samples, protocol) \
            == ref_rw.encode_shard_request(ref_samples, protocol)


def test_headers_equal_the_references(tmp_path):
    token = tmp_path / "token"
    token.write_text("s3cret\n")
    for protocol in ("1.0", "2.0"):
        for path in ("", str(token), str(tmp_path / "missing")):
            assert remote_write.build_headers(path, protocol) == \
                ref_rw.build_headers(path, protocol)
    assert remote_write.build_headers(str(tmp_path / "missing")) is None


# -- scripted receivers ----------------------------------------------------------

class Script:
    """A write receiver answering scripted statuses in order (then 204),
    keeping every body it took with its Content-Type."""

    def __init__(self, codes: list[tuple[int, dict]]) -> None:
        self.codes = list(codes)
        self.got: list[tuple[str, bytes]] = []
        script = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - http.server's name
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                status, headers = (script.codes.pop(0) if script.codes
                                   else (204, {}))
                if status < 300:
                    script.got.append((self.headers["Content-Type"], body))
                self.send_response(status)
                for key, value in headers.items():
                    self.send_header(key, value)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = (f"http://127.0.0.1:{self.httpd.server_address[1]}"
                    "/api/v1/write")
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _drive(side: str, codes, tmp_path, pushes: int, **kwargs) -> dict:
    rw, *_ = SIDES[side]
    registry = SIDES[side][2]()
    script = Script(codes)
    writer = rw.RemoteWriter(registry, script.url, job="kts",
                             instance="node-1", min_interval=0.0,
                             wal_fsync=False, **kwargs)
    try:
        for i in range(pushes):
            registry.publish(snapshot(side, i, ts=1_700_000_000.0 + i))
            if writer.durable:
                for shard in writer._shards:
                    shard.retry_at = 0.0
            writer.push_once()
        status = writer.egress_status()
        shards = None if status is None else [
            {k: s[k] for k in ("wal_records", "sent_total", "parked_total",
                               "dropped_total", "consecutive_failures")}
            for s in status["shards"]]
        return {"pushes": writer.pushes_total,
                "failures": writer.failures_total,
                "dropped": writer.dropped_total,
                "consecutive": writer.consecutive_failures,
                "protocol": writer.protocol, "shards": shards,
                "got": script.got}
    finally:
        writer.stop()
        script.close()


SCRIPTS = {
    "ok": [],
    "415": [(415, {})],
    "poison": [(400, {})],
    "5xx": [(503, {}), (500, {})],
    "429": [(429, {"Retry-After": "3"})],
    "redirect": [(302, {"Location": "http://elsewhere/"})],
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
@pytest.mark.parametrize("durable", [False, True])
def test_writers_answer_receiver_scripts_as_the_reference(tmp_path, case,
                                                          durable):
    # One shard: several pump on threads, and which of two concurrent
    # requests draws a scripted answer is a race.
    kwargs = {"protocol": "2.0"}
    runs = {}
    for side in SIDES:
        if durable:
            kwargs["wal_dir"] = str(tmp_path / side)
        runs[side] = _drive(side, SCRIPTS[case], tmp_path, 4, **kwargs)
    assert runs["port"] == runs["reference"]
    run = runs["port"]
    if case == "415":
        assert run["protocol"] == "1.0"
    if case in ("5xx", "429", "redirect"):
        assert run["failures"] >= 1
    if case == "poison" and not durable:
        assert run["dropped"] == 1


def test_an_unreadable_token_is_a_failure_as_the_reference(tmp_path):
    runs = [_drive(side, [], tmp_path, 2,
                   bearer_token_file=str(tmp_path / "missing"))
            for side in SIDES]
    assert runs[0] == runs[1]
    assert runs[0]["failures"] == 2 and runs[0]["pushes"] == 0


# -- tools/partition_sim.py's TSDB scenario, the port's side ----------------------

def test_tsdb_blackout_scenario_with_the_port_writer(tmp_path):
    registry = Registry()
    published = [0]

    def publish() -> None:
        builder = SnapshotBuilder()
        labels = (("accel_type", "h100"), ("chip", "0"),
                  ("device_path", "/dev/nvidia0"), ("uuid", ""))
        builder.add(schema.DUTY_CYCLE, float(published[0]), labels)
        registry.publish(builder.build())
        published[0] += 1
        time.sleep(0.002)  # distinct snapshot timestamps

    def unblock(writer) -> None:
        for shard in writer._shards:
            shard.retry_at = 0.0

    tsdb = partition_sim.FakeTsdb().start()
    tracer = Tracer(enabled=True)
    writer = remote_write.RemoteWriter(
        registry, f"http://127.0.0.1:{tsdb.port}/api/v1/push",
        job="kts", instance="sim", min_interval=0.0, shards=2,
        wal_dir=str(tmp_path / "rw-wal"), wal_fsync=False,
        drain_max_per_push=256, tracer=tracer)
    try:
        enqueued = 0
        publish()
        writer.push_once()
        enqueued += 1
        for _ in range(2):
            tsdb.stop()
            for _ in range(8):
                publish()
                unblock(writer)
                writer.push_once()
                enqueued += 1
            assert writer.backlog_records() > 0
            tsdb.start()
            unblock(writer)
            writer.push_once()
            assert writer.backlog_records() == 0
        tsdb.slow_seconds = 0.05
        for _ in range(4):
            publish()
            unblock(writer)
            writer.push_once()
            enqueued += 1
        tsdb.slow_seconds = 0.0
        unblock(writer)
        writer.push_once()
        expected = enqueued * sum(1 for shard in writer._shards
                                  if shard.sent_total)
        assert len(tsdb.requests) == expected
        assert writer.backlog_records() == 0
        ts = [request[0][1][0][1] for request in tsdb.requests if request]
        assert all(b >= a for a, b in zip(ts, ts[1:]))
        status = writer.egress_status()
        assert max(s["lag_seconds"] for s in status["shards"]) > 0.0
        assert not any(s["dropped_total"] for s in status["shards"])
        writer.stop()

        # Beyond bounds: a WAL far smaller than the backlog.
        registry2 = Registry()
        published[0] = 0

        def publish2() -> None:
            builder = SnapshotBuilder()
            for i in range(65):
                builder.add(schema.DUTY_CYCLE, float(published[0] * max(i, 1)),
                            (("accel_type", "h100"), ("chip", str(i)),
                             ("device_path", f"/dev/nvidia{i}"),
                             ("uuid", "")))
            registry2.publish(builder.build())
            published[0] += 1
            time.sleep(0.002)

        tsdb.stop()
        tracer2 = Tracer(enabled=True)
        writer2 = remote_write.RemoteWriter(
            registry2, f"http://127.0.0.1:{tsdb.port}/api/v1/push",
            job="kts", instance="sim2", min_interval=0.0,
            wal_dir=str(tmp_path / "rw-wal-tiny"), wal_max_bytes=1 << 16,
            wal_fsync=False, drain_max_per_push=512, tracer=tracer2)
        for _ in range(120):
            publish2()
            writer2._shards[0].retry_at = time.monotonic() + 60
            writer2.push_once()
        shard = writer2._shards[0]
        assert shard.dropped_total > 0
        assert any(e.get("kind") == "remote_write_drop"
                   for e in tracer2.events(0)["events"])
        tsdb.requests.clear()
        tsdb.start()
        shard.retry_at = 0.0
        writer2.push_once()
        assert writer2.backlog_records() == 0
        assert tsdb.requests and tsdb.requests[0][0][1][0][0] > 0.0
        assert len(tsdb.requests) + shard.dropped_total == 120
        writer2.stop()
    finally:
        tsdb.stop()


# -- disk formats across the packages -----------------------------------------------

def _tree(path: pathlib.Path) -> dict[str, bytes]:
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("protocol", ["1.0", "2.0"])
def test_shard_wals_are_byte_identical_and_drain_across(tmp_path, protocol):
    for side in SIDES:
        rw, _, registry_cls, *_ = SIDES[side]
        registry = registry_cls()
        writer = rw.RemoteWriter(
            registry, "http://127.0.0.1:9/api/v1/write", job="kts",
            instance="node-1", min_interval=0.0, shards=3,
            protocol=protocol, wal_dir=str(tmp_path / side),
            wal_fsync=False)
        for i in range(6):
            registry.publish(snapshot(side, i, ts=1_700_000_000.0 + i))
            for shard in writer._shards:
                shard.retry_at = time.monotonic() + 60  # journal only
            writer.push_once()
        writer.stop()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "reference")
    # The port's WAL drains through the reference's writer, and back.
    for writer_side, reader_side in (("port", "reference"),
                                     ("reference", "port")):
        rw, _, registry_cls, *_ = SIDES[reader_side]
        tsdb = partition_sim.FakeTsdb().start()
        reader = rw.RemoteWriter(
            registry_cls(), f"http://127.0.0.1:{tsdb.port}/api/v1/write",
            job="kts", instance="node-1", min_interval=0.0, shards=3,
            protocol="1.0", wal_dir=str(tmp_path / writer_side),
            wal_fsync=False)
        try:
            assert reader.backlog_records() == 18
            reader.push_once()
            assert reader.backlog_records() == 0
            sent = sum(s.sent_total for s in reader._shards)
            assert sent == 18
        finally:
            reader.stop()
            tsdb.stop()


def _bodies(n: int) -> list[str]:
    rng = np.random.default_rng(12)
    return ["".join(f'accelerator_duty_cycle{{chip="{c}"}} '
                    f'{rng.integers(0, 10**12)}\n' for c in range(40))
            for _ in range(n)]


@pytest.mark.parametrize("max_bytes", [64 * 1024 * 1024, 1 << 16])
def test_spill_rings_are_byte_identical_and_drain_across(tmp_path,
                                                         max_bytes):
    bodies = _bodies(300)
    dropped = {}
    for side in SIDES:
        queue = SIDES[side][5].SpillQueue(str(tmp_path / side),
                                          max_bytes=max_bytes, fsync=False)
        for i, body in enumerate(bodies):
            queue.spool(1_700_000_000.0 + i, body)
        dropped[side] = queue.dropped_total
        queue.close()
    assert dropped["port"] == dropped["reference"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "reference")
    for writer_side, reader_side in (("port", "reference"),
                                     ("reference", "port")):
        queue = SIDES[reader_side][5].SpillQueue(
            str(tmp_path / writer_side), max_bytes=max_bytes, fsync=False)
        drained = []
        while True:
            record = queue.peek()
            if record is None:
                break
            drained.append(record)
            queue.commit()
        assert [body for _, body in drained] == bodies[len(bodies)
                                                       - len(drained):]
        assert drained[0][0] == 1_700_000_000.0 + len(bodies) - len(drained)
        # Oldest-first loss, accounted where it happened (the writer).
        assert len(drained) + dropped[writer_side] == len(bodies)
        assert (dropped[writer_side] > 0) == (max_bytes < 1 << 20)
        queue.save_cursor(force=True)
        queue.close()
        # Reopened: nothing left, whoever reads.
        again = SIDES[writer_side][5].SpillQueue(
            str(tmp_path / writer_side), max_bytes=max_bytes, fsync=False)
        assert again.depth() == 0 and again.peek() is None
        again.close()


@pytest.mark.parametrize("seed", range(3))
def test_oldest_first_loss_is_accounted_as_the_reference(tmp_path, seed):
    rows = {}
    for side in SIDES:
        rng = np.random.default_rng(seed)
        tracer = Tracer(enabled=True) if side == "port" else None
        queue = SIDES[side][5].SpillQueue(str(tmp_path / side),
                                          max_bytes=1 << 16, fsync=False,
                                          tracer=tracer)
        for i in range(400):
            queue.spool(float(i), "".join(
                f"v{c} {rng.integers(0, 10**12)}\n" for c in range(40)))
            if i % 50 == 49:          # drain a little now and then
                for _ in range(3):
                    if queue.peek() is not None:
                        queue.commit()
        while queue.peek() is not None:
            queue.commit()
        rows[side] = (queue.spooled_total, queue.drained_total,
                      queue.dropped_total, queue.undecodable_total,
                      queue.depth())
        assert queue.spooled_total == queue.drained_total + \
            queue.dropped_total
        if tracer is not None:
            assert any(e["kind"] == "spill_drop"
                       for e in tracer.events(0)["events"])
        queue.close()
    assert rows["port"] == rows["reference"]
    assert rows["port"][2] > 0


def test_old_format_and_garbage_records_as_the_reference(tmp_path):
    full = delta.encode_full("node", 1, 1, "a 1\n")
    dlt = delta.encode_delta("node", 1, 2, [(0, 2.0)])
    records = [snappy.compress(b"plain 1\n"), full, dlt,
               b"not snappy", snappy.compress(b"\xff\xfe")]
    rows = []
    for side in SIDES:
        ring = (wal if side == "port" else ref_wal).SegmentRing(
            str(tmp_path / side), max_bytes=1 << 20,
            segment_bytes=1 << 20, prefix="spill", fsync=False,
            label="spill", format_version=spillq.SPILL_FORMAT_VERSION)
        for i, payload in enumerate(records):
            ring.append(float(i), payload)
        ring.close()
        queue = SIDES[side][5].SpillQueue(str(tmp_path / side), fsync=False)
        got = []
        while True:
            record = queue.peek()
            if record is None:
                break
            got.append(record)
            queue.commit()
        rows.append((got, queue.reencoded_total, queue.undecodable_total,
                     queue.drained_total, queue.status()["depth_frames"]))
        queue.close()
    assert rows[0] == rows[1]
    got, reencoded, undecodable, drained, depth = rows[0]
    assert [body for _, body in got] == ["plain 1\n", "a 1\n"]
    assert (reencoded, undecodable, drained, depth) == (1, 3, 2, 0)
    assert ref_snappy.compress(b"x") == snappy.compress(b"x")
    assert os.path.isdir(tmp_path / "port")
