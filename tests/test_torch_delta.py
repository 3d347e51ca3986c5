"""The port's delta publisher against the reference's wire and receiver.

- Frame codec: ``encode_full``/``encode_delta`` give equal bytes for
  equal inputs, and ``decode_frame``/``decode_frame_raw`` give the
  reference's frame or its verdict (error class and message) on valid
  frames and on seeded truncations and byte flips. The reference may
  decode DELTAs with its C slot walk; its verdicts are pinned to the
  Python walk's, which is the only one the port has.
- ``DeltaEncoder``: two encoders fed the same seeded bodies (value
  churn, shape changes, negotiations) through the same seeded ack /
  nack / defer sequence emit equal frames.
- ``DeltaPublisher`` over HTTP into the reference's ``DeltaIngest``
  (with the hub's own ingest-cache entries): after every publish the
  reference's session state equals the port registry's series; 409
  answered with one FULL inside the push; 429/503 + Retry-After and 413
  honoured with the same decorrelated-jitter delay as the reference's
  publisher under the same seeded rng; 426 renegotiated into range, or
  counted as refused when the ranges are disjoint.
- ``tools/partition_sim.py``'s hub-blackout and beyond-bounds scenarios
  with the port's daemon, publisher and spill queue against the
  reference's hub, held to the same pass criteria.
- ``testing.egress_sink``: the same frame sequences give the sink the
  reference ``DeltaIngest``'s statuses and series state, 409 cases
  included.

Exact throughout: this slice does no arithmetic of its own.
"""

from __future__ import annotations

import http.server
import pathlib
import random
import sys
import threading
import time

import numpy as np
import pytest

from kube_gpu_stats_tpu import delta as ref_delta
from kube_gpu_stats_tpu import hub as ref_hub
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
from kube_gpu_stats_tpu_torch import delta, schema, snappy
from kube_gpu_stats_tpu_torch.registry import Registry, SnapshotBuilder
from kube_gpu_stats_tpu_torch.spillq import SpillQueue
from kube_gpu_stats_tpu_torch.testing.egress_sink import EgressSink
from kube_gpu_stats_tpu_torch.tracing import Tracer
from kube_gpu_stats_tpu_torch.validate import parse_exposition_interned

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import partition_sim  # noqa: E402  (the reference's scenarios)

def _frame_key(frame) -> tuple:
    """A frame as comparable data: values by repr (NaN == NaN)."""
    return (frame.kind, frame.source, frame.generation, frame.seq,
            frame.body, tuple(frame.slots),
            tuple(repr(float(v)) for v in frame.values), frame.proto,
            frame.caps, frame.build)


def _verdict(fn, wire: bytes):
    try:
        return "ok", _frame_key(fn(wire))
    except Exception as exc:  # noqa: BLE001 - the verdict is compared
        return type(exc).__name__, str(exc)


# -- frame codec -------------------------------------------------------------

def _changes(rng, n: int) -> list[tuple[int, float]]:
    slots = sorted(set(int(s) for s in rng.integers(0, 5000, n)))
    return [(slot, float(rng.normal() * 10 ** int(rng.integers(-3, 12))))
            for slot in slots]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("proto,caps,build", [(1, 0, ""), (2, 0, ""),
                                              (2, 1, ""), (2, 1, "0.1.0"),
                                              (2, 3, "build-x")])
def test_frames_encode_and_decode_as_the_reference(seed, proto, caps,
                                                   build):
    rng = np.random.default_rng(seed)
    source = f"http://node-{seed}:9400/metrics"
    generation = int(rng.integers(1, 2**62))
    seq = int(rng.integers(1, 2**40))
    body = "".join(f'accelerator_duty_cycle{{chip="{i}"}} {i * seed}\n'
                   for i in range(int(rng.integers(0, 50))))
    changes = _changes(rng, int(rng.integers(0, 60)))
    pairs = [
        (delta.encode_full(source, generation, seq, body, proto=proto,
                           caps=caps, build=build),
         ref_delta.encode_full(source, generation, seq, body, proto=proto,
                               caps=caps, build=build)),
        (delta.encode_delta(source, generation, seq, changes, proto=proto,
                            caps=caps, build=build),
         ref_delta.encode_delta(source, generation, seq, changes,
                                proto=proto, caps=caps, build=build)),
    ]
    for port_wire, ref_wire in pairs:
        assert port_wire == ref_wire
        got = _verdict(delta.decode_frame, port_wire)
        assert got[0] == "ok"
        assert got == _verdict(ref_delta.decode_frame, port_wire)


def test_unsorted_delta_slots_are_refused_as_the_reference():
    for module in (delta, ref_delta):
        with pytest.raises(ValueError, match="ascending"):
            module.encode_delta("s", 1, 1, [(5, 1.0), (2, 1.0)])


def _raw_frames(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for proto in (1, 2):
        full = delta.encode_full("src", 7, 3, "a 1\nb{x=\"y\"} 2\n",
                                 proto=proto, caps=1, build="b")
        dlt = delta.encode_delta("src", 7, 4, _changes(rng, 20),
                                 proto=proto, caps=1, build="b")
        out += [snappy.decompress(full), snappy.decompress(dlt)]
    return out


@pytest.mark.parametrize("seed", range(6))
def test_malformed_frames_draw_the_references_verdicts(seed):
    rng = np.random.default_rng(1000 + seed)
    cases = [b"", b"KTSD", b"KTSX\x01\x00", b"KTSD\x03\x00",
             b"KTSD\x01\x05", b"KTSD\x01\x00\x00",
             b"KTSD\x01\x01\x03src\x07\x04\x01\x00"]
    for raw in _raw_frames(seed):
        cases += [raw[:cut] for cut in range(len(raw))]
        for _ in range(60):
            flipped = bytearray(raw)
            for _ in range(int(rng.integers(1, 3))):
                flipped[int(rng.integers(0, len(flipped)))] = \
                    int(rng.integers(0, 256))
            cases.append(bytes(flipped))
        cases.append(raw + b"\x01")
    seen = set()
    for raw in cases:
        got = _verdict(delta.decode_frame_raw, raw)
        assert got == _verdict(ref_delta.decode_frame_raw, raw), raw.hex()
        wire = snappy.compress(raw)
        assert _verdict(delta.decode_frame, wire) == \
            _verdict(ref_delta.decode_frame, wire), raw.hex()
        seen.add(got[0])
    assert {"ok", "ValueError", "FrameVersionSkew"} <= seen


def test_a_frame_past_the_size_cap_is_refused_before_decompression():
    wire = snappy._varint(delta.MAX_FRAME_BYTES + 1) + b"\x00"
    assert _verdict(delta.decode_frame, wire) == \
        _verdict(ref_delta.decode_frame, wire) == \
        ("ValueError", "frame exceeds the size cap")


# -- the encoder ---------------------------------------------------------------

def _bodies(seed: int, count: int) -> list[str]:
    """Rendered expositions with seeded value churn and a shape change
    (a card appearing, then going) every so often."""
    rng = np.random.default_rng(seed)
    registry = Registry()
    out = []
    cards = 2
    for i in range(count):
        if i and i % 7 == 0:
            cards = 3 if cards == 2 else 2
        builder = SnapshotBuilder()
        for chip in range(cards):
            labels = (("accel_type", "h100"), ("chip", str(chip)),
                      ("device_path", f"/dev/nvidia{chip}"),
                      ("uuid", f"GPU-{chip}"))
            builder.add(schema.DEVICE_UP, 1.0, labels)
            value = float(rng.integers(0, 100)) if rng.random() < 0.4 \
                else 50.0
            builder.add(schema.DUTY_CYCLE, value, labels)
            builder.add(schema.POWER, float(rng.integers(80, 700)),
                        labels)
        registry.publish(builder.build())
        out.append(registry.rendered()[0].decode())
    return out


@pytest.mark.parametrize("seed", range(5))
def test_encoders_emit_equal_frames_through_ack_nack_defer(seed):
    rng = np.random.default_rng(seed)
    port = delta.DeltaEncoder("node", 99, build="b")
    ref = ref_delta.DeltaEncoder("node", 99, build="b")
    kinds = []
    for i, body in enumerate(_bodies(seed, 60)):
        if i % 11 == 5:
            wire = (int(rng.integers(1, 3)), int(rng.integers(0, 2)))
            assert port.set_wire(*wire) == ref.set_wire(*wire)
        got, want = port.encode_next(body), ref.encode_next(body)
        assert got == want, i
        kinds.append(got[1])
        action = rng.choice(["ack", "ack", "ack", "nack", "defer"])
        getattr(port, action)()
        getattr(ref, action)()
        assert (port.seq, port.full_frames, port.delta_frames, port.proto,
                port.caps) == (ref.seq, ref.full_frames, ref.delta_frames,
                               ref.proto, ref.caps)
    assert delta.KIND_FULL in kinds and delta.KIND_DELTA in kinds


# -- the publisher against the reference's receiver ---------------------------

class Receiver:
    """An HTTP server answering POST /ingest/delta with ``handle(wire,
    peer) -> (status, body, headers)``; counts what it answered."""

    def __init__(self, handle) -> None:
        self.handle = handle
        self.statuses: list[int] = []
        receiver = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - http.server's name
                wire = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                status, body, headers = receiver.handle(
                    wire, self.client_address[0])
                receiver.statuses.append(status)
                self.send_response(status)
                for key, value in headers.items():
                    self.send_header(key, value)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _ingest(**kwargs) -> ref_delta.DeltaIngest:
    """The reference's receiver with the hub's own ingest-cache entries
    (a bare DeltaIngest keeps sessions but no series)."""
    return ref_delta.DeltaIngest(
        native=False,
        entry_factory=lambda series: ref_hub._TargetCache(
            "", series, pushed=True), **kwargs)


@pytest.fixture
def receivers():
    made = []

    def make(handle) -> Receiver:
        receiver = Receiver(handle)
        made.append(receiver)
        return receiver

    yield make
    for receiver in made:
        receiver.close()


def _publish(registry, builder_cls, rng, cards: int = 2) -> None:
    builder = builder_cls()
    for chip in range(cards):
        labels = (("accel_type", "h100"), ("chip", str(chip)),
                  ("device_path", f"/dev/nvidia{chip}"),
                  ("uuid", f"GPU-{chip}"))
        builder.add(schema.DEVICE_UP, 1.0, labels)
        builder.add(schema.DUTY_CYCLE, float(rng.integers(0, 100)), labels)
    registry.publish(builder.build())


def _entry_series(ingest, source: str) -> list:
    entry = ingest._entry_store[source]
    return [(name, labels, value) for name, labels, value in entry.series]


@pytest.mark.parametrize("seed", range(3))
def test_publisher_state_equals_the_reference_ingest_after_each_publish(
        receivers, seed):
    rng = np.random.default_rng(seed)
    ingest = _ingest()
    receiver = receivers(ingest.handle)
    registry = Registry()
    publisher = delta.DeltaPublisher(registry, receiver.url, source="node",
                                     timeout=5.0, build="b")
    try:
        for i in range(25):
            _publish(registry, SnapshotBuilder, rng,
                     cards=3 if 8 <= i < 14 else 2)
            publisher.push_once()
            want = parse_exposition_interned(
                registry.rendered()[0].decode())
            assert _entry_series(ingest, "node") == want, i
        assert publisher.pushes_total == 25 and publisher.failures_total == 0
        assert ingest.full_frames_total == 3      # session + two shapes
        assert ingest.delta_frames_total == 22
        # The first 200's hello raised the wire to v2.
        assert publisher.negotiated_proto == 2
        assert publisher.proto_upgrades_total == 1
    finally:
        publisher.stop()


def test_a_409_is_answered_with_one_full_inside_the_push(receivers):
    rng = np.random.default_rng(4)
    ingest = _ingest()
    holder = {"ingest": ingest}
    receiver = receivers(lambda wire, peer: holder["ingest"].handle(wire,
                                                                    peer))
    registry = Registry()
    publisher = delta.DeltaPublisher(registry, receiver.url, source="node")
    try:
        for _ in range(3):
            _publish(registry, SnapshotBuilder, rng)
            publisher.push_once()
        holder["ingest"] = _ingest()       # the hub lost its sessions
        _publish(registry, SnapshotBuilder, rng)
        publisher.push_once()
        assert receiver.statuses[-2:] == [409, 200]
        assert publisher.resyncs_total == 1
        assert publisher.failures_total == 0
        assert holder["ingest"].full_frames_total == 1
        assert _entry_series(holder["ingest"], "node") == \
            parse_exposition_interned(registry.rendered()[0].decode())
    finally:
        publisher.stop()


def _scripted(codes: list[tuple[int, dict]], ingest):
    """Answer the scripted (status, headers) first, then pass through."""

    def handle(wire, peer):
        if codes:
            status, headers = codes.pop(0)
            return status, b"shed\n", headers
        return ingest.handle(wire, peer)

    return handle


@pytest.mark.parametrize("status,headers", [
    (429, {"Retry-After": "2"}), (503, {"Retry-After": "0.5"}),
    (413, {}), (413, {"Retry-After": "7"})])
def test_shed_responses_are_honoured_as_the_reference(receivers, status,
                                                      headers):
    runs = []
    for module, registry_cls, builder_cls in (
            (delta, Registry, SnapshotBuilder),
            (ref_delta, RefRegistry, RefBuilder)):
        rng = np.random.default_rng(5)
        ingest = _ingest()
        codes: list = []
        receiver = receivers(_scripted(codes, ingest))
        registry = registry_cls()
        publisher = module.DeltaPublisher(registry, receiver.url,
                                          source="node",
                                          rng=random.Random(11))
        try:
            _publish(registry, builder_cls, rng)
            publisher.push_once()
            codes.append((status, dict(headers)))
            _publish(registry, builder_cls, rng)
            before = time.monotonic()
            publisher.push_once()
            delay = publisher._shed_prev
            until = publisher._shed_until - before
            # Inside the window: no POST at all.
            _publish(registry, builder_cls, rng)
            posts = len(receiver.statuses)
            publisher.push_once()
            skipped = len(receiver.statuses) == posts
            publisher._shed_until = 0.0     # the window has passed
            publisher.push_once()
            runs.append({
                "statuses": receiver.statuses, "delay": delay,
                "skipped": skipped,
                "shed": publisher.shed_honored_total,
                "failures": publisher.failures_total,
                "resyncs": publisher.resyncs_total,
                "fulls": ingest.full_frames_total,
                "deltas": ingest.delta_frames_total,
                "state": _entry_series(ingest, "node"),
                "until_ok": 0.0 < until <= delay + 0.5})
        finally:
            publisher.stop()
    port, ref = runs
    assert port == ref
    assert port["statuses"] == [200, status, 200]
    assert port["shed"] == 1 and port["failures"] == 0
    assert port["skipped"] and port["until_ok"]
    # Known-unapplied: the next push is one DELTA, never a FULL.
    assert (port["fulls"], port["deltas"], port["resyncs"]) == (1, 1, 0)


def test_a_426_renegotiates_into_the_advertised_range(receivers):
    runs = []
    for module, registry_cls, builder_cls in (
            (delta, Registry, SnapshotBuilder),
            (ref_delta, RefRegistry, RefBuilder)):
        rng = np.random.default_rng(6)
        ingest = _ingest()
        holder = {"ingest": ingest}
        receiver = receivers(lambda wire, peer: holder["ingest"].handle(
            wire, peer))
        registry = registry_cls()
        publisher = module.DeltaPublisher(registry, receiver.url,
                                          source="node", build="b")
        try:
            for _ in range(2):
                _publish(registry, builder_cls, rng)
                publisher.push_once()
            # A hub that now accepts only v2 refuses nothing (we are at
            # v2); one pinned to v1 refuses our v2 deltas with 426.
            old = _ingest(proto_max=1)
            for lane in ingest._lanes:
                for source, session in lane.sessions.items():
                    old._lanes[0].sessions[source] = session
            old._entry_store.update(ingest._entry_store)
            holder["ingest"] = old
            _publish(registry, builder_cls, rng)
            publisher.push_once()
            runs.append((list(receiver.statuses),
                         publisher.skew_status() | {"build": ""},
                         publisher.failures_total,
                         _entry_series(old, "node")))
        finally:
            publisher.stop()
    port, ref = runs
    assert port == ref
    statuses, skew, failures, _ = port
    assert statuses == [200, 200, 426, 200]
    assert skew["negotiated_proto"] == 1
    assert skew["proto_downgrades_total"] == 1
    assert skew["skew_refused_total"] == 1 and failures == 0


@pytest.mark.parametrize("with_spill", [False, True])
def test_a_disjoint_range_is_counted_as_refused(tmp_path, with_spill):
    from kube_gpu_stats_tpu.spillq import SpillQueue as RefSpillQueue

    sink = EgressSink(proto_min=3, proto_max=3).start()
    rows = []
    try:
        for module, registry_cls, builder_cls, spill_cls in (
                (delta, Registry, SnapshotBuilder, SpillQueue),
                (ref_delta, RefRegistry, RefBuilder, RefSpillQueue)):
            rng = np.random.default_rng(7)
            registry = registry_cls()
            spill = (spill_cls(str(tmp_path / module.__name__),
                               fsync=False) if with_spill else None)
            publisher = module.DeltaPublisher(registry, sink.url,
                                              source="node", spill=spill)
            try:
                for _ in range(3):
                    _publish(registry, builder_cls, rng)
                    publisher.push_once()
                status = publisher.skew_status()
                rows.append((status["skew_refused_total"],
                             status["negotiated_proto"],
                             publisher.failures_total,
                             publisher.consecutive_failures,
                             publisher.backlog_depth))
            finally:
                publisher.stop()
    finally:
        sink.stop()
    assert rows[0] == rows[1]
    # A refusal is its own counter, never a failure; with a spill queue
    # the refused snapshots spool (the probe backs off meanwhile).
    assert rows[0] == ((1, 1, 0, 0, 3) if with_spill else (3, 1, 0, 3, 0))
    assert sink.delta_status == {426: 2 if with_spill else 6}


def test_the_publisher_counts_the_snapshots_it_never_took_in(receivers):
    """The port's one addition to the publisher: generations published
    between two pushes are neither sent nor spooled (the reference's
    follower renders the newest); the port counts them."""
    rng = np.random.default_rng(9)
    receiver = receivers(_ingest().handle)
    registry = Registry()
    publisher = delta.DeltaPublisher(registry, receiver.url, source="node",
                                     rng=random.Random(3))
    try:
        pushed = 0
        for i in range(20):
            _publish(registry, SnapshotBuilder, rng)
            if i % 4 == 3:
                publisher.push_once()
                pushed += 1
        assert publisher.pushes_total == pushed == 5
        # 3 unseen before the first push (which anchors), 3 per push after.
        assert publisher.skipped_total == 12
        publisher.push_once()                 # the same generation again
        assert publisher.skipped_total == 12
    finally:
        publisher.stop()


# -- tools/partition_sim.py's scenarios, the port's side ----------------------

def test_hub_blackout_scenario_with_the_port_publisher(tmp_path):
    """partition_sim.scenario_hub_blackout with the port's daemons,
    publishers and spill queues against the reference's hub: every
    snapshot of the blackout spools, the backlog drains to 0 with 0
    drops, at most one FULL per publisher, no resync, live deltas
    resume."""
    from kube_gpu_stats_tpu.exposition import MetricsServer as RefServer
    from kube_gpu_stats_tpu_torch.config import Config
    from kube_gpu_stats_tpu_torch.daemon import Daemon

    wait_for = partition_sim.wait_for
    daemons_n = 2
    hub = ref_hub.Hub([], targets_provider=lambda: [], interval=0.2,
                      push_fence=1e9)
    server = RefServer(hub.registry, host="127.0.0.1", port=0,
                       ingest_provider=hub.delta.handle)
    server.start()
    port = server.port
    daemons, publishers, spills = [], [], []
    server2 = None
    try:
        for node in range(daemons_n):
            d = Daemon(Config(backend="mock", attribution="off",
                              interval=0.05, listen_port=0,
                              listen_host="127.0.0.1",
                              device_processes="off"))
            d.start()
            daemons.append(d)
            spill = SpillQueue(str(tmp_path / f"spill-{node}"),
                               tracer=d.tracer)
            spills.append(spill)
            publisher = delta.DeltaPublisher(
                d.registry, f"http://127.0.0.1:{port}",
                source=f"http://node-{node}:9400/metrics",
                min_interval=0.02, timeout=1.0, spill=spill,
                drain_rate=2000.0, tracer=d.tracer)
            publisher.start()
            publishers.append(publisher)
        assert wait_for(lambda: all(p.pushes_total >= 2
                                    for p in publishers), 15.0)
        server.stop()
        assert wait_for(lambda: all(s.depth() >= 5 for s in spills), 15.0)
        fulls_before = hub.delta.full_frames_total
        spooled_at_cut = [s.spooled_total for s in spills]
        server2 = RefServer(hub.registry, host="127.0.0.1", port=port,
                            ingest_provider=hub.delta.handle)
        server2.start()
        for publisher in publishers:
            publisher._probe_at = 0.0
        assert wait_for(lambda: all(s.depth() == 0 for s in spills), 20.0)
        for node, spill in enumerate(spills):
            assert spill.dropped_total == 0
            assert spill.drained_total >= spooled_at_cut[node]
        new_fulls = hub.delta.full_frames_total - fulls_before
        total_drained = sum(s.drained_total for s in spills)
        assert new_fulls <= max(2 * daemons_n, total_drained // 2)
        assert hub.delta.resyncs_total == 0
        pushes = [p.pushes_total for p in publishers]
        assert wait_for(lambda: all(p.pushes_total > pushes[i] + 2
                                    for i, p in enumerate(publishers)),
                        10.0)
        events = [e["kind"] for e in daemons[0].tracer.events(0)["events"]]
        assert "spill_start" in events and "spill_drained" in events
    finally:
        for publisher in publishers:
            publisher.stop()
        for d in daemons:
            d.stop()
        if server2 is not None:
            server2.stop()
        server.stop()
        hub.stop()


def test_beyond_bounds_scenario_with_the_port_publisher(tmp_path):
    """partition_sim.scenario_beyond_bounds on the port: a spool bounded
    far below the backlog loses oldest-first, journals spill_drop, and
    after reconnect spooled == drained + dropped exactly."""
    from kube_gpu_stats_tpu.exposition import MetricsServer as RefServer

    worker = Registry()

    def publish(value: float) -> None:
        builder = SnapshotBuilder()
        labels = (("accel_type", "h100"), ("chip", "0"),
                  ("device_path", "/dev/nvidia0"), ("uuid", ""))
        builder.add(schema.DEVICE_UP, 1.0, labels)
        builder.add(schema.DUTY_CYCLE, value, labels)
        builder.add(schema.ICI_TRAFFIC_TOTAL, value * 7.0,
                    labels + (("link", "0"), ("direction", "tx")))
        worker.publish(builder.build())

    tracer = Tracer(enabled=True)
    spill = SpillQueue(str(tmp_path / "tiny-spill"), max_bytes=1 << 16,
                       fsync=False, tracer=tracer)
    publisher = delta.DeltaPublisher(worker, "http://127.0.0.1:9",
                                     source="node-tiny", timeout=0.2,
                                     spill=spill, drain_rate=10_000.0)
    hub = server = None
    try:
        total = 400
        for i in range(total):
            publish(float(i))
            publisher.push_once()
        assert spill.dropped_total > 0
        head = spill.peek()
        assert head is not None and 'accelerator_duty_cycle{' in head[1]
        assert ' 0\n' not in head[1].split("accelerator_duty_cycle{")[1]
        events = tracer.events(0)["events"]
        assert any(e.get("kind") == "spill_drop" for e in events)
        hub = ref_hub.Hub([], targets_provider=lambda: [], interval=10.0,
                          push_fence=1e9)
        server = RefServer(hub.registry, host="127.0.0.1", port=0,
                           ingest_provider=hub.delta.handle)
        server.start()
        publisher._url = f"http://127.0.0.1:{server.port}/ingest/delta"
        publisher._probe_at = 0.0
        publish(9999.0)
        publisher.push_once()
        assert spill.depth() == 0
        assert spill.spooled_total == spill.drained_total + \
            spill.dropped_total
        assert publisher.spill_status()["dropped_total"] == \
            spill.dropped_total
        assert publisher.failures_total >= 1
    finally:
        publisher.stop()
        if server is not None:
            server.stop()
        if hub is not None:
            hub.stop()


# -- the sink against the reference's DeltaIngest -----------------------------

def _frame_sequence(seed: int) -> list[bytes]:
    """Frames a publisher would send, plus the faults a receiver must
    refuse: seq gaps, a stale generation, a DELTA before any FULL, a
    retransmitted FULL, a slot past the series, a version outside the
    range, garbage."""
    rng = np.random.default_rng(seed)
    encoder = delta.DeltaEncoder("node-a", 1000 + seed, build="b")
    frames = [delta.encode_delta("node-a", 5, 1, [(0, 1.0)])]
    bodies = _bodies(seed, 40)
    last_full = None
    for i, body in enumerate(bodies):
        if i == 20:
            encoder.set_wire(2, 1)
        wire, kind = encoder.encode_next(body)
        frames.append(wire)
        if kind == delta.KIND_FULL:
            last_full = wire
        roll = rng.random()
        if roll < 0.1:
            encoder.nack()
        elif roll < 0.15:
            encoder.defer()
        else:
            encoder.ack()
        if i == 12 and last_full is not None:
            frames.append(last_full)          # retransmitted FULL
        if i == 15:
            frames.append(delta.encode_delta(
                "node-a", encoder.generation, encoder.seq + 1,
                [(10_000, 1.0)]))
        if i == 25:
            frames.append(delta.encode_delta(
                "node-a", 1, encoder.seq + 1, [(0, 2.0)]))
        if i == 30:
            frames.append(snappy.compress(b"KTSD\x05\x00garbage"))
            frames.append(b"not snappy at all")
    return frames


@pytest.mark.parametrize("seed", range(4))
def test_the_sink_applies_frames_as_the_reference_ingest(seed):
    ingest = _ingest()
    sink = EgressSink()
    statuses = []
    for wire in _frame_sequence(seed):
        got = sink.handle_delta(wire)
        want = ingest.handle(wire)
        statuses.append(got[0])
        assert got[0] == want[0], wire[:32]
        if got[0] in (200, 409, 426):
            assert got[2] == {k: v for k, v in want[2].items()
                              if k != delta.HELLO_BUILD} | {
                delta.HELLO_BUILD: "egress-sink"}
        sessions = sink.sessions()
        if "node-a" in sessions and "node-a" in ingest._entry_store:
            assert sessions["node-a"] == _entry_series(ingest, "node-a")
    assert {200, 409, 400} <= set(statuses)
    applied = sink.applied("node-a")
    assert sum(a.duplicate for a in applied) == ingest.duplicate_frames_total
    assert sum(a.kind == delta.KIND_FULL and not a.duplicate
               for a in applied) == ingest.full_frames_total
    assert sum(a.kind == delta.KIND_DELTA for a in applied) == \
        ingest.delta_frames_total


def test_the_sink_refuses_versions_outside_its_range_as_the_reference():
    sink = EgressSink(proto_min=2, proto_max=2)
    ingest = _ingest(proto_min=2)
    wire = delta.encode_full("node", 1, 1, "a 1\n")
    got, want = sink.handle_delta(wire), ingest.handle(wire, "10.0.0.1")
    assert got[0] == want[0] == 426
    assert got[1] == want[1]
    assert got[2]["Retry-After"] == want[2]["Retry-After"] == "60"
    assert got[2][delta.HELLO_PROTO_MIN] == want[2][delta.HELLO_PROTO_MIN]


def test_the_sink_blackout_refuses_then_restores_with_sessions(tmp_path):
    sink = EgressSink().start()
    registry = Registry()
    rng = np.random.default_rng(8)
    spill = SpillQueue(str(tmp_path / "spill"), fsync=False)
    publisher = delta.DeltaPublisher(registry, sink.url, source="node",
                                     spill=spill, timeout=1.0)
    try:
        for _ in range(3):
            _publish(registry, SnapshotBuilder, rng)
            publisher.push_once()
        port = sink.port
        sink.blackout()
        for _ in range(4):
            _publish(registry, SnapshotBuilder, rng)
            publisher.push_once()
        assert spill.depth() == 4 and publisher.failures_total == 1
        sink.restore()
        assert sink.port == port
        publisher._probe_at = 0.0
        _publish(registry, SnapshotBuilder, rng)
        publisher.push_once()
        assert spill.depth() == 0 and spill.drained_total == 5
        applied = sink.applied("node")
        assert [a.kind for a in applied] == [0, 1, 1, 0, 1, 1, 1, 1]
        assert sink.sessions()["node"] == parse_exposition_interned(
            registry.rendered()[0].decode())
    finally:
        publisher.stop()
        sink.stop()
