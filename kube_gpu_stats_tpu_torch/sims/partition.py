"""Partition: the durable egress layer through cut, flapped, shed and slow
links.

The port of the reference's ``tools/partition_sim.py``: real NVML daemons
(over ``testing.fake_nvml``) publishing through real ``DeltaPublisher``s
with disk spill queues into a real ``MetricsServer``-fronted hub, and a
durable sharded ``RemoteWriter`` shipping into a remote-write receiver
(``testing.egress_sink``):

- **hub blackout**: the hub's listener dies mid-flight. Every snapshot
  the publishers take in spools, and on reconnect (a new listener on the
  same port, the same hub) the backlog drains oldest-first to 0 with 0
  dropped, no resync and at most a session FULL per publisher, then live
  deltas resume;
- **beyond bounds**: a spool bounded far below the backlog loses
  oldest-first, journals ``spill_drop``, and closes its accounting
  (spooled == drained + dropped) after the reconnect;
- **drain rate and shed**: an 80-frame backlog drains at no more than
  burst + rate (25 a second) into a recovering hub, and an
  admission-controlled hub's 429s are honoured (deferred, never turned
  into FULLs: one session FULL in all, no resync), the backlog draining
  as deltas once the pressure lifts;
- **TSDB blackout**: the durable writer journals through two receiver
  outages and a slow stretch and the receiver then holds every request
  exactly once, oldest-first, with the lag metered; a WAL bounded below
  the backlog drops oldest-first, counted and journaled.

The scenarios' synthetic snapshots carry the reference's labels byte for
byte (``accel_type="tpu-v5p"``, as ``bench.build_pusher_body``), so the
spool's and the WAL's bytes, and with them what a bound drops, are the
reference's too. The receiver's outages close its listener, as the
reference's do.
"""

from __future__ import annotations

import pathlib
import tempfile
import time

from ._common import Result, nvml_daemon, wait_for

# The synthetic card's labels: the reference's, byte for byte.
LABELS = (("accel_type", "tpu-v5p"), ("chip", "0"),
          ("device_path", "/dev/accel0"), ("uuid", ""))
BOUNDS_FRAMES = 400
DRAIN_BACKLOG = 80
DRAIN_RATE = 25.0             # frames a second; the burst is one interval's
SHED_BACKLOG = 5
TSDB_BOUNDS_SNAPSHOTS = 120


def _server(hub, port: int = 0):
    from ..exposition import MetricsServer

    server = MetricsServer(hub.registry, host="127.0.0.1", port=port,
                           ingest_provider=hub.delta.handle)
    server.start()
    return server


def _bare_hub(interval: float, **kw):
    from ..hub import Hub

    return Hub([], targets_provider=lambda: [], interval=interval,
               push_fence=1e9, **kw)


def scenario_hub_blackout(tmp: str, daemons_n: int = 2) -> Result:
    """NVML daemons and their spill queues through a listener blackout."""
    from ..delta import DeltaPublisher
    from ..spillq import SpillQueue

    result = Result("blackout")
    problems = result.problems
    hub = _bare_hub(0.2)
    server = _server(hub)
    port = server.port
    daemons: list = []
    publishers: list = []
    spills: list = []
    server2 = None
    try:
        for node in range(daemons_n):
            daemon, _fake, _faults = nvml_daemon(
                pathlib.Path(tmp) / f"node{node}", node, interval=0.05,
                device_processes="off")
            daemon.start()
            daemons.append(daemon)
            spill = SpillQueue(str(pathlib.Path(tmp) / f"spill-{node}"),
                               tracer=daemon.tracer)
            spills.append(spill)
            publisher = DeltaPublisher(
                daemon.registry, f"http://127.0.0.1:{port}",
                source=f"http://node-{node}:9400/metrics",
                min_interval=0.02, timeout=1.0, spill=spill,
                drain_rate=2000.0, tracer=daemon.tracer)
            publisher.start()
            publishers.append(publisher)
        synced = wait_for(lambda: all(p.pushes_total >= 2
                                      for p in publishers), 15.0)
        if not synced:
            problems.append("blackout: publishers never synced to the hub")

        # The blackout: the listener gone, the daemons sampling on.
        cut_at = time.monotonic()
        server.stop()
        spooling = wait_for(lambda: all(s.depth() >= 5 for s in spills),
                            15.0)
        if not spooling:
            problems.append(f"blackout: snapshots not spooling (depths "
                            f"{[s.depth() for s in spills]})")
        spool_s = time.monotonic() - cut_at
        fulls_before = hub.delta.full_frames_total
        spooled_at_cut = [s.spooled_total for s in spills]

        # Recovery: the same port, the same hub (its sessions intact).
        server2 = _server(hub, port=port)
        for publisher in publishers:
            publisher._probe_at = 0.0
        drain_from = time.monotonic()
        drained = wait_for(lambda: all(s.depth() == 0 for s in spills),
                           20.0)
        drain_s = time.monotonic() - drain_from
        if not drained:
            problems.append(f"blackout: backlog never drained (depths "
                            f"{[s.depth() for s in spills]})")
        dropped = sum(s.dropped_total for s in spills)
        lost = sum(max(0, spooled_at_cut[i] - s.drained_total)
                   for i, s in enumerate(spills))
        if dropped:
            problems.append(f"blackout: {dropped} frame(s) dropped inside "
                            f"the spool's bounds")
        if lost:
            problems.append(f"blackout: {lost} spooled record(s) never "
                            f"drained")
        new_fulls = hub.delta.full_frames_total - fulls_before
        total_drained = sum(s.drained_total for s in spills)
        # One re-establishing FULL per publisher, plus a shape change's
        # FULL when the daemon's own series set grows (its trace digest
        # warming up); what must not happen is a FULL per frame.
        amplified = new_fulls > max(2 * daemons_n, total_drained // 2)
        if amplified:
            problems.append(f"blackout: {new_fulls} FULLs for "
                            f"{total_drained} drained frames across "
                            f"{daemons_n} publishers (FULL amplification)")
        if hub.delta.resyncs_total:
            problems.append(f"blackout: {hub.delta.resyncs_total} "
                            f"resync(s): recovery must re-establish "
                            f"without a 409 loop")
        pushes = [p.pushes_total for p in publishers]
        resumed = wait_for(lambda: all(p.pushes_total > pushes[i] + 2
                                       for i, p in enumerate(publishers)),
                           10.0)
        if not resumed:
            problems.append("blackout: live deltas did not resume")
        events = {e["kind"] for d in daemons
                  for e in d.tracer.events(0)["events"]}
        journaled = {"spill_start", "spill_drained"} <= events
        if not journaled:
            problems.append(f"blackout: spill_start/spill_drained not "
                            f"journaled ({sorted(events)})")
        hub.refresh_once()
        result.figures.update(
            daemons=daemons_n, synced=synced, spooling=spooling,
            drained_to_zero=drained, dropped=dropped, lost=lost,
            full_amplification=amplified,
            resyncs=hub.delta.resyncs_total, live_resumed=resumed,
            journaled=journaled)
        result.timings.update(
            spooled=sum(spooled_at_cut), drained=total_drained,
            session_fulls=new_fulls, spool_s=spool_s, drain_s=drain_s)
    finally:
        for publisher in publishers:
            publisher.stop()
        for daemon in daemons:
            daemon.stop()
        if server2 is not None:
            server2.stop()
        server.stop()
        hub.stop()
    return result


def _publisher_of(worker):
    """publish(value): one synthetic snapshot into ``worker``."""
    from .. import schema
    from ..registry import SnapshotBuilder

    def publish(value: float, ici: bool = False) -> None:
        builder = SnapshotBuilder()
        builder.add(schema.DEVICE_UP, 1.0, LABELS)
        builder.add(schema.DUTY_CYCLE, value, LABELS)
        if ici:
            builder.add(schema.ICI_TRAFFIC_TOTAL, value * 7.0,
                        LABELS + (("link", "0"), ("direction", "tx")))
        worker.publish(builder.build())

    return publish


def scenario_beyond_bounds(tmp: str) -> Result:
    """A partition that outlasts the spool: oldest-first, accounted."""
    from ..delta import DeltaPublisher
    from ..registry import Registry
    from ..spillq import SpillQueue
    from ..tracing import Tracer

    result = Result("bounds")
    problems = result.problems
    worker = Registry()
    publish = _publisher_of(worker)
    tracer = Tracer(enabled=True)
    spill = SpillQueue(str(pathlib.Path(tmp) / "tiny-spill"),
                       max_bytes=1 << 16, fsync=False, tracer=tracer)
    publisher = DeltaPublisher(worker, "http://127.0.0.1:9",
                               source="node-tiny", timeout=0.2,
                               spill=spill, drain_rate=10_000.0)
    hub = server = None
    try:
        for i in range(BOUNDS_FRAMES):
            publish(float(i), ici=True)
            publisher.push_once()
        engaged = spill.dropped_total > 0
        if not engaged:
            problems.append(f"bounds: the byte bound never engaged "
                            f"({spill.bytes_pending()}B spooled)")
        head = spill.peek()
        oldest_first = head is not None and head[1].find(" 0\n") != 0
        if not oldest_first:
            problems.append("bounds: eviction was not oldest-first")
        journaled = any(e.get("kind") == "spill_drop"
                        for e in tracer.events(0)["events"])
        if not journaled:
            problems.append("bounds: no spill_drop journal event")
        # Reconnect: the survivors drain and the accounting closes.
        hub = _bare_hub(10.0)
        server = _server(hub)
        publisher._url = f"http://127.0.0.1:{server.port}/ingest/delta"
        publisher._probe_at = 0.0
        publish(9999.0, ici=True)
        publisher.push_once()
        left = spill.depth()
        if left:
            problems.append(f"bounds: {left} frame(s) left after drain")
        closes = spill.spooled_total == (spill.drained_total
                                         + spill.dropped_total)
        if not closes:
            problems.append(f"bounds: accounting leak: spooled "
                            f"{spill.spooled_total} != drained "
                            f"{spill.drained_total} + dropped "
                            f"{spill.dropped_total}")
        agrees = publisher.spill_status()["dropped_total"] == \
            spill.dropped_total
        if not agrees:
            problems.append("bounds: spill_status disagrees with the "
                            "queue's drop count")
        result.figures.update(
            frames=BOUNDS_FRAMES + 1, bound_engaged=engaged,
            oldest_first=oldest_first, journaled=journaled, left=left,
            accounting_closes=closes, status_agrees=agrees,
            dropped=spill.dropped_total, drained=spill.drained_total)
    finally:
        publisher.stop()
        if server is not None:
            server.stop()
        if hub is not None:
            hub.stop()
    return result


def scenario_drain_rate_and_shed(tmp: str) -> Result:
    """A backlog against a recovering, admission-controlled hub: the rate
    capped, sheds honoured, no FULL amplification."""
    from ..delta import DeltaPublisher
    from ..registry import Registry
    from ..spillq import SpillQueue

    result = Result("drain")
    problems = result.problems
    worker = Registry()
    publish = _publisher_of(worker)

    # The rate cap: 80 frames at 25 a second take at least ~2 s.
    hub = _bare_hub(10.0)
    server = _server(hub)
    spill = SpillQueue(str(pathlib.Path(tmp) / "rate-spill"), fsync=False)
    publisher = DeltaPublisher(
        worker, f"http://127.0.0.1:{server.port}", source="node-rate",
        spill=spill, drain_rate=DRAIN_RATE)
    try:
        for i in range(DRAIN_BACKLOG):
            publish(float(i))
            spill.spool(time.time(), worker.rendered()[0].decode())
        start = time.monotonic()
        while spill.depth() and time.monotonic() - start < 15.0:
            publisher.push_once()  # the follower's cadence, compressed
            time.sleep(0.01)
        elapsed = time.monotonic() - start
        undrained = spill.depth()
        if undrained:
            problems.append(f"rate: {undrained} frame(s) undrained")
        achieved = DRAIN_BACKLOG / max(elapsed, 1e-9)
        # One publish interval's burst up front, then the knob: the
        # recovering hub never sees more than burst + rate * t.
        over_rate = achieved > 2.0 * DRAIN_RATE
        if over_rate:
            problems.append(f"rate: drained {DRAIN_BACKLOG} frames in "
                            f"{elapsed:.2f}s ({achieved:.0f}/s > 2x the "
                            f"{DRAIN_RATE:g}/s knob)")
        too_fast = elapsed < 0.8 * (DRAIN_BACKLOG - DRAIN_RATE) / DRAIN_RATE
        if too_fast:
            problems.append(f"rate: drain finished in {elapsed:.2f}s, "
                            f"faster than the knob permits even with the "
                            f"burst")
        result.figures.update(backlog=DRAIN_BACKLOG, rate_cap=DRAIN_RATE,
                              undrained=undrained, over_rate=over_rate,
                              faster_than_knob=too_fast)
        result.timings.update(drain_s=elapsed, drain_per_s=achieved)
    finally:
        publisher.stop()
        server.stop()
        hub.stop()

    # Shed honouring: an admission-controlled hub, no FULL amplification.
    hub = _bare_hub(10.0, ingest_lanes=1, ingest_delta_rate=1e-6)
    server = _server(hub)
    spill2 = SpillQueue(str(pathlib.Path(tmp) / "shed-spill"), fsync=False)
    publisher2 = DeltaPublisher(
        worker, f"http://127.0.0.1:{server.port}", source="node-shed",
        spill=spill2, drain_rate=10_000.0)
    try:
        for i in range(SHED_BACKLOG):
            publish(100.0 + i)
            spill2.spool(time.time(), worker.rendered()[0].decode())
        publish(200.0)
        publisher2.push_once()
        honoured = publisher2.shed_honored_total
        if not honoured:
            problems.append("shed: the hub's 429 was never honoured")
        fulls_under_shed = hub.delta.full_frames_total
        if fulls_under_shed != 1:
            problems.append(f"shed: {fulls_under_shed} FULLs under shed "
                            f"(want exactly the 1 session FULL)")
        # The pressure lifts: the drain completes as deltas.
        for lane in hub.delta._lanes:
            lane.bucket = None
        publisher2._shed_until = 0.0
        deadline = time.monotonic() + 10.0
        while spill2.depth() and time.monotonic() < deadline:
            publisher2.push_once()
            time.sleep(0.01)
        stuck = spill2.depth()
        if stuck:
            problems.append("shed: backlog stuck after pressure lifted")
        fulls, resyncs = hub.delta.full_frames_total, \
            hub.delta.resyncs_total
        if fulls != 1 or resyncs:
            problems.append(f"shed: post-recovery FULLs {fulls} / resyncs "
                            f"{resyncs} (want 1 / 0)")
        result.figures.update(
            shed_honoured=honoured > 0, fulls_under_shed=fulls_under_shed,
            stuck=stuck, fulls=fulls, resyncs=resyncs)
        result.timings.update(shed_honoured=honoured)
    finally:
        publisher2.stop()
        server.stop()
        hub.stop()
    return result


def scenario_tsdb_blackout(tmp: str) -> Result:
    """The durable RemoteWriter through two receiver blackouts (a flap)
    and a slow stretch: exactly once, oldest-first, the lag metered."""
    from .. import schema
    from ..registry import Registry, SnapshotBuilder
    from ..remote_write import RemoteWriter
    from ..testing.egress_sink import EgressSink
    from ..tracing import Tracer

    result = Result("tsdb")
    problems = result.problems
    registry = Registry()
    published = [0]

    def publish(into, fat: int = 0) -> None:
        builder = SnapshotBuilder()
        builder.add(schema.DUTY_CYCLE, float(published[0]), LABELS)
        for i in range(fat):  # fatten the request past compression
            builder.add(schema.DUTY_CYCLE, float(published[0] * i),
                        (("accel_type", "tpu-v5p"), ("chip", str(i + 1)),
                         ("device_path", f"/dev/accel{i + 1}"),
                         ("uuid", "")))
        into.publish(builder.build())
        published[0] += 1
        time.sleep(0.002)  # distinct snapshot timestamps

    def unblock(writer) -> None:
        for shard in writer._shards:
            shard.retry_at = 0.0

    # The receiver: every request decoded and kept in arrival order; its
    # outages close the listener and open it again on the same port.
    tsdb = EgressSink().start()
    tracer = Tracer(enabled=True)
    writer = RemoteWriter(
        registry, f"http://127.0.0.1:{tsdb.port}/api/v1/write",
        job="kts", instance="sim", min_interval=0.0, shards=2,
        wal_dir=str(pathlib.Path(tmp) / "rw-wal"), wal_fsync=False,
        drain_max_per_push=256, tracer=tracer)
    writer2 = None
    try:
        enqueued = 0
        publish(registry)
        writer.push_once()
        enqueued += 1
        empty_cycles = stuck_cycles = 0
        for cycle in range(2):  # two outages: the flap
            tsdb.stop()
            for _ in range(8):
                publish(registry)
                unblock(writer)
                writer.push_once()
                enqueued += 1
            if writer.backlog_records() == 0:
                empty_cycles += 1
                problems.append(f"tsdb: cycle {cycle} WAL empty during "
                                f"the blackout")
            tsdb.start()
            unblock(writer)
            writer.push_once()
            if writer.backlog_records():
                stuck_cycles += 1
                problems.append(f"tsdb: cycle {cycle} backlog "
                                f"{writer.backlog_records()} after "
                                f"recovery")
        tsdb.write_delay = 0.05
        for _ in range(4):
            publish(registry)
            unblock(writer)
            writer.push_once()
            enqueued += 1
        tsdb.write_delay = 0.0
        unblock(writer)
        writer.push_once()
        # Every enqueued snapshot arrived once on each shard that holds
        # samples (the one series hashes to one of the two).
        sending = sum(1 for shard in writer._shards if shard.sent_total)
        requests = [w.series for w in tsdb.writes()]
        expected = enqueued * sending
        backlog = writer.backlog_records()
        if len(requests) != expected or backlog:
            problems.append(f"tsdb: {len(requests)} requests arrived, want "
                            f"{expected} (backlog {backlog})")
        ts = [request[0][1][0][1] for request in requests if request]
        in_order = all(b >= a for a, b in zip(ts, ts[1:]))
        if not in_order:
            problems.append("tsdb: samples arrived out of order")
        status = writer.egress_status()
        lag_metered = max(s["lag_seconds"] for s in status["shards"]) > 0.0
        if not lag_metered:
            problems.append("tsdb: lag self-metering never engaged")
        dropped_in_bounds = sum(s["dropped_total"]
                                for s in status["shards"])
        if dropped_in_bounds:
            problems.append("tsdb: drops inside WAL bounds")
        writer.stop()

        # Beyond bounds: a WAL far smaller than the backlog.
        registry2 = Registry()
        published[0] = 0
        tsdb.stop()
        tracer2 = Tracer(enabled=True)
        writer2 = RemoteWriter(
            registry2, f"http://127.0.0.1:{tsdb.port}/api/v1/write",
            job="kts", instance="sim2", min_interval=0.0,
            wal_dir=str(pathlib.Path(tmp) / "rw-wal-tiny"),
            wal_max_bytes=1 << 16, wal_fsync=False,
            drain_max_per_push=512, tracer=tracer2)
        for _ in range(TSDB_BOUNDS_SNAPSHOTS):
            publish(registry2, fat=64)
            writer2._shards[0].retry_at = time.monotonic() + 60  # no probe
            writer2.push_once()
        shard = writer2._shards[0]
        engaged = shard.dropped_total > 0
        if not engaged:
            problems.append("tsdb bounds: the WAL bound never engaged")
        journaled = any(e.get("kind") == "remote_write_drop"
                        for e in tracer2.events(0)["events"])
        if not journaled:
            problems.append("tsdb bounds: no remote_write_drop journal "
                            "event")
        delivered_before = len(tsdb.writes())
        tsdb.start()
        shard.retry_at = 0.0
        writer2.push_once()
        stuck = writer2.backlog_records()
        if stuck:
            problems.append(f"tsdb bounds: {stuck} records stuck after "
                            f"recovery")
        survivors = [w.series for w in tsdb.writes()[delivered_before:]]
        # Oldest-first loss: the survivors are the newest snapshots.
        first_value = survivors[0][0][1][0][0] if survivors else -1
        oldest_first = first_value > 0.0
        if not oldest_first:
            problems.append("tsdb bounds: eviction was not oldest-first")
        result.figures.update(
            requests=len(requests), expected=expected, backlog=backlog,
            sending_shards=sending, empty_cycles=empty_cycles,
            stuck_cycles=stuck_cycles, in_order=in_order,
            lag_metered=lag_metered, dropped_in_bounds=dropped_in_bounds,
            bounds_snapshots=TSDB_BOUNDS_SNAPSHOTS,
            bounds_engaged=engaged, bounds_journaled=journaled,
            bounds_stuck=stuck, bounds_oldest_first=oldest_first,
            bounds_dropped=shard.dropped_total,
            bounds_delivered=len(survivors))
    finally:
        writer.stop()
        if writer2 is not None:
            writer2.stop()
        tsdb.stop()
    return result


def run(daemons: int = 2) -> Result:
    result = Result("partition")
    with tempfile.TemporaryDirectory() as tmp:
        for name, scenario, args in (
                ("blackout", scenario_hub_blackout, (daemons,)),
                ("bounds", scenario_beyond_bounds, ()),
                ("drain", scenario_drain_rate_and_shed, ()),
                ("tsdb", scenario_tsdb_blackout, ())):
            path = pathlib.Path(tmp) / name
            path.mkdir()
            result.merge(scenario(str(path), *args), name)
    return result


def add_arguments(parser) -> None:
    parser.add_argument("--daemons", type=int, default=2)


def main(args) -> Result:
    result = run(args.daemons)
    print(result.report(
        f"hub blackout drained late but whole ({args.daemons} NVML "
        f"daemons, 0 lost, no 409 loop), beyond-bounds loss oldest-first "
        f"and accounted, drain rate capped with sheds honoured and no FULL "
        f"amplification, TSDB flap and slow link delivered exactly once "
        f"with the lag metered"))
    return result
