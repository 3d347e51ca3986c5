"""Fleet chaos: the root hub's survival layer over real HTTP.

The port of the reference's ``tools/chaos_sim.py``: real NVML daemons
(over ``testing.fake_nvml``) pushing deltas through real
``DeltaPublisher``s into real ``MetricsServer``-fronted hubs, with the
failures a fleet meets:

- **hub kill and warm restart**: a checkpointing root hub with the
  daemons and N synthesized sessions is killed at its last checkpoint
  and restarted on the same port. At least 95% of the sessions continue
  their delta chains with no FULL, no session is dropped, ``/readyz``
  gates on the replay;
- **publisher stampede**: an admission-controlled hub takes a delta
  blast from concurrent threads: it sheds with 429 + Retry-After (never
  5xx), admits every recovery FULL mid-storm, keeps every established
  session, and holds the new-session fence closed at capacity. Whether
  the blast is over budget depends on how fast the host sends it (each
  of the 4 lanes admits a burst of 80 deltas and 40 a second), so the
  check is the buckets' arithmetic: on each lane the deltas that landed
  are at most the burst plus the refill over the blast, and a lane
  offered more than that shed the rest. The reference asserts a shed
  whatever the host; on a host too slow to outrun the refill it fails;
- **hostile frames**: slow-loris sockets are cut with 408 at the read
  deadline while healthy pushers land beside them, and a source posting
  malformed bodies is quarantined (429 before decode, a journal event,
  ``kts_ingest_quarantined``) while healthy pushers on the same client
  address are untouched.

``procs`` > 0 puts that many ``SO_REUSEPORT`` acceptor processes in
front of each hub, and every frame they relay must be accounted by the
hub.
"""

from __future__ import annotations

import http.client
import json
import pathlib
import socket
import tempfile
import threading
import time
import urllib.request

from ._common import Result, nvml_daemon


def post_frame(port: int, wire: bytes, timeout: float = 10.0):
    """(status, Retry-After or None) for one frame on a fresh
    connection."""
    from ..delta import CONTENT_TYPE, INGEST_PATH

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", INGEST_PATH, body=wire,
                     headers={"Content-Type": CONTENT_TYPE})
        resp = conn.getresponse()
        resp.read()
        return resp.status, resp.getheader("Retry-After")
    finally:
        conn.close()


class SessionFleet:
    """N synthesized delta sessions over persistent connections (one per
    drain thread)."""

    def __init__(self, port: int, count: int, prefix: str = "node"):
        from ..bench import build_pusher_body
        from ..validate import parse_exposition_interned

        self.port = port
        self.sources = [f"http://{prefix}-{i:04d}:9400/metrics"
                        for i in range(count)]
        self.bodies = [build_pusher_body(i) for i in range(count)]
        self.gens = [i + 1 for i in range(count)]
        self.seqs = [0] * count
        probe = parse_exposition_interned(self.bodies[0])
        by_name = {name: slot for slot, (name, _l, _v) in enumerate(probe)}
        self.churn_slots = sorted((by_name["accelerator_duty_cycle"],
                                   by_name["accelerator_power_watts"]))

    def _drain(self, wires, outcomes, threads: int = 6) -> None:
        from ..delta import CONTENT_TYPE, INGEST_PATH

        def worker(chunk) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=15)
            try:
                for index, wire in chunk:
                    conn.request("POST", INGEST_PATH, body=wire,
                                 headers={"Content-Type": CONTENT_TYPE})
                    resp = conn.getresponse()
                    resp.read()
                    outcomes.append(
                        (index, resp.status, resp.getheader("Retry-After")))
            finally:
                conn.close()

        pool = [threading.Thread(target=worker, args=(wires[k::threads],))
                for k in range(threads)]
        for thread in pool:
            thread.start()
        for thread in pool:
            thread.join(timeout=60)

    def seed(self) -> list:
        from ..delta import encode_full

        wires = [(i, encode_full(self.sources[i], self.gens[i], 1,
                                 self.bodies[i]))
                 for i in range(len(self.sources))]
        outcomes: list = []
        self._drain(wires, outcomes)
        for index, status, _retry in outcomes:
            if status == 200:
                self.seqs[index] = 1
        return outcomes

    def delta_wave(self, offset: float) -> list:
        from ..delta import encode_delta

        wires = [(i, encode_delta(
            self.sources[i], self.gens[i], self.seqs[i] + 1,
            [(self.churn_slots[0], 50.0 + offset),
             (self.churn_slots[1], 300.0 + offset)]))
            for i in range(len(self.sources))]
        outcomes: list = []
        self._drain(wires, outcomes)
        for index, status, _retry in outcomes:
            if status == 200:
                self.seqs[index] += 1
        return outcomes


def make_front(hub, server, procs: int, port: int = 0,
               read_deadline: float = 10.0):
    """(public port, pool): the hub's own server when ``procs`` is 0,
    else an acceptor pool relaying to it."""
    if procs <= 0:
        return server.port, None
    from ..ingestproc import IngestProcPool

    pool = IngestProcPool(hub.delta.handle, host="127.0.0.1", port=port,
                          procs=procs, parent_port=server.port,
                          read_deadline=read_deadline)
    pool.start()
    return pool.port, pool


def check_proc_conservation(hub, pool, label: str) -> list[str]:
    """Every frame the acceptors relayed is accounted by the hub."""
    if pool is None:
        return []
    ingest = hub.delta
    hub_total = (ingest.full_frames_total + ingest.delta_frames_total
                 + ingest.duplicate_frames_total)
    if pool.accepted_total() != hub_total:
        return [f"{label}: per-proc accepted sum "
                f"{pool.accepted_total()} != hub frame total {hub_total}"]
    return []


def _server(hub, port: int = 0, **kw):
    from ..exposition import MetricsServer

    server = MetricsServer(hub.registry, host="127.0.0.1", port=port,
                           trace_provider=hub.tracer,
                           ingest_provider=hub.delta.handle, **kw)
    server.start()
    return server


def scenario_warm_restart(tmp: str, daemons_n: int, sessions_n: int,
                          procs: int = 0) -> Result:
    from ..delta import DeltaPublisher
    from ..hub import Hub

    result = Result("warm")
    problems = result.problems
    ckpt = str(pathlib.Path(tmp) / "root.ckpt")
    daemons: list = []
    publishers: list = []

    def make_hub():
        return Hub([], targets_provider=lambda: [], interval=0.2,
                   push_fence=5.0, ingest_checkpoint=ckpt,
                   ingest_checkpoint_interval=0.1)

    hub = make_hub()
    server = _server(hub, ready_check=hub.ready)
    port, pool = make_front(hub, server, procs)
    hub2 = server2 = pool2 = None
    try:
        for node in range(daemons_n):
            daemon, _fake, _faults = nvml_daemon(
                pathlib.Path(tmp) / f"node{node}", node,
                slice_name="chaos-slice", pods={f"train-{node}": [0, 1]},
                attribution_interval=0.5)
            daemon.start()
            daemons.append(daemon)
            pub = DeltaPublisher(
                daemon.registry, f"http://127.0.0.1:{port}",
                source=f"http://127.0.0.1:{daemon.server.port}/metrics",
                min_interval=0.05)
            pub.start()
            publishers.append(pub)
        for daemon in daemons:
            daemon.registry.wait_for_publish(0, timeout=10)

        fleet = SessionFleet(port, sessions_n)
        bad_seed = [o for o in fleet.seed() if o[1] != 200]
        if bad_seed:
            problems.append(f"warm: seeding failed: {bad_seed[:3]}")
        bad_wave = [o for o in fleet.delta_wave(1.0) if o[1] != 200]
        if bad_wave:
            problems.append(f"warm: delta wave failed: {bad_wave[:3]}")
        time.sleep(0.3)  # the daemons' publishers land a few frames
        hub.refresh_once()
        if not hub.delta.checkpoint(force=True):
            problems.append("warm: forced checkpoint did not write")
        crash_state = pathlib.Path(ckpt).read_bytes()

        # Kill: a clean stop() writes a newest-state checkpoint, so the
        # crash is the pre-stop bytes put back, as kill -9 leaves them.
        if pool is not None:
            pool.stop()
        server.stop()
        hub.stop()
        pathlib.Path(ckpt).write_bytes(crash_state)

        resyncs_before = sum(p.resyncs_total for p in publishers)
        restart_start = time.monotonic()
        hub2 = make_hub()
        server2 = _server(hub2, port=(0 if procs else port),
                          ready_check=hub2.ready)
        if procs:
            _port2, pool2 = make_front(hub2, server2, procs, port=port)
        hub2.start()

        outcomes = fleet.delta_wave(2.0)
        resumed = sum(1 for _i, status, _r in outcomes if status == 200)
        full_resyncs = len(outcomes) - resumed
        ready = False
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if hub2.ready()[0]:
                ready = True
                break
            time.sleep(0.05)
        recovery_s = time.monotonic() - restart_start
        time.sleep(0.5)
        hub2.refresh_once()
        sessions_after = len(hub2.delta.sources())
        total = sessions_n + daemons_n
        if resumed < 0.95 * sessions_n:
            problems.append(
                f"warm: only {resumed}/{sessions_n} sessions resumed "
                f"their delta chain ({full_resyncs} forced FULL)")
        if hub2.delta.warm_restart_sessions < 0.95 * sessions_n:
            problems.append(
                f"warm: replay restored only "
                f"{hub2.delta.warm_restart_sessions} of ~{total} sessions")
        if sessions_after < total:
            problems.append(f"warm: {total - sessions_after} session(s) "
                            f"dropped across the restart")
        if not ready:
            problems.append("warm: hub never went Ready after restart")
        if recovery_s > 10.0:
            problems.append(f"warm: recovery took {recovery_s:.1f}s (> 10s)")
        pushes_before = sum(p.pushes_total for p in publishers)
        time.sleep(0.5)
        if sum(p.pushes_total for p in publishers) <= pushes_before:
            problems.append("warm: daemon publishers did not resume pushing")
        result.figures.update(
            sessions=sessions_n, resumed=resumed, full_resyncs=full_resyncs,
            dropped=max(0, total - sessions_after), ready=ready)
        result.timings.update(
            recovery_s=recovery_s,
            daemon_resyncs=sum(p.resyncs_total for p in publishers)
            - resyncs_before,
            replayed=hub2.delta.warm_restart_sessions)
    finally:
        for pub in publishers:
            pub.stop()
        for daemon in daemons:
            daemon.stop()
        for closing in (pool, pool2, server2, hub2):
            if closing is not None:
                closing.stop()
    return result


STAMPEDE_LANES = 4
STAMPEDE_RATE = 40.0  # deltas a second per lane; the burst is twice it


def scenario_stampede(procs: int = 0, n: int = 128) -> Result:
    from ..delta import encode_full, lane_of
    from ..hub import Hub

    result = Result("stampede")
    problems = result.problems
    hub = Hub([], targets_provider=lambda: [], interval=0.2,
              push_fence=1e9, ingest_lanes=STAMPEDE_LANES,
              ingest_delta_rate=STAMPEDE_RATE,
              ingest_max_inflight=32, ingest_max_sessions=n)
    server = _server(hub)
    port, pool = make_front(hub, server, procs)
    try:
        fleet = SessionFleet(port, n, prefix="stampede")
        bad_seed = [o for o in fleet.seed() if o[1] != 200]
        if bad_seed:
            problems.append(f"stampede: seeding failed: {bad_seed[:3]}")
        hub.refresh_once()
        status, retry = post_frame(
            port, encode_full("http://intruder:9400/metrics", 7, 1,
                              fleet.bodies[0]))
        fence = (status, retry is not None)
        if status != 503 or retry is None:
            problems.append(
                f"stampede: memory fence answered {status} "
                f"(Retry-After {retry!r}), want 503 + Retry-After")
        shed = landed = 0
        crashed: list = []
        recovery_admitted = 0
        lane = [lane_of(source, STAMPEDE_LANES) for source in fleet.sources]
        offered = [0] * STAMPEDE_LANES
        admitted = [0] * STAMPEDE_LANES
        blast_started = time.monotonic()
        for wave in range(4):
            outcomes = fleet.delta_wave(10.0 + wave)
            for index, status, retry in outcomes:
                offered[lane[index]] += 1
                if status == 200:
                    landed += 1
                    admitted[lane[index]] += 1
                elif status == 429 and retry is not None:
                    shed += 1
                else:
                    crashed.append(status)
            victim = wave * 31 % n
            generation = 5_000_000 + victim * 10 + wave
            status, _retry = post_frame(
                port, encode_full(fleet.sources[victim], generation, 1,
                                  fleet.bodies[victim]))
            if status != 200:
                problems.append(
                    f"stampede: recovery FULL refused with {status} "
                    f"mid-storm (shed priority violated)")
            else:
                recovery_admitted += 1
                fleet.gens[victim] = generation
                fleet.seqs[victim] = 1
        blast_s = time.monotonic() - blast_started
        hub.refresh_once()
        alive = len(hub.delta.sources())
        served = hub._push_served
        if crashed:
            problems.append(f"stampede: non-shed failures {crashed[:5]} "
                            f"(want only 200 or 429+Retry-After)")
        # The buckets' ceiling over the blast, per lane.
        ceiling = 2.0 * STAMPEDE_RATE + STAMPEDE_RATE * blast_s
        over = [k for k in range(STAMPEDE_LANES) if admitted[k] > ceiling]
        if over:
            problems.append(
                f"stampede: lanes {over} admitted {admitted} deltas, over "
                f"the bucket ceiling {ceiling:.0f} of the {blast_s:.2f}s "
                f"blast")
        if not landed:
            problems.append("stampede: nothing landed (over-shedding)")
        if alive != n:
            problems.append(
                f"stampede: {n - alive} established session(s) dropped")
        if served != n:
            problems.append(
                f"stampede: post-storm refresh push-served {served}/{n}")
        text = hub.registry.snapshot().render()
        shed_family = 'kts_ingest_shed_total{reason="delta_rate"}' in text
        if shed and not shed_family:
            problems.append("stampede: kts_ingest_shed_total{reason="
                            "delta_rate} missing from the exposition")
        problems += check_proc_conservation(hub, pool, "stampede")
        relayed = None
        if pool is not None:
            relayed = sum(s["frames"] for s in pool.proc_stats().values())
            expected = n + 1 + landed + shed + len(crashed) + 4
            if relayed != expected:
                problems.append(f"stampede: acceptors relayed {relayed} "
                                f"frames, expected {expected}")
        result.figures.update(
            sessions=n, fence=fence, answered=landed + shed,
            non_shed_failures=len(crashed), recovery_admitted=
            recovery_admitted, alive=alive, served=served)
        result.timings.update(
            landed=landed, shed=shed, blast_s=blast_s,
            over_budget=any(o > ceiling for o in offered),
            relayed=relayed)
    finally:
        if pool is not None:
            pool.stop()
        server.stop()
        hub.stop()
    return result


def scenario_hostile(procs: int = 0) -> Result:
    from ..delta import encode_full
    from ..hub import Hub

    result = Result("hostile")
    problems = result.problems
    hub = Hub([], targets_provider=lambda: [], interval=0.2,
              push_fence=1e9, ingest_quarantine_threshold=5,
              ingest_quarantine_window=30.0)
    server = _server(hub, ingest_read_deadline=1.0)
    port, pool = make_front(hub, server, procs, read_deadline=1.0)
    try:
        fleet = SessionFleet(port, 16, prefix="healthy")
        bad_seed = [o for o in fleet.seed() if o[1] != 200]
        if bad_seed:
            problems.append(f"hostile: seeding failed: {bad_seed[:3]}")
        lorises = []
        for _ in range(5):
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            sock.sendall(b"POST /ingest/delta HTTP/1.1\r\n"
                         b"Host: chaos\r\n"
                         b"Content-Type: application/x-kts-delta\r\n"
                         b"Content-Length: 10000\r\n\r\nab")
            lorises.append(sock)
        latencies = []
        healthy_failed = 0
        for offset in (20.0, 21.0, 22.0):
            start = time.monotonic()
            bad = [o for o in fleet.delta_wave(offset) if o[1] != 200]
            latencies.append(time.monotonic() - start)
            healthy_failed += len(bad)
            if bad:
                problems.append(f"hostile: healthy deltas failed beside "
                                f"lorises: {bad[:3]}")
        if max(latencies) > 5.0:
            problems.append(f"hostile: healthy wave took "
                            f"{max(latencies):.1f}s beside lorises")
        cut = 0
        deadline = time.monotonic() + 10.0
        for sock in lorises:
            sock.settimeout(max(0.1, deadline - time.monotonic()))
            try:
                answer = sock.recv(256)
                if b"408" in answer or answer == b"":
                    cut += 1
            except OSError:
                pass
            finally:
                sock.close()
        if cut < len(lorises):
            problems.append(f"hostile: only {cut}/{len(lorises)} lorises "
                            f"cut off at the read deadline")
        evil_source = "http://evil:9400/metrics"
        quarantined_at = None
        for attempt in range(12):
            wire = encode_full(evil_source, attempt + 2, 1,
                               "this is { not an exposition !!\n")
            status, retry = post_frame(port, wire)
            if status == 429 and retry is not None:
                quarantined_at = attempt
                break
            if status != 400:
                problems.append(f"hostile: corrupt frame answered {status}, "
                                f"want 400 then 429")
                break
        if quarantined_at is None:
            problems.append(
                "hostile: 12 corrupt frames never tripped quarantine")
        bad = [o for o in fleet.delta_wave(30.0) if o[1] != 200]
        healthy_failed += len(bad)
        if bad:
            problems.append(f"hostile: healthy pushers collateral-damaged "
                            f"by the quarantine: {bad[:3]}")
        hub.refresh_once()
        text = hub.registry.snapshot().render()
        quarantine_rose = ("kts_ingest_quarantined" in text
                           and "kts_ingest_quarantined 0" not in text)
        if not quarantine_rose:
            problems.append("hostile: kts_ingest_quarantined did not rise")
        events = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/events", timeout=10).read())
        journaled = any(e.get("kind") == "ingest_quarantine"
                        for e in events.get("events", []))
        if not journaled:
            problems.append("hostile: no ingest_quarantine journal event")
        problems += check_proc_conservation(hub, pool, "hostile")
        result.figures.update(
            lorises_cut=cut, quarantined_at=quarantined_at,
            healthy_failed=healthy_failed,
            quarantine_rose=quarantine_rose, journaled=journaled)
        result.timings.update(healthy_wave_s_max=max(latencies))
    finally:
        if pool is not None:
            pool.stop()
        server.stop()
        hub.stop()
    return result


def run(daemons: int = 2, sessions: int = 256, procs: int = 0) -> Result:
    result = Result("chaos")
    with tempfile.TemporaryDirectory() as tmp:
        result.merge(scenario_warm_restart(tmp, daemons, sessions, procs),
                     "warm")
    result.merge(scenario_stampede(procs), "stampede")
    result.merge(scenario_hostile(procs), "hostile")
    return result


def add_arguments(parser) -> None:
    parser.add_argument("--daemons", type=int, default=2)
    parser.add_argument("--sessions", type=int, default=256,
                        help="synthesized delta sessions in the "
                             "warm-restart fleet")
    parser.add_argument("--ingest-procs", type=int, default=0,
                        help="run every scenario through N SO_REUSEPORT "
                             "acceptor processes")


def main(args) -> Result:
    result = run(args.daemons, args.sessions, args.ingest_procs)
    front = (f", all through {args.ingest_procs} acceptor process(es)"
             if args.ingest_procs else "")
    print(result.report(
        f"hub kill/restart warm-resumed {args.sessions} sessions + "
        f"{args.daemons} daemons, stampede held to the lanes' budget with "
        f"429s and no session dropped, lorises cut at the read deadline, corrupt-frame source "
        f"quarantined with healthy pushers unharmed{front}"))
    return result
