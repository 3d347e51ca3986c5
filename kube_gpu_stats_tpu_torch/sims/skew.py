"""Skew: a mixed-version fleet through a rolling upgrade.

The port of the reference's ``tools/skew_sim.py``: NVML daemons (over
``testing.fake_nvml``) publishing through real ``DeltaPublisher``s into
real ``MetricsServer``-fronted hubs, the two ends at different protocol
builds:

- **wire matrix**: a publisher capped at wire v1 against a current hub
  stays at v1, a current one negotiates up to v2 off the hub's hello, and
  a current publisher against a hub that speaks only v1 is clamped by the
  hello. No refusal, no downgrade, no FULL past the steady state but
  those a change of the daemon's series keys forces (counted apart),
  and the hub's census lists the capped publisher as ``wire-v1``;
- **pre-negotiation hub**: a hub that sends no hello and answers a v2
  frame with 400 "unsupported version": the publisher downgrades its
  encoding inside the push, with no FULL and no resync;
- **daemon upgrade onto old disk state**: a spill queue written by an
  older build (a headerless segment of plain bodies, one record in the
  old spooled-wire-frame format, one garbage record) drains with the
  wire frame re-encoded and the garbage counted undecodable; an energy
  checkpoint with pruned keys loads with its totals, and one of a future
  major version is quarantined aside byte for byte;
- **hub upgrade under live pushers**: a v1-window hub with live
  publishers checkpoints and is replaced on the same port by a current
  hub warm-restarting from that checkpoint. No resync, at most one FULL
  per session, the publishers negotiate up and the census flips to the
  publishers' build without a FULL;
- **stuck skew**: a hub with ``ingest_proto_min=2`` refuses a v1-capped
  publisher with 426, counted at both ends, journaled once, and
  ``doctor.check_skew`` against the live ``/debug/skew`` names the peer.

The census carries build strings, which differ between the packages; the
figures say what the census holds of each peer (``wire-v1`` for the
capped one, ``current`` for this build) rather than the string.
"""

from __future__ import annotations

import json
import pathlib
import struct
import tempfile
import time
import zlib

from ._common import Result, nvml_daemon, wait_for

_RECORD = struct.Struct("<dII")  # wal.py's segment record framing
PUBLISHER = dict(min_interval=0.02, timeout=1.0)
HUB_UPGRADE_PUBLISHERS = 3


def _daemon(tmp: str, name: str, node: int = 0):
    # The daemon's own tick deadline and flight recorder, as the
    # reference's skew daemons run. On a loaded host a tick past the
    # deadline drops a family and kts_slowest_tick_seconds{phase,blame}
    # takes new labels when a slower tick has another phase: a key
    # change, which is a FULL by design. The scenarios count those
    # FULLs apart (version_fulls excludes them).
    from ..config import Config

    daemon, _fake, _faults = nvml_daemon(
        pathlib.Path(tmp) / name, node, interval=0.05,
        device_processes="off", deadline=Config.deadline)
    daemon.start()
    return daemon


def fulls(pub) -> tuple[int, int]:
    """(FULLs not forced by a series key change, key-change FULLs) a
    publisher's session has had acked."""
    enc = pub._encoder
    return enc.full_frames - enc.key_change_fulls, enc.key_change_fulls


def _hub(**kw):
    from ..hub import Hub

    return Hub([], targets_provider=lambda: [], interval=0.2,
               push_fence=1e9, **kw)


def _hub_server(hub, port: int = 0):
    """A MetricsServer fronting a hub's ingest and its ``/debug/skew``,
    as the hub's ``main`` wires them."""
    from ..exposition import MetricsServer
    from ..hub import skew_payload

    server = MetricsServer(hub.registry, host="127.0.0.1", port=port,
                           ingest_provider=hub.delta.handle,
                           skew_provider=lambda: skew_payload(hub))
    server.start()
    return server


def census_roles(census: dict) -> dict:
    """The census with this build's string named ``current``."""
    from .. import __version__

    return {("current" if version == __version__ else version): count
            for version, count in census.items()}


def scenario_wire_matrix(tmp: str) -> Result:
    """An old publisher into a new hub, and a new one into a v1 hub."""
    from ..delta import DeltaPublisher

    result = Result("matrix")
    problems = result.problems
    hub = _hub()
    old_hub = _hub(ingest_proto_max=1)
    server = _hub_server(hub)
    old_server = _hub_server(old_hub)
    daemon = _daemon(tmp, "matrix")
    pubs = {
        "old": DeltaPublisher(daemon.registry,
                              f"http://127.0.0.1:{server.port}",
                              source="http://node-old:9400/metrics",
                              proto_max=1, **PUBLISHER),
        "new": DeltaPublisher(daemon.registry,
                              f"http://127.0.0.1:{server.port}",
                              source="http://node-new:9400/metrics",
                              **PUBLISHER),
        "vs-old": DeltaPublisher(daemon.registry,
                                 f"http://127.0.0.1:{old_server.port}",
                                 source="http://node-vs-old:9400/metrics",
                                 **PUBLISHER)}
    try:
        for pub in pubs.values():
            pub.start()
        synced = wait_for(lambda: all(p.pushes_total >= 5
                                      for p in pubs.values()), 15.0)
        if not synced:
            problems.append("matrix: publishers never synced")
        # The steady-state fence: a daemon's first ticks grow its series
        # set (its trace digest, its push stats), and a key change is a
        # FULL by design. FULLs from here on that no key change forced
        # could only be the versions'.
        fulls0 = {name: fulls(p) for name, p in pubs.items()}
        marks = {name: p.pushes_total for name, p in pubs.items()}
        steady = wait_for(lambda: all(p.pushes_total >= marks[name] + 5
                                      for name, p in pubs.items()), 15.0)
        if not steady:
            problems.append("matrix: pushes stalled after the sync")
        negotiated = {name: p.negotiated_proto for name, p in pubs.items()}
        if negotiated != {"old": 1, "new": 2, "vs-old": 1}:
            problems.append(f"matrix: negotiated {negotiated}, want old v1, "
                            f"new v2, vs-old v1")
        upgrades = pubs["new"].proto_upgrades_total
        if upgrades != 1:
            problems.append(f"matrix: want exactly 1 upgrade negotiation, "
                            f"got {upgrades}")
        refusals = {name: p.skew_refused_total + p.proto_downgrades_total
                    for name, p in pubs.items()}
        version_fulls = {name: fulls(p)[0] - fulls0[name][0]
                         for name, p in pubs.items()}
        churn_fulls = {name: fulls(p)[1] - fulls0[name][1]
                       for name, p in pubs.items()}
        for name in pubs:
            if refusals[name]:
                problems.append(f"matrix: {name} publisher counted "
                                f"{refusals[name]} refusals/downgrades on "
                                f"a legal mix")
            if version_fulls[name]:
                problems.append(f"matrix: {name} publisher sent "
                                f"{version_fulls[name]} FULL(s) in steady "
                                f"state that no key change forced, want 0")
        hub_refusals = {
            name: h.delta.resyncs_total + h.delta.skew_refused_total
            for name, h in (("new", hub), ("old-window", old_hub))}
        for name, count in hub_refusals.items():
            if count:
                problems.append(f"matrix: {name} hub counted {count} "
                                f"resyncs/refusals on a legal mix")
        census = census_roles(hub.delta.fleet_versions())
        if census != {"wire-v1": 1, "current": 1}:
            problems.append(f"matrix: census {census} should list 1 "
                            f"wire-v1 (the capped publisher) and 1 current")
        result.figures.update(
            synced=synced, steady=steady, negotiated=negotiated,
            upgrades=upgrades, refusals=refusals,
            version_fulls=version_fulls, hub_refusals=hub_refusals,
            census=census)
        result.timings.update(pushes={name: p.pushes_total
                                      for name, p in pubs.items()},
                              churn_fulls=churn_fulls)
    finally:
        for pub in pubs.values():
            pub.stop()
        daemon.stop()
        server.stop()
        old_server.stop()
        hub.stop()
        old_hub.stop()
    return result


def scenario_prenegotiation_hub(tmp: str) -> Result:
    """A hub from before the hello 400s v2 frames: the publisher
    downgrades its encoding inside the push and lands the same data."""
    from .. import snappy
    from ..delta import CAP_BUILD_INFO, DeltaPublisher
    from ..exposition import MetricsServer

    result = Result("prenegotiation")
    problems = result.problems
    hub = _hub()

    def prenegotiation_ingest(wire: bytes, peer: str = ""):
        # An old build: never a hello, and a v2 frame draws the only
        # signal it can give, 400 "unsupported version".
        if snappy.decompress(wire)[4] > 1:
            return (400, b"bad delta frame: unsupported version 2\n", {})
        code, body, _headers = hub.delta.handle(wire, peer=peer)
        return code, body, {}

    server = MetricsServer(hub.registry, host="127.0.0.1", port=0,
                           ingest_provider=prenegotiation_ingest)
    server.start()
    daemon = _daemon(tmp, "prenegotiation")
    pub = DeltaPublisher(daemon.registry, f"http://127.0.0.1:{server.port}",
                         source="http://node-roll:9400/metrics",
                         **PUBLISHER)
    try:
        pub.start()
        synced = wait_for(lambda: pub.pushes_total >= 5, 15.0)
        if not synced:
            problems.append("prenegotiation: publisher never synced")
        pushes_before = pub.pushes_total
        fulls_before = fulls(pub)
        # "The hub we negotiated v2 with rolled back": the encoder forced
        # to v2 against the receiver without a hello.
        pub._encoder.set_wire(2, CAP_BUILD_INFO)
        downgraded = wait_for(lambda: pub.proto_downgrades_total >= 1
                              and pub.pushes_total > pushes_before, 15.0)
        if not downgraded:
            problems.append("prenegotiation: publisher never downgraded off "
                            "the 'unsupported version' 400")
        if pub.negotiated_proto != 1:
            problems.append(f"prenegotiation: publisher at "
                            f"v{pub.negotiated_proto} after the downgrade, "
                            f"want 1")
        version_fulls = fulls(pub)[0] - fulls_before[0]
        if version_fulls or hub.delta.resyncs_total:
            problems.append(f"prenegotiation: the downgrade cost "
                            f"{version_fulls} FULL(s) and "
                            f"{hub.delta.resyncs_total} resync(s), want 0 "
                            f"(a 400 is before the apply: the diff base "
                            f"survives)")
        result.figures.update(
            synced=synced, downgraded=downgraded,
            negotiated=pub.negotiated_proto, version_fulls=version_fulls,
            resyncs=hub.delta.resyncs_total)
        result.timings.update(pushes_before=pushes_before,
                              churn_fulls=fulls(pub)[1] - fulls_before[1])
    finally:
        pub.stop()
        daemon.stop()
        server.stop()
        hub.stop()
    return result


def old_spill_records() -> list[bytes]:
    """An older build's spool: three plain spooled bodies, one record in
    the old spooled-wire-frame format (an encoded v1 FULL) and one
    garbage record."""
    from .. import snappy
    from ..delta import encode_full

    records = [snappy.compress(f'accelerator_duty_cycle{{chip="{i}"}} '
                               f'0.{i}\n'.encode()) for i in range(3)]
    records.append(encode_full("http://node-up:9400/metrics", 7, 0,
                               'accelerator_duty_cycle{chip="9"} 0.9\n'))
    records.append(b"\x00garbage-not-snappy\xff")
    return records


def scenario_daemon_upgrade(tmp: str) -> Result:
    """A daemon restarting mid-rollout onto an older build's disk state."""
    from .. import wal
    from ..delta import DeltaPublisher
    from ..energy import EnergyAccountant
    from ..spillq import SpillQueue

    result = Result("daemon-upgrade")
    problems = result.problems
    base = pathlib.Path(tmp)

    # The old build's spill queue, byte for byte: a headerless segment
    # from before the format was versioned.
    spill_dir = base / "spill"
    spill_dir.mkdir(parents=True)
    records = old_spill_records()
    with open(spill_dir / "spill-00000001.seg", "wb") as handle:
        for payload in records:
            handle.write(_RECORD.pack(time.time(), len(payload),
                                      zlib.crc32(payload)))
            handle.write(payload)

    # An old build's energy checkpoint: covered_seconds, total_seconds
    # and seq absent.
    energy_path = base / "energy.json"
    energy_path.write_text(json.dumps({
        "version": 1, "per_pod": [["train-pod", "ml", 123.5]]}))
    accountant = EnergyAccountant(checkpoint_path=str(energy_path))
    totals_kept = accountant._per_pod.get(("train-pod", "ml")) == 123.5
    if not totals_kept:
        problems.append("daemon-upgrade: the pruned-keys energy checkpoint "
                        "lost the pod totals")
    if not accountant.checkpoint_loaded:
        problems.append("daemon-upgrade: the pruned-keys energy checkpoint "
                        "refused to load")

    # A future major energy checkpoint: quarantined, never overwritten.
    wal.reset_quarantine_stats()
    future_path = base / "energy-future.json"
    future_bytes = json.dumps({"version": 99, "per_pod": [],
                               "from": "the future"}).encode()
    future_path.write_bytes(future_bytes)
    degraded = EnergyAccountant(checkpoint_path=str(future_path))
    aside = future_path.parent / (future_path.name + ".skew-v99")
    future_loaded = bool(degraded._per_pod) or degraded.checkpoint_loaded
    if future_loaded:
        problems.append("daemon-upgrade: the future-major checkpoint was "
                        "loaded instead of quarantined")
    left_in_place = future_path.exists()
    if left_in_place:
        problems.append("daemon-upgrade: the future-major checkpoint was "
                        "left in place (the next write would overwrite it)")
    aside_identical = aside.exists() and aside.read_bytes() == future_bytes
    if not aside_identical:
        problems.append("daemon-upgrade: the quarantined checkpoint is not "
                        "byte-identical aside")
    quarantined = wal.quarantine_counts().get("energy", 0)
    if quarantined != 1:
        problems.append(f"daemon-upgrade: quarantine not counted "
                        f"({wal.quarantine_counts()})")

    # The upgraded daemon drains the old spool.
    hub = _hub()
    server = _hub_server(hub)
    daemon = _daemon(tmp, "upgraded")
    spill = SpillQueue(str(spill_dir), tracer=daemon.tracer)
    recovered = spill.depth()
    if recovered != len(records):
        problems.append(f"daemon-upgrade: recovered {recovered} spooled "
                        f"record(s) of the old build's {len(records)}")
    pub = DeltaPublisher(daemon.registry, f"http://127.0.0.1:{server.port}",
                         source="http://node-up:9400/metrics", spill=spill,
                         drain_rate=2000.0, **PUBLISHER)
    try:
        pub.start()
        pub._probe_at = 0.0
        drained = wait_for(lambda: spill.depth() == 0, 15.0)
        if not drained:
            problems.append(f"daemon-upgrade: the old build's spool never "
                            f"drained (depth {spill.depth()})")
        if spill.reencoded_total != 1:
            problems.append(f"daemon-upgrade: {spill.reencoded_total} "
                            f"wire-frame record(s) re-encoded, want 1")
        if spill.undecodable_total != 1:
            problems.append(f"daemon-upgrade: {spill.undecodable_total} "
                            f"record(s) undecodable, want exactly 1 (the "
                            f"garbage record)")
        # Every recovered record was drained, re-encoded or counted.
        delivered = spill.drained_total
        closes = delivered + spill.undecodable_total >= len(records)
        if not closes:
            problems.append(f"daemon-upgrade: {delivered} drained + "
                            f"{spill.undecodable_total} undecodable < "
                            f"{len(records)} recovered: silent loss")
        result.figures.update(
            totals_kept=totals_kept,
            pruned_loaded=accountant.checkpoint_loaded,
            future_loaded=future_loaded, left_in_place=left_in_place,
            aside_identical=aside_identical, quarantined=quarantined,
            recovered=recovered, drained=drained,
            reencoded=spill.reencoded_total,
            undecodable=spill.undecodable_total, accounting_closes=closes)
        result.timings.update(delivered=delivered)
    finally:
        pub.stop()
        daemon.stop()
        server.stop()
        hub.stop()
        wal.reset_quarantine_stats()
    return result


def scenario_hub_upgrade(tmp: str) -> Result:
    """A v1-window hub restarted from its checkpoint as a current hub on
    the same port under live pushers."""
    from .. import __version__
    from ..delta import DeltaPublisher

    result = Result("hub-upgrade")
    problems = result.problems
    ckpt = str(pathlib.Path(tmp) / "ingest.json")
    hub1 = _hub(ingest_proto_max=1, ingest_checkpoint=ckpt)
    server1 = _hub_server(hub1)
    port = server1.port
    daemon = _daemon(tmp, "hub-upgrade")
    pubs = [DeltaPublisher(daemon.registry, f"http://127.0.0.1:{port}",
                           source=f"http://node-{i}:9400/metrics",
                           **PUBLISHER)
            for i in range(HUB_UPGRADE_PUBLISHERS)]
    hub2 = server2 = None
    try:
        for pub in pubs:
            pub.start()
        synced = wait_for(lambda: all(p.pushes_total >= 10 for p in pubs),
                          15.0)
        if not synced:
            problems.append("hub-upgrade: publishers never synced to the "
                            "old hub")
        old_window = all(p.negotiated_proto == 1 for p in pubs)
        if not old_window:
            problems.append("hub-upgrade: the v1-window hub negotiated "
                            "above v1")
        fulls0 = [fulls(p) for p in pubs]
        # The upgrade: stop, checkpoint, restart as the current build.
        upgrade_at = time.monotonic()
        server1.stop()
        hub1.delta.checkpoint(force=True)
        hub2 = _hub(ingest_checkpoint=ckpt)
        server2 = _hub_server(hub2, port=port)
        for pub in pubs:
            pub._probe_at = 0.0  # collapse the probe backoff
        negotiated_up = wait_for(
            lambda: all(p.negotiated_proto == 2 for p in pubs), 15.0)
        negotiate_s = time.monotonic() - upgrade_at
        if not negotiated_up:
            problems.append(f"hub-upgrade: publishers never negotiated up "
                            f"({[p.negotiated_proto for p in pubs]})")
        resyncs = hub2.delta.resyncs_total
        if resyncs:
            problems.append(f"hub-upgrade: {resyncs} resync(s) across a "
                            f"checkpointed upgrade, want 0")
        # At most one FULL per re-established session: the publisher
        # nacked its frame in flight when the listener died. A key
        # change on the daemon is counted apart.
        upgrade_fulls = [fulls(p)[0] - fulls0[i][0]
                         for i, p in enumerate(pubs)]
        churn_fulls = [fulls(p)[1] - fulls0[i][1]
                       for i, p in enumerate(pubs)]
        over = [pubs[i].source for i, n in enumerate(upgrade_fulls)
                if n > 1]
        for source in over:
            problems.append(f"hub-upgrade: {source} sent more than one "
                            f"FULL across the upgrade that no key change "
                            f"forced")
        # The census flips to the build without a FULL: the delta that
        # announces it once carries the build extension.
        flipped = wait_for(lambda: hub2.delta.fleet_versions().get(
            __version__) == len(pubs), 15.0)
        if not flipped:
            problems.append(f"hub-upgrade: the census never flipped to "
                            f"{__version__} ({hub2.delta.fleet_versions()})")
        result.figures.update(
            sessions=len(pubs), synced=synced, old_window=old_window,
            negotiated_up=negotiated_up, resyncs=resyncs,
            over_one_full=len(over), census_flipped=flipped,
            census=census_roles(hub2.delta.fleet_versions()))
        # Whether a session pays its one FULL depends on whether a push
        # was in flight as the listener closed: host timing.
        result.timings.update(
            upgrade_fulls=upgrade_fulls, churn_fulls=churn_fulls,
            resumed=sum(1 for n in upgrade_fulls if n == 0),
            replayed=hub2.delta.warm_restart_sessions,
            negotiate_s=negotiate_s)
    finally:
        for pub in pubs:
            pub.stop()
        daemon.stop()
        server1.stop()
        if server2 is not None:
            server2.stop()
        hub1.stop()
        if hub2 is not None:
            hub2.stop()
    return result


def scenario_stuck_skew_and_doctor(tmp: str) -> Result:
    """A hub gated at v2 refusing a v1-capped publisher: 426s counted at
    both ends, journaled once, and the doctor names the peer."""
    from ..delta import DeltaPublisher
    from ..doctor import WARN, check_skew

    result = Result("stuck-skew")
    problems = result.problems
    hub = _hub(ingest_proto_min=2)
    server = _hub_server(hub)
    daemon = _daemon(tmp, "stuck")
    source = "http://node-stuck:9400/metrics"
    pub = DeltaPublisher(daemon.registry, f"http://127.0.0.1:{server.port}",
                         source=source, proto_max=1, **PUBLISHER)
    try:
        pub.start()
        counted = wait_for(lambda: pub.skew_refused_total >= 2, 15.0)
        if not counted:
            problems.append("stuck-skew: the publisher never counted the 426 "
                            "refusals")
        hub_counted = hub.delta.skew_refused_total >= 2
        if not hub_counted:
            problems.append(f"stuck-skew: the hub counted "
                            f"{hub.delta.skew_refused_total} refusal(s), "
                            f"want >= 2")
        if pub.pushes_total:
            problems.append(f"stuck-skew: {pub.pushes_total} push(es) "
                            f"landed through a disjoint version window")
        named = source in hub.delta.skew_status().get("refused_peers", {})
        if not named:
            problems.append("stuck-skew: the refused peer is not named in "
                            "skew_status")
        # Journaled once per (peer, version), not once per frame.
        journaled = sum(1 for e in hub.tracer.events()["events"]
                        if e.get("kind") == "skew_refused")
        if journaled != 1:
            problems.append(f"stuck-skew: {journaled} skew_refused journal "
                            f"event(s), want exactly 1")
        verdict = check_skew(f"http://127.0.0.1:{server.port}")
        doctor_names = verdict.status == WARN and source in verdict.detail
        if not doctor_names:
            problems.append(f"stuck-skew: doctor --skew did not name the "
                            f"refused peer ([{verdict.status}] "
                            f"{verdict.detail[:200]})")
        result.figures.update(
            publisher_counted=counted, hub_counted=hub_counted,
            pushes=pub.pushes_total, peer_named=named,
            journal_events=journaled, doctor=verdict.status,
            doctor_names_peer=doctor_names)
        result.timings.update(publisher_refused=pub.skew_refused_total,
                              hub_refused=hub.delta.skew_refused_total)
    finally:
        pub.stop()
        daemon.stop()
        server.stop()
        hub.stop()
    return result


SCENARIOS = (("matrix", scenario_wire_matrix),
             ("prenegotiation", scenario_prenegotiation_hub),
             ("daemon-upgrade", scenario_daemon_upgrade),
             ("hub-upgrade", scenario_hub_upgrade),
             ("stuck-skew", scenario_stuck_skew_and_doctor))


def run() -> Result:
    result = Result("skew")
    with tempfile.TemporaryDirectory() as tmp:
        for name, scenario in SCENARIOS:
            path = pathlib.Path(tmp) / name
            path.mkdir()
            result.merge(scenario(str(path)), name)
    return result


def add_arguments(parser) -> None:
    pass


def main(args) -> Result:
    result = run()
    print(result.report(
        "old and new publishers against old and new hubs flowed with no "
        "refusal and no FULL past the steady state (the pre-negotiation "
        "400 downgraded in the push), an upgraded daemon drained an older "
        "build's spool (wire frame re-encoded, garbage counted) with the "
        "pruned checkpoint loaded and the future one quarantined, a hub "
        "upgrade under live pushers resumed with no resync and the census "
        "flipped without a FULL, and a gated refusal was counted at both "
        "ends with the doctor naming the peer"))
    return result
