"""Federation: a leaf/root hub tree over real NVML daemons.

The port of the reference's ``tools/federation_sim.py``:

- N daemons (over ``testing.fake_nvml``, pods from a kubelet checkpoint)
  split across two leaf hubs, each daemon pushing deltas to its leaf,
  each leaf pushing its merged rollup to one federation root. Node 0 is
  the straggler: its every NVML ``utilization`` read stalls ``delay``
  seconds (the reference's scripted RPC delay);
- a worker restart: one daemon's publisher is replaced (new generation,
  seq chain reset), and its leaf must resync through a FULL frame;
- a partitioned leaf: leaf B's push to the root stops, and the root's
  pull fallback serves it, so the rollup still converges;
- an authenticated leaf -> root hop (basic auth, password file), and a
  publisher without credentials refused with 401s;
- a resync storm: a 4-lane hub takes every one of 48 synthetic pushers
  re-posting a FULL at once over real HTTP, and keeps every session,
  serves every target by push, and spreads the sessions over lanes.

``doctor --fleet`` at the root names the straggler through the
root -> leaf walk.
"""

from __future__ import annotations

import hashlib
import pathlib
import tempfile
import threading
import time
import urllib.request

from ._common import Result, nvml_daemon


def run(nodes: int = 3, refreshes: int = 8, delay: float = 0.8) -> Result:
    from .. import doctor
    from ..bench import build_pusher_body
    from ..delta import (CONTENT_TYPE, DeltaPublisher, encode_full,
                         push_headers_provider)
    from ..exposition import MetricsServer
    from ..hub import Hub

    result = Result("federation")
    problems = result.problems
    fig = result.figures
    straggler_index = 0
    daemons: list = []
    hubs: list = []
    servers: list = []
    publishers: list = []

    def start_hub(hub, **kwargs):
        server = MetricsServer(
            hub.registry, host="127.0.0.1", port=0,
            trace_provider=hub.tracer, fleet_provider=hub.fleet,
            ingest_provider=hub.delta.handle, **kwargs)
        server.start()
        hubs.append(hub)
        servers.append(server)
        return server

    with tempfile.TemporaryDirectory() as tmp:
        try:
            node_urls = []
            split = max(1, nodes // 2)
            for node in range(nodes):
                daemon, fake, faults = nvml_daemon(
                    pathlib.Path(tmp) / f"node{node}", node,
                    slice_name=f"sim-slice-{0 if node < split else 1}",
                    pods={f"train-{node}": [0, 1]},
                    attribution_interval=0.5, pipeline_fetch=False)
                if node == straggler_index:
                    faults.stalls = {
                        card: {"utilization": (delay, 1)}
                        for card in range(len(fake.devices))}
                daemon.start()
                daemons.append(daemon)
                node_urls.append(
                    f"http://127.0.0.1:{daemon.server.port}/metrics")
            for daemon in daemons:
                daemon.registry.wait_for_publish(0, timeout=10)

            leaf_members = [node_urls[:split], node_urls[split:]]
            leaf_urls = []
            for _members in leaf_members:
                leaf = Hub([], targets_provider=lambda: [], interval=0.2,
                           push_fence=2.0)
                server = start_hub(leaf)
                leaf_urls.append(f"http://127.0.0.1:{server.port}/metrics")
            for members, leaf_url in zip(leaf_members, leaf_urls):
                for url in members:
                    daemon = daemons[node_urls.index(url)]
                    pub = DeltaPublisher(
                        daemon.registry, leaf_url.removesuffix("/metrics"),
                        source=url, min_interval=0.05)
                    pub.start()
                    publishers.append(pub)

            root_hub = Hub([], targets_provider=lambda: [], interval=0.2,
                           federate=True, push_fence=1.0)
            root_server = start_hub(root_hub)
            leaf_pubs = []
            for leaf, leaf_url in zip(hubs[:2], leaf_urls):
                pub = DeltaPublisher(
                    leaf.registry, f"http://127.0.0.1:{root_server.port}",
                    source=leaf_url, min_interval=0.05)
                pub.start()
                leaf_pubs.append(pub)
            publishers.extend(leaf_pubs)

            def pump(n: int) -> None:
                for _ in range(n):
                    time.sleep(0.25)
                    for leaf in hubs[:2]:
                        leaf.refresh_once()
                    root_hub.refresh_once()

            pump(refreshes)

            # A worker restart: a new generation, the seq chain reset.
            victim = daemons[-1]
            victim_url = node_urls[-1]
            old_pub = next(p for p in publishers if p.source == victim_url)
            old_pub.stop()
            in_first = victim_url in leaf_members[0]
            leaf_url = leaf_urls[0 if in_first else 1]
            leaf_of_victim = hubs[0 if in_first else 1]
            full_before = leaf_of_victim.delta.full_frames_total
            restarted = DeltaPublisher(
                victim.registry, leaf_url.removesuffix("/metrics"),
                source=victim_url, min_interval=0.05)
            restarted.start()
            publishers.append(restarted)

            # A partitioned leaf: its push to the root stops.
            leaf_pubs[1].stop()
            pump(refreshes)

            # The authenticated leaf -> root hop.
            authed_root = Hub([], targets_provider=lambda: [],
                              interval=0.2, federate=True, push_fence=2.0)
            authed_server = start_hub(
                authed_root, auth_username="fed",
                auth_password_sha256=hashlib.sha256(
                    b"fed-secret").hexdigest())
            pass_file = pathlib.Path(tmp) / "fed-pass"
            pass_file.write_text("fed-secret\n")
            authed_pub = DeltaPublisher(
                hubs[0].registry, f"http://127.0.0.1:{authed_server.port}",
                source=leaf_urls[0], min_interval=0.05,
                headers_provider=push_headers_provider("fed",
                                                       str(pass_file)))
            unauthed_pub = DeltaPublisher(
                hubs[1].registry, f"http://127.0.0.1:{authed_server.port}",
                source=leaf_urls[1] + "#unauthed", min_interval=0.05)
            publishers.extend([authed_pub, unauthed_pub])
            for _ in range(3):
                authed_pub.push_once()
                unauthed_pub.push_once()
                time.sleep(0.05)
            authed_root.refresh_once()

            # The resync storm over real HTTP.
            storm_hub = Hub([], targets_provider=lambda: [], interval=0.2,
                            push_fence=1e9, ingest_lanes=4)
            storm_server = start_hub(storm_hub)
            storm_url = (f"http://127.0.0.1:{storm_server.port}"
                         f"/ingest/delta")
            n_storm = 48
            storm_names = [f"http://storm-{i:03d}:9400/metrics"
                           for i in range(n_storm)]
            storm_bodies = [build_pusher_body(i) for i in range(n_storm)]

            def post_frame(wire: bytes) -> None:
                request = urllib.request.Request(
                    storm_url, data=wire, method="POST",
                    headers={"Content-Type": CONTENT_TYPE})
                with urllib.request.urlopen(request, timeout=10) as resp:
                    if resp.status != 200:
                        raise RuntimeError(f"HTTP {resp.status}")

            for i in range(n_storm):
                post_frame(encode_full(storm_names[i], i + 1, 1,
                                       storm_bodies[i]))
            storm_hub.refresh_once()
            storm_wires = [encode_full(storm_names[i], 1000 + i, 1,
                                       storm_bodies[i])
                           for i in range(n_storm)]
            storm_errors: list = []

            def storm_drain(chunk) -> None:
                for wire in chunk:
                    try:
                        post_frame(wire)
                    except Exception as exc:  # noqa: BLE001 - recorded
                        storm_errors.append(exc)

            storm_threads = [threading.Thread(target=storm_drain,
                                              args=(storm_wires[k::6],))
                             for k in range(6)]
            for thread in storm_threads:
                thread.start()
            for thread in storm_threads:
                thread.join(timeout=30)
            storm_hub.refresh_once()
            storm_sessions = len(storm_hub.delta.sources())
            storm_served = storm_hub._push_served
            storm_lane_spread = sum(1 for lane in storm_hub.delta.lane_stats()
                                    if lane["sessions"])

            if storm_errors:
                problems.append(f"resync storm POSTs failed: "
                                f"{storm_errors[:3]}")
            if storm_sessions != n_storm:
                problems.append(f"resync storm dropped sessions: "
                                f"{storm_sessions} of {n_storm} alive")
            if storm_served != n_storm:
                problems.append(f"post-storm refresh served {storm_served} "
                                f"of {n_storm} targets by push")
            if storm_lane_spread < 2:
                problems.append(f"storm sessions all landed in one lane "
                                f"(spread {storm_lane_spread} of 4)")
            if authed_pub.pushes_total < 1 or authed_pub.failures_total:
                problems.append(
                    f"authed leaf->root push did not land (pushes "
                    f"{authed_pub.pushes_total}, failures "
                    f"{authed_pub.failures_total})")
            if authed_root.delta.full_frames_total < 1:
                problems.append("authed root accepted no frames")
            authed_rollups = ("slice_chips{" in
                              authed_root.registry.snapshot().render())
            if not authed_rollups:
                problems.append("authed root re-exported no slice rollups")
            if unauthed_pub.pushes_total or \
                    unauthed_pub.auth_failures_total < 1:
                problems.append(
                    f"credential-less push was not refused with 401 "
                    f"(pushes {unauthed_pub.pushes_total}, 401s "
                    f"{unauthed_pub.auth_failures_total})")
            text = root_hub.registry.snapshot().render()
            total_chips = sum(float(line.rsplit(" ", 1)[1])
                              for line in text.splitlines()
                              if line.startswith("slice_chips{"))
            if total_chips != nodes * 2:
                problems.append(f"root rollup has {total_chips} chips, "
                                f"want {nodes * 2}")
            resynced = leaf_of_victim.delta.full_frames_total > full_before
            if not resynced:
                problems.append(
                    f"leaf saw no full resync after the worker restart "
                    f"(full frames {leaf_of_victim.delta.full_frames_total}"
                    f", was {full_before})")
            pulled = (f'slice_target_up{{target="{leaf_urls[1]}"}} 1'
                      in text)
            if not pulled:
                problems.append(f"partitioned leaf {leaf_urls[1]} not "
                                f"served by pull fallback")
            if root_hub._push_served < 1:
                problems.append("root served no targets by push")
            row = doctor.check_fleet(f"http://127.0.0.1:{root_server.port}")
            straggler = node_urls[straggler_index]
            named = straggler in row.detail
            if not named:
                problems.append(f"doctor --fleet walk did not name the "
                                f"straggler {straggler}: {row.detail}")
            fig.update(
                root_chips=int(total_chips), worker_resynced=resynced,
                partitioned_leaf_pulled=pulled,
                authed_pushed=authed_pub.pushes_total >= 1
                and not authed_pub.failures_total,
                authed_rollups=authed_rollups,
                unauthed_pushes=unauthed_pub.pushes_total,
                unauthed_refused=unauthed_pub.auth_failures_total >= 1,
                storm_sessions=storm_sessions, storm_served=storm_served,
                storm_errors=len(storm_errors),
                storm_lanes=storm_lane_spread,
                straggler_named=named)
            result.timings.update(doctor_fleet=f"[{row.status}] "
                                               f"{row.detail}")
        finally:
            for pub in publishers:
                pub.stop()
            for server in servers:
                server.stop()
            for hub in hubs:
                hub.stop()
            for daemon in daemons:
                daemon.stop()
    return result


def add_arguments(parser) -> None:
    parser.add_argument("--nodes", type=int, default=3)
    parser.add_argument("--refreshes", type=int, default=8)
    parser.add_argument("--delay", type=float, default=0.8,
                        help="seconds each NVML utilization read of node "
                             "0 stalls (the straggler)")


def main(args) -> Result:
    result = run(args.nodes, args.refreshes, args.delay)
    print(result.report(
        f"{args.nodes} daemons -> 2 leaves -> 1 root converged, worker "
        f"restart resynced, partitioned leaf fell back to pull, authed hop "
        f"pushed + 401 refused, 48-session resync storm survived, doctor "
        f"named the straggler"))
    return result
