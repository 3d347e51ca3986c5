"""Local faults: the daemon's and the hub's disks, threads and fds.

The port of the reference's ``tools/localfault_sim.py``: a real NVML
daemon (over ``testing.fake_nvml``; burst sampler continuous, energy
checkpoint, delta publisher with a disk spill queue) pushing into a real
hub (delta ingest with its checkpoint), through every local fault,
injected at the ``os`` level by ``testing/faultfs.py`` under this sim's
directory:

- **ENOSPC mid-drain**: the spill queue's disk fills while a hub
  blackout's backlog spools. The store degrades (counted, journaled),
  telemetry goes on in memory with the durability loss counted, and
  once the disk clears the store re-arms and the whole backlog drains:
  no frame dropped, no process death;
- **EIO on the energy checkpoint's fsync**: the checkpoint defers, the
  store degrades then recovers, the poll loop lives;
- **EROFS on the hub's ingest checkpoint**: exactly one ``disk_fault``
  journal event for the episode, frames keep applying exactly once,
  durability re-arms;
- **a killed sampler thread**: the supervisor respawns the burst sampler
  and counts the restart;
- **EMFILE on the hub's accept loop**: the fence sheds with backoff
  (counted, journaled) and the loop serves again.

Then ``doctor --stores`` names every store that degraded and the
restarted thread, and the ``kts_store_*`` families carry the same
accounting on the daemon's exposition.
"""

from __future__ import annotations

import pathlib
import tempfile
import urllib.request

from ._common import Result, nvml_daemon, wait_for


def run() -> Result:
    from .. import wal

    result = Result("localfault")
    problems = result.problems
    fig = result.figures
    # The stores' health registry is process-wide: start from an empty
    # one, as a fresh process does, with fast recovery probes; put the
    # probe cadence back at the end.
    wal.reset_store_stats()
    probe_interval = wal.DEFAULT_PROBE_INTERVAL
    wal.set_probe_interval(0.2)
    try:
        _run(result)
    finally:
        wal.set_probe_interval(probe_interval)
    return result


def _run(result: Result) -> None:
    from .. import doctor, wal
    from ..exposition import MetricsServer
    from ..hub import Hub
    from ..supervisor import Supervisor
    from ..testing.faultfs import FaultFS, fence_accepts
    from ..validate import parse_exposition

    problems = result.problems
    fig = result.figures
    with tempfile.TemporaryDirectory() as tmp, FaultFS() as fs:
        base = pathlib.Path(tmp)
        fs.watch(str(base))
        hub = Hub([], targets_provider=lambda: [], interval=0.2,
                  push_fence=1e9,
                  ingest_checkpoint=str(base / "ingest" / "ck.json"),
                  ingest_checkpoint_interval=0.05)
        supervisor = Supervisor(check_interval=0.1, tracer=hub.tracer)
        hub.attach_supervisor(supervisor)
        server = MetricsServer(hub.registry, host="127.0.0.1", port=0,
                               ingest_provider=hub.delta.handle,
                               stores_provider=lambda: {
                                   "enabled": True, "role": "hub",
                                   "stores": wal.store_report(),
                                   "accept_fence":
                                       server.accept_fence_status(),
                                   "threads":
                                       supervisor.restart_report(),
                               })
        server.start()
        hub_port = server.port
        daemon, _fake, _faults = nvml_daemon(
            base / "node", 0, interval=0.05, device_processes="off",
            burst_mode="continuous", burst_hz=50.0,
            energy_checkpoint=str(base / "energy" / "ck.json"),
            energy_checkpoint_interval=0.05,
            hub_url=f"http://127.0.0.1:{hub_port}",
            hub_push_interval=0.02,
            hub_push_source="http://node-0:9400/metrics",
            hub_spill_dir=str(base / "spill"), hub_drain_rate=5000.0)
        daemon.start()
        hub.start()
        supervisor.register("hub-refresh", is_alive=hub.thread_alive,
                            restart=hub.respawn, heartbeat_timeout=30.0)
        supervisor.start()
        daemon_base = f"http://127.0.0.1:{daemon.server.port}"
        server2 = None
        try:
            publisher = daemon.delta_pusher
            spill = publisher._spill
            if not wait_for(lambda: publisher.pushes_total >= 2, 15.0):
                problems.append("setup: publisher never synced to hub")

            # 1. ENOSPC on the spill disk mid-drain.
            server.stop()  # blackout: snapshots spool
            if not wait_for(lambda: spill.depth() >= 3, 15.0):
                problems.append("enospc: snapshots not spooling")
            durable_spooled = spill.spooled_total
            fs.inject(str(base / "spill"), "enospc",
                      ops=("open", "write", "fsync"))
            spill_health = wal.store_health("spill")
            degraded = wait_for(
                lambda: spill_health.state == wal.STORE_DEGRADED, 10.0)
            if not degraded:
                problems.append("enospc: spill store never degraded")
            if not wait_for(lambda: spill_health.lost_records >= 2, 10.0):
                problems.append("enospc: loss not counted while degraded")
            fig["enospc.errno"] = spill_health.errno_name
            result.timings["enospc.lost_durability"] = \
                spill_health.lost_records
            fs.clear()
            recovered = wait_for(
                lambda: spill_health.state == wal.STORE_HEALTHY, 10.0)
            if not recovered:
                problems.append("enospc: store did not auto-recover after "
                                "the fault cleared")
            server2 = MetricsServer(hub.registry, host="127.0.0.1",
                                    port=hub_port,
                                    ingest_provider=hub.delta.handle)
            server2.start()
            publisher._probe_at = 0.0
            if not wait_for(lambda: spill.depth() == 0, 20.0):
                problems.append(f"enospc: backlog never drained "
                                f"(depth {spill.depth()})")
            if spill.dropped_total:
                problems.append(
                    f"enospc: {spill.dropped_total} frame(s) dropped: the "
                    f"degraded window must lose durability, not records")
            if spill.drained_total < durable_spooled:
                problems.append("enospc: drained fewer frames than were "
                                "spooled before the fault")
            fig.update({"enospc.degraded": degraded,
                        "enospc.recovered": recovered,
                        "enospc.dropped": spill.dropped_total,
                        "enospc.drained_all":
                            spill.drained_total >= durable_spooled})
            result.timings["enospc.drained"] = spill.drained_total

            # 2. EIO on the energy checkpoint's fsync.
            energy_health = wal.store_health("energy")
            if not wait_for(lambda: daemon.energy.checkpoint_writes >= 1,
                            10.0):
                problems.append("eio: energy checkpoint never wrote")
            fs.inject(str(base / "energy"), "eio", ops=("fsync",))
            degraded = wait_for(
                lambda: energy_health.state == wal.STORE_DEGRADED, 10.0)
            if not degraded:
                problems.append("eio: energy store never degraded (fsync "
                                "fault not contained?)")
            poll_alive = daemon.poll.thread_alive()
            if not poll_alive:
                problems.append("eio: poll loop died to a checkpoint fault")
            fs.clear()
            rearmed = wait_for(
                lambda: energy_health.state == wal.STORE_HEALTHY, 10.0)
            if not rearmed:
                problems.append("eio: energy store did not re-arm")
            writes_after = daemon.energy.checkpoint_writes
            resumed = wait_for(
                lambda: daemon.energy.checkpoint_writes > writes_after, 10.0)
            if not resumed:
                problems.append("eio: checkpoints did not resume")
            fig.update({"eio.degraded": degraded, "eio.poll_alive":
                        poll_alive, "eio.rearmed": rearmed,
                        "eio.resumed": resumed})
            result.timings["eio.faults"] = \
                energy_health.fault_counts.get("EIO", 0)

            # 3. EROFS on the hub's ingest checkpoint.
            ingest_health = wal.store_health("ingest")

            def ingest_faults() -> int:
                return sum(1 for e in hub.tracer.events().get("events", ())
                           if e["kind"] == "disk_fault"
                           and e["attrs"].get("store") == "ingest")

            events_before = ingest_faults()
            dups_before = hub.delta.duplicate_frames_total
            fs.inject(str(base / "ingest"), "erofs",
                      ops=("open", "write", "fsync"))
            degraded = wait_for(
                lambda: ingest_health.state == wal.STORE_DEGRADED, 10.0)
            if not degraded:
                problems.append("erofs: ingest store never degraded")
            frames_at = hub.delta.delta_frames_total
            if not wait_for(
                    lambda: hub.delta.delta_frames_total > frames_at + 2,
                    10.0):
                problems.append("erofs: ingest stopped applying frames "
                                "while its checkpoint disk was read-only")
            journaled = ingest_faults() - events_before
            if journaled != 1:
                problems.append(f"erofs: expected exactly 1 disk_fault "
                                f"journal event for the episode, saw "
                                f"{journaled}")
            fs.clear()
            rearmed = wait_for(
                lambda: ingest_health.state == wal.STORE_HEALTHY, 10.0)
            if not rearmed:
                problems.append("erofs: ingest store did not re-arm")
            dups = hub.delta.duplicate_frames_total - dups_before
            if dups:
                problems.append("erofs: duplicate-counted frames during "
                                "the episode (exactly-once broken)")
            fig.update({"erofs.degraded": degraded,
                        "erofs.journal_events": journaled,
                        "erofs.duplicates": dups, "erofs.rearmed": rearmed})

            # 4. A killed background thread.
            def burst_restarts() -> int:
                return next((r["restarts"]
                             for r in daemon.supervisor.restart_report()
                             if r["component"] == "burst"), 0)

            restarts_before = burst_restarts()

            def _die() -> int:
                raise RuntimeError("sim: sampler killed")

            daemon.burst._read_once = _die  # the thread dies on arrival
            if not wait_for(lambda: not daemon.burst.thread_alive(), 10.0):
                problems.append("kill: sampler thread refused to die")
            del daemon.burst.__dict__["_read_once"]
            respawned = wait_for(daemon.burst.thread_alive, 15.0)
            if not respawned:
                problems.append("kill: supervisor never respawned the "
                                "sampler")
            restarts = burst_restarts() - restarts_before
            if restarts <= 0:
                problems.append("kill: burst restart not counted")
            fig.update({"kill.respawned": respawned,
                        "kill.restart_counted": restarts > 0})
            # The dying thread may be respawned into the fault once more
            # before it is healed: how often is the host's timing.
            result.timings["kill.restarts"] = restarts

            # 5. fd exhaustion on the hub's accept loop.
            proxy = fence_accepts(server2, times=5)
            pushes_at = publisher.pushes_total
            if not wait_for(lambda: publisher.pushes_total > pushes_at + 2,
                            15.0):
                problems.append("emfile: pushes never recovered after the "
                                "accept fence (loop dead?)")
            if proxy.faults_served != 5:
                problems.append(f"emfile: fence served "
                                f"{proxy.faults_served}/5 injected faults")
            fence = server2.accept_fence_status()
            if fence["fenced_total"] < 5 or fence["in_episode"]:
                problems.append(f"emfile: fence accounting wrong ({fence})")
            emfile = wal.store_health("http-accept").fault_counts.get(
                "EMFILE", 0)
            if emfile < 5:
                problems.append("emfile: faults not counted in "
                                "kts_disk_faults_total{store=http-accept}")
            fig.update({"emfile.faults_served": proxy.faults_served,
                        "emfile.fenced": fence["fenced_total"],
                        "emfile.in_episode": fence["in_episode"]})
            result.timings["emfile.episodes"] = fence["episodes"]

            # doctor --stores names everything.
            row = doctor.check_stores(daemon_base)
            if row.status == doctor.FAIL:
                problems.append(f"doctor --stores failed: {row.detail}")
            payload = row.data.get("stores", {})
            for store in ("spill", "energy"):
                info = (payload.get("stores") or {}).get(store)
                if not info or not sum(
                        (info.get("fault_counts") or {}).values()):
                    problems.append(f"doctor: store {store!r} fault "
                                    f"history missing from /debug/stores")
            if "burst" not in row.detail:
                problems.append(f"doctor --stores did not name the "
                                f"restarted burst thread: {row.detail!r}")
            fig["doctor.status"] = row.status

            with urllib.request.urlopen(daemon_base + "/metrics",
                                        timeout=5) as response:
                text = response.read().decode()
            rows = parse_exposition(text)
            families = {name for name, _labels, _v in rows}
            for family in ("kts_store_state", "kts_disk_faults_total",
                           "kts_store_lost_records_total",
                           "kts_thread_restart_storms_total"):
                if family not in families:
                    problems.append(f"{family} missing from the daemon "
                                    f"exposition")
            lost_exported = sum(v for name, labels, v in rows
                                if name == "kts_store_lost_records_total"
                                and labels.get("store") == "spill")
            if lost_exported != spill_health.lost_records:
                problems.append(f"exported spill loss {lost_exported} != "
                                f"ledger {spill_health.lost_records} "
                                f"(accounting drift)")
            fig["exported_loss_matches"] = \
                lost_exported == spill_health.lost_records
            if not daemon.poll.thread_alive():
                problems.append("daemon poll loop dead at sim end")
            if not hub.thread_alive():
                problems.append("hub refresh thread dead at sim end")
        finally:
            supervisor.stop()
            daemon.stop()
            hub.stop()
            if server2 is not None:
                server2.stop()
            server.stop()


def add_arguments(parser) -> None:
    pass


def main(args) -> Result:
    result = run()
    print(result.report(
        "ENOSPC/EIO/EROFS/killed thread/EMFILE all survived: no process "
        "death, loss exactly accounted, every store recovered, doctor "
        "--stores names the degraded stores and the restarted thread"))
    return result
