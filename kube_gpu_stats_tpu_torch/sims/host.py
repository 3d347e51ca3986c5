"""Host correlation: a straggler tick and host memory pressure at once.

The port of the reference's ``tools/host_sim.py``: N real NVML daemons
(over ``testing.fake_nvml``), each over a faked /proc, /sys and cgroup v2
tree (``testing/host_fixture.py``), and one hub scoring them. Once the
fleet lens's baselines are warm, one node gets a straggler tick (each of
its NVML ``utilization`` reads stalls ``delay`` seconds) and a host
memory-pressure episode (its /proc/pressure/memory full avg10 jumps
0 -> 18%) together, through:

  the daemon's host read (pool thread, off the tick path)
    -> ``kts_host_*`` exposition -> the hub's digest harvest
    -> the fleet lens's host_mem_stall baseline breach
    -> the ``doctor --fleet`` joined verdict

``doctor --fleet`` names the straggler node, its worst phase from the
flight recorder's digest, and the co-occurring host signal in one
sentence. The sim refreshes until the worst phase seen is the stall
itself (at least half of ``delay``), at most 20 times: a refresh can
name a node for a few milliseconds of host noise, as the reference's
run, which stops at the first correlated verdict, sometimes does. The reference's straggler waits in ``fetch_wait``/``rpc_port``
(its runtime fetch); NVML's stall is in the card's read, so the port's
phase is ``env_round``/``env_read``.
"""

from __future__ import annotations

import pathlib
import tempfile
import time

from ._common import Result, nvml_daemon

STALL_PCT = 18.0
# The phases a stalled NVML read lands in: the blocking tick's gather of
# the reads, or the read's own span.
READ_PHASES = ("env_round", "env_read")


def run(nodes: int = 3, warmup: int = 10, delay: float = 0.8) -> Result:
    from .. import doctor
    from ..exposition import MetricsServer
    from ..hub import Hub
    from ..testing import host_fixture

    result = Result("host")
    problems = result.problems
    straggler_index = 0
    daemons: list = []
    fakes: list = []
    hub = hub_server = None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            targets = []
            proc_roots = []
            for node in range(nodes):
                root = pathlib.Path(tmp) / f"node{node}"
                host_fixture.write_psi(root / "proc", "cpu", some_avg10=1.0,
                                       some_total_us=10_000, full_avg10=None)
                host_fixture.write_psi(root / "proc", "memory",
                                       some_avg10=0.0, full_avg10=0.0)
                host_fixture.write_psi(root / "proc", "io", some_avg10=0.5,
                                       full_avg10=0.0)
                host_fixture.write_proc_stat(root / "proc")
                host_fixture.write_softirqs(root / "proc")
                host_fixture.write_nic(root / "sys")
                host_fixture.write_thermal(root / "sys")
                host_fixture.write_pod_cgroup(root / "cgroup")
                proc_roots.append(root / "proc")
                daemon, fake, faults = nvml_daemon(
                    root, node, pods={f"train-{node}": [0, 1]},
                    sysfs_root=str(root / "sys"),
                    proc_root=str(root / "proc"),
                    cgroup_root=str(root / "cgroup"),
                    attribution_interval=0.5, pipeline_fetch=False)
                fakes.append((fake, faults))
                daemon.start()
                daemons.append(daemon)
                targets.append(
                    f"http://127.0.0.1:{daemon.server.port}/metrics")
            for daemon in daemons:
                daemon.registry.wait_for_publish(0, timeout=10)

            hub = Hub(targets, interval=0.2, expect_workers=nodes)
            hub_server = MetricsServer(
                hub.registry, host="127.0.0.1", port=0,
                trace_provider=hub.tracer, fleet_provider=hub.fleet)
            hub_server.start()
            for _ in range(warmup):
                time.sleep(0.3)
                hub.refresh_once()

            straggler = targets[straggler_index]
            fake, faults = fakes[straggler_index]
            faults.stalls = {card: {"utilization": (delay, 1)}
                             for card in range(len(fake.devices))}
            host_fixture.write_psi(
                proc_roots[straggler_index], "memory", some_avg10=35.0,
                full_avg10=STALL_PCT, some_total_us=5_000_000,
                full_total_us=1_800_000)
            row = None
            correlated: dict = {}
            refreshes = 0
            for refreshes in range(1, 21):
                time.sleep(0.3)
                hub.refresh_once()
                row = doctor.check_fleet(
                    f"http://127.0.0.1:{hub_server.port}")
                correlated = (row.data or {}).get("correlated") or {}
                worst = (row.data or {}).get("attribution") or {}
                # Until the stall itself is the worst phase seen: a
                # refresh can name a node for a few ms of host noise.
                if (straggler in correlated
                        and worst.get("target") == straggler
                        and (worst.get("seconds") or 0.0) >= delay / 2):
                    break
            data = row.data or {}
            attribution = data.get("attribution") or {}
            verdict = correlated.get(straggler) or {}
            anomalous = (data.get("anomalous") or {}).get(straggler) or {}
            named = attribution.get("target", "") == straggler
            phase = attribution.get("phase", "")
            checks = {
                "worst node is the straggler": named,
                "worst phase is the NVML read": phase in READ_PHASES,
                "host_mem_stall anomalous": "host_mem_stall" in anomalous,
                "correlated verdict's phase is the NVML read":
                    verdict.get("phase") in READ_PHASES,
                "the detail names PSI memory full-stall":
                    "PSI memory full-stall" in row.detail,
                "the detail says co-occurs with":
                    "co-occurs with" in row.detail,
            }
            problems.extend(f"{what}: no (attribution {attribution}, "
                            f"detail {row.detail!r})"
                            for what, ok in checks.items() if not ok)
            result.figures.update(
                straggler_named=named,
                phase_is_read=phase in READ_PHASES,
                host_mem_stall="host_mem_stall" in anomalous,
                mem_full_avg10=(verdict.get("host_values") or {}).get(
                    "mem_full_avg10"),
                correlated=straggler in correlated)
            result.timings.update(
                phase=phase, phase_s=attribution.get("seconds"),
                refreshes=refreshes, detail=row.detail)
        finally:
            if hub_server is not None:
                hub_server.stop()
            if hub is not None:
                hub.stop()
            for daemon in daemons:
                daemon.stop()
    return result


def add_arguments(parser) -> None:
    parser.add_argument("--nodes", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=10,
                        help="clean refreshes before the episode (covers "
                             "the lens's warm-up)")
    parser.add_argument("--delay", type=float, default=0.8,
                        help="seconds each NVML utilization read of node "
                             "0 stalls during the episode")


def main(args) -> Result:
    result = run(args.nodes, args.warmup, args.delay)
    print(result.report(
        f"doctor --fleet correlated the straggler with the host episode "
        f"(PSI memory full-stall {STALL_PCT}%) across {args.nodes} nodes"))
    return result
