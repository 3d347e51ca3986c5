"""Process wiring of the DaemonSet exporter for H100 nodes.

The port's counterpart of the reference's ``daemon.py``: parse flags →
choose the backend (NVML when a card is present, else null, or mock) →
discover devices → start the attribution and device-process watchers →
registry → HTTP server (+ textfile) → poll loop, all under a crash-only
supervisor. Process-boundary crossings: the kubelet's PodResources gRPC
over its unix socket, and the NVIDIA driver through ``libnvidia-ml.so.1``.

The daemon path imports no ``torch``: the DaemonSet image carries no CUDA
userspace beyond the NVML the container runtime injects.

One flight recorder (``tracing.Tracer``) is shared by the poll loop (span
recording, plan compiles, the label fence, the pipeline fence), the
supervisor (breaker and health journal feed), the burst sampler (arm
events, anomaly auto-arm), the WAL stores (disk faults and recoveries)
and the HTTP server (``/debug/ticks|trace|events``). The server takes
the TLS, mTLS and basic-auth flags, and serves ``/debug/burst`` (while
``--burst-mode`` is not off), ``/debug/energy`` (the energy accountant's
signed digest), ``/debug/stores`` (every disk-backed store's health),
``/debug/host``, ``/debug/egress`` and ``/debug/skew``.

Push egress: ``--pushgateway-url`` (:class:`PushgatewayPusher`),
``--remote-write-url`` (``remote_write.RemoteWriter``, durable and
sharded with ``--remote-write-wal-dir``) and ``--hub-url``
(``delta.DeltaPublisher``, with a disk spill queue under
``--hub-spill-dir``). Each sender runs on its own publish-following
thread and reads the render cache of the published generation: none of
them makes an NVML call or holds up a tick.

Not wired here (the reference's, left for later): ``reconfigure``.
"""

from __future__ import annotations

import logging
import signal
import socket
import threading

from . import __version__, native, topology, wal
from .collectors import Collector
from .collectors.mock import MockCollector, NullCollector
from .burstsampler import BurstSampler
from .config import Config
from .delta import PROTO_MAX, PROTO_MIN
from .energy import DEFAULT_COVER_GAP, EnergyAccountant
from .exposition import (MetricsServer, PushgatewayPusher, RenderStats,
                         TextfileWriter)
from .hoststats import HostStats
from .native.nvml import NvmlError
from .poll import AttributionProvider, NullAttribution, PollLoop
from .procopen import DeviceProcessWatcher
from .registry import Registry
from .supervisor import Supervisor
from .tracing import Tracer
from .workers import PeriodicRefresher

log = logging.getLogger(__name__)


def build_collector(cfg: Config, nvml=None) -> Collector:
    """The backend ``cfg.backend`` names. ``nvml`` raises ``NvmlError``
    when the library cannot be loaded or ``nvmlInit_v2`` fails: asked for
    by name, it never degrades to null. ``nvml``: the NVML binding the
    backend opens (``Daemon``'s)."""
    if cfg.backend == "mock":
        return MockCollector(num_devices=cfg.mock_devices)
    if cfg.backend == "null":
        return NullCollector()
    if cfg.backend == "nvml":
        return _open_nvml(nvml)
    # auto: NVML when a card is present, else a schema-valid null exporter
    # (card-less nodes; the daemon keeps re-probing while on null — see
    # BackendUpgradeWatcher).
    return probe_accelerator(cfg, nvml=nvml) or NullCollector()


def _nvml_collector() -> Collector:
    from .collectors.nvml import NvmlCollector

    return NvmlCollector()


def _open_nvml(nvml=None) -> Collector:
    """An NVML collector over the binding ``nvml``; None loads the
    driver's library."""
    if nvml is None:
        return _nvml_collector()
    from .collectors.nvml import NvmlCollector

    return NvmlCollector(nvml)


def probe_accelerator(cfg: Config, loglevel: int = logging.WARNING,
                      nvml=None) -> Collector | None:
    """One pass of the auto-backend probe: an NVML collector when the
    driver answers and lists at least one card, else None. The probe
    instance IS the production collector when devices are found — probing
    and serving never disagree about what "present" means. ``loglevel``
    lets the periodic re-probe demote the expected "nothing here yet"
    outcome to debug."""
    try:
        collector = _open_nvml(nvml)
    except Exception as exc:  # noqa: BLE001 - no driver: null, not a crash
        log.log(loglevel, "NVML probe failed (%s); falling back to null "
                "backend", exc)
        return None
    try:
        if collector.discover():
            return collector
    except Exception as exc:  # noqa: BLE001 - same degradation
        log.log(loglevel, "NVML discovery failed (%s); falling back to "
                "null backend", exc)
    collector.close()
    return None


def build_attribution(cfg: Config) -> AttributionProvider:
    if cfg.attribution == "off":
        return NullAttribution()
    try:
        from .attribution import build as build_attr

        return build_attr(
            mode=cfg.attribution,
            kubelet_socket=cfg.kubelet_socket,
            checkpoint_path=cfg.checkpoint_path,
            refresh_interval=cfg.attribution_interval,
        )
    except Exception as exc:
        # Attribution is an enrichment, never a reason for the DaemonSet to
        # crash-loop: degrade to unattributed metrics.
        log.warning("attribution unavailable (%s); exporting without pod labels",
                    exc)
        return NullAttribution()


def _backend_priority(collector) -> int:
    """auto-mode upgrade ordering: nvml beats null."""
    return 1 if getattr(collector, "name", "") == "nvml" else 0


class BackendUpgradeWatcher(PeriodicRefresher):
    """Re-probe for NVML while ``--backend auto`` latched the null backend
    (a daemon started before the driver was loaded, or before the card
    was attached, must not export nulls for its whole lifetime). Runs on
    the rediscovery cadence with capped backoff; the upgrade applies
    between ticks, and the watcher retires once NVML is in place. The
    first probe waits one interval: construction just probed."""

    def __init__(self, daemon: "Daemon", interval: float) -> None:
        super().__init__(interval, "backend-upgrade",
                         first_refresh_immediately=False)
        self._daemon = daemon

    def refresh_once(self) -> None:
        current_priority = _backend_priority(self._daemon.collector)
        if current_priority >= 1:
            self._stop_event.set()
            return
        try:
            new = probe_accelerator(self._daemon.cfg, loglevel=logging.DEBUG,
                                    nvml=self._daemon.nvml)
        except Exception:  # noqa: BLE001 - probe bug must not kill the thread
            log.debug("backend re-probe crashed", exc_info=True)
            new = None
        if new is None:
            # Modest backoff cap: a driver can appear any time, so keep
            # probing at most ~4x the base cadence.
            self.consecutive_failures = min(self.consecutive_failures + 1, 2)
            return
        log.info("auto backend: %s now present; upgrading from %s",
                 new.name, self._daemon.collector.name)
        self._daemon.collector = new
        self._daemon.poll.replace_collector(new)
        # Applied between ticks; retire this watcher (set, don't join —
        # we ARE the watcher thread).
        self._stop_event.set()


class Daemon:
    """Owns every long-lived component; stop() tears down in reverse
    order."""

    def __init__(self, cfg: Config, *, nvml=None) -> None:
        """``nvml``: the NVML binding the backend opens, where a caller
        runs several daemons in one process, each over its own
        (``testing.fake_nvml``, ``testing.nvml_faults``); None loads
        ``libnvidia-ml.so.1``."""
        self.cfg = cfg
        self.nvml = nvml
        # --no-native renders and gzips in Python; with the native
        # default a failed build of the extension raises here, at start.
        self.registry = Registry(native=cfg.use_native)
        self.render_stats = RenderStats()
        # Flight recorder: --no-trace keeps the object (the /debug
        # endpoints answer "disabled") but makes every recording call a
        # cheap no-op.
        self.tracer = Tracer(enabled=cfg.trace_enabled)
        # Store-fault journal feed: every WAL-backed store's disk_fault /
        # store_recovered transitions land in the shared event journal
        # beside breaker trips and health flips.
        wal.set_journal(self.tracer)
        self.collector = build_collector(cfg, nvml)
        self.attribution = build_attribution(cfg)
        # Crash-only supervisor: liveness/hang detection and restart with
        # backoff for every worker thread, and the circuit-breaker state of
        # the NVML and kubelet edges in the kts_* self-metrics and /healthz
        # reasons. Both are late-bound providers: the collector's swap on
        # the auto-mode backend upgrade, and the attribution source's lazy
        # PodResources client, resolve at read time.
        self.supervisor = Supervisor(
            check_interval=max(0.1, min(1.0, cfg.interval)),
            tracer=self.tracer)
        self.supervisor.register_breaker_provider(self._collector_breakers)
        self.supervisor.register_breaker_provider(self._attribution_breakers)
        # Per-process device holders (accelerator_process_open): the lazy
        # paths_fn closes over self.poll, which exists before the watcher's
        # first refresh (start()).
        self.procwatch = (
            DeviceProcessWatcher(
                lambda: [d.device_path for d in self.poll.devices],
                proc_root=cfg.proc_root,
                refresh_interval=cfg.attribution_interval,
                max_holders=cfg.max_process_series,
            )
            if cfg.device_processes == "on"
            else None
        )
        # Burst sampler: it resolves the CURRENT collector per pass
        # (late-bound, so it survives the auto-mode backend upgrade).
        self.burst = (
            BurstSampler(lambda: self.collector, lambda: self.poll.devices,
                         hz=cfg.burst_hz, ring=cfg.burst_ring,
                         hold=cfg.burst_hold, mode=cfg.burst_mode,
                         tracer=self.tracer)
            if cfg.burst_mode != "off"
            else None
        )
        # Energy accountant: ALWAYS constructed (an empty
        # --energy-checkpoint keeps the per-pod joules in memory only). It
        # persists them across restarts and signs the /debug/energy
        # digest with --energy-audit-key.
        self.energy = EnergyAccountant(
            checkpoint_path=cfg.energy_checkpoint,
            checkpoint_interval=cfg.energy_checkpoint_interval,
            audit_key=cfg.energy_audit_key,
            node=socket.gethostname(),
            max_gap=10 * cfg.interval,
            # "Covered by burst samples" follows the configured rate: at
            # --burst-hz 5 the honest inter-sample gap is 0.2 s, and the
            # fixed default (0.1 s) would report coverage ~0 while the
            # trapezoid integration was fully active.
            cover_gap=max(DEFAULT_COVER_GAP, 4.0 / cfg.burst_hz),
        )
        # Host-signals collector: read once per tick on the poll loop's
        # pool, exported as kts_host_* and served at /debug/host. ALWAYS
        # constructed — under --no-host-stats the disabled instance keeps
        # the endpoint up answering enabled:false. The per-pod cgroup
        # join resolves pod UIDs through the kubelet attribution mapping
        # via the cards' holder processes.
        self.hoststats = HostStats(
            proc_root=cfg.proc_root,
            sysfs_root=cfg.sysfs_root,
            cgroup_root=cfg.cgroup_root,
            pod_map=self._pod_uid_map,
            enabled=cfg.host_stats,
            # Capability-probe the optional eBPF runqueue source once at
            # startup (it refuses gracefully; /debug/host says why).
            probe_ebpf=cfg.host_stats,
        )
        self.poll = PollLoop(
            self.collector,
            self.registry,
            interval=cfg.interval,
            deadline=cfg.deadline,
            attribution=self.attribution,
            topology_labels=topology.topology_labels(),
            version=__version__,
            rediscovery_interval=cfg.rediscovery_interval,
            pipeline_fetch=cfg.pipeline_fetch,
            drop_labels=cfg.drop_labels,
            disabled_metrics=cfg.disabled_metrics,
            process_openers=self.procwatch.lookup if self.procwatch else None,
            push_stats=self._push_stats,
            egress_stats=self._egress_stats,
            render_stats=self.render_stats.contribute,
            health_stats=self.supervisor.contribute,
            heartbeat=self.supervisor.beater("poll"),
            tracer=self.tracer,
            burst_sampler=self.burst,
            energy=self.energy,
            host_stats=self.hoststats,
            label_value_cap=cfg.label_value_cap,
        )
        # Hung-tick watchdog threshold: same formula as healthz_max_age,
        # so the supervisor respawns the loop BEFORE the liveness probe
        # would kill the whole pod for the same hang.
        self.supervisor.register(
            "poll", is_alive=self.poll.thread_alive,
            restart=self.poll.respawn,
            heartbeat_timeout=max(5.0, cfg.interval * 5),
            breaker_prefixes=("nvml",))
        self.server = MetricsServer(
            self.registry, cfg.listen_host, cfg.listen_port,
            # A few missed intervals = unhealthy (floor for tiny test
            # intervals where scheduling jitter dominates).
            healthz_max_age=max(5.0, cfg.interval * 5),
            tls_cert_file=cfg.tls_cert_file,
            tls_key_file=cfg.tls_key_file,
            tls_client_ca_file=cfg.tls_client_ca_file,
            max_concurrent_scrapes=cfg.max_concurrent_scrapes,
            auth_username=cfg.auth_username,
            auth_password_sha256=cfg.auth_password_sha256,
            render_stats=self.render_stats,
            health_provider=self.supervisor.health_report,
            trace_provider=self.tracer,
            burst_provider=self.burst,
            energy_provider=self.energy,
            host_provider=self.hoststats,
            egress_provider=self._egress_payload,
            skew_provider=self._skew_payload,
            stores_provider=self._stores_payload,
        )
        self.textfile = (
            TextfileWriter(self.registry, cfg.textfile_dir,
                           render_stats=self.render_stats)
            if cfg.textfile_enabled
            else None
        )
        self.pusher = (
            PushgatewayPusher(self.registry, cfg.pushgateway_url,
                              job=cfg.pushgateway_job,
                              render_stats=self.render_stats)
            if cfg.pushgateway_url
            else None
        )
        self.upgrade_watcher = (
            BackendUpgradeWatcher(self, cfg.rediscovery_interval)
            if cfg.backend == "auto"
            and _backend_priority(self.collector) < 1
            and cfg.rediscovery_interval > 0
            else None
        )
        self.remote_writer = None
        if cfg.remote_write_url:
            from .remote_write import RemoteWriter

            self.remote_writer = RemoteWriter(
                self.registry, cfg.remote_write_url,
                job=cfg.remote_write_job,
                min_interval=cfg.remote_write_interval,
                bearer_token_file=cfg.remote_write_bearer_token_file,
                protocol=cfg.remote_write_protocol,
                extra_labels=cfg.remote_write_extra_labels,
                render_stats=self.render_stats,
                shards=cfg.remote_write_shards,
                wal_dir=cfg.remote_write_wal_dir,
                wal_max_bytes=cfg.remote_write_wal_max_bytes,
                drain_max_per_push=cfg.remote_write_drain_max,
                tracer=self.tracer,
            )
        # Delta push to an upstream hub: each published snapshot ships
        # as a changed-series delta. Source defaults to this node's own
        # scrape URL so the hub's fallback pull lands here.
        self.delta_pusher = None
        if cfg.hub_url:
            from .delta import DeltaPublisher, push_headers_provider

            # Partition survival: with --hub-spill-dir, a down hub link
            # spools every published snapshot to a bounded on-disk ring
            # (drained oldest-first, rate-limited on reconnect) instead
            # of dropping it to the backoff.
            spill = None
            if cfg.hub_spill_dir:
                from .spillq import SpillQueue

                spill = SpillQueue(cfg.hub_spill_dir,
                                   max_bytes=cfg.hub_spill_max_bytes,
                                   tracer=self.tracer)
            self.delta_pusher = DeltaPublisher(
                self.registry, cfg.hub_url,
                source=cfg.hub_push_source or (
                    f"http://{socket.gethostname()}:"
                    f"{cfg.listen_port}/metrics"),
                min_interval=cfg.hub_push_interval,
                render_stats=self.render_stats,
                headers_provider=push_headers_provider(
                    cfg.hub_auth_username, cfg.hub_auth_password_file),
                ca_file=cfg.hub_ca_file,
                insecure_tls=cfg.hub_insecure_tls,
                tracer=self.tracer,
                spill=spill,
                drain_rate=cfg.hub_drain_rate,
                proto_max=cfg.hub_proto_max,
            )

    def _pod_uid_map(self) -> dict[str, tuple[str, str]]:
        """pod UID -> (pod, namespace) for the host collector's cgroup
        join: a card whose holder process carries a pod UID (procopen's
        cgroup parse) ties that UID to the kubelet attribution mapping's
        pod for the same card. Dict walks over cached state — no RPC,
        safe from the host-read pool thread."""
        if self.procwatch is None:
            return {}
        out: dict[str, tuple[str, str]] = {}
        for dev in self.poll.devices:
            attribution = self.attribution.lookup(dev)
            pod = attribution.get("pod", "")
            if not pod:
                continue
            namespace = attribution.get("namespace", "")
            for _pid, _comm, pod_uid, _value in \
                    self.procwatch.lookup(dev.device_path):
                if pod_uid:
                    out.setdefault(pod_uid, (pod, namespace))
        return out

    def _push_stats(self) -> dict[str, dict[str, int]]:
        """Shipping-health counters for the collector_push_* self metrics.
        Wired into the poll loop at construction; the senders are created
        after the loop, so this resolves them late (each tick)."""
        stats: dict[str, dict[str, int]] = {}
        for mode, sender in (("pushgateway", getattr(self, "pusher", None)),
                             ("remote_write",
                              getattr(self, "remote_writer", None)),
                             ("delta",
                              getattr(self, "delta_pusher", None))):
            if sender is not None:
                stats[mode] = {
                    "pushes": sender.pushes_total,
                    "failures": sender.failures_total,
                    "dropped": sender.dropped_total,
                }
                if hasattr(sender, "shed_honored_total"):
                    # Delta publishers only: hub-admission sheds this
                    # publisher honored — their own class, deliberately
                    # NOT in failures (the hub is shaping load, not
                    # failing).
                    stats[mode]["shed_honored"] = sender.shed_honored_total
                if hasattr(sender, "skew_refused_total"):
                    # Delta publishers only: pushes the upstream hub
                    # refused for wire-version skew (426). Kept as the
                    # reference keeps it, though contribute_push_stats
                    # folds no family from it: the count reaches an
                    # operator through /debug/skew, not this exposition.
                    stats[mode]["skew_refused"] = sender.skew_refused_total
        return stats

    def _egress_stats(self) -> dict:
        """Spill-queue + durable remote-write status for the
        kts_spill_*/kts_remote_write_* fold and /debug/egress.
        Late-bound like _push_stats — the senders are created after the
        poll loop."""
        out: dict = {}
        pusher = getattr(self, "delta_pusher", None)
        if pusher is not None:
            status = pusher.spill_status()
            if status is not None:
                out["spill"] = status
        writer = getattr(self, "remote_writer", None)
        if writer is not None:
            status = writer.egress_status()
            if status is not None:
                out["remote_write"] = status
        return out

    def _egress_payload(self) -> dict:
        """/debug/egress: the egress-durability picture plus per-sender
        shipping health — what `doctor --egress` summarizes. enabled
        says whether ANY durability (spill queue / durable remote write)
        is configured; sender rows appear for every configured sender
        either way (their failure counters are the 'is the link down'
        half of the triage)."""
        payload: dict = dict(self._egress_stats())
        payload["enabled"] = bool(payload)
        senders: dict = {}
        for mode, sender in (("delta", self.delta_pusher),
                             ("remote_write", self.remote_writer),
                             ("pushgateway", self.pusher)):
            if sender is not None:
                senders[mode] = {
                    "pushes_total": sender.pushes_total,
                    "failures_total": sender.failures_total,
                    "dropped_total": sender.dropped_total,
                    "consecutive_failures": sender.consecutive_failures,
                }
                if hasattr(sender, "skipped_total"):
                    # The port's addition (the delta publisher): snapshots
                    # published while a push lasted past the next publish,
                    # which no receiver ever sees.
                    senders[mode]["skipped_total"] = \
                        sender.skipped_total
        payload["senders"] = senders
        return payload

    def _skew_payload(self) -> dict:
        """/debug/skew for a daemon: this build's version + wire-protocol
        range, the delta publisher's negotiation state against its
        upstream hub when one is configured, and any persisted-format
        files quarantined at startup — the node-side evidence `doctor
        --skew` reads."""
        pusher = self.delta_pusher
        return {
            "role": "daemon",
            "build": __version__,
            "proto_min": PROTO_MIN,
            "proto_max": PROTO_MAX,
            "publisher": (pusher.skew_status()
                          if pusher is not None else None),
            "wal_quarantined": wal.quarantine_counts(),
            "wal_quarantine_events": wal.quarantine_events(),
        }

    def _stores_payload(self) -> dict:
        """/debug/stores: every disk-backed store's durability state
        machine (which store is degraded, why, what was lost), the
        accept-loop fd fence, and the supervisor's restarted and
        storm-latched threads — what ``doctor --stores`` summarizes."""
        return {
            "enabled": True,
            "role": "daemon",
            "stores": wal.store_report(),
            "accept_fence": self.server.accept_fence_status(),
            "threads": self.supervisor.restart_report(),
        }

    def _collector_breakers(self):
        """The current collector's breakers (late-bound: survives the
        auto-mode backend upgrade)."""
        fn = getattr(self.collector, "breakers", None)
        return fn() if callable(fn) else {}

    def _attribution_breakers(self):
        """The attribution source's kubelet breaker, once it exists."""
        breaker = getattr(self.attribution, "breaker", None)
        return {"kubelet": breaker} if breaker is not None else {}

    def start(self) -> None:
        starter = getattr(self.attribution, "start", None)
        if starter:
            starter()
        if self.procwatch:
            self.procwatch.start()
        self.server.start()
        if self.textfile:
            self.textfile.start()
        if self.pusher:
            self.pusher.start()
        if self.remote_writer:
            self.remote_writer.start()
        if self.delta_pusher:
            self.delta_pusher.start()
        if self.upgrade_watcher:
            self.upgrade_watcher.start()
        if self.burst is not None:
            self.burst.start()
        self.poll.start()
        # Liveness-only supervision for the auxiliary worker threads
        # (their loops already contain exceptions, so death is a bug — the
        # crash-only answer is a fresh thread over retained state). The
        # upgrade watcher is deliberately NOT supervised: it retires itself
        # once NVML latches, and a restart would resurrect it. The
        # supervisor starts last so no watchdog pass can see a component
        # before its thread exists.
        for name, component in (
            ("attribution", self.attribution),
            ("pushgateway", self.pusher),
            ("remote_write", self.remote_writer),
            ("delta_push", self.delta_pusher),
            ("textfile", self.textfile),
            ("procwatch", self.procwatch),
        ):
            alive = getattr(component, "thread_alive", None)
            starter = getattr(component, "start", None)
            if component is not None and callable(alive) and callable(starter):
                # Publish-following senders beat once per loop pass: a
                # sender wedged INSIDE a push — a hung socket, a stuck
                # fsync on the spill drain — is detected as a hang, not
                # only when the thread dies outright. 60 s covers the
                # worst honest pass (several 10 s-timeout POSTs back to
                # back).
                heartbeat_timeout = 0.0
                restart = starter
                if hasattr(component, "heartbeat"):
                    component.heartbeat = self.supervisor.beater(name)
                    heartbeat_timeout = 60.0
                    # Hang restarts must ABANDON the wedged thread
                    # (PublishFollower.respawn; the old one retires at
                    # its next superseded() check) — start() is a no-op
                    # on a live thread, so it cannot recover a hang.
                    restart = getattr(component, "respawn", starter)
                self.supervisor.register(
                    name, is_alive=alive, restart=restart,
                    heartbeat_timeout=heartbeat_timeout,
                    breaker_prefixes=(("kubelet",)
                                      if name == "attribution" else ()))
        if self.burst is not None:
            # The sub-tick sampler: a killed or wedged sampler thread
            # would silently stop the burst families.
            self.burst.heartbeat = self.supervisor.beater("burst")
            self.supervisor.register(
                "burst", is_alive=self.burst.thread_alive,
                restart=self.burst.respawn, heartbeat_timeout=30.0)
        if self.server.prewarm_enabled:
            # The render pre-warmer: a dead warmer makes every scrape pay
            # the render inline, with no functional symptom.
            self.supervisor.register(
                "render-warmer", is_alive=self.server.warm_thread_alive,
                restart=self.server.respawn_warm)
        self.supervisor.start()
        log.info(
            "kube-tpu-stats %s: backend=%s devices=%d listening on %s:%d",
            __version__, self.collector.name, len(self.poll.devices),
            self.cfg.listen_host, self.server.port,
        )

    def stop(self) -> None:
        # Supervisor first: a watchdog firing mid-teardown would respawn
        # the very threads stop() is joining.
        self.supervisor.stop()
        if self.upgrade_watcher:
            self.upgrade_watcher.stop()
        if self.burst is not None:
            self.burst.stop()
        self.poll.stop()
        # Final forced checkpoint: the last partial interval of per-pod
        # joules must survive a clean pod reschedule.
        self.energy.checkpoint(force=True)
        if self.procwatch:
            self.procwatch.stop()
        if self.textfile:
            self.textfile.stop()
        # The senders' final flush runs in their stop(): after the last
        # tick and the final energy checkpoint, so the last snapshot
        # ships too.
        if self.pusher:
            self.pusher.stop()
        if self.remote_writer:
            self.remote_writer.stop()
        if self.delta_pusher:
            self.delta_pusher.stop()
        self.server.stop()
        stopper = getattr(self.attribution, "stop", None)
        if stopper:
            stopper()
        self.collector.close()


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line, keys aligned with Cloud Logging's
    structured-log parsing (severity/message/timestamp); exception text
    folded into the message so every record stays single-line."""

    def format(self, record: logging.LogRecord) -> str:
        import json
        import time as _time

        message = record.getMessage()
        if record.exc_info:
            message += "\n" + self.formatException(record.exc_info)
        return json.dumps({
            "timestamp": _time.strftime(
                "%Y-%m-%dT%H:%M:%S", _time.gmtime(record.created)
            ) + f".{int(record.msecs):03d}Z",
            "severity": record.levelname,
            "logger": record.name,
            "message": message,
        })


def setup_logging(cfg: Config) -> None:
    level = getattr(logging, cfg.log_level.upper(), logging.INFO)
    if cfg.log_format == "json":
        handler = logging.StreamHandler()
        handler.setFormatter(JsonLogFormatter())
        logging.basicConfig(level=level, handlers=[handler])
    else:
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(levelname)s %(name)s %(message)s",
        )


def run(cfg: Config) -> int:
    setup_logging(cfg)
    if not cfg.use_native:
        native.use_python_paths("--no-native")
    try:
        daemon = Daemon(cfg)
    except NvmlError as exc:
        # --backend nvml without a usable driver: fail at startup with
        # NVML's own error, never serve null in its place.
        log.error("cannot start the %s backend: %s", cfg.backend, exc)
        return 1
    except native.NativeUnavailable as exc:
        log.error("cannot start: %s", exc)
        return 1
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        # Inside the try: a partial start (unwritable textfile dir) must
        # still tear down what DID start.
        daemon.start()
        stop.wait()
    finally:
        daemon.stop()
    return 0
