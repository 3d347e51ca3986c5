"""Configuration of the daemon and the hub: CLI flags + environment.

The port's copy of the reference's ``Config``, ``build_parser`` and
``from_args``, cut to the flags this package wires. Each flag keeps the
reference's name, default and ``KTS_*`` environment variable, so the
DaemonSet manifest configures the container without args churn; a
reference flag that is not wired here is rejected by argparse, not
accepted and ignored. The push-egress flags (``--pushgateway-*``,
``--remote-write-*``, ``--hub-*``) come from the reference whole:
:func:`add_delta_push_flags` and :func:`validate_delta_push_args` keep
its shape, and the hub (``hub.main``) shares them with the daemon, beside
its own groups: :func:`add_ingest_guard_flags` (``--ingest-*``),
:func:`add_cardinality_flags` (``--series-*``),
:func:`add_history_flags` (``--no-history``, ``--history-*``),
:func:`add_efficiency_flags` (``--no-efficiency``, ``--waste-*``) and
:func:`add_hub_noop_flags`; :func:`add_fleet_lens_flags` (``--no-fleet-lens``,
``--slo-*``) sits on both parsers, as in the reference, so a manifest
written for either daemon parses. ``nvml`` takes the place of the reference's ``tpu``
backend; the reference's ``gpu`` (drm sysfs) backend is not offered on an
NVIDIA node.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
from typing import Sequence

from . import fleetlens

DEFAULT_KUBELET_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"
DEFAULT_CHECKPOINT = "/var/lib/kubelet/device-plugins/kubelet_internal_checkpoint"

BACKENDS = ("auto", "nvml", "mock", "null")


@dataclasses.dataclass
class Config:
    backend: str = "auto"
    interval: float = 1.0
    deadline: float = 0.050  # per-tick budget
    listen_host: str = "0.0.0.0"
    listen_port: int = 9400
    tls_cert_file: str = ""  # both set = serve HTTPS
    tls_key_file: str = ""
    tls_client_ca_file: str = ""  # set = require client certs (mTLS)
    auth_username: str = ""  # + password hash = basic auth on /metrics
    auth_password_sha256: str = ""
    max_concurrent_scrapes: int = 16  # parallel /metrics renders; 0 = off
    # Fleet-lens / SLO knobs. Scored by the HUB's fleet lens (hub.py
    # shares these flags via add_fleet_lens_flags); carried on the
    # daemon config surface so doctor and tools accept the same
    # spellings + KTS_SLO_* env vars everywhere. Defaults come from
    # fleetlens (the single source both CLIs use) so a programmatic
    # Config() can never drift from the flag surface.
    fleet_lens: bool = True
    slo_freshness_target: float = fleetlens.DEFAULT_FRESHNESS_TARGET
    slo_straggler_target: float = fleetlens.DEFAULT_STRAGGLER_TARGET
    slo_straggler_ratio: float = fleetlens.DEFAULT_STRAGGLER_RATIO
    textfile_dir: str = ""  # empty = textfile output disabled
    pushgateway_url: str = ""  # empty = push disabled
    pushgateway_job: str = "kube-tpu-stats"
    remote_write_url: str = ""  # empty = remote_write disabled
    remote_write_job: str = "kube-tpu-stats"
    remote_write_interval: float = 15.0
    remote_write_bearer_token_file: str = ""
    remote_write_protocol: str = "1.0"  # 1.0 | 2.0 (415 downgrades to 1.0)
    remote_write_extra_labels: tuple = ()  # ((name, value), ...) stamped on
    #                                        every remote-written series
    # Durable sharded exporter: wal_dir set => every snapshot is
    # journaled to per-shard write-ahead segment rings and drained with
    # retry classification (5xx/timeout retried off the WAL, poison 4xx
    # parked, Retry-After honored) — a receiver outage becomes late
    # delivery, bounded and accounted, instead of a hole.
    remote_write_shards: int = 1
    remote_write_wal_dir: str = ""
    remote_write_wal_max_bytes: int = 64 * 1024 * 1024
    remote_write_drain_max: int = 64  # requests per shard per push cycle
    sysfs_root: str = "/sys"
    proc_root: str = "/proc"
    device_processes: str = "on"  # accelerator_process_open scan (on|off)
    max_process_series: int = 32  # process_open holders per device; excess
    #                               folds into one comm="_overflow" series
    attribution: str = "auto"  # auto|podresources|checkpoint|off
    kubelet_socket: str = DEFAULT_KUBELET_SOCKET
    checkpoint_path: str = DEFAULT_CHECKPOINT
    attribution_interval: float = 10.0
    rediscovery_interval: float = 60.0  # 0 disables hotplug re-enumeration
    pipeline_fetch: bool = True  # tick serves the last completed read
    #                              round (False: join this tick's reads)
    trace_enabled: bool = True  # flight recorder (per-tick span digest)
    drop_labels: tuple[str, ...] = ()  # label keys emitted as "" (cardinality)
    label_value_cap: int = 0  # distinct values per attribution label key
    #                           before new values degrade to "overflow";
    #                           0 = unfenced
    metrics_include: tuple[str, ...] = ()  # family allowlist (() = all)
    metrics_exclude: tuple[str, ...] = ()  # family denylist
    disabled_metrics: frozenset = frozenset()  # resolved from the two above
    burst_mode: str = "auto"  # off | auto (demand/anomaly armed) |
    #                           continuous
    burst_hz: float = 100.0  # sampling rate while armed
    burst_hold: float = 30.0  # seconds a demand/anomaly arm stays armed
    burst_ring: int = 4096  # buffered samples per device
    energy_checkpoint: str = ""  # path; empty = per-pod joules reset on
    #                              restart (in-memory only)
    energy_checkpoint_interval: float = 10.0
    energy_audit_key: str = ""  # HMAC key signing the /debug/energy
    #                             digest; empty = unsigned
    # Delta push: when hub_url is set, the daemon publishes seq-numbered
    # changed-series deltas to that hub's /ingest/delta instead of
    # waiting to be pull-scraped. hub_push_source is the identity the
    # hub lists this node under — by convention the node's own scrape
    # URL, so the hub's pull fallback lands on the right endpoint; empty
    # derives it from the hostname and listen port at startup.
    hub_url: str = ""
    hub_push_source: str = ""
    hub_push_interval: float = 1.0
    # Credentials + TLS trust for the POSTs to --hub-url. The password
    # rides in a file, re-read per push, never on the command line.
    hub_auth_username: str = ""
    hub_auth_password_file: str = ""
    hub_ca_file: str = ""
    hub_insecure_tls: bool = False
    # Partition survival: when hub_spill_dir is set, a publisher whose
    # hub link is down spools every published snapshot to a bounded
    # on-disk ring and drains it oldest-first (at most hub_drain_rate
    # frames/s) on reconnect. Empty = offline snapshots are lost.
    hub_spill_dir: str = ""
    hub_spill_max_bytes: int = 64 * 1024 * 1024
    hub_drain_rate: float = 50.0
    # The highest delta wire-protocol version this publisher negotiates
    # UP to; 0 = this build's maximum (delta.PROTO_MAX). The publisher
    # still opens at v1 and raises only on the hub's hello, so this is a
    # ceiling, not a request.
    hub_proto_max: int = 0
    host_stats: bool = True
    cgroup_root: str = "/sys/fs/cgroup"  # cgroup v2 mount for per-pod stats
    mock_devices: int = 4
    log_level: str = "info"
    log_format: str = "text"  # text|json (json = Cloud Logging structured)

    @property
    def textfile_enabled(self) -> bool:
        return bool(self.textfile_dir)


def _env(name: str, default: str | None = None) -> str | None:
    return os.environ.get("KTS_" + name, default)


def _env_bool(name: str) -> bool:
    raw = os.environ.get("KTS_" + name, "")
    return raw.strip().lower() in ("1", "true", "yes", "on")


def parse_extra_labels(raw: str) -> tuple:
    """Parse 'name=value,name2=value2' into label pairs, rejecting names
    that collide with the schema (a duplicate label name makes every
    remote-written series invalid) — raises ValueError naming the entry."""
    from . import schema

    reserved = {"job", "instance", "le", "__name__"}
    reserved.update(schema.ALL_BASE_LABELS)
    for spec in schema.ALL_METRICS:
        reserved.update(spec.extra_labels)
    pairs = []
    for token in raw.split(","):
        token = token.strip()
        if not token:
            continue
        name, sep, value = token.partition("=")
        name = name.strip()
        value = value.strip()
        if not sep or not name:
            raise ValueError(
                f"extra label {token!r} must be name=value")
        if not value:
            # The wire encoders drop empty-valued labels (spec), so an
            # empty value would silently no-op — reject it here instead.
            raise ValueError(
                f"extra label {name!r} needs a non-empty value")
        if not re.match(r"^[a-zA-Z_][a-zA-Z0-9_]*$", name):
            raise ValueError(f"invalid extra label name {name!r}")
        if name in reserved:
            raise ValueError(
                f"extra label {name!r} collides with a schema/identity "
                f"label")
        pairs.append((name, value))
    names = [name for name, _ in pairs]
    if len(names) != len(set(names)):
        raise ValueError("duplicate extra label names")
    return tuple(pairs)



def add_fleet_lens_flags(p: argparse.ArgumentParser) -> None:
    """The fleet-lens / SLO flag surface, shared by the daemon parser
    (doctor/tools accept them) and the hub (which actually scores
    them): one definition so the spellings, KTS_* env vars and
    defaults can never drift between the two CLIs."""
    from .fleetlens import (DEFAULT_FRESHNESS_TARGET,
                            DEFAULT_STRAGGLER_RATIO,
                            DEFAULT_STRAGGLER_TARGET)

    p.add_argument("--no-fleet-lens", action="store_true",
                   default=_env_bool("NO_FLEET_LENS"),
                   help="disable the hub's fleet lens (per-target "
                        "anomaly baselines, slow-node attribution, SLO "
                        "burn windows; /debug/fleet and the kts_fleet_* "
                        "gauges go with it)")
    p.add_argument("--slo-freshness-target", type=float,
                   default=float(_env("SLO_FRESHNESS_TARGET",
                                      str(DEFAULT_FRESHNESS_TARGET))),
                   help="freshness SLO objective: fraction of observed "
                        "card-refreshes that must serve fresh data (a "
                        "stale card or an unreachable target's last-known "
                        "cards count against the error budget)")
    p.add_argument("--slo-straggler-target", type=float,
                   default=float(_env("SLO_STRAGGLER_TARGET",
                                      str(DEFAULT_STRAGGLER_TARGET))),
                   help="straggler SLO objective: fraction of "
                        "rate-bearing refreshes whose slice straggler "
                        "ratio must meet --slo-straggler-ratio")
    p.add_argument("--slo-straggler-ratio", type=float,
                   default=float(_env("SLO_STRAGGLER_RATIO",
                                      str(DEFAULT_STRAGGLER_RATIO))),
                   help="minimum healthy slice_straggler_ratio (min/max "
                        "per-worker step rate); refreshes below it burn "
                        "the straggler error budget")


def add_delta_push_flags(p: argparse.ArgumentParser) -> None:
    """The delta-push publisher flag surface, shared by the daemon
    parser (node -> hub) and `kube-tpu-stats hub` (leaf hub -> root hub
    in a federation tree): one definition so spellings, KTS_* env vars
    and defaults can never drift between the two CLIs."""
    p.add_argument("--hub-url", default=_env("HUB_URL", ""),
                   help="base URL of an upstream hub (e.g. "
                        "http://hub:9401); when set, each published "
                        "snapshot ships as a seq-numbered changed-series "
                        "delta to <url>/ingest/delta — a quiet tick "
                        "costs bytes proportional to churn, not chip "
                        "count. Empty disables (the hub can still "
                        "pull-scrape this exporter)")
    p.add_argument("--hub-push-source",
                   default=_env("HUB_PUSH_SOURCE", ""),
                   help="identity the upstream hub lists this publisher "
                        "under (its 'target'). Use this node's own "
                        "scrape URL so the hub's automatic pull "
                        "fallback hits the right endpoint when the push "
                        "session goes stale; empty derives "
                        "http://<hostname>:<listen-port>/metrics")
    p.add_argument("--hub-push-interval", type=float,
                   default=float(_env("HUB_PUSH_INTERVAL", "1.0")),
                   help="minimum seconds between delta pushes (each "
                        "push follows a snapshot publish; backs off "
                        "under consecutive failures)")
    p.add_argument("--hub-auth-username",
                   default=_env("HUB_AUTH_USERNAME", ""),
                   help="basic-auth username sent with every delta "
                        "push to --hub-url (hubs behind "
                        "--auth-username); needs "
                        "--hub-auth-password-file")
    p.add_argument("--hub-auth-password-file",
                   default=_env("HUB_AUTH_PASSWORD_FILE", ""),
                   help="file holding the delta-push basic-auth "
                        "password (re-read per push; rotations apply "
                        "without a restart)")
    p.add_argument("--hub-ca-file", default=_env("HUB_CA_FILE", ""),
                   help="CA bundle verifying an https --hub-url's TLS "
                        "cert (hubs behind --tls-cert-file signed by a "
                        "private CA)")
    p.add_argument("--hub-insecure-tls", action="store_true",
                   default=_env_bool("HUB_INSECURE_TLS"),
                   help="skip TLS verification of an https --hub-url "
                        "(self-signed dev certs; prefer --hub-ca-file)")
    p.add_argument("--hub-spill-dir", default=_env("HUB_SPILL_DIR", ""),
                   help="directory for the delta-push spill queue: while "
                        "--hub-url is unreachable every published "
                        "snapshot spools to a bounded on-disk ring "
                        "(fsynced, crash-recoverable) and drains "
                        "oldest-first on reconnect, so a partition "
                        "yields a late-but-complete record instead of a "
                        "hole. Empty disables (offline ticks are "
                        "dropped)")
    p.add_argument("--hub-spill-max-bytes", type=int,
                   default=int(_env("HUB_SPILL_MAX_BYTES",
                                    str(64 * 1024 * 1024))),
                   help="spill queue byte bound; past it the OLDEST "
                        "frames are dropped, counted in "
                        "kts_spill_dropped_total and journaled (bounded "
                        "loss is accounted loss)")
    p.add_argument("--hub-drain-rate", type=float,
                   default=float(_env("HUB_DRAIN_RATE", "50")),
                   help="max spooled frames/second sent while draining "
                        "a backlog (token bucket) — the whole returning "
                        "fleet must never stampede a recovering hub; "
                        "429/503 + Retry-After from the hub pauses the "
                        "drain on top of this")
    p.add_argument("--hub-proto-max", type=int,
                   default=int(_env("HUB_PROTO_MAX", "0")),
                   help="highest delta wire-protocol version to "
                        "negotiate up to against --hub-url (version "
                        "skew): the publisher always OPENS "
                        "at v1 and only raises to min(this, the hub's "
                        "advertised max). 0 = this build's maximum; "
                        "pin (e.g. 1) to hold a rollout wave on the "
                        "old encoding")



def add_ingest_guard_flags(p: argparse.ArgumentParser) -> None:
    """The hub's ingest survival knobs: admission control,
    hostile-pusher quarantine, and the warm-restart checkpoint. Defined
    here (not inline in hub.main) so spellings/env vars stay in one
    place alongside the delta-push flag surface they pair with."""
    p.add_argument("--ingest-delta-rate", type=float,
                   default=float(_env("INGEST_DELTA_RATE", "0")),
                   help="max DELTA frames/second PER INGEST LANE before "
                        "the hub sheds with 429 + Retry-After (chatty "
                        "sources lose deltas first; 409-recovery FULLs "
                        "are never rate-shed). 0 = unlimited")
    p.add_argument("--ingest-max-inflight", type=int,
                   default=int(_env("INGEST_MAX_INFLIGHT", "256")),
                   help="max frames in concurrent apply before the hub "
                        "sheds (deltas at 3/4 of the budget with 429, "
                        "FULLs only at the hard cap with 503, so "
                        "session recovery always finds headroom). "
                        "0 = unlimited")
    p.add_argument("--ingest-max-sessions", type=int,
                   default=int(_env("INGEST_MAX_SESSIONS", "0")),
                   help="memory fence over the session table: a FULL "
                        "from a NEW source is refused with 503 + "
                        "Retry-After once this many sessions are live "
                        "(established sessions keep being served and "
                        "resynced). 0 = unlimited")
    p.add_argument("--ingest-quarantine-threshold", type=int,
                   default=int(_env("INGEST_QUARANTINE_THRESHOLD", "5")),
                   help="consecutive malformed frames from one "
                        "peer/source before it is quarantined (frames "
                        "answered 429 before any decode work)")
    p.add_argument("--ingest-quarantine-window", type=float,
                   default=float(_env("INGEST_QUARANTINE_WINDOW", "60")),
                   help="seconds a quarantined peer/source stays "
                        "refused before one probe frame is admitted")
    p.add_argument("--ingest-checkpoint", default=_env(
                       "INGEST_CHECKPOINT", ""),
                   help="path for the warm-restart session checkpoint "
                        "(.wal + fsync + atomic rename, written off "
                        "the handler path): a restarted hub replays "
                        "it and resumes delta chains instead of "
                        "409ing the fleet into a FULL-resync "
                        "stampede. Empty disables (cold restarts)")
    p.add_argument("--ingest-checkpoint-interval", type=float,
                   default=float(_env("INGEST_CHECKPOINT_INTERVAL", "10")),
                   help="minimum seconds between checkpoint writes "
                        "(the crash-tail bound: sessions whose deltas "
                        "landed after the last write pay one FULL "
                        "resync on restart)")
    p.add_argument("--ingest-proto-min", type=int,
                   default=int(_env("INGEST_PROTO_MIN", "0")),
                   help="lowest delta wire-protocol version this hub "
                        "accepts (version skew): frames "
                        "below it draw a 426 refusal + this hub's "
                        "advertised range, counted in "
                        "kts_skew_refused_total and named by doctor "
                        "--skew. Raise it AFTER kts_fleet_version_count "
                        "shows the old version at 0 (census-gated "
                        "rollout); 0 = everything this build decodes")
    p.add_argument("--ingest-proto-max", type=int,
                   default=int(_env("INGEST_PROTO_MAX", "0")),
                   help="highest delta wire-protocol version this hub "
                        "accepts; 0 = this build's maximum. Mostly a "
                        "test/sim knob (play an old hub); production "
                        "rollouts leave it 0")


def add_cardinality_flags(p: argparse.ArgumentParser) -> None:
    """The hub's cardinality & memory admission knobs: the
    series ledger's budgets, hard cap and eviction watermarks. All 0 by
    default = accounting only (kts_series_live/kts_source_series still
    export), no admission — the same off-by-default contract as the
    ingest guards."""
    p.add_argument("--series-budget-per-source", type=int,
                   default=int(_env("SERIES_BUDGET_PER_SOURCE", "0")),
                   help="max series one source (push session or pull "
                        "target) may install: a FULL over it lands "
                        "clamped to the admitted prefix — existing "
                        "series keep updating, only the NEW series are "
                        "dropped and counted "
                        "(kts_cardinality_shed_total{reason="
                        "\"source_budget\"}). Size from the honest "
                        "fleet's max(kts_source_series). 0 = unlimited")
    p.add_argument("--series-hard-cap", type=int,
                   default=int(_env("SERIES_HARD_CAP", "0")),
                   help="global live-series hard cap across every "
                        "source: frames that would grow a full ledger "
                        "draw a 413-style shed the publisher defers on "
                        "like a 429 (no FULL promotion, no resync "
                        "storm). The hub's last line against OOM; "
                        "0 = unlimited")
    p.add_argument("--series-high-watermark", type=int,
                   default=int(_env("SERIES_HIGH_WATERMARK", "0")),
                   help="live-series level above which the accountant "
                        "LRU-evicts IDLE sources (no update for "
                        "--series-idle-refreshes refreshes) through the "
                        "hub's churn path, counted as "
                        "kts_cardinality_evicted_total{reason=\"idle\"}. "
                        "Set below --series-hard-cap so idle state "
                        "yields before live traffic sheds. 0 = never "
                        "evict")
    p.add_argument("--series-low-watermark", type=int,
                   default=int(_env("SERIES_LOW_WATERMARK", "0")),
                   help="eviction target: once above the high "
                        "watermark, idle sources are evicted until the "
                        "ledger is back under this (hysteresis — "
                        "without it the ledger oscillates across the "
                        "watermark every refresh). 0 = 90%% of the "
                        "high watermark")
    p.add_argument("--series-idle-refreshes", type=int,
                   default=int(_env("SERIES_IDLE_REFRESHES", "5")),
                   help="refreshes without an update before a source "
                        "counts as idle and becomes evictable above "
                        "the high watermark (a source still pushing or "
                        "being pulled is never evicted for pressure)")


def add_hub_noop_flags(p: argparse.ArgumentParser) -> None:
    """The reference hub's switch that only turns OFF a part the port's
    hub does not run: accepted, so a manifest written for either hub
    parses, and it changes nothing here."""
    p.add_argument("--no-native-ingest", action="store_true",
                   help="accepted for the reference hub's manifests: the "
                        "port always applies delta frames on the Python "
                        "per-slot path")


def add_history_flags(p: argparse.ArgumentParser) -> None:
    """The hub's history ring and ``/query``: on by default, its memory
    fixed (about 16 KB of slab per series over the 1h/24h/7d tiers)."""
    p.add_argument("--no-history", action="store_true",
                   default=_env("NO_HISTORY", "") == "1",
                   help="keep no history ring: /query answers "
                        "enabled:false and the hub holds no ring memory")
    p.add_argument("--history-series-max", type=int,
                   default=int(_env("HISTORY_SERIES_MAX", "1024")),
                   help="series identities (rollup family + labels) the "
                        "ring holds slabs for; the memory bound is this "
                        "times the per-series slab. Past it a new "
                        "identity takes a stale slab "
                        "(kts_history_series_evicted_total) or is "
                        "dropped (kts_history_series_shed_total); the "
                        "live exposition is never affected")
    p.add_argument("--history-query-qps", type=float,
                   default=float(_env("HISTORY_QUERY_QPS", "50")),
                   help="per-client /query rate in tokens per second; "
                        "over it a request draws 429 + Retry-After "
                        "(kts_query_shed_total). 0 = unlimited")
    p.add_argument("--history-query-burst", type=float,
                   default=float(_env("HISTORY_QUERY_BURST", "100")),
                   help="per-client /query bucket depth: how many "
                        "requests a dashboard may send at once before "
                        "the rate applies")


def validate_history_args(args) -> str | None:
    """Range rules for the history flags; the hub parser surfaces the
    string through parser.error."""
    if args.history_series_max < 1:
        return "--history-series-max must be >= 1"
    if args.history_query_qps < 0:
        return "--history-query-qps must be >= 0 (0 = unlimited)"
    if args.history_query_burst < 1:
        return "--history-query-burst must be >= 1"
    return None


def add_efficiency_flags(p: argparse.ArgumentParser) -> None:
    """The hub's fleet-efficiency scoring knobs: waste
    verdicts (idle-reservation / low-goodput), the top-K ranking bound,
    and the /debug/efficiency attestation switch. Defaults live in
    efficiency.py so the flag surface and the engine cannot drift."""
    from .efficiency import (DEFAULT_IDLE_DUTY, DEFAULT_IDLE_REFRESHES,
                             DEFAULT_TOP_K, DEFAULT_WARMUP_REFRESHES)

    p.add_argument("--no-efficiency", action="store_true",
                   default=_env("NO_EFFICIENCY", "") == "1",
                   help="disable fleet efficiency scoring: no "
                        "kts_fleet_efficiency_*/kts_fleet_waste_* "
                        "families, no waste journal events, and "
                        "/debug/efficiency answers enabled:false")
    p.add_argument("--waste-warmup-refreshes", type=int,
                   default=int(_env("WASTE_WARMUP_REFRESHES",
                                    str(DEFAULT_WARMUP_REFRESHES))),
                   help="refreshes a pod must be observed before any "
                        "waste verdict may form — the grace a "
                        "legitimately-starting pod (model loading, "
                        "compilation) gets before idle cards count "
                        "against it")
    p.add_argument("--waste-idle-refreshes", type=int,
                   default=int(_env("WASTE_IDLE_REFRESHES",
                                    str(DEFAULT_IDLE_REFRESHES))),
                   help="consecutive refreshes the idle-reservation / "
                        "low-goodput shape must hold before the verdict "
                        "raises (and journals fleet_waste)")
    p.add_argument("--waste-idle-duty", type=float,
                   default=float(_env("WASTE_IDLE_DUTY",
                                      str(DEFAULT_IDLE_DUTY))),
                   help="duty-cycle points at or below which a "
                        "card-holding pod counts as idle")
    p.add_argument("--waste-top-k", type=int,
                   default=int(_env("WASTE_TOP_K", str(DEFAULT_TOP_K))),
                   help="per-pod efficiency/waste series exported on "
                        "/metrics are bounded to the K worst offenders "
                        "(the full ledger rides /debug/fleet)")


def validate_efficiency_args(args) -> str | None:
    """Range rules for the efficiency flags; the hub parser surfaces
    the string through parser.error."""
    if args.waste_warmup_refreshes < 1:
        return "--waste-warmup-refreshes must be >= 1"
    if args.waste_idle_refreshes < 1:
        return "--waste-idle-refreshes must be >= 1"
    if args.waste_idle_duty < 0 or args.waste_idle_duty > 100:
        return "--waste-idle-duty must be 0..100 duty points"
    if args.waste_top_k < 1:
        return "--waste-top-k must be >= 1"
    return None


def validate_cardinality_args(args) -> str | None:
    """Range rules for the cardinality admission flags; the hub parser
    surfaces the string through parser.error."""
    for name in ("series_budget_per_source", "series_hard_cap",
                 "series_high_watermark", "series_low_watermark"):
        if getattr(args, name) < 0:
            return (f"--{name.replace('_', '-')} must be >= 0 "
                    f"(0 disables)")
    if args.series_idle_refreshes < 1:
        return "--series-idle-refreshes must be >= 1"
    if (args.series_high_watermark and args.series_hard_cap
            and args.series_high_watermark > args.series_hard_cap):
        return "--series-high-watermark must be <= --series-hard-cap"
    if (args.series_low_watermark and args.series_high_watermark
            and args.series_low_watermark > args.series_high_watermark):
        return "--series-low-watermark must be <= --series-high-watermark"
    if args.series_low_watermark and not args.series_high_watermark:
        return ("--series-low-watermark needs --series-high-watermark "
                "(eviction is watermark-driven)")
    return None


def validate_ingest_guard_args(args) -> str | None:
    """Range rules for the ingest survival flags; the hub parser
    surfaces the string through parser.error."""
    if args.ingest_delta_rate < 0:
        return "--ingest-delta-rate must be >= 0 (0 disables)"
    if args.ingest_max_inflight < 0:
        return "--ingest-max-inflight must be >= 0 (0 disables)"
    if args.ingest_max_sessions < 0:
        return "--ingest-max-sessions must be >= 0 (0 disables)"
    if args.ingest_quarantine_threshold < 1:
        return "--ingest-quarantine-threshold must be >= 1"
    if args.ingest_quarantine_window <= 0:
        return "--ingest-quarantine-window must be > 0 seconds"
    if args.ingest_checkpoint_interval <= 0:
        return "--ingest-checkpoint-interval must be > 0 seconds"
    if args.ingest_proto_min < 0 or args.ingest_proto_max < 0:
        return ("--ingest-proto-min/--ingest-proto-max must be >= 0 "
                "(0 = this build's bound)")
    if (args.ingest_proto_min and args.ingest_proto_max
            and args.ingest_proto_min > args.ingest_proto_max):
        return "--ingest-proto-min must be <= --ingest-proto-max"
    return None


def validate_delta_push_args(args) -> str | None:
    """Conflict rules for the shared delta-push transport flags; both
    CLIs surface the string through their own parser.error."""
    if bool(args.hub_auth_username) != bool(args.hub_auth_password_file):
        return ("--hub-auth-username and --hub-auth-password-file must "
                "be set together")
    if args.hub_ca_file and args.hub_insecure_tls:
        return "--hub-ca-file and --hub-insecure-tls are mutually exclusive"
    if args.hub_push_interval <= 0:
        return "--hub-push-interval must be > 0 seconds"
    if args.hub_spill_max_bytes < 1 << 16:
        return ("--hub-spill-max-bytes must be >= 65536 (a bound smaller "
                "than one frame spools nothing)")
    if args.hub_drain_rate <= 0:
        return "--hub-drain-rate must be > 0 frames/second"
    if args.hub_proto_max < 0:
        return "--hub-proto-max must be >= 0 (0 = this build's maximum)"
    return None



def validate_fleet_lens_args(args) -> str | None:
    """Range-check the shared SLO flags; returns an error string or
    None (both CLIs surface it through their own parser.error)."""
    for name in ("slo_freshness_target", "slo_straggler_target"):
        value = getattr(args, name)
        if not 0.0 < value < 1.0:
            return (f"--{name.replace('_', '-')} must be in (0, 1) "
                    f"(got {value!r})")
    if not 0.0 < args.slo_straggler_ratio <= 1.0:
        return (f"--slo-straggler-ratio must be in (0, 1] "
                f"(got {args.slo_straggler_ratio!r})")
    return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kube_gpu_stats_tpu_torch",
        description="accelerator telemetry exporter for Kubernetes H100 nodes",
    )
    from . import __version__

    p.add_argument("--version", action="version",
                   version=f"kube-tpu-stats {__version__}")
    p.add_argument("--backend", choices=BACKENDS,
                   default=_env("BACKEND", "auto"),
                   help="device backend; auto probes nvml, then falls back "
                        "to null (and re-probes while on null)")
    p.add_argument("--interval", type=float,
                   default=float(_env("INTERVAL", "1.0")),
                   help="poll interval seconds (default 1.0 = 1 Hz)")
    p.add_argument("--deadline", type=float,
                   default=float(_env("DEADLINE", "0.050")),
                   help="per-tick sampling deadline seconds")
    p.add_argument("--listen-host", default=_env("LISTEN_HOST", "0.0.0.0"))
    p.add_argument("--listen-port", type=int,
                   default=int(_env("LISTEN_PORT", "9400")))
    p.add_argument("--textfile-dir", default=_env("TEXTFILE_DIR", ""),
                   help="node_exporter textfile dir; empty disables")
    p.add_argument("--pushgateway-url", default=_env("PUSHGATEWAY_URL", ""),
                   help="Prometheus Pushgateway base URL; empty disables")
    p.add_argument("--pushgateway-job",
                   default=_env("PUSHGATEWAY_JOB", "kube-tpu-stats"))
    p.add_argument("--remote-write-url",
                   default=_env("REMOTE_WRITE_URL", ""),
                   help="Prometheus remote_write receiver endpoint "
                        "(Mimir/Thanos/GMP); empty disables; see "
                        "--remote-write-protocol")
    p.add_argument("--remote-write-job",
                   default=_env("REMOTE_WRITE_JOB", "kube-tpu-stats"),
                   help="job label stamped on every remote-written series")
    p.add_argument("--remote-write-interval", type=float,
                   default=float(_env("REMOTE_WRITE_INTERVAL", "15.0")),
                   help="minimum seconds between remote-write pushes")
    p.add_argument("--remote-write-bearer-token-file",
                   default=_env("REMOTE_WRITE_BEARER_TOKEN_FILE", ""),
                   help="file with a bearer token for the receiver "
                        "(re-read per push; rotating tokens work)")
    p.add_argument("--remote-write-extra-labels",
                   default=_env("REMOTE_WRITE_EXTRA_LABELS", ""),
                   help="comma-separated name=value labels stamped on "
                        "every remote-written series (the Prometheus "
                        "external_labels analog for a push path that "
                        "has no Prometheus to attach cluster/region "
                        "identity, e.g. 'cluster=prod,region=us-east1')")
    p.add_argument("--remote-write-protocol", choices=("1.0", "2.0"),
                   default=_env("REMOTE_WRITE_PROTOCOL", "1.0"),
                   help="remote-write wire protocol; 2.0 interns label "
                        "strings and sends typed metadata, and falls "
                        "back to 1.0 if the receiver answers 415")
    p.add_argument("--remote-write-wal-dir",
                   default=_env("REMOTE_WRITE_WAL_DIR", ""),
                   help="directory for the durable exporter's per-shard "
                        "write-ahead segment rings: snapshots are "
                        "journaled to disk BEFORE sending and drained "
                        "oldest-first with retry classification "
                        "(5xx/timeout retried, poison 4xx parked, "
                        "Retry-After honored), so a receiver outage is "
                        "late delivery, not a hole in the TSDB. Empty = "
                        "legacy best-effort (failures drop the snapshot)")
    p.add_argument("--remote-write-shards", type=int,
                   default=int(_env("REMOTE_WRITE_SHARDS", "1")),
                   help="send shards for the durable exporter (series "
                        "hash to a shard by identity; each shard has "
                        "its own WAL ring, backoff and parked ring). "
                        "Needs --remote-write-wal-dir when > 1")
    p.add_argument("--remote-write-wal-max-bytes", type=int,
                   default=int(_env("REMOTE_WRITE_WAL_MAX_BYTES",
                                    str(64 * 1024 * 1024))),
                   help="per-shard WAL byte bound; past it the OLDEST "
                        "segment is evicted whole, counted in "
                        "kts_remote_write_dropped_total and journaled")
    p.add_argument("--remote-write-drain-max", type=int,
                   default=int(_env("REMOTE_WRITE_DRAIN_MAX", "64")),
                   help="max backlogged requests one shard sends per "
                        "push cycle while catching up after an outage "
                        "(bounds the catch-up burst a recovering "
                        "receiver absorbs)")
    p.add_argument("--sysfs-root", default=_env("SYSFS_ROOT", "/sys"))
    p.add_argument("--proc-root", default=_env("PROC_ROOT", "/proc"))
    p.add_argument("--device-processes", choices=("on", "off"),
                   default=_env("DEVICE_PROCESSES", "on"),
                   help="export accelerator_process_open (which processes "
                        "hold each device node; procfs scan on the "
                        "attribution cadence). In Kubernetes the pod needs "
                        "hostPID to see beyond its own namespace")
    p.add_argument("--max-process-series", type=int,
                   default=int(_env("MAX_PROCESS_SERIES", "32")),
                   help="max accelerator_process_open holders exported per "
                        "device; the excess is folded into one "
                        '{comm="_overflow"} series carrying the folded '
                        "count")
    p.add_argument("--attribution",
                   choices=("auto", "podresources", "checkpoint", "off"),
                   default=_env("ATTRIBUTION", "auto"))
    p.add_argument("--kubelet-socket",
                   default=_env("KUBELET_SOCKET", DEFAULT_KUBELET_SOCKET))
    p.add_argument("--checkpoint-path",
                   default=_env("CHECKPOINT_PATH", DEFAULT_CHECKPOINT))
    p.add_argument("--attribution-interval", type=float,
                   default=float(_env("ATTRIBUTION_INTERVAL", "10.0")))
    p.add_argument("--rediscovery-interval", type=float,
                   default=float(_env("REDISCOVERY_INTERVAL", "60.0")),
                   help="device re-enumeration cadence seconds; 0 disables")
    p.add_argument("--no-pipeline-fetch", action="store_true",
                   default=_env_bool("NO_PIPELINE_FETCH"),
                   help="join each tick's own NVML read round instead of "
                        "serving the last completed one (pipelined mode "
                        "keeps a stalled read out of the tick latency "
                        "budget; values then lag the tick by up to the "
                        "freshness fence, 2x the poll interval)")
    p.add_argument("--no-trace", action="store_true",
                   default=_env_bool("NO_TRACE"),
                   help="disable the flight recorder (per-tick span "
                        "traces behind kts_tick_phase_seconds and "
                        "kts_slowest_tick_seconds)")
    p.add_argument("--drop-labels", default=_env("DROP_LABELS", ""),
                   help="comma-separated label keys to blank out (emitted as "
                        "empty strings for cardinality control, e.g. "
                        "'pod,namespace,container'); the label SET stays "
                        "stable so series identity never churns")
    p.add_argument("--label-value-cap", type=int,
                   default=int(_env("LABEL_VALUE_CAP", "0")),
                   help="cardinality fence at the plan compiler: max "
                        "distinct values per attribution label key "
                        "(pod/namespace/container); once a key reaches "
                        "the cap, NEW values degrade to the \"overflow\" "
                        "aggregate; fence hits count as "
                        "kts_cardinality_fenced_total. 0 = unfenced")
    p.add_argument("--metrics-include", default=_env("METRICS_INCLUDE", ""),
                   help="comma-separated allowlist of device metric "
                        "families to export (exact names or globs); "
                        "empty = all. accelerator_up and the collector's "
                        "own self metrics always export")
    p.add_argument("--metrics-exclude", default=_env("METRICS_EXCLUDE", ""),
                   help="comma-separated denylist of device metric "
                        "families (names or globs), applied after "
                        "--metrics-include; a typo fails at startup")
    p.add_argument("--mock-devices", type=int,
                   default=int(_env("MOCK_DEVICES", "4")))
    p.add_argument("--log-level", default=_env("LOG_LEVEL", "info"))
    p.add_argument("--log-format", choices=("text", "json"),
                   default=_env("LOG_FORMAT", "text"),
                   help="log record format; json emits one Cloud-Logging-"
                        "style object per line")
    p.add_argument("--tls-cert-file", default=_env("TLS_CERT_FILE", ""),
                   help="PEM certificate; with --tls-key-file serves HTTPS")
    p.add_argument("--tls-key-file", default=_env("TLS_KEY_FILE", ""))
    p.add_argument("--tls-client-ca-file",
                   default=_env("TLS_CLIENT_CA_FILE", ""),
                   help="CA bundle; set = require and verify a client "
                        "certificate on every connection (mTLS). Needs "
                        "--tls-cert-file/--tls-key-file")
    p.add_argument("--max-concurrent-scrapes", type=int,
                   default=int(_env("MAX_CONCURRENT_SCRAPES", "16")),
                   help="parallel /metrics renders before answering 503 "
                        "(scrape-storm guard; probes exempt; 0 disables)")
    p.add_argument("--auth-username", default=_env("AUTH_USERNAME", ""),
                   help="basic-auth user for all endpoints except "
                        "/healthz and /readyz (kubelet probes)")
    p.add_argument("--auth-password-sha256",
                   default=_env("AUTH_PASSWORD_SHA256", ""),
                   help="hex sha256 of the basic-auth password (never the "
                        "plaintext)")
    add_fleet_lens_flags(p)
    add_delta_push_flags(p)
    p.add_argument("--burst-mode", choices=("off", "auto", "continuous"),
                   default=_env("BURST_MODE", "auto"),
                   help="sub-tick power burst sampler (burstsampler.py): "
                        "'auto' arms on demand (/debug/burst?arm=N) or "
                        "on power/duty anomaly events and disarms after "
                        "--burst-hold; 'continuous' samples always; "
                        "'off' disables the thread and the "
                        "kts_power_burst_* families")
    p.add_argument("--burst-hz", type=float,
                   default=float(_env("BURST_HZ", "100.0")),
                   help="burst sampling rate while armed (Hz); the "
                        "achieved rate exports as "
                        "rate(kts_power_burst_samples_total)")
    p.add_argument("--burst-hold", type=float,
                   default=float(_env("BURST_HOLD", "30.0")),
                   help="seconds a demand/anomaly arm keeps the burst "
                        "sampler running")
    p.add_argument("--burst-ring", type=int,
                   default=int(_env("BURST_RING", "4096")),
                   help="burst samples buffered per device between poll "
                        "ticks (oldest dropped at the cap)")
    p.add_argument("--energy-checkpoint",
                   default=_env("ENERGY_CHECKPOINT", ""),
                   help="path persisting the per-pod joules accumulator "
                        "(write-ahead + atomic rename) so "
                        "kts_energy_pod_joules_total is monotone across "
                        "daemon restarts; empty = in-memory only")
    p.add_argument("--energy-checkpoint-interval", type=float,
                   default=float(_env("ENERGY_CHECKPOINT_INTERVAL", "10.0")),
                   help="minimum seconds between energy checkpoint "
                        "writes (a final write always lands on clean "
                        "shutdown)")
    p.add_argument("--energy-audit-key",
                   default=_env("ENERGY_AUDIT_KEY", ""),
                   help="HMAC-SHA256 key signing the /debug/energy "
                        "governance digest; the same key verifies it "
                        "via `doctor --energy`. Empty serves the digest "
                        "unsigned. Prefer the KTS_ENERGY_AUDIT_KEY env "
                        "var (a flag value is visible in `ps`)")
    p.add_argument("--no-host-stats", action="store_true",
                   default=_env_bool("NO_HOST_STATS"),
                   help="disable the host-signals collector (PSI "
                        "pressure, IRQ/softirq rates, NIC errors, "
                        "thermal throttle, per-pod cgroup stats — the "
                        "kts_host_* families and /debug/host; read once "
                        "per tick off the hot path). The endpoint stays "
                        "up and reports enabled:false")
    p.add_argument("--cgroup-root", default=_env("CGROUP_ROOT",
                                                 "/sys/fs/cgroup"),
                   help="cgroup v2 mount the host-signals collector "
                        "scans for kubelet pod cgroups (kts_host_pod_* "
                        "families); v1-only hosts degrade to no pod "
                        "families")
    p.add_argument("--config", default=_env("CONFIG", ""),
                   help="YAML config file (keys = long flag names); "
                        "precedence: flags > KTS_* env > file > defaults")
    return p


def _apply_config_file(parser: argparse.ArgumentParser, path: str) -> None:
    """Layer a YAML config file under env/flags: file values become parser
    defaults for keys whose KTS_ env var is unset (env already seeded the
    defaults, so skipping env-set keys preserves env > file)."""
    import yaml

    try:
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
    except OSError as exc:
        parser.error(f"--config: {exc}")
    if not isinstance(doc, dict):
        parser.error(f"--config: {path} must contain a YAML mapping")
    actions = {
        action.dest: action for action in parser._actions
        if action.dest not in ("help", "config", "version")
    }
    defaults = {}
    for key, value in doc.items():
        dest = str(key).replace("-", "_")
        action = actions.get(dest)
        if action is None:
            parser.error(
                f"--config: unknown key {key!r} (valid: {sorted(actions)})"
            )
        if "KTS_" + dest.upper() in os.environ:
            continue  # env beats file
        if isinstance(value, list):  # drop_labels as a list
            value = ",".join(str(v) for v in value)
        if (isinstance(value, bool) and action.choices is not None
                and ("on" in action.choices or "off" in action.choices)):
            # YAML 1.1 parses a bare `on`/`off` as a boolean before we ever
            # see it; map it back so the documented spelling works unquoted.
            value = "on" if value else "off"
        if not isinstance(value, (str, int, float, bool)):
            parser.error(f"--config: key {key!r} must be a scalar or list")
        # Defaults bypass argparse validation, so apply the action's type
        # conversion and choices check here — a typo in the file must fail
        # as fast as the same typo on the command line.
        if isinstance(action.const, bool):  # store_true-style flag
            if not isinstance(value, bool):
                parser.error(f"--config: key {key!r} must be true/false")
        else:
            try:
                value = action.type(str(value)) if action.type else str(value)
            except (TypeError, ValueError):
                parser.error(f"--config: invalid value for {key!r}: {value!r}")
            if action.choices is not None and value not in action.choices:
                parser.error(
                    f"--config: {key!r} must be one of {list(action.choices)}"
                )
        defaults[dest] = value
    parser.set_defaults(**defaults)


def _split(raw: str) -> tuple[str, ...]:
    return tuple(key.strip() for key in raw.split(",") if key.strip())


def from_args(argv: Sequence[str] | None = None) -> Config:
    parser = build_parser()
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        _apply_config_file(parser, pre.config)
    args = parser.parse_args(argv)
    drop_labels = _split(args.drop_labels)
    # Blanking the series-identity labels would collapse every card into
    # duplicate series — invalid exposition. uuid/accel_type/attribution/
    # topology are safe to blank (chip still disambiguates).
    identity = {"chip", "device_path"} & set(drop_labels)
    if identity:
        parser.error(
            f"--drop-labels may not include device-identity labels "
            f"{sorted(identity)}"
        )
    metrics_include = _split(args.metrics_include)
    metrics_exclude = _split(args.metrics_exclude)
    try:
        from . import schema

        disabled_metrics = schema.resolve_metric_filter(
            metrics_include, metrics_exclude)
    except ValueError as exc:
        parser.error(str(exc))
    try:
        remote_write_extra_labels = parse_extra_labels(
            args.remote_write_extra_labels)
    except ValueError as exc:
        parser.error(f"--remote-write-extra-labels: {exc}")
    if args.backend not in BACKENDS:
        # argparse `choices` only validates CLI-supplied values; a bad
        # KTS_BACKEND env default must fail as a usage error too.
        parser.error(f"--backend must be one of {list(BACKENDS)} "
                     f"(got {args.backend!r})")
    if args.max_process_series < 1:
        parser.error("--max-process-series must be >= 1")
    if args.label_value_cap < 0:
        parser.error("--label-value-cap must be >= 0 (0 = unfenced)")
    if args.burst_mode not in ("off", "auto", "continuous"):
        # Env defaults bypass argparse choices.
        parser.error(f"--burst-mode must be off, auto or continuous "
                     f"(got {args.burst_mode!r})")
    if args.burst_hz <= 0:
        parser.error("--burst-hz must be > 0")
    if args.burst_hold <= 0:
        parser.error("--burst-hold must be > 0 seconds")
    if args.burst_ring < 16:
        parser.error("--burst-ring must be >= 16 samples")
    if args.energy_checkpoint_interval <= 0:
        parser.error("--energy-checkpoint-interval must be > 0 seconds")
    if args.interval <= 0:
        parser.error("--interval must be > 0 seconds")
    if args.deadline <= 0:
        parser.error("--deadline must be > 0 seconds")
    if args.max_concurrent_scrapes < 0:
        parser.error("--max-concurrent-scrapes must be >= 0 (0 disables)")
    if args.remote_write_interval <= 0:
        parser.error("--remote-write-interval must be > 0 seconds")
    if not 1 <= args.remote_write_shards <= 64:
        parser.error("--remote-write-shards must be 1..64")
    if args.remote_write_shards > 1 and not args.remote_write_wal_dir:
        parser.error("--remote-write-shards > 1 needs "
                     "--remote-write-wal-dir (sharding exists for the "
                     "durable exporter)")
    if args.remote_write_wal_max_bytes < 1 << 16:
        parser.error("--remote-write-wal-max-bytes must be >= 65536")
    if args.remote_write_drain_max < 1:
        parser.error("--remote-write-drain-max must be >= 1")
    if args.remote_write_protocol not in ("1.0", "2.0"):
        # argparse `choices` only validates CLI-supplied values; a bad
        # KTS_REMOTE_WRITE_PROTOCOL env default would otherwise crash the
        # daemon later with a traceback instead of a usage error.
        parser.error(
            f"--remote-write-protocol must be 1.0 or 2.0 "
            f"(got {args.remote_write_protocol!r})")
    fleet_error = validate_fleet_lens_args(args)
    if fleet_error:
        parser.error(fleet_error)
    push_error = validate_delta_push_args(args)
    if push_error:
        parser.error(push_error)
    if bool(args.tls_cert_file) != bool(args.tls_key_file):
        parser.error("--tls-cert-file and --tls-key-file must be set together")
    if args.tls_client_ca_file and not args.tls_cert_file:
        parser.error("--tls-client-ca-file requires --tls-cert-file/"
                     "--tls-key-file")
    if bool(args.auth_username) != bool(args.auth_password_sha256):
        parser.error("--auth-username and --auth-password-sha256 must be "
                     "set together")
    if args.auth_password_sha256 and not (
        len(args.auth_password_sha256) == 64
        and all(c in "0123456789abcdefABCDEF"
                for c in args.auth_password_sha256)
    ):
        parser.error("--auth-password-sha256 must be a 64-char hex digest "
                     "(e.g. from `sha256sum`)")
    return Config(
        backend=args.backend,
        interval=args.interval,
        deadline=args.deadline,
        listen_host=args.listen_host,
        listen_port=args.listen_port,
        tls_cert_file=args.tls_cert_file,
        tls_key_file=args.tls_key_file,
        tls_client_ca_file=args.tls_client_ca_file,
        auth_username=args.auth_username,
        auth_password_sha256=args.auth_password_sha256,
        max_concurrent_scrapes=args.max_concurrent_scrapes,
        fleet_lens=not args.no_fleet_lens,
        slo_freshness_target=args.slo_freshness_target,
        slo_straggler_target=args.slo_straggler_target,
        slo_straggler_ratio=args.slo_straggler_ratio,
        textfile_dir=args.textfile_dir,
        pushgateway_url=args.pushgateway_url,
        pushgateway_job=args.pushgateway_job,
        remote_write_url=args.remote_write_url,
        remote_write_job=args.remote_write_job,
        remote_write_interval=args.remote_write_interval,
        remote_write_bearer_token_file=args.remote_write_bearer_token_file,
        remote_write_protocol=args.remote_write_protocol,
        remote_write_extra_labels=remote_write_extra_labels,
        remote_write_shards=args.remote_write_shards,
        remote_write_wal_dir=args.remote_write_wal_dir,
        remote_write_wal_max_bytes=args.remote_write_wal_max_bytes,
        remote_write_drain_max=args.remote_write_drain_max,
        sysfs_root=args.sysfs_root,
        proc_root=args.proc_root,
        device_processes=args.device_processes,
        max_process_series=args.max_process_series,
        attribution=args.attribution,
        kubelet_socket=args.kubelet_socket,
        checkpoint_path=args.checkpoint_path,
        attribution_interval=args.attribution_interval,
        rediscovery_interval=args.rediscovery_interval,
        pipeline_fetch=not args.no_pipeline_fetch,
        trace_enabled=not args.no_trace,
        drop_labels=drop_labels,
        label_value_cap=args.label_value_cap,
        metrics_include=metrics_include,
        metrics_exclude=metrics_exclude,
        disabled_metrics=disabled_metrics,
        burst_mode=args.burst_mode,
        burst_hz=args.burst_hz,
        burst_hold=args.burst_hold,
        burst_ring=args.burst_ring,
        energy_checkpoint=args.energy_checkpoint,
        energy_checkpoint_interval=args.energy_checkpoint_interval,
        energy_audit_key=args.energy_audit_key,
        hub_url=args.hub_url,
        hub_push_source=args.hub_push_source,
        hub_push_interval=args.hub_push_interval,
        hub_auth_username=args.hub_auth_username,
        hub_auth_password_file=args.hub_auth_password_file,
        hub_ca_file=args.hub_ca_file,
        hub_insecure_tls=args.hub_insecure_tls,
        hub_spill_dir=args.hub_spill_dir,
        hub_spill_max_bytes=args.hub_spill_max_bytes,
        hub_drain_rate=args.hub_drain_rate,
        hub_proto_max=args.hub_proto_max,
        host_stats=not args.no_host_stats,
        cgroup_root=args.cgroup_root,
        mock_devices=args.mock_devices,
        log_level=args.log_level,
        log_format=args.log_format,
    )
