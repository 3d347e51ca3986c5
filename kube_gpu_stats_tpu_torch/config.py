"""Configuration of the daemon: CLI flags + environment.

The port's copy of the reference's ``Config``, ``build_parser`` and
``from_args``, cut to the flags this package wires. Each flag keeps the
reference's name, default and ``KTS_*`` environment variable, so the
DaemonSet manifest configures the container without args churn; a
reference flag that is not wired here is rejected by argparse, not
accepted and ignored. ``nvml`` takes the place of the reference's ``tpu``
backend; the reference's ``gpu`` (drm sysfs) backend is not offered on an
NVIDIA node.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Sequence

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
    textfile_dir: str = ""  # empty = textfile output disabled
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
    p.add_argument("--auth-username", default=_env("AUTH_USERNAME", ""),
                   help="basic-auth user for all endpoints except "
                        "/healthz and /readyz (kubelet probes)")
    p.add_argument("--auth-password-sha256",
                   default=_env("AUTH_PASSWORD_SHA256", ""),
                   help="hex sha256 of the basic-auth password (never the "
                        "plaintext)")
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
        textfile_dir=args.textfile_dir,
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
        host_stats=not args.no_host_stats,
        cgroup_root=args.cgroup_root,
        mock_devices=args.mock_devices,
        log_level=args.log_level,
        log_format=args.log_format,
    )
