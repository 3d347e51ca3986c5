"""How the H100 exporter's operator assets differ from the reference's.

The alert rules (``alerts.yaml``), recording rules
(``recording_rules.yaml``) and Grafana board (``grafana/dashboard.json``)
here carry over every alert, rule and panel of the reference project's
``deploy/`` that an NVML node or the port's hub can serve, under the same
names, severities and ``for:`` windows. Three tables say the rest:

- :data:`NOT_ON_H100`: each reference alert the port cannot fire, and
  why (read off the port's collectors and schema);
- :data:`FAMILIES_NOT_ON_H100`: families of the shared schema that no
  H100 node or hub ever fills with a reading; the reference's recording
  rules and panels on them are left out;
- :data:`CONDITIONAL`: families the assets name that a node or hub
  serves only under a condition (a flag, an event, an embedded exporter
  in the workload), with what brings each.

:func:`named_families` lists the families the assets' expressions name;
``chip_smoke.py``'s ``operator`` phase holds each to a live scrape of the
daemon and the hub on the card, or to :data:`CONDITIONAL`. No torch here.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from .. import schema

DEPLOY = Path(__file__).resolve().parent
ALERTS = DEPLOY / "alerts.yaml"
RECORDING_RULES = DEPLOY / "recording_rules.yaml"
DASHBOARD = DEPLOY / "grafana" / "dashboard.json"

NOT_ON_H100: dict[str, str] = {
    "AcceleratorRuntimeRestarted":
        "accelerator_runtime_restarts_total counts a card's uptime moving "
        "backwards between two polls, and NVML has no uptime reading "
        "(collectors/nvml.py serves none); the counter is served born at 0 "
        "and never moves on an NVML node",
    "AcceleratorDcnLatencyHigh":
        "accelerator_dcn_transfer_latency_seconds is the reference's "
        "multislice DCN transfer latency from libtpu's runtime metrics; "
        "NVML has no such reading and no collector of the port fills it",
    "AcceleratorPassthroughFamilyCap":
        "the raw_family_cap poll error counts libtpu families passed "
        "through under --passthrough-unknown; the port has no passthrough "
        "(the flag is not in config.build_parser) and the NVML collector "
        "returns no raw values",
    "FleetIciLinkSuspect":
        "the hub's link localizer accuses a link only from two workers' "
        "views of it; an NVML card labels its links nvlink<N> toward the "
        "node's own NVSwitches, linkloc.edge_for maps none of them onto an "
        "edge, so kts_fleet_link_suspect is never set on an H100 fleet",
}

FAMILIES_NOT_ON_H100: dict[str, str] = {
    "accelerator_dcn_transfer_latency_seconds":
        "libtpu's multislice DCN latency; NVML has no counterpart",
    "accelerator_collective_ops_total":
        "libtpu's collective-op counter; neither NVML nor the port's "
        "embedded exporter counts collectives",
    "accelerator_runtime_restarts_total":
        "served at 0 and never moves: NVML has no uptime reading",
    "kts_fleet_link_suspect":
        "the link localizer is inert on NVLink labels (linkloc.py)",
}

CONDITIONAL: dict[str, str] = {
    "accelerator_ici_link_bandwidth_bytes_per_second":
        "NVLink traffic: a link is served from its first non-zero counter "
        "read (from the second tick on), so a card whose links carried "
        "nothing since the driver loaded serves none",
    "accelerator_memory_peak_bytes":
        "an embedded exporter in the workload (embedded.start)",
    "accelerator_peak_flops_per_second":
        "an embedded exporter in the workload (embedded.start)",
    "accelerator_workload_busy_seconds_total":
        "an embedded exporter in the workload (embedded.start)",
    "accelerator_workload_flops_total":
        "an embedded exporter in the workload, given the step's FLOPs",
    "accelerator_workload_model_flops_utilization":
        "an embedded exporter in the workload, given the step's FLOPs",
    "accelerator_workload_step_duration_seconds":
        "an embedded exporter in the workload, its steps timed",
    "accelerator_workload_steps_total":
        "an embedded exporter in the workload (embedded.start)",
    "collector_allocatable_devices":
        "kubelet attribution on (--attribution auto, a PodResources "
        "socket answering GetAllocatableResources)",
    "collector_poll_errors_total":
        "a failed read: each reason's series appears at its first error",
    "collector_push_total":
        "push egress: --pushgateway-url, --remote-write-url or --hub-url",
    "collector_push_failures_total":
        "push egress: --pushgateway-url, --remote-write-url or --hub-url",
    "collector_push_dropped_total":
        "push egress: --pushgateway-url, --remote-write-url or --hub-url",
    "kts_disk_faults_total":
        "a disk fault on a store (ENOSPC, EIO, EROFS, EMFILE)",
    "kts_fleet_waste_suspect":
        "the hub's efficiency lens accusing a pod (attribution on at the "
        "nodes, a pod idle or not stepping past the warm-up)",
    "kts_remote_write_dropped_total":
        "--remote-write-url with --remote-write-wal-dir",
    "kts_remote_write_lag_seconds":
        "--remote-write-url with --remote-write-wal-dir",
    "kts_spill_bytes": "--hub-url with --hub-spill-dir",
    "kts_spill_dropped_total": "--hub-url with --hub-spill-dir",
    "kts_wal_quarantined_total":
        "a checkpoint or WAL file of a newer format set aside at start",
    "slice_straggler_ratio":
        "a hub whose workers serve accelerator_workload_steps_total",
    "slice_worker_steps_per_second":
        "a hub whose workers serve accelerator_workload_steps_total",
}

# Every family prefix of the port's schema.
FAMILY_TOKEN = re.compile(
    r"\b((?:accelerator|collector|kts|slice|process|hub)_[a-z0-9_]*[a-z0-9])\b")
_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")
_SPECS = {spec.name: spec for spec in schema.ALL_METRICS}


def family_of(token: str) -> str | None:
    """The schema family a metric token names (a histogram's
    ``_bucket``/``_sum``/``_count`` series name its family), or None."""
    if token in _SPECS:
        return token
    for suffix in _HISTOGRAM_SUFFIXES:
        base = token[:-len(suffix)] if token.endswith(suffix) else None
        if base in _SPECS and \
                _SPECS[base].type is schema.MetricType.HISTOGRAM:
            return base
    return None


def _rules(path: Path) -> list[dict]:
    import yaml

    doc = yaml.safe_load(path.read_text())
    return [rule for group in doc["groups"] for rule in group["rules"]]


def alert_rules() -> list[dict]:
    return _rules(ALERTS)


def recording_rules() -> list[dict]:
    return _rules(RECORDING_RULES)


def dashboard() -> dict:
    return json.loads(DASHBOARD.read_text())


def expressions() -> dict[str, list[str]]:
    """Every PromQL expression of the three assets, by asset."""
    board = dashboard()
    return {
        "alerts": [rule["expr"] for rule in alert_rules()],
        "recording_rules": [rule["expr"] for rule in recording_rules()],
        "dashboard": [target["expr"] for panel in board["panels"]
                      for target in panel.get("targets", [])]
        + [var["query"]["query"] for var in board["templating"]["list"]
           if isinstance(var.get("query"), dict)],
    }


def named_families() -> dict[str, set[str]]:
    """asset -> the schema families its expressions name. Raises
    ValueError on a metric token outside the schema."""
    named: dict[str, set[str]] = {}
    for asset, exprs in expressions().items():
        families = named.setdefault(asset, set())
        for expr in exprs:
            for token in FAMILY_TOKEN.findall(expr):
                family = family_of(token)
                if family is None:
                    raise ValueError(f"{asset}: {token} is no family of "
                                     "the schema")
                families.add(family)
    return named
