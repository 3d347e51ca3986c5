"""Metric schema — the stable exposition contract.

The port's own copy of the reference package's schema: every family's
name, type, HELP text and labels, the base label contract, the histogram
buckets and the family filter are the same, so Prometheus cannot tell an
H100 node's exposition from a TPU node's (``docs/UNIFIED_SCHEMA.md``).
``tests/test_torch_schema.py`` holds the two tables equal.

Everything that renders or validates metrics in the port derives from the
tables in this module.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Iterable


class MetricType(enum.Enum):
    GAUGE = "gauge"
    COUNTER = "counter"
    HISTOGRAM = "histogram"


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One metric family in the exposition contract."""

    name: str
    type: MetricType
    help: str
    # Labels beyond the base device/attribution labels (e.g. "link" for
    # per-ICI-link families). Base labels are added by the registry.
    extra_labels: tuple[str, ...] = ()


# Base label set attached to every per-device sample. Order is the render
# order and is part of the golden contract.
#   accel_type   "tpu-v5p" / "tpu-v4" / "gpu-h100" / "mock" ...
#   chip         local chip index as string ("0".."7")
#   device_path  "/dev/accel0" or PCI address — stable node-local id
#   uuid         device serial/uuid when the backend provides one, else ""
DEVICE_LABELS: tuple[str, ...] = ("accel_type", "chip", "device_path", "uuid")

# Attribution labels (component C3). Empty strings when the device is
# unallocated or attribution is disabled — label *set* stays constant so
# Prometheus series identity never churns on (de)allocation.
ATTRIBUTION_LABELS: tuple[str, ...] = ("pod", "namespace", "container")

# Slice topology labels (component C9): every per-node exporter on a
# multi-host slice labels its local chips with its worker identity so
# Prometheus can aggregate the whole slice.
TOPOLOGY_LABELS: tuple[str, ...] = ("slice", "worker", "topology")

ALL_BASE_LABELS: tuple[str, ...] = DEVICE_LABELS + ATTRIBUTION_LABELS + TOPOLOGY_LABELS


# --- The accelerator_* family (north-star metrics, SURVEY.md §0) -----------

DUTY_CYCLE = MetricSpec(
    "accelerator_duty_cycle",
    MetricType.GAUGE,
    "Percent of time over the last sample window the accelerator core (MXU/"
    "TensorCore) was actively executing (0-100).",
)
TENSORCORE_UTIL = MetricSpec(
    "accelerator_tensorcore_utilization",
    MetricType.GAUGE,
    "Percent of peak TensorCore/MXU FLOP rate achieved over the last sample "
    "window (0-100).",
)
MEMORY_USED = MetricSpec(
    "accelerator_memory_used_bytes",
    MetricType.GAUGE,
    "Accelerator high-bandwidth memory currently allocated, in bytes.",
)
MEMORY_TOTAL = MetricSpec(
    "accelerator_memory_total_bytes",
    MetricType.GAUGE,
    "Accelerator high-bandwidth memory capacity, in bytes.",
)
MEMORY_PEAK = MetricSpec(
    "accelerator_memory_peak_bytes",
    MetricType.GAUGE,
    "High-water mark of accelerator memory allocated since the runtime "
    "(re)initialized this chip, in bytes. The OOM-debugging companion to "
    "accelerator_memory_used_bytes; a drop signals a runtime restart.",
)
MEMORY_BANDWIDTH_UTIL = MetricSpec(
    "accelerator_memory_bandwidth_utilization",
    MetricType.GAUGE,
    "Percent of peak accelerator memory (HBM) bandwidth used over the last "
    "sample window (0-100). Unified-schema analog of DCGM's DRAM-active "
    "ratio on GPU nodes.",
)
POWER = MetricSpec(
    "accelerator_power_watts",
    MetricType.GAUGE,
    "Instantaneous chip power draw, in watts.",
)
ENERGY = MetricSpec(
    "accelerator_energy_joules_total",
    MetricType.COUNTER,
    "Energy consumed by this chip since the exporter started, "
    "integrated from the power gauge at the poll cadence (rectangle "
    "rule over ~1 s ticks — an approximation; the DCGM "
    "total_energy_consumption analog). Joined with pod attribution "
    "labels this is per-workload energy accounting. Resets when the "
    "exporter restarts; use increase()/rate() across restarts.",
)
TEMPERATURE = MetricSpec(
    "accelerator_temperature_celsius",
    MetricType.GAUGE,
    "Chip temperature, in degrees Celsius.",
)
ICI_BANDWIDTH = MetricSpec(
    "accelerator_ici_link_bandwidth_bytes_per_second",
    MetricType.GAUGE,
    "Per-link inter-chip-interconnect traffic rate over the last poll "
    "interval, in bytes per second.",
    extra_labels=("link",),
)
ICI_TRAFFIC_TOTAL = MetricSpec(
    "accelerator_ici_link_traffic_bytes_total",
    MetricType.COUNTER,
    "Cumulative per-link inter-chip-interconnect traffic since device reset, "
    "in bytes.",
    extra_labels=("link",),
)
COLLECTIVE_OPS = MetricSpec(
    "accelerator_collective_ops_total",
    MetricType.COUNTER,
    "Cumulative collective operations (all-reduce/all-gather/...) executed "
    "by the runtime on this chip since reset.",
)
DCN_LATENCY = MetricSpec(
    "accelerator_dcn_transfer_latency_seconds",
    MetricType.GAUGE,
    "Cross-slice (DCN) buffer-transfer latency distribution over the last "
    "sample window, in seconds, as runtime-reported percentiles. Only "
    "present on multislice workloads; single-slice runtimes omit it.",
    extra_labels=("percentile",),
)
UPTIME = MetricSpec(
    "accelerator_uptime_seconds",
    MetricType.GAUGE,
    "Seconds since the accelerator runtime (re)initialized this chip. A "
    "reset to a small value flags a runtime restart between scrapes.",
)
RUNTIME_RESTARTS = MetricSpec(
    "accelerator_runtime_restarts_total",
    MetricType.COUNTER,
    "Runtime restarts observed for this chip since the exporter started "
    "(uptime moved backwards between polls — the exporter-derived "
    "'device bounced' event). Alert with increase(); the uptime gauge "
    "alone misses a restart that completes between scrapes. Counts "
    "observations, so restarts during exporter downtime are invisible; "
    "0 from first sight so increase() sees the first one.",
)
DEVICE_UP = MetricSpec(
    "accelerator_up",
    MetricType.GAUGE,
    "1 if the last poll of this device succeeded, 0 if it is stale/erroring.",
)
PROCESS_OPEN = MetricSpec(
    "accelerator_process_open",
    MetricType.GAUGE,
    "1 per process currently holding this device node open (procfs fd "
    "scan — the NVML-free analog of nvidia-smi's process table). The "
    "workload attribution that works on plain TPU VMs with no kubelet; "
    "refreshed on the attribution cadence, not per tick. pod_uid is "
    "parsed from the holder's cgroup path (kubelet systemd or cgroupfs "
    "layout; empty outside Kubernetes) — pod attribution with no kubelet "
    "API. Cardinality is capped at --max-process-series holders per "
    'device; the excess is folded into one {pid="",comm="_overflow"} '
    "series whose value is the folded holder count.",
    extra_labels=("pid", "comm", "pod_uid"),
)

WORKLOAD_STEPS = MetricSpec(
    "accelerator_workload_steps_total",
    MetricType.COUNTER,
    "Training/serving steps the co-located workload reported via the "
    "embedded exporter's step hook (kube_gpu_stats_tpu.embedded). In SPMD "
    "every local device participates in each step, so the counter rides "
    "each device's label set. Only present in embedded mode.",
)

PASSTHROUGH = MetricSpec(
    "tpu_runtime_passthrough",
    MetricType.GAUGE,
    "Value of a libtpu metric family outside the pinned accelerator_* "
    "schema, exported verbatim under the 'family' label "
    "(--passthrough-unknown). Series identity is the raw runtime name — "
    "deterministic across restarts, collision-free by construction; "
    "per-link samples carry the 'link' label. Semantics are the "
    "runtime's, not part of the accelerator_* contract; distinct family "
    "count is capped (overflow counted as raw_family_cap poll errors).",
    extra_labels=("family", "link"),
)

WORKLOAD_BUSY_SECONDS = MetricSpec(
    "accelerator_workload_busy_seconds_total",
    MetricType.COUNTER,
    "Cumulative seconds the co-located workload reported spending inside "
    "timed steps (embedded exporter's step_timer/record_step hook). "
    "rate() of this counter is the workload-busy fraction — the honest "
    "in-process analog of accelerator_duty_cycle, measured from the code "
    "that owns the chip rather than the runtime. Only present in "
    "embedded mode.",
)

WORKLOAD_FLOPS = MetricSpec(
    "accelerator_workload_flops_total",
    MetricType.COUNTER,
    "Cumulative model FLOPs this chip executed, as reported by the "
    "workload via the embedded exporter's step hook (record_step(flops=)/"
    "step_timer(flops=)); the workload-global figure is divided evenly "
    "over ALL participating devices (jax.device_count() — global, so "
    "multi-host SPMD shares are exact). rate() of this counter divided by "
    "accelerator_peak_flops_per_second, times 100, is MFU in percent "
    "(matching accelerator_workload_model_flops_utilization). Only "
    "present in embedded mode when the workload reports FLOPs.",
)
PEAK_FLOPS = MetricSpec(
    "accelerator_peak_flops_per_second",
    MetricType.GAUGE,
    "Peak dense bf16 FLOP rate of this chip, from a device-kind table "
    "(public per-chip specs). The MFU denominator for any FLOPs source; "
    "absent for unknown device kinds (never a guess).",
)
WORKLOAD_MFU = MetricSpec(
    "accelerator_workload_model_flops_utilization",
    MetricType.GAUGE,
    "Model FLOPs utilization (MFU) over the last poll interval, percent "
    "of peak dense bf16: workload-reported FLOPs per local device per "
    "second divided by accelerator_peak_flops_per_second. Computed "
    "in-process so `top`/dashboards get it without a Prometheus rate(). "
    "Values over 100 mean the workload over-reports FLOPs. Only present "
    "in embedded mode when FLOPs are reported and the device kind is "
    "known.",
)

WORKLOAD_STEP_DURATION = MetricSpec(
    "accelerator_workload_step_duration_seconds",
    MetricType.HISTOGRAM,
    "Distribution of timed workload step durations reported via the "
    "embedded exporter's step hook. Workload-global (SPMD steps span "
    "every local device), so it carries no per-device labels. Only "
    "present in embedded mode.",
)

PER_DEVICE_METRICS: tuple[MetricSpec, ...] = (
    DUTY_CYCLE,
    TENSORCORE_UTIL,
    MEMORY_USED,
    MEMORY_TOTAL,
    MEMORY_PEAK,
    MEMORY_BANDWIDTH_UTIL,
    POWER,
    ENERGY,
    TEMPERATURE,
    ICI_BANDWIDTH,
    ICI_TRAFFIC_TOTAL,
    COLLECTIVE_OPS,
    DCN_LATENCY,
    UPTIME,
    RUNTIME_RESTARTS,
    DEVICE_UP,
    PROCESS_OPEN,
    WORKLOAD_STEPS,
    WORKLOAD_BUSY_SECONDS,
    WORKLOAD_FLOPS,
    PEAK_FLOPS,
    WORKLOAD_MFU,
    PASSTHROUGH,
)

# Workload-global histogram families (embedded mode): enter snapshots via
# the poll loop's collector extra_histograms() hook, not Sample.values, so
# they live outside PER_DEVICE_METRICS (whose names key Sample.values).
WORKLOAD_HISTOGRAMS: tuple[MetricSpec, ...] = (WORKLOAD_STEP_DURATION,)

# DCN latency arrives from the runtime as one metric per percentile. Inside
# a Sample.values mapping each percentile is carried under a *value key*
# ("<family>:<percentile>" — ':' keeps the key out of the plain-family
# namespace); the poll loop expands the key into the percentile label at
# snapshot-build time. Collectors never construct label pairs themselves.
DCN_PERCENTILES: tuple[str, ...] = ("p50", "p90", "p99")


def dcn_value_key(percentile: str) -> str:
    return f"{DCN_LATENCY.name}:{percentile}"


# value key -> (spec, percentile), for the snapshot builder's expansion.
PERCENTILE_VALUE_KEYS: dict[str, tuple[MetricSpec, str]] = {
    dcn_value_key(p): (DCN_LATENCY, p) for p in DCN_PERCENTILES
}


# --- Slice hub rollups (C9 aggregation service, hub.py) --------------------
# Families exported by `kube-tpu-stats hub`, which scrapes every per-node
# exporter of a multi-host slice and serves one merged view. slice_* names
# carry cross-node rollups; hub_* names are the hub's own health.

HUB_TARGET_UP = MetricSpec(
    "slice_target_up",
    MetricType.GAUGE,
    "1 if the hub's last refresh scraped this per-node exporter target "
    "successfully, 0 if the fetch or parse failed. One series per "
    "configured target — a 0 names the exact worker VM that dropped out "
    "of the slice view.",
    extra_labels=("target",),
)
HUB_TARGET_FETCH_SECONDS = MetricSpec(
    "slice_target_fetch_seconds",
    MetricType.GAUGE,
    "Wall time the hub's last successful fetch+parse of this target "
    "took. A worker VM whose exporter answers slowly shows up here long "
    "before it times out into slice_target_up 0.",
    extra_labels=("target",),
)
HUB_TARGETS = MetricSpec(
    "slice_targets",
    MetricType.GAUGE,
    "Targets the hub is currently configured/discovered to scrape "
    "(before reachability). 0 means the target list is empty — a "
    "configuration/discovery state, not a process failure: the hub "
    "stays live and publishes this gauge so liveness probes pass; "
    "alert on `slice_targets == 0` to catch a decommission or a "
    "discovery outage.",
)
HUB_WORKERS_EXPECTED = MetricSpec(
    "slice_workers_expected",
    MetricType.GAUGE,
    "Worker count the hub was told to expect (--expect-workers); 0 when "
    "unset. Exported unlabeled (it is a property of the hub config, not "
    "of one slice), so alert with `slice_workers < on() group_left() "
    "slice_workers_expected` to catch missing DaemonSet pods that never "
    "appear as a failing target.",
)
HUB_DUPLICATE_SERIES = MetricSpec(
    "slice_duplicate_series",
    MetricType.GAUGE,
    "Per-chip series dropped from the merged view in the last refresh "
    "because another target already exported the identical name+labels. "
    "Nonzero means two exporters claim the same chip identity "
    "(misconfigured topology labels or a target listed twice).",
)
HUB_CHIPS = MetricSpec(
    "slice_chips",
    MetricType.GAUGE,
    "Chips the hub observed across all targets of this slice in the last "
    "refresh.",
    extra_labels=("slice",),
)
HUB_CHIPS_UP = MetricSpec(
    "slice_chips_up",
    MetricType.GAUGE,
    "Observed chips whose exporter reported accelerator_up 1.",
    extra_labels=("slice",),
)
HUB_WORKERS = MetricSpec(
    "slice_workers",
    MetricType.GAUGE,
    "Distinct workers observed for this slice in the last refresh "
    "(worker label; targets with no worker label count individually).",
    extra_labels=("slice",),
)
HUB_DUTY_MEAN = MetricSpec(
    "slice_duty_cycle_mean",
    MetricType.GAUGE,
    "Mean accelerator_duty_cycle over every observed chip of the slice "
    "(0-100).",
    extra_labels=("slice",),
)
HUB_DUTY_MIN = MetricSpec(
    "slice_duty_cycle_min",
    MetricType.GAUGE,
    "Minimum per-chip duty cycle across the slice — the idle straggler "
    "in an SPMD job where every chip should be equally busy.",
    extra_labels=("slice",),
)
HUB_DUTY_MAX = MetricSpec(
    "slice_duty_cycle_max",
    MetricType.GAUGE,
    "Maximum per-chip duty cycle across the slice.",
    extra_labels=("slice",),
)
HUB_MFU_MEAN = MetricSpec(
    "slice_workload_mfu_mean",
    MetricType.GAUGE,
    "Mean accelerator_workload_model_flops_utilization over every "
    "observed chip of the slice reporting it (embedded-mode workloads) "
    "— is the whole slice doing useful FLOPs, not just drawing power. "
    "Absent until some chip reports MFU.",
    extra_labels=("slice",),
)
HUB_MFU_MIN = MetricSpec(
    "slice_workload_mfu_min",
    MetricType.GAUGE,
    "Minimum per-chip MFU across the slice — in SPMD every chip should "
    "do the same useful work, so a low outlier is the goodput analog "
    "of the duty-cycle straggler.",
    extra_labels=("slice",),
)
HUB_MEMORY_USED = MetricSpec(
    "slice_memory_used_bytes",
    MetricType.GAUGE,
    "Sum of accelerator_memory_used_bytes over every observed chip of "
    "the slice.",
    extra_labels=("slice",),
)
HUB_MEMORY_TOTAL = MetricSpec(
    "slice_memory_total_bytes",
    MetricType.GAUGE,
    "Sum of accelerator_memory_total_bytes over every observed chip of "
    "the slice.",
    extra_labels=("slice",),
)
HUB_POWER = MetricSpec(
    "slice_power_watts",
    MetricType.GAUGE,
    "Sum of per-chip power draw over the slice, in watts.",
    extra_labels=("slice",),
)
HUB_ICI_BANDWIDTH = MetricSpec(
    "slice_ici_bandwidth_bytes_per_second",
    MetricType.GAUGE,
    "Sum of per-link ICI traffic rates over every observed chip of the "
    "slice.",
    extra_labels=("slice",),
)
HUB_ENERGY = MetricSpec(
    "slice_energy_joules",
    MetricType.GAUGE,
    "Sum of per-chip accelerator_energy_joules_total over the chips of "
    "the slice that answered the last refresh. A gauge, not a counter, "
    "by the deliberate dip policy: a worker missing a refresh drops its "
    "share (slice_target_up names it) and a counter dipping would "
    "rate() as a phantom reset. For audit-grade per-pod totals that "
    "survive restarts, read each node's /debug/energy digest "
    "(kts_energy_pod_joules_total).",
    extra_labels=("slice",),
)
HUB_WORKER_STEPS = MetricSpec(
    "slice_worker_steps_per_second",
    MetricType.GAUGE,
    "Per-worker workload step rate (mean over the worker's chips), "
    "computed by the hub from frame-over-frame counter deltas of "
    "accelerator_workload_steps_total. Appears from the second refresh. "
    "min() over workers is the slice's effective (straggler-bound) rate.",
    extra_labels=("slice", "worker"),
)
HUB_STRAGGLER_RATIO = MetricSpec(
    "slice_straggler_ratio",
    MetricType.GAUGE,
    "min/max of per-worker step rates for the slice (1.0 = perfectly "
    "balanced; low values mean a straggling worker is gating the SPMD "
    "job). Appears once step rates exist.",
    extra_labels=("slice",),
)
HUB_REFRESH_DURATION = MetricSpec(
    "hub_refresh_duration_seconds",
    MetricType.HISTOGRAM,
    "Wall time of one hub refresh: concurrent scrape of every target plus "
    "merge and rollup computation.",
)
HUB_BODY_CACHE_HITS = MetricSpec(
    "kts_hub_body_cache_hits_total",
    MetricType.COUNTER,
    "Target fetches whose response body was byte-identical to the previous "
    "refresh, so the hub reused the cached parse and merge plan with zero "
    "re-parse (idle chips make this the common case). Hit rate = this "
    "counter's rate over refresh_rate * slice_targets; a low rate on an "
    "idle slice means something (timestamps, jitter) is churning the "
    "exposition text every cycle.",
)
HUB_PARSE_SECONDS = MetricSpec(
    "kts_hub_parse_seconds",
    MetricType.HISTOGRAM,
    "Wall time tokenizing one target's exposition into series (body-cache "
    "misses only; hits skip the parse entirely). The ingest half of the "
    "hub's merge budget — hub_refresh_duration_seconds minus fetch and "
    "parse is rollup+merge cost.",
)

# Delta-ingest families (delta.py): the hub's push edge —
# daemons (and leaf hubs, in a federation tree) publish seq-numbered
# change-sets of interned series slots instead of being pull-scraped
# whole; these families make the protocol's health observable.

DELTA_FRAMES = MetricSpec(
    "kts_delta_frames_total",
    MetricType.COUNTER,
    "Delta-protocol frames this hub has applied, by kind: 'full' "
    "(complete exposition snapshot — session start, shape change, or "
    "resync) and 'delta' (changed series slots only — the steady "
    "state). A full:delta ratio climbing toward 1 means sessions keep "
    "resyncing (see kts_hub_resync_total) or series shapes churn every "
    "tick, and the push path is degenerating into pull-with-extra-steps.",
    extra_labels=("kind",),
)
DELTA_BYTES = MetricSpec(
    "kts_delta_bytes_total",
    MetricType.COUNTER,
    "Compressed wire bytes of delta-protocol frames this hub has "
    "accepted (full and delta frames both). Against the rendered "
    "exposition size this prices the push edge: a quiet fleet ships "
    "bytes proportional to churn, not chip count.",
)
HUB_RESYNC = MetricSpec(
    "kts_hub_resync_total",
    MetricType.COUNTER,
    "Delta frames this hub rejected with 'resync required' (seq gap, "
    "generation mismatch after a worker restart, or no session state "
    "after a hub restart/eviction). Each rejection makes the publisher "
    "send one full snapshot and resume deltas. A steady rate here is a "
    "resync storm — see the federation runbook in docs/OPERATIONS.md.",
)
HUB_DUP_SLICE = MetricSpec(
    "kts_hub_dup_slice_total",
    MetricType.COUNTER,
    "Federated slice_* rollup series a root hub dropped because another "
    "leaf already re-exported the identical name+labels (two leaves "
    "claiming one slice label — a misconfigured TPU_NAME or a leaf "
    "listed twice). First leaf wins, the loser's series is silently "
    "absent from the root, so this counter (and the delta_dup_slice "
    "journal event naming the slice) is the only evidence.",
)
DELTA_PUSH_TARGETS = MetricSpec(
    "kts_delta_push_targets",
    MetricType.GAUGE,
    "Targets whose last refresh was served from a live delta-push "
    "session (no pull fetch issued). slice_targets minus this is the "
    "pull-scraped remainder — old daemons, push-disabled nodes, and "
    "push sessions that went stale past the fence and fell back to "
    "pull.",
)

# Sharded-ingest families: push sources hash to
# shared-nothing lanes (own lock, session table, entry slab) so POST
# handler threads stop convoying behind one lock at 10k-pusher fan-in;
# the hot per-slot patch loop runs in the native wirefast extension.

INGEST_LANES = MetricSpec(
    "kts_ingest_lanes",
    MetricType.GAUGE,
    "Delta-ingest lanes this hub runs (--ingest-lanes; sources hash to "
    "a lane, each with its own lock, session table and entry slab). "
    "1 means every POST handler thread serializes on one lock — fine "
    "for small fleets, the ceiling at high pusher fan-in.",
)
INGEST_LANE_SESSIONS = MetricSpec(
    "kts_ingest_lane_sessions",
    MetricType.GAUGE,
    "Live delta-push sessions homed in this ingest lane. A healthy "
    "fleet spreads roughly evenly (crc32 of the source URL); one lane "
    "holding most sessions means pathologically similar source names — "
    "raise --ingest-lanes or diversify the source spellings.",
    extra_labels=("lane",),
)
INGEST_LANE_FRAMES = MetricSpec(
    "kts_ingest_lane_frames_total",
    MetricType.COUNTER,
    "Delta-protocol frames (full + delta) this ingest lane has applied "
    "since the hub started. Per-lane rate imbalance with a balanced "
    "session spread = one chatty publisher, not a bad hash.",
    extra_labels=("lane",),
)
INGEST_LANE_APPLY_SECONDS = MetricSpec(
    "kts_ingest_lane_apply_seconds_total",
    MetricType.COUNTER,
    "Cumulative wall seconds this lane's POST handler threads spent "
    "inside frame apply (parse + seq validation + slot patch). "
    "rate() summed over lanes is the hub's ingest CPU share — the "
    "number the 10k-pusher storm bench budgets (ingest_cpu_pct); one "
    "lane's rate running hot while the others idle is the "
    "sharding-isn't-helping signal (see the 'Scaling ingest' runbook).",
    extra_labels=("lane",),
)
INGEST_PROCS = MetricSpec(
    "kts_ingest_procs",
    MetricType.GAUGE,
    "SO_REUSEPORT acceptor processes configured for delta ingest "
    "(--ingest-procs). 0 means in-process ingest: POST handler "
    "threads run inside the hub. N>0 means the kernel shards the "
    "public-port accept load over N forked acceptors that validate at "
    "the edge and relay frames to the hub over pipelined unix "
    "channels — connection handling scales past the GIL while the hub "
    "stays the single-writer session authority.",
)
INGEST_PROC_UP = MetricSpec(
    "kts_ingest_proc_up",
    MetricType.GAUGE,
    "1 while this SO_REUSEPORT acceptor process is alive and relaying "
    "(its control channel is connected), 0 while the pool is "
    "respawning it. A proc flapping here while its siblings stay up "
    "is a crash in the acceptor itself; every proc down at once "
    "usually means the public port could not be bound.",
    extra_labels=("proc",),
)
INGEST_PROC_FRAMES = MetricSpec(
    "kts_ingest_proc_frames_total",
    MetricType.COUNTER,
    "Delta-protocol POST bodies this acceptor process relayed to the "
    "hub (any verdict). The kernel's SO_REUSEPORT hash spreads "
    "CONNECTIONS, so a roughly even spread is healthy; one proc "
    "carrying most frames means a few chatty persistent connections, "
    "not a broken hash.",
    extra_labels=("proc",),
)
INGEST_PROC_ACCEPTED = MetricSpec(
    "kts_ingest_proc_accepted_total",
    MetricType.COUNTER,
    "Frames relayed by this acceptor process that the hub applied "
    "(200). Summed over procs this equals the hub's "
    "kts_delta_frames_total (full + delta) plus duplicates — the "
    "multi-proc conservation check chaos-sim and the storm bench pin.",
    extra_labels=("proc",),
)
INGEST_PROC_SHED = MetricSpec(
    "kts_ingest_proc_shed_total",
    MetricType.COUNTER,
    "Frames relayed by this acceptor process that the hub refused at "
    "admission (429/503/413 shed classes). The per-reason split lives "
    "in kts_ingest_shed_total; this per-proc view says WHERE the "
    "refused load is landing.",
    extra_labels=("proc",),
)
INGEST_PROC_BYTES = MetricSpec(
    "kts_ingest_proc_bytes_total",
    MetricType.COUNTER,
    "Compressed delta-frame bytes this acceptor process relayed to "
    "the hub. Compare with kts_delta_bytes_total to price the relay "
    "overhead (should be ~equal: the relay ships the wire verbatim).",
    extra_labels=("proc",),
)
INGEST_NATIVE = MetricSpec(
    "kts_ingest_native",
    MetricType.GAUGE,
    "1 when delta frames apply through the native wirefast batch store "
    "(apply_slots), 0 on the pure-Python per-slot oracle "
    "(--no-native-ingest, or the extension isn't built). The Python "
    "path costs ~an order of magnitude more ingest CPU per frame — at "
    "10k-pusher fan-in, 0 here plus a hot "
    "kts_ingest_lane_apply_seconds_total is the first thing to check.",
)

# Overload-survival families: ingest admission control,
# hostile-pusher quarantine, and the warm-restart checkpoint — see the
# 'Overload & disaster recovery' runbook in docs/OPERATIONS.md.

INGEST_SHED = MetricSpec(
    "kts_ingest_shed_total",
    MetricType.COUNTER,
    "Delta-ingest frames refused at admission, by reason: 'delta_rate' "
    "(a lane's DELTA token bucket ran dry — chatty sources, 429), "
    "'inflight' (the concurrent-apply budget is full, 429/503), "
    "'memory' (a NEW session hit the session-table fence, 503 — "
    "established sessions are never refused here), and 'quarantined' "
    "(a peer/source serving repeated malformed frames, 429). Every "
    "shed carries Retry-After; publishers defer and re-diff (see "
    "kts_delta_shed_honored_total), so a steady rate here is load "
    "shaping, not data loss — alert when it stays high "
    "(IngestShedHigh).",
    extra_labels=("reason",),
)
INGEST_QUARANTINED = MetricSpec(
    "kts_ingest_quarantined",
    MetricType.GAUGE,
    "Peers/sources currently quarantined by the malformed-frame "
    "breaker: their frames answer 429 before any decode work until the "
    "quarantine window passes, then one probe frame decides. Nonzero "
    "means someone is POSTing garbage at /ingest/delta — the "
    "ingest_quarantine journal event (/debug/events) names the key.",
)
# Cardinality admission families: the series ledger, its
# sheds/evictions, and the daemon-side label fence — see the
# 'Cardinality admission' runbook in docs/OPERATIONS.md.

SERIES_LIVE = MetricSpec(
    "kts_series_live",
    MetricType.GAUGE,
    "Live series by component: 'entries' is the hub's admission ledger "
    "(series held across all ingested/pulled target entries — what the "
    "budgets and the hard cap bound), 'exposition' is the series count "
    "of the last rendered snapshot (what a scraper actually receives). "
    "Size budgets from 'entries'; it is the number that grows when a "
    "label bomb lands.",
    extra_labels=("component",),
)
CARDINALITY_SHED = MetricSpec(
    "kts_cardinality_shed_total",
    MetricType.COUNTER,
    "Series refused by cardinality admission, by source and reason: "
    "'source_budget' (a FULL over its source's series budget — the "
    "frame still lands, clamped to the admitted prefix; only the NEW "
    "series are dropped and existing series keep updating) and "
    "'hard_cap' (the global ledger is full; a frame that would grow it "
    "draws a 413 the publisher defers on, like a 429). Sources beyond "
    "the accounting bound aggregate under source=\"other\". A steady "
    "rate means a label bomb is being contained — doctor --cardinality "
    "names the offender (CardinalityShedActive).",
    extra_labels=("source", "reason"),
)
CARDINALITY_EVICTED = MetricSpec(
    "kts_cardinality_evicted_total",
    MetricType.COUNTER,
    "Series evicted by the accountant above its high watermark, by "
    "reason ('idle': the source had not updated for the configured "
    "number of refreshes — LRU order, pruned through the hub's churn "
    "path so parse cache, delta session and fleet baselines go "
    "together). An evicted push source re-admits itself with one FULL "
    "resync when it wakes; accounted loss, never a crash.",
    extra_labels=("reason",),
)
SOURCE_SERIES = MetricSpec(
    "kts_source_series",
    MetricType.GAUGE,
    "Live series for the top-K sources in the admission ledger (K "
    "bounded so this family cannot itself explode). The budget-sizing "
    "input: set --series-budget-per-source comfortably above the "
    "honest fleet's max(kts_source_series).",
    extra_labels=("source",),
)
CARDINALITY_FENCED = MetricSpec(
    "kts_cardinality_fenced_total",
    MetricType.COUNTER,
    "Daemon-side label-fence hits by label key: plan compilations "
    "where a label value past the per-key distinct-value cap "
    "(--label-value-cap) degraded to the \"overflow\" aggregate "
    "instead of minting a new series. Nonzero means attribution is "
    "churning values (bad kubelet join, pod-churn storm) — the "
    "cardinality_fenced journal event has the first occurrence.",
    extra_labels=("label",),
)
HUB_WARM_RESTART_SESSIONS = MetricSpec(
    "kts_hub_warm_restart_sessions",
    MetricType.GAUGE,
    "Push sessions this hub restored from its ingest checkpoint after "
    "a restart (seq chains resumed without a 409/FULL resync). "
    "Compare with kts_hub_resync_total right after a restart: warm "
    "sessions resume for free, only the checkpoint-to-crash tail pays "
    "a FULL.",
)
HUB_WARM_RESTART_PENDING = MetricSpec(
    "kts_hub_warm_restart_pending",
    MetricType.GAUGE,
    "Checkpointed sessions still waiting for warm-restart replay. "
    "/readyz holds NotReady while this is nonzero (scrapers drain to "
    "fully-resumed hubs); stuck above 0 means the replay thread died "
    "or the checkpoint names sources that never pushed again.",
)
HUB_WARM_RESTART_REPLAY_SECONDS = MetricSpec(
    "kts_hub_warm_restart_replay_seconds",
    MetricType.GAUGE,
    "Wall time the last warm-restart replay took from checkpoint load "
    "to the final session restored (background sweep + on-demand "
    "replays together). The recovery-time half of the chaos-sim pin.",
)
HUB_WARM_RESTART_CHECKPOINT_WRITES = MetricSpec(
    "kts_hub_warm_restart_checkpoint_writes_total",
    MetricType.COUNTER,
    "Ingest checkpoint writes (.wal + fsync + atomic rename, the "
    "energy.py WAL discipline) since the hub started. Flat while "
    "frames flow means checkpointing is failing — the next restart "
    "will be a cold 409 stampede, alert on it.",
)
HUB_WARM_RESTART_CHECKPOINT_AGE = MetricSpec(
    "kts_hub_warm_restart_checkpoint_age_seconds",
    MetricType.GAUGE,
    "Seconds since the last successful ingest checkpoint write. "
    "Bounded by the checkpoint interval on a healthy hub; its value "
    "at crash time is exactly the session tail that will pay a FULL "
    "resync on the next start.",
)

# Version-skew survival families: rolling upgrades leave
# the fleet mixed-build for hours; these are the census and the
# refusal accounting the 'Rolling upgrades' runbook keys on.

BUILD_INFO = MetricSpec(
    "kts_build_info",
    MetricType.GAUGE,
    "Constant 1 on daemon and hub alike; the labels carry this "
    "process's exporter build version and the delta wire-protocol "
    "range it speaks (proto_min..proto_max). Join/group across the "
    "fleet for a scrape-side version census; the push-side census the "
    "hub computes itself is kts_fleet_version_count.",
    extra_labels=("version", "proto_min", "proto_max"),
)
FLEET_VERSION_COUNT = MetricSpec(
    "kts_fleet_version_count",
    MetricType.GAUGE,
    "Live push sessions per publisher version, from the hub's ingest "
    "census: the label is the build its FULL frames declared "
    "(capability-carrying builds), 'wire-vN' for a pre-capability "
    "build that only stamps the wire version, or 'unknown' for a "
    "warm-restored session whose publisher hasn't pushed since "
    "restart. THE census-gated-rollout gauge: proceed to the next "
    "wave when the old version's count reaches 0 (see the Rolling "
    "upgrades runbook and the FleetVersionSkewStuck alert).",
    extra_labels=("version",),
)
SKEW_REFUSED = MetricSpec(
    "kts_skew_refused_total",
    MetricType.COUNTER,
    "Frames refused for wire-protocol version skew (HTTP 426 + this "
    "end's advertised range). On a hub: frames whose version fell "
    "outside --ingest-proto-min/max — a healthy peer from another "
    "rollout wave, NOT a malformed-frame quarantine strike; the "
    "refused peers are named at /debug/skew and by doctor --skew. On "
    "a daemon/leaf: pushes the upstream hub refused the same way. "
    "Steady growth means a publisher/hub pair whose ranges are "
    "disjoint — it cannot self-heal; fix the rollout "
    "(FleetVersionSkewStuck).",
)
WAL_QUARANTINED = MetricSpec(
    "kts_wal_quarantined_total",
    MetricType.COUNTER,
    "Persisted files set aside byte-identical (renamed *.skew-vN / "
    "*.skew) because they carry a FUTURE format version this build "
    "cannot safely parse — a downgrade landed on a newer build's "
    "state. The process starts degraded from empty state for that "
    "store instead of truncating data a newer build wrote; "
    "re-upgrading (or moving the file back under the writing build) "
    "replays it. Labeled by store (energy, ingest, spill, remote-write "
    "shard N...); any increase deserves a look — it means version "
    "skew reached disk.",
    extra_labels=("store",),
)

# Shared by daemon and hub expositions (the hub-only census family
# rides HUB_METRICS); folded into SELF_METRICS below.
SKEW_METRICS: tuple[MetricSpec, ...] = (
    BUILD_INFO,
    SKEW_REFUSED,
    WAL_QUARANTINED,
)

# Local fault survival families: every disk-backed store
# (energy checkpoint, ingest checkpoint, spill queue, remote-write
# WAL shards) and the HTTP accept loops carry a durability state
# machine — a full disk, an I/O error, a read-only remount or fd
# exhaustion becomes a counted, journaled, auto-recovering
# degradation instead of a crash or a silent stop.

STORE_STATE = MetricSpec(
    "kts_store_state",
    MetricType.GAUGE,
    "Durability state per disk-backed store (energy, ingest, spill, "
    "remote-write shard N, http-accept): 1 healthy (durable ops reach "
    "the disk), 0 degraded (a local resource fault — ENOSPC, EIO, "
    "EROFS, EMFILE; telemetry continues in-memory, loss is counted in "
    "kts_store_lost_records_total, and the store re-probes the disk "
    "every few seconds, re-arming automatically when the fault "
    "clears). The reason/errno detail lives at /debug/stores and in "
    "doctor --stores; alert on sustained 0 (StoreDegraded).",
    extra_labels=("store",),
)
DISK_FAULTS = MetricSpec(
    "kts_disk_faults_total",
    MetricType.COUNTER,
    "OS-level faults per store and errno (ENOSPC, EDQUOT, EIO, EROFS, "
    "EACCES, EMFILE, ENFILE, ...): every failed durable op counts "
    "here, while the matching log line fires once per (store, errno) "
    "EPISODE, not once per tick. A steady rate on one store names the "
    "sick filesystem; rates across every store mean the node's disk "
    "(or fd budget) is the problem (DiskFaultsHigh).",
    extra_labels=("store", "errno"),
)
STORE_LOST = MetricSpec(
    "kts_store_lost_records_total",
    MetricType.COUNTER,
    "Records whose DURABILITY was lost to a local fault, per store: "
    "ring records appended memory-only while the store was degraded, "
    "records shed oldest-first to reclaim a full disk, and records "
    "whose durable copy was quarantined with an EIO-sick segment. "
    "The queues keep serving from memory, so nothing is silently "
    "dropped while the process lives — this counter is exactly what a "
    "crash during the degraded window would cost. Checkpoint stores "
    "defer (rewrite whole on recovery) rather than lose, so they "
    "stay at 0 here.",
    extra_labels=("store",),
)
THREAD_RESTART_STORMS = MetricSpec(
    "kts_thread_restart_storms_total",
    MetricType.COUNTER,
    "Restart storms the supervisor latched per component: a component "
    "restarted so often inside the storm window that respawning it "
    "again is hammering, not healing — restarts pause for the storm "
    "hold (the component reads degraded with a 'restart storm' "
    "reason), then ONE probe respawn re-tests it. Any increase means "
    "a worker thread is dying on arrival — read its last restart "
    "reason at /debug/stores (ThreadRestartStorm).",
    extra_labels=("component",),
)

LOCAL_FAULT_METRICS: tuple[MetricSpec, ...] = (
    STORE_STATE,
    DISK_FAULTS,
    STORE_LOST,
    THREAD_RESTART_STORMS,
)

# Fleet-lens families (fleetlens.py, driven from the hub refresh):
# cross-node anomaly detection, slow-node attribution, SLO burn windows.

FLEET_TARGETS_ANOMALOUS = MetricSpec(
    "kts_fleet_targets_anomalous",
    MetricType.GAUGE,
    "Targets the hub's fleet lens currently flags anomalous (z-score "
    "baseline breach or freshness miss). 0 is the healthy steady state; "
    "the per-target detail (which signal, how far off baseline) is at "
    "/debug/fleet and in `doctor --fleet`.",
)
FLEET_ANOMALIES = MetricSpec(
    "kts_fleet_anomalies_total",
    MetricType.COUNTER,
    "Anomalies the fleet lens has raised per target and kind since the "
    "hub started (kind = the breached signal: duty/hbm/power/"
    "power_burst/steps/fetch/stale_fraction, a host_* signal from the "
    "target's kts_host_* exposition — host_mem_stall/host_cpu_stall/"
    "host_io_stall for PSI shares, host_nic_drops, host_throttle — or "
    "'freshness' for a target missing several refreshes running; "
    "power_burst scores the target's sub-tick burst peak, and fetch "
    "scores the delta-frame inter-arrival gap for push-served "
    "targets). Edge-counted — one per transition into anomaly, not "
    "per anomalous refresh — so increase() counts incidents, not "
    "their duration.",
    extra_labels=("target", "kind"),
)
FLEET_SLO_BURN = MetricSpec(
    "kts_fleet_slo_burn_rate",
    MetricType.GAUGE,
    "Multi-window SLO burn rate per objective: bad-event fraction over "
    "the window divided by the objective's error budget (1 - target). "
    "1.0 = burning exactly the budget; alert on both windows over "
    "threshold (classic multiwindow burn alerting). Objectives: "
    "'freshness' (observed chips serving fresh data — a stale chip or "
    "an unreachable target's last-known chips count as bad) and "
    "'straggler' (refreshes whose slice straggler ratio met "
    "--slo-straggler-ratio).",
    extra_labels=("objective", "window"),
)
FLEET_SLO_BAD = MetricSpec(
    "kts_fleet_slo_bad_ratio",
    MetricType.GAUGE,
    "Raw bad-event fraction per SLO objective and window — the burn "
    "rate's numerator before dividing by the error budget, for "
    "dashboards that plot budget consumption directly.",
    extra_labels=("objective", "window"),
)
FLEET_WORST_TICK = MetricSpec(
    "kts_fleet_worst_tick_seconds",
    MetricType.GAUGE,
    "Slowest flight-recorder tick across the fleet, harvested from each "
    "target's kts_slowest_tick_seconds digest: the value is that tick's "
    "duration, the labels name the worst node and its worst phase — the "
    "cross-node slow-node attribution a per-process view can't compute. "
    "Label values follow the current worst node, so treat this as "
    "forensic state (latest wins), not a long-lived series.",
    extra_labels=("target", "phase"),
)

# Interconnect-localization families (linkloc.py): the hub's
# topology-aware ICI pass that names the sick LINK instead of accusing
# the neighbor nodes that merely see its symptoms.

FLEET_LINKS = MetricSpec(
    "kts_fleet_links",
    MetricType.GAUGE,
    "ICI links in the modeled interconnect graph (torus adjacency from "
    "the fleet's topology label, or the ring fallback over worker "
    "ids). 0 means localization is inert — no parseable topology or a "
    "sparse/non-numeric worker set; per-link verdicts can't exist "
    "without a graph.",
)
FLEET_LINK_SUSPECT = MetricSpec(
    "kts_fleet_link_suspect",
    MetricType.GAUGE,
    "1 while the localization pass accuses this ICI link: BOTH "
    "endpoints' own per-link counters degraded below their baselines "
    "together for consecutive refreshes, and no endpoint looks like a "
    "whole-node fault (>= 2 sick edges). reason is the evidence trail "
    "('ici-rate', plus '+anomaly-correlated' when the endpoints' "
    "step/fetch/ici z-scores breached, plus '+host-counter-confirmed' "
    "when PR 8's host NIC/IRQ signals corroborate). Falls to 0 on "
    "recovery (the series persists as a tombstone so history lookback "
    "sees the clear); detail at /debug/fleet under 'links' and in "
    "`doctor --fleet`.",
    extra_labels=("link", "reason"),
)
FLEET_LINK_BASELINE_BPS = MetricSpec(
    "kts_fleet_link_baseline_bytes_per_second",
    MetricType.GAUGE,
    "Per-link rolling reference rate (EWMA across both endpoints' "
    "views, warmup-gated, counter-reset tolerant) the localization "
    "pass scores observations against. While a link is degraded the "
    "reference folds 16x slower, so a sick link cannot drag its own "
    "baseline down and self-clear.",
    extra_labels=("link",),
)
FLEET_LINK_BASELINE_BAND = MetricSpec(
    "kts_fleet_link_baseline_band_bytes_per_second",
    MetricType.GAUGE,
    "Per-link MAD tolerance band (robust sigma over the recent healthy "
    "window, floored at 2% of the reference) around "
    "kts_fleet_link_baseline_bytes_per_second. A link degrades when "
    "both endpoints fall below baseline - max(6 * band, 25% of "
    "baseline).",
    extra_labels=("link",),
)
FLEET_LINK_OBSERVED_BPS = MetricSpec(
    "kts_fleet_link_observed_bytes_per_second",
    MetricType.GAUGE,
    "Latest per-link ICI rate as the localization pass sees it: each "
    "endpoint's accelerator_ici_link_bandwidth series mapped onto the "
    "shared graph edge and averaged. Plot against the baseline/band "
    "pair to watch a verdict form.",
    extra_labels=("link",),
)

FLEET_LINK_METRICS: tuple[MetricSpec, ...] = (
    FLEET_LINKS,
    FLEET_LINK_SUSPECT,
    FLEET_LINK_BASELINE_BPS,
    FLEET_LINK_BASELINE_BAND,
    FLEET_LINK_OBSERVED_BPS,
)

# Fleet-efficiency families (efficiency.py): per-pod waste
# scoring driven from the hub refresh — who is holding chips without
# using them. Per-pod exports are bounded to the waste top-K
# (--waste-top-k), so a big fleet cannot label-bomb the hub's own
# exposition with one series per pod.

FLEET_EFFICIENCY_SCORE = MetricSpec(
    "kts_fleet_efficiency_score",
    MetricType.GAUGE,
    "Per-pod efficiency score in [0, 1] from the hub's efficiency "
    "lens: EWMA-smoothed MXU duty (as a fraction of 100) scaled by "
    "step progress when the pod exports a step counter — 1.0 is a pod "
    "earning its chips, ~0 is a pod holding them idle. Exported for "
    "the waste top-K only (--waste-top-k bounds the per-pod series); "
    "the full ledger is at /debug/fleet under 'efficiency' and in "
    "`doctor --efficiency`. Pods with no duty evidence and no energy "
    "coverage score UNKNOWN and are absent here, never 0.",
    extra_labels=("pod", "namespace"),
)
FLEET_EFFICIENCY_STEPS_PER_JOULE = MetricSpec(
    "kts_fleet_efficiency_steps_per_joule",
    MetricType.GAUGE,
    "Goodput per watt, per pod: the EWMA step rate divided by the "
    "EWMA power draw of the chips the pod holds (steps/s per W = "
    "steps per joule). Absent while the pod exports no step counter "
    "or no power reading — a missing input must read as 'unknown', "
    "not as zero goodput. Waste top-K pods only.",
    extra_labels=("pod", "namespace"),
)
FLEET_EFFICIENCY_STEPS_PER_CHIP_HOUR = MetricSpec(
    "kts_fleet_efficiency_steps_per_chip_hour",
    MetricType.GAUGE,
    "Goodput per reserved chip, per pod: the EWMA step rate times "
    "3600 divided by the chips the pod holds — the bill-shaped "
    "denominator (a pod wastes chip-hours whether or not it draws "
    "power). Absent without a step counter. Waste top-K pods only.",
    extra_labels=("pod", "namespace"),
)
FLEET_EFFICIENCY_UNKNOWN = MetricSpec(
    "kts_fleet_efficiency_unknown_pods",
    MetricType.GAUGE,
    "Pods the efficiency lens refuses to score this refresh: no duty "
    "evidence from any of the pod's chips AND zero energy coverage "
    "(collector degraded, burst disarmed). UNKNOWN is deliberately "
    "not wasteful — a degraded telemetry store must never page a "
    "healthy tenant — so these pods are excluded from the waste "
    "ranking until evidence returns.",
)
FLEET_WASTE_SUSPECT = MetricSpec(
    "kts_fleet_waste_suspect",
    MetricType.GAUGE,
    "1 while the efficiency lens accuses this pod of wasting its "
    "chips; reason is 'idle-reservation' (duty ~0 for "
    "--waste-idle-refreshes consecutive refreshes on a pod past the "
    "--waste-warmup-refreshes gate) or 'low-goodput' (power drawn "
    "and duty up, step counter flat). Falls to 0 on recovery (the "
    "series persists as a tombstone so history lookback sees the "
    "clear); edge-journaled as fleet_waste / fleet_waste_cleared and "
    "recorded into the history ring so `doctor --efficiency --at` "
    "answers retroactively.",
    extra_labels=("pod", "namespace", "reason"),
)
FLEET_WASTE_CHIPS = MetricSpec(
    "kts_fleet_waste_chips",
    MetricType.GAUGE,
    "Chips the efficiency lens scores as wasted per pod: "
    "(1 - efficiency score) times the chips the pod holds, exported "
    "for the waste top-K ranking (--waste-top-k). Sum it for the "
    "fleet's idle-reservation bill; the per-pod detail rides "
    "/debug/fleet and `doctor --efficiency`.",
    extra_labels=("pod", "namespace"),
)
FLEET_WASTE_PODS = MetricSpec(
    "kts_fleet_waste_pods",
    MetricType.GAUGE,
    "Pods currently under an active waste verdict (idle-reservation "
    "or low-goodput). 0 is the healthy steady state; alert on "
    "sustained nonzero and walk `doctor --efficiency` for the guilty "
    "pod.",
)

FLEET_EFFICIENCY_METRICS: tuple[MetricSpec, ...] = (
    FLEET_EFFICIENCY_SCORE,
    FLEET_EFFICIENCY_STEPS_PER_JOULE,
    FLEET_EFFICIENCY_STEPS_PER_CHIP_HOUR,
    FLEET_EFFICIENCY_UNKNOWN,
    FLEET_WASTE_SUSPECT,
    FLEET_WASTE_CHIPS,
    FLEET_WASTE_PODS,
)

# History ring + /query serving families (history.py): the
# hub's embedded lookback store and its read-admission layer.

HISTORY_SERIES = MetricSpec(
    "kts_history_series",
    MetricType.GAUGE,
    "Series identities (family + labels) the history ring currently "
    "holds slabs for. Bounded by --history-series-max; at the cap new "
    "identities either reclaim a stale slab "
    "(kts_history_series_evicted_total) or are shed "
    "(kts_history_series_shed_total) — this gauge never exceeds the "
    "cap.",
)
HISTORY_BYTES = MetricSpec(
    "kts_history_bytes",
    MetricType.GAUGE,
    "Bytes of preallocated ring slab the history store holds: series "
    "count times the fixed per-series cost across every tier. Flat by "
    "construction once the fleet's identities are admitted — growth "
    "here is a bug, not load.",
)
HISTORY_SAMPLES = MetricSpec(
    "kts_history_samples_total",
    MetricType.COUNTER,
    "Rollup samples folded into the history ring at publish time. "
    "Rises by roughly (tracked series) per hub refresh; a stall while "
    "refreshes continue means the ring is disabled or shedding.",
)
HISTORY_SERIES_SHED = MetricSpec(
    "kts_history_series_shed_total",
    MetricType.COUNTER,
    "History samples dropped because the series cap was reached and no "
    "slab was stale enough to reclaim. The live fleet view is "
    "unaffected (the ring only serves /query lookback); raise "
    "--history-series-max if the fleet legitimately outgrew it.",
)
HISTORY_SERIES_EVICTED = MetricSpec(
    "kts_history_series_evicted_total",
    MetricType.COUNTER,
    "History series whose slab was reclaimed for a new identity after "
    "sitting idle past the reclaim age — the expected steady cost of "
    "target churn under a fixed-memory ring. Lookback for the evicted "
    "identity is gone; the memory bound is the point.",
)
QUERY_REQUESTS = MetricSpec(
    "kts_query_requests_total",
    MetricType.COUNTER,
    "GET /query requests received, before admission — the read-side "
    "demand signal. Compare with kts_query_shed_total for the shed "
    "fraction and kts_query_cache_hits_total for how many of the "
    "admitted were a pre-rendered dict hit.",
)
QUERY_SHED = MetricSpec(
    "kts_query_shed_total",
    MetricType.COUNTER,
    "/query requests answered 429 + Retry-After by the per-client "
    "token gate (--history-query-qps/--history-query-burst). One "
    "misconfigured dashboard polling at 100 Hz sheds here without "
    "starving scrapes; triage: OPERATIONS.md 'Dashboard serving & "
    "time travel'.",
)
QUERY_CACHE_HITS = MetricSpec(
    "kts_query_cache_hits_total",
    MetricType.COUNTER,
    "/query range responses served from the per-(family, window, "
    "generation) pre-rendered + pre-gzipped cache — a dict hit and a "
    "sendall, no render. The expected overwhelming majority under a "
    "dashboard stampede.",
)
QUERY_CACHE_MISSES = MetricSpec(
    "kts_query_cache_misses_total",
    MetricType.COUNTER,
    "/query range responses that built (rendered + gzipped) their "
    "payload — first read of a (family, window) after a publish. "
    "Bounded by families x windows per generation; a rate far above "
    "the refresh rate means the cache key space is being outpaced.",
)

HISTORY_METRICS: tuple[MetricSpec, ...] = (
    HISTORY_SERIES,
    HISTORY_BYTES,
    HISTORY_SAMPLES,
    HISTORY_SERIES_SHED,
    HISTORY_SERIES_EVICTED,
    QUERY_REQUESTS,
    QUERY_SHED,
    QUERY_CACHE_HITS,
    QUERY_CACHE_MISSES,
)

HUB_METRICS: tuple[MetricSpec, ...] = (
    HUB_TARGET_UP,
    HUB_TARGET_FETCH_SECONDS,
    HUB_TARGETS,
    HUB_WORKERS_EXPECTED,
    HUB_DUPLICATE_SERIES,
    HUB_CHIPS,
    HUB_CHIPS_UP,
    HUB_WORKERS,
    HUB_DUTY_MEAN,
    HUB_DUTY_MIN,
    HUB_MFU_MEAN,
    HUB_MFU_MIN,
    HUB_DUTY_MAX,
    HUB_MEMORY_USED,
    HUB_MEMORY_TOTAL,
    HUB_POWER,
    HUB_ENERGY,
    HUB_ICI_BANDWIDTH,
    HUB_WORKER_STEPS,
    HUB_STRAGGLER_RATIO,
    HUB_REFRESH_DURATION,
    HUB_BODY_CACHE_HITS,
    HUB_PARSE_SECONDS,
    DELTA_FRAMES,
    DELTA_BYTES,
    HUB_RESYNC,
    HUB_DUP_SLICE,
    DELTA_PUSH_TARGETS,
    INGEST_LANES,
    INGEST_LANE_SESSIONS,
    INGEST_LANE_FRAMES,
    INGEST_LANE_APPLY_SECONDS,
    INGEST_NATIVE,
    INGEST_PROCS,
    INGEST_PROC_UP,
    INGEST_PROC_FRAMES,
    INGEST_PROC_ACCEPTED,
    INGEST_PROC_SHED,
    INGEST_PROC_BYTES,
    INGEST_SHED,
    INGEST_QUARANTINED,
    CARDINALITY_SHED,
    CARDINALITY_EVICTED,
    SOURCE_SERIES,
    HUB_WARM_RESTART_SESSIONS,
    HUB_WARM_RESTART_PENDING,
    HUB_WARM_RESTART_REPLAY_SECONDS,
    HUB_WARM_RESTART_CHECKPOINT_WRITES,
    HUB_WARM_RESTART_CHECKPOINT_AGE,
    FLEET_VERSION_COUNT,
    FLEET_TARGETS_ANOMALOUS,
    FLEET_ANOMALIES,
    FLEET_SLO_BURN,
    FLEET_SLO_BAD,
    FLEET_WORST_TICK,
    *FLEET_LINK_METRICS,
    *FLEET_EFFICIENCY_METRICS,
    *HISTORY_METRICS,
)

# Buckets for hub_refresh_duration_seconds: a refresh crosses the network
# once per target, so the range sits above the render buckets and below
# typical refresh intervals.
HUB_REFRESH_BUCKETS: tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Buckets for kts_hub_parse_seconds: one target's exposition is tens of
# KB (a few thousand lines), so a parse sits well under the refresh
# buckets — resolve from ~0.1 ms (small body, warm caches) to the
# tens-of-ms pathological case (huge body, cold intern pools).
HUB_PARSE_BUCKETS: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
)


# --- Exporter self-observability (SURVEY.md §5) ----------------------------

SELF_POLL_DURATION = MetricSpec(
    "collector_poll_duration_seconds",
    MetricType.HISTOGRAM,
    "Wall time of one full poll tick over all local devices. The north-star "
    "budget is p50 < 0.050s at 1 Hz (BASELINE.md).",
)
SELF_SCRAPE_DURATION = MetricSpec(
    "collector_scrape_duration_seconds",
    MetricType.HISTOGRAM,
    "Wall time to render (and, for HTTP, compress) one snapshot per output "
    "path (http scrape, textfile, pushgateway, remote_write). The render "
    "half of the north-star scrape-latency metric; collect-side wall time "
    "is collector_poll_duration_seconds.",
    extra_labels=("output",),
)
SELF_RENDERED_BYTES = MetricSpec(
    "collector_rendered_bytes_total",
    MetricType.COUNTER,
    "Cumulative bytes produced by snapshot rendering per output path "
    "(post-compression where the path compresses). Rising per-render size "
    "means series growth — the thing that silently eats the scrape "
    "budget.",
    extra_labels=("output",),
)
SELF_SCRAPES_REJECTED = MetricSpec(
    "collector_scrapes_rejected_total",
    MetricType.COUNTER,
    "Scrapes answered 503 by the --max-concurrent-scrapes storm guard. "
    "A nonzero rate means something is scraping far too hard (second "
    "Prometheus, misconfigured SD) and real scrapes are seeing gaps.",
)
RENDER_CACHE_HITS = MetricSpec(
    "kts_render_cache_hits_total",
    MetricType.COUNTER,
    "Renders served from the per-generation exposition cache: the snapshot "
    "generation had already been rendered (and, for compressed scrapes, "
    "gzipped) in this shape, so the reader got the memoized bytes. N "
    "concurrent scrapers per publish cost one render instead of N.",
)
SCRAPE_NOT_MODIFIED = MetricSpec(
    "kts_scrape_not_modified_total",
    MetricType.COUNTER,
    "Conditional reads answered 304 Not Modified per path: the "
    "client's If-None-Match named the current render generation's "
    "ETag, so the response cost zero render, zero gzip, and zero "
    "body transfer. The cheapest possible scrape — a high ratio "
    "under a steady generation is the read path working as designed "
    "(ISSUE 18); details: OPERATIONS.md 'Dashboard serving & time "
    "travel'.",
    extra_labels=("path",),
)
RENDER_CACHE_MISSES = MetricSpec(
    "kts_render_cache_misses_total",
    MetricType.COUNTER,
    "Renders that actually serialized the snapshot (first read of a "
    "generation in a given shape). At most a few per publish — one per "
    "(format, compression) shape in use; a rate far above the publish "
    "rate means readers are outpacing the cache key space.",
)
SELF_POLL_ERRORS = MetricSpec(
    "collector_poll_errors_total",
    MetricType.COUNTER,
    "Device-sample failures observed by the poll loop.",
    extra_labels=("reason",),
)
TICK_PLAN_COMPILES = MetricSpec(
    "kts_tick_plan_compiles_total",
    MetricType.COUNTER,
    "Per-device tick-plan compilations (pre-joined label tuples, "
    "pre-rendered series prefixes, cached series slots) by reason: "
    "'device' (new/rediscovered device, no plan existed), 'attribution' "
    "(the device's pod attribution changed, label join recompiled), "
    "'reconfig' (drop-label/metric-filter reconfiguration invalidated "
    "every plan; counted per device recompiled). Steady state is a "
    "one-time burst at startup and a "
    "blip on pod (re)scheduling; a rate tracking the tick rate is a "
    "compile storm — every tick is paying full label-build cost (see "
    "docs/OPERATIONS.md).",
    extra_labels=("reason",),
)
TICK_PLAN_CACHE_HITS = MetricSpec(
    "kts_tick_plan_cache_hits_total",
    MetricType.COUNTER,
    "Device ticks served by an already-compiled tick plan (the snapshot "
    "build wrote values into cached slots instead of rebuilding label "
    "lists and series identity). Healthy steady state: rises by "
    "device-count every tick while kts_tick_plan_compiles_total stays "
    "flat.",
)
TICK_PHASE_SECONDS = MetricSpec(
    "kts_tick_phase_seconds",
    MetricType.GAUGE,
    "Flight-recorder phase-duration digest: bucketed p50/p99 (values are "
    "the recorder's fixed bucket upper bounds) plus the exact observed "
    "max per recorded phase, cumulative over the process lifetime. The "
    "compact self-export of /debug/ticks that lets the hub's fleet lens "
    "do cross-node slow-node attribution without scraping every "
    "worker's debug endpoint. Absent until a first tick has recorded; "
    "absent entirely under --no-trace.",
    extra_labels=("phase", "quantile"),
)
SLOWEST_TICK_SECONDS = MetricSpec(
    "kts_slowest_tick_seconds",
    MetricType.GAUGE,
    "Duration of the slowest tick/cycle in the flight recorder's ring, "
    "labeled with that tick's worst phase and its blame span "
    "('port=8431' / 'device=3' / 'target=<url>', empty when no span "
    "carried a responsible party). The one-series slow-tick summary the "
    "hub folds into kts_fleet_worst_tick_seconds; label values follow "
    "the ring (forensic state, latest wins). Absent until a tick has "
    "recorded; absent under --no-trace.",
    extra_labels=("phase", "blame"),
)
TRACE_DROPPED_SPANS = MetricSpec(
    "kts_trace_dropped_spans_total",
    MetricType.COUNTER,
    "Spans the flight recorder dropped because one tick/cycle trace (or "
    "the cross-thread side buffer) hit its span cap. Nonzero means "
    "/debug/trace and the /debug/ticks phase stats are truncating — the "
    "recorded traces stay valid, just incomplete. Steady state is 0; "
    "see docs/OPERATIONS.md (flight recorder).",
)
RPC_BATCHED_FAMILIES = MetricSpec(
    "kts_rpc_batched_families",
    MetricType.GAUGE,
    "Metric families the runtime served through the single batched "
    "(empty-selector) RPC per port in the last completed fetch. 0 means "
    "the runtime rejected the batched form and the collector is on the "
    "per-metric burst fallback — one pipelined RPC per family per port "
    "per tick instead of one per port.",
)
# Burst-sampler families (burstsampler.py): sub-tick power
# shape from the high-rate sampling ring, folded at each poll tick so
# Prometheus sees transients without sub-tick scrape rates. Per-device
# (chip label); absent for a device until its first folded sample.

BURST_WATTS = MetricSpec(
    "kts_power_burst_watts",
    MetricType.GAUGE,
    "Per-device power statistics over the last poll tick's burst-sample "
    "fold (stat = min/mean/max), from the 100 Hz+ sampling ring. The "
    "max is the headline: a sub-second spike invisible to the 1 Hz "
    "accelerator_power_watts gauge (it samples at tick instants) shows "
    "up here at its true height. Holds the last armed window's values "
    "between windows; kts_power_burst_samples_total says whether new "
    "data arrived.",
    extra_labels=("chip", "stat"),
)
BURST_HIST = MetricSpec(
    "kts_power_burst_watts_distribution",
    MetricType.HISTOGRAM,
    "Cumulative fixed-bucket distribution of burst power samples per "
    "device, in watts. The sub-tick shape series: "
    "histogram_quantile() over it answers 'how often does this chip "
    "spike past the breaker budget' at scrape-rate cost.",
    extra_labels=("chip",),
)
BURST_SAMPLES = MetricSpec(
    "kts_power_burst_samples_total",
    MetricType.COUNTER,
    "Burst samples folded into the per-device distribution since the "
    "exporter started. rate() of this is the achieved sampling rate "
    "while armed (compare --burst-hz); flat means the sampler is "
    "disarmed.",
    extra_labels=("chip",),
)
BURST_ARMED = MetricSpec(
    "kts_power_burst_armed",
    MetricType.GAUGE,
    "1 while the burst sampler is armed (demand/anomaly window open, or "
    "--burst-mode continuous), else 0.",
)
BURST_ARMS = MetricSpec(
    "kts_power_burst_arms_total",
    MetricType.COUNTER,
    "Burst-sampler arm transitions by reason: 'demand' (/debug/burst or "
    "doctor), 'anomaly' (auto-armed by a power/duty-shaped "
    "fleet_anomaly event in the journal), 'continuous' (armed at "
    "startup by --burst-mode continuous).",
    extra_labels=("reason",),
)

# Energy-accounting families (energy.py): per-pod joules that
# survive restarts, with an attestable signed digest at /debug/energy.

ENERGY_POD = MetricSpec(
    "kts_energy_pod_joules_total",
    MetricType.COUNTER,
    "Energy attributed to this pod on this node, in joules: per-device "
    "power integrated trapezoidally over burst samples when the burst "
    "sampler is armed (true transient area), rectangle over the tick "
    "gauge otherwise, attributed through the kubelet device mapping at "
    "integration time. Empty pod/namespace = unattributed draw. "
    "MONOTONE ACROSS RESTARTS when --energy-checkpoint is set (the "
    "write-ahead checkpoint replays on startup) — the audit-grade "
    "companion to accelerator_energy_joules_total, which resets.",
    extra_labels=("pod", "namespace"),
)
ENERGY_COVERAGE = MetricSpec(
    "kts_energy_coverage_ratio",
    MetricType.GAUGE,
    "Fraction of integrated energy time covered by sub-tick burst "
    "samples (0-1, cumulative). 1.0 = every joule was integrated over "
    "100 Hz+ samples; near 0 = tick-rectangle fidelity only. Rides the "
    "signed /debug/energy digest so an auditor can weight the bill's "
    "fidelity.",
)
ENERGY_CHECKPOINT_WRITES = MetricSpec(
    "kts_energy_checkpoint_writes_total",
    MetricType.COUNTER,
    "Energy checkpoint files written (wal + fsync + atomic rename). "
    "Flat while --energy-checkpoint is set means persistence is "
    "failing and a restart will lose the accumulated window — see the "
    "warning log.",
)
ENERGY_CHECKPOINT_AGE = MetricSpec(
    "kts_energy_checkpoint_age_seconds",
    MetricType.GAUGE,
    "Seconds since the last successful energy checkpoint write. Absent "
    "until the first write; alert when it grows far past "
    "--energy-checkpoint-interval.",
)

# Host-signals families (hoststats.py): the per-node half of
# straggler root-cause — PSI pressure, IRQ/softirq rates, NIC errors,
# thermal throttle, per-pod cgroup v2 stats — sampled once per tick off
# the hot path and time-aligned with the flight recorder's tick traces.
# Every family degrades to absent (never an error) on hosts missing the
# backing /proc//sys file; see docs/OPERATIONS.md "Host triage".

HOST_PRESSURE = MetricSpec(
    "kts_host_pressure_share",
    MetricType.GAUGE,
    "Linux PSI pressure share (0-100) from /proc/pressure/<resource>: "
    "percent of the window some/all runnable tasks stalled on the "
    "resource (kind 'some') or every non-idle task stalled at once "
    "(kind 'full' — the whole host made no progress). The headline "
    "host root-cause signal: a memory 'full' share in the double "
    "digits during a slow tick means the node was reclaim-stalled, "
    "not the accelerator. Absent on pre-4.20 kernels (no "
    "/proc/pressure).",
    extra_labels=("resource", "kind", "window"),
)
HOST_PRESSURE_STALL = MetricSpec(
    "kts_host_pressure_stall_seconds_total",
    MetricType.COUNTER,
    "Cumulative PSI stall time per resource and kind, in seconds (the "
    "total= field of /proc/pressure/<resource>, kernel-reported "
    "microseconds). rate() of this is the exact stall fraction — the "
    "avg10/avg60 shares are the kernel's own EWMA of the same signal.",
    extra_labels=("resource", "kind"),
)
HOST_INTERRUPTS = MetricSpec(
    "kts_host_interrupts_total",
    MetricType.COUNTER,
    "Cumulative interrupts serviced by this host since boot "
    "(/proc/stat intr/softirq totals), by kind 'hard' or 'soft'.",
    extra_labels=("kind",),
)
HOST_IRQ_RATE = MetricSpec(
    "kts_host_irq_rate",
    MetricType.GAUGE,
    "Interrupts per second over the last host-stats sampling interval "
    "(delta of /proc/stat intr/softirq totals), by kind 'hard' or "
    "'soft'. An IRQ storm steals the CPU the runtime's feeder threads "
    "need — the classic invisible straggler cause. Absent until two "
    "samples exist.",
    extra_labels=("kind",),
)
HOST_SOFTIRQ_RATE = MetricSpec(
    "kts_host_softirq_rate",
    MetricType.GAUGE,
    "Per-type softirqs per second over the last host-stats sampling "
    "interval (/proc/softirqs deltas summed over CPUs; type is the "
    "kernel's row name, e.g. NET_RX, TIMER). Names WHICH softirq is "
    "storming when kts_host_irq_rate{kind='soft'} spikes.",
    extra_labels=("type",),
)
HOST_NIC_ERRORS = MetricSpec(
    "kts_host_nic_errors_total",
    MetricType.COUNTER,
    "Cumulative NIC errors per interface and direction "
    "(/sys/class/net/<dev>/statistics/{rx,tx}_errors; loopback "
    "excluded). Nonzero rate on the DCN-facing NIC during a slow "
    "collective is a fabric problem, not a chip problem.",
    extra_labels=("device", "direction"),
)
HOST_NIC_DROPS = MetricSpec(
    "kts_host_nic_drops_total",
    MetricType.COUNTER,
    "Cumulative NIC packet drops per interface and direction "
    "(/sys/class/net/<dev>/statistics/{rx,tx}_dropped; loopback "
    "excluded).",
    extra_labels=("device", "direction"),
)
HOST_NIC_DROP_RATE = MetricSpec(
    "kts_host_nic_drop_rate",
    MetricType.GAUGE,
    "Packets per second dropped across every non-loopback NIC over the "
    "last host-stats sampling interval — the one-series NIC health "
    "signal the hub's fleet lens baselines per node. Absent until two "
    "samples exist.",
)
HOST_THERMAL_ZONE = MetricSpec(
    "kts_host_thermal_zone_celsius",
    MetricType.GAUGE,
    "Host thermal zone temperature in degrees Celsius "
    "(/sys/class/thermal/thermal_zone*/temp; zone is the sysfs index, "
    "type the kernel's zone type string). The HOST-side heat picture "
    "next to the chip's own accelerator_temperature_celsius.",
    extra_labels=("zone", "type"),
)
HOST_THROTTLE_EVENTS = MetricSpec(
    "kts_host_cpu_throttle_events_total",
    MetricType.COUNTER,
    "Cumulative CPU thermal-throttle events summed over CPUs, by scope "
    "'core' or 'package' (/sys/devices/system/cpu/cpu*/thermal_throttle/"
    "*_throttle_count). A throttled host CPU starves the runtime's "
    "feeder threads while every accelerator gauge reads healthy.",
    extra_labels=("scope",),
)
HOST_THROTTLE_RATE = MetricSpec(
    "kts_host_cpu_throttle_rate",
    MetricType.GAUGE,
    "CPU thermal-throttle events per second over the last host-stats "
    "sampling interval (all scopes summed) — the throttle-edge signal "
    "the hub's fleet lens baselines per node. Absent until two samples "
    "exist.",
)
HOST_POD_CPU = MetricSpec(
    "kts_host_pod_cpu_seconds_total",
    MetricType.COUNTER,
    "Cumulative CPU time consumed by this pod's cgroup (cgroup v2 "
    "cpu.stat usage_usec), joined to pod/namespace through the kubelet "
    "attribution mapping where a holder process ties the pod UID to an "
    "attributed device (labels empty when the join has no answer). "
    "The noisy-co-tenant ledger: a bystander pod burning the host CPU "
    "shows up here while the accelerator pod's gauges look idle.",
    extra_labels=("pod", "namespace", "pod_uid"),
)
HOST_POD_THROTTLED = MetricSpec(
    "kts_host_pod_cpu_throttled_seconds_total",
    MetricType.COUNTER,
    "Cumulative seconds this pod's cgroup spent CPU-throttled by its "
    "quota (cgroup v2 cpu.stat throttled_usec). A training pod with a "
    "rising rate here is starved by its own limits, not the node.",
    extra_labels=("pod", "namespace", "pod_uid"),
)
HOST_POD_MEMORY = MetricSpec(
    "kts_host_pod_memory_bytes",
    MetricType.GAUGE,
    "Current memory charged to this pod's cgroup (cgroup v2 "
    "memory.current). Against the node's PSI memory pressure this "
    "names WHICH pod is driving reclaim.",
    extra_labels=("pod", "namespace", "pod_uid"),
)
HOST_POD_IO = MetricSpec(
    "kts_host_pod_io_bytes_total",
    MetricType.COUNTER,
    "Cumulative block-IO bytes per pod cgroup and direction (cgroup v2 "
    "io.stat rbytes/wbytes summed over devices). The checkpoint-storm "
    "signal next to PSI io pressure.",
    extra_labels=("pod", "namespace", "pod_uid", "direction"),
)
HOST_RUNQ_LATENCY = MetricSpec(
    "kts_host_runq_latency_seconds",
    MetricType.GAUGE,
    "Scheduler run-queue latency quantiles from the optional "
    "eBPF-backed source (runqlat-style): how long runnable tasks "
    "waited for a CPU over the last sampling window. Only present "
    "when the capability probe finds a working eBPF toolchain (see "
    "/debug/host 'ebpf'); absent otherwise — the collector never "
    "fails for lack of it.",
    extra_labels=("quantile",),
)

HOST_METRICS: tuple[MetricSpec, ...] = (
    HOST_PRESSURE,
    HOST_PRESSURE_STALL,
    HOST_INTERRUPTS,
    HOST_IRQ_RATE,
    HOST_SOFTIRQ_RATE,
    HOST_NIC_ERRORS,
    HOST_NIC_DROPS,
    HOST_NIC_DROP_RATE,
    HOST_THERMAL_ZONE,
    HOST_THROTTLE_EVENTS,
    HOST_THROTTLE_RATE,
    HOST_POD_CPU,
    HOST_POD_THROTTLED,
    HOST_POD_MEMORY,
    HOST_POD_IO,
    HOST_RUNQ_LATENCY,
)

SELF_DEVICES = MetricSpec(
    "collector_devices",
    MetricType.GAUGE,
    "Number of accelerator devices discovered on this node.",
)
SELF_INFO = MetricSpec(
    "collector_build_info",
    MetricType.GAUGE,
    "Constant 1; build/runtime identity in labels.",
    extra_labels=("version", "backend"),
)
SELF_ALLOCATABLE = MetricSpec(
    "collector_allocatable_devices",
    MetricType.GAUGE,
    "Accelerator devices the kubelet reports as allocatable on this node, "
    "per resource class. Divergence from collector_devices signals a "
    "device-plugin/driver disagreement.",
    extra_labels=("resource",),
)

SELF_PUSH_TOTAL = MetricSpec(
    "collector_push_total",
    MetricType.COUNTER,
    "Completed pushes per shipping mode (pushgateway, remote_write).",
    extra_labels=("mode",),
)
SELF_PUSH_FAILURES = MetricSpec(
    "collector_push_failures_total",
    MetricType.COUNTER,
    "Failed (retryable) pushes per shipping mode — receiver down, "
    "transport error, 5xx/429.",
    extra_labels=("mode",),
)
SELF_PUSH_DROPPED = MetricSpec(
    "collector_push_dropped_total",
    MetricType.COUNTER,
    "Sample sets dropped as non-retryable per shipping mode (remote-write "
    "spec: 4xx other than 429 means the payload, not the network).",
    extra_labels=("mode",),
)
DELTA_SHED_HONORED = MetricSpec(
    "kts_delta_shed_honored_total",
    MetricType.COUNTER,
    "Delta-push frames the hub refused at admission (429/503 + "
    "Retry-After) that this publisher honored: the push was deferred a "
    "decorrelated-jitter spread of the hub's hint and the next frame "
    "re-diffed against the acked state — NOT promoted to a FULL (that "
    "would amplify the load being shed) and NOT counted as a push "
    "failure (the hub is healthy, it is shaping load). A sustained "
    "rate across the fleet means the hub's admission knobs are too "
    "tight for the fleet's cadence (ISSUE 12).",
    extra_labels=("mode",),
)
# Egress-durability families: the node-side spill queue
# (spillq.py — a partitioned publisher's late-but-complete record) and
# the WAL-backed sharded remote_write exporter (remote_write.py). Both
# ends of the data path self-report their backlog, their lag, and —
# critically — their accounted loss: a bounded queue that drops silently
# is a hole, one that counts and journals is an audit line.

SPILL_FRAMES = MetricSpec(
    "kts_spill_frames_total",
    MetricType.COUNTER,
    "Delta-push snapshots through the disk spill queue, by state: "
    "'spooled' (published while the hub link was down — written to the "
    "bounded on-disk ring instead of dropped), 'drained' (sent to "
    "the hub on reconnect, oldest-first, drain-rate limited), "
    "'reencoded' (old-format spooled wire frames whose FULL body was "
    "recovered and re-sent at the negotiated wire version — a "
    "mid-rollout spool replays, it doesn't rot), and 'undecodable' "
    "(CRC-valid records no decoder in this build understands — "
    "version skew; doctor --egress points at doctor --skew). spooled "
    "minus drained minus kts_spill_dropped_total is the live backlog "
    "(kts_spill_depth_frames).",
    extra_labels=("state",),
)
SPILL_DROPPED = MetricSpec(
    "kts_spill_dropped_total",
    MetricType.COUNTER,
    "Spooled snapshots dropped OLDEST-FIRST because the spill queue hit "
    "--hub-spill-max-bytes: the partition outlasted the spool bound, "
    "and this counter (plus the spill_drop journal event) is the "
    "accounting for exactly how much record was lost. Size the bound "
    "from the OPERATIONS.md spool table so the partitions you plan for "
    "fit; alert on any increase (SpillDataLoss).",
)
SPILL_DEPTH = MetricSpec(
    "kts_spill_depth_frames",
    MetricType.GAUGE,
    "Snapshots currently spooled on disk awaiting drain. 0 when the "
    "hub link is healthy; rising during a partition; falling at "
    "--hub-drain-rate after reconnect. Near the byte bound "
    "(kts_spill_bytes vs the configured max) means the next frames "
    "start dropping oldest-first (SpillNearFull).",
)
SPILL_BYTES = MetricSpec(
    "kts_spill_bytes",
    MetricType.GAUGE,
    "Bytes the spill queue holds on disk (snappy-compressed snapshots "
    "+ record framing), against --hub-spill-max-bytes.",
)
SPILL_OLDEST = MetricSpec(
    "kts_spill_oldest_seconds",
    MetricType.GAUGE,
    "Age of the oldest spooled snapshot — how far behind this node's "
    "contribution to the fleet record currently is. Falls to 0 as the "
    "drain completes; stuck high with a nonzero depth means the drain "
    "is failing (link still down, or the hub shedding hard).",
)
REMOTE_WRITE_SHARDS = MetricSpec(
    "kts_remote_write_shards",
    MetricType.GAUGE,
    "Send shards the durable remote-write exporter runs "
    "(--remote-write-shards): series hash to a shard by identity, each "
    "shard owns its own WAL segment ring, retry/backoff state and "
    "parked-poison ring. Absent in legacy best-effort mode (no "
    "--remote-write-wal-dir).",
)
REMOTE_WRITE_WAL_BYTES = MetricSpec(
    "kts_remote_write_wal_bytes",
    MetricType.GAUGE,
    "Bytes pending in this shard's write-ahead segment ring (encoded, "
    "compressed WriteRequests not yet acknowledged by the receiver). "
    "Bounded by --remote-write-wal-max-bytes per shard; at the bound "
    "the OLDEST segment is evicted whole and counted in "
    "kts_remote_write_dropped_total.",
    extra_labels=("shard",),
)
REMOTE_WRITE_LAG = MetricSpec(
    "kts_remote_write_lag_seconds",
    MetricType.GAUGE,
    "How stale the receiver's view of this shard is: the age of the "
    "oldest still-undelivered WAL request while a backlog exists "
    "(grows through a receiver outage — the case the alert exists "
    "for), else the send-time minus sample-time of the newest "
    "delivered request (~the push interval when healthy). Shrinks as "
    "the drain catches up (RemoteWriteLagHigh alerts on it).",
    extra_labels=("shard",),
)
REMOTE_WRITE_PARKED = MetricSpec(
    "kts_remote_write_parked_total",
    MetricType.COUNTER,
    "Poison requests parked by this shard: the receiver answered a "
    "non-retryable 4xx (bad payload, not a bad network), so retrying "
    "would wedge the queue forever behind one request. The request is "
    "moved to the shard's bounded parked ring for post-mortem and the "
    "drain continues. A steady rate means a schema/receiver mismatch, "
    "not an outage.",
    extra_labels=("shard",),
)
REMOTE_WRITE_DROPPED = MetricSpec(
    "kts_remote_write_dropped_total",
    MetricType.COUNTER,
    "Pending WriteRequests dropped OLDEST-FIRST because a shard's WAL "
    "ring hit its byte bound — the receiver outage outlasted the WAL. "
    "Counted and journaled (remote_write_drop event) so the gap in the "
    "TSDB is an audited number, not a silent hole.",
    extra_labels=("shard",),
)

EGRESS_METRICS: tuple[MetricSpec, ...] = (
    SPILL_FRAMES,
    SPILL_DROPPED,
    SPILL_DEPTH,
    SPILL_BYTES,
    SPILL_OLDEST,
    REMOTE_WRITE_SHARDS,
    REMOTE_WRITE_WAL_BYTES,
    REMOTE_WRITE_LAG,
    REMOTE_WRITE_PARKED,
    REMOTE_WRITE_DROPPED,
)

RENDER_PREWARM_WAIT = MetricSpec(
    "kts_render_prewarm_wait_seconds_total",
    MetricType.COUNTER,
    "Cumulative seconds readers spent waiting to ACQUIRE the publish "
    "lock inside Registry.rendered() — scrapes queueing behind "
    "publishes or the render pre-warmer. ~0 on a healthy process; "
    "growth is the first suspect for scrape-p99 creep (the r07→r09 "
    "watch item), also surfaced in /debug/ticks meta so a post-mortem "
    "needs no profiler.",
)

# Resilience self-metrics (resilience.py / supervisor.py): the unified
# failure policy must self-report, or fleet dashboards silently lie
# about degraded exporters. The component label names an I/O
# edge or worker thread: "poll", "attribution", "remote_write",
# "libtpu:<port>", "kubelet", "target:<url>" (hub).

BREAKER_STATE = MetricSpec(
    "kts_breaker_state",
    MetricType.GAUGE,
    "Circuit-breaker state per I/O edge: 0 closed (healthy), 1 half-open "
    "(probing recovery), 2 open (dependency persistently failing; calls "
    "are refused and the edge serves stale/degraded data). Alert on "
    "sustained 2.",
    extra_labels=("component",),
)
BREAKER_TRIPS = MetricSpec(
    "kts_breaker_trips_total",
    MetricType.COUNTER,
    "Times this edge's circuit breaker tripped open since the exporter "
    "started (consecutive-failure or failure-rate condition met, or a "
    "half-open probe failed).",
    extra_labels=("component",),
)
COMPONENT_RESTARTS = MetricSpec(
    "kts_component_restarts_total",
    MetricType.COUNTER,
    "Times the crash-only supervisor restarted this worker component "
    "(thread dead, or hung past its heartbeat timeout). 0 from first "
    "sight so increase() sees the first restart.",
    extra_labels=("component",),
)
COMPONENT_HEALTHY = MetricSpec(
    "kts_component_healthy",
    MetricType.GAUGE,
    "Supervisor health state per worker component: 1 healthy, 0.5 "
    "degraded (restarted recently or its breaker is not closed), 0 "
    "stale (hung or dead right now). /healthz carries the matching "
    "per-component reason text.",
    extra_labels=("component",),
)

PROCESS_CPU = MetricSpec(
    "process_cpu_seconds_total",
    MetricType.COUNTER,
    "Total user+system CPU time this exporter process has consumed.",
)
PROCESS_RSS = MetricSpec(
    "process_resident_memory_bytes",
    MetricType.GAUGE,
    "Resident memory of the exporter process.",
)
PROCESS_START = MetricSpec(
    "process_start_time_seconds",
    MetricType.GAUGE,
    "Unix time the exporter process started.",
)
PROCESS_VMEM = MetricSpec(
    "process_virtual_memory_bytes",
    MetricType.GAUGE,
    "Virtual memory size of the exporter process.",
)
PROCESS_OPEN_FDS = MetricSpec(
    "process_open_fds",
    MetricType.GAUGE,
    "File descriptors the exporter process holds open. Rising toward "
    "process_max_fds means an fd leak (sockets, procfs scans).",
)
PROCESS_MAX_FDS = MetricSpec(
    "process_max_fds",
    MetricType.GAUGE,
    "Soft limit on open file descriptors for the exporter process.",
)

SELF_METRICS: tuple[MetricSpec, ...] = (
    SELF_POLL_DURATION,
    SELF_SCRAPE_DURATION,
    SELF_RENDERED_BYTES,
    SELF_SCRAPES_REJECTED,
    RENDER_CACHE_HITS,
    RENDER_CACHE_MISSES,
    SCRAPE_NOT_MODIFIED,
    SELF_POLL_ERRORS,
    TICK_PLAN_COMPILES,
    TICK_PLAN_CACHE_HITS,
    TICK_PHASE_SECONDS,
    SLOWEST_TICK_SECONDS,
    TRACE_DROPPED_SPANS,
    RPC_BATCHED_FAMILIES,
    BURST_WATTS,
    BURST_HIST,
    BURST_SAMPLES,
    BURST_ARMED,
    BURST_ARMS,
    ENERGY_POD,
    ENERGY_COVERAGE,
    ENERGY_CHECKPOINT_WRITES,
    ENERGY_CHECKPOINT_AGE,
    SELF_DEVICES,
    SELF_INFO,
    SELF_ALLOCATABLE,
    SELF_PUSH_TOTAL,
    SELF_PUSH_FAILURES,
    SELF_PUSH_DROPPED,
    DELTA_SHED_HONORED,
    SERIES_LIVE,
    CARDINALITY_FENCED,
    *EGRESS_METRICS,
    *SKEW_METRICS,
    *LOCAL_FAULT_METRICS,
    RENDER_PREWARM_WAIT,
    BREAKER_STATE,
    BREAKER_TRIPS,
    COMPONENT_RESTARTS,
    COMPONENT_HEALTHY,
    PROCESS_CPU,
    PROCESS_RSS,
    PROCESS_START,
    PROCESS_VMEM,
    PROCESS_OPEN_FDS,
    PROCESS_MAX_FDS,
)

ALL_METRICS: tuple[MetricSpec, ...] = (
    PER_DEVICE_METRICS + WORKLOAD_HISTOGRAMS + HUB_METRICS + HOST_METRICS
    + SELF_METRICS
)

# Default histogram buckets for collector_poll_duration_seconds. Chosen to
# resolve the 50 ms budget from both sides.
POLL_DURATION_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)

# Buckets for collector_scrape_duration_seconds: renders are ~10x faster
# than a full poll tick, so the range shifts down one decade.
SCRAPE_DURATION_BUCKETS: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
)

# Buckets for kts_power_burst_watts_distribution: watts, spanning an
# idle mobile-class part (~25 W) through a v5p-class chip's sustained
# draw (~500 W) up to inrush-transient territory — the top buckets are
# where the breaker-budget question lives.
BURST_WATTS_BUCKETS: tuple[float, ...] = (
    25.0, 50.0, 75.0, 100.0, 150.0, 200.0, 250.0, 300.0, 400.0, 500.0,
    750.0, 1000.0,
)

# Buckets for accelerator_workload_step_duration_seconds: training/serving
# steps span ~1 ms (small serving batches) to ~10 s (large-model training).
STEP_DURATION_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)

# --- Metric family selection (--metrics-include/--metrics-exclude) --------
# The DCGM-exporter collectors-CSV analog: operators choose which device
# families to export (cardinality/cost control per cluster). Self metrics
# (collector_*/process_*) are never filterable — they are the exporter's
# own health contract — and neither is accelerator_up, the per-device
# health contract every dashboard and alert joins against.

FILTERABLE_METRICS: frozenset[str] = frozenset(
    spec.name for spec in PER_DEVICE_METRICS + WORKLOAD_HISTOGRAMS
    if spec is not DEVICE_UP
)


def resolve_metric_filter(include: Iterable[str],
                          exclude: Iterable[str]) -> frozenset[str]:
    """Turn include/exclude family lists into the set of DISABLED names.

    Entries are exact family names or fnmatch globs (e.g.
    ``accelerator_memory_*``). A non-empty include list enables only the
    named families (plus the unfilterable ones); exclude then subtracts.
    Raises ValueError naming the offending entry — a typo must fail at
    startup, not silently export everything (or nothing).
    """
    import fnmatch

    def expand(patterns: Iterable[str], flag: str) -> set[str]:
        chosen: set[str] = set()
        for raw in patterns:
            pattern = raw.strip()
            if not pattern:
                continue
            if pattern == DEVICE_UP.name:
                raise ValueError(
                    f"{flag}: {DEVICE_UP.name} cannot be filtered — it is "
                    f"the per-device health contract")
            if any(ch in pattern for ch in "*?["):
                hits = fnmatch.filter(FILTERABLE_METRICS, pattern)
                if not hits:
                    raise ValueError(
                        f"{flag}: pattern {pattern!r} matches no filterable "
                        f"metric family")
                chosen.update(hits)
            elif pattern in FILTERABLE_METRICS:
                chosen.add(pattern)
            else:
                raise ValueError(
                    f"{flag}: unknown metric family {pattern!r}; filterable "
                    f"families: {', '.join(sorted(FILTERABLE_METRICS))}")
        return chosen

    disabled: set[str] = set()
    included = expand(include, "--metrics-include")
    if included:
        disabled = set(FILTERABLE_METRICS) - included
    disabled |= expand(exclude, "--metrics-exclude")
    return frozenset(disabled)


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def validate() -> None:
    """Sanity-check the schema tables (run from tests)."""
    seen: set[str] = set()
    for spec in ALL_METRICS:
        if not _NAME_RE.match(spec.name):
            raise ValueError(f"bad metric name: {spec.name!r}")
        if spec.name in seen:
            raise ValueError(f"duplicate metric name: {spec.name!r}")
        seen.add(spec.name)
        for label in spec.extra_labels:
            if not _LABEL_RE.match(label):
                raise ValueError(f"bad label {label!r} on {spec.name}")
        if spec.type is MetricType.COUNTER and not spec.name.endswith("_total"):
            raise ValueError(f"counter {spec.name!r} must end in _total")
    for label in ALL_BASE_LABELS:
        if not _LABEL_RE.match(label):
            raise ValueError(f"bad base label {label!r}")


def escape_label_value(value: str) -> str:
    """Escape a label value per the Prometheus text exposition format."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_labels(labels: Iterable[tuple[str, str]]) -> str:
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}" if inner else ""
