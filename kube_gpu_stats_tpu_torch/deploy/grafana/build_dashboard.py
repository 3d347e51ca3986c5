#!/usr/bin/env python
"""Generates dashboard.json, the H100 exporter's Grafana board.

The reference project's board (its deploy/grafana/build_dashboard.py)
carried over to NVML nodes: the same template variables (datasource,
slice, worker, accel_type), layout rules and fixed 8-slot per-card
palette — an HGX H100 node has 8 cards, and card N always wears slot N.
Its panels on families no H100 node fills (the collective-op counter,
the cross-slice DCN latency, runtime restarts; deploy/assets.py,
FAMILIES_NOT_ON_H100) are left out, and NVLink stands where it names
the TPU interconnect.

Design follows the dataviz method: color is assigned by job, not taste —
per-card series use a fixed 8-slot categorical palette (validated
reference instance, dark-surface steps, slot = chip index, never cycled);
status colors are reserved for up/down; magnitude panels use a single
sequential hue; one axis per panel. Stdlib only. Regenerate with:
python build_dashboard.py
"""

import json
from pathlib import Path

# Validated categorical palette (dark-surface steps), slot order is fixed:
# card N always wears slot N — a filter that hides cards must not repaint
# the survivors.
CHIP_COLORS = [
    "#3987e5",  # 1 blue
    "#d95926",  # 2 orange
    "#199e70",  # 3 aqua
    "#c98500",  # 4 yellow
    "#d55181",  # 5 magenta
    "#008300",  # 6 green
    "#9085e9",  # 7 violet
    "#c3c2b7",  # 8 gray
]
STATUS_GOOD = "#199e70"
STATUS_CRITICAL = "#d55181"
SEQUENTIAL_HUE = "#3987e5"

DS = {"type": "prometheus", "uid": "${datasource}"}
FILTERS = 'slice=~"$slice",worker=~"$worker",accel_type=~"$accel_type"'


def chip_overrides():
    return [
        {
            "matcher": {"id": "byRegexp", "options": f'.*chip="{i}".*'},
            "properties": [
                {"id": "color", "value": {"mode": "fixed", "fixedColor": color}}
            ],
        }
        for i, color in enumerate(CHIP_COLORS)
    ]


def timeseries(title, targets, unit, grid, *, per_chip=True, max_val=None,
               thresholds=None, description="", palette=False,
               right_axis_regex=None, right_axis_max=None):
    field_defaults = {
        "custom": {
            "lineWidth": 2,
            "fillOpacity": 0,
            "pointSize": 4,
            "showPoints": "never",
            "spanNulls": True,
        },
        "unit": unit,
        "min": 0,
        # palette: multi-entity panels (workers, targets) cycle the
        # classic palette; single-quantity panels keep the fixed hue.
        "color": ({"mode": "palette-classic"} if palette
                  else {"mode": "fixed", "fixedColor": SEQUENTIAL_HUE}),
    }
    if max_val is not None:
        field_defaults["max"] = max_val
    if thresholds:
        field_defaults["custom"]["thresholdsStyle"] = {"mode": "line"}
        field_defaults["thresholds"] = {
            "mode": "absolute",
            "steps": [{"color": "transparent", "value": None}]
            + [{"color": STATUS_CRITICAL, "value": v} for v in thresholds],
        }
    return {
        "type": "timeseries",
        "title": title,
        "description": description,
        "datasource": DS,
        "gridPos": grid,
        "fieldConfig": {
            "defaults": field_defaults,
            "overrides": (chip_overrides() if per_chip else [])
            + ([{
                # Series matching the regex ride a right-hand axis so a
                # small-magnitude series isn't flattened under a large
                # left axis (ratio under steps/s, watts under counts).
                "matcher": {"id": "byRegexp", "options": right_axis_regex},
                "properties": [
                    {"id": "custom.axisPlacement", "value": "right"},
                ] + ([{"id": "max", "value": right_axis_max}]
                     if right_axis_max is not None else []),
            }] if right_axis_regex else []),
        },
        "options": {
            "tooltip": {"mode": "multi", "sort": "desc"},
            "legend": {"displayMode": "list", "placement": "bottom",
                       "showLegend": True},
        },
        "targets": [
            {"expr": expr, "legendFormat": legend, "refId": chr(65 + i),
             "datasource": DS}
            for i, (expr, legend) in enumerate(targets)
        ],
    }


def stat(title, expr, unit, grid, *, color=SEQUENTIAL_HUE, description=""):
    return {
        "type": "stat",
        "title": title,
        "description": description,
        "datasource": DS,
        "gridPos": grid,
        "fieldConfig": {
            "defaults": {
                "unit": unit,
                "color": {"mode": "fixed", "fixedColor": color},
                "thresholds": {"mode": "absolute",
                               "steps": [{"color": color, "value": None}]},
            },
            "overrides": [],
        },
        "options": {"reduceOptions": {"calcs": ["lastNotNull"]},
                    "graphMode": "none", "colorMode": "value"},
        "targets": [{"expr": expr, "refId": "A", "datasource": DS}],
    }


def table(title, expr, grid, *, hide_columns=(), description=""):
    """Instant-query table (label-valued data like the process holders —
    a timeseries of constant 1s would be noise)."""
    return {
        "type": "table",
        "title": title,
        "description": description,
        "datasource": DS,
        "gridPos": grid,
        "fieldConfig": {"defaults": {"custom": {"align": "auto"}},
                        "overrides": []},
        "options": {"showHeader": True},
        "targets": [{"expr": expr, "refId": "A", "datasource": DS,
                     "format": "table", "instant": True}],
        "transformations": [{
            "id": "organize",
            "options": {
                "excludeByName": dict.fromkeys(
                    ("Time", "Value", "__name__") + tuple(hide_columns), True
                ),
                "indexByName": {},
                "renameByName": {},
            },
        }],
    }


def template_var(name, label, query):
    return {
        "name": name,
        "label": label,
        "type": "query",
        "datasource": DS,
        "query": {"query": query, "refId": name},
        "refresh": 2,
        "includeAll": True,
        "multi": True,
        "current": {"text": "All", "value": "$__all"},
    }


CARD = 'w{{worker}} card {{chip}}'

panels = [
    # Row 1 — headline stats (stat tiles, not charts: single numbers).
    stat("Cards up",
         f'sum(accelerator_up{{{FILTERS}}})',
         "none", {"x": 0, "y": 0, "w": 4, "h": 4}, color=STATUS_GOOD,
         description="Cards whose last NVML poll succeeded, across the "
                     "slice."),
    stat("Cards stale",
         f'count(accelerator_up{{{FILTERS}}} == 0) OR vector(0)',
         "none", {"x": 4, "y": 0, "w": 4, "h": 4}, color=STATUS_CRITICAL,
         description="Stale/erroring cards (accelerator_up == 0)."),
    stat("Mean duty cycle",
         f'avg(accelerator_duty_cycle{{{FILTERS}}})',
         "percent", {"x": 8, "y": 0, "w": 4, "h": 4},
         description="Slice-wide mean of NVML's utilization.gpu over the "
                     "last sample window."),
    stat("Device memory used",
         f'sum(accelerator_memory_used_bytes{{{FILTERS}}})',
         "bytes", {"x": 12, "y": 0, "w": 4, "h": 4}),
    stat("Total power",
         f'sum(accelerator_power_watts{{{FILTERS}}})',
         "watt", {"x": 16, "y": 0, "w": 4, "h": 4}),
    stat("Collection p50",
         'histogram_quantile(0.5, sum(rate(collector_poll_duration_seconds_bucket[5m])) by (le))',
         "s", {"x": 20, "y": 0, "w": 4, "h": 4},
         description="North-star budget: < 50 ms p50."),

    # Row 2 — core utilization, identity = card (fixed categorical slots).
    timeseries(
        "Duty cycle by card",
        [(f'accelerator_duty_cycle{{{FILTERS}}}', CARD)],
        "percent", {"x": 0, "y": 4, "w": 12, "h": 8}, max_val=100,
        description="Percent of the sample period in which a kernel ran "
                    "on the card (NVML utilization.gpu)."),
    timeseries(
        "Device memory used by card",
        [(f'accelerator_memory_used_bytes{{{FILTERS}}}', CARD)],
        "bytes", {"x": 12, "y": 4, "w": 12, "h": 8},
        description="HBM3 allocated per card, the driver's reservation "
                    "left out; capacity is accelerator_memory_total_bytes."),

    # Row 3 — environment.
    timeseries(
        "Card power",
        [(f'accelerator_power_watts{{{FILTERS}}}', CARD)],
        "watt", {"x": 0, "y": 12, "w": 12, "h": 8}),
    timeseries(
        "Card temperature",
        [(f'accelerator_temperature_celsius{{{FILTERS}}}', CARD)],
        "celsius", {"x": 12, "y": 12, "w": 12, "h": 8}),

    # Row 4 — interconnect and the memory system.
    timeseries(
        "NVLink bandwidth (sum over links, by card)",
        [(f'sum by (worker, chip) (accelerator_ici_link_bandwidth_bytes_per_second{{{FILTERS}}})',
          CARD)],
        "Bps", {"x": 0, "y": 20, "w": 12, "h": 8},
        description="Per-card total NVLink traffic rate (TX + RX); "
                    "per-link series carry link=\"nvlink<N>\" for "
                    "drill-down. A link appears once it has carried "
                    "traffic."),
    timeseries(
        "Memory bandwidth utilization by card",
        [(f'accelerator_memory_bandwidth_utilization{{{FILTERS}}}', CARD)],
        "percent", {"x": 12, "y": 20, "w": 12, "h": 8}, max_val=100,
        description="Percent of peak DRAM bandwidth used (GPM), or, where "
                    "the card refuses GPM, NVML's share of time memory "
                    "was read or written; sustained high values with a "
                    "low duty cycle = memory-bound."),

    # Row 5 — exporter self-observability (single series per panel: no
    # per-card identity; sequential hue).
    timeseries(
        "Collection latency quantiles",
        [('histogram_quantile(0.5, sum(rate(collector_poll_duration_seconds_bucket[5m])) by (le))', 'p50'),
         ('histogram_quantile(0.99, sum(rate(collector_poll_duration_seconds_bucket[5m])) by (le))', 'p99')],
        "s", {"x": 0, "y": 28, "w": 12, "h": 8}, per_chip=False,
        thresholds=[0.050],
        description="Poll-tick wall time; threshold line = 50 ms budget."),
    timeseries(
        "Poll errors / rejected scrapes",
        [('sum by (reason) (rate(collector_poll_errors_total[5m]))',
          '{{reason}}'),
         ('sum(rate(collector_scrapes_rejected_total[5m]))',
          'scrapes rejected (storm guard)')],
        "ops", {"x": 12, "y": 28, "w": 12, "h": 8}, per_chip=False),

    # Row 6 — fleet health cross-checks.
    timeseries(
        "Discovered vs kubelet-allocatable devices",
        [('sum(collector_devices)', 'discovered'),
         ('sum(collector_allocatable_devices{resource="nvidia.com/gpu"})',
          'allocatable (nvidia.com/gpu)')],
        "none", {"x": 0, "y": 36, "w": 12, "h": 8}, per_chip=False,
        description="Divergence = device-plugin/driver disagreement "
                    "(AcceleratorDeviceCountMismatch alert)."),
    timeseries(
        "Exporter memory (RSS)",
        [('process_resident_memory_bytes', '{{instance}}')],
        "bytes", {"x": 12, "y": 36, "w": 12, "h": 8}, per_chip=False),

    # Row 7 — workload view + shipping health.
    table(
        "Processes holding cards (nvidia-smi process table analog)",
        f'accelerator_process_open{{{FILTERS}}}',
        {"x": 0, "y": 44, "w": 12, "h": 8},
        hide_columns=("device_path", "uuid", "instance", "job",
                      "accel_type", "slice", "topology"),
        description="Which process (pid/comm) holds each /dev/nvidia<N> "
                    "open, with pod attribution where kubelet data "
                    "exists. Refreshed on the attribution cadence "
                    "(~10 s)."),
    timeseries(
        "Metric shipping (pushgateway / remote_write)",
        [('sum by (mode) (rate(collector_push_total[5m]))',
          '{{mode}} ok'),
         ('sum by (mode) (rate(collector_push_failures_total[5m]))',
          '{{mode}} failing'),
         ('sum by (mode) (rate(collector_push_dropped_total[5m]))',
          '{{mode}} rejected')],
        "ops", {"x": 12, "y": 44, "w": 12, "h": 8}, per_chip=False,
        description="Push-mode delivery health; failing/rejected map to the "
                    "AcceleratorMetricShipping* alerts. Absent when no "
                    "push mode is configured."),

    # Row 8 — scrape/render self-observability (the render half of the
    # north-star scrape latency; collect half is row 5).
    timeseries(
        "Scrape render latency by output (p99)",
        [('histogram_quantile(0.99, sum by (output, le) '
          '(rate(collector_scrape_duration_seconds_bucket[5m])))',
          '{{output}} p99')],
        "s", {"x": 0, "y": 52, "w": 12, "h": 8}, per_chip=False,
        thresholds=[0.025],
        description="Snapshot render (+gzip/snappy) wall time per output "
                    "path; threshold line = ScrapeRenderLatencyHigh alert "
                    "(25 ms p99 on the http path)."),
    timeseries(
        "Rendered bytes by output",
        [('sum by (output) (rate(collector_rendered_bytes_total[5m]))',
          '{{output}}')],
        "Bps", {"x": 12, "y": 52, "w": 12, "h": 8}, per_chip=False,
        description="Output volume per render path (post-compression). A "
                    "rising trend at constant scrape rate means series "
                    "growth — cardinality eating the scrape budget."),

    # Row 9 — workload view (the embedded exporter's step hook; absent
    # unless a workload runs kube_gpu_stats_tpu_torch.embedded).
    timeseries(
        "Workload step rate / busy fraction",
        # max, not sum, by worker: in SPMD the counter rides every local
        # card's labels with the same value — summing would overcount by
        # the card count.
        [(f'max by (worker) (rate(accelerator_workload_steps_total{{{FILTERS}}}[2m]))',
          'w{{worker}} steps/s'),
         (f'max by (worker) (rate(accelerator_workload_busy_seconds_total{{{FILTERS}}}[2m]))',
          'w{{worker}} busy fraction')],
        "none", {"x": 0, "y": 60, "w": 12, "h": 8}, per_chip=False,
        description="Embedded-mode workload hook: reported step rate and "
                    "the fraction of wall time inside timed steps (the "
                    "in-process duty-cycle analog)."),
    timeseries(
        "Workload step duration quantiles",
        [('histogram_quantile(0.5, sum(rate(accelerator_workload_step_duration_seconds_bucket[5m])) by (le))', 'p50'),
         ('histogram_quantile(0.99, sum(rate(accelerator_workload_step_duration_seconds_bucket[5m])) by (le))', 'p99')],
        "s", {"x": 12, "y": 60, "w": 12, "h": 8}, per_chip=False,
        description="Timed workload step durations (embedded step_timer)."),
    timeseries(
        "Device memory peak (high-water mark) by card",
        [(f'accelerator_memory_peak_bytes{{{FILTERS}}}', CARD)],
        "bytes", {"x": 0, "y": 68, "w": 12, "h": 8},
        description="Peak memory the workload's allocator held since it "
                    "started (the embedded exporter) — the OOM-debugging "
                    "companion to memory used."),
    timeseries(
        "Workload MFU (% of dense bf16 peak)",
        [(f'accelerator_workload_model_flops_utilization{{{FILTERS}}}',
          'w{{worker}} card {{chip}} (live)'),
         (f'100 * rate(accelerator_workload_flops_total{{{FILTERS}}}'
          f'[$__rate_interval]) / '
          f'accelerator_peak_flops_per_second{{{FILTERS}}}',
          'w{{worker}} card {{chip}} (rate)')],
        "percent", {"x": 12, "y": 68, "w": 12, "h": 8}, per_chip=False,
        palette=True,
        description="Model FLOPs utilization from the embedded step hook: "
                    "the live in-process gauge, and the same ratio "
                    "recomputed Prometheus-side from the FLOPs counter "
                    "(the two should agree; divergence means scrape gaps "
                    "or a device kind with no peak table entry)."),

    # Row 10 — slice hub rollups (absent unless a hub is deployed).
    timeseries(
        "Slice workers: observed vs expected (hub)",
        # slice_workers carries a slice label (filter it); expected and
        # target_up are deliberately unlabeled/target-only — unfiltered.
        [('slice_workers{slice=~"$slice"}', '{{slice}} observed'),
         ('slice_workers_expected', 'expected'),
         ('sum(1 - slice_target_up)', 'targets down')],
        "short", {"x": 0, "y": 76, "w": 12, "h": 8}, per_chip=False,
        palette=True,
        description="From the kube-tpu-stats-h100 hub. Observed workers "
                    "per slice against --expect-workers; a persistent "
                    "gap is a missing DaemonSet pod or a dead node (see "
                    "slice_target_up for which)."),
    timeseries(
        "Per-worker step rate + straggler ratio (hub)",
        [('slice_worker_steps_per_second{slice=~"$slice"}',
          '{{slice}} w{{worker}}'),
         ('slice_straggler_ratio{slice=~"$slice"}',
          '{{slice}} straggler ratio')],
        "short", {"x": 12, "y": 76, "w": 12, "h": 8}, per_chip=False,
        palette=True, right_axis_regex=".*straggler.*", right_axis_max=1,
        description="slice_worker_steps_per_second per worker — in an "
                    "SPMD job the slowest worker gates the slice. "
                    "slice_straggler_ratio (min/max, right-friendly 0-1) "
                    "near 1.0 = balanced; a sagging worker drags it "
                    "down."),
    timeseries(
        "Hub health: per-target fetch time + refresh p99",
        [('slice_target_fetch_seconds', 'fetch {{target}}'),
         ('histogram_quantile(0.99, sum(rate('
          'hub_refresh_duration_seconds_bucket[5m])) by (le))',
          'refresh p99')],
        "s", {"x": 0, "y": 84, "w": 12, "h": 8}, per_chip=False,
        palette=True,
        description="From the kube-tpu-stats-h100 hub. "
                    "slice_target_fetch_seconds shows a node answering "
                    "slowly long before it times out into "
                    "slice_target_up 0; hub_refresh_duration_seconds p99 "
                    "is the whole refresh (concurrent scrape of every "
                    "target + merge + rollups)."),
    timeseries(
        "Energy draw (from the joules counter)",
        [(f'sum(rate(accelerator_energy_joules_total{{{FILTERS}}}[5m]))',
          'avg power from energy (W)')],
        "watt", {"x": 12, "y": 84, "w": 12, "h": 8}, per_chip=False,
        description="rate() of the integrated energy counter recomputes "
                    "average watts — should track the power panel; "
                    "divergence means scrape gaps. Joined with pod labels "
                    "the energy counter is per-workload accounting."),
]

dashboard = {
    "uid": "kube-tpu-stats-h100",
    "title": "Accelerator telemetry (H100)",
    "description": "kube-tpu-stats-h100: per-card accelerator_* metrics "
                   "from NVML with pod attribution and slice topology. "
                   "Works for any exporter emitting the unified "
                   "accelerator_* schema (docs/UNIFIED_SCHEMA.md).",
    "tags": ["gpu", "h100", "accelerator", "kube-tpu-stats"],
    "schemaVersion": 39,
    "editable": True,
    "graphTooltip": 1,
    "time": {"from": "now-1h", "to": "now"},
    "refresh": "30s",
    "templating": {
        "list": [
            {"name": "datasource", "label": "Data source", "type": "datasource",
             "query": "prometheus", "current": {}},
            template_var("slice", "Slice",
                         "label_values(accelerator_up, slice)"),
            template_var("worker", "Worker",
                         'label_values(accelerator_up{slice=~"$slice"}, worker)'),
            template_var("accel_type", "Accelerator",
                         "label_values(accelerator_up, accel_type)"),
        ]
    },
    "panels": panels,
}

out = Path(__file__).parent / "dashboard.json"
out.write_text(json.dumps(dashboard, indent=1) + "\n")
print(f"wrote {out} ({len(panels)} panels)")
