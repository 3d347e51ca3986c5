"""`top` — live per-card terminal view over scrape targets.

The nvidia-smi-shaped operator view paired with the DaemonSet: point it
at one or more exporter `/metrics` URLs (a node's daemon, an embedded
exporter, or a hub) or saved `.prom` textfiles, and it renders a
refreshing table of every card those targets export — duty cycle,
memory, power, temperature, link traffic, the owning pod, and workload
step rate. Against a hub, the ``slice_*`` rollups fold into a footer.

The port's copy of the reference's view: the same rows, columns, table
and JSON shape (the column headers keep the reference's words, so a
script reading either package's output reads both). It imports no
torch: it runs from the DaemonSet image.

Counters (steps, busy-seconds) need two frames for a rate, so those
columns fill in from the second refresh; `--once` prints a single frame
with rates blank. `--json` emits one machine-readable frame per refresh
(one JSON object per line) for scripting instead of the table.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import sys
import time
from typing import Mapping, Sequence

from . import schema
from .validate import (add_fetch_arguments, fetch_exposition, fetch_options,
                       parse_exposition)

DEFAULT_TARGET = "http://127.0.0.1:9400/metrics"

# Families the table reads. Keyed by short column id.
_GAUGES = {
    "duty": schema.DUTY_CYCLE.name,
    "mem_used": schema.MEMORY_USED.name,
    "mem_total": schema.MEMORY_TOTAL.name,
    "mem_peak": schema.MEMORY_PEAK.name,
    "power": schema.POWER.name,
    "temp": schema.TEMPERATURE.name,
    "up": schema.DEVICE_UP.name,
    "mfu": schema.WORKLOAD_MFU.name,
}
_COUNTERS = {
    "steps": schema.WORKLOAD_STEPS.name,
    "busy": schema.WORKLOAD_BUSY_SECONDS.name,
    # JSON-only raw totals (the 80-col table stays as is): energy for
    # per-chip/per-pod accounting, restarts for bounce triage.
    "energy": schema.ENERGY.name,
    "restarts": schema.RUNTIME_RESTARTS.name,
}


@dataclasses.dataclass
class ChipRow:
    """One chip's latest values across every family the view renders.

    Keyed by (target, slice, worker, chip): per-node exporters only
    export local chips, so chips from different targets are different
    hardware even when their topology labels are identical or empty —
    without the target in the key, two dev-VM embedded exporters (all
    labels "") would silently fold into one chimera row. The key uses
    the target's NAME (url/path), not its position in the fetch list: a
    transient fetch failure must not shift every later target onto a
    different identity and cross-match their rate windows."""

    key: tuple[object, str, str, str]
    at: float = 0.0  # this target's fetch timestamp (rate denominator)
    accel_type: str = ""
    pod: str = ""
    namespace: str = ""
    up: float | None = None
    duty: float | None = None
    mem_used: float | None = None
    mem_total: float | None = None
    mem_peak: float | None = None  # JSON only; the table stays 80-col
    mfu: float | None = None  # JSON only (embedded-mode MFU gauge)
    power: float | None = None
    temp: float | None = None
    ici_bps: float = 0.0  # summed over links
    ici_links: int = 0  # ICI rate series seen ("no data" vs "0 B/s")
    holders: int = 0  # accelerator_process_open series (excl. overflow fold)
    # Raw counter values; rates derive from frame-over-frame deltas.
    steps_total: float | None = None
    busy_total: float | None = None

    energy_total: float | None = None  # JSON only (joules since start)
    restarts_total: float | None = None  # JSON only (runtime bounces)
    # Filled by Frame.rates():
    steps_per_s: float | None = None
    busy_pct: float | None = None

    def clone_at(self, at: float) -> "ChipRow":
        """Field-identical copy restamped with a fetch timestamp. The
        hub replays cached per-target folds into every frame; the frame
        must get fresh rows (rates() mutates them) without copy.copy's
        __reduce_ex__ detour — this is ~20x cheaper, measured at
        64-target fan-in."""
        row = ChipRow.__new__(ChipRow)
        row.__dict__.update(self.__dict__)
        row.at = at
        return row


class Frame:
    """One fetch round over every target."""

    def __init__(self, rows: dict[tuple, ChipRow], errors: list[str],
                 rollups: dict[tuple, float] | None = None) -> None:
        self.rows = rows
        self.errors = errors
        # Hub slice_* rollups seen in the scraped text, keyed by
        # (target, family, ((label, value), ...)) — present when a target
        # is a kube-tpu-stats hub; render_table folds them into a footer.
        # Target-keyed so two hubs' unlabeled families (expected-worker
        # count, duplicate count) never overwrite each other.
        self.rollups = rollups or {}

    def rates(self, previous: "Frame | None") -> None:
        if previous is None:
            return
        for key, row in self.rows.items():
            prev = previous.rows.get(key)
            if prev is None:
                continue
            # Per-target timestamps: a slow sibling target must not skew
            # this target's counter-delta denominator.
            dt = row.at - prev.at
            if dt <= 0:
                continue
            if (row.steps_total is not None and prev.steps_total is not None
                    and row.steps_total >= prev.steps_total):
                row.steps_per_s = (row.steps_total - prev.steps_total) / dt
            if (row.busy_total is not None and prev.busy_total is not None
                    and row.busy_total >= prev.busy_total):
                row.busy_pct = min(
                    100.0, 100.0 * (row.busy_total - prev.busy_total) / dt)


# Rendered-name -> column maps, built once at import (they were rebuilt
# per frame, visible in the 1 Hz hub profile at 64-target fan-in).
_GAUGE_BY_NAME = {name: col for col, name in _GAUGES.items()}
_COUNTER_BY_NAME = {name: col for col, name in _COUNTERS.items()}


def fold_target(series: Sequence, tkey: object, at: float,
                rows: dict[tuple, ChipRow],
                rollups: dict[tuple, float]) -> None:
    """Fold ONE target's parsed series into the rows/rollups
    accumulators. Every key this writes leads with ``tkey``, so two
    targets' contributions are disjoint — which is what lets
    build_frame merge per-target folds, and lets the hub cache a
    target's fold and replay it for every refresh its body is
    unchanged (zero-reparse ingest)."""
    def row(labels: Mapping[str, str]) -> ChipRow:
        key = (tkey, labels.get("slice", ""), labels.get("worker", ""),
               labels.get("chip", ""))
        r = rows.get(key)
        if r is None:
            r = rows[key] = ChipRow(key, at=at)
        if labels.get("accel_type"):
            r.accel_type = labels["accel_type"]
        if labels.get("pod"):
            r.pod = labels["pod"]
            r.namespace = labels.get("namespace", "")
        return r

    for name, labels, value in series:
        if name.startswith("slice_"):
            rollups[(tkey, name, tuple(sorted(labels.items())))] = value
            continue
        if not name.startswith("accelerator_"):
            continue
        col = _GAUGE_BY_NAME.get(name)
        if col is not None:
            setattr(row(labels), col, value)
            continue
        col = _COUNTER_BY_NAME.get(name)
        if col is not None:
            setattr(row(labels), f"{col}_total", value)
            continue
        if name == schema.ICI_BANDWIDTH.name:
            r = row(labels)
            r.ici_bps += value
            r.ici_links += 1
        elif name == schema.PROCESS_OPEN.name:
            if labels.get("comm") != "_overflow":
                row(labels).holders += 1


def build_frame(texts: Sequence[object], errors: list[str],
                ats: Sequence[float] | None = None,
                targets: Sequence[object] | None = None) -> Frame:
    """Fold exposition output from every target into chip rows.
    ``texts[i]`` is either raw exposition text or an already-parsed
    ``parse_exposition`` series list (hub.py parses once and shares);
    ``ats[i]`` is target i's fetch timestamp (defaults to now);
    ``targets[i]`` its stable identity in row keys (defaults to i)."""
    rows: dict[tuple, ChipRow] = {}
    rollups: dict[tuple, float] = {}
    now = time.monotonic()

    for tidx, text in enumerate(texts):
        at = ats[tidx] if ats is not None else now
        tkey = targets[tidx] if targets is not None else tidx
        if isinstance(text, str):
            try:
                series = parse_exposition(text)
            except ValueError as exc:
                errors.append(str(exc))
                continue
        else:
            series = text
        fold_target(series, tkey, at, rows, rollups)
    return Frame(rows, errors, rollups)


# -- rendering ---------------------------------------------------------------

def _fmt_bytes(n: float | None) -> str:
    if n is None:
        return "-"
    for unit in ("B", "Ki", "Mi", "Gi", "Ti"):
        if abs(n) < 1024 or unit == "Ti":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return "?"


def _fmt(v: float | None, pattern: str = "{:.1f}") -> str:
    return "-" if v is None else pattern.format(v)


_HEADER = (f"{'CHIP':<10} {'TYPE':<10} {'UP':<3} {'DUTY%':>6} {'BUSY%':>6} "
           f"{'MEM USED/TOTAL':>17} {'MEM%':>5} {'PWR W':>6} {'TEMP':>5} "
           f"{'ICI B/s':>9} {'STEP/S':>7} {'PROC':>4}  POD")


def render_table(frame: Frame) -> str:
    lines = []
    slices = sorted({k[1] for k in frame.rows})
    stamp = time.strftime("%H:%M:%S")
    up = sum(1 for r in frame.rows.values() if r.up == 1.0)
    lines.append(
        f"kube-tpu-stats top  {stamp}  chips: {len(frame.rows)} "
        f"({up} up)  slices: {', '.join(s or '-' for s in slices)}")
    lines.append(_HEADER)
    for key in sorted(frame.rows, key=lambda k: (k[1], _numeric(k[2]),
                                                 _numeric(k[3]), k[0])):
        r = frame.rows[key]
        chip = f"{key[3]}" + (f"/w{key[2]}" if key[2] else "")
        mem = f"{_fmt_bytes(r.mem_used)}/{_fmt_bytes(r.mem_total)}"
        mem_pct = ("-" if not r.mem_total or r.mem_used is None
                   else f"{100 * r.mem_used / r.mem_total:.0f}")
        pod = f"{r.namespace}/{r.pod}" if r.pod else "-"
        lines.append(
            f"{chip:<10} {r.accel_type:<10} "
            f"{'ok' if r.up == 1.0 else ('DN' if r.up == 0.0 else '-'):<3} "
            f"{_fmt(r.duty):>6} {_fmt(r.busy_pct):>6} {mem:>17} "
            f"{mem_pct:>5} {_fmt(r.power):>6} {_fmt(r.temp, '{:.0f}'):>5} "
            f"{_fmt_bytes(r.ici_bps if r.ici_bps else None):>9} "
            f"{_fmt(r.steps_per_s):>7} {r.holders or '-':>4}  {pod}")
    lines.extend(_rollup_footer(frame))
    for err in frame.errors:
        lines.append(f"! {err}")
    return "\n".join(lines)


def _rollup_footer(frame: Frame) -> list[str]:
    """One line per hub slice (slice_* rollups): worker/target health and
    the straggler ratio at a glance. Grouped per hub target so two hubs
    never mix their numbers, and a hub whose targets are ALL down still
    gets a line — that outage is exactly what the footer must surface."""
    if not frame.rollups:
        return []
    hubs: dict[object, dict] = {}
    for (tkey, name, labels), value in frame.rollups.items():
        hub = hubs.setdefault(tkey, {"expected": None, "down": 0,
                                     "duplicates": 0.0, "slices": {}})
        label_map = dict(labels)
        if name == "slice_workers_expected":
            hub["expected"] = value
        elif name == "slice_target_up":
            hub["down"] += value == 0.0
        elif name == "slice_duplicate_series":
            hub["duplicates"] += value
        elif "slice" in label_map and "worker" not in label_map:
            hub["slices"].setdefault(label_map["slice"], {})[name] = value

    def hub_level_parts(hub, workers=None):
        # Hub-config/health facts printed once per hub: expected workers
        # is a property of the hub config, not of one slice (schema.py),
        # so pairing it against a single slice's count only makes sense
        # when the hub serves exactly one slice.
        parts = []
        if workers is not None or hub["expected"]:
            shown = f"{workers:.0f}" if workers is not None else "0"
            want = f"/{hub['expected']:.0f}" if hub["expected"] else ""
            parts.append(f"workers {shown}{want}")
        if hub["down"]:
            parts.append(f"targets down {hub['down']:.0f}")
        if hub["duplicates"]:
            parts.append(f"DUPLICATE CHIP IDS {hub['duplicates']:.0f}")
        return parts

    def slice_parts(vals):
        parts = []
        workers = vals.get("slice_workers")
        if workers is not None:
            parts.append(f"workers {workers:.0f}")
        ratio = vals.get("slice_straggler_ratio")
        if ratio is not None:
            parts.append(f"straggler ratio {ratio:.2f}")
        return parts

    lines = []
    # With several hubs in one view every line names its hub, or two
    # hubs' identical-looking lines would be indistinguishable.
    many_hubs = len(hubs) > 1
    for tkey in sorted(hubs, key=str):
        hub = hubs[tkey]
        slices = hub["slices"]
        suffix = f"  ({tkey})" if many_hubs else ""
        if len(slices) == 1:
            # Single-slice hub (the common case): one combined line.
            (slice_name, vals), = slices.items()
            parts = hub_level_parts(hub, vals.get("slice_workers"))
            ratio = vals.get("slice_straggler_ratio")
            if ratio is not None:
                parts.insert(min(1, len(parts)),
                             f"straggler ratio {ratio:.2f}")
            if parts:
                lines.append(f"hub[{slice_name or '-'}]:  "
                             + "  ".join(parts) + suffix)
            continue
        for slice_name in sorted(slices):
            parts = slice_parts(slices[slice_name])
            if parts:
                lines.append(f"hub[{slice_name or '-'}]:  "
                             + "  ".join(parts) + suffix)
        # Hub-level summary (or the full-outage state with no slices):
        # total workers across the hub's slices vs the hub's expectation.
        total = (sum(v.get("slice_workers", 0) for v in slices.values())
                 if slices else None)
        parts = hub_level_parts(hub, total)
        if parts:
            lines.append("hub:  " + "  ".join(parts) + suffix)
    return lines


def _numeric(s: str):
    try:
        return (0, int(s))
    except ValueError:
        return (1, s)


def render_json(frame: Frame) -> str:
    rows = []
    for key in sorted(frame.rows):
        r = frame.rows[key]
        d = dataclasses.asdict(r)
        d["target"], d["slice"], d["worker"], d["chip"] = key
        del d["key"], d["at"]
        rows.append(d)
    out = {"chips": rows, "errors": frame.errors}
    if frame.rollups:
        out["rollups"] = [
            {"target": str(tkey), "family": name, "labels": dict(labels),
             "value": value}
            for (tkey, name, labels), value in sorted(
                frame.rollups.items(), key=lambda kv: (str(kv[0][0]),
                                                       kv[0][1], kv[0][2]))
        ]
    return json.dumps(out)


# -- CLI ---------------------------------------------------------------------

def snapshot_frame(targets: Sequence[str], previous: Frame | None,
                   pool: concurrent.futures.ThreadPoolExecutor | None = None,
                   fetch_kwargs: Mapping | None = None) -> Frame:
    """Fetch every target concurrently (one slow target must not stall
    the others or skew their rate windows) and fold into a Frame. Any
    fetch/decode failure becomes an error line, never a crash — this is
    a long-running terminal view. ``fetch_kwargs`` (auth headers, TLS
    options — validate.fetch_options) ride every fetch."""
    errors: list[str] = []
    texts: list[str] = []
    ats: list[float] = []
    names: list[str] = []

    def fetch(target: str) -> tuple[str, float]:
        text = fetch_exposition(target, timeout=5.0, **(fetch_kwargs or {}))
        return text, time.monotonic()

    own_pool = pool is None
    if own_pool:
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(16, len(targets) or 16))
    try:
        for target, future in [(t, pool.submit(fetch, t)) for t in targets]:
            try:
                text, at = future.result()
                texts.append(text)
                ats.append(at)
                names.append(target)
            except Exception as exc:  # noqa: BLE001 - rendered, not raised
                errors.append(f"{target}: {exc}")
    finally:
        if own_pool:
            pool.shutdown(wait=False)
    frame = build_frame(texts, errors, ats, targets=names)
    frame.rates(previous)
    return frame


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kube_gpu_stats_tpu_torch top",
        description="live per-card view over exporter scrape targets")
    parser.add_argument("targets", nargs="*", default=None,
                        help=f"metric URLs or .prom files "
                             f"(default {DEFAULT_TARGET})")
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument("--once", action="store_true",
                        help="print one frame and exit (rates blank)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="one JSON frame per line instead of the table")
    parser.add_argument("--no-clear", action="store_true",
                        help="append frames instead of clearing the screen")
    parser.add_argument("--targets-dns", default="",
                        help="host:port resolved to one target per pod IP "
                             "each frame (watch a whole slice via its "
                             "headless Service; follows pod churn)")
    parser.add_argument("--targets-dns-scheme", choices=("http", "https"),
                        default="http")
    add_fetch_arguments(parser)
    args = parser.parse_args(argv)
    resolve = None
    if args.targets_dns:
        if args.targets:
            parser.error("--targets-dns replaces positional targets")
        from .hub import parse_dns_endpoint, resolve_dns_targets

        try:
            parse_dns_endpoint(args.targets_dns)
        except ValueError as exc:
            parser.error(str(exc))

        def resolve(previous_targets):
            try:
                return resolve_dns_targets(
                    args.targets_dns, scheme=args.targets_dns_scheme)
            except OSError as exc:
                # DNS blip: keep watching the last-known pods.
                print(f"! dns: {exc}", file=sys.stderr)
                return previous_targets

        # Resolved per frame in the loop (one resolution, not two, before
        # the first frame — degraded DNS must not double startup latency).
        targets = []
    else:
        targets = args.targets or [DEFAULT_TARGET]
    try:
        fetch_options(args)  # flag conflicts fail before the loop
    except ValueError as exc:
        parser.error(str(exc))

    previous: Frame | None = None
    # One executor for the watch loop's lifetime — not 16 threads built
    # and torn down per refresh. DNS mode sizes for churn (the slice can
    # scale past the startup pod count), static mode for the given list.
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=16 if resolve is not None
        else min(16, len(targets) or 16))
    try:
        while True:
            # Re-resolved per frame: credential files rotate and DNS
            # targets churn under a long-running watch.
            if resolve is not None:
                targets = resolve(targets)
                if not targets:
                    print("! dns: no targets resolved", file=sys.stderr)
                    if args.once:
                        return 2
                    time.sleep(max(0.2, args.interval))
                    continue
            frame = snapshot_frame(targets, previous, pool,
                                   fetch_kwargs=fetch_options(args))
            if not frame.rows and frame.errors and previous is None:
                for err in frame.errors:
                    print(f"! {err}", file=sys.stderr)
                if args.once:
                    return 2
            out = render_json(frame) if args.as_json else render_table(frame)
            if not (args.once or args.as_json or args.no_clear) \
                    and sys.stdout.isatty():
                # ANSI clear only on a real terminal — piped/redirected
                # output gets appended frames like --no-clear.
                sys.stdout.write("\x1b[2J\x1b[H")
            print(out, flush=True)
            if args.once:
                return 0
            previous = frame
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0
    finally:
        pool.shutdown(wait=False)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
