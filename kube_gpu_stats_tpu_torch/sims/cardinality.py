"""Cardinality: a label bomb beside a healthy fleet.

The port of the reference's ``tools/cardinality_sim.py``: a real hub
behind a real ``MetricsServer`` takes 2 label bombs, each a FULL frame
of 50,000 series unique to its wave, 10 waves (1,000,000 unique series
offered), beside 14 healthy pushers sending their usual 6 series, with
a per-source budget of 500 series, a hard cap of 700 and an idle
watermark of 650:

- **the shed, counted exactly**: every bomb frame is admitted clamped to
  the budget, so each bomb's ``source_budget`` shed is waves x (offered
  - budget); the accountant, ``/debug/cardinality`` and the exported
  ``kts_cardinality_shed_total`` agree row for row, and no more than the
  hard cap of series is live;
- **the memory**: the shed series never accumulate, so the process's RSS
  grows less than 384 MB across the bomb: its peak through the bomb less
  the RSS before it. Run ``python -m kube_gpu_stats_tpu_torch.sims
  cardinality`` in a fresh process for a figure of the bomb alone. The
  peak is the kernel's ``VmHWM`` when, before the bomb, it lies within
  HWM_SLACK_MB of ``VmRSS`` (the process's own peak), or a higher
  sample; otherwise the highest ``VmRSS`` sampled every 10 ms through
  the bomb. The reference
  reads ``ru_maxrss``, the process's lifetime peak, which a process
  carries across ``exec`` from the one that forked it (and the card
  machine's gVisor carries ``VmHWM`` too): a child of a large process
  would start at its parent's peak. ``rss_source`` names the peak
  used;
- **the healthy fleet untouched**: the 14 healthy pushers' series on the
  bombed hub are byte-equal to a control hub's that took the same
  healthy traffic and no bomb;
- **recovery**: a new source at the hard cap draws 413 + Retry-After;
  once the bombs stop, idle eviction takes the ledger below the
  watermark and the same source is admitted, with no resync.

The bomb frames and the healthy bodies carry the reference's labels byte
for byte (``accel_type="tpu-v5p"``, as ``bench.build_pusher_body``):
synthetic load, so that every count equals the reference's.
"""

from __future__ import annotations

import json
import resource
import threading
import urllib.request

from ._common import Result
from .chaos import SessionFleet, post_frame

HEALTHY = 14
BOMBS = 2
WAVES = 10
BOMB_SERIES = 50_000          # unique series a bomb frame
BUDGET = 500                  # series a source
HARD_CAP = 700                # series in the whole ledger
HIGH = 650                    # the idle-eviction watermark
IDLE_REFRESHES = 2
RSS_PIN_MB = 384              # the most RSS may grow across the bomb
RSS_SAMPLE_S = 0.01
HWM_SLACK_MB = 16             # VmHWM this near VmRSS is the process's own


def bomb_body(bomb: int, wave: int, n: int = BOMB_SERIES) -> str:
    """One bomb frame: n series of a known family, every label value
    unique to this (bomb, wave); ``slice="zz-bomb"`` keeps the healthy
    workers' slice rollups clean."""
    lines = ["# TYPE accelerator_duty_cycle gauge"]
    for j in range(n):
        lines.append(
            f'accelerator_duty_cycle{{accel_type="tpu-v5p",chip="0",'
            f'pod="bomb-{bomb}-{wave}-{j}",slice="zz-bomb",'
            f'worker="bomb{bomb}"}} 1')
    return "\n".join(lines) + "\n"


def healthy_lines(text: str) -> str:
    """The healthy workers' own series, sorted: the surface compared
    with the control hub (self-metrics and rollups carry no worker)."""
    wanted = tuple(f'worker="{i}"' for i in range(HEALTHY))
    return "\n".join(sorted(line for line in text.splitlines()
                            if any(w in line for w in wanted)))


def shed_from_exposition(text: str) -> dict:
    """{(source, reason): n} of the rendered non-zero
    ``kts_cardinality_shed_total`` rows."""
    out: dict = {}
    for line in text.splitlines():
        if not line.startswith("kts_cardinality_shed_total{"):
            continue
        labels, value = line.rsplit(" ", 1)
        fields = dict(part.split("=", 1)
                      for part in labels[labels.index("{") + 1:-1]
                      .split('",') if "=" in part)
        if float(value):
            out[(fields["source"].strip('"'),
                 fields["reason"].strip('"'))] = int(float(value))
    return out


def proc_status_bytes(field: str) -> int | None:
    """A ``/proc/self/status`` size field (``VmRSS``, ``VmHWM``) in
    bytes; None where there is no /proc."""
    try:
        with open("/proc/self/status") as handle:
            for line in handle:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def rss_bytes() -> int:
    """This process's resident set now (its peak where there is no
    /proc)."""
    rss = proc_status_bytes("VmRSS")
    if rss is not None:
        return rss
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class RssPeak:
    """The highest ``VmRSS`` seen by a thread sampling it every
    RSS_SAMPLE_S while the with-block runs."""

    def __init__(self) -> None:
        self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample,
                                        name="rss-peak", daemon=True)

    def _sample(self) -> None:
        while not self._stop.wait(RSS_SAMPLE_S):
            self.peak = max(self.peak, rss_bytes())

    def __enter__(self) -> "RssPeak":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def run() -> Result:
    from ..delta import encode_full
    from ..exposition import MetricsServer
    from ..hub import Hub

    result = Result("cardinality")
    problems = result.problems
    fig, timings = result.figures, result.timings
    bomb_series = BOMB_SERIES

    def make_hub():
        hub = Hub([], targets_provider=lambda: [], interval=0.2,
                  push_fence=1e9, ingest_lanes=2,
                  series_budget_per_source=BUDGET,
                  series_hard_cap=HARD_CAP, series_high_watermark=HIGH,
                  series_idle_refreshes=IDLE_REFRESHES)
        server = MetricsServer(
            hub.registry, host="127.0.0.1", port=0,
            trace_provider=hub.tracer, ingest_provider=hub.delta.handle,
            cardinality_provider=lambda: dict(
                hub.cardinality.debug_payload(),
                enabled=hub.cardinality.enabled))
        server.start()
        return hub, server

    hub, server = make_hub()               # the bombed hub
    control, control_server = make_hub()   # the same fleet, no bomb
    bomb_sources = [f"http://bomb-{b}:9400/metrics" for b in range(BOMBS)]
    bomb_gens = [1000 + b for b in range(BOMBS)]
    intruder = "http://late-joiner:9400/metrics"
    try:
        fleet = SessionFleet(server.port, HEALTHY, prefix="healthy")
        peer = SessionFleet(control_server.port, HEALTHY, prefix="healthy")
        for name, outcomes in (("bombed", fleet.seed()),
                               ("control", peer.seed())):
            bad = [o for o in outcomes if o[1] != 200]
            if bad:
                problems.append(f"{name} hub: seeding failed: {bad[:3]}")
        hub.refresh_once()
        control.refresh_once()
        rss_before = rss_bytes()
        hwm_before = proc_status_bytes("VmHWM")

        # The bomb: WAVES waves of fresh unique series.
        attempted = 0
        statuses: dict = {}
        healthy_failed = 0
        intruder_413 = None
        with RssPeak() as sampled:
            for wave in range(WAVES):
                for name, outcomes in (
                        ("bombed", fleet.delta_wave(40.0 + wave)),
                        ("control", peer.delta_wave(40.0 + wave))):
                    bad = [o for o in outcomes if o[1] != 200]
                    healthy_failed += len(bad)
                    if bad:
                        problems.append(f"{name} hub: healthy deltas "
                                        f"failed beside the bomb: "
                                        f"{bad[:3]}")
                for b in range(BOMBS):
                    wire = encode_full(bomb_sources[b], bomb_gens[b],
                                       wave + 1,
                                       bomb_body(b, wave, bomb_series))
                    status, _retry = post_frame(server.port, wire,
                                                timeout=60.0)
                    attempted += bomb_series
                    statuses[status] = statuses.get(status, 0) + 1
                if wave == 2:
                    # Mid-bomb the ledger sits at the hard cap: a new
                    # source is refused 413 + Retry-After before any
                    # parse.
                    status, retry = post_frame(
                        server.port, encode_full(intruder, 7, 1,
                                                 fleet.bodies[0]))
                    intruder_413 = [status, retry is not None]
                hub.refresh_once()
                control.refresh_once()
        hwm_after = proc_status_bytes("VmHWM")
        own_hwm = (hwm_before is not None and hwm_after is not None
                   and hwm_before - rss_before <= HWM_SLACK_MB * 2**20)
        # The kernel keeps VmHWM from counters it syncs now and then, so
        # a sample can top it by a page or two: the peak is the higher.
        rss_source = "VmHWM" if own_hwm else "VmRSS sampled"
        peak = max(hwm_after, sampled.peak) if own_hwm else sampled.peak
        rss_growth_mb = (peak - rss_before) / 2**20

        if statuses.get(200, 0) != BOMBS * WAVES:
            problems.append(f"bomb frames not all clamped and accepted: "
                            f"{statuses} (an established source's FULL "
                            f"lands, clamped)")
        if intruder_413 != [413, True]:
            problems.append(f"a new source at the hard cap answered "
                            f"{intruder_413}, want 413 + Retry-After")
        if rss_growth_mb > RSS_PIN_MB:
            problems.append(f"RSS grew {rss_growth_mb:.0f} MB across the "
                            f"bomb (pin: {RSS_PIN_MB} MB): shed series are "
                            f"accumulating somewhere")

        # The exact accounting: three views of one ledger (the last
        # wave's refresh published the counters; another refresh here
        # would advance the idle clock).
        in_process = {k: v for k, v in
                      hub.cardinality.shed_totals().items() if v}
        exported = shed_from_exposition(hub.registry.snapshot().render())
        debug = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/debug/cardinality",
            timeout=10).read())
        via_debug = {(row["source"], reason): n
                     for row in debug.get("shed", [])
                     for reason, n in (row.get("reasons") or {}).items()
                     if n}
        if exported != in_process:
            problems.append(f"the exported shed ledger != the in-process "
                            f"one: {exported} vs {in_process}")
        if via_debug != in_process:
            problems.append(f"/debug/cardinality's shed ledger != the "
                            f"in-process one: {via_debug} vs {in_process}")
        # The clamp is deterministic: each bomb frame offers bomb_series
        # and keeps BUDGET.
        want_shed = WAVES * (bomb_series - BUDGET)
        bomb_shed = [in_process.get((source, "source_budget"), 0)
                     for source in bomb_sources]
        if bomb_shed != [want_shed] * BOMBS:
            problems.append(f"bomb source_budget shed {bomb_shed}, want "
                            f"exactly {want_shed} each ({WAVES} x "
                            f"({bomb_series} - {BUDGET}))")
        live = hub.cardinality.live_series()
        if live > HARD_CAP:
            problems.append(f"{live} series live > hard cap {HARD_CAP}")

        # The healthy fleet, byte for byte.
        bombed_healthy = healthy_lines(hub.registry.snapshot().render())
        control_healthy = healthy_lines(
            control.registry.snapshot().render())
        healthy_equal = bool(bombed_healthy) and \
            bombed_healthy == control_healthy
        if bombed_healthy != control_healthy:
            diff = [f"  bombed:  {a!r}\n  control: {b!r}"
                    for a, b in zip(bombed_healthy.splitlines(),
                                    control_healthy.splitlines())
                    if a != b][:3]
            problems.append("the healthy workers' series differ from the "
                            "control hub's:\n"
                            + ("\n".join(diff) or "  (line counts differ)"))
        if not bombed_healthy:
            problems.append("the healthy comparison surface is empty")

        # Recovery: the bombs stop, idle eviction reclaims their series.
        for wave in range(IDLE_REFRESHES + 2):
            bad = [o for o in fleet.delta_wave(90.0 + wave) if o[1] != 200]
            healthy_failed += len(bad)
            if bad:
                problems.append(f"post-bomb healthy deltas failed: "
                                f"{bad[:3]}")
            hub.refresh_once()
        live_after = hub.cardinality.live_series()
        if live_after > HIGH:
            problems.append(f"no recovery: {live_after} series still live "
                            f"after the bomb stopped (watermark {HIGH})")
        evicted = hub.cardinality.evicted_totals().get("idle", 0)
        if not evicted:
            problems.append("kts_cardinality_evicted_total{reason=idle} "
                            "never rose: the bombs' series were not "
                            "reclaimed")
        status, _retry = post_frame(
            server.port, encode_full(intruder, 8, 1, fleet.bodies[0]))
        if status != 200:
            problems.append(f"the late joiner is still refused ({status}) "
                            f"after the bomb stopped")
        fig.update(
            bomb_series=bomb_series, attempted=attempted,
            bomb_statuses={str(k): v for k, v in sorted(statuses.items())},
            intruder_at_cap=intruder_413, healthy_failed=healthy_failed,
            shed_rows=len(in_process),
            shed_total=sum(in_process.values()), bomb_shed=bomb_shed,
            want_bomb_shed=want_shed,
            exported_equal=exported == in_process,
            debug_equal=via_debug == in_process, live_at_peak=live,
            healthy_equal=healthy_equal, live_after=live_after,
            evicted_idle=evicted, late_joiner=status,
            rss_growth_under_pin=rss_growth_mb <= RSS_PIN_MB)
        timings.update(rss_growth_mb=rss_growth_mb, rss_pin_mb=RSS_PIN_MB,
                       rss_source=rss_source,
                       rss_before_mb=rss_before / 2**20,
                       rss_sampled_peak_mb=sampled.peak / 2**20,
                       hwm_before_mb=(hwm_before or 0) / 2**20,
                       hwm_after_mb=(hwm_after or 0) / 2**20)
    finally:
        server.stop()
        hub.stop()
        control_server.stop()
        control.stop()
    return result


def add_arguments(parser) -> None:
    pass


def main(args) -> Result:
    result = run()
    fig, t = result.figures, result.timings
    print(result.report(
        f"{fig.get('attempted')} unique series from {BOMBS} label bombs "
        f"shed with the three ledgers equal, RSS "
        f"+{t.get('rss_growth_mb', 0.0):.0f} MB by {t.get('rss_source')} "
        f"(pin {RSS_PIN_MB}), "
        f"{HEALTHY} healthy pushers byte-equal to the control hub, idle "
        f"eviction re-admitted the late joiner"))
    return result
