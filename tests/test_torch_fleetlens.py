"""The port's fleet lens against the reference's on the same inputs.

The same seeded inputs go through both packages' ``fleetlens``: the EWMA
baseline (scores and state after every fold), the SLO tracker (every
window's state), ``straggler_ratios`` over seeded frames, and
``digest_from_series`` over seeded series of every family it harvests
and over a scrape of the port's NVML daemon, whose links are
``nvlink<N>``. Then ``FleetLens.observe`` over 40 seeded refreshes of six
workers on a ``2x3`` torus whose incidents raise and clear every anomaly
kind (duty, memory, power and its burst peak, steps, fetch, stale cards,
freshness, the five host signals, the summed link rate), accuse and
clear a shared link, and raise and clear both waste verdicts: after
each refresh the ``rollup()`` JSON, the ``contribute()`` text and the
journal are equal, and so is each package's ``doctor`` post-mortem of
the rollup; then again after an ``evict``. The arm hook fires on
the same anomalies in both. Each package's rows are its own ``ChipRow``.

The reference's end-to-end slow-node test over a libtpu fake with a
60 ms delay becomes a port test over two mock-backed poll loops: one
whose card 1 reads slowly on a scripted flight-recorder clock (no real
delay), one whose card 0 fails every read. The hub names the first the
worst node with its phase and ``device=1`` blame, flags the second
``stale_fraction``, and both packages' ``check_fleet`` print the same
row; no time budget is asserted.

Exact throughout: both packages fold the same floats in the same order.
"""

from __future__ import annotations

import itertools
import json
import types

import numpy as np
import pytest

from kube_gpu_stats_tpu import fleetlens as ref_fleetlens
from kube_gpu_stats_tpu import registry as ref_registry
from kube_gpu_stats_tpu import top as ref_top
from kube_gpu_stats_tpu_torch import fleetlens, registry, top

PACKAGES = {"port": (fleetlens, registry, top),
            "reference": (ref_fleetlens, ref_registry, ref_top)}


class Journal:
    """The tracer the lens journals into, duck-typed: (kind, detail,
    attrs) in emit order."""

    def __init__(self) -> None:
        self.events: list[tuple] = []

    def event(self, kind: str, detail: str = "", **attrs) -> None:
        self.events.append((kind, detail, dict(attrs)))


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_ewma_baseline_scores_and_folds_alike(seed):
    rng = np.random.default_rng(seed)
    values = list(rng.normal(50.0, 5.0, 40)) + [0.0] * 5 + [200.0, 51.0]
    floors = rng.choice([0.0, 1.0, 0.05], len(values))
    alphas = rng.choice([0.2, 0.2 / 16.0], len(values))
    got, want = fleetlens.EwmaBaseline(), ref_fleetlens.EwmaBaseline()
    for value, floor, alpha in zip(values, floors, alphas):
        assert got.score(float(value), float(floor)) == \
            want.score(float(value), float(floor))
        got.fold(float(value), float(alpha))
        want.fold(float(value), float(alpha))
        assert (got.mean, got.var, got.count) == \
            (want.mean, want.var, want.count)


@pytest.mark.parametrize("seed", range(3))
def test_slo_tracker_windows_alike(seed):
    rng = np.random.default_rng(10 + seed)
    windows = fleetlens.SLO_WINDOWS
    assert windows == ref_fleetlens.SLO_WINDOWS
    target = float(rng.choice([0.9, 0.95, 0.99]))
    got = fleetlens._SloTracker(target, windows)
    want = ref_fleetlens._SloTracker(target, windows)
    at = 1_700_000_000.0
    for _ in range(120):
        at += float(rng.uniform(5.0, 60.0))
        total = float(rng.integers(1, 9))
        bad = float(rng.integers(0, int(total) + 1))
        got.update(at, bad, total)
        want.update(at, bad, total)
        assert got.window_state(at, windows) == \
            want.window_state(at, windows)
    assert got.window_state(at + 4000.0, windows) == \
        want.window_state(at + 4000.0, windows)


def _rows(package: str, specs: list[dict]) -> dict:
    chip_row = PACKAGES[package][2].ChipRow
    rows = {}
    for i, spec in enumerate(specs):
        row = chip_row(key=spec["key"])
        for field, value in spec.items():
            if field != "key":
                setattr(row, field, value)
        rows[spec["key"] + (i,)] = row
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_straggler_ratios_alike(seed):
    rng = np.random.default_rng(20 + seed)
    specs = []
    for n in range(24):
        specs.append({
            "key": (f"t{n % 7}", f"s{n % 3}",
                    "" if n % 5 == 0 else str(n % 4), str(n)),
            "steps_per_s": (None if n % 6 == 0
                            else float(rng.uniform(0.0, 20.0)))})
    got = fleetlens.straggler_ratios(_rows("port", specs))
    want = ref_fleetlens.straggler_ratios(_rows("reference", specs))
    assert got == want and got
    assert fleetlens.straggler_ratios({}) == {}


def _digest_series(rng, worker: int, r: int = 1) -> list[tuple]:
    """Every family digest_from_series harvests, plus one it ignores."""
    series = []
    for phase in ("sample", "fold", "publish"):
        for quantile in ("p50", "p99", "max"):
            series.append(("kts_tick_phase_seconds",
                           {"phase": phase, "quantile": quantile},
                           float(rng.uniform(1e-4, 2e-3))))
    slow = 0.08 if worker == 4 and r >= 10 else \
        float(0.002 + rng.uniform(0.0, 1e-3))
    series.append(("kts_slowest_tick_seconds",
                   {"phase": "sample", "blame": f"device={worker % 2}"},
                   slow))
    for chip in range(2):
        burst = 350.0 + float(rng.normal(0.0, 2.0))
        if worker == 2 and 14 <= r <= 18:
            burst *= 2.0
        for stat, value in (("max", burst), ("mean", burst - 20.0)):
            series.append(("kts_power_burst_watts",
                           {"chip": str(chip), "stat": stat}, value))
    hot = worker == 1 and 24 <= r <= 28
    for resource, kind, value in (("memory", "full", 30.0),
                                  ("cpu", "some", 40.0),
                                  ("io", "full", 20.0),
                                  ("memory", "some", 50.0)):
        for window in ("avg10", "avg60"):
            series.append(("kts_host_pressure_share",
                           {"resource": resource, "kind": kind,
                            "window": window},
                           value if hot else 0.0))
    series.append(("kts_host_nic_drop_rate", {}, 50.0 if hot else 0.0))
    series.append(("kts_host_cpu_throttle_rate", {},
                   5.0 if hot else 0.0))
    for chip in range(2):
        for label in ("x0", "x1", "y0", "y1"):
            rate = 1e9 + float(rng.normal(0.0, 1e7))
            if 26 <= r <= 30 and ((worker == 0 and label == "y1")
                                  or (worker == 1 and label == "y0")):
                rate *= 0.4
            series.append((
                "accelerator_ici_link_bandwidth_bytes_per_second",
                {"chip": str(chip), "link": label, "slice": "fleet-a",
                 "worker": str(worker), "topology": "2x3"}, rate))
    series.append(("kts_energy_pod_joules_total",
                   {"pod": f"job-{worker}", "namespace": "ml"},
                   600.0 * r + worker))
    series.append(("kts_energy_pod_joules_total",
                   {"pod": "", "namespace": ""}, 1.0))
    series.append(("kts_energy_coverage_ratio", {}, 0.5))
    series.append(("accelerator_duty_cycle", {"chip": "0"}, 50.0))
    return series


@pytest.mark.parametrize("seed", range(3))
def test_digest_from_series_alike(seed):
    rng = np.random.default_rng(30 + seed)
    series = _digest_series(rng, int(rng.integers(0, 6)),
                            int(rng.integers(1, 41)))
    order = rng.permutation(len(series))
    series = [series[i] for i in order]
    got = fleetlens.digest_from_series(series)
    assert got == ref_fleetlens.digest_from_series(series)
    assert set(got) == {"phases", "slowest", "burst_max_watts", "host",
                        "ici", "energy"}
    assert fleetlens.digest_from_series([]) == {} == \
        ref_fleetlens.digest_from_series([])


def nvlink_scrape(ticks: int = 3, worker: str = "3") -> list[tuple]:
    """A scrape of the port's NVML daemon poll loop over a fake NVML
    with two H100s and their NVLinks, traced: (name, labels, value)."""
    from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
    from kube_gpu_stats_tpu_torch.poll import PollLoop
    from kube_gpu_stats_tpu_torch.registry import Registry
    from kube_gpu_stats_tpu_torch.testing.fake_nvml import (FakeDevice,
                                                            FakeNvml)
    from kube_gpu_stats_tpu_torch.tracing import Tracer
    from kube_gpu_stats_tpu_torch.validate import parse_exposition

    devices = [FakeDevice(uuid=f"GPU-{i}", minor=i, gpu_util=90,
                          power_mw=600_000,
                          nvlink_kib={link: (0, 0) for link in range(4)})
               for i in range(2)]
    now = [1000.0]
    loop = PollLoop(NvmlCollector(FakeNvml(devices)), Registry(),
                    deadline=30.0, clock=lambda: now[0],
                    pipeline_fetch=False, tracer=Tracer(),
                    topology_labels={"slice": "h100-a", "worker": worker,
                                     "topology": "8x8"})
    try:
        for tick in range(1, ticks + 1):
            for i, dev in enumerate(devices):
                dev.nvlink_kib = {link: (tick * (1000 + 10 * link + i),
                                         tick * (900 + link))
                                  for link in range(4)}
            now[0] += 1.0
            loop.tick()
        text = loop._registry.snapshot().render()
    finally:
        loop.stop()
    return [(name, dict(labels), value)
            for name, labels, value in parse_exposition(text)]


def test_digest_of_a_port_daemons_nvlink_scrape_alike():
    series = nvlink_scrape()
    got = fleetlens.digest_from_series(series)
    assert got == ref_fleetlens.digest_from_series(series)
    assert sorted(got["ici"]["links"]) == [f"nvlink{n}" for n in range(4)]
    assert got["ici"]["worker"] == "3"
    assert got["ici"]["topology"] == "8x8"
    assert all(rate > 0 for rate in got["ici"]["links"].values())
    assert "slowest" in got and "phases" in got


# -- the lens over a scripted fleet ---------------------------------------------

TARGETS = [f"http://node-{w}.fleet:9400/metrics" for w in range(6)]
REFRESHES = 40


def _scenario(seed: int):
    """Per refresh: (targets, reachable, fetch, row specs, series per
    answering target). Incidents, by refresh: worker 1's duty collapses
    (12-16); worker 2's power and its burst peak double (14-18); worker
    3's memory halves (15-17); worker 4's step rate halves (16-20, the
    straggler) and its slowest tick is the fleet's worst from 10 on;
    worker 5's fetch takes 2 s (18-20) and then it stops answering
    (22-26); a card of worker 0 goes stale (20-22); worker 1's host
    signals spike (24-28); the link 0-1 loses 60% on both endpoints'
    views (26-30); pod job-2 holds its cards idle (28-36); pod job-3
    runs with a flat step counter (30-38) and departs (39 on)."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(1, REFRESHES + 1):
        reachable, fetch, specs, series = {}, {}, [], {}
        for w, target in enumerate(TARGETS):
            if w == 5 and 22 <= r <= 26:
                reachable[target] = False
                continue
            reachable[target] = True
            fetch[target] = 0.010 + float(rng.normal(0.0, 5e-4))
            if w == 5 and 18 <= r <= 20:
                fetch[target] = 2.0
            pod = "job-3b" if w == 3 and r >= 39 else f"job-{w}"
            for chip in range(2):
                duty = 60.0 + float(rng.normal(0.0, 1.0))
                mem = 40e9 + float(rng.normal(0.0, 1e8))
                power = 300.0 + float(rng.normal(0.0, 2.0))
                steps = 10.0 + float(rng.normal(0.0, 0.05))
                up = 1.0
                if w == 1 and 12 <= r <= 16:
                    duty = 5.0 + float(rng.normal(0.0, 0.5))
                if w == 2 and 14 <= r <= 18:
                    power *= 2.0
                if w == 3 and 15 <= r <= 17:
                    mem /= 2.0
                if w == 4 and 16 <= r <= 20:
                    steps = 5.0
                if w == 0 and chip == 1 and 20 <= r <= 22:
                    up = 0.0
                if w == 2 and 28 <= r <= 36:
                    duty, steps, power = 0.0, 0.0, 70.0
                if w == 3 and 30 <= r <= 38:
                    steps = 0.0
                specs.append({"key": (target, "fleet-a", str(w), str(chip)),
                              "up": up, "duty": duty, "mem_used": mem,
                              "power": power, "steps_per_s": steps,
                              "pod": pod, "namespace": "ml"})
            series[target] = _digest_series(rng, w, r)
        out.append((list(TARGETS), reachable, fetch, specs, series))
    return out


def _observe(package, lens, seq, now, step):
    targets, reachable, fetch, specs, series = step
    mod = PACKAGES[package][0]
    digests = {t: mod.digest_from_series(s) for t, s in series.items()}
    frame = types.SimpleNamespace(rows=_rows(package, specs))
    lens.observe(seq, now, targets, reachable, fetch, frame, digests)


def _contributed(package, lens) -> str:
    builder = PACKAGES[package][1].SnapshotBuilder()
    lens.contribute(builder)
    return builder.build().render()


def _lenses(**kwargs):
    journals = {"port": Journal(), "reference": Journal()}
    lenses = {"port": fleetlens.FleetLens(tracer=journals["port"], **kwargs),
              "reference": ref_fleetlens.FleetLens(
                  tracer=journals["reference"], **kwargs)}
    hooks: dict[str, list] = {"port": [], "reference": []}
    for package, lens in lenses.items():
        lens.arm_hook = (lambda target, kind, z, calls=hooks[package]:
                         calls.append((target, kind, z)))
    return lenses, journals, hooks


def _assert_alike(lenses, journals):
    from kube_gpu_stats_tpu import doctor as ref_doctor
    from kube_gpu_stats_tpu_torch import doctor

    got, want = lenses["port"], lenses["reference"]
    assert json.dumps(got.rollup(), sort_keys=True) == \
        json.dumps(want.rollup(), sort_keys=True)
    # The doctor's post-mortem of this rollup, in each package.
    payload = json.loads(json.dumps(got.rollup()))
    assert doctor.fleet_post_mortem(payload) == \
        ref_doctor.fleet_post_mortem(payload)
    assert _contributed("port", got) == _contributed("reference", want)
    assert got.link_history_rows() == want.link_history_rows()
    assert got.waste_history_rows() == want.waste_history_rows()
    assert got.efficiency_summary() == want.efficiency_summary()
    assert journals["port"].events == journals["reference"].events


ALL_KINDS = {"duty", "hbm", "power", "power_burst", "steps", "fetch",
             "stale_fraction", "freshness", "host_mem_stall",
             "host_cpu_stall", "host_io_stall", "host_nic_drops",
             "host_throttle", "ici"}


@pytest.mark.parametrize("seed", range(2))
def test_observe_over_forty_refreshes_alike(seed):
    lenses, journals, hooks = _lenses()
    now = 1_700_000_000.0
    for seq, step in enumerate(_scenario(seed), start=1):
        now += 10.0
        for package, lens in lenses.items():
            _observe(package, lens, seq, now, step)
        _assert_alike(lenses, journals)
    events = journals["port"].events
    raised = {attrs["anomaly"] for kind, _d, attrs in events
              if kind == "fleet_anomaly"}
    recovered = {attrs["anomaly"] for kind, _d, attrs in events
                 if kind == "fleet_recovered"}
    assert ALL_KINDS <= raised, ALL_KINDS - raised
    assert ALL_KINDS <= recovered, ALL_KINDS - recovered
    kinds = [kind for kind, _d, _a in events]
    for edge in ("fleet_link_suspect", "fleet_link_cleared", "fleet_waste",
                 "fleet_waste_cleared"):
        assert edge in kinds, edge
    suspect = next(a for k, _d, a in events if k == "fleet_link_suspect")
    assert suspect["link"] == "0-1"
    wastes = {(a["pod"], a["reason"]) for k, _d, a in events
              if k == "fleet_waste"}
    assert wastes == {("job-2", "idle-reservation"),
                      ("job-3", "low-goodput")}
    assert any("pod departed" in d for k, d, _a in events
               if k == "fleet_waste_cleared")
    rollup = lenses["port"].rollup()
    assert rollup["attribution"]["target"] == TARGETS[4]
    assert rollup["attribution"]["blame"] == "device=0"
    windows = rollup["slo"]["straggler"]["windows"]["1h"]
    assert windows["bad_ratio"] > 0.0 and windows["events"] == REFRESHES
    assert rollup["links"]["graph"] == {"kind": "torus", "topology": "2x3",
                                        "nodes": 6, "links": 9}
    text = _contributed("port", lenses["port"])
    assert ('kts_fleet_link_suspect{link="0-1",'
            'reason="ici-rate+anomaly-correlated+host-counter-confirmed"} 0'
            in text)
    assert hooks["port"] == hooks["reference"]
    assert {kind for _t, kind, _z in hooks["port"]} == \
        {"duty", "power", "power_burst"}
    # Churn: workers 4 and 5 leave; their state goes in both.
    for lens in lenses.values():
        lens.evict(set(TARGETS[:4]))
    _assert_alike(lenses, journals)
    assert TARGETS[4] not in lenses["port"].rollup()["targets"]
    assert lenses["port"].rollup()["attribution"] is None


def test_observe_with_the_efficiency_lens_off_and_custom_knobs_alike():
    kwargs = dict(freshness_target=0.9, straggler_target=0.8,
                  straggler_ratio=0.6, z_threshold=3.0, min_samples=4,
                  miss_threshold=2, efficiency=False)
    lenses, journals, _hooks = _lenses(**kwargs)
    now = 1_700_000_000.0
    for seq, step in enumerate(_scenario(7)[:24], start=1):
        now += 15.0
        for package, lens in lenses.items():
            _observe(package, lens, seq, now, step)
        _assert_alike(lenses, journals)
    assert lenses["port"].rollup()["efficiency"] == {"enabled": False}
    assert lenses["port"].waste_history_rows() == []
    assert "kts_fleet_waste_pods" not in _contributed("port",
                                                       lenses["port"])


def test_arm_hook_errors_do_not_stop_observe_alike():
    lenses, journals, _hooks = _lenses(min_samples=3)

    def boom(*_args):
        raise RuntimeError("hook failed")

    for lens in lenses.values():
        lens.arm_hook = boom
    now = 1_700_000_000.0
    for seq, step in enumerate(_scenario(3)[:18], start=1):
        now += 10.0
        for package, lens in lenses.items():
            _observe(package, lens, seq, now, step)
        _assert_alike(lenses, journals)
    assert any(k == "fleet_anomaly" and a["anomaly"] == "power"
               for k, _d, a in journals["port"].events)


def _assert_alike_but_unplaced(lenses, journals, dropped):
    """As ``_assert_alike``, except for the doctor's verdict on a node
    whose every anomaly is a link symptom led by its own NVLink rate
    dropping: the reference accuses it; the port, whose localizer cannot
    place an nvlink<N> label on any edge, names it as an interconnect
    slowdown it cannot localize (``link_unplaced``) and accuses no node.
    Everything else of the post-mortem is the reference's. Returns the
    port's (anomalous, link_unplaced)."""
    from kube_gpu_stats_tpu import doctor as ref_doctor
    from kube_gpu_stats_tpu_torch import doctor

    got, want = lenses["port"], lenses["reference"]
    assert json.dumps(got.rollup(), sort_keys=True) == \
        json.dumps(want.rollup(), sort_keys=True)
    assert _contributed("port", got) == _contributed("reference", want)
    payload = json.loads(json.dumps(got.rollup()))
    status, detail, data = doctor.fleet_post_mortem(payload)
    ref_status, ref_detail, ref_data = ref_doctor.fleet_post_mortem(payload)
    unplaced = data.pop("link_unplaced", {})
    assert set(unplaced) <= set(dropped)
    assert all(kinds.get("ici", 0.0) < 0.0 for kinds in unplaced.values())
    assert unplaced == {t: ref_data["anomalous"][t] for t in unplaced}
    assert data["anomalous"] == {t: kinds for t, kinds
                                 in ref_data["anomalous"].items()
                                 if t not in unplaced}
    assert {k: v for k, v in data.items() if k != "anomalous"} == \
        {k: v for k, v in ref_data.items() if k != "anomalous"}
    assert status == ref_status

    def others(text):
        return [line for line in text.split("; ")
                if not any(line.startswith(f"{t}:") for t in unplaced)]

    assert others(detail) == others(ref_detail)
    for target in unplaced:
        assert f"{target}: interconnect slowdown not localized" in detail
    return data["anomalous"], unplaced


def test_an_nvlink_fleet_scores_the_ici_signal_and_accuses_no_link():
    """The port's NVML daemon labels its links nvlink<N>: the lens sums
    them into each node's ici signal, and the localizer maps none onto
    an edge, in both packages. Two nodes' NVLink rates then drop to 30%:
    the reference's doctor accuses them; the port's names them as an
    interconnect slowdown it cannot localize and accuses no node."""
    lenses, journals, _hooks = _lenses()
    scrapes = {w: nvlink_scrape(ticks=2, worker=str(w)) for w in range(4)}
    targets = [f"http://h100-{w}:9400/metrics" for w in range(4)]
    now = 1_700_000_000.0
    for seq in range(1, 13):
        now += 10.0
        series = {}
        for w, target in enumerate(targets):
            scale = 0.3 if (w in (0, 1) and seq >= 9) else 1.0
            series[target] = [
                (name, labels, value * scale if "ici_link" in name
                 else value)
                for name, labels, value in scrapes[w]]
        step = (targets, {t: True for t in targets},
                {t: 0.01 for t in targets}, [], series)
        for package, lens in lenses.items():
            _observe(package, lens, seq, now, step)
        accused, unplaced = _assert_alike_but_unplaced(
            lenses, journals, targets[:2])
    assert accused == {} and set(unplaced) == set(targets[:2])
    rollup = lenses["port"].rollup()
    assert rollup["links"]["suspects"] == {}
    assert rollup["links"]["baselines"] == {}
    signals = rollup["targets"][targets[0]]["signals"]
    assert signals["ici"]["value"] > 0
    assert not any(kind.startswith("fleet_link") for kind, _d, _a in
                   journals["port"].events)


# -- the slow node, on a scripted clock -------------------------------------------

class _ScriptedClock:
    """The flight recorder's clock: a nanosecond counter that moves only
    when a read is scripted to be slow (and a hair per call, so spans
    order)."""

    def __init__(self) -> None:
        self._ns = itertools.count(10**12, 1000)
        self._extra = 0

    def __call__(self) -> int:
        return next(self._ns) + self._extra

    def stall(self, ns: int) -> None:
        self._extra += ns


def test_fleet_lens_names_the_slow_node_and_the_frozen_one(tmp_path):
    from kube_gpu_stats_tpu import doctor as ref_doctor
    from kube_gpu_stats_tpu_torch import doctor, hub
    from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
    from kube_gpu_stats_tpu_torch.exposition import MetricsServer
    from kube_gpu_stats_tpu_torch.poll import PollLoop
    from kube_gpu_stats_tpu_torch.registry import Registry
    from kube_gpu_stats_tpu_torch.tracing import Tracer

    clock = _ScriptedClock()
    slow = MockCollector(num_devices=2)
    real_slow = slow.sample

    def slow_sample(device):
        if device.device_id == "1":
            clock.stall(60_000_000)          # a 60 ms read, scripted
        return real_slow(device)

    slow.sample = slow_sample
    frozen = MockCollector(num_devices=2)
    loops = [PollLoop(slow, Registry(), deadline=2.0, pipeline_fetch=False,
                      tracer=Tracer(clock_ns=clock)),
             PollLoop(frozen, Registry(), deadline=2.0,
                      pipeline_fetch=False)]
    paths = [str(tmp_path / "slow.prom"), str(tmp_path / "frozen.prom")]
    h = hub.Hub(paths, interval=60.0)
    h.fleet.min_samples = 3
    server = MetricsServer(h.registry, host="127.0.0.1", port=0,
                           trace_provider=h.tracer, fleet_provider=h.fleet)
    server.start()

    def cycle():
        for loop, path in zip(loops, paths):
            loop.tick()
            with open(path, "w") as handle:
                handle.write(loop._registry.snapshot().render())
        h.refresh_once()

    try:
        for _ in range(6):
            cycle()
        assert "stale_fraction" not in \
            h.fleet.rollup()["targets"][paths[1]]["anomalous"]
        real_frozen = frozen.sample

        def frozen_sample(device):
            if device.device_id == "0":
                raise RuntimeError("read frozen")
            return real_frozen(device)

        frozen.sample = frozen_sample
        for _ in range(3):
            cycle()
        rollup = h.fleet.rollup()
        assert "stale_fraction" in rollup["targets"][paths[1]]["anomalous"]
        worst = rollup["attribution"]
        assert worst["target"] == paths[0]
        assert worst["blame"] == "device=1"
        phase = worst["phase"]
        assert phase
        text = h.registry.snapshot().render()
        assert (f'kts_fleet_worst_tick_seconds{{target="{paths[0]}",'
                f'phase="{phase}"}}') in text
        assert (f'kts_fleet_anomalies_total{{target="{paths[1]}",'
                f'kind="stale_fraction"}} 1') in text
        base = f"http://127.0.0.1:{server.port}"
        got, want = doctor.check_fleet(base), ref_doctor.check_fleet(base)
        assert (got.name, got.status, got.detail) == \
            (want.name, want.status, want.detail)
        assert got.status == "warn"
        assert f"worst node: {paths[0]} (phase {phase}" in got.detail
        assert "device=1" in got.detail
        assert f"{paths[1]}: " in got.detail and "stale_fraction" in \
            got.detail
    finally:
        server.stop()
        h.stop()
        for loop in loops:
            loop.stop()
