"""The port's measurement module against the reference's, on the CPU.

``kube_gpu_stats_tpu_torch/bench.py`` and ``kube_gpu_stats_tpu/bench.py``
run on the same small arguments (workers <= 8, chips <= 2, pushers <= 64,
waves <= 2, readers <= 8, ticks <= 20), each over its own package's hub,
stores and collectors. Both return dicts with equal key sets, and every
key of a result is held to one tolerance:

- ``exact``: counts, bytes, series, frames, sheds, conservation and the
  ratios computed from them are equal (``==``) across the packages;
- ``time``: a time, rate or percent of a time is finite and > 0 in each
  package, and never compared across them;
- ``time0``: the same, but >= 0, for a figure the reference rounds to a
  precision these sizes can reach zero at (seconds to 0.01, percents to
  0.01, a ``max(0, ...)`` difference);
- ``own``: a figure that differs by design, with its own assertion
  (``native``: the port's hub applies slots through its own extension,
  so True, whatever the reference's build does; the children's
  ``per_proc_accepted``: which child accepts a connection is the
  kernel's ``SO_REUSEPORT`` hash, so the children are the same and each
  package's counts sum to its accepted total; ``hub_rss_mb_under_bomb``:
  the process's RSS, > 0).

The sheds of ``measure_overload_shed`` refill on the monotonic clock; both
packages' token buckets get a frozen clock, so every shed is counted
exactly. The fixture builders' bodies and files are byte-equal, and so
are the host fixture trees. ``profile_ingest(sources=16, waves=2)``
counts the same frames and bytes. The real-mode harnesses run here on
stand-ins: the embedded one on the CPU (``device="cpu"``, size 256, its
keys held against the reference's, which cannot run here), the NVML one
over ``testing.fake_nvml``; neither leaves a process behind. No timing
budget is asserted here.

Every test that starts a hub or ingest children has its own time limit.
"""

from __future__ import annotations

import ast
import contextlib
import math
import os
import pathlib
import signal
import time

import numpy as np
import pytest

import chip_smoke
from kube_gpu_stats_tpu import bench as ref_bench
from kube_gpu_stats_tpu import cardinality as ref_cardinality
from kube_gpu_stats_tpu import hub as ref_hub
from kube_gpu_stats_tpu import profiler as ref_profiler
from kube_gpu_stats_tpu import resilience as ref_resilience
from kube_gpu_stats_tpu.collectors.mock import MockCollector as RefMock
from kube_gpu_stats_tpu.testing import host_fixture as ref_host_fixture
from kube_gpu_stats_tpu_torch import bench, cardinality, hub, profiler
from kube_gpu_stats_tpu_torch import resilience, tracing
from kube_gpu_stats_tpu_torch import wal as port_wal
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.testing import fake_nvml, host_fixture

ROOT = pathlib.Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the test, rather than hang the run, when it outlasts
    ``seconds`` (SIGALRM on the main thread)."""
    def expired(*_):
        raise TimeoutError(f"test exceeded its {seconds:g} s limit")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def children() -> list[str]:
    """This process's live children (pid and state)."""
    me = str(os.getpid())
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            fields = pathlib.Path(f"/proc/{entry}/stat").read_text(
                ).rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me and fields[0] != "Z":
            found.append(f"{entry}:{fields[0]}")
    return found


@pytest.fixture(autouse=True)
def _reset_port_store_health():
    """The port's store registry is process wide, like the reference's
    (which tests/conftest.py resets): a hub serves a series set per
    store, so each test starts from an empty one."""
    port_wal.reset_store_stats()
    yield
    port_wal.reset_store_stats()


@pytest.fixture
def frozen_buckets(monkeypatch):
    """Both packages' token buckets on one frozen clock: no refill, so a
    shed depends on the frames alone."""
    for module in (resilience, ref_resilience):
        monkeypatch.setattr(module.TokenBucket.__init__, "__defaults__",
                            (lambda: 1000.0,))


# name -> (keyword arguments, {key: tolerance}); the tolerances are the
# module docstring's.
CASES = {
    "measure_quiet_tick_delta": ({}, {
        "full_bytes": "exact", "quiet_delta_bytes": "exact",
        "ratio": "exact"}),
    "measure_hub_merge": (dict(workers=8, chips=2, refreshes=4), {
        "p50_ms": "time", "cold_ms": "time",
        "body_cache_hit_rate": "exact", "parse_mb_per_s": "time",
        "render_cache_hits": "exact", "fleet_score_ms_per_refresh": "time"}),
    "measure_delta_federation": (
        dict(leaves=4, workers_per_leaf=8, refreshes=4), {
            "workers": "exact", "leaves": "exact",
            "root_merge_p50_ms": "time", "root_merge_cold_ms": "time",
            "delta_ingest_ms_per_refresh": "time",
            "delta_bytes_per_refresh": "exact",
            "full_bytes_total": "exact", "root_series": "exact"}),
    "measure_ingest_storm": (dict(pushers=64, waves=2, storm_threads=4), {
        "pushers": "exact", "lanes": "exact", "native": "own",
        "seed_s": "time0", "cold_refresh_ms": "time",
        "warm_refresh_ms": "time",
        "delta_ingest_10k_ms_per_refresh": "time",
        "ingest_cpu_pct": "time0", "resync_storm_recovery_s": "time0",
        "resync_storm_sessions": "exact", "resync_storm_dropped": "exact",
        "resync_storm_served": "exact"}),
    "measure_ingest_storm_procs": (
        dict(procs=2, pushers=64, waves=2, client_threads=4), {
            "procs": "exact", "pushers": "exact", "seed_ms": "time",
            "delta_ingest_procs_ms_per_refresh": "time",
            "ingest_procs_cpu_pct": "time0", "accepted_total": "exact",
            "hub_frames_total": "exact", "conserved": "exact",
            "per_proc_accepted": "own"}),
    "measure_warm_restart": (dict(pushers=64, tail_fraction=0.125), {
        "pushers": "exact", "warm_restart_sessions": "exact",
        "resumed_fraction": "exact", "resyncs": "exact",
        "replay_s": "time0", "recovery_s": "time0", "dropped": "exact"}),
    "measure_overload_shed": (
        dict(pushers=64, lanes=2, delta_rate=20.0, waves=2), {
            "pushers": "exact", "delta_shed": "exact",
            "full_refused": "exact", "fence_held": "exact",
            "sessions_alive": "exact",
            "sources_served_fraction": "exact", "shed_counts": "exact"}),
    "measure_cardinality_admission": (
        dict(pushers=32, frames=8, bomb_series=2000, bomb_frames=2), {
            "cardinality_admission_ns_per_series": "time",
            "ingest_ns_per_series": "time",
            "cardinality_admission_overhead_pct": "time",
            "hub_rss_mb_under_bomb": "own",
            "bomb_series_attempted": "exact",
            "bomb_live_series": "exact"}),
    "measure_query_serving": (
        dict(readers=8, requests_per_reader=2, pushers=8,
             conditional_scrapes=20), {
            "query_p50_ms_256readers": "time",
            "query_p99_ms_256readers": "time",
            "scrape_304_ratio": "exact",
            "history_write_ns_per_refresh": "time",
            "history_rss_mb": "exact", "query_requests": "exact"}),
    "measure_partition_drain": (dict(frames=20), {
        "frames": "exact", "spill_spool_ms_per_frame": "time",
        "spill_bytes_per_tick": "exact",
        "partition_drain_frames_per_s": "time",
        "partition_catchup_s": "time", "spill_dropped": "exact"}),
    "measure_degraded_overhead": (dict(ticks=20), {
        "healthy_store_ms_per_tick": "time",
        "degraded_store_ms_per_tick": "time",
        "degraded_overhead_pct": "time",
        "degraded_lost_counted": "exact"}),
    "measure_burst_overhead": (
        dict(ticks=20, chips=2, thread_seconds=0.3), {
            "burst_overhead_pct": "time0",
            "burst_fold_ms_per_tick": "time0",
            "burst_samples_per_sec": "time",
            "burst_thread_cpu_pct": "time0"}),
    "measure_hoststats": (dict(reads=10, pods=2), {
        "hoststats_read_ms_per_tick": "time",
        "hoststats_read_p99_ms": "time", "hoststats_families": "exact"}),
    "measure_fleet_localize": (dict(workers=8, refreshes=12), {
        "fleet_localize_ms": "time"}),
    "measure_efficiency_score": (dict(workers=8, refreshes=12), {
        "fleet_efficiency_ms_per_refresh": "time0"}),
}


def check_time(value, *, zero_ok: bool) -> bool:
    return (isinstance(value, (int, float)) and math.isfinite(value)
            and (value >= 0 if zero_ok else value > 0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_measurement_matches_the_reference(name, request):
    kwargs, tolerances = CASES[name]
    if name == "measure_overload_shed":
        request.getfixturevalue("frozen_buckets")
    with time_limit(60):
        got = getattr(bench, name)(**kwargs)
        want = getattr(ref_bench, name)(**kwargs)
    assert isinstance(got, dict) and isinstance(want, dict), (got, want)
    assert set(got) == set(want) == set(tolerances)
    # The keys the card's smoke requires are the reference's too.
    assert set(want) == set(chip_smoke.BENCH_KEYS[name])
    # So do the exact figures it derives from a measurement's arguments.
    chip_smoke.bench_invariants(name, got, kwargs)
    for key, tolerance in tolerances.items():
        if tolerance == "exact":
            assert got[key] == want[key], (key, got[key], want[key])
        elif tolerance in ("time", "time0"):
            for package, value in (("port", got[key]),
                                   ("reference", want[key])):
                assert check_time(value, zero_ok=tolerance == "time0"), (
                    package, key, value)
    if "native" in tolerances:
        assert got["native"] is True
    if "per_proc_accepted" in tolerances:
        assert set(got["per_proc_accepted"]) == set(
            want["per_proc_accepted"]) == set(range(kwargs["procs"]))
        for result in (got, want):
            assert sum(result["per_proc_accepted"].values()) == result[
                "accepted_total"]
    if "hub_rss_mb_under_bomb" in tolerances:
        assert got["hub_rss_mb_under_bomb"] > 0
    assert children() == []


def test_a_failing_measurement_logs_its_traceback_and_returns_none(
        monkeypatch, caplog):
    """None, never an exception, as in the reference; and the port logs
    why."""
    def boom(*_args, **_kwargs):
        raise OSError("no room")

    monkeypatch.setattr(hub, "Hub", boom)
    monkeypatch.setattr(ref_hub, "Hub", boom)
    with caplog.at_level("WARNING", logger="kube_gpu_stats_tpu_torch.bench"):
        assert bench.measure_hub_merge(workers=1, chips=1,
                                       refreshes=1) is None
    assert ref_bench.measure_hub_merge(workers=1, chips=1,
                                       refreshes=1) is None
    [record] = [r for r in caplog.records
                if r.name == "kube_gpu_stats_tpu_torch.bench"]
    assert "measure_hub_merge failed" in record.getMessage()
    assert record.exc_info and "no room" in str(record.exc_info[1])


# -- the fixture builders: byte for byte --------------------------------------


@pytest.mark.parametrize("workers,chips,links", [(1, 1, 0), (3, 2, 2),
                                                 (8, 2, 6)])
def test_slice_fixture_files_are_the_references(tmp_path, workers, chips,
                                                links):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got = bench.build_slice_fixture(tmp_path / "port", workers, chips, links)
    want = ref_bench.build_slice_fixture(tmp_path / "ref", workers, chips,
                                         links)
    assert [pathlib.Path(p).name for p in got] == [
        pathlib.Path(p).name for p in want]
    settle = time.time_ns() - hub._STAT_SIG_SETTLE_NS
    for mine, theirs in zip(got, want):
        assert pathlib.Path(mine).read_bytes() == pathlib.Path(
            theirs).read_bytes()
        # Aged past the settle window, so the hub's stat shortcut sees
        # the files as idle.
        assert os.stat(mine).st_mtime_ns < settle


@pytest.mark.parametrize("leaf,workers,duty,step_rate", [
    (0, 1, 50.0, 4.0), (3, 8, 61.25, 0.5), (63, 64, 0.0, 12.75)])
def test_leaf_rollup_snapshot_renders_as_the_references(leaf, workers,
                                                        duty, step_rate):
    got = bench.build_leaf_rollup_snapshot(leaf, workers, duty, step_rate)
    want = ref_bench.build_leaf_rollup_snapshot(leaf, workers, duty,
                                                step_rate)
    assert got.render() == want.render()


@pytest.mark.parametrize("worker,duty,power", [
    (0, 50.0, 300.0), (31, 0.0, 0.0), (33, 99.5, 712.25),
    (12345, 50.0, 300.0)])
def test_pusher_body_is_the_references(worker, duty, power):
    assert bench.build_pusher_body(worker, duty, power) == \
        ref_bench.build_pusher_body(worker, duty, power)


def tree(root: pathlib.Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("mem_full_avg10,layout", [(0.0, "systemd"),
                                                    (12.5, "cgroupfs")])
def test_host_fixture_trees_are_the_references(tmp_path, mem_full_avg10,
                                               layout):
    for package, module in (("port", host_fixture),
                            ("ref", ref_host_fixture)):
        root = tmp_path / package
        roots = module.make_host_tree(root, mem_full_avg10=mem_full_avg10)
        module.write_pod_cgroup(roots["cgroup"], "1234-abcd", layout=layout,
                                cpu_usec=7, rbytes=11)
        module.write_psi(roots["proc"], "cpu", some_avg10=3.5,
                         full_avg10=None)
        module.write_softirqs(roots["proc"], {"NET_RX": (1, 2, 3)})
        module.write_nic(roots["sysfs"], "eth1", rx_errors=4)
        module.write_thermal(roots["sysfs"], zone=1, temp_mc=71_000)
        module.write_throttle(roots["sysfs"], cpu=3, core=2, package=1)
        module.write_proc_stat(roots["proc"], intr_total=5,
                               softirq_total=6)
        assert {k: v.relative_to(root) for k, v in roots.items()} == {
            "proc": pathlib.Path("proc"), "sysfs": pathlib.Path("sys"),
            "cgroup": pathlib.Path("cgroup")}
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")
    assert host_fixture.DEFAULT_POD_UID == ref_host_fixture.DEFAULT_POD_UID


# -- the small pieces ------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 7, 20, 101])
def test_percentile_is_the_references(n):
    values = sorted(np.random.default_rng(n).normal(size=n).tolist())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        got, want = bench._percentile(values, q), ref_bench._percentile(
            values, q)
        assert got == want or (math.isnan(got) and math.isnan(want))


def test_span_overhead_is_finite_and_positive():
    for spans in (100, 250):
        ns = tracing.measure_overhead_ns(spans)
        assert math.isfinite(ns) and ns > 0


@pytest.mark.parametrize("cap", [0, 1, 3])
def test_label_fence_admitted_values_are_the_references(cap):
    rng = np.random.default_rng(cap)
    port = cardinality.LabelFence(cap)
    ref = ref_cardinality.LabelFence(cap)
    keys = ("pod", "namespace", "container")
    for _ in range(200):
        labels = {key: f"v{int(rng.integers(6))}" for key in keys
                  if rng.random() < 0.8}
        assert port.fence(labels) == ref.fence(labels)
        for key in keys + ("absent",):
            assert port.admitted_values(key) == ref.admitted_values(key)
    assert port.fenced_totals() == ref.fenced_totals()


# measure_collector's figures that do not depend on the host's speed.
COLLECTOR_EXACT = ("chips", "ticks", "metrics_per_chip",
                   "tick_series_per_tick")


def test_measure_collector_over_the_mock_backend():
    with time_limit(60):
        got = bench.measure_collector(MockCollector(2), ticks=12, warmup=2,
                                      extra={"mode": "simulated"})
        want = ref_bench.measure_collector(RefMock(2), ticks=12, warmup=2,
                                           extra={"mode": "simulated"})
    assert set(got) == set(want)
    for key in COLLECTOR_EXACT:
        assert got[key] == want[key], key
    assert got["mode"] == "simulated"
    assert len(got["durations_ms"]) == 12
    assert got["mean_ms"] == np.mean(got["durations_ms"]) or math.isclose(
        got["mean_ms"], float(np.mean(got["durations_ms"])), rel_tol=1e-12)
    assert got["p50_ms"] <= got["p90_ms"] <= got["p99_ms"]
    for key in ("mean_ms", "p50_ms", "max_hz", "scrape_p50_ms",
                "scrape_p99_ms", "tick_spans_per_tick",
                "trace_overhead_ns_per_span"):
        assert check_time(got[key], zero_ok=False), key
    assert "rpc_calls_per_tick" not in got


def test_profile_ingest_counts_what_the_reference_counts():
    with time_limit(60):
        report, got = profiler.profile_ingest(sources=16, waves=2)
        ref_report, want = ref_profiler.profile_ingest(sources=16, waves=2)
    assert set(got) == set(want)
    for key in ("sources", "waves", "lanes", "ingest"):
        assert got[key] == want[key], key
    # The path asked for is the path that ran.
    assert got["path"] == "native"
    assert profiler.profile_ingest(sources=4, waves=1,
                                   native=False)[1]["path"] == "python"
    assert check_time(got["ms_per_wave"], zero_ok=False)
    assert "function calls" in report and "handle" in report


# -- the real-mode harnesses, on stand-ins ------------------------------------


def _reference_extra_keys(function: str) -> set[str]:
    """The keys the reference's ``function`` adds to measure_collector's:
    its ``extra={...}`` literals and its ``result["..."] =`` stores."""
    source = (ROOT / "kube_gpu_stats_tpu" / "bench.py").read_text()
    [node] = [n for n in ast.walk(ast.parse(source))
              if isinstance(n, ast.FunctionDef) and n.name == function]
    keys = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.keyword) and sub.arg == "extra" and \
                isinstance(sub.value, ast.Dict):
            keys |= {k.value for k in sub.value.keys}
        if isinstance(sub, ast.Assign):
            for target in sub.targets:
                if (isinstance(target, ast.Subscript)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "result"
                        and isinstance(target.slice, ast.Constant)):
                    keys.add(target.slice.value)
    return keys


@pytest.fixture(scope="module")
def collector_keys() -> set[str]:
    """measure_collector's keys as the reference returns them for a
    collector without ``rpc_stats``."""
    keys = set(ref_bench.measure_collector(RefMock(1), ticks=2, warmup=1))
    assert keys == chip_smoke.COLLECTOR_KEYS
    return keys


def test_embedded_harness_on_the_cpu_has_the_references_keys(
        collector_keys):
    probe: dict = {}
    # The burn reports its steps in batches of 32 and the window opens at
    # the first report: the burn must outlast a few batches, which on a
    # loaded CPU take seconds.
    with time_limit(60):
        result = bench.try_embedded_harness(probe, ticks=10, warmup=2,
                                            burn_seconds=6.0,
                                            device="cpu", size=256)
    assert probe["embedded_attempt"] == {
        "platform": "cpu", "device_kind": "cpu", "error": None}
    extra = _reference_extra_keys("try_embedded_harness")
    assert extra == {"mode", "path", "device_kind",
                     "workload_steps_per_s_during_bench",
                     "workload_busy_fraction_during_bench",
                     "workload_mfu_pct_during_bench", "mfu_sweep"}
    assert set(result) == collector_keys | extra == chip_smoke.EMBEDDED_KEYS
    assert result["workload_steps_per_s_during_bench"] > 0
    assert 0 < result["workload_busy_fraction_during_bench"]
    # No datasheet peak for a CPU: no MFU rather than a guess.
    assert result["workload_mfu_pct_during_bench"] is None
    assert result["mode"] == "cpu" and result["path"] == "embedded"
    # Half, once and twice the size, through the cuda kernel's wrapper
    # (its plain version on the CPU).
    assert [row["size"] for row in result["mfu_sweep"]] == [128, 256, 512]
    assert all(row["tflops_per_s"] > 0 for row in result["mfu_sweep"])
    assert children() == []


def test_embedded_harness_without_a_card_returns_none_and_says_why():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the harness would burn it")
    probe: dict = {}
    assert bench.try_embedded_harness(probe, ticks=2, warmup=1) is None
    record = probe["embedded_attempt"]
    assert record["platform"] is None
    assert "no CUDA device" in record["error"]


def test_real_harness_without_nvml_returns_none_with_the_reason():
    result, probe = bench.try_real_harness(ticks=2, warmup=1)
    if probe["nvml_init"] == "ok":
        pytest.skip("NVML loads on this machine")
    assert result is None
    assert "NVML error" in probe["nvml_init"]
    assert probe["cards"] is None and probe["driver_version"] is None
    assert children() == []


@pytest.fixture
def fake_card(monkeypatch):
    card = fake_nvml.FakeDevice(uuid="GPU-0", minor=0, gpu_util=97)
    monkeypatch.setattr(bench, "_nvml_binding",
                        lambda: fake_nvml.FakeNvml([card]))
    return card


def test_real_harness_on_an_idle_fake_card_has_the_references_keys(
        fake_card, collector_keys):
    with time_limit(60):
        result, probe = bench.try_real_harness(ticks=10, warmup=2,
                                               colaunch=False)
    # The reference's real path adds mode and path to measure_collector's.
    assert _reference_extra_keys("_try_external_measure") == {"mode",
                                                              "path"}
    assert set(result) == collector_keys | {"mode", "path"} == \
        chip_smoke.REAL_KEYS
    assert (result["mode"], result["path"]) == ("real", "nvml")
    assert probe["nvml_init"] == "ok" and probe["cards"] == 1
    assert probe["driver_version"] == "580.159.03"
    assert probe["nvml_attempt"] == {"error": None,
                                     "last_duty": {"0": 97.0}}
    assert probe["burn_colaunch"]["skipped"] is True
    assert children() == []


def test_real_harness_measures_once_the_burn_loads_the_card_and_reaps_it(
        fake_card):
    with time_limit(60):
        result, probe = bench.try_real_harness(ticks=5, warmup=1,
                                               colaunch_seconds=2.0)
    record = probe["burn_colaunch"]
    assert record["spawned"] and record["loaded"]
    assert result is not None and result["path"] == "nvml"
    # Stopped (or already ended), and reaped either way.
    assert record["returncode"] is not None
    assert children() == []


def test_real_harness_refuses_a_card_the_burn_never_loads(fake_card):
    fake_card.gpu_util = 0
    with time_limit(60):
        result, probe = bench.try_real_harness(ticks=5, warmup=1,
                                               colaunch_seconds=2.0)
    record = probe["burn_colaunch"]
    assert result is None
    assert record["spawned"] and not record["loaded"]
    assert record["duty_seen"] == 0 and record["returncode"] is not None
    assert probe["nvml_attempt"]["error"] == (
        "the co-launched burn never loaded card 0")
    assert children() == []
