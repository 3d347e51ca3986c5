"""The measurement module: what the exporter, the daemon and the hub cost,
and what they hold, measured through the production code paths.

The port's counterpart of the reference's ``bench.py``, with the same
function names, signatures, defaults and result keys. Two kinds:

- **Real-mode harnesses**, on an H100 node: :func:`try_real_harness`
  measures the DaemonSet's NVML backend through the production poll loop
  while a co-launched ``cuda`` burn (``python -m
  kube_gpu_stats_tpu_torch.loadgen --kernel cuda``) loads the card, and
  :func:`try_embedded_harness` measures the embedded collector in the
  burn's own process, with the burn's MFU and a size sweep after it. Both
  import torch (the embedded one) or NVML only inside the call.
- **Host measurements**, on any machine: the hub's merge, the delta
  federation root, the ingest storm (in process and through the
  ``SO_REUSEPORT`` acceptor processes), warm restart, admission sheds,
  the cardinality accountant, the ``/query`` read path, the spill queue's
  drain, the degraded stores, the burst sampler, host signals, the fleet
  localizer and the efficiency lens. Their synthetic fixtures come from
  :func:`build_slice_fixture`, :func:`build_leaf_rollup_snapshot` and
  :func:`build_pusher_body`.

Every measurement returns a dict, or ``None`` on failure: it never raises
into its caller, and it logs the exception with its traceback through
this module's logger, so a ``None`` says why. :func:`measure_collector`
is the one exception: it is the harnesses' inner loop and raises, and the
harnesses catch it. Importing this module loads no torch.
"""

from __future__ import annotations

import functools
import logging
import statistics
import time
from pathlib import Path

from . import tracing
from .collectors import Collector
from .poll import PollLoop
from .registry import Registry

log = logging.getLogger(__name__)

# utilization.gpu (percent) at which the NVML harness counts the card as
# loaded by its co-launched burn.
LOADED_DUTY = 90


def _native_switch(fn):
    """Run ``fn`` with the process's module-level fast paths (snappy, the
    delta decode) as its ``native`` argument asks: on, or the Python
    paths for the length of the call."""
    @functools.wraps(fn)
    def wrapper(*args, native: bool = True, **kwargs):
        from . import native as native_pkg

        with native_pkg.python_paths(None if native else "native=False"):
            return fn(*args, native=native, **kwargs)
    return wrapper


def _guarded(fn):
    """A measurement returns None on failure and never raises; the
    exception goes to the log with its traceback."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:  # noqa: BLE001 - an extra datum, never a failure
            log.warning("%s failed", fn.__name__, exc_info=True)
            return None

    return wrapper


def _percentile(sorted_values: list[float], q: float) -> float:
    if not sorted_values:
        return float("nan")
    idx = min(len(sorted_values) - 1, max(0, round(q * (len(sorted_values) - 1))))
    return sorted_values[idx]


def measure_collector(collector: Collector, *, ticks: int, warmup: int,
                      pipeline_fetch: bool = True,
                      extra: dict | None = None) -> dict:
    """Run ``warmup + ticks`` polls of ``collector`` through the production
    loop and report the tick-duration distribution in milliseconds, plus
    the HTTP-scrape distribution over the same snapshots (render + gzip +
    HTTP through the production MetricsServer, over real sockets)."""
    return _measure_collector(collector, Registry(), ticks=ticks,
                              warmup=warmup, pipeline_fetch=pipeline_fetch,
                              extra=extra)


def _measure_collector(collector: Collector, registry: Registry, *,
                       ticks: int, warmup: int, pipeline_fetch: bool,
                       extra: dict | None) -> dict:
    """:func:`measure_collector` into a given registry, which keeps the
    last snapshot for the caller to read."""
    import gc
    import urllib.request

    from .exposition import MetricsServer

    loop = PollLoop(collector, registry, deadline=10.0,
                    pipeline_fetch=pipeline_fetch)
    # The production trace wiring: a collector's own aux spans are part
    # of the measured cost.
    setter = getattr(collector, "set_tracer", None)
    if callable(setter):
        setter(loop.tracer)
    durations: list[float] = []
    scrape_ms: list[float] = []
    # Series objects actually constructed per tick (tick plans re-emit
    # cached Series while a slot's value is unchanged; see
    # PollLoop.last_tick_stats), and the RPCs a collector with a runtime
    # fetch issued per tick.
    alloc_per_tick: list[float] = []
    rpc_stats = getattr(collector, "rpc_stats", None)
    rpc_calls_before: int | None = None
    server = MetricsServer(registry, host="127.0.0.1", port=0)
    server.start()

    # GC pause probe: a collection landing inside a measured tick is the
    # classic cause of a p99 far over an unchanged p50. Record every
    # collection's wall time in the measured window, and freeze the warm
    # heap after the warm-up so window collections scan only fresh
    # garbage.
    gc_pauses_ms: list[float] = []
    gc_started = [0.0]

    def _gc_probe(phase: str, info: dict) -> None:
        if phase == "start":
            gc_started[0] = time.monotonic()
        else:
            gc_pauses_ms.append((time.monotonic() - gc_started[0]) * 1000.0)

    # Bound the scrape sampling: in real mode a burn contends for the
    # host's CPU, and ~15 samples give a stable p50; the tick loop stays
    # full length.
    max_scrapes = min(ticks, 15)

    def scrape() -> None:
        # Ask for gzip as a Prometheus scraper does, so the measured path
        # includes the compression.
        request = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/metrics",
            headers={"Accept-Encoding": "gzip"})
        urllib.request.urlopen(request, timeout=5).read()

    try:
        for _ in range(warmup):
            loop.tick()
            scrape()
        # The warm-up's garbage collected and the long-lived heap frozen
        # before the measured ticks: no full-heap collection lands in
        # the window.
        gc.collect()
        gc.freeze()
        gc.callbacks.append(_gc_probe)
        if rpc_stats is not None:
            rpc_calls_before = rpc_stats().get("rpc_calls_total", 0)
        for _ in range(ticks):
            durations.append(loop.tick() * 1000.0)
            alloc_per_tick.append(
                loop.last_tick_stats.get("series_built", 0))
            if len(scrape_ms) < max_scrapes:
                scrape_start = time.monotonic()
                scrape()
                scrape_ms.append(
                    (time.monotonic() - scrape_start) * 1000.0)
    finally:
        try:
            gc.callbacks.remove(_gc_probe)
        except ValueError:
            pass
        gc.unfreeze()
        loop.stop()
        server.stop()
    ordered = sorted(durations)
    scrape_sorted = sorted(scrape_ms)
    chips = max(1, len(loop.devices))
    # Per-chip series exported on the last tick: at a 1 Hz cadence this
    # is the metrics/s/chip figure.
    device_series = sum(
        1 for s in registry.snapshot().series
        if s.spec.name.startswith("accelerator_")
    )
    result = {
        "chips": len(loop.devices),
        "ticks": ticks,
        "durations_ms": durations,
        "mean_ms": statistics.mean(durations),
        "p50_ms": _percentile(ordered, 0.50),
        "p90_ms": _percentile(ordered, 0.90),
        "p99_ms": _percentile(ordered, 0.99),
        "metrics_per_chip": device_series / chips,
        "max_hz": 1000.0 / _percentile(ordered, 0.50) if ordered else 0.0,
        "scrape_p50_ms": _percentile(scrape_sorted, 0.50),
        "scrape_p99_ms": _percentile(scrape_sorted, 0.99),
        # GC evidence for the measured window.
        "gc_collections": len(gc_pauses_ms),
        "gc_max_pause_ms": round(max(gc_pauses_ms), 3) if gc_pauses_ms
        else 0.0,
        # Snapshot objects built per tick against those re-emitted from
        # plan slots: series_reused near the series count means the plan
        # path is warm.
        "tick_alloc_objects_per_tick": round(
            statistics.mean(alloc_per_tick), 1) if alloc_per_tick else None,
        "tick_series_per_tick": loop.last_tick_stats.get("series"),
        "tick_series_reused_per_tick": loop.last_tick_stats.get(
            "series_reused"),
        # The flight recorder's cost: spans each tick recorded (0 would
        # mean tracing silently off) and the measured cost of one span.
        "tick_spans_per_tick": round(loop.tracer.spans_per_trace(), 1),
        "trace_overhead_ns_per_span": round(tracing.measure_overhead_ns(),
                                            1),
    }
    if rpc_stats is not None and rpc_calls_before is not None and ticks:
        result["rpc_calls_per_tick"] = round(
            (rpc_stats().get("rpc_calls_total", 0) - rpc_calls_before)
            / ticks, 2)
        result["rpc_batched_families"] = rpc_stats().get(
            "batched_families", 0)
    result.update(extra or {})
    return result


def _terminate(proc) -> None:
    import subprocess

    proc.terminate()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _nvml_binding():
    """The NVML binding the real harness opens (tests hand it
    ``testing.fake_nvml.FakeNvml`` instead)."""
    from .native.nvml import Nvml

    return Nvml()


def _colaunch_burn(seconds: float, size: int, record: dict, stderr_file):
    """Start ``python -m kube_gpu_stats_tpu_torch.loadgen --kernel cuda``
    for ``seconds`` on every card; None when it cannot start. Its stderr
    goes to a file, not a pipe: an undrained pipe would wedge a chatty
    child."""
    import os
    import subprocess
    import sys

    package_root = str(Path(__file__).resolve().parent.parent)
    existing = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, PYTHONPATH=(
        f"{package_root}{os.pathsep}{existing}" if existing
        else package_root))
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kube_gpu_stats_tpu_torch.loadgen",
             "--kernel", "cuda", "--size", str(size),
             "--seconds", str(seconds)],
            env=env, stdout=subprocess.DEVNULL, stderr=stderr_file)
    except Exception as exc:  # noqa: BLE001 - recorded, then None
        record["stderr_tail"] = f"spawn failed: {exc}"
        return None
    record["spawned"] = True
    return proc


def _wait_loaded(proc, nvml, handle: int, seconds: float,
                 record: dict) -> bool:
    """Wait (bounded: the burn's own length plus start-up headroom) until
    card 0 reads at least LOADED_DUTY, or the burn has exited."""
    start = time.monotonic()
    deadline = start + seconds + 60.0
    while time.monotonic() < deadline and proc.poll() is None:
        duty, _memory = nvml.utilization(handle)
        record["duty_seen"] = duty
        if duty >= LOADED_DUTY:
            record["loaded"] = True
            record["load_wait_s"] = round(time.monotonic() - start, 2)
            return True
        time.sleep(0.25)
    return False


def _reap_burn(proc, record: dict, stderr_file) -> None:
    """Stop the co-launched burn if it still runs, always reap it, and
    keep its return code and the tail of its stderr."""
    if proc is not None:
        if proc.poll() is None:
            _terminate(proc)
        record["returncode"] = proc.returncode
    try:
        stderr_file.seek(0)
        stderr = stderr_file.read()
        record["stderr_tail"] = (record["stderr_tail"]
                                 or (stderr[-400:] if stderr else ""))
    except Exception:  # noqa: BLE001 - a diagnostic only
        pass


def _duty_by_card(registry: Registry) -> dict[str, float]:
    """``accelerator_duty_cycle`` per ``chip`` label in the registry's
    last snapshot."""
    return {dict(s.labels).get("chip", ""): s.value
            for s in registry.snapshot().series
            if s.spec.name == "accelerator_duty_cycle"}


def try_real_harness(*, ticks: int = 50, warmup: int = 5,
                     colaunch_seconds: float = 12.0,
                     colaunch: bool = True) -> tuple[dict | None, dict]:
    """(measurement or None, probe record), on the DaemonSet's NVML
    backend: :func:`measure_collector` over the pipelined
    ``NvmlCollector`` while a co-launched ``cuda`` burn loads the card
    (``colaunch=False``: on the card as it is).

    The probe record says what was found either way: NVML's init (``ok``
    or the error), the card count and the driver version; the burn's
    spawn, whether card 0 reached LOADED_DUTY, its return code and
    stderr tail (``burn_colaunch``); and the measurement's outcome with
    each card's ``accelerator_duty_cycle`` in the loop's last snapshot
    (``nvml_attempt``). The burn is always stopped and reaped."""
    import tempfile

    probe: dict = {"nvml_init": None, "cards": None,
                   "driver_version": None}
    try:
        from .collectors.nvml import NvmlCollector

        nvml = _nvml_binding()
        collector = NvmlCollector(nvml)
    except Exception as exc:  # noqa: BLE001 - no driver: recorded, None
        probe["nvml_init"] = f"{type(exc).__name__}: {exc}"
        log.warning("NVML harness: %s", probe["nvml_init"])
        return None, probe
    probe["nvml_init"] = "ok"
    attempt: dict = {"error": None, "last_duty": None}
    probe["nvml_attempt"] = attempt
    try:
        probe["driver_version"] = nvml.driver_version()
        probe["cards"] = nvml.device_count()
        if not collector.discover():
            attempt["error"] = "no card"
            return None, probe
        if not colaunch:
            probe["burn_colaunch"] = {"spawned": False, "loaded": False,
                                      "skipped": True}
            return _nvml_measure(collector, probe, ticks, warmup), probe
        record: dict = {"spawned": False, "loaded": False,
                        "load_wait_s": None, "duty_seen": None,
                        "returncode": None, "stderr_tail": None}
        probe["burn_colaunch"] = record
        with tempfile.TemporaryFile(mode="w+") as stderr_file:
            proc = None
            try:
                proc = _colaunch_burn(colaunch_seconds, 4096, record,
                                      stderr_file)
                if proc is None or not _wait_loaded(
                        proc, nvml, nvml.handle(0), colaunch_seconds,
                        record):
                    # A number taken on an idle card while claiming a
                    # loaded one is refused, with the reason recorded.
                    attempt["error"] = "the co-launched burn never loaded card 0"
                    return None, probe
                return _nvml_measure(collector, probe, ticks, warmup), probe
            finally:
                _reap_burn(proc, record, stderr_file)
    except Exception as exc:  # noqa: BLE001 - recorded, then None
        attempt["error"] = f"{type(exc).__name__}: {exc}"
        log.warning("NVML harness failed", exc_info=True)
        return None, probe
    finally:
        collector.close()


def _nvml_measure(collector, probe: dict, ticks: int,
                  warmup: int) -> dict:
    registry = Registry()
    result = _measure_collector(collector, registry, ticks=ticks,
                                warmup=warmup, pipeline_fetch=True,
                                extra={"mode": "real", "path": "nvml"})
    probe["nvml_attempt"]["last_duty"] = _duty_by_card(registry)
    return result


def try_embedded_harness(probe: dict, *, ticks: int = 50, warmup: int = 5,
                         burn_seconds: float = 20.0, device=None,
                         size: int = 4096) -> dict | None:
    """Measure the embedded collector (in-process PyTorch introspection)
    while ``run_burn(kernel="cuda", size=size, depth=16)`` drives every
    local card from a thread of this process, with the step rate, busy
    fraction and MFU over the measurement; then ``sweep_burn`` at half,
    once and twice ``size`` (2048, 4096, 8192 at the default).

    ``device=None`` is the card: with no CUDA device the harness returns
    None and records why; it never runs the burn on the CPU unless the
    caller passes ``device="cpu"`` (there the ``cuda`` kernel's wrapper
    takes its plain version, and ``mode`` says ``"cpu"``). The record
    is ``probe["embedded_attempt"]``."""
    import threading

    record: dict = {"platform": None, "device_kind": None, "error": None}
    probe["embedded_attempt"] = record
    try:
        import torch

        from .device import device_kind, local_devices

        if device is None and not torch.cuda.is_available():
            record["error"] = ("no CUDA device (torch.cuda.is_available() "
                               "is False); pass device='cpu' to run on "
                               "the CPU")
            return None
        devices = local_devices(device)
        record["platform"] = devices[0].type
        record["device_kind"] = device_kind(devices[0])
    except Exception as exc:  # noqa: BLE001 - recorded, then None
        record["error"] = f"device: {type(exc).__name__}: {exc}"
        log.warning("embedded harness: no device", exc_info=True)
        return None
    try:
        from .embedded import TorchIntrospectCollector
        from .kinds import _kind_peak_flops
        from .loadgen.burn import run_burn, sweep_burn
        from .supervisor import spawn

        collector = TorchIntrospectCollector(device=device)
        stop = threading.Event()

        def counters() -> tuple[int, float, float]:
            # (steps, busy seconds, FLOPs): one read of the collector's
            # published tuple.
            steps, busy, flops, _hist = collector._counters
            return steps, busy, flops

        def burn():
            try:
                run_burn(burn_seconds, size=size, depth=16,
                         report_every=1e9, kernel="cuda",
                         step_hook=collector.record_step, device=device)
            except Exception as exc:  # noqa: BLE001 - recorded, not fatal
                record["error"] = f"burn: {type(exc).__name__}: {exc}"
                log.warning("embedded harness: burn failed", exc_info=True)
            finally:
                stop.set()

        burner = spawn(burn, name="bench-burn")
        burner.start()
        # Let the burn build its kernel and load the card before
        # measuring.
        deadline = time.monotonic() + 60.0
        while (time.monotonic() < deadline and counters()[0] == 0
               and not stop.is_set()):
            time.sleep(0.2)
        if record["error"] is not None or counters()[0] == 0:
            # The burn died or never stepped: a number taken on an idle
            # card while claiming a loaded one is refused.
            record["error"] = record["error"] or "burn produced no steps"
            stop.wait(5.0)
            return None
        steps_before, busy_before, flops_before = counters()
        window_start = time.monotonic()
        result = measure_collector(
            collector, ticks=ticks, warmup=warmup,
            extra={"mode": "real" if record["platform"] == "cuda"
                   else record["platform"],
                   "path": "embedded",
                   "device_kind": record["device_kind"]})
        # The ticks take milliseconds: pad the step-rate window to 2 s
        # (the burn keeps running) so the rate is not a rounding of zero.
        while (time.monotonic() - window_start < 2.0
               and not stop.is_set()):
            time.sleep(0.1)
        elapsed = time.monotonic() - window_start
        steps_after, busy_after, flops_after = counters()
        result["workload_steps_per_s_during_bench"] = round(
            (steps_after - steps_before) / elapsed, 1) if elapsed else 0.0
        # The busy fraction over the same window: the duty-cycle analog
        # the step hook measures (about 1.0 while the burn runs).
        result["workload_busy_fraction_during_bench"] = round(
            (busy_after - busy_before) / elapsed, 3) if elapsed else 0.0
        # Per-card MFU over the window: the burn reports workload-global
        # FLOPs, so the per-card share divides by the card count (the
        # split the collector exports); None for a kind with no peak.
        peak = _kind_peak_flops(record.get("device_kind") or "")
        n_dev = max(1, collector._global_devices)
        result["workload_mfu_pct_during_bench"] = round(
            100.0 * (flops_after - flops_before) / n_dev
            / elapsed / peak, 2) if (peak and elapsed) else None
        stop.wait(burn_seconds + 60.0)
        burner.join(timeout=5.0)
        # The size sweep after the measurement, with the card free:
        # steady-state TFLOP/s per size. An extra datum: a failure is a
        # row, never the harness's failure.
        try:
            result["mfu_sweep"] = sweep_burn(
                (size // 2, size, size * 2), seconds_per_size=4.0,
                kernel="cuda", deadline_seconds=150.0, device=device)
        except Exception as exc:  # noqa: BLE001
            log.warning("embedded harness: sweep failed", exc_info=True)
            result["mfu_sweep"] = [{"error": f"{type(exc).__name__}: {exc}"}]
        return result
    except Exception as exc:  # noqa: BLE001 - recorded, then None
        record["error"] = f"{type(exc).__name__}: {exc}"
        log.warning("embedded harness failed", exc_info=True)
        return None


def build_slice_fixture(directory, workers: int = 64, chips: int = 4,
                        links: int = 6) -> list[str]:
    """Write ``workers`` worker expositions (full label sets, per-link
    interconnect rates) into ``directory`` and return the file-target
    paths: the 64-worker slice shared by :func:`measure_hub_merge` and
    :func:`measure_quiet_tick_delta`.

    The labels are the reference's byte for byte, ``accel_type``
    ``"tpu-v5p"`` and the ``v5p-256`` slice included: this is synthetic
    load, and the tests hold the two packages' fixtures and measurements
    byte-equal."""
    from . import schema
    from .registry import SnapshotBuilder

    targets = []
    for worker in range(workers):
        builder = SnapshotBuilder()
        for chip in range(chips):
            labels = (
                ("accel_type", "tpu-v5p"), ("chip", str(chip)),
                ("device_path", f"/dev/accel{chip}"), ("uuid", ""),
                ("pod", "trainer-0"), ("namespace", "ml"),
                ("container", "main"), ("slice", "v5p-256"),
                ("worker", str(worker)), ("topology", "8x8x4"))
            builder.add(schema.DEVICE_UP, 1.0, labels)
            builder.add(schema.DUTY_CYCLE, 50.0 + chip, labels)
            builder.add(schema.MEMORY_USED, 1.0e9, labels)
            builder.add(schema.MEMORY_TOTAL, 95.0e9, labels)
            builder.add(schema.POWER, 300.0, labels)
            for link in range(links):
                builder.add(schema.ICI_BANDWIDTH, 1e9,
                            labels + (("link", str(link)),))
        path = Path(directory) / f"w{worker}.prom"
        path.write_text(builder.build().render())
        targets.append(str(path))
    # The fixture is the idle steady state (bodies unchanged across
    # refreshes), so the files must look idle to the hub's stat short
    # cut too: a just-written mtime is inside the racily-clean settle
    # window and would send every refresh down the read + body-hash path,
    # a state no unchanged target stays in past one window.
    import os

    from .hub import _STAT_SIG_SETTLE_NS
    aged = time.time_ns() - 10 * _STAT_SIG_SETTLE_NS
    for target in targets:
        os.utime(target, ns=(aged, aged))
    return targets


def build_leaf_rollup_snapshot(leaf: int, workers: int, duty: float,
                               step_rate: float):
    """One leaf hub's rollup exposition (the ``--rollups-only`` shape a
    federation root ingests): ``slice_*`` aggregates plus per-worker step
    rates and per-node ``slice_target_up``, cardinality proportional to
    the workers."""
    from . import schema
    from .registry import SnapshotBuilder

    builder = SnapshotBuilder()
    slice_labels = (("slice", f"slice-{leaf:03d}"),)
    for worker in range(workers):
        builder.add(schema.HUB_TARGET_UP, 1.0,
                    (("target", f"http://node-{leaf:03d}-{worker:03d}"
                                f":9400/metrics"),))
    builder.add(schema.HUB_CHIPS, float(workers * 4), slice_labels)
    builder.add(schema.HUB_CHIPS_UP, float(workers * 4), slice_labels)
    builder.add(schema.HUB_WORKERS, float(workers), slice_labels)
    builder.add(schema.HUB_DUTY_MEAN, duty, slice_labels)
    builder.add(schema.HUB_DUTY_MIN, duty - 2.0, slice_labels)
    builder.add(schema.HUB_DUTY_MAX, duty + 2.0, slice_labels)
    builder.add(schema.HUB_MEMORY_USED, 1.0e9 * workers, slice_labels)
    builder.add(schema.HUB_MEMORY_TOTAL, 9.5e10 * workers, slice_labels)
    builder.add(schema.HUB_POWER, 300.0 * workers, slice_labels)
    for worker in range(workers):
        builder.add(schema.HUB_WORKER_STEPS,
                    step_rate + (worker % 7) * 0.01,
                    slice_labels + (("worker", f"w{worker:03d}"),))
    builder.add(schema.HUB_STRAGGLER_RATIO, 0.97, slice_labels)
    return builder.build()


@_guarded
@_native_switch
def measure_delta_federation(leaves: int = 64, workers_per_leaf: int = 64,
                             refreshes: int = 9,
                             native: bool = True) -> dict | None:
    """Root-hub cost at fleet scale over the push-delta protocol:
    ``leaves`` leaf hubs, each standing for ``workers_per_leaf`` workers,
    push rollup expositions into a federation root (push only, no pull):

    - ``root_merge_p50_ms``: warm root refresh wall time (the best spaced
      round's median) while every leaf's gauges churn each cycle: delta
      apply results, plan replay and rollup, no fetch or parse;
    - ``delta_ingest_ms_per_refresh``: the median wall time of applying
      one full wave of leaf delta frames (the POST handlers' work);
    - ``delta_bytes_per_refresh``: compressed wire bytes of one churn
      wave; ``full_bytes_total`` what a pull or a resync storm moves;
    - ``workers``: ``leaves * workers_per_leaf``.

    ``native=False`` measures the hub's Python paths (``Hub(native_ingest=
    False)`` with the process's snappy and delta decode on Python too)."""
    from .delta import DeltaEncoder
    from .hub import Hub

    root = Hub([], targets_provider=lambda: [], interval=10.0,
               federate=True, native_ingest=native)
    try:
        encoders = []
        full_bytes = 0
        for leaf in range(leaves):
            source = f"http://leaf-{leaf:03d}:9401/metrics"
            encoder = DeltaEncoder(source, generation=leaf + 1)
            body = build_leaf_rollup_snapshot(
                leaf, workers_per_leaf, 50.0, 4.0).render()
            wire, _ = encoder.encode_next(body)
            code, _resp, _hdrs = root.delta.handle(wire)
            assert code == 200, code
            encoder.ack()
            full_bytes += len(wire)
            encoders.append(encoder)
        start = time.monotonic()
        root.refresh_once()
        cold_ms = (time.monotonic() - start) * 1000.0

        def churn(round_no: int) -> tuple[float, int]:
            """Push one wave of changed-gauge deltas; returns (apply
            seconds, wire bytes)."""
            apply_seconds = 0.0
            nbytes = 0
            for leaf, encoder in enumerate(encoders):
                body = build_leaf_rollup_snapshot(
                    leaf, workers_per_leaf,
                    50.0 + round_no + leaf * 0.01,
                    4.0 + round_no * 0.1).render()
                wire, _ = encoder.encode_next(body)
                apply_start = time.monotonic()
                code, _resp, _hdrs = root.delta.handle(wire)
                apply_seconds += time.monotonic() - apply_start
                assert code == 200, code
                encoder.ack()
                nbytes += len(wire)
            return apply_seconds, nbytes

        warm = max(1, refreshes - 1)
        n_rounds = min(3, warm)
        medians = []
        ingest_ms: list[float] = []
        delta_bytes: list[int] = []
        round_no = 0
        for r in range(n_rounds):
            size = warm // n_rounds + (1 if r < warm % n_rounds else 0)
            walls = []
            for _ in range(size):
                round_no += 1
                apply_seconds, nbytes = churn(round_no)
                ingest_ms.append(apply_seconds * 1000.0)
                delta_bytes.append(nbytes)
                start = time.monotonic()
                root.refresh_once()
                walls.append((time.monotonic() - start) * 1000.0)
            if walls:
                medians.append(statistics.median(walls))
            if r + 1 < n_rounds:
                time.sleep(0.1)
        series_count = len(root.registry.snapshot().series)
    finally:
        root.stop()
    return {
        "workers": leaves * workers_per_leaf,
        "leaves": leaves,
        "root_merge_p50_ms": round(min(medians), 2),
        "root_merge_cold_ms": round(cold_ms, 2),
        "delta_ingest_ms_per_refresh": round(
            statistics.median(ingest_ms), 2),
        "delta_bytes_per_refresh": int(statistics.median(delta_bytes)),
        "full_bytes_total": full_bytes,
        "root_series": series_count,
    }


def build_pusher_body(worker: int, duty: float = 50.0,
                      power: float = 300.0) -> str:
    """One synthetic pusher's exposition for the ingest storm: a single
    chip's gauge surface (6 series). Small on purpose: the storm prices
    the hub's per-frame machinery (decode, session validation, slot
    patch) at fan-in, not body size. The labels are the reference's byte
    for byte (``accel_type`` ``"tpu-v5p"`` included): synthetic load, held
    byte-equal across the packages by the tests."""
    from . import schema
    from .registry import SnapshotBuilder

    builder = SnapshotBuilder()
    labels = (("accel_type", "tpu-v5p"), ("chip", "0"),
              ("device_path", "/dev/accel0"), ("uuid", ""),
              ("slice", f"s{worker % 32:02d}"),
              ("worker", str(worker)), ("topology", "4x4"))
    builder.add(schema.DEVICE_UP, 1.0, labels)
    builder.add(schema.DUTY_CYCLE, duty, labels)
    builder.add(schema.MEMORY_USED, 1.0e9, labels)
    builder.add(schema.MEMORY_TOTAL, 9.5e10, labels)
    builder.add(schema.POWER, power, labels)
    builder.add(schema.ICI_BANDWIDTH, 1e9, labels + (("link", "0"),))
    return builder.build().render()


def _churn_slots(body: str) -> list[int]:
    """Slot indices of the duty and power gauges in a pusher body: the
    same for every pusher (one builder shape)."""
    from .validate import parse_exposition_interned

    slot_by_name = {name: slot for slot, (name, _labels, _v)
                    in enumerate(parse_exposition_interned(body))}
    return sorted((slot_by_name["accelerator_duty_cycle"],
                   slot_by_name["accelerator_power_watts"]))


@_guarded
@_native_switch
def measure_ingest_storm(pushers: int = 10_000, waves: int = 3,
                         interval: float = 10.0,
                         storm_threads: int = 8,
                         lanes: int = 0, native: bool = True) -> dict | None:
    """The ingest storm: ``pushers`` synthesized delta sessions against
    one hub, frames made at the wire level (the publisher's diff is the
    pushers' CPU, not the hub's):

    - ``delta_ingest_10k_ms_per_refresh``: wall time of applying one full
      wave of per-pusher delta frames (two changed gauges each), the
      handler work one refresh interval absorbs; median over ``waves``;
    - ``ingest_cpu_pct``: that wave as a percent of the interval;
    - ``resync_storm_recovery_s``: a fleet-wide restart, every session
      re-POSTing a FULL with a new generation from ``storm_threads``
      threads, from the first frame to all applied plus the refresh that
      serves the fleet again;
    - ``resync_storm_dropped``: sessions lost across it (must be 0).

    ``native=False`` measures the hub's Python paths, as in
    :func:`measure_delta_federation`."""
    import concurrent.futures

    from .delta import encode_delta, encode_full
    from .hub import Hub

    hub = Hub([], targets_provider=lambda: [], interval=interval,
              ingest_lanes=lanes, native_ingest=native)
    try:
        sources = [f"http://node-{i:05d}:9400/metrics"
                   for i in range(pushers)]
        bodies = [build_pusher_body(i) for i in range(pushers)]
        churn_slots = _churn_slots(bodies[0])

        seed_start = time.monotonic()
        for i, source in enumerate(sources):
            code, _resp, _hdrs = hub.delta.handle(
                encode_full(source, i + 1, 1, bodies[i]))
            assert code == 200, code
        seed_s = time.monotonic() - seed_start
        start = time.monotonic()
        hub.refresh_once()
        cold_refresh_ms = (time.monotonic() - start) * 1000.0

        wave_ms: list[float] = []
        seq = 1
        for wave in range(waves):
            seq += 1
            wires = [
                encode_delta(
                    source, i + 1, seq,
                    [(churn_slots[0], 50.0 + wave + i * 1e-3),
                     (churn_slots[1], 300.0 + wave)])
                for i, source in enumerate(sources)]
            handle = hub.delta.handle
            start = time.monotonic()
            for wire in wires:
                code, _resp, _hdrs = handle(wire)
                assert code == 200, code
            wave_ms.append((time.monotonic() - start) * 1000.0)
        start = time.monotonic()
        hub.refresh_once()
        warm_refresh_ms = (time.monotonic() - start) * 1000.0
        assert hub._push_served == pushers, hub._push_served

        # The fleet-wide restart: every pusher back with a new generation
        # and one FULL, all at once, from concurrent threads (one handler
        # thread per POST in production).
        sessions_before = len(hub.delta.sources())
        storm_wires = [
            encode_full(source, i + 1 + 1_000_000, 1, bodies[i])
            for i, source in enumerate(sources)]

        def drain(chunk) -> None:
            handle = hub.delta.handle
            for wire in chunk:
                code, _resp, _hdrs = handle(wire)
                assert code == 200, code

        ways = max(1, storm_threads)
        per = -(-len(storm_wires) // ways)
        start = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(ways) as pool:
            futures = [pool.submit(drain, storm_wires[i:i + per])
                       for i in range(0, len(storm_wires), per)]
            for future in futures:
                future.result()
        hub.refresh_once()
        recovery_s = time.monotonic() - start
        sessions_after = len(hub.delta.sources())
        served_after = hub._push_served
    finally:
        hub.stop()
    return {
        "pushers": pushers,
        "lanes": hub.delta.lanes,
        "native": hub.delta.native_active,
        "seed_s": round(seed_s, 2),
        "cold_refresh_ms": round(cold_refresh_ms, 1),
        "warm_refresh_ms": round(warm_refresh_ms, 1),
        "delta_ingest_10k_ms_per_refresh": round(
            statistics.median(wave_ms), 1),
        "ingest_cpu_pct": round(
            100.0 * statistics.median(wave_ms) / (interval * 1000.0),
            2),
        "resync_storm_recovery_s": round(recovery_s, 2),
        "resync_storm_sessions": sessions_after,
        "resync_storm_dropped": sessions_before - sessions_after,
        "resync_storm_served": served_after,
    }


@_guarded
def measure_ingest_storm_procs(procs: int = 4, pushers: int = 10_000,
                               waves: int = 3, interval: float = 10.0,
                               client_threads: int = 16) -> dict | None:
    """The storm through the ``SO_REUSEPORT`` acceptor processes: the
    frames of :func:`measure_ingest_storm`, POSTed by real HTTP clients
    (one persistent connection per client thread) to the pool's public
    port, so the figure prices what ``--ingest-procs`` changes: accept,
    parse and relay across ``procs`` processes instead of one interpreter
    lock. Beside the wave's wall time it checks the conservation law: the
    children's accepted frames sum to the hub's own frame totals. None
    where the platform has no ``SO_REUSEPORT``."""
    import concurrent.futures
    import http.client
    import socket

    from .delta import CONTENT_TYPE, INGEST_PATH, encode_delta, encode_full
    from .hub import Hub
    from .ingestproc import IngestProcPool

    if not hasattr(socket, "SO_REUSEPORT"):
        return None
    hub = Hub([], targets_provider=lambda: [], interval=interval)
    pool = None
    try:
        pool = IngestProcPool(hub.delta.handle, host="127.0.0.1",
                              port=0, procs=procs, parent_port=0)
        pool.start()
        sources = [f"http://node-{i:05d}:9400/metrics"
                   for i in range(pushers)]
        bodies = [build_pusher_body(i) for i in range(pushers)]
        churn_slots = _churn_slots(bodies[0])

        def drain(chunk) -> None:
            conn = http.client.HTTPConnection(
                "127.0.0.1", pool.port, timeout=30.0)
            try:
                for wire in chunk:
                    conn.request(
                        "POST", INGEST_PATH, body=wire,
                        headers={"Content-Type": CONTENT_TYPE})
                    resp = conn.getresponse()
                    resp.read()
                    assert resp.status == 200, resp.status
            finally:
                conn.close()

        def blast(wires) -> float:
            ways = max(1, client_threads)
            per = -(-len(wires) // ways)
            start = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(ways) as tp:
                futures = [tp.submit(drain, wires[i:i + per])
                           for i in range(0, len(wires), per)]
                for future in futures:
                    future.result()
            return (time.monotonic() - start) * 1000.0

        seed_ms = blast([encode_full(source, i + 1, 1, bodies[i])
                         for i, source in enumerate(sources)])
        hub.refresh_once()
        wave_ms = []
        for wave in range(waves):
            wave_ms.append(blast([
                encode_delta(source, i + 1, wave + 2,
                             [(churn_slots[0], 50.0 + wave + i * 1e-3),
                              (churn_slots[1], 300.0 + wave)])
                for i, source in enumerate(sources)]))
        hub.refresh_once()
        ingest = hub.delta
        hub_frames = (ingest.full_frames_total
                      + ingest.delta_frames_total
                      + ingest.duplicate_frames_total)
        accepted = pool.accepted_total()
        per_proc = {idx: s["accepted"]
                    for idx, s in pool.proc_stats().items()}
    finally:
        if pool is not None:
            pool.stop()
        hub.stop()
    return {
        "procs": procs,
        "pushers": pushers,
        "seed_ms": round(seed_ms, 1),
        "delta_ingest_procs_ms_per_refresh": round(
            statistics.median(wave_ms), 1),
        "ingest_procs_cpu_pct": round(
            100.0 * statistics.median(wave_ms) / (interval * 1000.0),
            2),
        "accepted_total": accepted,
        "hub_frames_total": hub_frames,
        "conserved": accepted == hub_frames == pushers * (waves + 1),
        "per_proc_accepted": per_proc,
    }


@_guarded
def measure_warm_restart(pushers: int = 2_000, tail_fraction: float = 0.02,
                         interval: float = 10.0) -> dict | None:
    """Warm-restart recovery at fleet scale: seed ``pushers`` delta
    sessions mid-chain, checkpoint, advance a ``tail_fraction`` of them
    past the checkpoint (the crash window's tail), then kill the hub at
    exactly the checkpoint state and bring up a fresh one on the same
    file:

    - ``resumed_fraction``: sessions whose next DELTA landed 200 on the
      restarted hub (no 409, no FULL); only the tail may resync;
    - ``replay_s`` / ``recovery_s``: the background replay's wall time,
      and construction to the fleet served again by push;
    - ``dropped``: sessions lost across the restart (must be 0)."""
    import pathlib
    import tempfile

    from .delta import encode_delta, encode_full
    from .hub import Hub

    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "ingest.ckpt")
        sources = [f"http://node-{i:05d}:9400/metrics"
                   for i in range(pushers)]
        bodies = [build_pusher_body(i) for i in range(pushers)]
        churn_slots = _churn_slots(bodies[0])

        hub = Hub([], targets_provider=lambda: [], interval=interval,
                  ingest_checkpoint=path)
        try:
            for i, source in enumerate(sources):
                code, _resp, _hdrs = hub.delta.handle(
                    encode_full(source, i + 1, 1, bodies[i]))
                assert code == 200, code
            for i, source in enumerate(sources):
                code, _resp, _hdrs = hub.delta.handle(encode_delta(
                    source, i + 1, 2,
                    [(churn_slots[0], 51.0), (churn_slots[1], 301.0)]))
                assert code == 200, code
            hub.refresh_once()
            assert hub.delta.checkpoint(force=True)
            # The crash tail: a few sessions advance past the checkpoint,
            # exactly what a rate-limited write loses.
            tail = max(0, int(pushers * tail_fraction))
            for i in range(tail):
                code, _resp, _hdrs = hub.delta.handle(encode_delta(
                    sources[i], i + 1, 3,
                    [(churn_slots[0], 52.0), (churn_slots[1], 302.0)]))
                assert code == 200, code
            # Kill at the checkpoint state: stop() force-writes the newest
            # state (a clean shutdown), so the crash point is put back
            # from the bytes captured here.
            crash_state = pathlib.Path(path).read_bytes()
        finally:
            hub.stop()
        pathlib.Path(path).write_bytes(crash_state)

        recovery_start = time.monotonic()
        hub2 = Hub([], targets_provider=lambda: [], interval=interval,
                   ingest_checkpoint=path)
        try:
            hub2.delta.start_replay()
            while hub2.delta.replaying and \
                    time.monotonic() - recovery_start < 60.0:
                time.sleep(0.01)
            replay_s = time.monotonic() - recovery_start
            resumed = resynced = 0
            for i, source in enumerate(sources):
                seq = 4 if i < tail else 3
                code, _resp, _hdrs = hub2.delta.handle(encode_delta(
                    source, i + 1, seq,
                    [(churn_slots[0], 53.0), (churn_slots[1], 303.0)]))
                if code == 200:
                    resumed += 1
                else:
                    resynced += 1
                    code, _resp, _hdrs = hub2.delta.handle(
                        encode_full(source, i + 1, 1, bodies[i]))
                    assert code == 200, code
            hub2.refresh_once()
            recovery_s = time.monotonic() - recovery_start
            served = hub2._push_served
            warm_sessions = hub2.delta.warm_restart_sessions
        finally:
            hub2.stop()
    return {
        "pushers": pushers,
        "warm_restart_sessions": warm_sessions,
        "resumed_fraction": round(resumed / pushers, 4),
        "resyncs": resynced,
        "replay_s": round(replay_s, 2),
        "recovery_s": round(recovery_s, 2),
        "dropped": pushers - served,
    }


@_guarded
def measure_overload_shed(pushers: int = 256, lanes: int = 4,
                          delta_rate: float = 50.0,
                          waves: int = 4) -> dict | None:
    """Admission sheds under a publisher stampede: ``pushers``
    established sessions send delta waves far past the per-lane token
    budget, the wave order rotated so sheds land round-robin:

    - ``delta_shed``: deltas answered 429 + Retry-After (must be > 0: the
      guard engaged);
    - ``full_refused``: recovery FULLs refused mid-storm (must be 0:
      deltas are shed first);
    - ``sessions_alive`` / ``sources_served_fraction``: sessions left
      after the storm (all of them: a shed shapes load, never evicts) and
      the share of sources that landed at least one delta (fairness)."""
    from .delta import encode_delta, encode_full
    from .hub import Hub

    hub = Hub([], targets_provider=lambda: [], interval=10.0,
              ingest_lanes=lanes,
              ingest_delta_rate=delta_rate,
              ingest_max_inflight=64,
              ingest_max_sessions=pushers)
    try:
        sources = [f"http://node-{i:05d}:9400/metrics"
                   for i in range(pushers)]
        bodies = [build_pusher_body(i) for i in range(pushers)]
        churn_slots = _churn_slots(bodies[0])
        for i, source in enumerate(sources):
            code, _resp, _hdrs = hub.delta.handle(
                encode_full(source, i + 1, 1, bodies[i]))
            assert code == 200, code
        # The memory fence is at capacity: a new source is refused 503
        # while every established session keeps landing.
        code, _resp, hdrs = hub.delta.handle(
            encode_full("http://intruder:9400/metrics", 99, 1,
                        bodies[0]))
        fence_held = code == 503 and "Retry-After" in hdrs

        landed = [0] * pushers
        seqs = [1] * pushers
        gens = [i + 1 for i in range(pushers)]
        delta_shed = 0
        full_refused = 0
        for wave in range(waves):
            start = wave * (pushers // waves)  # rotate the shed burden
            order = list(range(start, pushers)) + list(range(start))
            for i in order:
                wire = encode_delta(
                    sources[i], gens[i], seqs[i] + 1,
                    [(churn_slots[0], 50.0 + wave),
                     (churn_slots[1], 300.0 + wave)])
                code, _resp, hdrs = hub.delta.handle(wire)
                if code == 200:
                    seqs[i] += 1
                    landed[i] += 1
                elif code == 429 and "Retry-After" in hdrs:
                    delta_shed += 1
                else:
                    raise AssertionError((code, _resp))
            # One recovery FULL mid-storm (a restarted worker): admitted
            # even while deltas shed.
            victim = (wave * 37) % pushers
            code, _resp, _hdrs = hub.delta.handle(encode_full(
                sources[victim], 1_000_000 + victim * 10 + wave, 1,
                bodies[victim]))
            if code != 200:
                full_refused += 1
            else:
                gens[victim] = 1_000_000 + victim * 10 + wave
                seqs[victim] = 1
        hub.refresh_once()
        alive = len(hub.delta.sources())
        served_sources = sum(1 for n in landed if n > 0)
        shed_counts = hub.delta.shed_total
    finally:
        hub.stop()
    return {
        "pushers": pushers,
        "delta_shed": delta_shed,
        "full_refused": full_refused,
        "fence_held": fence_held,
        "sessions_alive": alive,
        "sources_served_fraction": round(served_sources / pushers, 4),
        "shed_counts": shed_counts,
    }


@_guarded
def measure_cardinality_admission(pushers: int = 256, frames: int = 40,
                                  bomb_series: int = 100_000,
                                  bomb_frames: int = 4) -> dict | None:
    """The series accountant's cost:

    - ``cardinality_admission_ns_per_series``: the accountant's
      bookkeeping (admit + install) per ingested series, the ops a FULL
      apply pays on top of parse and entry build;
    - ``ingest_ns_per_series``: the whole ingest path's cost per series
      (a real hub, FULL frames through ``handle()``), the denominator;
    - ``cardinality_admission_overhead_pct``: the ratio of the two;
    - ``hub_rss_mb_under_bomb``: process RSS (MB) after a budgeted hub
      absorbs a label bomb (``bomb_frames`` FULLs of ``bomb_series``
      unique series each, clamped to a 500-series budget)."""
    from .cardinality import SeriesAccountant
    from .delta import encode_full
    from .hub import Hub

    series_per_full = 6
    sources = [f"http://adm-{i:05d}:9400/metrics"
               for i in range(pushers)]

    # (a) The bookkeeping alone, steady state: every source established
    # after the first rep, so admit takes its headroom path.
    acc = SeriesAccountant(
        budget_per_source=series_per_full,
        hard_cap=pushers * series_per_full * 2,
        high_watermark=pushers * series_per_full * 2)
    start = time.perf_counter()
    booked = 0
    for _rep in range(frames):
        for source in sources:
            admitted = acc.admit(source, series_per_full)
            acc.install(source, admitted, 600)
            booked += series_per_full
    admission_ns = (time.perf_counter() - start) / booked * 1e9

    # (b) The whole ingest path those ops ride on.
    hub = Hub([], targets_provider=lambda: [], interval=10.0,
              ingest_lanes=2, ingest_max_sessions=pushers + 8,
              series_budget_per_source=500,
              series_hard_cap=pushers * series_per_full + 1000,
              series_high_watermark=pushers * series_per_full + 1000)
    try:
        bodies = [build_pusher_body(i) for i in range(pushers)]
        wires = [encode_full(sources[i], i + 1, 1, bodies[i])
                 for i in range(pushers)]
        for wire in wires:  # establish the sessions, untimed
            code, _resp, _hdrs = hub.delta.handle(wire)
            assert code == 200, code
        start = time.perf_counter()
        ingested = 0
        for rep in range(max(2, frames // 8)):
            for i, source in enumerate(sources):
                code, _resp, _hdrs = hub.delta.handle(encode_full(
                    source, i + 1, rep + 2, bodies[i]))
                assert code == 200, code
                ingested += series_per_full
        ingest_ns = (time.perf_counter() - start) / ingested * 1e9

        # (c) RSS after a label bomb, clamped: the unique series must
        # not accumulate.
        bomb = "http://bomb:9400/metrics"
        for rep in range(bomb_frames):
            lines = ["# TYPE accelerator_duty_cycle gauge"]
            lines += [
                f'accelerator_duty_cycle{{pod="b-{rep}-{j}",'
                f'slice="zz",worker="bomb"}} 1'
                for j in range(bomb_series)]
            code, _resp, _hdrs = hub.delta.handle(encode_full(
                bomb, 900_000, rep + 1, "\n".join(lines) + "\n"))
            assert code == 200, code
        rss_kb = 0
        with open("/proc/self/status") as handle:
            for line in handle:
                if line.startswith("VmRSS:"):
                    rss_kb = int(line.split()[1])
                    break
        bomb_live = hub.cardinality.live_series()
    finally:
        hub.stop()
    return {
        "cardinality_admission_ns_per_series": round(admission_ns, 1),
        "ingest_ns_per_series": round(ingest_ns, 1),
        "cardinality_admission_overhead_pct": round(
            admission_ns / ingest_ns * 100.0, 3),
        "hub_rss_mb_under_bomb": round(rss_kb / 1024.0, 1),
        "bomb_series_attempted": bomb_series * bomb_frames,
        "bomb_live_series": bomb_live,
    }


# Per-reader request period of measure_query_serving: about 2 Hz per
# dashboard panel, so 256 readers offer ~512 requests/s, sustained rather
# than phase-locked.
_QUERY_PERIOD_S = 0.5


@_guarded
def measure_query_serving(readers: int = 256,
                          requests_per_reader: int = 6,
                          pushers: int = 16,
                          conditional_scrapes: int = 200) -> dict | None:
    """The dashboard read path:

    - ``query_p99_ms_256readers`` (and p50): ``GET /query`` latency with
      ``readers`` concurrent clients against a live-refreshing hub, the
      stampede the pre-rendered response cache exists for;
    - ``scrape_304_ratio``: the share of ``If-None-Match`` scrapes of
      ``/metrics`` answered 304 under a steady generation;
    - ``history_write_ns_per_refresh``: the ring's write cost folded into
      one refresh (record staging + tier commit);
    - ``history_rss_mb``: the ring's preallocated slab bytes."""
    import http.client
    import threading

    from .delta import encode_full
    from .exposition import MetricsServer
    from .history import HistoryStore
    from .hub import Hub
    from .supervisor import spawn

    # qps=0: admission off. Every reader here shares 127.0.0.1, and this
    # measures serving latency, not the shed discipline.
    store = HistoryStore(query_qps=0.0)
    hub = Hub([], targets_provider=lambda: [], interval=10.0,
              push_fence=1e9, ingest_lanes=2,
              ingest_max_sessions=pushers + 8, history=store)
    server = MetricsServer(hub.registry, host="127.0.0.1", port=0,
                           max_concurrent_scrapes=0,
                           ingest_provider=hub.delta.handle,
                           history_provider=store,
                           prewarm_renders=False)
    server.start()
    try:
        sources = [f"http://qry-{i:04d}:9400/metrics"
                   for i in range(pushers)]
        for i, source in enumerate(sources):
            code, _resp, _hdrs = hub.delta.handle(encode_full(
                source, i + 1, 1, build_pusher_body(i)))
            assert code == 200, code
        hub.refresh_once()
        hub.refresh_once()

        port = server.port
        stop_refresh = threading.Event()

        def refresher() -> None:
            # Readers must ride generation churn, not a frozen cache.
            while not stop_refresh.is_set():
                hub.refresh_once()
                stop_refresh.wait(0.05)

        def get(path: str, headers: dict | None = None):
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=10.0)
            try:
                conn.request("GET", path, headers=headers or {})
                resp = conn.getresponse()
                body = resp.read()
                return resp.status, dict(resp.getheaders()), body
            finally:
                conn.close()

        latencies: list[float] = []
        lat_lock = threading.Lock()
        barrier = threading.Barrier(readers + 1)

        def reader(idx: int) -> None:
            # One persistent connection per reader (HTTP/1.1 keep-alive,
            # as a dashboard holds one): a request costs parse and
            # respond, not connect, thread spawn and teardown.
            mine: list[float] = []
            path = ("/query?family=slice_chips&window=1h"
                    if idx % 2 else
                    "/query?family=slice_duty_cycle_mean&window=1h")
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=10.0)
            # Connect before the barrier: the dashboards are connected
            # when the reload storm hits; the accept burst is set-up.
            conn.connect()
            barrier.wait()
            # Uniform phase jitter over one period: dashboards are never
            # phase-locked to the microsecond, and simultaneous arrivals
            # would measure a self-made convoy.
            time.sleep(idx * (_QUERY_PERIOD_S / max(1, readers)))
            try:
                for _r in range(requests_per_reader):
                    start = time.perf_counter()
                    conn.request("GET", path)
                    resp = conn.getresponse()
                    resp.read()
                    mine.append(time.perf_counter() - start)
                    assert resp.status == 200, resp.status
                    # Refresh pacing, not a busy spin.
                    time.sleep(_QUERY_PERIOD_S)
            finally:
                conn.close()
            with lat_lock:
                latencies.extend(mine)

        refresh_thread = spawn(refresher, name="bench-query-refresh")
        refresh_thread.start()
        threads = [spawn(reader, name=f"bench-query-reader-{i}",
                         args=(i,))
                   for i in range(readers)]
        for thread in threads:
            thread.start()
        barrier.wait()
        for thread in threads:
            thread.join(timeout=60.0)
        stop_refresh.set()
        refresh_thread.join(timeout=10.0)

        latencies.sort()
        p50 = statistics.median(latencies)
        p99 = latencies[int(len(latencies) * 0.99) - 1]

        # The 304 ratio under a steady generation.
        _status, hdrs, _body = get("/metrics")
        etag = hdrs.get("ETag", "")
        hits = 0
        for _r in range(conditional_scrapes):
            status, hdrs, _body = get(
                "/metrics", {"If-None-Match": etag})
            if status == 304:
                hits += 1
            else:
                etag = hdrs.get("ETag", etag)
        ratio = hits / conditional_scrapes

        write_ns = (store.write_ns_total / store.commits_total
                    if store.commits_total else 0.0)
    finally:
        server.stop()
        hub.stop()
    return {
        "query_p50_ms_256readers": round(p50 * 1000.0, 3),
        "query_p99_ms_256readers": round(p99 * 1000.0, 3),
        "scrape_304_ratio": round(ratio, 3),
        "history_write_ns_per_refresh": round(write_ns, 0),
        "history_rss_mb": round(store.bytes() / 1e6, 3),
        "query_requests": len(latencies),
    }


@_guarded
def measure_partition_drain(frames: int = 200,
                            drain_rate: float = 1e9) -> dict | None:
    """Egress through a partition: spool ``frames`` snapshots into a disk
    spill queue (fsynced, the write a partitioned node pays per tick),
    then drain them over real HTTP into a push hub:

    - ``spill_spool_ms_per_frame``: the fsynced spool cost per published
      snapshot while offline;
    - ``spill_bytes_per_tick``: on-disk bytes per spooled snapshot
      (snappy + framing), the input of spool sizing;
    - ``partition_drain_frames_per_s``: the drain's throughput over real
      HTTP with no rate limit (the ceiling ``--hub-drain-rate`` caps);
    - ``partition_catchup_s``: reconnect to backlog empty for the
      ``frames``-deep backlog at that ceiling.

    None when the drain wedges (not a representative number)."""
    import pathlib
    import tempfile

    from . import schema
    from .delta import DeltaPublisher
    from .exposition import MetricsServer
    from .hub import Hub
    from .registry import SnapshotBuilder
    from .spillq import SpillQueue

    with tempfile.TemporaryDirectory() as tmp:
        worker = Registry()

        def publish(value: float) -> None:
            builder = SnapshotBuilder()
            labels = (("accel_type", "tpu-v5p"), ("chip", "0"),
                      ("device_path", "/dev/accel0"), ("uuid", ""))
            builder.add(schema.DEVICE_UP, 1.0, labels)
            builder.add(schema.DUTY_CYCLE, value, labels)
            builder.add(schema.MEMORY_USED, 1.0e9 + value, labels)
            builder.add(schema.MEMORY_TOTAL, 9.5e10, labels)
            builder.add(schema.POWER, 300.0 + value, labels)
            worker.publish(builder.build())

        spill = SpillQueue(str(pathlib.Path(tmp) / "spill"), fsync=True)
        publish(0.0)
        body = worker.rendered()[0].decode()
        spool_start = time.perf_counter()
        for _ in range(frames):
            spill.spool(time.time(), body)
        spool_ms = ((time.perf_counter() - spool_start)
                    / frames * 1000.0)
        bytes_per_tick = spill.bytes_pending() / max(1, spill.depth())

        hub = Hub([], targets_provider=lambda: [], interval=10.0,
                  push_fence=1e9)
        server = MetricsServer(hub.registry, host="127.0.0.1", port=0,
                               ingest_provider=hub.delta.handle)
        server.start()
        publisher = DeltaPublisher(
            worker, f"http://127.0.0.1:{server.port}",
            source="bench-node", spill=spill, drain_rate=drain_rate)
        try:
            drain_start = time.perf_counter()
            deadline = drain_start + 120.0
            while spill.depth() and time.perf_counter() < deadline:
                publisher.push_once()
            catchup_s = time.perf_counter() - drain_start
            drained = spill.drained_total
        finally:
            publisher.stop()
            server.stop()
            hub.stop()
        if spill.depth():
            log.warning("partition drain wedged with %d frames left",
                        spill.depth())
            return None
        return {
            "frames": frames,
            "spill_spool_ms_per_frame": round(spool_ms, 4),
            "spill_bytes_per_tick": round(bytes_per_tick, 1),
            "partition_drain_frames_per_s": round(
                drained / max(catchup_s, 1e-9), 1),
            "partition_catchup_s": round(catchup_s, 3),
            "spill_dropped": spill.dropped_total,
        }


@_guarded
def measure_degraded_overhead(ticks: int = 200,
                              budget_ms: float = 50.0) -> dict | None:
    """The disk-backed stores' cost on the tick path: one spill spool (the
    delta publisher's offline write) and one energy observe + forced
    checkpoint per tick, measured healthy (fsync to a real temporary
    directory) and degraded (both stores' durability state machines
    latched on a full disk, so every op takes the gated in-memory path).

    ``degraded_overhead_pct`` is the degraded per-tick cost as a percent
    of the 50 ms tick budget; by design degraded is cheaper than healthy
    (no fsync, no syscalls between probes)."""
    import errno as errno_mod
    import pathlib
    import tempfile

    from . import wal
    from .energy import EnergyAccountant
    from .spillq import SpillQueue

    body = "x" * 4096

    def run_ticks(spill: SpillQueue, acct: EnergyAccountant) -> float:
        start = time.perf_counter()
        for i in range(ticks):
            spill.spool(float(i), body)
            acct.observe("dev0", "pod", "ns", float(i + 1), 100.0)
            acct.checkpoint(force=True)
        return (time.perf_counter() - start) / ticks * 1000.0

    try:
        with tempfile.TemporaryDirectory() as tmp:
            base = pathlib.Path(tmp)
            spill = SpillQueue(str(base / "spill"), fsync=True)
            acct = EnergyAccountant(
                checkpoint_path=str(base / "energy.json"),
                checkpoint_interval=0.0)
            healthy_ms = run_ticks(spill, acct)
            spill.close()
        with tempfile.TemporaryDirectory() as tmp:
            base = pathlib.Path(tmp)
            spill = SpillQueue(str(base / "spill"), fsync=True)
            acct = EnergyAccountant(
                checkpoint_path=str(base / "energy.json"),
                checkpoint_interval=0.0)
            # Latch both stores degraded with the probe far away: every
            # tick op takes the in-memory path, what a long ENOSPC
            # episode costs per tick.
            for label in ("spill", "energy"):
                health = wal.store_health(label)
                health.probe_interval = 3600.0
                health.record_fault(
                    OSError(errno_mod.ENOSPC, "bench: disk full"))
            degraded_ms = run_ticks(spill, acct)
            lost = wal.store_health("spill").lost_records
            spill.close()
    finally:
        wal.reset_store_stats()
    return {
        "healthy_store_ms_per_tick": round(healthy_ms, 4),
        "degraded_store_ms_per_tick": round(degraded_ms, 4),
        "degraded_overhead_pct": round(
            degraded_ms / budget_ms * 100.0, 3),
        "degraded_lost_counted": lost,
    }


@_guarded
def measure_burst_overhead(ticks: int = 200, chips: int = 8,
                           hz: float = 100.0, budget_ms: float = 50.0,
                           thread_seconds: float = 1.0) -> dict | None:
    """The burst sampler's cost, in two parts on two budgets:

    - ``burst_overhead_pct``: its cost on the tick path, the drain and
      fold of one interval's samples (``hz`` per device), as a percent of
      the 50 ms tick budget: the p50 tick wall delta between two mock
      loops, one folding a full ring per tick, one with no sampler (the
      sampling thread runs beside the loop, never inside it);
    - ``burst_samples_per_sec``: the real thread's sampling rate at
      ``hz`` over ``chips`` devices (about ``hz * chips``);
    - ``burst_thread_cpu_pct``: the sampling thread's CPU share while
      armed (``read_seconds_total`` over the wall time)."""
    from .burstsampler import BurstSampler
    from .collectors.mock import MockCollector

    def tick_p50(with_burst: bool) -> float:
        collector = MockCollector(chips)
        devices = collector.discover()
        sampler = (BurstSampler(lambda: collector, lambda: devices,
                                hz=hz, mode="continuous")
                   if with_burst else None)
        loop = PollLoop(collector, Registry(), deadline=budget_ms / 1e3,
                        burst_sampler=sampler)
        walls = []
        per_device = max(1, int(hz))  # one 1 Hz interval's worth
        for tick in range(ticks):
            if sampler is not None:
                t = float(tick)
                for dev in devices:
                    for i in range(per_device):
                        sampler.inject(dev.device_id,
                                       t + i / per_device, 100.0 + i)
            start = time.perf_counter_ns()
            loop.tick()
            walls.append(time.perf_counter_ns() - start)
        loop.stop()
        walls.sort()
        return _percentile(walls, 0.50) / 1e6  # ms

    base_ms = tick_p50(False)
    burst_ms = tick_p50(True)
    overhead_ms = max(0.0, burst_ms - base_ms)

    # The real thread's rate over the mock read path.
    collector = MockCollector(chips)
    devices = collector.discover()
    sampler = BurstSampler(lambda: collector, lambda: devices,
                           hz=hz, mode="continuous")
    sampler.start()
    time.sleep(thread_seconds)
    sampler.stop()
    drained = sum(len(sampler.drain(d.device_id)) for d in devices)
    return {
        "burst_overhead_pct": round(100.0 * overhead_ms / budget_ms, 3),
        "burst_fold_ms_per_tick": round(overhead_ms, 4),
        "burst_samples_per_sec": round(drained / thread_seconds, 1),
        "burst_thread_cpu_pct": round(
            100.0 * sampler.read_seconds_total / thread_seconds, 2),
    }


@_guarded
def measure_hoststats(reads: int = 50, pods: int = 8) -> dict | None:
    """The host-signals collector's cost: p50 wall time of one whole
    ``HostStats.read()`` over a fixture tree (PSI x3, ``/proc/stat``,
    ``/proc/softirqs``, one NIC, one thermal zone, a throttle counter and
    ``pods`` pod cgroups). The read runs on the sampler pool in the
    pipelined idle window, never inside the tick, so this prices the
    pool's occupancy per tick."""
    import tempfile
    import uuid as uuid_mod

    from .hoststats import HostStats
    from .testing import host_fixture

    with tempfile.TemporaryDirectory() as tmp:
        roots = host_fixture.make_host_tree(Path(tmp))
        for i in range(1, pods):
            host_fixture.write_pod_cgroup(
                roots["cgroup"],
                str(uuid_mod.uuid5(uuid_mod.NAMESPACE_DNS,
                                   f"bench-pod-{i}")))
        host = HostStats(proc_root=str(roots["proc"]),
                         sysfs_root=str(roots["sysfs"]),
                         cgroup_root=str(roots["cgroup"]))
        host.read()  # warm caches and rate baselines
        walls = []
        for _ in range(reads):
            start = time.perf_counter_ns()
            snap = host.read()
            walls.append(time.perf_counter_ns() - start)
        walls.sort()
        return {
            "hoststats_read_ms_per_tick": round(
                _percentile(walls, 0.50) / 1e6, 4),
            "hoststats_read_p99_ms": round(
                _percentile(walls, 0.99) / 1e6, 4),
            "hoststats_families": len(snap.pressure) + len(snap.pods),
        }


@_guarded
def measure_quiet_tick_delta() -> dict | None:
    """The publisher's payload on a quiet tick: one worker exposition,
    one tick with one gauge changed, FULL against DELTA wire bytes."""
    import tempfile

    from .delta import DeltaEncoder

    with tempfile.TemporaryDirectory() as tmp:
        target = build_slice_fixture(tmp, workers=1, chips=4)[0]
        body = Path(target).read_text()
    encoder = DeltaEncoder("bench-worker", generation=1)
    wire_full, _ = encoder.encode_next(body)
    encoder.ack()
    # A quiet tick: the body is value-identical but for one gauge.
    lines = body.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("accelerator_duty_cycle{") and '"0"' in line:
            lines[i] = line.rsplit(" ", 1)[0] + " 51.5"
            break
    quiet = "\n".join(lines) + "\n"
    wire_delta, _ = encoder.encode_next(quiet)
    encoder.ack()
    return {
        "full_bytes": len(wire_full),
        "quiet_delta_bytes": len(wire_delta),
        "ratio": round(len(wire_full) / max(1, len(wire_delta)), 1),
    }


@_guarded
@_native_switch
def measure_hub_merge(workers: int = 64, chips: int = 4,
                      refreshes: int = 9, native: bool = True) -> dict | None:
    """The hub's pull ingest and merge over a 64-worker slice
    (:func:`build_slice_fixture`), merged and rolled up by the real hub:

    - ``p50_ms``: steady-state refresh wall time, the best spaced round's
      median over the warm refreshes (2..N). The bodies are static, the
      idle steady state: the body-cache and incremental-merge path;
    - ``cold_ms``: the first refresh (every body parsed, every merge plan
      built), the worst case a target-set change brings back;
    - ``body_cache_hit_rate``: the hit share over all fetches;
    - ``parse_mb_per_s``: ``parse_exposition_interned`` throughput over
      the fixture bodies, the variant the hub's ingest calls;
    - ``render_cache_hits``: hits over 4 back-to-back renders of the
      final merged snapshot (3 expected: one render per generation);
    - ``fleet_score_ms_per_refresh``: the mean of the fleet lens's
      ``fleet_score`` phase from the hub's own flight recorder.

    ``native=False`` measures the hub's Python paths, as in
    :func:`measure_delta_federation`."""
    import tempfile

    from .hub import Hub
    from .validate import parse_exposition_interned

    with tempfile.TemporaryDirectory() as tmp:
        targets = build_slice_fixture(tmp, workers, chips)
        bodies = [Path(t).read_text() for t in targets]
        hub = Hub(targets, native_ingest=native)
        try:
            start = time.monotonic()
            hub.refresh_once()
            cold_ms = (time.monotonic() - start) * 1000.0
            # Spaced rounds, the best round's median: a shared host's
            # noise burst outlasts a ~10 ms refresh, so one contiguous
            # run's median can be all burst.
            warm = max(0, refreshes - 1)
            n_rounds = min(3, warm) or 1
            medians = []
            for r in range(n_rounds):
                size = warm // n_rounds + (1 if r < warm % n_rounds
                                           else 0)
                walls = []
                for _ in range(size):
                    start = time.monotonic()
                    hub.refresh_once()
                    walls.append((time.monotonic() - start) * 1000.0)
                if walls:
                    medians.append(statistics.median(walls))
                if r + 1 < n_rounds:
                    time.sleep(0.1)
            hits = hub._body_cache_hits
            render_hits = 0
            for _ in range(4):
                _, hit = hub.registry.rendered()
                render_hits += int(hit)
            fleet_phase = hub.tracer.ticks_summary()["phases"].get(
                "fleet_score")
            fleet_score_ms = (fleet_phase["mean_ms"]
                              if fleet_phase else None)
        finally:
            hub.stop()
    parse_start = time.monotonic()
    for body in bodies:
        parse_exposition_interned(body)
    parse_seconds = time.monotonic() - parse_start
    total_bytes = sum(len(b) for b in bodies)
    return {
        "p50_ms": round(min(medians) if medians else cold_ms, 1),
        "cold_ms": round(cold_ms, 1),
        "body_cache_hit_rate": round(
            hits / float(refreshes * workers), 3),
        "parse_mb_per_s": round(
            total_bytes / parse_seconds / 1e6, 1) if parse_seconds
        else None,
        "render_cache_hits": render_hits,
        "fleet_score_ms_per_refresh": fleet_score_ms,
    }


@_guarded
def measure_fleet_localize(workers: int = 64,
                           refreshes: int = 60) -> dict | None:
    """The link localizer's pass: median wall time of one
    ``LinkLocalizer.observe`` over an 8x8-torus fleet (64 workers, 6 link
    labels each, 256 endpoint views baselined per refresh). It runs under
    the fleet lens's lock on the hub's refresh thread, so its cost is
    refresh latency.

    Deterministic: the rates carry an index-derived jitter (no RNG), and
    one link degrades mid-run so the verdict bookkeeping is on the
    measured path."""
    from . import linkloc

    loc = linkloc.LinkLocalizer()
    node_ids = [str(i) for i in range(workers)]
    labels = ("x0", "x1", "y0", "y1", "z0", "z1")

    def evidence(r: int, degraded: bool) -> dict:
        nodes = {}
        for i, worker in enumerate(node_ids):
            links = {}
            for li, label in enumerate(labels):
                rate = 3e7 + ((i * 31 + r * 17 + li * 7) % 13) * 1e4
                # The shared edge 0-1 degrades mid-run (8x8 row-major:
                # worker 0's y1 and worker 1's y0 are one link), so a
                # verdict forms and clears inside the window.
                if degraded and (worker, label) in (("0", "y1"),
                                                    ("1", "y0")):
                    rate *= 0.1
                links[label] = rate
            nodes[worker] = {"links": links, "topology": "8x8",
                             "anomalies": set(), "host": False,
                             "target": f"http://w{worker}"}
        return nodes

    now = 1_000_000.0
    walls = []
    for r in range(refreshes):
        nodes = evidence(r, degraded=refreshes // 3 < r
                         < 2 * refreshes // 3)
        start = time.perf_counter()
        loc.observe(now, nodes)
        walls.append((time.perf_counter() - start) * 1000.0)
        now += 10.0
    return {"fleet_localize_ms": round(statistics.median(walls), 3)}


@_guarded
def measure_efficiency_score(workers: int = 64,
                             refreshes: int = 60) -> dict | None:
    """The waste-scoring pass: median wall time of one
    ``EfficiencyLens.observe`` over a 64-pod fleet (duty, power, steps and
    joules folds, verdict streaks, ranking). Like the localizer it runs
    under the fleet lens's lock on the refresh thread.

    Deterministic: index-derived jitter (no RNG), one pod parks idle
    mid-run so a verdict raises and clears, and one pod rides blind (the
    UNKNOWN gate)."""
    from . import efficiency

    lens = efficiency.EfficiencyLens(warmup_refreshes=5,
                                     idle_refreshes=4)
    keys = [(f"train-{i}", "ml") for i in range(workers)]

    def evidence(r: int, idle: bool) -> dict:
        pods = {}
        for i, key in enumerate(keys):
            if i == workers - 1:
                # The blind pod: no duty evidence, zero coverage.
                pods[key] = {"duty": None, "power": None,
                             "steps": None, "chips": 4,
                             "joules": None, "coverage": 0.0}
                continue
            duty = 60.0 + ((i * 31 + r * 17) % 13)
            steps = 5.0 + ((i * 7 + r * 3) % 5) * 0.25
            if idle and i == 0:
                # Pod 0 idles mid-run: the verdict forms and clears
                # inside the window.
                duty, steps = 0.0, 0.0
            pods[key] = {"duty": duty, "power": 4.0 * duty,
                         "steps": steps, "chips": 4,
                         "joules": 1000.0 * i + 40.0 * r,
                         "coverage": 0.9}
        return pods

    now = 1_000_000.0
    walls = []
    for r in range(refreshes):
        pods = evidence(r, idle=refreshes // 3 < r
                        < 2 * refreshes // 3)
        start = time.perf_counter()
        lens.observe(r + 1, now, pods)
        walls.append((time.perf_counter() - start) * 1000.0)
        now += 10.0
    return {"fleet_efficiency_ms_per_refresh":
            round(statistics.median(walls), 3)}
