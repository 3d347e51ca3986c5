"""Each metric's reader on a made-up context, and the trace reduction on a
made-up Chrome trace."""

from __future__ import annotations

import json

import pytest

from h100bench.core import manifest, trace

EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "gemm_bf16_f32(CUtensorMap)", "ts": 0.0, "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel<tanh>", "ts": 100.0, "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": "unrolled_elementwise_kernel<copy>", "ts": 140.0, "dur": 20.0},
    {"ph": "X", "cat": "kernel", "name": "gemm_bf16_f32(CUtensorMap)", "ts": 200.0, "dur": 100.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize", "ts": 150.0, "dur": 60.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 125.0, "dur": 10.0},
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5.0},
]


@pytest.fixture
def traced(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return trace.load(str(path))


def _ctx(traced=None, **extra):
    ctx = {"trace": traced, "size": 4096, "peaks": (989e12, 3.35e12),
           "window_s": 2.0, "steps": 7000, "setup_s": 12.5,
           "scrapes": [], "counters": {}}
    ctx.update(extra)
    return ctx


def read(name, ctx):
    return manifest.reader(name)(ctx)


def test_the_trace_reduces_to_busy_window_and_gaps(traced):
    assert traced.window_us == 300.0
    assert traced.busy_us == 250.0
    assert traced.gaps() == [(130.0, 140.0), (160.0, 200.0)]
    out = trace.breakdown(traced)
    assert out["device_ops"][0] == ["gemm_bf16_f32(CUtensorMap)", 200e-6]
    assert out["idle_gaps"] == [["cudaEventSynchronize", 40e-6],
                                ["cudaLaunchKernel", 10e-6]]


def test_the_device_readers(traced):
    ctx = _ctx(traced)
    least = 2 * 2 * 4096 ** 3 / 989e12
    assert read("b1_roofline_pct", ctx) == pytest.approx(100 * least / 200e-6)
    assert read("epilogue_pct", ctx) == pytest.approx(100 * 50 / 250)
    assert read("device_idle_pct", ctx) == pytest.approx(100 * 50 / 300)
    assert read("step_mfu", ctx) == pytest.approx(100 * least / 300e-6)
    # A size at which the bytes bound B1.
    small = _ctx(traced, size=128, peaks=(989e12, 1e9))
    assert read("b1_roofline_pct", small) == pytest.approx(
        100 * 2 * 8 * 128 ** 2 / 1e9 / 200e-6)


def test_device_readers_find_nothing_without_a_trace():
    for name in ("b1_roofline_pct", "epilogue_pct", "device_idle_pct",
                 "step_mfu"):
        assert read(name, _ctx()) is None


def test_the_host_clock_readers():
    scrapes = [{"ok": True, "latency_s": v / 1e3, "timeout_s": 10}
               for v in range(1, 101)]
    scrapes[-1] = {"ok": False, "latency_s": 0.2, "timeout_s": 10}
    ctx = _ctx(scrapes=scrapes)
    assert read("steps_per_s", ctx) == 3500.0
    assert read("setup_s", ctx) == 12.5
    assert read("scrape_p50_ms", ctx) == pytest.approx(51.0)
    assert read("scrape_p95_ms", ctx) == pytest.approx(95.0)
    # The failed scrape counts at its scraper's timeout.
    assert read("scrape_p95_ms", _ctx(scrapes=scrapes[-10:])) == 10_000.0


def test_the_counter_readers():
    first = {"poll_sum": 1.0, "poll_count": 10, "http_sum": 0.5,
             "http_count": 100, "cache_hits": 90, "cache_misses": 10}
    last = {"poll_sum": 1.03, "poll_count": 40, "http_sum": 0.56,
            "http_count": 340, "cache_hits": 300, "cache_misses": 40}
    ctx = _ctx(counters={"first": first, "last": last})
    assert read("tick_mean_ms", ctx) == pytest.approx(1.0)
    assert read("render_mean_ms", ctx) == pytest.approx(0.25)
    assert read("render_cache_hit_pct", ctx) == pytest.approx(87.5)
    for name in ("tick_mean_ms", "render_mean_ms", "render_cache_hit_pct"):
        assert read(name, _ctx()) is None
