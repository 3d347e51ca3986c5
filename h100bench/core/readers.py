"""Arithmetic the metric readers share: scrape latency percentiles, deltas
of the program's counters over the window, and which traced kernels belong
to which part of the burn step."""

from h100bench.core.common import percentile

# B1 is the kernel of ``csrc/tiled_gemm.cu``; the epilogue is the tanh and
# the bf16 cast that follow it.
B1 = "gemm_bf16_f32"


def latency_ms(ctx, q):
    values = sorted(
        (s["latency_s"] if s["ok"] else max(s["latency_s"], s["timeout_s"]))
        * 1e3
        for s in ctx["scrapes"])
    return percentile(values, q) if values else None


def delta(ctx, key):
    c = ctx["counters"]
    if not c or c["first"].get(key) is None or c["last"].get(key) is None:
        return None
    return c["last"][key] - c["first"][key]


def mean_ms(ctx, sum_key, count_key):
    total, count = delta(ctx, sum_key), delta(ctx, count_key)
    if not total or not count:
        return None
    return 1e3 * total / count


def is_b1(name):
    return B1 in name


def is_epilogue(name):
    lowered = name.lower()
    return not is_b1(name) and ("tanh" in lowered or "copy" in lowered)
