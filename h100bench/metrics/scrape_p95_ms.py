"""95th percentile latency of all scrapes due in the window (host clock)."""

from h100bench.core.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 0.95)
