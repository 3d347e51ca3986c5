"""Mean render of an HTTP scrape over the window:
``collector_scrape_duration_seconds{output="http"}`` sum over count, as
deltas (program counter, read from /metrics)."""

from h100bench.core.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "http_sum", "http_count")
