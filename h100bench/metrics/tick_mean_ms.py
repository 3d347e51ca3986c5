"""Mean poll tick over the window: ``collector_poll_duration_seconds`` sum
over count, as deltas (program counter, read from /metrics)."""

from h100bench.core.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "poll_sum", "poll_count")
