"""Share of the window's renders served from the per-generation cache:
``kts_render_cache_hits_total`` over hits plus misses, as deltas (program
counter, read from /metrics)."""

from h100bench.core.readers import delta


def read(ctx):
    hits, misses = delta(ctx, "cache_hits"), delta(ctx, "cache_misses")
    if hits is None or misses is None or hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)
