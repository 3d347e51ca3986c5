"""Flight-recorder digest on every snapshot.

The port keeps only ``contribute_trace_digest`` of the reference's fleet
lens: the daemon-side half of slow-node attribution.
"""

from __future__ import annotations

from . import schema


def contribute_trace_digest(builder, tracer) -> None:
    """Fold a flight recorder's phase digest into a snapshot — the
    node-side half of slow-node attribution (poll.py calls this from
    the snapshot tail). Emits nothing
    until a trace has recorded, and nothing at all when tracing is
    disabled (the families are documented as absent under --no-trace,
    and a disabled recorder has no data to digest)."""
    if not getattr(tracer, "enabled", False):
        return
    for phase, (p50, p99, mx) in tracer.phase_quantiles().items():
        for quantile, value in (("p50", p50), ("p99", p99), ("max", mx)):
            builder.add(schema.TICK_PHASE_SECONDS, value,
                        (("phase", phase), ("quantile", quantile)))
    slow = tracer.slowest_tick()
    if slow is not None:
        builder.add(schema.SLOWEST_TICK_SECONDS, slow["seconds"],
                    (("phase", slow["phase"]), ("blame", slow["blame"])))
