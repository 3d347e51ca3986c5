"""Flight-recorder digest on every snapshot, and per-worker step rates.

The port keeps only two parts of the reference's fleet lens:
``contribute_trace_digest`` (the daemon-side half of slow-node
attribution) and ``worker_step_rates`` (the hub's per-worker rollup
calls it with the lens off). The lens itself comes with the fleet-lens
slice.
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


def worker_step_rates(rows) -> dict[str, float]:
    """Mean step rate per worker over ONE slice's frame rows (SPMD:
    every card of a worker reports the same counter, so mean, not sum;
    workers with no label count individually by target — row.key leads
    with the target). The hub's slice_worker_steps_per_second rollup
    calls this."""
    per_worker: dict[str, list[float]] = {}
    for row in rows:
        if row.steps_per_s is None:
            continue
        worker = row.key[2] or str(row.key[0])
        per_worker.setdefault(worker, []).append(row.steps_per_s)
    return {worker: sum(values) / len(values)
            for worker, values in per_worker.items()}
