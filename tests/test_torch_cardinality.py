"""The port's series accountant against the reference's.

Seeded sequences of admit, install, touch, forget, tick, evict and
runtime knob writes drive the port's ``SeriesAccountant`` and the
reference's side by side: every admitted count, every
``CardinalityShed`` (its reason and Retry-After), every eviction list,
``debug_payload`` and the journal events equal after each operation.
``clamp_series`` clamps the same prefix, and ``contribute_cardinality``
renders the same exposition text from both ledgers.

Exact throughout: the accountant counts integers.
"""

from __future__ import annotations

import numpy as np
import pytest

from kube_gpu_stats_tpu import cardinality as ref_cardinality
from kube_gpu_stats_tpu import registry as ref_registry
from kube_gpu_stats_tpu.tracing import Tracer as RefTracer
from kube_gpu_stats_tpu_torch import cardinality, registry
from kube_gpu_stats_tpu_torch.tracing import Tracer


def _events(tracer) -> list[tuple]:
    return [(e["kind"], e["detail"]) for e in tracer.events()["events"]]


def _call(acct, op: str, *args):
    try:
        return "ok", getattr(acct, op)(*args)
    except cardinality.CardinalityShed as exc:
        return "shed", exc.reason, exc.retry_after
    except ref_cardinality.CardinalityShed as exc:
        return "shed", exc.reason, exc.retry_after


KNOBS = [dict(),
         dict(budget_per_source=6),
         dict(hard_cap=40),
         dict(budget_per_source=8, hard_cap=50, high_watermark=40,
              idle_refreshes=2),
         dict(high_watermark=30, low_watermark=20, idle_refreshes=1)]


@pytest.mark.parametrize("knobs", KNOBS, ids=[
    "off", "budget", "hard-cap", "all", "watermarks"])
@pytest.mark.parametrize("seed", range(3))
def test_seeded_ledger_sequences_equal_the_reference(seed, knobs):
    rng = np.random.default_rng(seed)
    port_tracer, ref_tracer = Tracer(), RefTracer()
    port = cardinality.SeriesAccountant(tracer=port_tracer, **knobs)
    ref = ref_cardinality.SeriesAccountant(tracer=ref_tracer, **knobs)
    sources = [f"src-{i}" for i in range(12)]
    for step in range(300):
        source = sources[int(rng.integers(0, len(sources)))]
        roll = rng.random()
        if roll < 0.45:
            n = int(rng.integers(0, 14))
            got, want = _call(port, "admit", source, n), \
                _call(ref, "admit", source, n)
            assert got == want, step
            if got[0] == "ok":
                kind = "push" if rng.random() < 0.6 else "pull"
                nbytes = int(rng.integers(10, 5000))
                for acct in (port, ref):
                    acct.install(source, got[1], nbytes, kind=kind,
                                 clamped=got[1] < n)
        elif roll < 0.65:
            port.touch(source)
            ref.touch(source)
        elif roll < 0.72:
            port.forget(source)
            ref.forget(source)
        elif roll < 0.9:
            assert port.tick() == ref.tick()
            assert port.evict_idle() == ref.evict_idle()
        elif roll < 0.93:
            port.count_shed(source, "source_budget", 2)
            ref.count_shed(source, "source_budget", 2)
        elif roll < 0.95:
            value = int(rng.integers(0, 60))
            port.hard_cap = value
            ref.hard_cap = value
        assert port.debug_payload() == ref.debug_payload(), step
        assert (port.enabled, port.config_gen, port.at_hard_cap(),
                port.is_clamped(source)) == (
            ref.enabled, ref.config_gen, ref.at_hard_cap(),
            ref.is_clamped(source))
        assert port.ledger_sources() == ref.ledger_sources()
        assert port.top_sources(5) == ref.top_sources(5)
    assert _events(port_tracer) == _events(ref_tracer)


def test_shed_sources_past_the_bound_aggregate_as_the_reference():
    port = cardinality.SeriesAccountant(budget_per_source=1)
    ref = ref_cardinality.SeriesAccountant(budget_per_source=1)
    for i in range(100):
        assert port.admit(f"bomb-{i}", 3) == ref.admit(f"bomb-{i}", 3) == 1
    assert port.shed_totals() == ref.shed_totals()
    assert ("other", "source_budget") in port.shed_totals()
    assert port.shed_series_total() == ref.shed_series_total() == 200


@pytest.mark.parametrize("n,admitted", [(0, 0), (5, 3), (5, 5), (5, 9),
                                        (3, 0)])
def test_clamp_series_keeps_the_same_prefix(n, admitted):
    series = [(f"s{i}", (("k", str(i)),), float(i)) for i in range(n)]
    got = cardinality.clamp_series(series, admitted)
    assert got == ref_cardinality.clamp_series(series, admitted)
    assert (got is series) == (admitted >= n)


@pytest.mark.parametrize("with_exposition", [False, True])
def test_contribute_cardinality_renders_the_same_text(with_exposition):
    port = cardinality.SeriesAccountant(budget_per_source=4)
    ref = ref_cardinality.SeriesAccountant(budget_per_source=4)
    for i, n in enumerate([2, 9, 4, 7, 1, 12]):
        for acct in (port, ref):
            admitted = acct.admit(f"node-{i}", n)
            acct.install(f"node-{i}", admitted, n * 100,
                         clamped=admitted < n)
    for acct in (port, ref):
        acct.forget("node-4")
    exposition = 1234 if with_exposition else None
    port_builder = registry.SnapshotBuilder()
    ref_builder = ref_registry.SnapshotBuilder()
    registry.contribute_cardinality(port_builder, port, exposition, top_k=3)
    ref_registry.contribute_cardinality(ref_builder, ref, exposition,
                                        top_k=3)
    text = port_builder.build().render()
    assert text == ref_builder.build().render()
    assert 'kts_source_series{source="node-1"} 4' in text


def test_label_fence_still_matches_the_reference():
    port = cardinality.LabelFence(value_cap=2)
    ref = ref_cardinality.LabelFence(value_cap=2)
    for pod in ["a", "b", "c", "a", "d", "overflow", ""]:
        labels = {"pod": pod, "namespace": "ns"}
        assert port.fence(labels) == ref.fence(labels)
    assert port.fenced_totals() == ref.fenced_totals()
