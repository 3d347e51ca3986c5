"""The port's registry against the JAX package's pure-Python render path
(``Registry(native=False)``): the same series and histograms, made from a
seeded numpy generator, render to byte-identical Prometheus text and
OpenMetrics text. Gzip bodies are compared after decompressing them (the
reference's native gzip header differs from Python's at byte 9)."""

import gzip

import numpy as np
import pytest

from kube_gpu_stats_tpu import registry as ref_registry
from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu_torch import registry as port_registry
from kube_gpu_stats_tpu_torch import schema as port_schema

SEEDS = range(6)
LABEL_VALUES = ("", "0", "7", "pod-a", 'quo"te', "back\\slash", "new\nline",
                "ünïcode", "/dev/nvidia3", "gpu-h100")
HISTOGRAMS = (
    ("accelerator_workload_step_duration_seconds", "STEP_DURATION_BUCKETS",
     ()),
    ("collector_poll_duration_seconds", "POLL_DURATION_BUCKETS", ()),
    ("collector_scrape_duration_seconds", "SCRAPE_DURATION_BUCKETS",
     (("output", "http"),)),
    ("collector_scrape_duration_seconds", "SCRAPE_DURATION_BUCKETS",
     (("output", "textfile"),)),
)


def _value(rng) -> float:
    kind = rng.integers(6)
    if kind == 0:
        return float(rng.integers(0, 10**6))
    if kind == 1:
        return float(rng.normal() * 10.0 ** rng.integers(-6, 13))
    if kind == 2:
        return float(rng.choice([np.nan, np.inf, -np.inf]))
    if kind == 3:
        return float(rng.integers(1, 10**4)) * 1e15  # past the int form
    if kind == 4:
        return float(rng.random())
    return -0.0


def _draw(seed: int):
    """Plain rows: [(family, labels, value)], [(family, bucket table,
    labels, observations)] — no spec objects, so each side builds its own."""
    rng = np.random.default_rng(seed)
    plain = [s for s in ref_schema.ALL_METRICS
             if s.type is not ref_schema.MetricType.HISTOGRAM]
    rows = []
    for _ in range(80):
        spec = plain[rng.integers(len(plain))]
        keys = list(ref_schema.ALL_BASE_LABELS) + list(spec.extra_labels)
        keep = [k for k in keys if rng.random() < 0.7]
        labels = tuple((k, LABEL_VALUES[rng.integers(len(LABEL_VALUES))])
                       for k in keep)
        rows.append((spec.name, labels, _value(rng)))
    hists = []
    for name, buckets, labels in HISTOGRAMS:
        count = int(rng.integers(0, 40))
        obs = [(float(rng.lognormal(-5, 3)), int(rng.integers(1, 5)))
               for _ in range(count)]
        hists.append((name, buckets, labels, obs))
    return rows, hists


def _snapshot(module, schema, rows, hists):
    by_name = {s.name: s for s in schema.ALL_METRICS}
    series = tuple(module.Series(by_name[name], labels, value)
                   for name, labels, value in rows)
    states = []
    for name, buckets, labels, obs in hists:
        state = module.HistogramState.empty(
            by_name[name], getattr(schema, buckets), labels)
        for value, count in obs:
            state = state.observe(value, count=count)
        states.append(state)
    return module.Snapshot(series=series, histograms=tuple(states),
                           timestamp=1234.5)


def _registries(seed):
    rows, hists = _draw(seed)
    ref = ref_registry.Registry(native=False)
    port = port_registry.Registry()
    ref.publish(_snapshot(ref_registry, ref_schema, rows, hists))
    port.publish(_snapshot(port_registry, port_schema, rows, hists))
    return ref, port


@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["prometheus", "openmetrics"])
@pytest.mark.parametrize("seed", SEEDS)
def test_rendered_text_is_byte_identical(seed, openmetrics):
    ref, port = _registries(seed)
    want, _ = ref.rendered(openmetrics=openmetrics)
    got, _ = port.rendered(openmetrics=openmetrics)
    assert got == want
    assert len(want) > 1000  # a real exposition, not two empty strings


@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["prometheus", "openmetrics"])
@pytest.mark.parametrize("seed", SEEDS)
def test_gzip_bodies_decompress_to_the_same_text(seed, openmetrics):
    ref, port = _registries(seed)
    want, _ = ref.rendered(openmetrics=openmetrics, gzip_level=3)
    got, _ = port.rendered(openmetrics=openmetrics, gzip_level=3)
    assert gzip.decompress(got) == gzip.decompress(want)
    # The cache serves the same bytes again, and the text shape it filled
    # on the way is the uncompressed body.
    again, hit = port.rendered(openmetrics=openmetrics, gzip_level=3)
    assert hit and again == got
    assert port.rendered(openmetrics=openmetrics)[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_snapshot_render_matches_reference(seed):
    rows, hists = _draw(seed)
    assert (_snapshot(port_registry, port_schema, rows, hists).render()
            == _snapshot(ref_registry, ref_schema, rows, hists).render())


@pytest.mark.parametrize("value", [0.0, -0.0, 1.0, 2.5, 1e15, 1e15 - 1,
                                   -3e20, 1e-9, float("nan"), float("inf"),
                                   float("-inf"), 123456789.0])
def test_format_value_matches(value):
    assert (port_registry.format_value(value)
            == ref_registry.format_value(value))


def test_filtered_builder_drops_like_the_reference():
    disabled = frozenset({"accelerator_duty_cycle",
                          "accelerator_workload_step_duration_seconds"})
    out = []
    for module, schema in ((ref_registry, ref_schema),
                           (port_registry, port_schema)):
        builder = module.FilteredSnapshotBuilder(disabled)
        builder.add(schema.DUTY_CYCLE, 50.0, (("chip", "0"),))
        builder.add(schema.POWER, 300.0, {"chip": "0"})
        builder.add_histogram(module.HistogramState.empty(
            schema.WORKLOAD_STEP_DURATION, schema.STEP_DURATION_BUCKETS))
        builder.add_histogram(module.HistogramState.empty(
            schema.SELF_POLL_DURATION, schema.POLL_DURATION_BUCKETS))
        out.append(builder.build().render())
    assert out[0] == out[1]
    assert "accelerator_duty_cycle" not in out[1]
    assert "accelerator_power_watts" in out[1]


def test_registry_generation_and_wait():
    port = port_registry.Registry()
    assert port.generation == 0
    assert not port.wait_for_publish(0, timeout=0.01)
    port.publish(port_registry.EMPTY_SNAPSHOT)
    assert port.generation == 1 and port.wait_for_publish(0, timeout=0.01)
    assert port.rendered() == (b"", False)


@pytest.mark.parametrize("faults", [(), ("EMFILE",), ("EMFILE", "ENOSPC"),
                                    ("EIO", "EIO", "ok")])
def test_store_metrics_render_like_the_reference(faults):
    import errno

    from kube_gpu_stats_tpu import wal as ref_wal
    from kube_gpu_stats_tpu_torch import wal as port_wal

    port_wal.reset_store_stats()
    ref_wal.reset_store_stats()
    try:
        texts = []
        for wal, module in ((ref_wal, ref_registry),
                            (port_wal, port_registry)):
            health = wal.store_health("http-accept")
            for fault in faults:
                if fault == "ok":
                    health.ok()
                else:
                    health.record_fault(
                        OSError(getattr(errno, fault), fault))
            builder = module.SnapshotBuilder()
            module.contribute_store_metrics(builder)
            texts.append(builder.build().render())
        assert texts[1] == texts[0]
        assert 'kts_store_state{store="http-accept"}' in texts[1]
    finally:
        port_wal.reset_store_stats()
        ref_wal.reset_store_stats()
