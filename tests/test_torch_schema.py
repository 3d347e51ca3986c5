"""The port's metric schema against the JAX package's: every family with
the same name, type, HELP and labels, in the same render order, and the
same label contract, buckets, family filter and label rendering — so
Prometheus cannot tell an H100 node's exposition from a TPU node's."""

import pytest

from kube_gpu_stats_tpu import schema as ref
from kube_gpu_stats_tpu_torch import schema as port


def _spec_row(spec):
    return (spec.name, spec.type.value, spec.help, spec.extra_labels)


def test_every_reference_spec_has_an_identical_port_spec():
    port_by_name = {spec.name: spec for spec in port.ALL_METRICS}
    for spec in ref.ALL_METRICS:
        assert spec.name in port_by_name, spec.name
        assert _spec_row(port_by_name[spec.name]) == _spec_row(spec)


def test_port_has_no_spec_the_reference_lacks():
    ref_names = {spec.name for spec in ref.ALL_METRICS}
    assert [s.name for s in port.ALL_METRICS if s.name not in ref_names] == []


@pytest.mark.parametrize("table", [
    "ALL_METRICS", "PER_DEVICE_METRICS", "WORKLOAD_HISTOGRAMS",
    "HUB_METRICS", "HOST_METRICS", "SELF_METRICS",
])
def test_family_tables_keep_the_reference_order(table):
    # Snapshot.render walks ALL_METRICS: the order is the byte order.
    assert ([_spec_row(s) for s in getattr(port, table)]
            == [_spec_row(s) for s in getattr(ref, table)])


@pytest.mark.parametrize("name", [
    "DEVICE_LABELS", "ATTRIBUTION_LABELS", "TOPOLOGY_LABELS",
    "ALL_BASE_LABELS", "POLL_DURATION_BUCKETS", "SCRAPE_DURATION_BUCKETS",
    "STEP_DURATION_BUCKETS", "BURST_WATTS_BUCKETS", "FILTERABLE_METRICS",
])
def test_label_contract_and_buckets_match(name):
    assert getattr(port, name) == getattr(ref, name)


def test_percentile_value_keys_match():
    assert ({k: (spec.name, pct)
             for k, (spec, pct) in port.PERCENTILE_VALUE_KEYS.items()}
            == {k: (spec.name, pct)
                for k, (spec, pct) in ref.PERCENTILE_VALUE_KEYS.items()})


@pytest.mark.parametrize("include,exclude", [
    ((), ()),
    (("accelerator_memory_*",), ()),
    ((), ("accelerator_uptime_seconds", "accelerator_workload_*")),
    (("accelerator_duty_cycle", "accelerator_power_watts"),
     ("accelerator_power_watts",)),
])
def test_metric_filter_resolves_alike(include, exclude):
    assert (port.resolve_metric_filter(include, exclude)
            == ref.resolve_metric_filter(include, exclude))


@pytest.mark.parametrize("bad", [
    ("accelerator_up",), ("not_a_family",), ("nomatch_*",),
])
def test_metric_filter_rejects_alike(bad):
    with pytest.raises(ValueError) as want:
        ref.resolve_metric_filter(bad, ())
    with pytest.raises(ValueError) as got:
        port.resolve_metric_filter(bad, ())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("labels", [
    (), (("chip", "0"),),
    (("pod", 'a"b'), ("path", "c\\d"), ("note", "e\nf")),
])
def test_label_rendering_matches(labels):
    assert port.render_labels(labels) == ref.render_labels(labels)


def test_port_schema_validates():
    port.validate()
