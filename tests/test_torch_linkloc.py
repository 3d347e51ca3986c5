"""The port's interconnect graph, link baselines and link localizer
against the reference's.

- ``parse_topology``, ``link_name`` and ``InterconnectGraph`` on torus,
  ring and edgeless worker sets: nodes, links, endpoints, adjacency,
  ``describe`` and ``edge_for`` for every axis label and every
  ``nvlink<N>`` label are equal.
- ``LinkBaselineEngine`` over seeded rate streams with counter resets
  (``None``), a degradation and its recovery, the link budget and the
  stale sweep: every assessment, ``snapshot`` and ``degraded`` equal.
- ``LinkLocalizer`` on axis-labelled inputs over a ``4x1`` torus: a
  shared link (both endpoint views degrade: accused, corroborated, then
  cleared), a one-sided view (never accused) and a node fault (every
  link of one worker: no link accused) — journal events, ``suspects``,
  ``summary``, ``rows``, ``baseline_rows`` and ``explained_targets``
  equal after every refresh.
- The H100 case: the same seeded NVLink inputs (``nvlink0``..``nvlink17``
  per worker, with the same collapse on two workers) through both
  localizers give no edge, no suspect and no event, and equal
  summaries. On an H100 fleet the localizer is inert in both packages.

Exact throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from kube_gpu_stats_tpu import ici as ref_ici
from kube_gpu_stats_tpu import linkloc as ref_linkloc
from kube_gpu_stats_tpu import topology as ref_topology
from kube_gpu_stats_tpu_torch import ici, linkloc, topology

LABELS = ["x0", "x1", "y0", "y1", "z0", "z1", "x2", "X1", "w0", "x",
          ""] + [f"nvlink{n}" for n in range(18)]


@pytest.mark.parametrize("raw", ["4x4x4", "2x2", "8X8", " 2x3 ", "4", "",
                                 "v5p-128", "4x0", "ax2", "h100-8x8"])
def test_parse_topology_alike(raw):
    assert topology.parse_topology(raw) == ref_topology.parse_topology(raw)


@pytest.mark.parametrize("pair", [("1", "2"), ("2", "1"), ("10", "2"),
                                  ("b", "a"), ("3", "x")])
def test_link_name_alike(pair):
    assert topology.link_name(*pair) == ref_topology.link_name(*pair)


GRAPHS = [
    (range(8), "2x2x2"), (range(6), "2x3"), (range(12), "3x4"),
    (range(4), "4x1"), (range(64), "4x4x4"), (range(5), ""),
    (range(2), "v5p-8"), (range(7), "2x4"), (["0", "2", "3"], "1x3"),
    (["a", "b"], ""), (["01", "02"], "1x2"), (["0"], ""),
    ([], "2x2"), (["0", "1", "", "1"], ""),
]


@pytest.mark.parametrize("workers,topo", GRAPHS,
                         ids=[f"{len(list(w))}-{t or 'none'}"
                              for w, t in GRAPHS])
def test_interconnect_graph_alike(workers, topo):
    workers = [str(w) for w in workers]
    got = topology.InterconnectGraph(workers, topo)
    want = ref_topology.InterconnectGraph(workers, topo)
    assert got.describe() == want.describe()
    assert (got.kind, got.dims) == (want.kind, want.dims)
    assert got.nodes() == want.nodes()
    assert got.links() == want.links()
    for link in got.links() + ["0-99"]:
        assert got.endpoints(link) == want.endpoints(link)
    for node in got.nodes() + ["99"]:
        assert got.links_of(node) == want.links_of(node)
        assert got.neighbors(node) == want.neighbors(node)
        for label in LABELS:
            assert got.edge_for(node, label) == want.edge_for(node, label)
            if label.startswith("nvlink"):
                assert got.edge_for(node, label) is None


def test_the_graph_kinds():
    assert topology.InterconnectGraph(range(8), "2x2x2").kind == "torus"
    assert topology.InterconnectGraph(range(5), "").kind == "ring"
    assert topology.InterconnectGraph(["a", "b"], "").kind == "none"


def _assessment(a):
    return None if a is None else dataclasses.asdict(a)


@pytest.mark.parametrize("seed", range(3))
def test_link_baseline_engine_alike(seed):
    rng = np.random.default_rng(50 + seed)
    kwargs = [{}, {"warmup": 3, "window": 8, "mad_k": 3.0},
              {"alpha": 0.5, "drop_fraction": 0.1}][seed]
    got = ici.LinkBaselineEngine(**kwargs)
    want = ref_ici.LinkBaselineEngine(**kwargs)
    keys = [f"{a}-{a + 1}|{a}" for a in range(5)]
    now = 0.0
    for step in range(80):
        now += 10.0
        for i, key in enumerate(keys):
            if i == 4 and step > 40:
                continue                       # goes stale, then swept
            rate: float | None = 1e9 * (1 + i) + float(rng.normal(0, 1e7))
            if i == 1 and 20 <= step <= 30:
                rate *= 0.3                    # degrades, recovers
            if i == 2 and step % 9 == 0:
                rate = None                    # counter reset
            assert _assessment(got.observe(key, rate, now)) == \
                _assessment(want.observe(key, rate, now))
            assert got.degraded(key) == want.degraded(key)
        assert got.snapshot() == want.snapshot()
        assert got.sweep(now, 200.0) == want.sweep(now, 200.0)
    assert keys[4] not in got.snapshot()
    got.forget(keys[0])
    want.forget(keys[0])
    assert got.snapshot() == want.snapshot()


def test_link_budget_alike():
    got, want = ici.LinkBaselineEngine(), ref_ici.LinkBaselineEngine()
    got.MAX_LINKS = want.MAX_LINKS = 3
    for n in range(6):
        assert _assessment(got.observe(str(n), 1.0, 1.0)) == \
            _assessment(want.observe(str(n), 1.0, 1.0))
    assert sorted(got.snapshot()) == sorted(want.snapshot()) == \
        ["0", "1", "2"]


# -- the localizer ----------------------------------------------------------------

def _nodes(rng, r: int, sick: tuple, hot: set, anomalies: dict,
           labels=("x0", "x1"), topo: str = "4x1", workers: int = 4):
    """Worker id -> evidence for one refresh; ``sick`` (worker, label)
    views run at 10% from refresh 10 to 15."""
    nodes = {}
    for w in range(workers):
        links = {}
        for label in labels:
            rate = 3e7 + float(rng.normal(0.0, 3e5))
            if 10 <= r <= 15 and (str(w), label) in sick:
                rate *= 0.1
            links[label] = rate
        nodes[str(w)] = {"links": links, "topology": topo,
                         "anomalies": set(anomalies.get(str(w), ())),
                         "host": str(w) in hot and 11 <= r <= 14,
                         "target": f"http://w{w}/metrics"}
    return nodes


def _assert_localizers_alike(got, want):
    assert got.suspects() == want.suspects()
    assert got.summary() == want.summary()
    assert got.rows() == want.rows()
    assert got.baseline_rows() == want.baseline_rows()
    assert got.explained_targets() == want.explained_targets()
    assert got.link_count() == want.link_count()


CASES = {
    # Link 1-2: worker 1 sees it as x1, worker 2 as x0.
    "shared-link": ((("1", "x1"), ("2", "x0")), {"1"}, {"2": {"steps"}}),
    "one-sided": ((("1", "x1"),), set(), {}),
    # Every link of worker 1, from both ends.
    "node-fault": ((("1", "x0"), ("1", "x1"), ("0", "x1"), ("2", "x0")),
                   set(), {"1": {"fetch"}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", range(2))
def test_link_localizer_alike(case, seed):
    sick, hot, anomalies = CASES[case]
    rng = np.random.default_rng(60 + seed)
    got, want = linkloc.LinkLocalizer(), ref_linkloc.LinkLocalizer()
    events = []
    for r in range(1, 24):
        nodes = _nodes(rng, r, sick, hot, anomalies)
        step = got.observe(r * 10.0, nodes)
        assert step == want.observe(r * 10.0, nodes)
        events += step
        _assert_localizers_alike(got, want)
    kinds = [kind for kind, _d, _a in events]
    assert got.summary()["graph"] == {"kind": "torus", "topology": "4x1",
                                      "nodes": 4, "links": 4}
    if case == "shared-link":
        assert kinds == ["fleet_link_suspect", "fleet_link_cleared"]
        assert events[0][2]["link"] == "1-2"
        assert ("1-2", "ici-rate+anomaly-correlated+host-counter-confirmed",
                0.0) in got.rows()
    else:
        assert kinds == []
        assert got.rows() == []


def test_a_reshaped_graph_drops_its_suspects_alike():
    rng = np.random.default_rng(70)
    got, want = linkloc.LinkLocalizer(), ref_linkloc.LinkLocalizer()
    sick = (("1", "x1"), ("2", "x0"))
    for r in range(1, 14):
        nodes = _nodes(rng, r, sick, set(), {})
        assert got.observe(r * 10.0, nodes) == want.observe(r * 10.0, nodes)
    assert got.suspects()
    # Worker 2 leaves: workers 0, 1, 3 are not contiguous, the graph
    # goes edgeless, and the verdict on 1-2 clears with it.
    nodes = _nodes(rng, 14, sick, set(), {})
    del nodes["2"]
    step = got.observe(140.0, nodes)
    assert step == want.observe(140.0, nodes)
    assert step == [("fleet_link_cleared",
                     "ICI link 1-2 cleared: graph changed",
                     {"link": "1-2", "reason": "ici-rate"})]
    assert got.summary()["graph"]["kind"] == "none"
    _assert_localizers_alike(got, want)


@pytest.mark.parametrize("seed", range(2))
def test_nvlink_inputs_give_no_edge_no_suspect_no_event(seed):
    """An H100 node's links are nvlink0..nvlink17, its links to the
    node's NVSwitches: on a 2x4 torus of eight workers (and on a ring
    of them) the same collapse that accuses an axis-labelled link maps
    onto no edge in either package."""
    rng = np.random.default_rng(80 + seed)
    labels = tuple(f"nvlink{n}" for n in range(18))
    sick = tuple((w, label) for w in ("1", "2") for label in labels)
    for topo in ("2x4", ""):
        got, want = linkloc.LinkLocalizer(), ref_linkloc.LinkLocalizer()
        for r in range(1, 20):
            nodes = _nodes(rng, r, sick, {"1", "2"}, {"1": {"ici"}},
                           labels=labels, topo=topo, workers=8)
            step = got.observe(r * 10.0, nodes)
            assert step == want.observe(r * 10.0, nodes) == []
            _assert_localizers_alike(got, want)
        summary = got.summary()
        assert summary["suspects"] == {} and summary["baselines"] == {}
        assert summary["graph"]["links"] > 0          # a graph, no views
        assert got.rows() == [] and got.baseline_rows() == []
        assert got.engine.snapshot() == {}
