"""The port's history ring and ``/query`` against the reference's.

Both packages' ``HistoryStore`` get the same seeded sample streams at
the same injected wall times; each ring's ``samples`` and ``at`` for
every tier, ``handle_query``'s status, body and headers (ETags with the
per-boot nonce masked), ``bytes`` and the shed and evicted counts under
identity churn, ``QueryGate``'s verdicts on an injected clock, and the
``contribute`` text each package's ``SnapshotBuilder`` renders, are
equal. The reference's own cases (``tests/test_history.py``: the bucket
mean against a brute-force oracle, the fixed memory bound, the ring
that a restart does not keep and the ETags that keep restarts apart,
the 304, gzip, validation, the gate) run on the port the same way, and
so does ``TestDoctorAt``: the doctor's ``--fleet --at`` and
``--efficiency --at`` verdicts replayed from both packages' rings
through a straggler and waste episode and its recovery, each package's
verdict on its own ring equal to the other's.

Exact throughout: the same float operations in the same order.
"""

from __future__ import annotations

import gzip
import json
import math
import re

import numpy as np
import pytest

from kube_gpu_stats_tpu import history as ref_history
from kube_gpu_stats_tpu.exposition import _metrics_etag as ref_metrics_etag
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
from kube_gpu_stats_tpu_torch import history
from kube_gpu_stats_tpu_torch.exposition import _metrics_etag
from kube_gpu_stats_tpu_torch.registry import Registry, SnapshotBuilder

BASE = 1_700_000_000.0
FAMILY = "slice_duty_cycle_mean"
LABELS = (("slice", "s0"),)
NONCE = re.compile(r'"h[0-9a-f]{8}-')


def _masked(headers: dict) -> dict:
    return {k: NONCE.sub('"h<boot>-', v) for k, v in headers.items()}


class Pair:
    """One store of each package, fed and read alike; every read holds
    the two answers equal and returns the port's."""

    def __init__(self, **kwargs) -> None:
        self.port = history.HistoryStore(**kwargs)
        self.ref = ref_history.HistoryStore(**kwargs)

    def record(self, family: str, labels: tuple, value: float) -> None:
        self.port.record(family, labels, value)
        self.ref.record(family, labels, value)

    def commit(self, now: float, generation: int) -> None:
        self.port.commit(now, generation)
        self.ref.commit(now, generation)

    def feed(self, samples, family=FAMILY, labels=LABELS) -> None:
        """One commit per (ts, value), the hub's cadence."""
        for generation, (ts, value) in enumerate(samples, start=1):
            self.record(family, labels, value)
            self.commit(ts, generation)

    def query(self, client="10.0.0.1", gzip_ok=False, if_none_match="",
              **params):
        got = self.port.handle_query(params, client, gzip_ok,
                                     if_none_match)
        want = self.ref.handle_query(params, client, gzip_ok,
                                     if_none_match)
        assert (got[0], got[1], _masked(got[2])) == \
            (want[0], want[1], _masked(want[2]))
        return got

    def counters(self) -> None:
        for name in ("samples_total", "series_shed_total",
                     "series_evicted_total", "requests_total",
                     "cache_hits_total", "cache_misses_total",
                     "commits_total", "generation", "series_bytes"):
            assert getattr(self.port, name) == getattr(self.ref, name), name
        assert self.port.bytes() == self.ref.bytes()
        assert self.port.gate.shed_total == self.ref.gate.shed_total
        assert self.port.gate.admitted_total == self.ref.gate.admitted_total


def _stream(seed: int, n: int, jitter: bool = True):
    """n samples near the 10 s cadence: seeded values, seeded jitter."""
    rng = np.random.default_rng(seed)
    times = BASE + 10.0 * np.arange(n)
    if jitter:
        times = times + rng.uniform(0.0, 9.0, n)
    values = rng.uniform(0.0, 100.0, n)
    return [(float(t), float(v)) for t, v in zip(times, values)]


# -- the tiers, against each other and the oracle -----------------------------

@pytest.mark.parametrize("seed", range(3))
def test_every_tier_samples_and_at_equal_the_reference(seed):
    pair = Pair()
    samples = _stream(seed, 400)
    pair.feed(samples)
    now = samples[-1][0]
    port_rings = pair.port._data[FAMILY][LABELS].tiers
    ref_rings = pair.ref._data[FAMILY][LABELS].tiers
    rng = np.random.default_rng(100 + seed)
    for name, _step, _slots in history.DEFAULT_TIERS:
        assert port_rings[name].samples(now) == ref_rings[name].samples(now)
        for ts in rng.uniform(BASE - 3600.0, now + 600.0, 40):
            assert port_rings[name].at(float(ts)) == \
                ref_rings[name].at(float(ts))
        for ts in (BASE, now, now - 3600.0, now + 86400.0):
            assert pair.port.at_payload(FAMILY, ts) == \
                pair.ref.at_payload(FAMILY, ts)
    assert history.DEFAULT_TIERS == ref_history.DEFAULT_TIERS
    assert history.GZIP_MIN_BYTES == ref_history.GZIP_MIN_BYTES
    pair.counters()


@pytest.mark.parametrize("seed", range(3))
def test_every_tier_matches_the_bucket_mean_oracle(seed):
    # Seeded values at the 10 s cadence: one per finest bucket, three
    # per 5-minute bucket, as in the reference's case.
    pair = Pair()
    rng = np.random.default_rng(seed)
    samples = [(BASE + 10.0 * i, float(rng.integers(0, 97)))
               for i in range(90)]
    pair.feed(samples)
    for window, step, _slots in history.DEFAULT_TIERS:
        oracle: dict[int, list[float]] = {}
        for ts, value in samples:
            oracle.setdefault(math.floor(ts / step), []).append(value)
        want = [[bucket * step, sum(vs) / len(vs)]
                for bucket, vs in sorted(oracle.items())]
        status, body, _headers = pair.query(family=FAMILY, window=window)
        assert status == 200
        payload = json.loads(body)
        assert payload["step_s"] == step
        (series,) = payload["series"]
        got = series["samples"]
        assert len(got) == len(want)
        for (got_ts, got_v), (want_ts, want_v) in zip(got, want):
            assert got_ts == want_ts
            assert math.isfinite(got_v)
            assert abs(got_v - want_v) < 1e-9, (window, got_ts)


def test_boundary_sample_opens_the_next_bucket():
    pair = Pair()
    edge = (math.floor(BASE / 300.0) + 1) * 300.0
    pair.feed([(edge - 10.0, 1.0), (edge, 5.0), (edge + 10.0, 7.0)])
    status, body, _ = pair.query(family=FAMILY, window="24h")
    assert status == 200
    (series,) = json.loads(body)["series"]
    assert series["samples"] == [[edge - 300.0, 1.0], [edge, 6.0]]


def test_ring_wrap_drops_only_aged_out_buckets():
    pair = Pair()
    pair.feed([(BASE + 10.0 * i, float(i)) for i in range(720)])
    status, body, _ = pair.query(family=FAMILY, window="1h")
    (series,) = json.loads(body)["series"]
    assert len(series["samples"]) == 360
    assert series["samples"][0][0] == BASE + 10.0 * 360
    assert series["samples"][-1][1] == 719.0


# -- fixed memory --------------------------------------------------------------

@pytest.mark.parametrize("reclaim_age", [7200.0, 0.0, 25.0])
def test_bytes_shed_and_evictions_under_churn(reclaim_age):
    """Seeded identity churn past max_series: each package sheds or
    reclaims the same identities, and offered = admitted + shed."""
    rng = np.random.default_rng(int(reclaim_age))
    pair = Pair(max_series=8, reclaim_age=reclaim_age)
    bound = 8 * pair.port.series_bytes
    offered = 0
    for cycle in range(40):
        for _ in range(int(rng.integers(1, 6))):
            name = f"c{int(rng.integers(0, 20))}"
            pair.record("slice_power_watts", (("slice", name),),
                        float(rng.uniform(0, 700)))
            offered += 1
        pair.commit(BASE + 10.0 * cycle, cycle + 1)
        assert pair.port.bytes() <= bound
        pair.counters()
    assert pair.port.samples_total + pair.port.series_shed_total == offered
    assert sorted(pair.port._data["slice_power_watts"]) == \
        sorted(pair.ref._data["slice_power_watts"])
    pair.query(family="slice_power_watts", window="1h")


def test_bytes_capped_and_shed_accounted_under_churn():
    pair = Pair(max_series=8)
    bound = 8 * pair.port.series_bytes
    offered = 0
    for cycle in range(30):
        for i in range(4):
            pair.record("slice_power_watts", (("slice", f"c{cycle}-{i}"),),
                        1.0)
            offered += 1
        pair.commit(BASE + 10.0 * cycle, cycle + 1)
        assert pair.port.bytes() <= bound
    assert pair.port.bytes() == bound
    assert pair.port.samples_total == 8
    assert pair.port.series_shed_total == offered - 8
    assert pair.port.series_evicted_total == 0
    pair.counters()


def test_reclaim_reuses_slabs_in_place():
    pair = Pair(max_series=8, reclaim_age=0.0)
    bound = 8 * pair.port.series_bytes
    for cycle in range(30):
        for i in range(4):
            pair.record("slice_power_watts", (("slice", f"c{cycle}-{i}"),),
                        1.0)
        pair.commit(BASE + 10.0 * cycle, cycle + 1)
        assert pair.port.bytes() <= bound
    assert pair.port.bytes() == bound
    assert pair.port.series_shed_total == 0
    assert pair.port.series_evicted_total == 30 * 4 - 8
    pair.counters()


def test_series_bytes_of_the_default_tiers():
    # (360 + 288 + 168) slots, each an f64 mean, a u32 count and an i64
    # bucket id.
    assert history.HistoryStore().series_bytes == \
        ref_history.HistoryStore().series_bytes == 816 * 20 == 16320


# -- the warm restart ------------------------------------------------------------

def test_ring_does_not_survive_a_restart_by_design():
    old = Pair()
    old.feed([(BASE, 1.0), (BASE + 10.0, 2.0)])
    assert old.query(family=FAMILY, window="1h")[0] == 200
    reborn = Pair()
    status, body, _ = reborn.query(family=FAMILY, window="1h")
    assert status == 404
    assert b"unknown family" in body


def test_boot_nonce_splits_the_etag_spaces():
    first, second = Pair(), Pair()
    first.feed([(BASE, 1.0)])
    second.feed([(BASE, 1.0)])
    etags = [pair.query(family=FAMILY, window="1h")[2]["ETag"]
             for pair in (first, second)]
    assert etags[0] != etags[1]
    # Same document, same generation: only the nonce differs.
    assert NONCE.sub("", etags[0]) == NONCE.sub("", etags[1])
    assert first.port._boot != second.port._boot
    for store in (second.port, second.ref):
        status, _body, _headers = store.handle_query(
            {"family": FAMILY, "window": "1h"}, "10.0.0.1",
            gzip_ok=False, if_none_match=etags[0])
        assert status == 200


def test_registry_metrics_etags_differ_across_boots():
    a, b = Registry(), Registry()
    assert a.boot_id != b.boot_id
    assert (_metrics_etag(a.boot_id, 1, False, False)
            != _metrics_etag(b.boot_id, 1, False, False))
    ref = RefRegistry()
    assert _metrics_etag(ref.boot_id, 7, True, True) == \
        ref_metrics_etag(ref.boot_id, 7, True, True)


# -- serving -----------------------------------------------------------------------

def test_etag_roundtrip_and_invalidation():
    pair = Pair()
    pair.feed([(BASE, 1.0)])
    status, _body, headers = pair.query(family=FAMILY, window="1h")
    assert status == 200
    port_etag = headers["ETag"]
    ref_etag = pair.ref.handle_query({"family": FAMILY, "window": "1h"},
                                     "10.0.0.1", False, "")[2]["ETag"]
    for store, etag in ((pair.port, port_etag), (pair.ref, ref_etag)):
        status, body, got = store.handle_query(
            {"family": FAMILY, "window": "1h"}, "10.0.0.1", False, etag)
        assert (status, body) == (304, b"")
        assert got["ETag"] == etag
    pair.record(FAMILY, LABELS, 9.0)
    pair.commit(BASE + 10.0, 2)
    for store, etag in ((pair.port, port_etag), (pair.ref, ref_etag)):
        status, _body, got = store.handle_query(
            {"family": FAMILY, "window": "1h"}, "10.0.0.1", False, etag)
        assert status == 200
        assert got["ETag"] != etag


@pytest.mark.parametrize("n", [1, 60, 360])
def test_gzip_body_is_the_same_document(n):
    pair = Pair()
    pair.feed([(BASE + 10.0 * i, float(i)) for i in range(n)])
    _s, plain, _h = pair.query(family=FAMILY, window="1h")
    status, gz, headers = pair.query(family=FAMILY, window="1h",
                                     gzip_ok=True)
    assert status == 200
    if len(plain) >= history.GZIP_MIN_BYTES:
        assert headers["Content-Encoding"] == "gzip"
        assert gzip.decompress(gz) == plain
    else:
        assert "Content-Encoding" not in headers and gz == plain
    pair.counters()


def test_parameter_validation():
    pair = Pair()
    pair.feed([(BASE, 1.0)])
    assert pair.query()[0] == 400
    status, body, _ = pair.query(family=FAMILY, window="3h")
    assert status == 400
    assert b"1h,24h,7d" in body
    assert pair.query(family=FAMILY, window="1h", step="300")[0] == 400
    assert pair.query(family=FAMILY, window="1h", step="10s")[0] == 200
    assert pair.query(family=FAMILY, window="1h", step="x")[0] == 400
    assert pair.query(family=FAMILY, at="soon")[0] == 400
    assert pair.query(family=FAMILY, at=str(BASE + 3.0))[0] == 200
    status, body, _ = pair.query(family="nope", window="1h")
    assert status == 404
    assert FAMILY.encode() in body
    pair.counters()


def test_disabled_store_answers_enabled_false():
    pair = Pair(enabled=False)
    pair.record("slice_chips", (), 1.0)
    pair.commit(BASE, 1)
    assert pair.port.samples_total == 0
    assert pair.port.bytes() == 0
    status, body, _ = pair.query(family="slice_chips")
    assert status == 200
    payload = json.loads(body)
    assert payload["enabled"] is False
    assert "--no-history" in payload["hint"]
    pair.counters()


def test_at_nearest_bucket_in_the_finest_covering_tier():
    pair = Pair()
    pair.feed([(BASE + 10.0 * i, float(i)) for i in range(0, 400, 3)])
    now = BASE + 10.0 * 399
    for ts in (now - 5.0, now - 25.0, now - 3000.0, now - 4000.0,
               now - 90000.0):
        status, body, _ = pair.query(family=FAMILY, at=repr(ts))
        assert status == 200
        (series,) = json.loads(body)["series"] or [None]
        assert series is not None
        expect_window = ("1h" if now - ts <= 3600.0 else
                         "24h" if now - ts <= 86400.0 else "7d")
        assert series["window"] == expect_window, ts


# -- the gate ------------------------------------------------------------------------

def test_exact_shed_accounting():
    gates = [history.QueryGate(rate=1.0, burst=2.0),
             ref_history.QueryGate(rate=1.0, burst=2.0)]
    verdicts = [[g.admit("1.2.3.4", now=100.0) for _ in range(20)]
                for g in gates]
    assert verdicts[0] == verdicts[1]
    admitted = [v for v in verdicts[0] if v[0]]
    shed = [v for v in verdicts[0] if not v[0]]
    assert len(admitted) == 2 and len(shed) == 18
    assert all(retry >= 1 for _ok, retry in shed)
    assert [g.admit("1.2.3.4", now=101.5) for g in gates] == [(True, 0)] * 2
    assert [(g.admitted_total, g.shed_total) for g in gates] == [(3, 18)] * 2


@pytest.mark.parametrize("seed", range(3))
def test_gate_verdicts_on_a_seeded_clock(seed):
    rng = np.random.default_rng(seed)
    rate, burst = float(rng.uniform(0.5, 5)), float(rng.uniform(1, 10))
    gates = [history.QueryGate(rate, burst),
             ref_history.QueryGate(rate, burst)]
    now = 1000.0
    for _ in range(600):
        now += float(rng.exponential(0.005))
        client = f"10.0.0.{int(rng.integers(0, 5))}"
        got = [g.admit(client, now=now) for g in gates]
        assert got[0] == got[1]
    assert (gates[0].admitted_total, gates[0].shed_total) == \
        (gates[1].admitted_total, gates[1].shed_total)
    assert gates[0].shed_total > 0


def test_clients_are_isolated():
    for gate in (history.QueryGate(rate=1.0, burst=1.0),
                 ref_history.QueryGate(rate=1.0, burst=1.0)):
        assert gate.admit("1.2.3.4", now=100.0)[0]
        assert not gate.admit("1.2.3.4", now=100.0)[0]
        assert gate.admit("5.6.7.8", now=100.0)[0]


def test_the_client_map_stays_bounded():
    gates = [history.QueryGate(rate=1.0, burst=1.0),
             ref_history.QueryGate(rate=1.0, burst=1.0)]
    for gate in gates:
        gate.MAX_CLIENTS = 16
        for i in range(40):
            gate.admit(f"c{i}", now=100.0 + i)
            gate.admit(f"c{i}", now=100.0 + i)
    assert sorted(gates[0]._clients) == sorted(gates[1]._clients)
    assert len(gates[0]._clients) <= 17


def test_rate_zero_admits_everything():
    for gate in (history.QueryGate(rate=0.0, burst=1.0),
                 ref_history.QueryGate(rate=0.0, burst=1.0)):
        assert all(gate.admit("1.2.3.4")[0] for _ in range(50))
        assert gate.shed_total == 0


def test_a_stampede_is_shed_with_retry_after():
    pair = Pair(query_qps=50.0, query_burst=100.0)
    pair.feed([(BASE, 1.0)])
    codes = [pair.port.handle_query({"family": FAMILY}, "9.9.9.9", False,
                                    "") for _ in range(200)]
    shed = [c for c in codes if c[0] == 429]
    assert len(shed) >= 99            # the bucket holds 100, refills at 50/s
    assert all(int(c[2]["Retry-After"]) >= 1 for c in shed)
    assert pair.port.gate.shed_total == len(shed)


# -- etag_match and the self-metrics ------------------------------------------------

@pytest.mark.parametrize("header,etag", [
    ('"a-1"', '"a-1"'), ("*", '"anything"'), ('"x", "a-1"', '"a-1"'),
    ('W/"a-1"', '"a-1"'), ("", '"a-1"'), ('"a-2"', '"a-1"'),
    ("  ", '"a-1"'), ('W/"a-2", W/"a-1"', '"a-1"'),
])
def test_etag_match_equals_the_reference(header, etag):
    assert history.etag_match(header, etag) == \
        ref_history.etag_match(header, etag)


def test_etag_match_semantics():
    assert history.etag_match('"a-1"', '"a-1"')
    assert history.etag_match("*", '"anything"')
    assert history.etag_match('"x", "a-1"', '"a-1"')
    assert history.etag_match('W/"a-1"', '"a-1"')
    assert not history.etag_match("", '"a-1"')
    assert not history.etag_match('"a-2"', '"a-1"')


@pytest.mark.parametrize("enabled", [True, False])
def test_contribute_renders_the_references_text(enabled):
    rng = np.random.default_rng(11)
    pair = Pair(enabled=enabled, max_series=6, query_qps=2.0,
                query_burst=3.0)
    for cycle in range(12):
        for _ in range(3):
            pair.record("slice_chips",
                        (("slice", f"s{int(rng.integers(0, 9))}"),),
                        float(rng.integers(0, 64)))
        pair.commit(BASE + 10.0 * cycle, cycle + 1)
        for _ in range(int(rng.integers(0, 5))):
            pair.query(family="slice_chips", window="1h")
    texts = []
    for store, builder in ((pair.port, SnapshotBuilder()),
                           (pair.ref, RefBuilder())):
        store.contribute(builder)
        texts.append(builder.build().render())
    assert texts[0] == texts[1]
    assert "kts_history_series_shed_total" in texts[0]
    assert "kts_query_requests_total" in texts[0]


# -- the doctor's --at replay ---------------------------------------------------

class TestDoctorAt:
    """`doctor --fleet --at` and `--efficiency --at` replay the verdict
    from ring payloads: a real store of each package through a
    straggler episode (and a waste verdict, and a suspect link) and its
    recovery. The past still names the straggler in both."""

    STEPS = "slice_worker_steps_per_second"
    UP = "slice_target_up"
    RATIO = "slice_straggler_ratio"
    LINKS = "kts_fleet_link_suspect"
    WASTE = "kts_fleet_waste_suspect"

    def make_history(self) -> tuple[Pair, float]:
        pair = Pair()
        t0 = BASE
        # t0: worker w2 straggling at 2 steps/s, target node-2 down, a
        # link accused, a pod wasting cards.
        for worker, rate in (("w0", 10.0), ("w1", 10.0), ("w2", 2.0)):
            pair.record(self.STEPS, (("slice", "s0"), ("worker", worker)),
                        rate)
        pair.record(self.RATIO, (("slice", "s0"),), 0.2)
        pair.record(self.UP, (("target", "node-2:9400"),), 0.0)
        pair.record(self.LINKS, (("link", "1-2"), ("reason", "ici-rate")),
                    1.0)
        pair.record(self.WASTE, (("pod", "train-1"), ("namespace", "ml"),
                                 ("reason", "idle-reservation")), 1.0)
        pair.commit(t0, 1)
        # t0+600: fully recovered (tombstones for the verdicts).
        for worker in ("w0", "w1", "w2"):
            pair.record(self.STEPS, (("slice", "s0"), ("worker", worker)),
                        10.0)
        pair.record(self.RATIO, (("slice", "s0"),), 1.0)
        pair.record(self.UP, (("target", "node-2:9400"),), 1.0)
        pair.record(self.LINKS, (("link", "1-2"), ("reason", "ici-rate")),
                    0.0)
        pair.record(self.WASTE, (("pod", "train-1"), ("namespace", "ml"),
                                 ("reason", "idle-reservation")), 0.0)
        pair.commit(t0 + 600.0, 2)
        return pair, t0

    def verdicts_at(self, pair: Pair, ts: float):
        from kube_gpu_stats_tpu import doctor as ref_doctor
        from kube_gpu_stats_tpu_torch import doctor

        out = []
        for store, mod in ((pair.port, doctor), (pair.ref, ref_doctor)):
            fleet = mod.fleet_at_verdict(
                store.at_payload(self.STEPS, ts),
                store.at_payload(self.UP, ts),
                store.at_payload(self.RATIO, ts), ts,
                links_payload=store.at_payload(self.LINKS, ts))
            waste = mod.efficiency_at_verdict(
                store.at_payload(self.WASTE, ts), ts)
            out.append((fleet, waste))
        assert out[0] == out[1]
        return out[0]

    def test_straggler_ten_minutes_ago_stays_named_after_recovery(self):
        pair, t0 = self.make_history()
        (status, detail, data), waste = self.verdicts_at(pair, t0)
        assert status == "warn"
        assert "straggler worker w2" in detail
        assert "ratio 0.20" in detail
        assert "as of" in detail
        assert "node-2:9400 was down" in detail
        assert "ICI link 1-2 was suspect (ici-rate" in detail
        assert data["slices"]["s0"]["slowest_worker"] == "w2"
        assert data["targets_down"] == ["node-2:9400"]
        assert waste[0] == "warn"
        assert "ml/train-1 was wasting chips (idle-reservation" in waste[1]

    def test_now_is_healthy_after_recovery(self):
        pair, t0 = self.make_history()
        (status, detail, _data), waste = self.verdicts_at(pair, t0 + 600.0)
        assert status == "ok"
        assert "fleet healthy" in detail
        assert waste[0] == "ok" and "no pod was wasting chips" in waste[1]

    def test_empty_ring_says_it_does_not_survive_restarts(self):
        from kube_gpu_stats_tpu import doctor as ref_doctor
        from kube_gpu_stats_tpu_torch import doctor

        empty = {"series": []}
        got = doctor.fleet_at_verdict(empty, empty, empty, BASE)
        assert got == ref_doctor.fleet_at_verdict(empty, empty, empty, BASE)
        assert got[0] == "warn"
        assert "does not survive a restart" in got[1]
        got = doctor.efficiency_at_verdict(empty, BASE)
        assert got == ref_doctor.efficiency_at_verdict(empty, BASE)
        assert got[0] == "warn" and "no waste samples" in got[1]

    @pytest.mark.parametrize("raw", ["600", "10m", "-2h", "1700000000",
                                     "1.5h", "", "x", "-"])
    def test_parse_at_equals_the_reference(self, raw):
        from kube_gpu_stats_tpu import doctor as ref_doctor
        from kube_gpu_stats_tpu_torch import doctor

        def parsed(mod):
            try:
                return mod.parse_at(raw, BASE)
            except ValueError as exc:
                return str(exc)

        assert parsed(doctor) == parsed(ref_doctor)
