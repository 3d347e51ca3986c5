"""The port's efficiency lens and its attestation against the reference's.

- ``EfficiencyLens.observe`` over seeded per-pod evidence: pods that go
  idle holding their cards (idle-reservation), that draw power with a
  flat step counter (low-goodput), that lose their duty evidence and
  their energy coverage (UNKNOWN, never ranked), that depart with a
  verdict active, whose joules counter resets, and more pods than the
  top-K bound. After each refresh the journal events, ``summary()``,
  ``rows()``, ``suspects()`` and the ``contribute()`` text are equal.
- ``build_attestation`` over seeded leaf digests (signed, unsigned,
  error stubs): the same canonical bytes and HMAC, and each package
  verifies the other's.
- The hub's ``efficiency_payload`` over an injected energy fetcher
  (reachable leaves, a failing one, the TTL cache, ``--no-efficiency``):
  equal up to ``generated_at``.
- The doctor's ``check_efficiency`` (verified, wrong key, no key,
  unsigned, disabled, 404) and ``check_efficiency_at`` rows: the
  reference's status and text.

Exact throughout.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from kube_gpu_stats_tpu import doctor as ref_doctor
from kube_gpu_stats_tpu import efficiency as ref_efficiency
from kube_gpu_stats_tpu import energy as ref_energy
from kube_gpu_stats_tpu import hub as ref_hub
from kube_gpu_stats_tpu import registry as ref_registry
from kube_gpu_stats_tpu_torch import doctor, efficiency, energy, hub, registry


def _evidence(rng, pod: int, r: int) -> dict | None:
    """Pod ``pod``'s evidence at refresh ``r``; None = absent. Pod 0
    idles from 16 to 26, pod 1 runs a flat counter from 18 to 28, pod 2
    goes blind (no duty, no coverage) from 10 to 14, pod 3 departs at
    25 while idle, pod 4 never exports steps, pod 5's joules reset at
    20; pods 6-13 are busy fillers past the top-K bound."""
    if pod == 3 and r >= 25:
        return None
    duty = float(rng.uniform(40.0, 95.0))
    power = float(rng.uniform(200.0, 650.0)) * 2
    steps = float(rng.uniform(0.5, 4.0))
    joules = 500.0 * r + pod
    coverage = float(rng.uniform(0.1, 1.0))
    if pod == 0 and 16 <= r <= 26:
        duty, steps, power = float(rng.uniform(0.0, 0.4)), 0.0, 140.0
    if pod == 1 and 18 <= r <= 28:
        steps = 0.0
    if pod == 2 and 10 <= r <= 14:
        duty, coverage = None, 0.0
    if pod == 3 and r >= 14:
        duty, steps = 0.0, 0.0
    if pod == 4:
        steps = None
    if pod == 5 and r >= 20:
        joules = 30.0 * (r - 19)
    return {"duty": duty, "power": power, "steps": steps, "chips": 1 + pod % 8,
            "joules": joules, "coverage": coverage}


def _contributed(mod, lens) -> str:
    builder = mod.SnapshotBuilder()
    lens.contribute(builder)
    return builder.build().render()


@pytest.mark.parametrize("seed,knobs", [
    (0, {}),
    (1, {"warmup_refreshes": 4, "idle_refreshes": 2}),
    (2, {"warmup_refreshes": 1, "idle_refreshes": 3, "idle_duty": 0.5,
         "top_k": 3, "clear_refreshes": 1}),
])
def test_observe_over_seeded_pods_alike(seed, knobs):
    got = efficiency.EfficiencyLens(**knobs)
    want = ref_efficiency.EfficiencyLens(**knobs)
    rng = np.random.default_rng(seed)
    now = 1_700_000_000.0
    events = []
    for seq in range(1, 33):
        now += 10.0
        pods = {}
        for pod in range(14):
            evidence = _evidence(rng, pod, seq)
            if evidence is not None:
                pods[(f"train-{pod}", "ml")] = evidence
        step = got.observe(seq, now, pods)
        assert step == want.observe(seq, now, pods)
        events += step
        assert got.summary() == want.summary()
        assert got.rows() == want.rows()
        assert got.suspects() == want.suspects()
        assert _contributed(registry, got) == \
            _contributed(ref_registry, want)
    raised = {(a["pod"], a["reason"]) for k, _d, a in events
              if k == "fleet_waste"}
    assert ("train-0", "idle-reservation") in raised
    assert ("train-1", "low-goodput") in raised
    assert ("train-3", "idle-reservation") in raised
    assert any(k == "fleet_waste_cleared" and "departed" in d
               for k, d, _a in events)
    assert any(k == "fleet_waste_cleared" and "back in use" in d
               for k, d, _a in events)
    assert not any(a["pod"] == "train-2" for _k, _d, a in events)


def test_unknown_pods_are_counted_and_never_ranked_alike():
    got, want = efficiency.EfficiencyLens(), ref_efficiency.EfficiencyLens()
    blind = {"duty": None, "power": None, "steps": None, "chips": 8,
             "joules": None, "coverage": 0.0}
    for seq in range(1, 20):
        pods = {("blind", "ml"): blind,
                ("busy", "ml"): {"duty": 80.0, "power": 600.0,
                                 "steps": 2.0, "chips": 8, "joules": None,
                                 "coverage": 0.0}}
        assert got.observe(seq, 1000.0 + seq, pods) == \
            want.observe(seq, 1000.0 + seq, pods)
    assert got.summary() == want.summary()
    assert got.summary()["unknown_pods"] == 1
    assert [r["pod"] for r in got.summary()["top_waste"]] == ["busy"]
    text = _contributed(registry, got)
    assert text == _contributed(ref_registry, want)
    assert "kts_fleet_efficiency_unknown_pods 1" in text


# -- the attestation ---------------------------------------------------------

def _leaves(rng, n: int, key: str) -> dict:
    leaves = {}
    for i in range(n):
        target = f"http://node-{i:02d}.fleet:9400/metrics"
        if i % 4 == 3:
            leaves[target] = {"error": f"<urlopen error [Errno -2] {i}>"}
            continue
        digest = {
            "version": 1, "node": f"node-{i:02d}",
            "generated_at": 1_700_000_000.0 + i,
            "per_pod": [[f"train-{j}", "ml", float(rng.uniform(1, 1e6))]
                        for j in range(int(rng.integers(0, 4)))],
            "coverage_ratio": float(rng.uniform(0.0, 1.0)),
            "enabled": True, "signed": bool(key) and i % 2 == 0,
        }
        if digest["signed"]:
            digest["hmac"] = energy.sign_payload(digest, key)
        leaves[target] = digest
    return leaves


@pytest.mark.parametrize("seed,key", [(0, "fleet-key"), (1, ""),
                                      (2, "kéy")])
def test_attestation_same_bytes_and_hmac(seed, key):
    rng = np.random.default_rng(40 + seed)
    lens = efficiency.EfficiencyLens(warmup_refreshes=1, idle_refreshes=1)
    ref_lens = ref_efficiency.EfficiencyLens(warmup_refreshes=1,
                                             idle_refreshes=1)
    for seq in range(1, 4):
        pods = {("idle", "ml"): {"duty": 0.0, "power": 70.0, "steps": 0.0,
                                 "chips": 8, "joules": 10.0 * seq,
                                 "coverage": 1.0}}
        lens.observe(seq, 100.0 * seq, pods)
        ref_lens.observe(seq, 100.0 * seq, pods)
    leaves = _leaves(rng, 7, key)
    kwargs = dict(node="hub-0", generated_at=1_700_000_123.5,
                  targets_total=9)
    got = efficiency.build_attestation(lens.summary(), leaves, key, **kwargs)
    want = ref_efficiency.build_attestation(ref_lens.summary(), leaves, key,
                                            **kwargs)
    assert energy.canonical_payload(got) == \
        ref_energy.canonical_payload(want)
    assert got == want
    assert got["totals"]["targets_total"] == 9
    assert got["totals"]["leaves"] == 7
    assert "ml/idle" in got["waste"]["suspects"]
    if key:
        assert energy.verify_payload(want, key)
        assert ref_energy.verify_payload(got, key)
        assert not energy.verify_payload(got, key + "x")
    else:
        assert "hmac" not in got and got["signed"] is False


# -- the hub's fold ------------------------------------------------------------

LEAF = {"version": 1, "node": "n", "generated_at": 5.0,
        "per_pod": [["train-0", "ml", 150.0]], "coverage_ratio": 0.5,
        "enabled": True, "signed": False}


def _fetcher(calls):
    def fetch(url):
        calls.append(url)
        if "9001" in url:
            raise OSError("connection refused")
        return dict(LEAF)
    return fetch


def test_hub_efficiency_payload_alike(monkeypatch):
    monkeypatch.setenv("HOSTNAME", "hub-7")
    targets = ["http://127.0.0.1:9000/metrics",
               "http://127.0.0.1:9001/metrics", "/var/x.prom"]
    hubs = [hub.Hub(targets, interval=3600.0, energy_audit_key="fleet-key"),
            ref_hub.Hub(targets, interval=3600.0,
                        energy_audit_key="fleet-key", native_ingest=False,
                        history=None)]
    calls = [[], []]
    try:
        for h, seen in zip(hubs, calls):
            h._energy_fetcher = _fetcher(seen)
        payloads = [h.efficiency_payload() for h in hubs]
        for p in payloads:
            p.pop("generated_at")
            p.pop("hmac")
        assert payloads[0] == payloads[1]
        assert payloads[0]["totals"]["targets_total"] == 2
        assert payloads[0]["leaves"][targets[1]] == \
            {"error": "connection refused"}
        assert payloads[0]["node"] == "hub-7"
        assert calls[0] == calls[1] == [
            "http://127.0.0.1:9000/debug/energy",
            "http://127.0.0.1:9001/debug/energy"]
        # The TTL cache: a second read re-signs, fetches nothing.
        for h in hubs:
            assert energy.verify_payload(h.efficiency_payload(),
                                         "fleet-key")
        assert len(calls[0]) == len(calls[1]) == 2
    finally:
        for h in hubs:
            h.stop()


def test_hub_without_efficiency_answers_enabled_false_alike():
    got = hub.Hub(["a.prom"], interval=3600.0, efficiency=False)
    want = ref_hub.Hub(["a.prom"], interval=3600.0, efficiency=False,
                       native_ingest=False, history=None)
    try:
        assert got.efficiency_payload() == want.efficiency_payload() == {
            "enabled": False, "reason": "--no-efficiency"}
        assert got.fleet.efficiency_summary() == {"enabled": False}
    finally:
        got.stop()
        want.stop()


# -- the doctor's rows -----------------------------------------------------------

def _serve(provider=None, history=None):
    from kube_gpu_stats_tpu_torch.exposition import MetricsServer

    server = MetricsServer(registry.Registry(), host="127.0.0.1", port=0,
                           efficiency_provider=provider,
                           history_provider=history)
    server.start()
    return server


def _row(result) -> tuple:
    return result.name, result.status, result.detail


def _attestation(key: str, suspects: bool = True) -> dict:
    lens = efficiency.EfficiencyLens(warmup_refreshes=1, idle_refreshes=1)
    if suspects:
        for seq in range(1, 4):
            lens.observe(seq, 10.0 * seq, {("idle", "ml"): {
                "duty": 0.0, "power": 70.0, "steps": None, "chips": 4,
                "joules": None, "coverage": 1.0}})
    return efficiency.build_attestation(
        lens.summary(), {"http://a/metrics": dict(LEAF)}, key,
        generated_at=1.0)


@pytest.mark.parametrize("case", ["verified", "clean", "wrong-key", "no-key",
                                  "unsigned", "tampered", "disabled",
                                  "missing"])
def test_check_efficiency_rows_equal_the_reference(case):
    payload = {"verified": _attestation("k"),
               "clean": _attestation("k", suspects=False),
               "wrong-key": _attestation("other"),
               "no-key": _attestation("k"),
               "unsigned": _attestation(""),
               "tampered": dict(_attestation("k"), node="mallory"),
               "disabled": {"enabled": False, "reason": "--no-efficiency"},
               "missing": None}[case]
    key = "" if case == "no-key" else "k"
    server = _serve(None if payload is None else (lambda: payload))
    try:
        base = f"http://127.0.0.1:{server.port}"
        got = doctor.check_efficiency(base, key)
        want = ref_doctor.check_efficiency(base, key)
        assert _row(got) == _row(want)
        assert got.data == want.data
        status = {"verified": "warn", "clean": "ok", "wrong-key": "fail",
                  "no-key": "warn", "unsigned": "fail", "tampered": "fail",
                  "disabled": "warn", "missing": "warn"}[case]
        assert got.status == status, got.detail
    finally:
        server.stop()


def test_check_efficiency_at_rows_equal_the_reference():
    from kube_gpu_stats_tpu_torch import history

    store = history.HistoryStore()
    labels = (("pod", "idle"), ("namespace", "ml"),
              ("reason", "idle-reservation"))
    at = time.time() - 120.0
    store.record("kts_fleet_waste_suspect", labels, 1.0)
    store.commit(at, 1)
    store.record("kts_fleet_waste_suspect", labels, 0.0)
    store.commit(at + 60.0, 2)
    server = _serve(history=store)
    try:
        base = f"http://127.0.0.1:{server.port}"
        for ts in (at, at + 60.0):
            got = doctor.check_efficiency_at(base, ts)
            want = ref_doctor.check_efficiency_at(base, ts)
            assert _row(got) == _row(want)
        assert doctor.check_efficiency_at(base, at).status == "warn"
        assert "ml/idle was wasting chips" in \
            doctor.check_efficiency_at(base, at).detail
    finally:
        server.stop()
    payload = json.loads(json.dumps(store.at_payload(
        "kts_fleet_waste_suspect", at)))
    assert doctor.efficiency_at_verdict(payload, at) == \
        ref_doctor.efficiency_at_verdict(payload, at)
