"""The port's energy accountant against the JAX package's.

Seeded numpy traces of tick power and burst samples go through both
``EnergyAccountant``s call for call: pods rescheduled between ticks,
outages past ``max_gap``, stale ticks that bring burst samples only,
NaN and inf in the gauge and the samples, ``forget_device``. The two
run the same float operations, so per-pod totals, coverage and
``_state()`` must be equal, not close. With the same injected wall
clock the signed digests are equal and each package's
``verify_payload`` accepts the other's. Checkpoints cross-load both
ways, through the cases of ``tests/test_energy.py`` (torn main file,
crash between fsync and rename, a future major quarantined). The
doctor's ``energy`` and ``stores`` rows equal the reference's for the
same served payloads. Both poll loops run the same ticks with
``energy=`` (mock collector, scripted burst samples, pods from a
device-plugin checkpoint file) and serve the same ``kts_energy_*``
text. The daemon over ``testing.fake_nvml`` serves ``kts_energy_*``
with no ``--energy-checkpoint``, as the reference's does.
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
import time
import urllib.request

import numpy as np
import pytest

from kube_gpu_stats_tpu import doctor as ref_doctor
from kube_gpu_stats_tpu import energy as ref_energy
from kube_gpu_stats_tpu import wal as ref_wal
from kube_gpu_stats_tpu.attribution import \
    CachedAttribution as RefCachedAttribution
from kube_gpu_stats_tpu.attribution.checkpoint import \
    CheckpointSource as RefCheckpointSource
from kube_gpu_stats_tpu.burstsampler import BurstSampler as RefBurstSampler
from kube_gpu_stats_tpu.collectors.mock import MockCollector as RefMock
from kube_gpu_stats_tpu.config import Config as RefConfig
from kube_gpu_stats_tpu.daemon import Daemon as RefDaemon
from kube_gpu_stats_tpu.exposition import MetricsServer as RefMetricsServer
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
from kube_gpu_stats_tpu_torch import daemon, doctor, energy, schema, wal
from kube_gpu_stats_tpu_torch.attribution import CachedAttribution
from kube_gpu_stats_tpu_torch.attribution.checkpoint import CheckpointSource
from kube_gpu_stats_tpu_torch.burstsampler import BurstSampler
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.config import Config
from kube_gpu_stats_tpu_torch.exposition import MetricsServer
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry, SnapshotBuilder
from kube_gpu_stats_tpu_torch.testing.faultfs import FaultFS
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml

GPU = "nvidia.com/gpu"
ENERGY_FAMILIES = (schema.ENERGY_POD.name, schema.ENERGY_COVERAGE.name,
                   schema.ENERGY_CHECKPOINT_WRITES.name,
                   schema.ENERGY_CHECKPOINT_AGE.name)
PACKAGES = {"reference": ref_energy, "port": energy}


@pytest.fixture(autouse=True)
def clean_registries():
    for module in (ref_wal, wal):
        module.reset_store_stats()
        module.reset_quarantine_stats()
    yield
    for module in (ref_wal, wal):
        module.reset_store_stats()
        module.reset_quarantine_stats()
        module.set_probe_interval(5.0)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class Wall:
    def __init__(self, t: float = 1.76e9) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def pair(**kwargs):
    """The reference's accountant and the port's on one wall clock."""
    wall = kwargs.pop("wall", None) or Wall()
    return (ref_energy.EnergyAccountant(wall=wall, **kwargs),
            energy.EnergyAccountant(wall=wall, **kwargs))


# -- seeded traces -------------------------------------------------------

PODS = [("train-a", "ml"), ("train-b", "ml"), ("infer-0", "serve"),
        ("", "")]


def trace(seed: int, ticks: int = 80, devices: int = 3) -> list[tuple]:
    """("observe", device, pod, namespace, now, watts, samples) and
    ("forget", device) calls: 0.1-1 s ticks, an outage of 15-40 s now
    and then (past the 10 s max_gap), pods rescheduled, stale ticks with
    burst samples only, bursts at ~100 Hz with a NaN, an inf, a negative
    reading or an out-of-window time among them, the gauge NaN or inf
    now and then, a device forgotten and seen again."""
    rng = np.random.default_rng(seed)
    owner = {str(d): PODS[d % len(PODS)] for d in range(devices)}
    calls: list[tuple] = []
    t = 100.0
    for _ in range(ticks):
        prev = t
        t += (float(rng.uniform(15.0, 40.0)) if rng.random() < 0.05
              else float(rng.choice([0.1, 0.25, 0.5, 1.0])))
        for device in owner:
            if rng.random() < 0.08:
                owner[device] = PODS[int(rng.integers(len(PODS)))]
            samples: list[tuple[float, float]] = []
            if rng.random() < 0.6:
                n = int(rng.integers(1, 40))
                times = np.sort(rng.uniform(prev - 0.05, t + 0.02, n))
                watts = rng.uniform(60.0, 720.0, n)
                samples = [(float(a), float(b)) for a, b in
                           zip(times, watts)]
                if rng.random() < 0.2:
                    bad = float(rng.choice([math.nan, math.inf, -5.0]))
                    samples.insert(int(rng.integers(len(samples) + 1)),
                                   (float(rng.uniform(prev, t)), bad))
            roll = rng.random()
            if roll < 0.1:
                gauge = None  # stale tick: burst only (or nothing)
            elif roll < 0.14:
                gauge = float(rng.choice([math.nan, math.inf]))
            else:
                gauge = float(rng.uniform(60.0, 720.0))
            calls.append(("observe", device, *owner[device], t, gauge,
                          tuple(samples)))
        if rng.random() < 0.04:
            calls.append(("forget", str(int(rng.integers(devices)))))
    return calls


def run(acct, calls) -> list[float]:
    added = []
    for call in calls:
        if call[0] == "forget":
            acct.forget_device(call[1])
        else:
            added.append(acct.observe(*call[1:]))
    return added


def counters(acct) -> tuple:
    return (dict(acct._per_pod), acct.covered_seconds, acct.total_seconds,
            acct.coverage_ratio, acct.burst_samples_used,
            acct.ticks_observed, acct._seq, dict(acct._last))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cover_gap", [0.1, 0.8])
def test_seeded_traces_integrate_identically(seed, cover_gap):
    ref, port = pair(max_gap=10.0, cover_gap=cover_gap)
    calls = trace(seed)
    assert run(port, calls) == run(ref, calls)
    assert counters(port) == counters(ref)
    assert port._state() == ref._state()
    assert port.status() == ref.status()
    totals = list(port._per_pod.values())
    assert all(math.isfinite(j) and j >= 0 for j in totals)
    assert sum(totals) > 0 and 0.0 < port.coverage_ratio <= 1.0


@pytest.mark.parametrize("seed", range(3))
def test_contributed_text_is_the_references(seed):
    ref, port = pair()
    calls = trace(seed)
    run(ref, calls)
    run(port, calls)
    texts = []
    for acct, builder in ((ref, RefBuilder()), (port, SnapshotBuilder())):
        acct.contribute(builder)
        texts.append(builder.build().render())
    assert texts[1] == texts[0]
    assert schema.ENERGY_POD.name in texts[1]


def test_each_guard_matches_the_reference():
    """One call per guard: the outage cap, the stale tick with burst
    samples only, NaN/inf/negative/old/future samples, an inf gauge."""
    script = [
        ("observe", "0", "p", "ns", 0.0, 100.0, ()),
        ("observe", "0", "p", "ns", 1000.0, 100.0, ()),
        ("observe", "0", "p", "ns", 1001.0, None,
         ((1000.1, 100.0), (1000.2, 300.0))),
        ("observe", "0", "p", "ns", 1002.0, math.inf,
         ((1001.5, math.inf), (1001.6, math.nan), (1001.7, -5.0),
          (999.0, 100.0), (1003.0, 100.0))),
        ("observe", "0", "q", "ns", 1003.0, 200.0, ()),
        ("forget", "0"),
        ("observe", "0", "q", "ns", 1004.0, 200.0, ()),
        ("observe", "0", "q", "ns", 1005.0, 200.0, ()),
    ]
    ref, port = pair(max_gap=10.0)
    got, want = run(port, script), run(ref, script)
    assert got == want
    assert got[1] == pytest.approx(1000.0)  # 100 W for the 10 s cap
    assert got[2] == pytest.approx(0.1 * 100.0 + 0.1 * 200.0)
    assert got[3] == 0.0 and got[5] == 0.0  # anchor only after forget
    assert counters(port) == counters(ref)


# -- digest ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_signed_digests_are_equal_and_cross_verify(seed):
    ref, port = pair(audit_key="attest-key", node="node-1")
    calls = trace(seed)
    run(ref, calls)
    run(port, calls)
    ref_digest, port_digest = ref.digest(), port.digest()
    assert port_digest == ref_digest
    assert port_digest["signed"] and len(port_digest["hmac"]) == 64
    assert energy.canonical_payload(port_digest) == \
        ref_energy.canonical_payload(ref_digest)
    for verify in (energy.verify_payload, ref_energy.verify_payload):
        assert verify(ref_digest, "attest-key")
        assert verify(json.loads(json.dumps(port_digest)), "attest-key")
        assert not verify(port_digest, "wrong-key")
        tampered = dict(port_digest, per_pod=[["train-a", "ml", 1.0]])
        assert not verify(tampered, "attest-key")


def test_unsigned_digest_never_verifies(pkg):
    digest = pkg.EnergyAccountant().digest()
    assert not digest["signed"] and "hmac" not in digest
    assert not energy.verify_payload(digest, "any-key")
    assert not energy.verify_payload({**digest, "hmac": ""}, "any-key")


def test_sign_payload_ignores_existing_hmac_field():
    payload = {"a": 1, "hmac": "junk"}
    assert energy.sign_payload(payload, "k") == \
        energy.sign_payload({"a": 1}, "k") == \
        ref_energy.sign_payload(payload, "k")


# -- checkpoints, across the packages ------------------------------------

CROSS = pytest.mark.parametrize(
    "writer,reader", [(ref_energy, energy), (energy, ref_energy)],
    ids=["ref-to-port", "port-to-ref"])


def _loaded(module, path: str, **kwargs):
    return module.EnergyAccountant(checkpoint_path=path, wall=Wall(),
                                   **kwargs)


@CROSS
@pytest.mark.parametrize("seed", range(3))
def test_checkpoints_cross_load(tmp_path, writer, reader, seed):
    calls = trace(seed)
    paths = {}
    for module in (ref_energy, energy):
        paths[module] = str(tmp_path / f"{module.__name__}.json")
        acct = _loaded(module, paths[module])
        run(acct, calls)
        assert acct.checkpoint(force=True)
    assert (open(paths[ref_energy], "rb").read()
            == open(paths[energy], "rb").read())
    wrote = _loaded(writer, paths[writer])
    reborn = _loaded(reader, paths[writer])
    assert reborn.checkpoint_loaded
    assert reborn._per_pod == wrote._per_pod
    assert (reborn.covered_seconds, reborn.total_seconds, reborn._seq,
            reborn.burst_samples_used, reborn.ticks_observed) == \
        (wrote.covered_seconds, wrote.total_seconds, wrote._seq,
         wrote.burst_samples_used, wrote.ticks_observed)
    # And keeps counting up from there: monotone across the restart.
    before = dict(reborn._per_pod)
    run(reborn, trace(seed + 10, ticks=5))
    assert all(reborn._per_pod[key] >= value
               for key, value in before.items())


def _served_pod_joules(acct, builder) -> list[float]:
    acct.contribute(builder)
    return [s.value for s in builder.build().series
            if s.spec.name == schema.ENERGY_POD.name]


def test_a_restart_serves_no_joule_below_the_last_scrape(tmp_path):
    """A pod's joules that round down at the sixth decimal. Both packages
    write the same checkpoint (rounded to nearest), which replays below
    the value served before the restart: the reference serves that, a
    counter reset to Prometheus; the port serves no less than its last
    scrape, across a second restart too, and counts on from there."""
    served = {}
    for module, builder in ((ref_energy, RefBuilder), (energy,
                                                       SnapshotBuilder)):
        path = str(tmp_path / f"{module.__name__}.json")
        acct = _loaded(module, path)
        acct.observe("0", "train", "ml", 1.0, 100.0)
        acct.observe("0", "train", "ml", 1.0 + 4e-9, 100.0)
        got = [_served_pod_joules(acct, builder())]
        assert acct.checkpoint(force=True)
        for _restart in range(2):
            acct = _loaded(module, path)
            got.append(_served_pod_joules(acct, builder()))
            assert acct.checkpoint(force=True)
        acct.observe("0", "train", "ml", 2.0, 100.0)
        acct.observe("0", "train", "ml", 3.0, 100.0)
        got.append(_served_pod_joules(acct, builder()))
        served[module] = [joules for (joules,) in got]
    assert (open(tmp_path / "kube_gpu_stats_tpu.energy.json", "rb").read()
            == open(tmp_path / "kube_gpu_stats_tpu_torch.energy.json",
                    "rb").read())
    ref, port = served[ref_energy], served[energy]
    assert ref[1] < ref[0]  # the reference's reset, not copied
    assert all(a <= b for a, b in zip(port, port[1:])), port
    assert port[1] <= port[0] + 1e-6
    assert port[-1] == pytest.approx(ref[-1]) and port[-1] > 99.0


@CROSS
def test_torn_main_file_recovers_from_wal(tmp_path, writer, reader):
    path = str(tmp_path / "energy.json")
    acct = _loaded(writer, path)
    acct.observe("0", "train", "ml", 1.0, 100.0)
    acct.observe("0", "train", "ml", 2.0, 100.0)
    acct.checkpoint(force=True)
    (tmp_path / "energy.json.wal").write_text(
        (tmp_path / "energy.json").read_text())
    (tmp_path / "energy.json").write_text("{torn")
    reborn = _loaded(reader, path)
    assert reborn.checkpoint_loaded and reborn.status()["pods"] == 1
    assert reborn._per_pod[("train", "ml")] == pytest.approx(100.0)


@CROSS
def test_crash_between_fsync_and_rename_recovers_newer_wal(tmp_path, writer,
                                                           reader):
    path = str(tmp_path / "energy.json")
    acct = _loaded(writer, path)
    acct.observe("0", "train", "ml", 1.0, 100.0)
    acct.observe("0", "train", "ml", 2.0, 100.0)
    acct.checkpoint(force=True)
    acct.observe("0", "train", "ml", 3.0, 100.0)
    with acct._lock:
        newer = acct._state()
    (tmp_path / "energy.json.wal").write_text(json.dumps(newer))
    reborn = _loaded(reader, path)
    assert reborn.checkpoint_loaded and reborn.status()["seq"] == 2
    assert reborn._per_pod[("train", "ml")] == pytest.approx(200.0)


@CROSS
def test_first_checkpoint_crash_recovers_from_wal_alone(tmp_path, writer,
                                                        reader):
    acct = writer.EnergyAccountant()
    acct.observe("0", "train", "ml", 1.0, 100.0)
    acct.observe("0", "train", "ml", 2.0, 100.0)
    with acct._lock:
        state = acct._state()
    (tmp_path / "energy.json.wal").write_text(json.dumps(state))
    reborn = _loaded(reader, str(tmp_path / "energy.json"))
    assert reborn.checkpoint_loaded and reborn.status()["pods"] == 1


def test_unreadable_checkpoint_starts_at_zero(tmp_path, pkg):
    (tmp_path / "energy.json").write_text("not json")
    acct = _loaded(pkg, str(tmp_path / "energy.json"))
    assert not acct.checkpoint_loaded and acct.status()["pods"] == 0


def test_checkpoint_rate_limited_and_forced(tmp_path, pkg):
    wall = Wall()
    acct = pkg.EnergyAccountant(checkpoint_path=str(tmp_path / "e.json"),
                                checkpoint_interval=3600, wall=wall)
    acct.observe("0", "p", "ns", 1.0, 100.0)
    acct.observe("0", "p", "ns", 2.0, 100.0)
    assert acct.checkpoint()
    assert not acct.checkpoint()
    acct.observe("0", "p", "ns", 3.0, 100.0)
    wall.t += 10.0
    assert not acct.checkpoint()  # still within the interval
    assert acct.checkpoint(force=True)
    assert acct.checkpoint_writes == 2


def test_checkpoint_pruned_keys_default_and_warn(tmp_path, pkg, caplog):
    path = tmp_path / "energy.json"
    path.write_text(json.dumps({
        "version": 1,
        "per_pod": [["train-pod", "ml", 123.5], ["short-record"]],
    }))
    with caplog.at_level("WARNING"):
        acct = _loaded(pkg, str(path))
    assert acct.checkpoint_loaded
    assert acct._per_pod == {("train-pod", "ml"): 123.5}
    assert acct.covered_seconds == 0.0 and acct.total_seconds == 0.0
    assert any("missing" in r.message for r in caplog.records)


@CROSS
def test_checkpoint_future_major_quarantined_byte_identical(tmp_path,
                                                            writer, reader):
    """A checkpoint from a newer build parks aside intact in either
    package; the accountant starts from empty and never overwrites it."""
    path = tmp_path / "energy.json"
    raw = json.dumps({"version": 99, "per_pod": [["p", "ns", 1.0]],
                      "new_field": True}).encode()
    path.write_bytes(raw)
    acct = _loaded(reader, str(path))
    assert not acct.checkpoint_loaded and not acct._per_pod
    assert not path.exists()
    aside = tmp_path / "energy.json.skew-v99"
    assert aside.read_bytes() == raw
    quarantined = (wal if reader is energy else ref_wal).quarantine_counts()
    assert quarantined == {"energy": 1}
    acct.observe("dev0", "p2", "ns", 1.0, 100.0)
    acct.observe("dev0", "p2", "ns", 2.0, 100.0)
    assert acct.checkpoint(force=True)
    assert aside.read_bytes() == raw
    assert _loaded(writer, str(path))._per_pod == {("p2", "ns"): 100.0}


def test_concurrent_checkpoints_serialize(tmp_path):
    path = str(tmp_path / "energy.json")
    acct = energy.EnergyAccountant(checkpoint_path=path)
    for i in range(50):
        acct.observe("0", "p", "ns", float(i), 100.0)
    threads = [threading.Thread(target=acct.checkpoint, args=(True,))
               for _ in range(8)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=30)
        assert not thread.is_alive()
    assert acct.checkpoint_writes == 8
    assert ref_energy.EnergyAccountant(checkpoint_path=path) \
        .checkpoint_loaded


def test_checkpoint_eio_defers_and_counters_stay_monotone(tmp_path):
    wal.set_probe_interval(0.0)
    path = str(tmp_path / "energy.json")
    acct = energy.EnergyAccountant(checkpoint_path=path,
                                   checkpoint_interval=0.0)
    acct.observe("dev0", "pod-a", "ns", 1.0, 100.0)
    acct.observe("dev0", "pod-a", "ns", 2.0, 100.0)
    assert acct.checkpoint(force=True)
    before = acct._per_pod[("pod-a", "ns")]
    with FaultFS() as fs:
        fs.inject(str(tmp_path), "eio", ops=("fsync",))
        acct.observe("dev0", "pod-a", "ns", 3.0, 100.0)
        assert not acct.checkpoint(force=True)
        assert wal.store_health("energy").state == wal.STORE_DEGRADED
        fs.clear()
        assert acct.checkpoint(force=True)
        assert wal.store_health("energy").state == wal.STORE_HEALTHY
    fresh = ref_energy.EnergyAccountant(checkpoint_path=path)
    assert fresh._per_pod[("pod-a", "ns")] > before


# -- /debug/energy, /debug/stores and the doctor's rows -------------------

def _row(result) -> tuple:
    return (result.name, result.status, result.detail,
            json.loads(json.dumps(result.data, sort_keys=True)))


@pytest.fixture(params=["reference", "port"])
def serve(request):
    """Start one package's MetricsServer with the given providers."""
    server_cls, registry_cls = ((RefMetricsServer, RefRegistry)
                                if request.param == "reference"
                                else (MetricsServer, Registry))
    servers = []

    def start(**providers):
        server = server_cls(registry_cls(), host="127.0.0.1", port=0,
                            **providers)
        server.start()
        servers.append(server)
        return f"http://127.0.0.1:{server.port}"

    yield start
    for server in servers:
        server.stop()


def _served_accountant(module, audit_key: str):
    acct = module.EnergyAccountant(audit_key=audit_key, node="node-1",
                                   wall=Wall())
    acct.observe("0", "train", "ml", 1.0, 100.0)
    acct.observe("0", "train", "ml", 2.0, 100.0)
    return acct


@pytest.mark.parametrize("served_key,local_key,status", [
    ("attest-key", "attest-key", "ok"),
    ("attest-key", "other-key", "fail"),
    ("attest-key", "", "warn"),
    ("", "attest-key", "fail"),
])
@pytest.mark.parametrize("module", [ref_energy, energy],
                         ids=["ref-digest", "port-digest"])
def test_energy_rows_equal_the_references(serve, module, served_key,
                                          local_key, status):
    base = serve(energy_provider=_served_accountant(module, served_key))
    got = doctor.check_energy(base, local_key)
    assert _row(got) == _row(ref_doctor.check_energy(base, local_key))
    assert got.status == status
    assert "100.0 J" in got.detail


def test_energy_row_without_the_endpoint_equals_the_references(serve):
    base = serve()
    got = doctor.check_energy(base, "attest-key")
    assert _row(got) == _row(ref_doctor.check_energy(base, "attest-key"))
    assert got.status == "warn" and "no /debug/energy" in got.detail


def test_energy_row_behind_auth_equals_the_references(serve):
    base = serve(energy_provider=_served_accountant(energy, "k"),
                 auth_username="ops",
                 auth_password_sha256=hashlib.sha256(b"pw").hexdigest())
    got = doctor.check_energy(base, "k")
    assert _row(got) == _row(ref_doctor.check_energy(base, "k"))
    assert got.status == "warn" and "HTTP 401" in got.detail


STORES_PAYLOADS = {
    "healthy": {"enabled": True, "stores": {
        "energy": {"state": "healthy", "fault_counts": {},
                   "lost_records": 0}}, "threads": []},
    "degraded": {"enabled": True, "stores": {
        "energy": {"state": "degraded", "reason": "disk_full",
                   "errno": "ENOSPC", "degraded_for_seconds": 12.4,
                   "fault_counts": {"ENOSPC": 3}, "lost_records": 0},
        "spill": {"state": "healthy", "fault_counts": {"EIO": 1},
                  "lost_records": 4}},
        "accept_fence": {"in_episode": True, "fenced_total": 7},
        "threads": []},
    "recovered": {"enabled": True, "stores": {
        "energy": {"state": "healthy", "fault_counts": {"EIO": 2},
                   "lost_records": 0}},
        "accept_fence": {"in_episode": False, "fenced_total": 2},
        "threads": [{"component": "poll", "restarts": 0}]},
    "threads": {"enabled": True, "stores": {}, "threads": [
        {"component": "burst", "restarts": 2, "last_reason": "dead",
         "storm_latched": False},
        {"component": "poll", "restarts": 5, "storm_latched": True}]},
}


@pytest.mark.parametrize("case", sorted(STORES_PAYLOADS))
def test_stores_verdicts_equal_the_references(case):
    payload = STORES_PAYLOADS[case]
    assert doctor.stores_verdict(payload) == \
        ref_doctor.stores_verdict(payload)


@pytest.mark.parametrize("case", sorted(STORES_PAYLOADS))
def test_stores_rows_equal_the_references(serve, case):
    base = serve(stores_provider=lambda: STORES_PAYLOADS[case])
    got = doctor.check_stores(base)
    assert _row(got) == _row(ref_doctor.check_stores(base))
    assert got.status == ("ok" if case in ("healthy", "recovered")
                          else "warn")


def test_stores_row_without_the_endpoint_equals_the_references(serve):
    base = serve()
    got = doctor.check_stores(base)
    assert _row(got) == _row(ref_doctor.check_stores(base))
    assert got.status == "warn"


# -- the poll loop --------------------------------------------------------

class Clock:
    def __init__(self) -> None:
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def _checkpoint_file(path, owners: dict[str, str]) -> None:
    """The kubelet's device-plugin checkpoint: device index -> pod UID."""
    path.write_text(json.dumps({"Data": {"PodDeviceEntries": [
        {"PodUID": uid, "ContainerName": "main", "ResourceName": GPU,
         "DeviceIDs": {"-1": [device]}}
        for device, uid in owners.items() if uid],
        "RegisteredDevices": {GPU: sorted(owners)}}, "Checksum": 1}))


@pytest.mark.parametrize("seed", range(3))
def test_poll_loops_serve_the_same_energy_text(tmp_path, seed):
    rng = np.random.default_rng(seed)
    ckpt = tmp_path / "kubelet_internal_checkpoint"
    owners = {"0": "uid-a", "1": "uid-b", "2": ""}
    _checkpoint_file(ckpt, owners)
    clock = Clock()
    sides = []
    for (loop_cls, registry, mock, sampler_cls, attr_cls, source_cls,
         module) in (
            (RefPollLoop, RefRegistry(native=False), RefMock(3),
             RefBurstSampler, RefCachedAttribution, RefCheckpointSource,
             ref_energy),
            (PollLoop, Registry(), MockCollector(3), BurstSampler,
             CachedAttribution, CheckpointSource, energy)):
        attribution = attr_cls(source_cls(str(ckpt)))
        attribution.refresh_once()
        burst = sampler_cls(lambda mock=mock: mock, mock.discover,
                            clock=clock, mode="continuous")
        acct = module.EnergyAccountant(
            checkpoint_path=str(tmp_path / f"{module.__name__}.json"),
            checkpoint_interval=2.0, wall=clock, max_gap=10.0,
            cover_gap=0.04)
        loop = loop_cls(mock, registry, interval=0.5, deadline=30.0,
                        version="test", attribution=attribution,
                        burst_sampler=burst, energy=acct, clock=clock)
        sides.append((loop, registry, burst, attribution, acct))
    try:
        for tick in range(14):
            if tick in (5, 9):
                owners["0"], owners["2"] = owners["2"] or "uid-c", \
                    owners["0"]
                _checkpoint_file(ckpt, owners)
                for side in sides:
                    side[3].refresh_once()
            prev = clock.now
            clock.now += float(rng.choice([0.25, 0.5, 1.0]))
            if tick != 3:  # one tick with no burst samples at all
                for device in ("0", "1", "2"):
                    n = int(rng.integers(0, 30))
                    times = np.sort(rng.uniform(prev, clock.now, n))
                    watts = rng.uniform(80.0, 700.0, n)
                    for t, w in zip(times, watts):
                        for side in sides:
                            side[2].inject(device, float(t), float(w))
            texts = []
            for loop, registry, _, _, acct in sides:
                loop.tick()
                loop._ckpt_future.result(timeout=10)
                text = registry.rendered()[0].decode()
                texts.append([line for line in text.splitlines()
                              if line.split("{")[0].split(" ")[0]
                              in ENERGY_FAMILIES])
            assert texts[1] == texts[0], tick
        assert any('pod="uid-c"' in line for line in texts[1])
        assert any(line.startswith(schema.ENERGY_CHECKPOINT_AGE.name)
                   for line in texts[1])
        assert sides[1][4]._per_pod == sides[0][4]._per_pod
    finally:
        for loop, *_ in sides:
            loop.stop()


def test_rediscovery_forgets_the_energy_anchor():
    clock = Clock()
    acct = energy.EnergyAccountant(wall=clock)
    mock = MockCollector(2)
    loop = PollLoop(mock, Registry(), interval=1.0, deadline=30.0,
                    energy=acct, clock=clock)
    try:
        loop.tick()
        assert set(acct._last) == {"0", "1"}
        mock._num = 1
        loop.rediscover()
        assert set(acct._last) == {"0"}
    finally:
        loop.stop()


# -- the daemon -----------------------------------------------------------

def _nvml_daemon(monkeypatch, **fields) -> daemon.Daemon:
    fake = FakeNvml([FakeDevice("GPU-0", 0, power_mw=250_000)])
    monkeypatch.setattr(daemon, "_nvml_collector",
                        lambda: NvmlCollector(fake))
    cfg = Config(backend="nvml", interval=0.05, listen_host="127.0.0.1",
                 listen_port=0, attribution="off", device_processes="off",
                 **fields)
    return daemon.Daemon(cfg)


def _families(text: str) -> set[str]:
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line.startswith("kts_energy_")}


def test_the_nvml_daemon_serves_energy_without_a_checkpoint(monkeypatch):
    d = _nvml_daemon(monkeypatch)
    ref = RefDaemon(RefConfig(backend="mock", mock_devices=1,
                              interval=0.05, listen_host="127.0.0.1",
                              listen_port=0, attribution="off"))
    d.start()
    ref.start()
    try:
        texts = []
        for instance in (ref, d):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                text = urllib.request.urlopen(
                    f"http://127.0.0.1:{instance.server.port}/metrics",
                    timeout=5).read().decode()
                if 'kts_energy_pod_joules_total{pod=""' in text:
                    break
                time.sleep(0.05)
            texts.append(text)
        assert _families(texts[1]) == _families(texts[0]) == {
            schema.ENERGY_POD.name, schema.ENERGY_COVERAGE.name,
            schema.ENERGY_CHECKPOINT_WRITES.name}
        digest = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{d.server.port}/debug/energy",
            timeout=5).read())
        assert not digest["signed"] and digest["per_pod"][0][2] > 0
        stores = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{d.server.port}/debug/stores",
            timeout=5).read())
        assert sorted(stores) == ["accept_fence", "enabled", "role",
                                  "stores", "threads"]
        assert {row["component"] for row in stores["threads"]} >= {"poll"}
    finally:
        d.stop()
        ref.stop()
    assert d.energy.checkpoint_writes == 0


@pytest.mark.parametrize("burst_hz,cover_gap", [(5.0, 0.8), (100.0, 0.1),
                                                (20.0, 0.2)])
def test_the_daemon_derives_cover_gap_from_burst_hz(monkeypatch, burst_hz,
                                                    cover_gap):
    d = _nvml_daemon(monkeypatch, burst_hz=burst_hz)
    ref = RefDaemon(RefConfig(backend="null", listen_port=0,
                              burst_hz=burst_hz, attribution="off"))
    try:
        assert d.energy._cover_gap == pytest.approx(cover_gap)
        assert d.energy._cover_gap == ref.energy._cover_gap
        assert d.energy._max_gap == pytest.approx(10 * 0.05)
    finally:
        for instance in (d, ref):
            instance.start()  # stop() on a never-started server hangs
            instance.stop()


def test_stop_forces_the_final_checkpoint(monkeypatch, tmp_path):
    path = tmp_path / "energy.json"
    d = _nvml_daemon(monkeypatch, energy_checkpoint=str(path),
                     energy_checkpoint_interval=3600.0,
                     energy_audit_key="k")
    d.start()
    try:
        assert d.registry.wait_for_publish(0, timeout=5)
        deadline = time.monotonic() + 10
        while d.energy.ticks_observed < 5 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        d.stop()
    state = json.loads(path.read_text())
    assert state["seq"] == d.energy._seq >= 5
    assert d.energy.checkpoint_writes >= 2  # the first write + stop's
    reborn = ref_energy.EnergyAccountant(checkpoint_path=str(path))
    assert reborn._per_pod == {key: round(joules, 6) for key, joules
                               in d.energy._per_pod.items()}
