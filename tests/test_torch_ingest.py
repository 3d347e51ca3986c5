"""The port's delta ingest against the reference's, frame by frame.

The same seeded frame sequences go into the port's ``DeltaIngest`` and
the reference's ``DeltaIngest(native=False)`` (its Python oracle; also
its default, which may take the native slot store where it is built),
each with its own hub's ``_TargetCache`` entries. After every frame the
two give the same status, body and headers, and the same session state:
generation, seq, frame count, admission order, wire state and the
entry's series. Covered: FULL, DELTA, a retransmitted FULL, seq gaps,
generation changes, a DELTA before any FULL, slots out of range, proto
skew with its 426 and throttle, malformed frames up to quarantine, rate,
in-flight, session-fence and hard-cap sheds with Retry-After, lane
routing, eviction and expiry, ``stats`` and ``skew_status``; the
warm-restart checkpoint written by either package replays in the other,
also after a torn write under either package's ``FaultFS``.

Exact throughout: the ingest does no arithmetic; values compare by
``repr``. The build string is pinned (``build="b"``) because the two
packages' versions differ.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from kube_gpu_stats_tpu import cardinality as ref_cardinality
from kube_gpu_stats_tpu import delta as ref_delta
from kube_gpu_stats_tpu import hub as ref_hub
from kube_gpu_stats_tpu import wal as ref_wal
from kube_gpu_stats_tpu.testing import faultfs as ref_faultfs
from kube_gpu_stats_tpu_torch import cardinality, delta, hub, snappy, wal
from kube_gpu_stats_tpu_torch.testing import faultfs as port_faultfs


def _pair(ref_native: bool = False, lanes: int = 1, accountants=(None, None),
          **kwargs):
    """(port, reference) ingests with their hubs' entries and, like the
    hubs, an entry store sharded by the same lanes."""
    port = delta.DeltaIngest(
        build="b", lanes=lanes, entry_store=delta.LaneStore(lanes),
        entry_factory=lambda s: hub._TargetCache("", s, pushed=True),
        accountant=accountants[0], **kwargs)
    ref = ref_delta.DeltaIngest(
        build="b", lanes=lanes, native=ref_native,
        entry_store=ref_delta.LaneStore(lanes),
        entry_factory=lambda s: ref_hub._TargetCache("", s, pushed=True),
        accountant=accountants[1], **kwargs)
    return port, ref


def _state(ingest) -> dict:
    sessions = {}
    for index, lane in enumerate(ingest._lanes):
        for source, s in lane.sessions.items():
            sessions[source] = (index, s.generation, s.seq, s.frames,
                                s.order, s.proto, s.caps, s.build)
    store = ingest._entry_store
    entries = {}
    for source in store:
        entry = store[source]
        entries[source] = [(name, labels, repr(float(value)))
                           for name, labels, value in entry.series]
    return {"sessions": sessions, "entries": entries,
            "stats": ingest.stats(), "shed": ingest.shed_total,
            "lanes": [{k: v for k, v in lane.items() if k != "apply_seconds"}
                      for lane in ingest.lane_stats()]}


def _skew(ingest) -> dict:
    status = ingest.skew_status()
    for record in status["refused_peers"].values():
        record.pop("last_wall")
    return status


def _both(port, ref, wire: bytes, peer: str = ""):
    got = port.handle(wire, peer)
    want = ref.handle(wire, peer)
    assert got == want, (got, want)
    assert _state(port) == _state(ref)
    return got


def _body(rng, node: int, cards: int, step: int) -> str:
    """One node's exposition: per-card gauges with seeded churn (some
    values repeat, so DELTAs carry a few slots, not all)."""
    lines = []
    for card in range(cards):
        labels = (f'accel_type="h100",chip="{card}",slice="s",'
                  f'uuid="GPU-{node}-{card}",worker="node-{node:02d}"')
        duty = float(rng.integers(0, 100)) if rng.random() < 0.5 else 90.0
        lines.append(f"accelerator_up{{{labels}}} 1")
        lines.append(f"accelerator_duty_cycle{{{labels}}} {duty:g}")
        lines.append(f"accelerator_power_watts{{{labels}}} "
                     f"{float(rng.integers(80, 700)):g}")
        lines.append(f"accelerator_workload_steps_total{{{labels}}} "
                     f"{step * 10 + card}")
    return "\n".join(lines) + "\n"


def _sequence(seed: int, sources: int = 4, count: int = 80) -> list:
    """(wire, peer) frames from several publishers interleaved, with
    the faults a receiver must refuse or absorb."""
    rng = np.random.default_rng(seed)
    encoders = [delta.DeltaEncoder(f"node-{i:02d}", 100 + i, build="b")
                for i in range(sources)]
    frames = [(delta.encode_delta("node-00", 100, 1, [(0, 1.0)]),
               "10.0.0.1")]                       # DELTA before any FULL
    last_full: dict[int, bytes] = {}
    for step in range(count):
        i = int(rng.integers(0, sources))
        enc = encoders[i]
        if step == count // 2:
            enc.set_wire(2, 1)
        wire, kind = enc.encode_next(_body(rng, i, 2 + i % 2, step))
        frames.append((wire, f"10.0.0.{i + 1}"))
        if kind == delta.KIND_FULL:
            last_full[i] = wire
        roll = rng.random()
        if roll < 0.08:
            enc.nack()
        elif roll < 0.12:
            enc.defer()
        else:
            enc.ack()
        if step % 17 == 9 and i in last_full:
            frames.append((last_full[i], ""))      # retransmitted FULL
        if step % 23 == 11:                        # seq gap
            frames.append((delta.encode_delta(
                enc.source, enc.generation, enc.seq + 2, [(0, 3.0)]), ""))
        if step % 29 == 13:                        # slot past the series
            frames.append((delta.encode_delta(
                enc.source, enc.generation, enc.seq + 1,
                [(10_000, 1.0)]), ""))
        if step == count * 3 // 4:                 # worker restart
            encoders[i] = delta.DeltaEncoder(enc.source, 900 + i,
                                             build="b2")
        if step % 31 == 7:
            frames.append((b"not snappy at all", "10.9.9.9"))
            frames.append((snappy.compress(b"KTSD\x05\x00junk"), ""))
    return frames


@pytest.mark.parametrize("ref_native", [False, True],
                         ids=["reference-oracle", "reference-default"])
@pytest.mark.parametrize("seed", range(3))
def test_frames_apply_as_the_reference(seed, ref_native):
    port, ref = _pair(ref_native=ref_native, lanes=3)
    codes = [_both(port, ref, wire, peer)[0]
             for wire, peer in _sequence(seed)]
    assert {200, 409, 400} <= set(codes)
    assert port.duplicate_frames_total and port.resyncs_total
    assert _skew(port) == _skew(ref)
    assert port.fleet_versions() == ref.fleet_versions()


def test_a_full_body_that_does_not_parse_quarantines_its_source():
    port, ref = _pair(quarantine_threshold=3, quarantine_window=60.0)
    bad = delta.encode_full("node-x", 1, 1, "garbage line\n")
    codes = [_both(port, ref, bad, "10.0.0.7")[0] for _ in range(5)]
    assert codes == [400, 400, 400, 429, 429]
    # The source is quarantined, not the shared address.
    good = delta.encode_full("node-y", 1, 1, "a 1\n")
    assert _both(port, ref, good, "10.0.0.7")[0] == 200
    assert port.quarantined == ref.quarantined == 1


def test_undecodable_frames_quarantine_the_peer_then_absolve():
    port, ref = _pair(quarantine_threshold=2, quarantine_window=0.05)
    codes = [_both(port, ref, b"garbage", "10.0.0.8")[0]
             for _ in range(3)]
    assert codes == [400, 400, 429]
    time.sleep(0.06)                       # the recovery probe's window
    good = delta.encode_full("node-z", 1, 1, "a 1\n")
    assert _both(port, ref, good, "10.0.0.8")[0] == 200
    assert port.quarantined == ref.quarantined == 0


def test_proto_skew_draws_426_with_hello_then_the_throttle():
    port, ref = _pair(proto_min=2)
    v1 = delta.encode_full("node-a", 1, 1, "a 1\n")
    answers = [_both(port, ref, v1, "10.1.1.1") for _ in range(4)]
    assert [code for code, _, _ in answers] == [426] * 4
    for _, _, headers in answers:
        assert headers[delta.HELLO_PROTO_MIN] == "2"
        assert headers["Retry-After"] == "60"
    v2 = delta.encode_full("node-a", 1, 1, "a 1\n", proto=2, caps=1,
                           build="b")
    # A throttled peer re-draws its 426 before any decode.
    assert _both(port, ref, v2, "10.1.1.1")[0] == 426
    assert _both(port, ref, v2, "10.1.1.2")[0] == 200
    assert _skew(port) == _skew(ref)
    assert port.skew_refused_total == ref.skew_refused_total == 5


def test_a_session_of_an_old_wire_is_refused_by_source():
    port, ref = _pair(proto_max=1)
    v2 = delta.encode_full("node-b", 1, 1, "a 1\n", proto=2, caps=1)
    assert _both(port, ref, v2, "10.2.2.2")[0] == 426
    assert _skew(port) == _skew(ref)


def test_delta_rate_sheds_429_with_retry_after():
    port, ref = _pair(delta_rate=0.5, delta_burst=1.0)
    assert _both(port, ref, delta.encode_full("n", 1, 1, "a 1\n"))[0] == 200
    assert _both(port, ref, delta.encode_delta("n", 1, 2, [(0, 2.0)]))[0] \
        == 200
    code, body, headers = _both(port, ref,
                                delta.encode_delta("n", 1, 3, [(0, 3.0)]))
    assert (code, body) == (429, b"shed: delta rate over lane budget\n")
    assert float(headers["Retry-After"]) > 0
    # A FULL is never rate-shed.
    assert _both(port, ref, delta.encode_full("n", 1, 4, "a 4\n"))[0] == 200
    assert port.shed_total == ref.shed_total == {"delta_rate": 1}


def test_in_flight_budget_sheds_deltas_first_then_fulls():
    port, ref = _pair(max_inflight=4)
    assert _both(port, ref, delta.encode_full("n", 1, 1, "a 1\n"))[0] == 200
    for ingest in (port, ref):
        ingest._inflight = 3          # three applies in flight
    assert _both(port, ref, delta.encode_delta("n", 1, 2, [(0, 2.0)])) == (
        429, b"shed: ingest at the in-flight budget\n", {"Retry-After": "1"})
    assert _both(port, ref, delta.encode_full("n", 1, 2, "a 2\n"))[0] == 200
    for ingest in (port, ref):
        ingest._inflight = 4
    assert _both(port, ref, delta.encode_full("n", 1, 3, "a 3\n"))[0] == 503


def test_the_session_fence_refuses_only_new_sources():
    port, ref = _pair(max_sessions=2)
    for source in ("a", "b"):
        assert _both(port, ref, delta.encode_full(source, 1, 1, "x 1\n"))[0] \
            == 200
    assert _both(port, ref, delta.encode_full("c", 1, 1, "x 1\n")) == (
        503, b"shed: session table at the memory fence\n",
        {"Retry-After": "15"})
    assert _both(port, ref, delta.encode_full("a", 1, 2, "x 2\n"))[0] == 200


def test_the_series_hard_cap_sheds_413():
    port, ref = _pair(accountants=(
        cardinality.SeriesAccountant(hard_cap=3),
        ref_cardinality.SeriesAccountant(hard_cap=3)))
    body = "a 1\nb 2\nc 3\n"
    assert _both(port, ref, delta.encode_full("s1", 1, 1, body))[0] == 200
    code, _, headers = _both(port, ref, delta.encode_full("s2", 1, 1, body))
    assert code == 413 and headers["Retry-After"] == "30"
    assert port._accountant.debug_payload() == ref._accountant.debug_payload()


@pytest.mark.parametrize("lanes", [1, 2, 3, 8, 64])
def test_lane_routing_equals_the_reference(lanes):
    rng = np.random.default_rng(lanes)
    sources = [f"http://10.{int(rng.integers(0, 255))}."
               f"{int(rng.integers(0, 255))}.1:9400/metrics"
               for _ in range(200)] + ["", "node-00"]
    assert [delta.lane_of(s, lanes) for s in sources] == \
        [ref_delta.lane_of(s, lanes) for s in sources]
    assert delta.DEFAULT_INGEST_LANES == ref_delta.DEFAULT_INGEST_LANES


def test_evict_and_expiry_as_the_reference(monkeypatch):
    port, ref = _pair(lanes=2, expiry=100.0)
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    for i in range(6):
        wire = delta.encode_full(f"n{i}", 1, 1, f"a {i}\n")
        assert _both(port, ref, wire)[0] == 200
        clock[0] += 10.0
    assert port.sources() == ref.sources() == [f"n{i}" for i in range(6)]
    assert port.fresh_sources(25.0) == ref.fresh_sources(25.0)
    clock[0] += 55.0                  # n0 and n1 now past the expiry
    assert port.sources() == ref.sources() == ["n2", "n3", "n4", "n5"]
    port.evict({"n3", "n5"})
    ref.evict({"n3", "n5"})
    assert port.sources() == ref.sources() == ["n3", "n5"]
    assert _state(port)["sessions"] == _state(ref)["sessions"]
    gap = delta.encode_delta("n4", 1, 2, [(0, 9.0)])
    assert _both(port, ref, gap)[0] == 409


# -- the warm-restart checkpoint ----------------------------------------------

def _fill(port, ref, seed: int) -> None:
    for wire, peer in _sequence(seed, count=40):
        _both(port, ref, wire, peer)


def _comparable(state: dict) -> dict:
    return {k: v for k, v in state.items() if k != "wall"}


def test_checkpoints_are_written_as_the_reference(tmp_path):
    port, ref = _pair(lanes=2, checkpoint_path=str(tmp_path / "p.json"))
    ref._ckpt_path = str(tmp_path / "r.json")
    _fill(port, ref, 5)
    assert port.checkpoint(force=True) and ref.checkpoint(force=True)
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "r.json").read_text())
    assert _comparable(got) == _comparable(want)
    assert len(got["sessions"]) == 4


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_checkpoint_replays_in_either_package(tmp_path, writer):
    path = str(tmp_path / "ingest.json")
    port, ref = _pair(lanes=3)
    _fill(port, ref, 6)
    source = port if writer == "port" else ref
    source._ckpt_path = path
    assert source.checkpoint(force=True)
    before = _state(source)
    new_port, new_ref = _pair(lanes=3, checkpoint_path=path)
    assert new_port.replaying and new_ref.replaying
    assert new_port.warm_restart_pending == new_ref.warm_restart_pending == 4
    # A DELTA continuing a chain replays its session inline.
    enc_source = next(iter(before["sessions"]))
    _, generation, seq, *_ = before["sessions"][enc_source]
    wire = delta.encode_delta(enc_source, generation, seq + 1, [(0, 7.0)])
    assert _both(new_port, new_ref, wire)[0] == 200
    for ingest in (new_port, new_ref):
        ingest.start_replay()
        ingest._replay_thread.join(timeout=10)
    assert not new_port.replaying and not new_ref.replaying
    got, want = _state(new_port), _state(new_ref)
    assert got == want
    assert new_port.warm_restart_sessions == new_ref.warm_restart_sessions
    # The replayed sessions are the checkpointed ones, series and seqs
    # (the frame counts restart at 0; one DELTA applied since).
    for src, row in before["sessions"].items():
        gen_seq = got["sessions"][src][1:3]
        assert gen_seq == (row[1], row[2] + (src == enc_source))
    assert set(got["entries"]) == set(before["entries"])


@pytest.mark.parametrize("faultfs", ["port", "reference"])
def test_a_torn_checkpoint_write_keeps_the_previous_one(tmp_path, faultfs):
    fs_mod = port_faultfs if faultfs == "port" else ref_faultfs
    path = str(tmp_path / "ingest.json")
    port, ref = _pair(lanes=2)
    port._ckpt_path = path
    _fill(port, ref, 7)
    assert port.checkpoint(force=True)
    first = json.loads(open(path).read())
    _both(port, ref, delta.encode_full("late", 1, 1, "a 1\n"))
    with fs_mod.FaultFS() as fs:
        fs.inject(str(tmp_path), "torn", ops=("write",), times=1)
        try:
            port.checkpoint(force=True)
        except fs_mod.TornWrite:
            pass                               # the crash mid-write
    for pkg_delta, pkg_hub, pkg_wal in (
            (delta, hub, wal), (ref_delta, ref_hub, ref_wal)):
        extra = {"native": False} if pkg_delta is ref_delta else {}
        ingest = pkg_delta.DeltaIngest(
            checkpoint_path=path, build="b", **extra,
            entry_factory=lambda s, h=pkg_hub: h._TargetCache(
                "", s, pushed=True))
        assert sorted(ingest._pending_replay) == sorted(
            record[0] for record in first["sessions"])
        assert "late" not in ingest._pending_replay
