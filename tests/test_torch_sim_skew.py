"""The port's skew sim against the reference's ``tools/skew_sim.py``, and
the wire between the two packages.

Each scenario runs on both sides, the reference's scenario function
called directly (without the one retry its ``run`` gives each), the
port's over NVML daemons and its hubs. Asserted are the figures the
scenario fixes and that they equal the reference's: the versions each
publisher negotiates, no refusal and no FULL past the steady state, the
census (each side's own build named ``current``), the old build's spool
recovered record by record with the wire frame re-encoded and the garbage
counted, the energy checkpoints loaded and quarantined, the hub upgrade's
sessions, the stuck peer's refusals journaled once and named by the
doctor. The pushes made and the FULLs a session pays across the hub
upgrade depend on the host's timing and are printed.

The daemons of both sides run at their defaults (a 50 ms tick deadline,
the flight recorder on), the reference's built by its own
``_make_daemon``. A series key change is a FULL by design, and on a
loaded host the daemon changes its keys mid-scenario: a tick past the
deadline drops a family for that tick, and ``kts_slowest_tick_seconds``
takes new labels when a slower tick has another phase. The reference's
``run`` retries each scenario once for that; here its scenario functions
run once, and its checks that count every FULL (KEY_CHANGE_FULLS) are
printed, not asserted, since they cannot tell such a FULL from a
version's. The port counts the FULLs a key change forced apart
(``DeltaEncoder.key_change_fulls``) and holds the rest to the
scenario's figures. When one of those checks fires the reference prints
no summary line, and its values are the ones its other checks, which
did not fire, hold.

A fleet mid-migration mixes the packages: the reference's publisher into
the port's hub and the port's into the reference's, at wire v1 and v2,
with no refusal, one FULL per session and the served series equal to the
publisher's snapshot (uncompressed text).
"""

from __future__ import annotations

import ast
import contextlib
import io
import pathlib
import re
import sys

import pytest

import chip_smoke
from kube_gpu_stats_tpu import __version__ as REF_VERSION
from kube_gpu_stats_tpu_torch.sims import skew

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import skew_sim  # noqa: E402  (the reference's scenarios)

pytestmark = pytest.mark.chaos


def _as_the_smoke(sim: str, prefix: str, fig: dict) -> None:
    """The figures ``chip_smoke.py``'s ``sims`` phase requires of this
    scenario on the card's host are the ones the port gave here."""
    want = {key[len(prefix):]: value
            for key, value in chip_smoke.SIMS_EXACT[sim].items()
            if key.startswith(prefix)}
    assert want and {key: fig.get(key) for key in want} == want


# The reference's checks that count every FULL a publisher sent, those
# a change of its daemon's series keys forced among them (a host-speed
# effect at the daemon's defaults; ROADMAP C).
KEY_CHANGE_FULLS = (
    r"wire-matrix: \S+ publisher sent \d+ FULL\(s\) in version-relevant "
    r"steady state",
    r"prenegotiation: downgrade cost \d+ FULL\(s\) \+ 0 resync\(s\)",
    r"hub-upgrade: \S+ sent \d+ FULLs across the upgrade")


def _reference(fn, *args) -> str | None:
    """The reference's scenario once: its output, None when one of
    KEY_CHANGE_FULLS fired (and it printed no summary line)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        problems = fn(*args, verbose=True)
    print(out.getvalue())
    print("reference problems:", problems)
    assert [p for p in problems
            if not any(re.match(k, p) for k in KEY_CHANGE_FULLS)] == []
    return None if problems else out.getvalue()


def _port(fn, tmp_path):
    (tmp_path / "port").mkdir()
    result = fn(str(tmp_path / "port"))
    print(result.report(result.name))
    assert result.problems == []
    return result.figures


def _census(text: str) -> dict:
    return {("current" if version == REF_VERSION else version): count
            for version, count in ast.literal_eval(text).items()}


def test_wire_matrix_as_the_reference(tmp_path):
    out = _reference(skew_sim.scenario_wire_matrix)
    # Else the reference's census check holds it to this.
    census = {"wire-v1": 1, "current": 1} if out is None else _census(
        re.search(r"wire-matrix: census (\{.*?\}), 0 refusals, 1 FULL "
                  r"each", out).group(1))
    fig = _port(skew.scenario_wire_matrix, tmp_path)
    assert fig["census"] == census == {"wire-v1": 1, "current": 1}
    assert fig["negotiated"] == {"old": 1, "new": 2, "vs-old": 1}
    assert fig["upgrades"] == 1
    assert set(fig["refusals"].values()) == {0}
    assert set(fig["version_fulls"].values()) == {0}
    assert set(fig["hub_refusals"].values()) == {0}
    _as_the_smoke("skew", "matrix.", fig)


def test_prenegotiation_hub_as_the_reference(tmp_path):
    out = _reference(skew_sim.scenario_prenegotiation_hub)
    assert out is None or re.search(r"prenegotiation: in-push downgrade "
                                    r"after \d+ v-mixed pushes, 0 resyncs",
                                    out)
    fig = _port(skew.scenario_prenegotiation_hub, tmp_path)
    assert fig["downgraded"] and fig["negotiated"] == 1
    assert (fig["version_fulls"], fig["resyncs"]) == (0, 0)
    _as_the_smoke("skew", "prenegotiation.", fig)


def test_daemon_upgrade_as_the_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    out = _reference(skew_sim.scenario_daemon_upgrade, str(tmp_path / "ref"))
    reencoded, undecodable = map(int, re.search(
        r"daemon-upgrade: \d+ drained \((\d+) re-encoded\), (\d+) "
        r"undecodable counted", out).groups())
    fig = _port(skew.scenario_daemon_upgrade, tmp_path)
    assert (fig["reencoded"], fig["undecodable"]) \
        == (reencoded, undecodable) == (1, 1)
    assert fig["recovered"] == len(skew.old_spill_records()) == 5
    assert fig["drained"] and fig["accounting_closes"]
    assert fig["totals_kept"] and fig["pruned_loaded"]
    assert not fig["future_loaded"] and not fig["left_in_place"]
    assert fig["aside_identical"] and fig["quarantined"] == 1
    _as_the_smoke("skew", "daemon-upgrade.", fig)


def test_hub_upgrade_as_the_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    out = _reference(skew_sim.scenario_hub_upgrade, str(tmp_path / "ref"))
    if out is None:  # the reference's census check holds its 3 sessions
        sessions, census = 3, {"current": 3}
    else:
        found = re.search(r"hub-upgrade: (\d+) sessions warm across the "
                          r"upgrade, 0 resyncs, census (\{.*?\})", out)
        sessions, census = int(found.group(1)), _census(found.group(2))
    fig = _port(skew.scenario_hub_upgrade, tmp_path)
    assert fig["sessions"] == sessions == 3
    assert fig["census"] == census == {"current": 3}
    assert fig["old_window"] and fig["negotiated_up"]
    assert fig["census_flipped"]
    assert (fig["resyncs"], fig["over_one_full"]) == (0, 0)
    _as_the_smoke("skew", "hub-upgrade.", fig)


def test_stuck_skew_and_doctor_as_the_reference(tmp_path):
    out = _reference(skew_sim.scenario_stuck_skew_and_doctor)
    events, peer = re.search(r"stuck-skew: \d+ refusals counted, (\d+) "
                             r"journal event, doctor names (\S+)",
                             out).groups()
    fig = _port(skew.scenario_stuck_skew_and_doctor, tmp_path)
    assert fig["journal_events"] == int(events) == 1
    assert peer == "http://node-stuck:9400/metrics"
    assert fig["publisher_counted"] and fig["hub_counted"]
    assert fig["pushes"] == 0 and fig["peer_named"]
    assert fig["doctor"] == "warn" and fig["doctor_names_peer"]
    _as_the_smoke("skew", "stuck-skew.", fig)


# -- the wire across the packages ---------------------------------------------

def _package(name: str):
    if name == "port":
        from kube_gpu_stats_tpu_torch import delta, exposition, hub, registry
        from kube_gpu_stats_tpu_torch import schema
    else:
        from kube_gpu_stats_tpu import delta, exposition, hub, registry
        from kube_gpu_stats_tpu import schema
    return delta, exposition, hub, registry, schema


def _publish(registry_mod, schema, registry, value: float) -> None:
    labels = (("accel_type", "h100"), ("chip", "0"),
              ("device_path", "/dev/nvidia0"),
              ("uuid", "GPU-00000000-0000-0000-0000-000000000000"))
    builder = registry_mod.SnapshotBuilder()
    builder.add(schema.DEVICE_UP, 1.0, labels)
    builder.add(schema.DUTY_CYCLE, value, labels)
    builder.add(schema.POWER, 100.0 + value, labels)
    builder.add(schema.MEMORY_USED, 1.0e9 * value, labels)
    registry.publish(builder.build())


def _data_lines(text: str) -> list[str]:
    return sorted(line for line in text.splitlines()
                  if line.startswith("accelerator_"))


@pytest.mark.parametrize("proto", [1, 2])
@pytest.mark.parametrize("publisher_side,hub_side",
                         [("reference", "port"), ("port", "reference")])
def test_a_publisher_of_one_package_feeds_a_hub_of_the_other(
        publisher_side, hub_side, proto):
    pub_delta, _, _, pub_registry, pub_schema = _package(publisher_side)
    _, hub_exposition, hub_mod, _, _ = _package(hub_side)
    hub = hub_mod.Hub([], targets_provider=lambda: [], interval=10.0,
                      push_fence=1e9)
    server = hub_exposition.MetricsServer(
        hub.registry, host="127.0.0.1", port=0,
        ingest_provider=hub.delta.handle)
    server.start()
    registry = pub_registry.Registry()
    publisher = pub_delta.DeltaPublisher(
        registry, f"http://127.0.0.1:{server.port}",
        source="http://node-mixed:9400/metrics", timeout=5.0,
        proto_max=proto)
    try:
        for step in range(6):
            _publish(pub_registry, pub_schema, registry, 10.0 + step)
            publisher.push_once()
            hub.refresh_once()
            assert _data_lines(hub.registry.snapshot().render()) == \
                _data_lines(registry.snapshot().render())
        assert publisher.pushes_total == 6
        assert publisher.negotiated_proto == proto
        assert (publisher.skew_refused_total, publisher.resyncs_total,
                publisher.proto_downgrades_total) == (0, 0, 0)
        assert publisher._encoder.full_frames == 1
        ingest = hub.delta
        assert (ingest.full_frames_total, ingest.delta_frames_total) == (1, 5)
        assert (ingest.skew_refused_total, ingest.resyncs_total) == (0, 0)
        census = ingest.fleet_versions()
        assert sum(census.values()) == 1
        if proto == 1:
            assert census == {"wire-v1": 1}
    finally:
        publisher.stop()
        server.stop()
        hub.stop()
