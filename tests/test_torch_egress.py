"""Push egress of the port's daemon against the reference's.

- The Pushgateway pusher: for the same registry, the same PUT target and
  body as the reference's.
- The poll fold: both poll loops, given the same stand-in sender
  counters and egress status, serve the same ``collector_push_*``,
  ``kts_spill_*`` and ``kts_remote_write_*`` text.
- The daemon: ``/debug/egress`` and ``/debug/skew`` of the port's daemon
  over ``testing.fake_nvml`` equal the reference daemon's (mock backend)
  for the same sender config, with and without senders (build string,
  times and ages excepted); a daemon with every sender on ships into one
  ``testing.egress_sink`` whose delta state, remote-write samples and
  Pushgateway bodies equal what it serves, and flushes on stop.
- The flags: every push-egress flag parses to the reference's ``Config``
  values and is refused by the same checks; ``--max-concurrent-scrapes``
  reaches the server.
- The doctor: ``check_egress``, ``skew_verdict``/``check_skew`` and
  ``check_remote_write`` give the reference's status and text on the
  same canned payloads and stand-in receivers; ``--egress`` and
  ``--skew`` run their rows.
"""

from __future__ import annotations

import hashlib
import http.server
import json
import socket
import threading
import time
import urllib.request

import pytest

from kube_gpu_stats_tpu import config as ref_config
from kube_gpu_stats_tpu import doctor as ref_doctor
from kube_gpu_stats_tpu.collectors.mock import MockCollector as RefMock
from kube_gpu_stats_tpu.daemon import Daemon as RefDaemon
from kube_gpu_stats_tpu.exposition import MetricsServer as RefMetricsServer
from kube_gpu_stats_tpu.exposition import \
    PushgatewayPusher as RefPushgatewayPusher
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu_torch import config, daemon, doctor, remote_write
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.exposition import (MetricsServer,
                                                 PushgatewayPusher)
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry
from kube_gpu_stats_tpu_torch.testing.egress_sink import EgressSink
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml
from kube_gpu_stats_tpu_torch.validate import parse_exposition_interned

EGRESS_PREFIXES = ("collector_push_", "kts_spill_", "kts_remote_write_",
                   "kts_delta_shed")


def _row(result) -> tuple:
    return (result.name, result.status, result.detail,
            json.loads(json.dumps(result.data, sort_keys=True)))


def _loops():
    return ((RefPollLoop, RefRegistry(native=False), RefMock(2)),
            (PollLoop, Registry(), MockCollector(2)))


# -- the Pushgateway pusher ---------------------------------------------------

def _same_snapshot(registry, builder_cls, schema_mod) -> None:
    builder = builder_cls()
    for chip in range(3):
        labels = (("accel_type", "h100"), ("chip", str(chip)),
                  ("device_path", f"/dev/nvidia{chip}"),
                  ("uuid", f"GPU-{chip}"))
        builder.add(schema_mod.DEVICE_UP, 1.0, labels)
        builder.add(schema_mod.DUTY_CYCLE, 12.5 * chip, labels)
        builder.add(schema_mod.POWER, 300.25 + chip, labels)
    registry.publish(builder.build())


@pytest.mark.parametrize("job,instance", [("kube-tpu-stats", "node-1"),
                                          ("a/b c", "host:9400")])
def test_pushgateway_target_and_body_equal_the_references(job, instance):
    from kube_gpu_stats_tpu import schema as ref_schema
    from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
    from kube_gpu_stats_tpu_torch import schema
    from kube_gpu_stats_tpu_torch.registry import SnapshotBuilder

    sink = EgressSink().start()
    try:
        for pusher_cls, registry, builder_cls, schema_mod in (
                (RefPushgatewayPusher, RefRegistry(native=False), RefBuilder,
                 ref_schema),
                (PushgatewayPusher, Registry(), SnapshotBuilder, schema)):
            _same_snapshot(registry, builder_cls, schema_mod)
            pusher = pusher_cls(registry, sink.url + "/", job=job,
                                instance=instance)
            pusher.push_once()
            assert (pusher.pushes_total, pusher.failures_total) == (1, 0)
            assert sink.pushes()[-1][1] == registry.rendered()[0]
        (ref_path, ref_body), (path, body) = sink.pushes()
        assert (path, body) == (ref_path, ref_body)
        assert path.startswith("/metrics/job/")
    finally:
        sink.stop()


def test_a_pushgateway_failure_counts_as_the_references():
    for pusher_cls, registry in ((PushgatewayPusher, Registry()),
                                 (RefPushgatewayPusher, RefRegistry())):
        pusher = pusher_cls(registry, "http://127.0.0.1:9", instance="n")
        pusher.push_once()
        pusher.push_once()
        assert (pusher.pushes_total, pusher.failures_total,
                pusher.consecutive_failures) == (0, 2, 2)


# -- the poll fold -----------------------------------------------------------------

PUSH_STATS = {
    "pushgateway": {"pushes": 3, "failures": 1, "dropped": 0},
    "remote_write": {"pushes": 10, "failures": 4, "dropped": 2},
    "delta": {"pushes": 40, "failures": 2, "dropped": 0, "shed_honored": 5,
              "skew_refused": 7},
}
EGRESS_STATS = {
    "spill": {"spooled_total": 12, "drained_total": 9, "reencoded_total": 1,
              "undecodable_total": 2, "dropped_total": 1, "depth_frames": 3,
              "bytes": 4096, "oldest_age_seconds": 1.5},
    "remote_write": {"durable": True, "protocol": "2.0", "url": "u",
                     "shards": [{"shard": 0, "wal_bytes": 10,
                                 "lag_seconds": 0.25, "parked_total": 1,
                                 "dropped_total": 0},
                                {"shard": 1, "wal_bytes": 0,
                                 "lag_seconds": 0.0, "parked_total": 0,
                                 "dropped_total": 3}]},
}


@pytest.mark.parametrize("push,egress", [
    (PUSH_STATS, EGRESS_STATS), ({}, {}),
    ({"delta": PUSH_STATS["delta"]}, {"spill": EGRESS_STATS["spill"]}),
    (PUSH_STATS, {"remote_write": EGRESS_STATS["remote_write"]})])
def test_both_poll_loops_fold_the_same_egress_text(push, egress):
    texts = []
    for loop_cls, registry, mock in _loops():
        loop = loop_cls(mock, registry, interval=1.0, deadline=30.0,
                        version="test", push_stats=lambda: push,
                        egress_stats=lambda: egress)
        try:
            loop.tick()
            text = registry.rendered()[0].decode()
            texts.append([line for line in text.splitlines()
                          if line.split("{")[0].split(" ")[0]
                          .startswith(EGRESS_PREFIXES)
                          or line.startswith(("# HELP", "# TYPE"))
                          and line.split()[2].startswith(EGRESS_PREFIXES)])
        finally:
            loop.stop()
    assert texts[1] == texts[0]
    assert bool(texts[1]) == bool(push or egress)
    # The copied reference flaw: the daemon's skew_refused count rides
    # the push stats, but no family carries it on a node's exposition.
    assert not any("skew_refused" in line for line in texts[1])


# -- the daemon ----------------------------------------------------------------

def _sender_args(url: str, tmp_path, side: str) -> dict:
    return dict(hub_url=url, hub_spill_dir=str(tmp_path / side / "spill"),
                remote_write_url=url + "/api/v1/write",
                remote_write_protocol="2.0",
                remote_write_wal_dir=str(tmp_path / side / "rw"),
                remote_write_shards=2, pushgateway_url=url,
                hub_push_source="http://node:9400/metrics")


def _nvml_daemon(monkeypatch, **fields) -> daemon.Daemon:
    fake = FakeNvml([FakeDevice("GPU-0", 0, power_mw=250_000)])
    monkeypatch.setattr(daemon, "_nvml_collector",
                        lambda: NvmlCollector(fake))
    cfg = config.Config(backend="nvml", interval=0.05,
                        listen_host="127.0.0.1", listen_port=0,
                        attribution="off", device_processes="off",
                        **fields)
    return daemon.Daemon(cfg)


def _ref_daemon(**fields) -> RefDaemon:
    return RefDaemon(ref_config.Config(
        backend="mock", mock_devices=1, interval=0.05,
        listen_host="127.0.0.1", listen_port=0, attribution="off",
        device_processes="off", **fields))


VARYING = {"oldest_age_seconds", "lag_seconds", "retry_in_seconds",
           "build"}


def _steady(payload):
    """A payload with its build string and its clock-read fields
    blanked: everything else must be equal."""
    if isinstance(payload, dict):
        return {k: (None if k in VARYING else _steady(v))
                for k, v in payload.items()}
    if isinstance(payload, list):
        return [_steady(v) for v in payload]
    return payload


def _close(*daemons) -> None:
    for instance in daemons:
        instance.start()  # stop() on a never-started server hangs
        instance.stop()


@pytest.mark.parametrize("senders", [False, True])
def test_debug_egress_and_skew_equal_the_reference_daemons(
        monkeypatch, tmp_path, senders):
    fields = {}
    ref_fields = {}
    if senders:
        fields = _sender_args("http://127.0.0.1:9", tmp_path, "port")
        ref_fields = _sender_args("http://127.0.0.1:9", tmp_path, "ref")
    d = _nvml_daemon(monkeypatch, **fields)
    ref = _ref_daemon(**ref_fields)
    try:
        egress, ref_egress = d._egress_payload(), ref._egress_payload()
        if senders:
            for payload in (egress, ref_egress):
                for shard in payload["remote_write"]["shards"]:
                    shard.pop("health")
            # The port's one addition: the delta sender's count of
            # snapshots it never took in.
            assert egress["senders"]["delta"].pop("skipped_total") == 0
        assert _steady(egress) == _steady(ref_egress)
        assert egress["enabled"] is senders
        skew, ref_skew = d._skew_payload(), ref._skew_payload()
        assert _steady(skew) == _steady(ref_skew)
        assert skew["build"] == "0.1.0"
        assert (skew["publisher"] is None) is not senders
        assert sorted(d._push_stats()) == sorted(ref._push_stats())
    finally:
        _close(d, ref)


def test_the_daemon_serves_egress_and_skew_without_senders(monkeypatch):
    d = _nvml_daemon(monkeypatch)
    d.start()
    try:
        base = f"http://127.0.0.1:{d.server.port}"
        egress = json.loads(urllib.request.urlopen(
            base + "/debug/egress", timeout=5).read())
        assert egress == {"enabled": False, "senders": {}}
        skew = json.loads(urllib.request.urlopen(
            base + "/debug/skew", timeout=5).read())
        assert skew["role"] == "daemon" and skew["publisher"] is None
        index = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b'href="/debug/egress"' in index
        assert b'href="/debug/skew"' in index
    finally:
        d.stop()


def _wait(predicate, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def test_a_daemon_with_every_sender_ships_what_it_serves(monkeypatch,
                                                         tmp_path):
    sink = EgressSink().start()
    fields = _sender_args(sink.url, tmp_path, "port")
    fields.update(remote_write_interval=0.2, hub_push_interval=0.02)
    d = _nvml_daemon(monkeypatch, **fields)
    d.start()
    try:
        assert _wait(lambda: len(sink.applied()) >= 10
                     and len(sink.writes()) >= 4 and sink.pushes())
        status = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{d.server.port}/debug/egress",
            timeout=5).read())
        assert status["enabled"] and set(status["senders"]) == {
            "delta", "remote_write", "pushgateway"}
        assert all(s["failures_total"] == 0
                   for s in status["senders"].values())
    finally:
        d.stop()
        sink.stop()
    # Every tick between the first and last the sink applied arrived,
    # or is among the snapshots the publisher counted as skipped.
    ticks = sorted({int(sum(v for n, _, v in a.series
                            if n == "collector_poll_duration_seconds_count"))
                    for a in sink.applied()})
    missing = set(range(ticks[0], ticks[-1] + 1)) - set(ticks)
    assert len(missing) <= d.delta_pusher.skipped_total
    # The final flush ran in stop(): the sink holds the last snapshot.
    final = d.registry.rendered()[0]
    assert sink.sessions()["http://node:9400/metrics"] == \
        parse_exposition_interned(final.decode())
    assert sink.pushes()[-1][1] == final
    last = d.registry.snapshot()
    stamps = {ts for w in sink.writes() for _, samples, _ in w.series
              for _, ts in samples}
    assert int(last.timestamp * 1000) in stamps
    # Every sample of the last write equals the snapshot's value.
    want = {}
    for _spec, name, labels, value, _ts in remote_write._snapshot_series(
            last, "kube-tpu-stats", socket.gethostname()):
        want[(name, tuple(sorted((k, v) for k, v in labels if v)))] = value
    got = {}
    for w in sink.writes():
        for labels, samples, _ in w.series:
            for value, ts in samples:
                if ts == int(last.timestamp * 1000):
                    key = (labels.pop("__name__"),
                           tuple(sorted(labels.items())))
                    got[key] = value
    assert got == want
    assert {w.protocol for w in sink.writes()} == {"2.0"}


def test_the_daemon_path_wires_max_concurrent_scrapes(monkeypatch):
    d = _nvml_daemon(monkeypatch, max_concurrent_scrapes=0)
    try:
        assert d.server._scrape_slots is None
    finally:
        _close(d)
    d = _nvml_daemon(monkeypatch, max_concurrent_scrapes=3)
    try:
        slots = d.server._scrape_slots
        assert [slots.acquire(blocking=False) for _ in range(4)] == \
            [True, True, True, False]
    finally:
        _close(d)


# -- the flags -------------------------------------------------------------------

FIELDS = ("pushgateway_url", "pushgateway_job", "remote_write_url",
          "remote_write_job", "remote_write_interval",
          "remote_write_bearer_token_file", "remote_write_protocol",
          "remote_write_extra_labels", "remote_write_shards",
          "remote_write_wal_dir", "remote_write_wal_max_bytes",
          "remote_write_drain_max", "max_concurrent_scrapes", "hub_url",
          "hub_push_source", "hub_push_interval", "hub_auth_username",
          "hub_auth_password_file", "hub_ca_file", "hub_insecure_tls",
          "hub_spill_dir", "hub_spill_max_bytes", "hub_drain_rate",
          "hub_proto_max")


@pytest.mark.parametrize("argv", [
    [],
    ["--pushgateway-url", "http://gw:9091", "--pushgateway-job", "j"],
    ["--remote-write-url", "http://rw/api/v1/write", "--remote-write-job",
     "j", "--remote-write-interval", "2.5", "--remote-write-protocol", "2.0",
     "--remote-write-bearer-token-file", "/t",
     "--remote-write-extra-labels", "cluster=prod, region=eu"],
    ["--remote-write-url", "http://rw", "--remote-write-wal-dir", "/w",
     "--remote-write-shards", "8", "--remote-write-wal-max-bytes", "65536",
     "--remote-write-drain-max", "3"],
    ["--hub-url", "http://hub:9401", "--hub-push-source", "s",
     "--hub-push-interval", "0.5", "--hub-auth-username", "u",
     "--hub-auth-password-file", "/p", "--hub-ca-file", "/ca"],
    ["--hub-url", "https://hub", "--hub-insecure-tls", "--hub-spill-dir",
     "/s", "--hub-spill-max-bytes", "70000", "--hub-drain-rate", "7",
     "--hub-proto-max", "1"],
    ["--max-concurrent-scrapes", "0"],
])
def test_push_flags_parse_as_the_reference(argv):
    port_cfg, ref_cfg = config.from_args(argv), ref_config.from_args(argv)
    for field in FIELDS:
        assert getattr(port_cfg, field) == getattr(ref_cfg, field), field


def test_push_flags_read_the_reference_environment(monkeypatch):
    env = {"KTS_HUB_URL": "http://h", "KTS_HUB_SPILL_DIR": "/s",
           "KTS_HUB_DRAIN_RATE": "9", "KTS_HUB_INSECURE_TLS": "1",
           "KTS_REMOTE_WRITE_URL": "http://r", "KTS_REMOTE_WRITE_SHARDS": "4",
           "KTS_REMOTE_WRITE_WAL_DIR": "/w",
           "KTS_REMOTE_WRITE_PROTOCOL": "2.0",
           "KTS_PUSHGATEWAY_URL": "http://g", "KTS_PUSHGATEWAY_JOB": "jj",
           "KTS_MAX_CONCURRENT_SCRAPES": "5", "KTS_HUB_PROTO_MAX": "1"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port_cfg, ref_cfg = config.from_args([]), ref_config.from_args([])
    for field in FIELDS:
        assert getattr(port_cfg, field) == getattr(ref_cfg, field), field
    assert port_cfg.remote_write_shards == 4 and port_cfg.hub_insecure_tls


@pytest.mark.parametrize("argv,env", [
    (["--remote-write-interval", "0"], {}),
    (["--remote-write-shards", "0"], {}),
    (["--remote-write-shards", "65", "--remote-write-wal-dir", "/w"], {}),
    (["--remote-write-shards", "2"], {}),
    (["--remote-write-wal-max-bytes", "1024"], {}),
    (["--remote-write-drain-max", "0"], {}),
    (["--remote-write-protocol", "3.0"], {}),
    ([], {"KTS_REMOTE_WRITE_PROTOCOL": "1.1"}),
    (["--remote-write-extra-labels", "job=x"], {}),
    (["--remote-write-extra-labels", "chip=0"], {}),
    (["--remote-write-extra-labels", "a"], {}),
    (["--remote-write-extra-labels", "a="], {}),
    (["--remote-write-extra-labels", "1a=b"], {}),
    (["--remote-write-extra-labels", "a=b,a=c"], {}),
    (["--max-concurrent-scrapes", "-1"], {}),
    (["--hub-auth-username", "u"], {}),
    (["--hub-auth-password-file", "/p"], {}),
    (["--hub-ca-file", "/ca", "--hub-insecure-tls"], {}),
    (["--hub-push-interval", "0"], {}),
    (["--hub-spill-max-bytes", "1000"], {}),
    (["--hub-drain-rate", "0"], {}),
    (["--hub-proto-max", "-1"], {}),
])
def test_bad_push_flags_fail_as_the_reference(argv, env, monkeypatch,
                                              capsys):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    errors = []
    for module in (ref_config, config):
        with pytest.raises(SystemExit) as info:
            module.from_args(argv)
        assert info.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1]
                      .split("error: ", 1)[1])
    assert errors[0] == errors[1]


# -- the doctor -------------------------------------------------------------------

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


_SHARD = {"shard": 0, "wal_bytes": 0, "lag_seconds": 0.3, "parked_total": 0,
          "dropped_total": 0, "consecutive_failures": 0}
_SPILL = {"depth_frames": 0, "bytes": 0, "max_bytes": 1000,
          "oldest_age_seconds": 0.0, "dropped_total": 0,
          "undecodable_total": 0, "reencoded_total": 0,
          "skew_segments_total": 0, "link_failures": 0}
_SENDERS = {"delta": {"consecutive_failures": 0},
            "remote_write": {"consecutive_failures": 0},
            "pushgateway": {"consecutive_failures": 0}}

EGRESS_PAYLOADS = {
    "disabled": {"enabled": False, "senders": {}},
    "healthy": {"enabled": True, "spill": _SPILL,
                "remote_write": {"shards": [_SHARD, _SHARD | {"shard": 1}]},
                "senders": _SENDERS},
    "blackout": {"enabled": True,
                 "spill": _SPILL | {"depth_frames": 40, "bytes": 900,
                                    "oldest_age_seconds": 4.0,
                                    "link_failures": 3},
                 "remote_write": {"shards": [_SHARD | {
                     "wal_bytes": 5000, "lag_seconds": 4.2,
                     "consecutive_failures": 2}]},
                 "senders": _SENDERS | {"pushgateway": {
                     "consecutive_failures": 4}}},
    "lossy": {"enabled": True,
              "spill": _SPILL | {"dropped_total": 5, "undecodable_total": 2,
                                 "reencoded_total": 1,
                                 "skew_segments_total": 1},
              "remote_write": {"shards": [_SHARD | {"parked_total": 2,
                                                    "dropped_total": 3}]},
              "senders": {}},
    "no-durability-keys": {"senders": {}},
}


@pytest.mark.parametrize("case", sorted(EGRESS_PAYLOADS))
def test_egress_rows_equal_the_references(serve, case):
    base = serve(egress_provider=lambda: EGRESS_PAYLOADS[case])
    got = doctor.check_egress(base)
    assert _row(got) == _row(ref_doctor.check_egress(base))
    assert got.status == ("ok" if case in ("healthy", "no-durability-keys")
                          else "warn")


def test_egress_row_without_the_endpoint_or_daemon_equals_the_reference(
        serve):
    for base in (serve(), "http://127.0.0.1:9"):
        got = doctor.check_egress(base)
        assert _row(got) == _row(ref_doctor.check_egress(base))
    auth = serve(egress_provider=lambda: EGRESS_PAYLOADS["healthy"],
                 auth_username="ops",
                 auth_password_sha256=hashlib.sha256(b"pw").hexdigest())
    got = doctor.check_egress(auth)
    assert _row(got) == _row(ref_doctor.check_egress(auth))
    assert got.status == "warn" and "HTTP 401" in got.detail


_PUBLISHER = {"source": "s", "build": "0.1.0", "proto_min": 1,
              "proto_max": 2, "negotiated_proto": 2, "negotiated_caps": 1,
              "hub": {"proto_min": 1, "proto_max": 2, "caps": 1,
                      "build": "egress-sink"},
              "skew_refused_total": 0, "proto_upgrades_total": 1,
              "proto_downgrades_total": 0}

SKEW_PAYLOADS = {
    "daemon-alone": {"role": "daemon", "build": "0.1.0", "proto_min": 1,
                     "proto_max": 2, "publisher": None,
                     "wal_quarantined": {}},
    "negotiated": {"role": "daemon", "build": "0.1.0", "proto_min": 1,
                   "proto_max": 2, "publisher": _PUBLISHER,
                   "wal_quarantined": {}},
    "no-hello": {"role": "daemon", "build": "0.1.0", "proto_min": 1,
                 "proto_max": 2, "publisher": _PUBLISHER | {
                     "hub": None, "negotiated_proto": 1}},
    "refused": {"role": "daemon", "build": "0.1.0", "proto_min": 1,
                "proto_max": 2, "publisher": _PUBLISHER | {
                    "hub": {"proto_min": 3, "proto_max": 3, "caps": 1,
                            "build": ""}, "negotiated_proto": 1,
                    "skew_refused_total": 4},
                "wal_quarantined": {}},
    "downgraded": {"role": "daemon", "build": "0.1.0", "proto_min": 1,
                   "proto_max": 2, "publisher": _PUBLISHER | {
                       "negotiated_proto": 1, "proto_downgrades_total": 1,
                       "skew_refused_total": 1}},
    "quarantined": {"role": "daemon", "build": "0.1.0", "proto_min": 1,
                    "proto_max": 2, "publisher": None,
                    "wal_quarantined": {"energy": 1, "spill": 2}},
    "hub-census": {"role": "hub", "build": "0.5.0", "proto_min": 1,
                   "proto_max": 2, "ingest": {
                       "fleet_versions": {"0.1.0": 3, "0.5.0": 1},
                       "refused_peers": {"10.0.0.9": {"version": 3,
                                                      "count": 2}},
                       "skew_refused_total": 2, "proto_min": 1,
                       "proto_max": 2,
                       "downgraded_sessions": [
                           {"source": "n1", "proto": 1, "build": "0.1.0"},
                           {"source": "n2", "proto": 1}],
                       "downgraded_sessions_truncated": 4},
                   "publisher": None, "wal_quarantined": {}},
    "hub-uniform": {"role": "hub", "build": "0.5.0", "proto_min": 1,
                    "proto_max": 2, "ingest": {
                        "fleet_versions": {"0.5.0": 8}, "refused_peers": {},
                        "skew_refused_total": 0}},
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(SKEW_PAYLOADS))
def test_skew_verdicts_equal_the_references(case):
    payload = SKEW_PAYLOADS[case]
    assert doctor.skew_verdict(payload) == ref_doctor.skew_verdict(payload)


@pytest.mark.parametrize("case", sorted(SKEW_PAYLOADS))
def test_skew_rows_equal_the_references(serve, case):
    base = serve(skew_provider=lambda: SKEW_PAYLOADS[case])
    got = doctor.check_skew(base)
    assert _row(got) == _row(ref_doctor.check_skew(base))
    assert got.status == ("ok" if case in ("daemon-alone", "negotiated",
                                           "no-hello", "hub-uniform",
                                           "empty") else "warn")


def test_skew_row_without_the_endpoint_or_daemon_equals_the_reference(serve):
    for base in (serve(), "http://127.0.0.1:9"):
        got = doctor.check_skew(base)
        assert _row(got) == _row(ref_doctor.check_skew(base))
        assert got.status in ("warn", "fail")


class WriteReceiver:
    """Answers every POST with one status, or hangs up."""

    def __init__(self, status: int) -> None:
        receiver = self
        self.status = status

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - http.server's name
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                self.send_response(receiver.status)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = (f"http://127.0.0.1:{self.httpd.server_address[1]}"
                    "/api/v1/write")
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("status,verdict", [(204, "ok"), (400, "ok"),
                                            (401, "fail"), (403, "fail"),
                                            (404, "fail"), (429, "warn"),
                                            (503, "warn")])
@pytest.mark.parametrize("protocol", ["1.0", "2.0"])
def test_remote_write_rows_equal_the_references(status, verdict, protocol):
    receiver = WriteReceiver(status)
    try:
        cfg = config.Config(remote_write_url=receiver.url,
                            remote_write_protocol=protocol)
        ref_cfg = ref_config.Config(remote_write_url=receiver.url,
                                    remote_write_protocol=protocol)
        got = doctor.check_remote_write(cfg)
        assert _row(got) == _row(ref_doctor.check_remote_write(ref_cfg))
        assert got.status == verdict
    finally:
        receiver.close()


@pytest.mark.parametrize("url,token", [
    ("http://127.0.0.1:9/api/v1/write", ""),     # unreachable: warn
    ("127.0.0.1:9/api/v1/write", ""),            # no scheme: fail
    ("foo://127.0.0.1/api/v1/write", ""),        # unknown scheme: fail
    ("http://127.0.0.1:9/api/v1/write", "/nonexistent/token"),
])
def test_remote_write_row_failures_equal_the_references(url, token):
    got = doctor.check_remote_write(config.Config(
        remote_write_url=url, remote_write_bearer_token_file=token))
    want = ref_doctor.check_remote_write(ref_config.Config(
        remote_write_url=url, remote_write_bearer_token_file=token))
    assert _row(got) == _row(want)


def test_the_remote_write_row_against_the_sink():
    sink = EgressSink().start()
    try:
        got = doctor.check_remote_write(config.Config(
            remote_write_url=sink.url + "/api/v1/write",
            remote_write_protocol="2.0"))
        assert got.status == "ok" and "accepts writes" in got.detail
        assert [w.series for w in sink.writes()] == [[]]
        assert sink.writes()[0].protocol == "2.0"
    finally:
        sink.stop()


def test_doctor_egress_and_skew_run_their_rows(monkeypatch, capsys,
                                               tmp_path):
    assert not hasattr(doctor, "NOT_PORTED_FLAGS")
    d = _nvml_daemon(monkeypatch)
    d.start()
    try:
        rc = doctor.main(["--backend", "mock", "--json", "--egress", "--skew",
                          "--url",
                          f"http://127.0.0.1:{d.server.port}/metrics"])
    finally:
        d.stop()
    payload = json.loads(capsys.readouterr().out)
    rows = {row["name"]: row for row in payload["checks"]}
    assert rc == 0
    assert rows["egress"]["status"] == "warn"     # nothing durable
    assert "no egress durability configured" in rows["egress"]["detail"]
    assert rows["skew"]["status"] == "ok"
    assert "build 0.1.0 speaks wire v1..v2" in rows["skew"]["detail"]
    # With no daemon listening the rows fail (exit 1), never exit 2.
    assert doctor.main(["--backend", "mock", "--json", "--egress",
                        "--listen-port", "9"]) == 1
    capsys.readouterr()
