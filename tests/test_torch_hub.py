"""The port's hub against the reference's on the same targets.

The port's ``Hub`` and the reference's ``Hub(history=None,
native_ingest=False)`` (the native store the port leaves off, in its off
state; the fleet lens and the efficiency lens on in both, at their
defaults) get the same targets: ``.prom`` files, HTTP targets served by
a small server, and push sessions whose frames reach both hubs' ingests
(from the port's and the reference's ``DeltaPublisher`` over HTTP,
through a receiver that hands each frame to both). The monotonic clock
is pinned and stepped between refreshes, so every rate has the same
denominator in both, and the wall clock with it, so the lens's SLO
windows hold the same instants. After each
``refresh_once`` the rendered, uncompressed ``/metrics`` text is equal,
except for the families that time the hub itself (``TIMED``) and the
hub's own process readings (``PROCESS``), named below; the build label
of ``kts_build_info`` carries each package's version and is compared
with the version swapped.

Cases: first-wins duplicate dedup; a target down then up, with the
histogram cache holding cumulative counts; push-fresh against
fence-expired, falling back to pull; ``--rollups-only``; ``--federate``
over two leaf hubs; ``--expect-workers``; file-target churn; series
budget and hard-cap sheds; idle eviction above the watermark; skew
refusals counted; a warm restart from the ingest checkpoint; the
history ring fed by both hubs (each with its package's
``HistoryStore``, the wall clock pinned too), its ``/query`` answers for
every family, window and a spread of ``at=`` times, its cap and its
disabled form; the same hubs with both lenses off (no ``kts_fleet_*``);
and a lens scenario (a card gone idle in its pod, a straggler, a
silent node, churn) that holds ``/debug/fleet``, ``/debug/efficiency``
(up to ``generated_at``, over an injected energy fetcher), the ring's
link and waste rows and the lens's eviction equal too; and four workers
of a 4x1 torus whose shared link is accused and cleared alike, through
both rings (the 1.0 row, then its 0.0 tombstone) and both packages'
servers.

Exact throughout: the rollups are sums, means, mins and maxes over the
same floats in the same order, formatted by the same ``format_value``.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time

import numpy as np
import pytest

from kube_gpu_stats_tpu import __version__ as REF_VERSION
from kube_gpu_stats_tpu import delta as ref_delta
from kube_gpu_stats_tpu import hub as ref_hub
from kube_gpu_stats_tpu import wal as ref_wal
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu_torch import __version__ as PORT_VERSION
from kube_gpu_stats_tpu_torch import delta, hub, wal
from kube_gpu_stats_tpu_torch.registry import Registry

# The hub's own wall times, which differ between any two runs.
TIMED = frozenset({
    "hub_refresh_duration_seconds", "kts_hub_parse_seconds",
    "slice_target_fetch_seconds", "kts_ingest_lane_apply_seconds_total",
    "kts_render_prewarm_wait_seconds_total", "kts_tick_phase_seconds",
    "kts_slowest_tick_seconds", "kts_hub_warm_restart_replay_seconds",
    "kts_hub_warm_restart_checkpoint_age_seconds",
})
# The hub process's own readings (procstats).
PROCESS = frozenset({
    "process_cpu_seconds_total", "process_start_time_seconds",
    "process_virtual_memory_bytes", "process_resident_memory_bytes",
    "process_open_fds", "process_max_fds",
})
EXCLUDED = TIMED | PROCESS


def _family(line: str) -> str:
    if line.startswith("#"):
        return line.split()[2]
    name = line.split("{", 1)[0].split(" ", 1)[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[:-len(suffix)] in EXCLUDED:
            return name[:-len(suffix)]
    return name


# Families whose series order among equal values follows the order in
# which pool threads installed the targets' parses — a race in either
# package from run to run — so their lines compare as a set.
TIE_ORDERED = frozenset({"kts_source_series"})


def _comparable(text: str, port: bool) -> list[str]:
    lines = [line for line in text.splitlines()
             if _family(line) not in EXCLUDED]
    tied = sorted(line for line in lines
                  if _family(line) in TIE_ORDERED
                  and not line.startswith("#"))
    lines = [line for line in lines
             if _family(line) not in TIE_ORDERED
             or line.startswith("#")] + tied
    if port:
        lines = [line.replace(f'version="{PORT_VERSION}"',
                              f'version="{REF_VERSION}"')
                 if line.startswith("kts_build_info") else line
                 for line in lines]
    return lines


class Clock:
    """time.monotonic pinned between steps: every call inside one
    refresh reads the same instant, so fetch stamps, push stamps and
    rate denominators are equal in both hubs. time.time follows it at
    a fixed offset (the fleet lens stamps each refresh with it)."""

    def __init__(self) -> None:
        self.now = 5000.0

    def __call__(self) -> float:
        return self.now


@pytest.fixture(autouse=True)
def fresh_store_registries():
    """Each package keeps one process-wide registry of the disk stores
    any code in the process opened (the hub exports it as kts_store_*):
    start both empty, so the two hubs export only their own."""
    for module in (wal, ref_wal):
        module.reset_store_stats()
        module.reset_quarantine_stats()
    yield


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "monotonic", c)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0 + c.now)
    return c


def _hubs(targets, **kwargs):
    port = hub.Hub(list(targets), **kwargs)
    ref = ref_hub.Hub(list(targets), history=None, native_ingest=False,
                      **kwargs)
    return port, ref


def _refresh(port, ref) -> str:
    got = port.refresh_once()
    want = ref.refresh_once()
    assert got.errors == want.errors
    port_text = port.registry.snapshot().render()
    ref_text = ref.registry.snapshot().render()
    assert _comparable(port_text, True) == _comparable(ref_text, False)
    return port_text


def _stop(*hubs) -> None:
    for h in hubs:
        h.stop()


def _node(rng, worker: str, cards: int, step: int, slice_="h100-a",
          chip_offset: int = 0, hist: bool = False) -> str:
    lines = []
    for card in range(cards):
        chip = card + chip_offset
        base = (f'accel_type="h100",chip="{chip}",slice="{slice_}",'
                f'worker="{worker}"')
        lines += [
            f"accelerator_up{{{base}}} 1",
            f"accelerator_duty_cycle{{{base}}} "
            f"{float(rng.integers(0, 101))}",
            f"accelerator_memory_used_bytes{{{base}}} "
            f"{float(rng.integers(1, 80)) * 2**30}",
            f"accelerator_memory_total_bytes{{{base}}} {80 * 2**30}",
            f"accelerator_power_watts{{{base}}} "
            f"{float(rng.uniform(80, 700)):.4f}",
            f"accelerator_energy_joules_total{{{base}}} "
            f"{step * 613.25 + card}",
            f"accelerator_workload_steps_total{{{base}}} "
            f"{step * (30 + int(rng.integers(0, 5)))}",
            f"accelerator_workload_model_flops_utilization{{{base}}} "
            f"{float(rng.random()):.5f}",
            f'accelerator_ici_link_bandwidth_bytes_per_second{{{base},'
            f'link="0"}} {float(rng.integers(0, 10**9))}',
            # A node-side self family: never merged by the hub.
            f"collector_up{{{base}}} 1",
        ]
        if hist:
            le_counts = [step, 3 * step, 4 * step]
            for le, count in zip(("0.01", "0.1", "+Inf"), le_counts):
                lines.append(
                    f"accelerator_workload_step_duration_seconds_bucket"
                    f"{{{base},le=\"{le}\"}} {count}")
            lines.append(f"accelerator_workload_step_duration_seconds_sum"
                         f"{{{base}}} {step * 0.125}")
            lines.append(f"accelerator_workload_step_duration_seconds_count"
                         f"{{{base}}} {4 * step}")
    return "\n".join(lines) + "\n"


class Exporters:
    """A small HTTP server: GET /<name>/metrics answers the body set for
    ``name`` (or a 500 while it is down)."""

    def __init__(self) -> None:
        self.bodies: dict[str, str] = {}
        self.down: set[str] = set()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server's name
                name = self.path.strip("/").split("/")[0]
                if name in outer.down or name not in outer.bodies:
                    self.send_response(500)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                body = outer.bodies[name].encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def url(self, name: str) -> str:
        return f"{self.base}/{name}/metrics"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def exporters():
    server = Exporters()
    yield server
    server.close()


class Tee:
    """POST /ingest/delta handed to both hubs' ingests; answers what
    the port's answered, after holding it equal to the reference's."""

    def __init__(self, port_hub, ref_hub_) -> None:
        outer = self
        self.answers: list[int] = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - http.server's name
                wire = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                got = port_hub.delta.handle(wire, "127.0.0.1")
                want = ref_hub_.delta.handle(wire, "127.0.0.1")
                if got[:2] != want[:2]:
                    got = (599, b"hubs disagree\n", {})
                outer.answers.append(got[0])
                self.send_response(got[0])
                for key, value in got[2].items():
                    self.send_header(key, value)
                self.send_header("Content-Length", str(len(got[1])))
                self.end_headers()
                self.wfile.write(got[1])

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _publishers(tee, sources):
    """One publisher per source, alternating packages, each over its
    own registry; build pinned so both hubs census the same string."""
    out = []
    for i, source in enumerate(sources):
        if i % 2 == 0:
            registry = Registry()
            pub = delta.DeltaPublisher(registry, tee.url, source=source,
                                       generation=700 + i, build="b")
        else:
            registry = RefRegistry()
            pub = ref_delta.DeltaPublisher(registry, tee.url, source=source,
                                           generation=700 + i, build="b")
        out.append((registry, pub))
    return out


def _publish(registry, text: str) -> None:
    from kube_gpu_stats_tpu_torch.validate import parse_exposition

    from kube_gpu_stats_tpu_torch import registry as port_registry
    from kube_gpu_stats_tpu import registry as ref_registry_mod
    from kube_gpu_stats_tpu import schema as ref_schema
    from kube_gpu_stats_tpu_torch import schema as port_schema

    is_port = isinstance(registry, Registry)
    mod = port_registry if is_port else ref_registry_mod
    schema = port_schema if is_port else ref_schema
    specs = {m.name: m for m in schema.PER_DEVICE_METRICS}
    builder = mod.SnapshotBuilder()
    for name, labels, value in parse_exposition(text):
        spec = specs.get(name)
        if spec is not None:
            builder.add(spec, value, tuple(labels.items()))
    registry.publish(builder.build())


# -- the cases ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
def test_file_targets_with_a_duplicate_chip(tmp_path, clock, seed):
    rng = np.random.default_rng(seed)
    paths = [str(tmp_path / f"n{i}.prom") for i in range(3)]
    port, ref = _hubs(paths, interval=1.0, expect_workers=3)
    try:
        for step in range(1, 4):
            for i, path in enumerate(paths):
                # n2 claims n0's worker and chip 1: first target wins.
                worker = "node-00" if i == 2 else f"node-{i:02d}"
                with open(path, "w") as handle:
                    handle.write(_node(rng, worker, 2, step,
                                       chip_offset=1 if i == 2 else 0))
            clock.now += 1.0
            text = _refresh(port, ref)
        assert "slice_duplicate_series 9" in text   # chip 1: 9 families
        assert 'slice_workers_expected 3' in text
        assert "slice_straggler_ratio" in text
    finally:
        _stop(port, ref)


def test_a_target_down_then_up_keeps_its_histogram(exporters, clock):
    rng = np.random.default_rng(3)
    names = ["a", "b"]
    port, ref = _hubs([exporters.url(n) for n in names], interval=1.0,
                      fetch_timeout=2.0)
    try:
        for step in range(1, 7):
            for i, name in enumerate(names):
                exporters.bodies[name] = _node(rng, f"node-{i:02d}", 2,
                                               step, hist=True)
            if step == 3:
                exporters.down.add("b")
            if step == 5:
                exporters.down.discard("b")
            clock.now += 1.0
            text = _refresh(port, ref)
            if step in (3, 4):
                assert f'slice_target_up{{target="{exporters.url("b")}"}} 0' \
                    in text
                # b's last histogram contribution still counts.
                assert "accelerator_workload_step_duration_seconds_count" \
                    in text
    finally:
        _stop(port, ref)


def test_push_fresh_then_fence_expired_falls_back_to_pull(exporters, clock):
    rng = np.random.default_rng(4)
    url = exporters.url("p")
    port, ref = _hubs([url], interval=1.0, push_fence=2.0)
    tee = Tee(port, ref)
    try:
        (registry, pub), = _publishers(tee, [url])
        for step in range(1, 8):
            body = _node(rng, "node-00", 2, step)
            exporters.bodies["p"] = body
            if step <= 3:                        # pushing
                _publish(registry, body)
                pub.push_once()
            clock.now += 1.0
            text = _refresh(port, ref)
            pushed = "kts_delta_push_targets 1" in text
            # The last push lands at step 3; the fence (2 s) holds it
            # fresh for two more refreshes, then the hub pulls.
            assert pushed == (step <= 4), step
        assert set(tee.answers) == {200}
    finally:
        tee.close()
        _stop(port, ref)


def test_push_sessions_from_both_publishers(exporters, clock):
    rng = np.random.default_rng(5)
    sources = [f"http://node-{i:02d}.example:9400/metrics" for i in range(4)]
    port, ref = _hubs([], interval=1.0, targets_provider=lambda: [])
    tee = Tee(port, ref)
    try:
        pubs = _publishers(tee, sources)
        for step in range(1, 6):
            for i, (registry, pub) in enumerate(pubs):
                _publish(registry, _node(rng, f"node-{i:02d}", 2, step))
                pub.push_once()
            clock.now += 1.0
            text = _refresh(port, ref)
        assert "slice_targets 4" in text
        assert 'slice_workers{slice="h100-a"} 4' in text
        assert {200} == set(tee.answers)
        assert port.delta.delta_frames_total == ref.delta.delta_frames_total
        assert port.delta.delta_frames_total > 0
    finally:
        tee.close()
        _stop(port, ref)


def test_rollups_only(tmp_path, clock):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "n.prom")
    port, ref = _hubs([path], interval=1.0, rollups_only=True)
    try:
        for step in range(1, 3):
            with open(path, "w") as handle:
                handle.write(_node(rng, "node-00", 4, step, hist=True))
            clock.now += 1.0
            text = _refresh(port, ref)
        assert "accelerator_duty_cycle{" not in text
        assert "slice_duty_cycle_mean" in text
    finally:
        _stop(port, ref)


def test_federate_over_two_leaf_hubs(tmp_path, clock):
    rng = np.random.default_rng(7)
    leaves = []
    for leaf in range(2):
        paths = [str(tmp_path / f"l{leaf}n{i}.prom") for i in range(2)]
        for i, path in enumerate(paths):
            with open(path, "w") as handle:
                handle.write(_node(rng, f"node-{i:02d}", 2, 1,
                                   slice_=f"h100-{'ab'[leaf]}"))
        leaves.append(hub.Hub(paths, interval=1.0))
    leaf_paths = []
    for i, leaf in enumerate(leaves):
        leaf.refresh_once()
        path = str(tmp_path / f"leaf{i}.prom")
        with open(path, "w") as handle:
            handle.write(leaf.registry.snapshot().render())
        leaf_paths.append(path)
    # A third leaf claims leaf 0's slice: first leaf wins, counted.
    dup = str(tmp_path / "leafdup.prom")
    with open(dup, "w") as handle:
        handle.write(open(leaf_paths[0]).read())
    port, ref = _hubs(leaf_paths + [dup], interval=1.0, federate=True)
    try:
        clock.now += 1.0
        text = _refresh(port, ref)
        assert 'slice_chips{slice="h100-a"} 4' in text
        assert 'slice_chips{slice="h100-b"} 4' in text
        assert "kts_hub_dup_slice_total" in text
    finally:
        _stop(port, ref, *leaves)


def test_file_target_churn(tmp_path, clock):
    rng = np.random.default_rng(8)
    paths = [str(tmp_path / f"c{i}.prom") for i in range(4)]
    for i, path in enumerate(paths):
        with open(path, "w") as handle:
            handle.write(_node(rng, f"node-{i:02d}", 1, 1))
    listing = tmp_path / "targets.txt"
    plans = [paths[:2], paths[1:4], [], paths[2:], paths]
    port = ref = None
    try:
        for step, plan in enumerate(plans):
            listing.write_text("# targets\n" + "\n".join(plan) + "\n")
            if port is None:
                provider = hub.file_targets_provider(str(listing))
                ref_provider = ref_hub.file_targets_provider(str(listing))
                assert provider() == ref_provider()
                port = hub.Hub([], interval=1.0, targets_provider=provider)
                ref = ref_hub.Hub([], interval=1.0,
                                  targets_provider=ref_provider,
                                  history=None, native_ingest=False)
            clock.now += 1.0
            text = _refresh(port, ref)
            assert f"slice_targets {len(plan)}" in text
            assert port.ready() == ref.ready()
    finally:
        _stop(*(h for h in (port, ref) if h is not None))


@pytest.mark.parametrize("knobs", [
    dict(series_budget_per_source=5),
    dict(series_hard_cap=25),
], ids=["budget", "hard-cap"])
def test_series_budget_and_hard_cap_sheds(tmp_path, clock, knobs):
    """One new target per refresh, bodies written once: each refresh
    admits exactly one parse, so which target the ledger sheds does not
    hang on the order in which pool threads finish (a race in either
    package when several parses admit against one hard cap)."""
    rng = np.random.default_rng(9)
    paths = [str(tmp_path / f"s{i}.prom") for i in range(4)]
    for i, path in enumerate(paths):
        with open(path, "w") as handle:
            handle.write(_node(rng, f"node-{i:02d}", 1 + i, 1))
    listed: list[str] = []
    port, ref = _hubs([], interval=1.0, targets_provider=lambda: listed,
                      **knobs)
    try:
        for step in range(len(paths) + 1):
            if step < len(paths):
                listed.append(paths[step])
            clock.now += 1.0
            text = _refresh(port, ref)
        assert port.cardinality.debug_payload() == \
            ref.cardinality.debug_payload()
        assert "kts_cardinality_shed_total" in text
    finally:
        _stop(port, ref)


def test_idle_push_sources_are_evicted_above_the_watermark(clock):
    """Push sources, applied in this thread in one order to both hubs:
    which idle source the watermark evicts does not hang on pool-thread
    arrival (configured pull targets re-admit on their own fetches, in
    whatever order the pool finishes them, in either package)."""
    port, ref = _hubs([], interval=1.0, targets_provider=lambda: [],
                      series_budget_per_source=8, series_hard_cap=30,
                      series_high_watermark=20, series_idle_refreshes=1)
    encoders = {}
    try:
        for step, (source, n) in enumerate([("a", 6), ("b", 9), ("c", 12),
                                            ("d", 5), ("d", 5), ("d", 5)]):
            enc = encoders.setdefault(source, delta.DeltaEncoder(source, 1))
            body = "".join(f'm{i}{{s="{source}"}} {step * 10 + i}\n'
                           for i in range(n))
            wire, _ = enc.encode_next(body)
            assert port.delta.handle(wire)[:2] == ref.delta.handle(wire)[:2]
            enc.ack()
            clock.now += 1.0
            text = _refresh(port, ref)
        assert port.cardinality.debug_payload() == \
            ref.cardinality.debug_payload()
        assert 'kts_cardinality_evicted_total{reason="idle"}' in text
        assert port.cardinality.evicted_totals()["idle"] > 0
    finally:
        _stop(port, ref)


def test_skew_refusals_are_counted_as_the_reference(clock):
    """kts_skew_refused_total on the hub's own exposition: the refusals
    its ingest issued, counted as the reference's hub counts them."""
    port, ref = _hubs([], interval=1.0, targets_provider=lambda: [],
                      ingest_proto_min=2)
    try:
        old = delta.encode_full("old-node", 1, 1, "a 1\n")
        new = delta.encode_full("new-node", 1, 1, "a 1\n", proto=2, caps=1,
                                build="b")
        for wire, peer, code in ((old, "10.0.0.1", 426),
                                 (old, "10.0.0.1", 426),
                                 (old, "10.0.0.1", 426),
                                 (new, "10.0.0.2", 200)):
            got = port.delta.handle(wire, peer)
            want = ref.delta.handle(wire, peer)
            assert got[0] == want[0] == code
        clock.now += 1.0
        text = _refresh(port, ref)
        assert "kts_skew_refused_total 3" in text
    finally:
        _stop(port, ref)


def test_warm_restart_from_either_checkpoint(tmp_path, clock):
    rng = np.random.default_rng(10)
    sources = [f"http://node-{i:02d}.example:9400/metrics" for i in range(3)]
    path = str(tmp_path / "ingest.json")
    port, ref = _hubs([], interval=1.0, targets_provider=lambda: [],
                      ingest_checkpoint=path)
    ref.delta._ckpt_path = str(tmp_path / "ref.json")
    tee = Tee(port, ref)
    pubs = _publishers(tee, sources)
    try:
        for step in range(1, 4):
            for i, (registry, pub) in enumerate(pubs):
                _publish(registry, _node(rng, f"node-{i:02d}", 2, step))
                pub.push_once()
            clock.now += 1.0
            _refresh(port, ref)
    finally:
        tee.close()
        _stop(port, ref)          # stop() forces a final checkpoint
    new_port, new_ref = _hubs([], interval=1.0, targets_provider=lambda: [],
                              ingest_checkpoint=path)
    try:
        assert new_port.ready() == new_ref.ready()
        assert not new_port.ready()[0]
        clock.now += 1.0
        text = _refresh(new_port, new_ref)   # the replay runs here
        for h in (new_port, new_ref):
            h.delta._replay_thread.join(timeout=10)
        clock.now += 1.0
        text = _refresh(new_port, new_ref)
        assert new_port.ready() == new_ref.ready() == (True, "ready")
        assert "slice_targets 3" in text
        assert "kts_hub_warm_restart_sessions 3" in text
    finally:
        _stop(new_port, new_ref)


# -- the history ring through the hub --------------------------------------------

class WallClock:
    """time.time pinned between refreshes: both hubs commit their ring
    at the same wall instant, so bucket boundaries fall alike."""

    def __init__(self) -> None:
        self.now = 1_700_000_003.0

    def __call__(self) -> float:
        return self.now


def _history_hubs(targets, store_kwargs=None, **kwargs):
    from kube_gpu_stats_tpu import history as ref_history
    from kube_gpu_stats_tpu_torch import history

    store_kwargs = store_kwargs or {}
    port = hub.Hub(list(targets),
                   history=history.HistoryStore(**store_kwargs), **kwargs)
    ref = ref_hub.Hub(list(targets),
                      history=ref_history.HistoryStore(**store_kwargs),
                      native_ingest=False, **kwargs)
    return port, ref


def _queries_equal(port, ref, params: dict) -> tuple:
    import re

    nonce = re.compile(r'"h[0-9a-f]{8}-')
    got = port.history.handle_query(dict(params), "10.0.0.1", False, "")
    want = ref.history.handle_query(dict(params), "10.0.0.1", False, "")
    assert (got[0], got[1]) == (want[0], want[1]), params
    assert {k: nonce.sub("", v) for k, v in got[2].items()} == \
        {k: nonce.sub("", v) for k, v in want[2].items()}, params
    return got


@pytest.mark.parametrize("seed", range(2))
def test_the_ring_and_query_equal_the_reference(tmp_path, exporters, clock,
                                                monkeypatch, seed):
    """Pulled and pushed nodes through a sequence of refreshes 10 s of
    wall time apart (one node down for two of them): after each, the
    whole /metrics text (kts_history_* and kts_query_* included) and,
    for every family the ring tracks, every window and a spread of
    ``at=`` timestamps, the /query answers are equal."""
    wall = WallClock()
    monkeypatch.setattr(time, "time", wall)
    rng = np.random.default_rng(20 + seed)
    paths = [str(tmp_path / f"h{i}.prom") for i in range(2)]
    urls = [exporters.url("x"), exporters.url("y")]
    sources = [f"http://node-{i:02d}.push:9400/metrics" for i in range(4, 6)]
    # Rate 0: every read admitted (the monotonic clock is pinned, so a
    # bucket would not refill between these reads).
    port, ref = _history_hubs(paths + urls, store_kwargs={"query_qps": 0.0},
                              interval=10.0, expect_workers=6,
                              fetch_timeout=2.0)
    tee = Tee(port, ref)
    try:
        pubs = _publishers(tee, sources)
        for step in range(1, 9):
            for i, path in enumerate(paths):
                with open(path, "w") as handle:
                    handle.write(_node(rng, f"node-{i:02d}", 2, step))
            for j, name in enumerate(("x", "y")):
                exporters.bodies[name] = _node(rng, f"node-{2 + j:02d}", 2,
                                               step, hist=True)
            if step in (4, 5):
                exporters.down.add("y")
            else:
                exporters.down.discard("y")
            for k, (registry, pub) in enumerate(pubs):
                _publish(registry, _node(rng, f"node-{4 + k:02d}", 2, step))
                pub.push_once()
            clock.now += 10.0
            wall.now += 10.0 + float(rng.uniform(0.0, 0.5))
            text = _refresh(port, ref)
            assert sorted(port.history._data) == sorted(ref.history._data)
            for family in sorted(port.history._data):
                for window in ("1h", "24h", "7d"):
                    status, _b, _h = _queries_equal(
                        port, ref, {"family": family, "window": window})
                    assert status == 200
                for back in (0.0, 5.0, 12.0, 31.0, 400.0):
                    _queries_equal(port, ref, {"family": family,
                                               "at": repr(wall.now - back)})
            _queries_equal(port, ref, {"family": "absent", "window": "1h"})
        families = set(port.history._data)
        assert {"slice_duty_cycle_mean", "slice_chips", "slice_target_up",
                "slice_worker_steps_per_second"} <= families
        # One ring series per target and per rollup series served.
        assert "kts_history_series_shed_total 0" in text
        down = json.loads(port.history.handle_query(
            {"family": "slice_target_up", "at": repr(wall.now - 40.0)},
            "10.0.0.2", False, "")[1])
        assert {s["labels"]["target"]: s["v"] for s in down["series"]}[
            urls[1]] == 0.0
        assert port.history.generation == port.registry.generation
    finally:
        tee.close()
        _stop(port, ref)


def test_the_ring_sheds_past_its_cap_as_the_reference(tmp_path, clock,
                                                      monkeypatch):
    wall = WallClock()
    monkeypatch.setattr(time, "time", wall)
    rng = np.random.default_rng(30)
    paths = [str(tmp_path / f"c{i}.prom") for i in range(3)]
    port, ref = _history_hubs(paths, store_kwargs={"max_series": 6},
                              interval=10.0)
    try:
        for step in range(1, 5):
            for i, path in enumerate(paths):
                with open(path, "w") as handle:
                    handle.write(_node(rng, f"node-{i:02d}", 1, step,
                                       slice_=f"h100-{step % 2}"))
            clock.now += 10.0
            wall.now += 10.0
            text = _refresh(port, ref)
        assert "kts_history_series 6" in text
        assert port.history.series_shed_total == \
            ref.history.series_shed_total > 0
        assert port.history.bytes() == 6 * port.history.series_bytes
    finally:
        _stop(port, ref)


def test_a_disabled_ring_answers_enabled_false(tmp_path, clock, monkeypatch):
    wall = WallClock()
    monkeypatch.setattr(time, "time", wall)
    path = str(tmp_path / "d.prom")
    with open(path, "w") as handle:
        handle.write(_node(np.random.default_rng(31), "node-00", 2, 1))
    port, ref = _history_hubs([path], store_kwargs={"enabled": False},
                              interval=10.0)
    try:
        clock.now += 10.0
        text = _refresh(port, ref)
        assert "kts_history_series 0" in text
        assert "kts_history_bytes 0" in text
        status, body, _ = _queries_equal(port, ref,
                                         {"family": "slice_chips"})
        assert status == 200 and json.loads(body)["enabled"] is False
    finally:
        _stop(port, ref)


# -- the fleet lens through the hub ----------------------------------------------

def test_lens_off_hubs_equal_the_reference(tmp_path, clock):
    """``--no-fleet-lens --no-efficiency`` on both: the off state, with
    no kts_fleet_* family of the lens on either exposition."""
    rng = np.random.default_rng(40)
    paths = [str(tmp_path / f"o{i}.prom") for i in range(2)]
    port = hub.Hub(paths, interval=1.0, fleet_lens=False, efficiency=False)
    ref = ref_hub.Hub(paths, interval=1.0, fleet_lens=False,
                      efficiency=False, history=None, native_ingest=False)
    try:
        assert port.fleet is None
        for step in range(1, 4):
            for i, path in enumerate(paths):
                with open(path, "w") as handle:
                    handle.write(_node(rng, f"node-{i:02d}", 2, step))
            clock.now += 1.0
            text = _refresh(port, ref)
        assert not [line for line in text.splitlines()
                    if line.startswith("kts_fleet_")
                    and not line.startswith("kts_fleet_version_count")]
        assert port.efficiency_payload() == ref.efficiency_payload() == {
            "enabled": False, "reason": "--no-efficiency"}
    finally:
        _stop(port, ref)


def _lens_node(rng, worker: int, step: int, *, idle: bool = False,
               collapsed: bool = False, slow: float = 0.0) -> str:
    """One node of two cards held by the pod ``job-<worker>``, with the
    daemon's trace digest and per-pod energy."""
    lines = []
    for card in range(2):
        base = (f'chip="{card}",namespace="ml",pod="job-{worker}",'
                f'slice="h100-a",worker="{worker}"')
        duty = 0.0 if idle else 70.0 + float(rng.normal(0.0, 1.0))
        if collapsed:
            duty = 4.0
        lines += [
            f"accelerator_up{{{base}}} 1",
            f"accelerator_duty_cycle{{{base}}} {duty:.4f}",
            f"accelerator_memory_used_bytes{{{base}}} "
            f"{40 * 2**30 + float(rng.normal(0.0, 2**26)):.1f}",
            f"accelerator_power_watts{{{base}}} "
            f"{(90.0 if idle else 600.0) + float(rng.normal(0.0, 2.0)):.4f}",
            f"accelerator_workload_steps_total{{{base}}} "
            f"{(0 if idle else 10) * step + 1000}",
            f'accelerator_ici_link_bandwidth_bytes_per_second{{{base},'
            f'link="nvlink{card}"}} {1e11 + float(rng.normal(0, 1e8)):.1f}',
        ]
    lines += [
        f'kts_slowest_tick_seconds{{phase="env_round",blame="device=1"}} '
        f'{0.004 + slow + float(rng.uniform(0.0, 1e-3)):.6f}',
        f'kts_tick_phase_seconds{{phase="env_round",quantile="p50"}} 0.002',
        f'kts_energy_pod_joules_total{{pod="job-{worker}",namespace="ml"}} '
        f'{1200.0 * step + worker}',
        "kts_energy_coverage_ratio 0.25",
    ]
    return "\n".join(lines) + "\n"


def test_the_fleet_lens_through_both_hubs(tmp_path, exporters, clock,
                                         monkeypatch):
    """Six nodes (four files, two HTTP) through 24 refreshes, the ring
    on: node 1's duty collapses (9-12), pod job-2 holds its cards idle
    (13-22), node 4 is the slowest tick from 5 on, node 3's file
    vanishes (15-18). After each refresh the /metrics text, the
    /debug/fleet rollup, the /debug/efficiency attestation over an
    injected energy fetcher (up to generated_at and the HMAC over it)
    and the ring's link and waste rows (tombstones included) are equal;
    then nodes 4 and 5 leave the target list and the lens evicts them
    in both."""
    from kube_gpu_stats_tpu import history as ref_history
    from kube_gpu_stats_tpu import resilience as ref_resilience
    from kube_gpu_stats_tpu_torch import energy, history, resilience

    # The targets' breakers on the pinned clock too: the vanished file's
    # breaker opens at its third miss and half-opens after two intervals
    # of this clock, in both hubs alike.
    for mod in (resilience, ref_resilience):
        monkeypatch.setitem(mod.CircuitBreaker.__init__.__kwdefaults__,
                            "clock", clock)
    rng = np.random.default_rng(41)
    paths = [str(tmp_path / f"f{i}.prom") for i in range(4)]
    urls = [exporters.url("h4"), exporters.url("h5")]
    listed = paths + urls
    leaf = {"version": 1, "node": "n", "generated_at": 1.0,
            "per_pod": [["job-4", "ml", 99.0]], "coverage_ratio": 0.25,
            "enabled": True, "signed": False}

    def fetcher(url):
        if "h5" in url:
            raise OSError("connection refused")
        return dict(leaf)

    port = hub.Hub([], targets_provider=lambda: list(listed), interval=10.0,
                   history=history.HistoryStore(query_qps=0.0),
                   energy_audit_key="k")
    ref = ref_hub.Hub([], targets_provider=lambda: list(listed),
                      interval=10.0, native_ingest=False,
                      history=ref_history.HistoryStore(query_qps=0.0),
                      energy_audit_key="k")
    port._energy_fetcher = ref._energy_fetcher = fetcher
    try:
        for step in range(1, 25):
            for w in range(6):
                body = _lens_node(rng, w, step,
                                  idle=(w == 2 and 13 <= step <= 22),
                                  collapsed=(w == 1 and 9 <= step <= 12),
                                  slow=0.2 if (w == 4 and step >= 5) else 0)
                if w < 4:
                    if w == 3 and 15 <= step <= 18:
                        if os.path.exists(paths[3]):
                            os.unlink(paths[3])
                        continue
                    with open(paths[w], "w") as handle:
                        handle.write(body)
                else:
                    exporters.bodies[f"h{w}"] = body
            clock.now += 10.0
            port._energy_digest_cache = ref._energy_digest_cache = None
            text = _refresh(port, ref)
            assert json.dumps(port.fleet.rollup(), sort_keys=True) == \
                json.dumps(ref.fleet.rollup(), sort_keys=True)
            got, want = port.efficiency_payload(), ref.efficiency_payload()
            assert energy.verify_payload(got, "k")
            for payload in (got, want):
                payload.pop("generated_at")
                payload.pop("hmac")
            assert got == want
            for family in ("kts_fleet_waste_suspect",
                           "kts_fleet_link_suspect"):
                wall = time.time()
                assert port.history.at_payload(family, wall) == \
                    ref.history.at_payload(family, wall)
        rollup = port.fleet.rollup()
        assert rollup["attribution"]["target"] == urls[0]
        assert rollup["links"]["suspects"] == {}
        events = [e for e in port.tracer.events()["events"]
                  if e["kind"].startswith("fleet_")]
        ref_events = [e for e in ref.tracer.events()["events"]
                      if e["kind"].startswith("fleet_")]
        assert [(e["kind"], e["detail"], e["attrs"]) for e in events] == \
            [(e["kind"], e["detail"], e["attrs"]) for e in ref_events]
        kinds = {(e["kind"], e["attrs"].get("anomaly")) for e in events}
        assert ("fleet_anomaly", "duty") in kinds
        assert ("fleet_anomaly", "freshness") in kinds
        assert ("fleet_recovered", "freshness") in kinds
        assert ("fleet_waste", None) in kinds
        assert ("fleet_waste_cleared", None) in kinds
        assert ('kts_fleet_waste_suspect{pod="job-2",namespace="ml",'
                'reason="idle-reservation"} 0') in text
        ring = port.history.at_payload("kts_fleet_waste_suspect",
                                       time.time())["series"]
        assert [s["v"] for s in ring] == [0.0]
        assert got["leaves"][urls[1]] == {"error": "connection refused"}
        assert got["totals"]["targets_total"] == 2
        # Churn: the HTTP nodes leave the list.
        del listed[4:]
        clock.now += 10.0
        _refresh(port, ref)
        rollup = port.fleet.rollup()
        assert json.dumps(rollup, sort_keys=True) == \
            json.dumps(ref.fleet.rollup(), sort_keys=True)
        assert sorted(rollup["targets"]) == sorted(paths)
        assert rollup["attribution"]["target"] != urls[0]
    finally:
        _stop(port, ref)


def _torus_node(rng, worker: int, step: int, sick: bool) -> str:
    """Worker ``worker`` of a 4x1 torus: two cards, each carrying the
    worker's x0 and x1 link rates; ``sick`` cuts the link 1-2 (worker
    1's x1, worker 2's x0) to a tenth."""
    lines = []
    for card in range(2):
        base = (f'chip="{card}",slice="h100-t",topology="4x1",'
                f'worker="{worker}"')
        lines += [f"accelerator_up{{{base}}} 1",
                  f"accelerator_duty_cycle{{{base}}} 80"]
        for label in ("x0", "x1"):
            rate = 3e7 + float(rng.normal(0.0, 3e5))
            if sick and (worker, label) in ((1, "x1"), (2, "x0")):
                rate *= 0.1
            lines.append(f"accelerator_ici_link_bandwidth_bytes_per_second"
                         f"{{{base},link=\"{label}\"}} {rate:.1f}")
    return "\n".join(lines) + "\n"


def test_link_verdicts_ride_both_rings_and_servers(tmp_path, clock):
    """Four workers of a 4x1 torus whose link 1-2 collapses for six
    refreshes: both hubs accuse it and clear it alike, both rings hold
    the 1.0 row and then its 0.0 tombstone, and both packages' servers
    answer /debug/fleet and /debug/efficiency (generated_at and the
    HMAC over it aside) with the same bodies."""
    import urllib.request

    from kube_gpu_stats_tpu import history as ref_history
    from kube_gpu_stats_tpu.exposition import MetricsServer as RefServer
    from kube_gpu_stats_tpu_torch import history
    from kube_gpu_stats_tpu_torch.exposition import MetricsServer

    rng = np.random.default_rng(42)
    paths = [str(tmp_path / f"t{w}.prom") for w in range(4)]
    port = hub.Hub(paths, interval=10.0, energy_audit_key="k",
                   history=history.HistoryStore(query_qps=0.0))
    ref = ref_hub.Hub(paths, interval=10.0, energy_audit_key="k",
                      native_ingest=False,
                      history=ref_history.HistoryStore(query_qps=0.0))
    servers = [MetricsServer(port.registry, host="127.0.0.1", port=0,
                             fleet_provider=port.fleet,
                             efficiency_provider=port.efficiency_payload),
               RefServer(ref.registry, host="127.0.0.1", port=0,
                         fleet_provider=ref.fleet, prewarm_renders=False,
                         efficiency_provider=ref.efficiency_payload)]
    for server in servers:
        server.start()
    rows = []
    try:
        for step in range(1, 24):
            for w, path in enumerate(paths):
                with open(path, "w") as handle:
                    handle.write(_torus_node(rng, w, step,
                                             sick=10 <= step <= 15))
            clock.now += 10.0
            _refresh(port, ref)
            at = time.time()
            got = port.history.at_payload("kts_fleet_link_suspect", at)
            assert got == ref.history.at_payload("kts_fleet_link_suspect",
                                                 at)
            rows.append([s["v"] for s in got["series"]])
        bodies = []
        for server in servers:
            base = f"http://127.0.0.1:{server.port}"
            fleet_body = json.loads(urllib.request.urlopen(
                base + "/debug/fleet").read())
            eff_body = json.loads(urllib.request.urlopen(
                base + "/debug/efficiency").read())
            eff_body.pop("generated_at")
            eff_body.pop("hmac")
            bodies.append((fleet_body, eff_body))
        assert bodies[0] == bodies[1]
        assert bodies[0][0]["links"]["graph"]["kind"] == "torus"
    finally:
        for server in servers:
            server.stop()
        _stop(port, ref)
    assert [1.0] in rows and rows[-1] == [0.0]
    events = [(e["kind"], e["attrs"].get("link"))
              for e in port.tracer.events()["events"]
              if e["kind"].startswith("fleet_link")]
    assert events == [("fleet_link_suspect", "1-2"),
                      ("fleet_link_cleared", "1-2")]
