"""The port's host fast paths (``kube_gpu_stats_tpu_torch/native/wirefast.cc``)
against their Python paths.

Each test drives, with the same inputs made by a seeded numpy generator,
the port's native path, the port's Python path and the reference's Python
path (``Registry(native=False)``, ``DeltaIngest(native=False)``,
``Hub(native_ingest=False)``, ``snappy._decompress_py``, its Python frame
decode), and the reference's native path too where it is right (decode,
snappy, apply, fold and the plaintext render; not its gzip, whose header
byte 9 is fixed at 0xff while this Python writes 0x03). The tolerance is
exact: bytes equal, floats bitwise equal, the same error verdicts. Each
fast path is also shown to have run, so that no comparison is vacuous, and
the build to stop a process at start when it fails, naming the switches.
"""

from __future__ import annotations

import gzip
import math
import struct

import numpy as np
import pytest

from kube_gpu_stats_tpu import delta as ref_delta
from kube_gpu_stats_tpu import hub as ref_hub
from kube_gpu_stats_tpu import native as ref_native
from kube_gpu_stats_tpu import registry as ref_registry
from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu import snappy as ref_snappy
from kube_gpu_stats_tpu_torch import (config, daemon, delta, doctor, hub,
                                      native, registry, schema, snappy)
from kube_gpu_stats_tpu_torch.native import _hostbuild
from kube_gpu_stats_tpu_torch.top import ChipRow

from tests.test_torch_registry import _draw, _snapshot

SEEDS = range(3)
# Wall-clock-derived hub families: each hub computes them from its own
# refresh timestamps, so they are equal in shape but not in digits.
CLOCK_FAMILIES = ("slice_worker_steps_per_second", "slice_straggler_ratio",
                  "slice_target_fetch_seconds")


@pytest.fixture(autouse=True)
def native_paths(monkeypatch):
    """Each test starts with the fast paths on, whatever an earlier test
    in this process switched (a hub or daemon main run in process turns
    the process over to the Python paths, as a real one does)."""
    monkeypatch.setattr(native, "_cache", {
        key: value for key, value in native._cache.items()
        if key != "python_paths"})


@pytest.fixture
def ref_mod():
    """The reference's extension, or None where its build is missing:
    then only the port's paths and the reference's Python paths are
    held."""
    return ref_native.load_wirefast()


@pytest.fixture
def ref_python_decode(monkeypatch):
    """The reference's frame decode on its Python path."""
    monkeypatch.setattr(ref_delta, "_NATIVE_DECODE_LOADED", True)
    monkeypatch.setattr(ref_delta, "_NATIVE_DECODE", None)
    monkeypatch.setattr(ref_delta, "_NATIVE_FRAME", None)
    return ref_delta.decode_frame_raw


@pytest.fixture
def broken_build(monkeypatch, tmp_path):
    """A compiler that fails, an empty build directory and a process that
    has loaded nothing yet."""
    monkeypatch.setattr(_hostbuild, "CXX", "/bin/false")
    monkeypatch.setattr(_hostbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_cache", {})


# -- the build ------------------------------------------------------------------

def test_the_library_is_keyed_by_source_flags_and_python(monkeypatch):
    module = native.load_wirefast()
    path = native.library_path()
    assert path == _hostbuild.library_path()
    assert path.parent == _hostbuild.HERE / "build"
    assert module.__file__ == str(path)
    assert module.__name__ == "kube_gpu_stats_tpu_torch.native._wirefast"
    monkeypatch.setattr(_hostbuild, "CXX_FLAGS",
                        (*_hostbuild.CXX_FLAGS, "-DKTS_OTHER"))
    assert _hostbuild.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(_hostbuild.sys.implementation, "cache_tag",
                        "cpython-399")
    assert _hostbuild.library_path() != path


STARTS = {
    "registry": lambda: registry.Registry(),
    "delta_ingest": lambda: delta.DeltaIngest(),
    "hub": lambda: hub.Hub([], targets_provider=lambda: [], interval=10.0),
    "doctor_row": lambda: doctor.check_native(config.Config()),
}


@pytest.mark.parametrize("start", sorted(STARTS))
def test_a_failed_build_raises_at_start_naming_the_switches(
        start, broken_build):
    if start == "doctor_row":
        row = STARTS[start]()
        assert row.status == "fail"
        message = row.detail
    else:
        with pytest.raises(native.NativeUnavailable) as info:
            STARTS[start]()
        message = str(info.value)
    assert "/bin/false" in message and "exited 1" in message
    assert "--no-native" in message and "--no-native-ingest" in message


def test_a_failed_build_stops_the_daemon_and_the_hub(broken_build, caplog,
                                                     capsys):
    assert daemon.run(config.Config(backend="mock", listen_port=0)) == 1
    assert "--no-native-ingest" in caplog.text and "/bin/false" in caplog.text
    assert hub.main(["--listen-port", "0", "--no-history"]) == 1
    assert "exited 1" in capsys.readouterr().err


def test_the_switches_run_the_python_paths_without_a_build(broken_build):
    reg = registry.Registry(native=False)
    reg.publish(_snapshot(registry, schema, *_draw(0)))
    assert not reg.native_active
    assert reg.rendered(gzip_level=6)[0]
    with native.python_paths("--no-native-ingest"):
        h = hub.Hub([], targets_provider=lambda: [], interval=10.0,
                    native_ingest=False)
        try:
            source = "http://node-0:9400/metrics"
            assert h.delta.handle(delta.encode_full(
                source, 1, 1, "accelerator_up 1\n"))[0] == 200
            assert h.delta.handle(delta.encode_delta(
                source, 1, 2, [(0, 0.0)]))[0] == 200
            h.refresh_once()
            assert not h.delta.native_active and h._fold_native is None
        finally:
            h.stop()
    row = doctor.check_native(config.from_args(["--no-native"]))
    assert row.status == "skip"
    assert native.library_path() is None


def test_the_flags_reach_the_paths(monkeypatch):
    import torch

    from kube_gpu_stats_tpu_torch import embedded

    def embedded_native(**kwargs) -> bool:
        return embedded.EmbeddedExporter(
            device=torch.device("cpu"), **kwargs).registry.native_active

    assert config.from_args([]).use_native and embedded_native()
    assert not embedded_native(native=False)
    assert not config.from_args(["--no-native"]).use_native
    monkeypatch.setenv("KTS_NO_NATIVE", "1")
    assert not config.from_args([]).use_native and not embedded_native()
    assert not daemon.Daemon(config.from_args(
        ["--backend", "mock"])).registry.native_active


@pytest.mark.parametrize("switch", [False, True],
                         ids=["native", "no-native-ingest"])
def test_hub_once_runs_the_path_its_switch_names(switch, monkeypatch,
                                                 tmp_path, capsys):
    target = tmp_path / "node.prom"
    target.write_text('accelerator_up{chip="0",slice="s",worker="w"} 1\n')
    argv = ["--once", str(target), "--no-history"]
    assert hub.main(argv + ["--no-native-ingest"] * switch) == 0
    out = capsys.readouterr().out
    assert f"kts_ingest_native {int(not switch)}" in out.splitlines()
    assert native.python_paths_switch() == (
        "--no-native-ingest" if switch else None)


def test_the_doctor_row_names_the_library():
    row = doctor.check_native(config.Config())
    assert row.status == "ok"
    assert row.data["library"] == str(native.library_path())


# -- snappy ---------------------------------------------------------------------

def _snappy_corpus(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    corpus = [snappy.compress(b""), snappy.compress(b"ab" * 500),
              b"\x05\x10Hello", b"\x0a\x04ab\x1e\x02\x00", b"",
              b"\xff\xff\xff\xff\xff\xff", b"\x05\x10Hel", b"\x05\x10Hello\x00",
              b"\x02\x00a\x05\x01\x00", b"\x80\x80\x80\x80\x10"]
    for _ in range(300):
        size = int(rng.integers(0, 2048))
        payload = rng.integers(0, int(rng.integers(1, 257)), size,
                               dtype=np.uint8).tobytes()
        wire = bytearray(snappy.compress(payload))
        if rng.random() < 0.4 and wire:
            for _ in range(int(rng.integers(1, 3))):
                wire[int(rng.integers(0, len(wire)))] = int(
                    rng.integers(0, 256))
        elif rng.random() < 0.3:
            wire = wire[:int(rng.integers(0, len(wire) + 1))]
        corpus.append(bytes(wire))
    return corpus


def _outcome(decode, data):
    try:
        return decode(data)
    except ValueError as exc:
        return (type(exc), str(exc))


@pytest.mark.parametrize("seed", SEEDS)
def test_snappy_native_equals_the_python_decoders(seed, ref_mod):
    decoders = [snappy._decompress_py, ref_snappy._decompress_py]
    if ref_mod is not None:
        decoders.append(ref_mod.snappy_uncompress)
    module = native.load_wirefast()
    assert native.fast_path() is module
    for wire in _snappy_corpus(seed):
        got = _outcome(snappy.decompress, wire)
        for decode in decoders:
            assert _outcome(decode, wire) == got, wire.hex()


# -- the delta frame decode -----------------------------------------------------

def _frames(seed: int, count: int = 1500) -> list[bytes]:
    """Decompressed DELTA (and some FULL) frames, a share of them corrupt:
    every verdict of the decode comes up, and the slot walk's fallback
    for slots past 2^62."""
    rng = np.random.default_rng(seed)
    specials = (math.nan, math.inf, -math.inf, -0.0, 5e-324, 1e300)
    raws = []
    for i in range(count):
        source = f"http://node-{i % 11}:9400/metrics"
        proto = int(rng.integers(1, 3))
        build = f"b{i % 5}" if proto == 2 and rng.random() < 0.5 else ""
        caps = int(rng.integers(0, 4)) if proto == 2 else 0
        if rng.random() < 0.05:
            wire = delta.encode_full(source, i + 1, 1, "accelerator_up 1\n",
                                     proto=proto, caps=caps, build=build)
        else:
            n = int(rng.integers(0, 40))
            gaps = rng.integers(1, 400, n).astype(object)
            if n and rng.random() < 0.02:
                gaps[-1] = 2**62
            slots = np.cumsum(gaps) if n else []
            values = [specials[int(rng.integers(len(specials)))]
                      if rng.random() < 0.1
                      else float(rng.normal() * 10.0 ** rng.integers(-4, 12))
                      for _ in range(n)]
            wire = delta.encode_delta(source, i + 1, i + 2,
                                      list(zip(map(int, slots), values)),
                                      proto=proto, caps=caps, build=build)
        raw = bytearray(snappy._decompress_py(wire))
        roll = rng.random()
        if roll < 0.08:
            raw = raw[:int(rng.integers(0, len(raw)))]
        elif roll < 0.16:
            raw[int(rng.integers(0, len(raw)))] = int(rng.integers(0, 256))
        elif roll < 0.18:
            raw += bytes([int(rng.integers(0, 256))])
        raws.append(bytes(raw))
    return raws


def _decoded(decode, raw: bytes):
    try:
        f = decode(raw)
    except ValueError as exc:
        return (type(exc).__name__, str(exc))
    return (f.kind, f.source, f.generation, f.seq, f.body, tuple(f.slots),
            struct.pack(f"<{len(f.values)}d", *f.values), f.proto, f.caps,
            f.build)


@pytest.mark.parametrize("seed", SEEDS)
def test_delta_decode_native_equals_the_python_paths(
        seed, ref_mod, ref_python_decode, monkeypatch):
    raws = _frames(seed)
    module = native.load_wirefast()
    calls = {"frame": 0, "slots": 0}

    class Counting:
        def __getattr__(self, name):
            return getattr(module, name)

        def decode_delta_frame(self, data):
            calls["frame"] += 1
            return module.decode_delta_frame(data)

        def decode_delta_slots(self, data, pos, count):
            calls["slots"] += 1
            return module.decode_delta_slots(data, pos, count)

    monkeypatch.setitem(native._cache, "module", Counting())
    got = [_decoded(delta.decode_frame_raw, raw) for raw in raws]
    assert calls["frame"] == len(raws) and calls["slots"] > 0
    monkeypatch.setitem(native._cache, "module", module)
    with native.python_paths("test"):
        assert [_decoded(delta.decode_frame_raw, raw) for raw in raws] == got
    assert [_decoded(ref_python_decode, raw) for raw in raws] == got
    monkeypatch.undo()
    if ref_mod is not None:
        assert [_decoded(ref_delta.decode_frame_raw, raw)
                for raw in raws] == got
    verdicts = {outcome[0] for outcome in got if isinstance(outcome[0], str)}
    assert {"ValueError", "UnicodeDecodeError"} <= verdicts
    assert sum(not isinstance(o[0], str) for o in got) > len(raws) // 2


def test_slot_walk_past_2_62_falls_back_to_python_ints():
    wire = delta.encode_delta("s", 1, 2, [(5, 1.0), (2**62 + 5, 2.0),
                                          (2**63 + 9, 3.0)])
    raw = snappy.decompress(wire)
    assert native.load_wirefast().decode_delta_frame(raw) is None
    frame = delta.decode_frame_raw(raw)
    assert frame.slots == (5, 2**62 + 5, 2**63 + 9)
    with native.python_paths("test"):
        assert delta.decode_frame_raw(raw) == frame


# -- render and gzip ------------------------------------------------------------

def _ref_render_snapshot(seed: int):
    return _snapshot(ref_registry, ref_schema, *_draw(seed))


@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["prometheus", "openmetrics"])
@pytest.mark.parametrize("seed", SEEDS)
def test_render_native_equals_the_python_paths(seed, openmetrics, ref_mod):
    port_snapshot = _snapshot(registry, schema, *_draw(seed))
    got = native.load_render().render_exposition(
        port_snapshot.series, port_snapshot.histograms, openmetrics)
    assert got == port_snapshot.render(openmetrics=openmetrics).encode()
    ref_snapshot = _ref_render_snapshot(seed)
    assert got == ref_snapshot.render(openmetrics=openmetrics).encode()
    if ref_native.load_render() is not None:
        assert got == ref_mod.render_exposition(
            ref_snapshot.series, ref_snapshot.histograms, openmetrics)
    assert len(got) > 1000


def test_render_edges_empty_and_eof():
    module = native.load_render()
    assert module.render_exposition((), (), False) == b""
    assert module.render_exposition((), (), True) == b"# EOF\n"


@pytest.mark.parametrize("level", [1, 3, 6, 9])
def test_gzip_equals_gzip_compress_on_this_python(level):
    rng = np.random.default_rng(level)
    module = native.load_wirefast()
    payloads = [b"", b"a", _snapshot(registry, schema, *_draw(level))
                .render().encode()]
    payloads += [rng.integers(0, int(rng.integers(1, 257)),
                              int(rng.integers(0, 1 << 16)),
                              dtype=np.uint8).tobytes() for _ in range(8)]
    for data in payloads:
        assert module.gzip_compress(data, level) == gzip.compress(
            data, compresslevel=level, mtime=0)


@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["prometheus", "openmetrics"])
@pytest.mark.parametrize("seed", SEEDS)
def test_registry_bytes_equal_the_python_registries(seed, openmetrics):
    rows, hists = _draw(seed)
    fast, slow = registry.Registry(), registry.Registry(native=False)
    ref = ref_registry.Registry(native=False)
    fast.publish(_snapshot(registry, schema, rows, hists))
    slow.publish(_snapshot(registry, schema, rows, hists))
    ref.publish(_snapshot(ref_registry, ref_schema, rows, hists))
    assert fast.native_active and not slow.native_active
    for level in (0, 3):
        got = fast.rendered(openmetrics=openmetrics, gzip_level=level)
        assert got == slow.rendered(openmetrics=openmetrics,
                                    gzip_level=level)
        assert got == ref.rendered(openmetrics=openmetrics,
                                   gzip_level=level)
        assert not got[1]
    assert fast.native_active


def test_cached_render_byte_identical_to_uncached():
    reg = registry.Registry()
    snapshot = _snapshot(registry, schema, *_draw(7))
    reg.publish(snapshot)
    text = snapshot.render().encode()
    for level in (0, 3, 6):
        want = gzip.compress(text, compresslevel=level, mtime=0) \
            if level else text
        assert reg.rendered(gzip_level=level) == (want, False)
        assert reg.rendered(gzip_level=level) == (want, True)


def test_the_registry_renders_through_the_extension(monkeypatch):
    calls = {"render": 0, "gzip": 0}
    module = native.load_render()

    class Counting:
        def render_exposition(self, series, hists, openmetrics):
            calls["render"] += 1
            return module.render_exposition(series, hists, openmetrics)

        def gzip_compress(self, data, level):
            calls["gzip"] += 1
            return module.gzip_compress(data, level)

    reg = registry.Registry()
    monkeypatch.setattr(reg, "_native_render", Counting())
    reg.publish(_snapshot(registry, schema, *_draw(1)))
    body, hit = reg.rendered(False, 6)
    assert not hit and body
    assert calls == {"render": 1, "gzip": 1}


def test_a_render_fault_degrades_the_registry_visibly(monkeypatch):
    monkeypatch.setattr(native, "_faults", {})

    class Refusing:
        def render_exposition(self, *_args):
            raise ValueError("label pair is not a 2-tuple")

    reg = registry.Registry()
    monkeypatch.setattr(reg, "_native_render", Refusing())
    snapshot = _snapshot(registry, schema, *_draw(2))
    reg.publish(snapshot)
    assert reg.rendered() == (snapshot.render().encode(), False)
    assert not reg.native_active
    assert "render" in native.faults()
    row = doctor.check_native(config.Config())
    assert row.status == "warn" and "render" in row.detail


# -- the frame fold -------------------------------------------------------------

def _rows(rng, n: int) -> dict:
    rows = {}
    for i in range(n):
        key = (f"http://t{i}", f"s{rng.integers(3)}", str(rng.integers(8)),
               str(i))
        row = ChipRow(key, at=float(rng.uniform(0, 100)))
        row.duty = None if rng.random() < 0.3 else float(rng.uniform(0, 100))
        row.mem_used = None if rng.random() < 0.3 else float(rng.random())
        row.ici_bps = float(rng.uniform(0, 1e9))
        row.holders = int(rng.integers(4))
        row.steps_total = (None if rng.random() < 0.3
                           else float(rng.integers(10**6)))
        rows[key] = row
    return rows


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_rows_equals_clone_at(seed, ref_mod):
    rng = np.random.default_rng(seed)
    folds = [native.load_fold().fold_rows]
    if ref_mod is not None:
        folds.append(ref_mod.fold_rows)
    src = _rows(rng, 40)
    for _ in range(12):
        at = float(rng.uniform(0, 1e6))
        want = {key: row.clone_at(at) for key, row in src.items()}
        for fold in folds:
            got: dict = {}
            fold(got, src, at)
            assert list(got) == list(want)
            for key, row in want.items():
                assert type(got[key]) is ChipRow
                assert got[key].__dict__ == row.__dict__
                assert got[key] is not src[key]
            sample = list(src)[int(rng.integers(len(src)))]
            got[sample].duty = -1.0
            assert src[sample].duty != -1.0
        for key in list(src)[:3]:
            del src[key]
        src.update(_rows(rng, int(rng.integers(1, 6))))


def test_the_hub_folds_through_the_extension(monkeypatch):
    fast = hub.Hub([], targets_provider=lambda: [], interval=10.0,
                   push_fence=1e9)
    oracle = hub.Hub([], targets_provider=lambda: [], interval=10.0,
                     push_fence=1e9, native_ingest=False)
    calls = []
    module = fast._fold_native

    class Counting:
        def fold_rows(self, dst, src, at):
            calls.append(len(src))
            module.fold_rows(dst, src, at)

    try:
        assert module is not None and oracle._fold_native is None
        monkeypatch.setattr(fast, "_fold_native", Counting())
        for h in (fast, oracle):
            assert h.delta.handle(delta.encode_full(
                "w0", 1, 1, _body(0, 10.0, 0.0, False, 0.001)))[0] == 200
            h.refresh_once()
        assert calls == [2]
        assert _lines(fast) == _lines(oracle)
    finally:
        fast.stop()
        oracle.stop()


# -- the batch slot store under churn -------------------------------------------

def _body(worker: int, duty: float, steps: float, extra: bool,
          phase: float) -> str:
    """One worker's exposition: per-card gauges and a counter, link rates,
    a workload histogram and the flight recorder's digest family — every
    surface the hub derives a cache from."""
    builder = registry.SnapshotBuilder()
    for card in range(2 + extra):
        labels = (("accel_type", "h100-sxm"), ("chip", str(card)),
                  ("device_path", f"/dev/nvidia{card}"), ("uuid", ""),
                  ("pod", "train-0"), ("namespace", "ml"),
                  ("container", "w"), ("slice", f"s{worker % 2}"),
                  ("worker", str(worker)), ("topology", "2x2"))
        builder.add(schema.DEVICE_UP, 1.0, labels)
        builder.add(schema.DUTY_CYCLE, duty + card, labels)
        builder.add(schema.MEMORY_USED, 1e9 + worker, labels)
        builder.add(schema.POWER, 200.0 + duty, labels)
        builder.add(schema.WORKLOAD_STEPS, steps, labels)
        builder.add(schema.ICI_BANDWIDTH, 1e8 * (1 + card) + duty,
                    labels + (("link", "nvlink0"),))
    state = registry.HistogramState.empty(
        schema.WORKLOAD_STEP_DURATION, (0.1, 1.0),
        labels=(("worker", str(worker)),))
    builder.add_histogram(state.observe(0.05, int(steps) % 7 + 1))
    builder.add(schema.TICK_PHASE_SECONDS, phase,
                (("phase", "fetch"), ("quantile", "0.5")))
    return builder.build().render()


def _lines(h) -> list[str]:
    text = h.registry.rendered()[0].decode()
    return [line for line in text.splitlines()
            if line.startswith(("accelerator_", "slice_"))
            and not line.startswith(CLOCK_FAMILIES)]


def _push_hubs(ref_mod):
    """(name, hub, python paths?) for every path held."""
    kwargs = dict(targets_provider=lambda: [], interval=10.0,
                  push_fence=1e9, ingest_lanes=2)
    hubs = [("port-native", hub.Hub([], **kwargs), False),
            ("port-python", hub.Hub([], native_ingest=False, **kwargs),
             True),
            ("reference-python",
             ref_hub.Hub([], native_ingest=False, history=None, **kwargs),
             False)]
    if ref_mod is not None and ref_native.load_ingest() is not None:
        hubs.append(("reference-native",
                     ref_hub.Hub([], history=None, **kwargs), False))
    return hubs


def _handle(name, h, python, wire):
    with native.python_paths(name if python else None):
        return h.delta.handle(wire)[0]


@pytest.mark.parametrize("seed", range(2))
def test_native_hub_equals_the_python_hubs_under_churn(seed, ref_mod):
    """Randomised value churn, shape changes (FULLs), worker restarts,
    duplicate deliveries and resyncs: every hub serves the same data
    series after each round, and the native entries' value slabs stay
    equal to the series they front."""
    rng = np.random.default_rng(seed)
    workers = 4
    hubs = _push_hubs(ref_mod)
    encoders = {name: {} for name, _h, _p in hubs}
    state = {i: [10.0 * (i + 1), float(i), False, 0.001, i + 1]
             for i in range(workers)}

    def encoder(name, i):
        gen = state[i][4]
        enc = encoders[name].get(i)
        if enc is None or enc.generation != gen:
            module = delta if name.startswith("port") else ref_delta
            enc = encoders[name][i] = module.DeltaEncoder(f"w{i}",
                                                          generation=gen)
        return enc

    def feed(i, duplicate=False):
        body = _body(i, *state[i][:4])
        for name, h, python in hubs:
            enc = encoder(name, i)
            wire, kind = enc.encode_next(body)
            code = _handle(name, h, python, wire)
            if code != 200:
                enc.nack()
                wire, kind = enc.encode_next(body)
                code = _handle(name, h, python, wire)
            assert code == 200, name
            enc.ack()
            if duplicate:
                assert _handle(name, h, python, wire) == (
                    200 if kind == delta.KIND_FULL else 409)

    try:
        assert [h.delta.native_active for _n, h, _p in hubs] == [
            True, False, False] + [True] * (len(hubs) - 3)
        for i in range(workers):
            feed(i)
        for round_no in range(12):
            for i in range(workers):
                event = rng.random()
                if event < 0.45:
                    state[i][0] += float(rng.choice([0.0, 1.0, 2.5]))
                    state[i][1] += float(rng.integers(0, 4))
                elif event < 0.6:
                    state[i][3] += 0.0005
                elif event < 0.75:
                    state[i][2] = not state[i][2]
                elif event < 0.85:
                    state[i][4] += 100
                    state[i][1] = 0.0
                feed(i, duplicate=rng.random() < 0.15)
            served = []
            for name, h, python in hubs:
                with native.python_paths(name if python else None):
                    h.refresh_once()
                served.append(_lines(h))
            assert served[0], f"round {round_no}: nothing served"
            for (name, _h, _p), lines in zip(hubs[1:], served[1:]):
                assert lines == served[0], f"round {round_no}: {name}"
            fast = hubs[0][1]
            for source in fast.delta.sources():
                entry = fast._parse_cache.get(source)
                if entry is not None and entry.value_slab is not None:
                    assert list(entry.value_slab) == [
                        value for _n, _l, value in entry.series]
        assert hubs[0][1].delta.native_active
    finally:
        for _name, h, _python in hubs:
            h.stop()


def test_the_slot_store_runs_natively(monkeypatch):
    h = hub.Hub([], targets_provider=lambda: [], interval=10.0,
                push_fence=1e9)
    module = h.delta._native_mod
    calls = []

    class Counting:
        def apply_slots(self, entry, slots, values):
            calls.append(len(slots))
            return module.apply_slots(entry, slots, values)

    try:
        encoder = delta.DeltaEncoder("w0", generation=1)
        wire, _ = encoder.encode_next(_body(0, 10.0, 0.0, False, 0.001))
        assert h.delta.handle(wire)[0] == 200
        encoder.ack()
        h.refresh_once()  # builds the merge plans: the program's gate
        entry = h._parse_cache.get("w0")
        assert entry.patch_program is None  # lazy: no delta yet
        monkeypatch.setattr(h.delta, "_native_mod", Counting())
        wire, kind = encoder.encode_next(_body(0, 12.0, 3.0, False, 0.002))
        assert kind == delta.KIND_DELTA
        assert h.delta.handle(wire)[0] == 200
        assert calls and entry.patch_program is not None
        assert set(entry.patch_program[0]) <= {0, 1, 2, 3, 4, 5}
        assert list(entry.value_slab) == [v for _n, _l, v in entry.series]
    finally:
        h.stop()


def test_a_native_apply_fault_degrades_the_hub_visibly(monkeypatch):
    monkeypatch.setattr(native, "_faults", {})
    fast = hub.Hub([], targets_provider=lambda: [], interval=10.0,
                   push_fence=1e9)
    oracle = hub.Hub([], targets_provider=lambda: [], interval=10.0,
                     push_fence=1e9, native_ingest=False)

    class Refusing:
        def apply_slots(self, *_args):
            raise ValueError("patch program does not match the entry shape")

    try:
        encoders = [delta.DeltaEncoder("w0", generation=1) for _ in "ab"]
        for step, duty in enumerate((10.0, 11.0, 12.0)):
            if step == 1:
                monkeypatch.setattr(fast.delta, "_native_mod", Refusing())
            for h, enc in zip((fast, oracle), encoders):
                wire, _ = enc.encode_next(_body(0, duty, step, False, 0.001))
                assert h.delta.handle(wire)[0] == 200
                enc.ack()
                h.refresh_once()
            assert _lines(fast) == _lines(oracle)
        assert not fast.delta.native_active
        assert "apply_slots" in native.faults()
        assert "kts_ingest_native 0" in fast.registry.rendered()[0].decode()
        row = doctor.check_native(config.Config())
        assert row.status == "warn" and "apply_slots" in row.detail
    finally:
        fast.stop()
        oracle.stop()
