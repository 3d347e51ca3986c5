"""The port's snappy codec and remote-write protos against the reference's.

``compress`` must give the reference's bytes on seeded random data (runs
of a small alphabet, so the matcher finds copies of every length and
offset class) and on exposition texts; ``decompress`` must give the
reference's bytes, or raise its error class with its message, on those
and on malformed streams: the spec's garbage vectors, truncations at
every byte, and seeded byte flips. The reference's public
``decompress`` may run its C decoder, so the port is held against both
it and the Python ``_decompress_py``.

``prompb``/``prompb2`` must encode the same bytes for the same series,
and each package must decode the other's output to the same rows.
"""

from __future__ import annotations

import numpy as np
import pytest

from kube_gpu_stats_tpu import snappy as ref_snappy
from kube_gpu_stats_tpu.collectors.mock import MockCollector as RefMock
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.proto import codec as ref_codec
from kube_gpu_stats_tpu.proto import prompb as ref_prompb
from kube_gpu_stats_tpu.proto import prompb2 as ref_prompb2
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu_torch import snappy
from kube_gpu_stats_tpu_torch.proto import codec, prompb, prompb2


def _random_payload(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 200_000 if seed % 4 == 0 else 5_000))
    alphabet = int(rng.choice([2, 4, 16, 256]))
    return rng.integers(0, alphabet, n, dtype=np.uint8).tobytes()


def _exposition(devices: int) -> bytes:
    registry = RefRegistry(native=False)
    loop = RefPollLoop(RefMock(devices), registry, interval=1.0,
                       deadline=30.0, version="test")
    try:
        loop.tick()
        loop.tick()
        return registry.rendered()[0]
    finally:
        loop.stop()


EXPOSITIONS = {n: _exposition(n) for n in (1, 4)}


def _outcome(fn, data: bytes):
    try:
        return "ok", fn(data)
    except Exception as exc:  # noqa: BLE001 - the verdict is compared
        return type(exc), str(exc)


@pytest.mark.parametrize("seed", range(12))
def test_compress_gives_the_references_bytes(seed):
    data = _random_payload(seed)
    wire = snappy.compress(data)
    assert wire == ref_snappy.compress(data)
    assert snappy.decompress(wire) == data


@pytest.mark.parametrize("devices", sorted(EXPOSITIONS))
def test_compress_gives_the_references_bytes_on_expositions(devices):
    body = EXPOSITIONS[devices]
    wire = snappy.compress(body)
    assert wire == ref_snappy.compress(body)
    assert len(wire) < len(body) // 2
    assert snappy.decompress(wire) == ref_snappy._decompress_py(wire) == body


GARBAGE = [
    b"",                          # no preamble
    b"\x05\x10He",                # truncated literal
    b"\x0a\x04ab\x1e",            # truncated copy offset
    b"\x05\x04ab\x06\x09\x00",    # copy offset beyond output
    b"\x03\x10Hello",             # length mismatch
    b"\xff\xff\xff\xff\xff\xff",  # runaway length varint
    b"\x05\x10Hello\x00",         # trailing garbage tag
    b"\x02\x00a\x05\x01\x00",     # copy reaching past declared length
    b"\x80\x80\x80\x80\x10",      # declared length past 2 GiB
    b"\x04\xf0",                  # literal length bytes missing
    b"\x04\x03\x01\x00",          # truncated copy-4 offset
    b"\x04\x00a\x03\x00\x00\x00\x00",  # copy-4 with offset 0
    b"\x08\x00a" + b"\x0d\x01",  # copy-1 overlapping its own output
]


@pytest.mark.parametrize("wire", GARBAGE, ids=[w.hex() or "empty"
                                               for w in GARBAGE])
def test_decompress_verdicts_equal_the_references(wire):
    got = _outcome(snappy.decompress, wire)
    assert got == _outcome(ref_snappy._decompress_py, wire)
    assert got == _outcome(ref_snappy.decompress, wire)


def test_the_decompression_bomb_is_refused_as_the_reference_does():
    body = bytearray([100, (2 - 1) << 2]) + b"ab"
    for _ in range(5000):
        body += bytes([((64 - 1) << 2) | 0b10, 1, 0])
    got = _outcome(snappy.decompress, bytes(body))
    assert got == _outcome(ref_snappy._decompress_py, bytes(body))
    assert got[0] is ValueError and "exceeds declared length" in got[1]


@pytest.mark.parametrize("seed", range(6))
def test_truncations_and_flips_give_the_references_verdicts(seed):
    rng = np.random.default_rng(100 + seed)
    body = EXPOSITIONS[1][:4096] if seed % 2 else _random_payload(seed)[:4096]
    wire = ref_snappy.compress(body)
    cases = [wire[:cut] for cut in range(0, len(wire), max(1, len(wire)
                                                           // 97))]
    for _ in range(150):
        flipped = bytearray(wire)
        for _ in range(int(rng.integers(1, 4))):
            flipped[int(rng.integers(0, len(flipped)))] = \
                int(rng.integers(0, 256))
        cases.append(bytes(flipped))
    verdicts = set()
    for case in cases:
        got = _outcome(snappy.decompress, case)
        assert got == _outcome(ref_snappy._decompress_py, case), case.hex()
        assert got == _outcome(ref_snappy.decompress, case), case.hex()
        verdicts.add(got[0] if got[0] != "ok" else "ok")
    assert ValueError in verdicts


# -- the codec and the remote-write protos ------------------------------------

@pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 2**35, 2**63 - 1,
                                   -1, -(2**40)])
def test_varints_and_fields_encode_as_the_reference(value):
    assert codec.encode_varint(value) == ref_codec.encode_varint(value)
    assert codec.field_varint(3, value) == ref_codec.field_varint(3, value)
    decoded, _ = codec.decode_varint(codec.encode_varint(value), 0)
    assert codec.signed(decoded) == ref_codec.signed(decoded) == value


def _series(seed: int) -> list[tuple[str, list, float, int]]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(1, 40))):
        labels = [("chip", str(i % 8)), ("uuid", f"GPU-{i}"),
                  ("pod", "" if i % 3 else f"pod-{i}"),
                  ("accel_type", "h100"), ("job", "kts")]
        rng.shuffle(labels)
        value = float(rng.choice([rng.normal() * 1e3, 0.0, -0.0, 1e300,
                                  float(rng.integers(0, 10))]))
        out.append((f"accelerator_metric_{i % 5}", labels, value,
                    int(rng.integers(0, 2**41))))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_prompb_bytes_and_cross_decode(seed):
    rows = _series(seed)
    port = prompb.encode_write_request(
        [prompb.encode_series(*row) for row in rows])
    ref = ref_prompb.encode_write_request(
        [ref_prompb.encode_series(*row) for row in rows])
    assert port == ref
    assert prompb.decode_write_request(ref) == \
        ref_prompb.decode_write_request(port)
    decoded = prompb.decode_write_request(port)
    assert [labels["__name__"] for labels, _ in decoded] == \
        [row[0] for row in rows]
    assert all("" not in labels.values() for labels, _ in decoded)


@pytest.mark.parametrize("seed", range(5))
def test_prompb2_bytes_and_cross_decode(seed):
    rows = _series(seed)
    encoded = []
    for module in (prompb2, ref_prompb2):
        table = module.SymbolTable()
        series = [module.encode_series(table, name, labels, value, ts,
                                       module.TYPE_GAUGE if i % 2 else 0,
                                       "help text" if i % 3 else "")
                  for i, (name, labels, value, ts) in enumerate(rows)]
        encoded.append(module.encode_request(table, series))
    assert encoded[0] == encoded[1]
    assert prompb2.decode_request(encoded[1]) == \
        ref_prompb2.decode_request(encoded[0])


@pytest.mark.parametrize("raw", [
    prompb2.codec.field_string(4, "x"),             # symbols[0] not ""
    prompb2.codec.field_string(4, "")
    + prompb2.codec.field_bytes(5, prompb2.codec.field_bytes(1, b"\x07")),
    prompb2.codec.field_string(4, "")
    + prompb2.codec.field_bytes(5, prompb2.codec.field_bytes(1, b"\x00")),
])
def test_prompb2_decode_refuses_as_the_reference(raw):
    assert _outcome(prompb2.decode_request, raw) == \
        _outcome(ref_prompb2.decode_request, raw)
    assert _outcome(prompb2.decode_request, raw)[0] is ValueError
