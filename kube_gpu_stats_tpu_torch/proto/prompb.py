"""Prometheus remote_write protobuf surface (prompb.WriteRequest subset).

The port's copy of the reference's module, hand-rolled on :mod:`.codec`
like the PodResources messages — the schema is tiny and frozen by the
remote-write 1.0 spec:

    WriteRequest { repeated TimeSeries timeseries = 1; }
    TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
    Label        { string name = 1; string value = 2; }
    Sample       { double value = 1; int64 timestamp = 2; }  // ms epoch

The encoder enforces the spec's invariants (labels sorted by name,
``__name__`` present, no empty values); the decoder exists for the test
receiver (``testing/egress_sink.py``) and round-trips strictly.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from . import codec


def encode_series(
    name: str,
    labels: Iterable[tuple[str, str]],
    value: float,
    timestamp_ms: int,
) -> bytes:
    """One TimeSeries message. Labels are sorted and ``__name__`` is
    injected; empty-valued labels are dropped (remote-write receivers
    reject them, unlike exposition where "" is the documented encoding
    for not-applicable)."""
    pairs = [("__name__", name)]
    pairs.extend((k, v) for k, v in labels if v != "")
    pairs.sort()
    body = bytearray()
    for key, val in pairs:
        label = codec.field_string(1, key) + codec.field_string(2, val)
        body += codec.field_bytes(1, label)
    sample = codec.field_double(1, value) + codec.field_varint(2, timestamp_ms)
    body += codec.field_bytes(2, sample)
    return codec.field_bytes(1, bytes(body))


def encode_write_request(series: Sequence[bytes]) -> bytes:
    """Concatenate pre-encoded TimeSeries into one WriteRequest."""
    return b"".join(series)


def decode_write_request(
    raw: bytes,
) -> list[tuple[dict[str, str], list[tuple[float, int]]]]:
    """[(labels, [(value, timestamp_ms), ...]), ...] — test-side decoder."""
    out: list[tuple[dict[str, str], list[tuple[float, int]]]] = []
    for field, wire_type, ts_raw in codec.iter_fields(raw):
        if field != 1 or wire_type != codec.LENGTH:
            continue
        labels: dict[str, str] = {}
        samples: list[tuple[float, int]] = []
        for ts_field, ts_wire, value in codec.iter_fields(ts_raw):
            if ts_field == 1 and ts_wire == codec.LENGTH:
                name = val = ""
                for lf, lw, lv in codec.iter_fields(value):
                    if lf == 1 and lw == codec.LENGTH:
                        name = lv.decode("utf-8")
                    elif lf == 2 and lw == codec.LENGTH:
                        val = lv.decode("utf-8")
                labels[name] = val
            elif ts_field == 2 and ts_wire == codec.LENGTH:
                sample_value = 0.0
                sample_ts = 0
                for sf, sw, sv in codec.iter_fields(value):
                    if sf == 1 and sw == codec.FIXED64:
                        sample_value = float(sv)
                    elif sf == 2 and sw == codec.VARINT:
                        sample_ts = codec.signed(sv)
                samples.append((sample_value, sample_ts))
        out.append((labels, samples))
    return out
