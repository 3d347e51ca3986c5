"""Prometheus remote_write 2.0 protobuf surface
(``io.prometheus.write.v2.Request`` subset).

The port's copy of the reference's module, hand-rolled on :mod:`.codec`
like prompb 1.0 — the 2.0 schema is small
and frozen by the remote-write 2.0 spec
(https://prometheus.io/docs/specs/remote_write_spec_2_0/):

    Request {
      repeated string symbols = 4;        // interned strings; [0] == ""
      repeated TimeSeries timeseries = 5;
    }
    TimeSeries {
      repeated uint32 labels_refs = 1;    // packed; (name,value) ref pairs
      repeated Sample samples = 2;
      // fields 3/4: native histograms / exemplars (not sent by gauges)
      Metadata metadata = 5;
      // field 6: int64 created_timestamp (not sent)
    }
    Sample   { double value = 1; int64 timestamp = 2; }   // ms epoch
    Metadata { MetricType type = 1; uint32 help_ref = 3; uint32 unit_ref = 4; }

The symbol table is the point of 2.0: every label name/value and help
string is sent once per request instead of once per series, which on a
node's per-card label sets cuts the uncompressed payload severalfold.
The encoder enforces the spec's invariants (symbols[0] is the empty
string, labels sorted by name, ``__name__`` present); the decoder exists
for the test receiver (``testing/egress_sink.py``) and round-trips
strictly.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from . import codec

# Metadata.MetricType enum values fixed by the 2.0 proto.
TYPE_UNSPECIFIED = 0
TYPE_COUNTER = 1
TYPE_GAUGE = 2
TYPE_HISTOGRAM = 3


class SymbolTable:
    """Interns strings for one Request; ref 0 is always ""."""

    def __init__(self) -> None:
        self._refs: dict[str, int] = {"": 0}
        self.symbols: list[str] = [""]

    def ref(self, symbol: str) -> int:
        ref = self._refs.get(symbol)
        if ref is None:
            ref = self._refs[symbol] = len(self.symbols)
            self.symbols.append(symbol)
        return ref


def encode_series(
    table: SymbolTable,
    name: str,
    labels: Iterable[tuple[str, str]],
    value: float,
    timestamp_ms: int,
    metric_type: int = TYPE_UNSPECIFIED,
    help_text: str = "",
) -> bytes:
    """One TimeSeries message (unframed body; encode_request frames it).
    Labels are sorted, ``__name__`` is injected, empty values dropped
    (same receiver contract as prompb 1.0)."""
    pairs = [("__name__", name)]
    pairs.extend((k, v) for k, v in labels if v != "")
    pairs.sort()
    refs = bytearray()
    for key, val in pairs:
        refs += codec.encode_varint(table.ref(key))
        refs += codec.encode_varint(table.ref(val))
    body = codec.field_bytes(1, bytes(refs))  # packed labels_refs
    sample = codec.field_double(1, value) + codec.field_varint(2, timestamp_ms)
    body += codec.field_bytes(2, sample)
    if metric_type or help_text:
        metadata = b""
        if metric_type:
            metadata += codec.field_varint(1, metric_type)
        if help_text:
            metadata += codec.field_varint(3, table.ref(help_text))
        body += codec.field_bytes(5, metadata)
    return body


def encode_request(table: SymbolTable, series: Sequence[bytes]) -> bytes:
    """Frame interned symbols + pre-encoded TimeSeries into one Request.
    Symbols are emitted after the series bodies are built (building them
    is what populates the table) but serialized first — field order
    within a protobuf message is free, and symbols-first keeps hexdumps
    readable."""
    out = bytearray()
    for symbol in table.symbols:
        out += codec.field_string(4, symbol)
    for body in series:
        out += codec.field_bytes(5, body)
    return bytes(out)


def decode_request(
    raw: bytes,
) -> list[tuple[dict[str, str], list[tuple[float, int]], dict]]:
    """[(labels, [(value, ts_ms)], metadata)] — test-side decoder.
    metadata holds {"type": int, "help": str} when present."""
    symbols: list[str] = []
    series_raw: list[bytes] = []
    for field, wire_type, value in codec.iter_fields(raw):
        if field == 4 and wire_type == codec.LENGTH:
            symbols.append(value.decode("utf-8"))
        elif field == 5 and wire_type == codec.LENGTH:
            series_raw.append(value)
    if symbols and symbols[0] != "":
        raise ValueError("symbols[0] must be the empty string (2.0 spec)")

    def symbol(ref: int) -> str:
        if ref >= len(symbols):
            raise ValueError(
                f"symbol ref {ref} out of range ({len(symbols)} symbols)")
        return symbols[ref]

    out = []
    for ts_raw in series_raw:
        labels: dict[str, str] = {}
        samples: list[tuple[float, int]] = []
        metadata: dict = {}
        for field, wire_type, value in codec.iter_fields(ts_raw):
            if field == 1 and wire_type == codec.LENGTH:
                refs: list[int] = []
                pos = 0
                while pos < len(value):
                    ref, pos = codec.decode_varint(value, pos)
                    refs.append(ref)
                if len(refs) % 2:
                    raise ValueError("odd labels_refs count")
                for i in range(0, len(refs), 2):
                    labels[symbol(refs[i])] = symbol(refs[i + 1])
            elif field == 2 and wire_type == codec.LENGTH:
                sample_value, sample_ts = 0.0, 0
                for sf, sw, sv in codec.iter_fields(value):
                    if sf == 1 and sw == codec.FIXED64:
                        sample_value = float(sv)
                    elif sf == 2 and sw == codec.VARINT:
                        sample_ts = codec.signed(sv)
                samples.append((sample_value, sample_ts))
            elif field == 5 and wire_type == codec.LENGTH:
                for mf, mw, mv in codec.iter_fields(value):
                    if mf == 1 and mw == codec.VARINT:
                        metadata["type"] = mv
                    elif mf == 3 and mw == codec.VARINT:
                        metadata["help"] = symbol(mv)
        out.append((labels, samples, metadata))
    return out
