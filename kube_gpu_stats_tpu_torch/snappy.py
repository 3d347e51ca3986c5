"""Snappy block-format codec (pure Python, no third-party dependency).

The port's copy of the reference's codec. ``decompress`` runs the host
extension's decoder (``native/wirefast.cc`` ``snappy_uncompress``) unless
the process chose the Python paths (``native.use_python_paths``);
``_decompress_py`` is the readable decoder it matches verdict for verdict
and error message for error message, and stays as its oracle.

Prometheus remote_write mandates snappy block compression of the protobuf
WriteRequest body; python-snappy isn't in this environment and pulling a
C dependency for a 1 Hz ~50 KB payload is not worth a supply chain, so
this implements the snappy format directly:

    https://github.com/google/snappy/blob/main/format_description.txt

- ``compress``: greedy hash-table matcher (the reference algorithm's
  shape) emitting literals + copies with 1- or 2-byte offsets. Any
  conformant decoder (the one in every remote-write receiver) accepts it.
- ``decompress``: full decoder for all element types — used by the delta
  frame decoder, the spill queue and the test receiver to round-trip,
  and kept strict (a malformed stream raises ValueError, never reads out
  of bounds).
"""

from __future__ import annotations

from . import native

_MIN_MATCH = 4
_MAX_COPY_LEN = 64
_MAX_OFFSET = 65535  # 2-byte-offset copies; keeps the matcher windowed



def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _literal(data: bytes, start: int, end: int, out: bytearray) -> None:
    length = end - start
    while length > 0:
        chunk = min(length, 0x10000)  # 4-byte length tag caps at 65536
        n = chunk - 1
        if n < 60:
            out.append(n << 2)
        elif n < 0x100:
            out.append(60 << 2)
            out.append(n)
        else:
            out.append(61 << 2)
            out += n.to_bytes(2, "little")
        out += data[start:start + chunk]
        start += chunk
        length -= chunk


def compress(data: bytes) -> bytes:
    """Snappy block-format compression of ``data``."""
    out = bytearray(_varint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table: dict[int, int] = {}
    pos = 0
    literal_start = 0
    # Greedy scan: hash every 4-byte window; on a match within the offset
    # window, extend it maximally and emit pending literal + copies.
    while pos + _MIN_MATCH <= n:
        key = int.from_bytes(data[pos:pos + _MIN_MATCH], "little")
        candidate = table.get(key)
        table[key] = pos
        if (candidate is None or pos - candidate > _MAX_OFFSET
                or data[candidate:candidate + _MIN_MATCH]
                != data[pos:pos + _MIN_MATCH]):
            pos += 1
            continue
        if literal_start < pos:
            _literal(data, literal_start, pos, out)
        offset = pos - candidate
        match_len = _MIN_MATCH
        limit = n - pos
        while (match_len < limit
               and data[candidate + match_len] == data[pos + match_len]):
            match_len += 1
        pos += match_len
        literal_start = pos
        # Emit as one or more copy elements (each 4..64 bytes long). Avoid
        # leaving a sub-4-byte tail that no copy element could encode.
        while match_len > 0:
            chunk = min(match_len, _MAX_COPY_LEN)
            if match_len - chunk in (1, 2, 3) and chunk > _MIN_MATCH:
                chunk = match_len - _MIN_MATCH  # rebalance the tail
            if 4 <= chunk <= 11 and offset < 2048:
                out.append(0b01 | ((chunk - 4) << 2) | ((offset >> 8) << 5))
                out.append(offset & 0xFF)
            else:
                out.append(0b10 | ((chunk - 1) << 2))
                out += offset.to_bytes(2, "little")
            match_len -= chunk
    if literal_start < n:
        _literal(data, literal_start, n, out)
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Strict snappy block-format decoder: a malformed stream raises
    ValueError and never reads out of bounds. The extension's decoder
    when the process runs the fast paths (the delta ingest decompresses
    every pushed frame), else :func:`_decompress_py`."""
    module = native.fast_path()
    if module is not None:
        return module.snappy_uncompress(data)
    return _decompress_py(data)


def _decompress_py(data: bytes) -> bytes:
    """The pure-Python decoder (see :func:`decompress`)."""
    # Preamble: uncompressed length varint.
    expected = 0
    shift = 0
    pos = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated snappy preamble")
        byte = data[pos]
        pos += 1
        expected |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
        if shift > 32:
            raise ValueError("snappy length varint too long")
    if expected > (1 << 31):
        # The extension's cap (and message), which allocates the
        # declared size upfront: a >2 GiB declaration is rejected at the
        # preamble on both paths. No legitimate caller is near this —
        # delta frames are capped at 64 MiB before decompressing, and
        # remote_write payloads are ~MBs.
        raise ValueError("snappy declared length too large")
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0b11
        if kind == 0b00:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59  # 60..63 -> 1..4 length bytes
                if pos + extra > n:
                    raise ValueError("truncated literal length")
                length = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > n:
                raise ValueError("truncated literal body")
            if len(out) + length > expected:
                # Same bound as copies: literals are input-limited, but
                # the check keeps the "never exceed the preamble" rule in
                # one consistent place.
                raise ValueError("snappy output exceeds declared length")
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 0b01:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x07) + 4
            if pos >= n:
                raise ValueError("truncated copy-1 offset")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 0b10:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > n:
                raise ValueError("truncated copy-2 offset")
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > n:
                raise ValueError("truncated copy-4 offset")
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("copy offset out of range")
        if len(out) + length > expected:
            # Bound BEFORE materializing: a tiny crafted stream of RLE
            # copies declaring a small preamble must not expand without
            # limit before the final length check (decompression bomb).
            raise ValueError("snappy output exceeds declared length")
        # Copies may overlap their own output (RLE-style); byte-by-byte
        # semantics are the spec'd behavior.
        start = len(out) - offset
        for i in range(length):
            out.append(out[start + i])
    if len(out) != expected:
        raise ValueError(
            f"snappy length mismatch: preamble {expected}, got {len(out)}"
        )
    return bytes(out)
