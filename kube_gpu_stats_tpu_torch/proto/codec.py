"""Protobuf wire-format decoding (proto3 subset).

The decode half of the reference's codec: varint (0), 64-bit fixed (1),
length-delimited (2) and 32-bit fixed (5). Unknown fields are yielded and
skipped by the callers, which is what makes the client tolerant of
server-side proto evolution.
"""

from __future__ import annotations

import struct
from typing import Iterator

VARINT = 0
FIXED64 = 1
LENGTH = 2
FIXED32 = 5


def decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    try:
        byte = data[pos]
    except IndexError:
        raise ValueError("truncated varint") from None
    if not byte & 0x80:  # hot path: single-byte varint
        return byte, pos + 1
    result = byte & 0x7F
    shift = 7
    pos += 1
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            # Truncate to 64 bits like standard protobuf parsers.
            return result & 0xFFFFFFFFFFFFFFFF, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def iter_fields(data: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, raw_value); callers ignore field
    numbers they don't know."""
    pos = 0
    while pos < len(data):
        key, pos = decode_varint(data, pos)
        field, wire_type = key >> 3, key & 0x07
        if wire_type == VARINT:
            value, pos = decode_varint(data, pos)
        elif wire_type == FIXED64:
            if pos + 8 > len(data):
                raise ValueError("truncated fixed64")
            value = struct.unpack_from("<d", data, pos)[0]
            pos += 8
        elif wire_type == LENGTH:
            length, pos = decode_varint(data, pos)
            if pos + length > len(data):
                raise ValueError("truncated length-delimited field")
            value = data[pos : pos + length]
            pos += length
        elif wire_type == FIXED32:
            if pos + 4 > len(data):
                raise ValueError("truncated fixed32")
            value = struct.unpack_from("<f", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field, wire_type, value
