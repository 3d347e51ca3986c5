"""Conditional-read helper of the exposition path.

The port keeps only ``etag_match`` of the reference's history module: the
``If-None-Match`` test behind ``/metrics``'s 304 answer.
"""

from __future__ import annotations


def etag_match(header: str, etag: str) -> bool:
    """True when an If-None-Match header names ``etag`` (or ``*``).
    W/ prefixes compare as their opaque tag: for a 304 the weak
    comparison is the correct one (RFC 9110 §13.1.2)."""
    header = header.strip()
    if not header:
        return False
    if header == "*":
        return True
    for token in header.split(","):
        token = token.strip()
        if token.startswith("W/"):
            token = token[2:]
        if token == etag:
            return True
    return False
