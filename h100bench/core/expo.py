"""A plain parser of the Prometheus text format (0.0.4) and OpenMetrics
1.0, written for the benchmark and independent of the program's own.

Standard library only: the scraper process imports it and never torch.
"""

from __future__ import annotations

import gzip
import math
import re

_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL = re.compile(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*(,?)')
_UNESCAPE = {"\\\\": "\\", '\\"': '"', "\\n": "\n"}


class ExpositionError(ValueError):
    """A body that is not valid exposition text."""


def _unescape(value: str) -> str:
    return re.sub(r'\\[\\"n]', lambda m: _UNESCAPE[m[0]], value)


def _number(text: str) -> float:
    lowered = text.lower()
    if lowered in ("+inf", "inf"):
        return math.inf
    if lowered == "-inf":
        return -math.inf
    if lowered == "nan":
        return math.nan
    return float(text)


def parse(text: str) -> list[tuple[str, dict[str, str], float]]:
    """Every sample of ``text`` as (name, labels, value). Comments and
    ``# EOF`` are skipped; a malformed line raises ``ExpositionError``."""
    samples = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line or line.startswith("#"):
            continue
        m = _NAME.match(line)
        if not m:
            raise ExpositionError(f"line {lineno}: no metric name: {line!r}")
        name, pos = m[0], m.end()
        labels: dict[str, str] = {}
        if pos < len(line) and line[pos] == "{":
            pos += 1
            while True:
                if line[pos:pos + 1] == "}":
                    pos += 1
                    break
                lm = _LABEL.match(line, pos)
                if not lm:
                    raise ExpositionError(f"line {lineno}: bad labels: {line!r}")
                labels[lm[1]] = _unescape(lm[2])
                pos = lm.end()
                if not lm[3] and line[pos:pos + 1] != "}":
                    raise ExpositionError(f"line {lineno}: bad labels: {line!r}")
        rest = line[pos:].split("#", 1)[0].split()
        if not rest or len(rest) > 2:
            raise ExpositionError(f"line {lineno}: bad value: {line!r}")
        try:
            value = _number(rest[0])
        except ValueError:
            raise ExpositionError(f"line {lineno}: bad value: {line!r}") from None
        samples.append((name, labels, value))
    return samples


def decode(body: bytes, content_encoding: str) -> str:
    """The body as text, gunzipped when the response says gzip."""
    if content_encoding.strip().lower() == "gzip":
        body = gzip.decompress(body)
    return body.decode("utf-8")


def serves_card(samples, family: str, labels: dict[str, str]) -> bool:
    """True when ``family`` has a finite, positive sample carrying every
    label of ``labels``."""
    for name, have, value in samples:
        if (name == family and value > 0 and math.isfinite(value)
                and all(have.get(k) == v for k, v in labels.items())):
            return True
    return False


def total(samples, family: str, labels: dict[str, str] | None = None) -> float | None:
    """Sum of ``family``'s samples that carry ``labels``; None when there
    is none."""
    found = [value for name, have, value in samples
             if name == family
             and all(have.get(k) == v for k, v in (labels or {}).items())]
    return sum(found) if found else None
