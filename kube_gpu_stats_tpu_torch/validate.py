"""Exposition-contract validator: `python -m kube_gpu_stats_tpu_torch
validate <url-or-file>` (or `python -m kube_gpu_stats_tpu_torch.validate`).

The port's copy of the reference's validator
(``kube_gpu_stats_tpu/validate.py``), over the port's own ``schema`` and
``workers``. Checks a live scrape (or saved .prom file) against the
schema contract (schema.py + docs/UNIFIED_SCHEMA.md): every
accelerator_* series carries the full label set, types/ranges are sane,
and — given two scrapes — counters are monotone. Exit code 0 =
conformant, 1 = violations (printed one per line), 2 = usage/fetch
error. The hub, `top` and the push senders parse through it too.
"""

from __future__ import annotations

import functools
import re
import sys
import urllib.request
from typing import Iterable

from . import schema

_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)"
    r"(?:\s+(?P<timestamp>-?\d+))?$"  # optional trailing ms timestamp (0.0.4)
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

BOUNDED_MEMO_MAX = 65536


def bounded_memo(cache: dict, key, compute):
    """Shared bounded-memo idiom (this parser's label cache, the hub's
    dedup-key cache): look up, else compute and store; cleared WHOLESALE
    at the cap — churn that large means the memo isn't helping anyway.
    GIL-atomic operations only, so concurrent pool threads are safe
    (worst case both compute, one wins the store)."""
    value = cache.get(key)
    if value is None:
        if len(cache) >= BOUNDED_MEMO_MAX:
            cache.clear()
        value = compute()
        cache[key] = value
    return value


# Shared intern pools. A scrape's metric names and label sets are
# identical from refresh to refresh (only values change), so the hub
# re-tokenizes the same few thousand strings every cycle — the regex
# walk was the hottest line of a 64-worker refresh (profiled). Both
# pools store immutable objects and are bounded like every other memo:
#
# - _NAME_POOL: raw family-name substring -> validated interned str.
# - _LABEL_CACHE: raw label substring -> tuple of (name, value) pairs.
#   The POOLED tuple itself is what parse_exposition_interned hands
#   out, so merge keys built from it are pointer-equal across targets
#   and cycles; parse_exposition builds each caller a FRESH dict (a
#   10-item dict build is ~10x cheaper than the tokenizer walk), so
#   downstream mutation can't poison the pool.
_NAME_POOL: dict[str, str] = {}
_LABEL_CACHE: dict[str, tuple] = {}


def _parse_labels(raw: str) -> dict[str, str]:
    """Reference-parser label view: pure regex, no shared caches, so the
    oracle in the differential test cannot be contaminated by fast-path
    state."""
    return dict(_tokenize_labels_reference(raw))


def _tokenize_labels(raw: str) -> tuple:
    """Label pairs from the text inside ``{...}``: a split/scan
    tokenizer for the clean ``name="value",...`` grammar every real
    renderer emits, falling back to the reference regex findall the
    moment the input deviates (escapes, junk separators, malformed
    names) — so the fast path can only ever agree with the reference.
    Duplicate label names collapse last-wins (what dict() always did)
    so the pooled tuple and the dict view share one identity."""
    if "\\" in raw:
        return _tokenize_labels_reference(raw)
    pairs: list[tuple[str, str]] = []
    i, n = 0, len(raw)
    while i < n:
        eq = raw.find('="', i)
        if eq == -1:
            if raw[i:] != ",":  # lone trailing comma is harmless
                return _tokenize_labels_reference(raw)
            break
        name = raw[i:eq]
        if pairs:
            if not name.startswith(","):
                return _tokenize_labels_reference(raw)
            name = name[1:]
        end = raw.find('"', eq + 2)
        if end == -1 or not _LABEL_NAME_RE.match(name):
            return _tokenize_labels_reference(raw)
        pairs.append((name, raw[eq + 2:end]))
        i = end + 1
    if len(pairs) > 1 and len({name for name, _ in pairs}) != len(pairs):
        return tuple(dict(pairs).items())
    return tuple(pairs)


def _tokenize_labels_reference(raw: str) -> tuple:
    pairs = _LABEL_RE.findall(raw)
    if len(pairs) > 1 and len({name for name, _ in pairs}) != len(pairs):
        return tuple(dict(pairs).items())
    return tuple(pairs)

_RANGES = {
    schema.DUTY_CYCLE.name: (0.0, 100.0),
    schema.TENSORCORE_UTIL.name: (0.0, 100.0),
    schema.MEMORY_BANDWIDTH_UTIL.name: (0.0, 100.0),
    schema.DEVICE_UP.name: (0.0, 1.0),
    schema.TEMPERATURE.name: (-50.0, 150.0),
}

# Hub rollup families (slice_*) checked when validating a hub scrape:
# range sanity only — the label contract for slice_* is the spec's
# extra_labels, not the per-device base set.
_HUB_RANGES = {
    schema.HUB_TARGET_UP.name: (0.0, 1.0),
    schema.HUB_DUTY_MEAN.name: (0.0, 100.0),
    schema.HUB_DUTY_MIN.name: (0.0, 100.0),
    schema.HUB_DUTY_MAX.name: (0.0, 100.0),
    schema.HUB_STRAGGLER_RATIO.name: (0.0, 1.0),
}


_SPECIAL_VALUES = {"NaN": float("nan"), "+Inf": float("inf"),
                   "-Inf": float("-inf")}


def _intern_name(raw: str) -> str:
    """Validated, interned metric-family name (raises ValueError)."""
    if not _METRIC_NAME_RE.match(raw):
        raise ValueError(f"bad metric name {raw!r}")
    return sys.intern(raw)


def _is_timestamp(raw: str) -> bool:
    # isdecimal, not isdigit: the reference regex `-?\d+` matches exactly
    # the Unicode Nd category, which is isdecimal's definition; isdigit
    # additionally accepts superscripts, which the regex rejects.
    if raw.startswith("-"):
        raw = raw[1:]
    return raw.isdecimal()


def _parse_series(text: str, interned: bool) -> list:
    """Shared tokenizer core: slice out name/labels/value by structure
    (one find + one rfind per line) instead of running the series regex
    per line — the regex walk dominated hub parse cost at 64-worker
    fan-in. Semantics are pinned to parse_exposition_reference by the
    differential test; any label text the fast scan can't prove
    equivalent falls back to the reference regex inside
    _tokenize_labels."""
    out: list = []
    append = out.append
    name_pool = _NAME_POOL
    label_cache = _LABEL_CACHE
    specials = _SPECIAL_VALUES
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line[0] == "#":
            continue
        try:
            brace = line.find("{")
            if brace == -1:
                fields = line.split()
                name = fields[0]
                rest = fields[1:]
                raw_labels = ""
            else:
                close = line.rfind("}")
                if close < brace:
                    raise ValueError("unbalanced braces")
                name = line[:brace]
                raw_labels = line[brace + 1:close]
                tail = line[close + 1:]
                if tail and not tail[0].isspace():
                    raise ValueError("missing space after labels")
                rest = tail.split()
            if not rest or len(rest) > 2 or (
                    len(rest) == 2 and not _is_timestamp(rest[1])):
                raise ValueError("bad value/timestamp fields")
            name = name_pool.get(name) or bounded_memo(
                name_pool, name, lambda: _intern_name(name))
            labels = label_cache.get(raw_labels)
            if labels is None:
                labels = bounded_memo(label_cache, raw_labels,
                                      lambda: _tokenize_labels(raw_labels))
            raw = rest[0]
            value = specials.get(raw)
            if value is None:
                value = float(raw)
        except (ValueError, IndexError):
            raise ValueError(
                f"line {lineno}: unparseable series: {line!r}") from None
        append((name, dict(labels) if not interned else labels, value))
    return out


def parse_exposition(text: str) -> list[tuple[str, dict[str, str], float]]:
    """(name, labels, value) triples; raises ValueError on malformed
    lines. Differential-tested against parse_exposition_reference (the
    regex implementation this tokenizer replaced on the hot path)."""
    return _parse_series(text, interned=False)


def parse_exposition_interned(
        text: str) -> list[tuple[str, tuple[tuple[str, str], ...], float]]:
    """Like parse_exposition but labels come back as the POOLED label
    tuple instead of a fresh dict: tuples (and family names) are
    pointer-equal across targets and cycles, so the hub's merge keys
    and shape checks are identity comparisons, not re-hashing. Callers
    must treat the tuples as immutable shared state."""
    return _parse_series(text, interned=True)


def parse_exposition_reference(
        text: str) -> list[tuple[str, dict[str, str], float]]:
    """Reference implementation (the original per-line regex pair),
    kept as the semantic oracle for the fast tokenizer's differential
    test — not used on any hot path."""
    out = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        match = _SERIES_RE.match(line)
        if not match:
            raise ValueError(f"line {lineno}: unparseable series: {line!r}")
        labels = _parse_labels(match.group("labels") or "")
        raw = match.group("value")
        value = _SPECIAL_VALUES.get(raw)
        if value is None:
            value = float(raw)
        out.append((match.group("name"), labels, value))
    return out


def check(text: str, previous: str | None = None) -> list[str]:
    """Return violations (empty = conformant)."""
    problems: list[str] = []
    try:
        series = parse_exposition(text)
    except ValueError as exc:
        return [str(exc)]

    specs = {m.name: m for m in schema.ALL_METRICS}
    # Histogram families render as <name>_bucket/_sum/_count; map each
    # rendered name back to its spec. Workload histograms are global
    # (schema.WORKLOAD_HISTOGRAMS): no per-device base labels, only "le".
    hist_suffix: dict[str, tuple[schema.MetricSpec, bool]] = {}
    for m in schema.ALL_METRICS:
        if m.type is schema.MetricType.HISTOGRAM:
            hist_suffix[f"{m.name}_bucket"] = (m, True)
            hist_suffix[f"{m.name}_sum"] = (m, False)
            hist_suffix[f"{m.name}_count"] = (m, False)
    required = set(schema.ALL_BASE_LABELS)
    seen_identities: set[tuple] = set()

    def common_checks(name, labels, value, ranges) -> None:
        """Range + duplicate-identity checks shared by every branch."""
        lo_hi = ranges.get(name)
        if lo_hi and not (lo_hi[0] <= value <= lo_hi[1]):
            problems.append(f"{name}{labels}: value {value} outside {lo_hi}")
        identity = (name, tuple(sorted(labels.items())))
        if identity in seen_identities:
            problems.append(f"{name}: duplicate series {labels}")
        seen_identities.add(identity)

    for name, labels, value in series:
        if name.startswith("accelerator_"):
            hist = hist_suffix.get(name)
            if hist is not None:
                spec, is_bucket = hist
                allowed = set(spec.extra_labels) | ({"le"} if is_bucket else set())
                unexpected = set(labels) - allowed
                if unexpected:
                    problems.append(
                        f"{name}: unexpected labels {sorted(unexpected)}")
                common_checks(name, labels, value, {})
                continue
            spec = specs.get(name)
            if spec is None or spec.type is schema.MetricType.HISTOGRAM:
                problems.append(f"{name}: not in the accelerator_* contract")
                continue
            missing = required - set(labels)
            if missing:
                problems.append(
                    f"{name}: missing labels {sorted(missing)} (empty-string "
                    f"values are required, absent labels are not allowed)"
                )
            # stale="true" is the optional degradation marker (poll.py /
            # resilience.py): per-device GAUGES carry it while an open
            # breaker keeps the chip/mapping on last-good data, and it
            # vanishes on recovery. Counters never carry it (a label
            # flip mid-outage would blind increase()) and neither does
            # accelerator_up (the health contract keeps one identity) —
            # the validator enforces that, not just the emitter.
            extra_expected = set(spec.extra_labels)
            if (spec.type is schema.MetricType.GAUGE
                    and spec.name != schema.DEVICE_UP.name):
                extra_expected.add("stale")
            extra_present = set(labels) - required
            if not extra_expected >= extra_present:
                problems.append(
                    f"{name}: unexpected labels "
                    f"{sorted(extra_present - extra_expected)}"
                )
            if spec.type is schema.MetricType.COUNTER and value < 0:
                problems.append(f"{name}{labels}: negative counter")
            common_checks(name, labels, value, _RANGES)
        elif name.startswith("slice_"):
            # Hub rollups: range sanity + labels from the spec's
            # extra_labels (no per-device base set on aggregates).
            spec = specs.get(name)
            if spec is None:
                problems.append(
                    f"{name}: not in the slice_* rollup contract")
                continue
            unexpected = set(labels) - set(spec.extra_labels)
            if unexpected:
                problems.append(
                    f"{name}: unexpected labels {sorted(unexpected)}")
            missing = set(spec.extra_labels) - set(labels)
            if missing:
                # The hub always emits its labels; an unlabeled rollup
                # breaks every `by (slice)` join and the shipped alerts.
                problems.append(
                    f"{name}: missing labels {sorted(missing)}")
            common_checks(name, labels, value, _HUB_RANGES)

    if previous is not None:
        problems.extend(_check_monotone(previous, text, specs))
    return problems


def _check_monotone(before: str, after: str, specs) -> Iterable[str]:
    # Histogram _bucket/_count series are cumulative too — a backwards
    # step there is the same counter-reset bug class.
    monotone_names = {
        name for name, spec in specs.items()
        if spec.type is schema.MetricType.COUNTER
    } | {
        f"{spec.name}{suffix}"
        for spec in specs.values()
        if spec.type is schema.MetricType.HISTOGRAM
        for suffix in ("_bucket", "_count")
    }

    def counters(text):
        return {
            (name, tuple(sorted(labels.items()))): value
            for name, labels, value in parse_exposition(text)
            if name in monotone_names
        }

    earlier = counters(before)
    problems = []
    for key, value in counters(after).items():
        if key in earlier and value < earlier[key]:
            problems.append(
                f"{key[0]}: counter went backwards "
                f"({earlier[key]} -> {value}) for {dict(key[1])}"
            )
    return problems


def retry_after_seconds(headers, default: float = 1.0,
                        cap: float = 300.0) -> float:
    """Seconds from a response's ``Retry-After`` header (delta-ingest
    shed responses, scrape-storm 503s). Only the delta-seconds form is
    parsed — an HTTP-date (the other RFC 9110 form) or garbage falls
    back to ``default`` rather than raising: a hostile or buggy server
    must not crash the publisher, and ``cap`` bounds how long one bad
    header can silence a push loop."""
    raw = headers.get("Retry-After", "") if headers is not None else ""
    try:
        seconds = float(raw)
    except (TypeError, ValueError):
        return default
    if not (seconds >= 0.0):  # NaN falls through to the default too
        return default
    return min(seconds, cap)


def classify_push_status(code: int) -> str:
    """Retry classification for push-sender HTTP responses, shared by
    the durable remote-write shards and doctor's receiver probe:
    'ok' (2xx — the receiver took it), 'retryable' (429, any 5xx, and
    3xx — the no-redirect openers surface redirects as failures; the
    network or the receiver's load is the problem, the payload is
    fine), or 'poison' (any other 4xx — the PAYLOAD is wrong, and
    retrying it would wedge a durable queue forever behind one bad
    request; park it and move on). 415 is returned as 'poison' here —
    the remote-write 2.0 downgrade special-case is the caller's
    protocol knowledge, not retry classification."""
    if 200 <= code < 300:
        return "ok"
    if code == 429 or code >= 500 or 300 <= code < 400:
        return "retryable"
    return "poison"


def auth_headers(bearer_token_file: str = "", username: str = "",
                 password_file: str = "") -> dict:
    """Authorization header from file-backed credentials, re-read per
    call so rotations apply without a restart. Unreadable files log and
    return {} — the scrape proceeds unauthenticated and the hardened
    target's 401 is a visible per-target failure, never a crash."""
    import base64
    import logging

    try:
        if bearer_token_file:
            with open(bearer_token_file, encoding="utf-8") as handle:
                return {"Authorization": "Bearer " + handle.read().strip()}
        if username:
            with open(password_file, encoding="utf-8") as handle:
                password = handle.read().strip()
            token = base64.b64encode(
                f"{username}:{password}".encode()).decode()
            return {"Authorization": "Basic " + token}
    except (OSError, UnicodeDecodeError, ValueError) as exc:
        # ValueError/UnicodeDecodeError: a rotation mid-write can leave
        # truncated or non-UTF-8 bytes — same contract as a missing file.
        logging.getLogger(__name__).warning(
            "credential file unreadable: %s", exc)
    return {}


# Response-size ceiling for fetched expositions. A real 256-chip node
# renders ~tens of KB; 64 MB is three orders of magnitude past any
# legitimate exposition, while an endless/misdirected response (wrong
# port, a misbehaving proxy streaming forever) must not OOM a hub or a
# long-running top.
MAX_EXPOSITION_BYTES = 64 << 20


def fetch_exposition(target: str, timeout: float = 10.0,
                     headers: dict | None = None,
                     ca_file: str = "",
                     insecure_tls: bool = False,
                     max_bytes: int = MAX_EXPOSITION_BYTES) -> str:
    """Read a scrape target: http(s) URL or a saved .prom file path.
    Shared by this validator, the `top` view, and the hub. ``headers``
    ride the request (Authorization for hardened exporters — redirects
    are refused for authed requests so the credential can never be
    forwarded to a cross-origin Location); ``ca_file`` verifies a
    private CA; ``insecure_tls`` skips verification (dev slices with
    self-signed certs — the scraped data is telemetry, but prefer
    ca_file)."""
    if target.startswith(("http://", "https://")):
        request = urllib.request.Request(target, headers=headers or {})
        opener = _opener(
            target.startswith("https://"), ca_file, insecure_tls,
            # Case-insensitive: urllib capitalizes header keys when
            # SENDING, so a lowercase "authorization" would ride the
            # request while a case-sensitive check here skipped the
            # redirect refusal that protects it.
            bool(headers) and any(k.lower() == "authorization"
                                  for k in headers))
        with opener.open(request, timeout=timeout) as resp:
            body = resp.read(max_bytes + 1)
            if len(body) > max_bytes:
                raise ValueError(
                    f"response exceeds {max_bytes} bytes — not a metrics "
                    f"endpoint?")
            return body.decode()
    with open(target) as f:
        return f.read()


def add_fetch_arguments(parser) -> None:
    """Scrape-client options shared by the `top` and `validate` CLIs so
    they can talk to hardened exporters (the hub has its own --target-*
    spellings of the same options)."""
    parser.add_argument("--auth-username", default="",
                        help="basic-auth username for the target(s)")
    parser.add_argument("--auth-password-file", default="",
                        help="file holding the basic-auth password "
                             "(re-read per fetch)")
    parser.add_argument("--bearer-token-file", default="",
                        help="file holding a bearer token (re-read per "
                             "fetch)")
    parser.add_argument("--ca-file", default="",
                        help="CA bundle verifying the targets' TLS certs")
    parser.add_argument("--insecure-tls", action="store_true",
                        help="skip TLS verification (prefer --ca-file)")


def fetch_options(args, prefix: str = "") -> dict:
    """fetch_exposition kwargs from add_fetch_arguments flags; raises
    ValueError on conflicting flags. ``prefix`` maps differently-spelled
    argparse attributes onto the same semantics (the hub's ``target_``
    flags) so the conflict rules exist once. Call per fetch round —
    credential files are re-read so rotations apply to long-running
    views."""
    def get(name: str):
        return getattr(args, prefix + name)

    def flag(name: str) -> str:
        return "--" + (prefix + name).replace("_", "-")

    if bool(get("auth_username")) != bool(get("auth_password_file")):
        raise ValueError(f"{flag('auth_username')} and "
                         f"{flag('auth_password_file')} must be set "
                         f"together")
    if get("bearer_token_file") and get("auth_username"):
        raise ValueError(f"{flag('bearer_token_file')} and "
                         f"{flag('auth_username')} are mutually exclusive")
    if get("ca_file") and get("insecure_tls"):
        raise ValueError(f"{flag('ca_file')} and {flag('insecure_tls')} "
                         f"are mutually exclusive")
    headers = None
    if get("auth_username") or get("bearer_token_file"):
        headers = auth_headers(bearer_token_file=get("bearer_token_file"),
                               username=get("auth_username"),
                               password_file=get("auth_password_file"))
    return {"headers": headers, "ca_file": get("ca_file"),
            "insecure_tls": get("insecure_tls")}


@functools.lru_cache(maxsize=16)
def _opener(https: bool, ca_file: str, insecure_tls: bool,
            authed: bool):
    """Opener cached per (scheme, TLS config, auth) — measured 26 ms to
    build fresh (the default HTTPSHandler loads the system CA bundle
    from disk each construction) vs 0.7 ms to reuse, which dominated a
    64-target hub refresh 40x. OpenerDirector.open is safe for this
    concurrent reuse (same contract as workers.push_opener)."""
    handlers = []
    if https and (insecure_tls or ca_file):
        handlers.append(urllib.request.HTTPSHandler(
            context=_tls_context(ca_file, insecure_tls)))
    if authed:
        from .workers import NoRedirectHandler

        handlers.append(NoRedirectHandler())
    return urllib.request.build_opener(*handlers)


@functools.lru_cache(maxsize=8)
def _tls_context(ca_file: str, insecure_tls: bool):
    """Client TLS context, cached per (ca_file, insecure) — parsing the
    CA bundle per fetch would put file IO + X.509 parsing on the hub's
    per-target refresh path. Cached for the process lifetime: CA bundle
    rotation needs a restart (unlike the per-refresh credential files)."""
    import ssl

    if insecure_tls:
        context = ssl.create_default_context()
        context.check_hostname = False
        context.verify_mode = ssl.CERT_NONE
        return context
    return ssl.create_default_context(cafile=ca_file)


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="kube_gpu_stats_tpu_torch validate",
        description="check a scrape against the accelerator_* contract")
    parser.add_argument("target",
                        help="http(s)://host:9400/metrics or file.prom")
    parser.add_argument("--two-scrapes", action="store_true",
                        help="scrape twice and check counter monotonicity")
    add_fetch_arguments(parser)
    try:
        args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    except SystemExit as exc:
        # Preserve the documented contract: usage errors exit 2
        # (argparse already uses 2; --help uses 0).
        return int(exc.code or 0)
    target = args.target
    try:
        options = fetch_options(args)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    try:
        first = fetch_exposition(target, **options)
        previous = None
        if args.two_scrapes:
            import time

            previous = first
            time.sleep(1.5)
            first = fetch_exposition(target, **fetch_options(args))
    except (OSError, ValueError) as exc:
        # ValueError: the response-size cap — same "this isn't a usable
        # metrics endpoint" class as a connection failure.
        print(f"fetch failed: {exc}", file=sys.stderr)
        return 2
    problems = check(first, previous)
    for problem in problems:
        print(problem)
    if not problems:
        count = sum(1 for line in first.splitlines()
                    if line and not line.startswith("#"))
        print(f"ok: {count} series conform to the accelerator_* contract")
    return 1 if problems else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
