"""Node preflight and diagnosis for H100 nodes:
``python -m kube_gpu_stats_tpu_torch doctor``.

The port's counterpart of the reference's ``doctor.py``: one bounded pass
over every dependency the exporter has — the NVIDIA driver through NVML,
kubelet attribution sources, topology labels — plus a short measured poll
(5 ticks, p50 against the configured deadline) through the production
loop. Made for ``kubectl exec <pod> -- python -m kube_gpu_stats_tpu_torch
doctor`` on a misbehaving node and for initContainer-style preflight.

Accepts the exporter's own flags (the same config surface) plus:
  --json         machine-readable output
  --url TARGET   also scrape TARGET (URL or .prom file) and check it
                 against the accelerator_* exposition contract, and read
                 the running exporter's breaker state off it
  --trace        pull the RUNNING daemon's flight recorder (/debug/ticks
                 + /debug/events) and print a "last slow tick"
                 post-mortem: worst phase, the responsible device, and
                 co-occurring journal events. Uses the --url target's
                 server (default http://127.0.0.1:<--listen-port>)
  --host         read the RUNNING daemon's /debug/host snapshot and
                 summarize the host side: PSI pressure, CPU thermal
                 throttle, NIC drops, pod cgroups, eBPF availability.
                 Same server as --trace
  --energy       pull the RUNNING daemon's /debug/energy governance
                 digest (per-pod joules + burst coverage) and verify its
                 HMAC-SHA256 signature with the locally configured
                 --energy-audit-key. FAIL on a tampered/mismatched
                 digest, WARN when either side runs unsigned. Same
                 server as --trace
  --stores       pull the RUNNING daemon's /debug/stores and summarize
                 every disk-backed store's durability state (degraded
                 stores with reason/errno, records that lost
                 durability), the accept loop's fd fence and the
                 supervisor's thread restarts. Same server as --trace

  --egress       read the RUNNING daemon's /debug/egress and summarize
                 the push senders: spill depth/age/loss, the durable
                 remote-write shards' WAL/lag/parked state, and which
                 sender's link is down. Same server as --trace
  --skew         read the RUNNING daemon's /debug/skew: this build's
                 wire-protocol range, the delta publisher's negotiation
                 with its hub, refusals (426) and downgrades, and
                 quarantined persisted formats. Same server as --trace;
                 against a hub, its ingest's fleet version census
  --cardinality  read a RUNNING hub's /debug/cardinality: live series
                 against the limits, clamped sources, sheds, evictions
                 and the largest sources. Uses the --url target's server
                 (default http://127.0.0.1:9401, the hub's port)

With --remote-write-url set, a ``remote-write`` row probes the receiver
with an empty write request.

  --fleet        read a RUNNING hub's fleet lens (/debug/fleet) and
                 print the post-mortem: the worst node with its phase
                 and blame, every anomalous target with its anomaly
                 kinds (joined with host pressure on the same node),
                 a suspect link, and the SLO burn windows. A target
                 that itself answers /debug/fleet is a leaf hub, and
                 its own post-mortem is folded in. Hub fallback like
                 --cardinality
  --efficiency   read a RUNNING hub's /debug/efficiency attestation,
                 verify its HMAC with the local --energy-audit-key (OK
                 verified, FAIL on tamper or a wrong key, WARN with no
                 key) and name the pods wasting cards now. Hub fallback
                 like --cardinality
  --at TIME      with --fleet and/or --efficiency: replay the verdict
                 from the hub's history ring at TIME (unix seconds, or
                 an ago-offset like 600, 10m, 2h) instead of the live
                 lens

Exit code: 0 = no failures (warns allowed), 1 = at least one failure,
2 = usage error. Every probe is time-bounded; the doctor never hangs on a
wedged driver. Nothing here imports torch: the one row that asks about
CUDA (``embedded``) asks a bounded subprocess.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Callable, Sequence

from .config import Config, from_args

OK, WARN, FAIL, SKIP = "ok", "warn", "fail", "skip"
_ORDER = {FAIL: 0, WARN: 1, OK: 2, SKIP: 3}


@dataclasses.dataclass
class CheckResult:
    name: str
    status: str  # ok | warn | fail | skip
    detail: str
    # Structured payload for --json consumers. Absent keys mean "nothing
    # to report".
    data: dict = dataclasses.field(default_factory=dict)


def _result(name: str, status: str, detail: str,
            data: dict | None = None) -> CheckResult:
    return CheckResult(name, status, detail, data or {})


# -- individual probes (each bounded, each returns exactly one result) -------

def _nvml_binding():
    """The NVML binding the ``nvml`` row opens (tests substitute
    ``testing.fake_nvml.FakeNvml``)."""
    from .native.nvml import Nvml

    return Nvml()


def check_nvml(cfg: Config) -> CheckResult:
    """The device backend's row: NVML loaded and initialised, the driver
    and CUDA driver versions, and per card its index, name, UUID and
    minor number. FAIL when ``--backend nvml`` is named and NVML cannot
    load or initialise (the daemon would exit 1); WARN under ``auto``
    (the daemon would serve the null backend).

    The row opens its own NVML reference and closes it: ``nvmlInit`` and
    ``nvmlShutdown`` count references per process, so a daemon in the
    same process keeps its own."""
    from .native.nvml import NVML_ERROR_LIBRARY_NOT_FOUND, NvmlError

    if cfg.backend in ("mock", "null"):
        return _result("nvml", SKIP, f"backend={cfg.backend}: NVML not used")
    bad = FAIL if cfg.backend == "nvml" else WARN
    consequence = ("--backend nvml cannot start" if bad is FAIL
                   else "--backend auto would serve the null backend")
    nvml = _nvml_binding()
    try:
        nvml.init()
    except NvmlError as exc:
        loaded = exc.code != NVML_ERROR_LIBRARY_NOT_FOUND
        step = "nvmlInit_v2 failed" if loaded else "library not loaded"
        return _result("nvml", bad, f"{step}: {exc} — {consequence}",
                       data={"loaded": loaded, "init": False,
                             "error": str(exc), "code": exc.code})
    try:
        driver = nvml.driver_version()
        cuda = nvml.cuda_driver_version()
        devices = []
        for index in range(nvml.device_count()):
            handle = nvml.handle(index)
            devices.append({"index": index, "name": nvml.name(handle),
                            "uuid": nvml.uuid(handle),
                            "minor": nvml.minor_number(handle)})
    except NvmlError as exc:
        return _result("nvml", bad,
                       f"NVML initialised, but enumeration failed: {exc} "
                       f"— {consequence}",
                       data={"loaded": True, "init": True,
                             "error": str(exc), "code": exc.code})
    finally:
        try:
            nvml.shutdown()
        except NvmlError:
            pass
    data = {"loaded": True, "init": True, "driver_version": driver,
            "cuda_driver_version": cuda, "device_count": len(devices),
            "devices": devices}
    versions = f"driver {driver}, CUDA {cuda // 1000}.{cuda % 1000 // 10}"
    if not devices:
        return _result("nvml", WARN,
                       f"NVML up ({versions}) but 0 cards — the exporter "
                       f"would serve self-metrics only", data=data)
    cards = "; ".join(
        f"{d['index']}: {d['name']} {d['uuid']} /dev/nvidia{d['minor']}"
        for d in devices)
    return _result("nvml", OK, f"{versions}; {len(devices)} card(s): {cards}",
                   data=data)


def check_attribution(cfg: Config) -> CheckResult:
    import os

    if cfg.attribution == "off":
        return _result("attribution", SKIP, "disabled by --attribution off")
    details = []
    status = WARN
    if cfg.attribution in ("auto", "podresources"):
        if os.path.exists(cfg.kubelet_socket):
            try:
                from .attribution.podresources import PodResourcesSource

                src = PodResourcesSource(cfg.kubelet_socket, rpc_timeout=2.0)
                try:
                    allocations = src.fetch()
                    allocatable = src.fetch_allocatable()
                finally:
                    src.close()
                details.append(
                    f"PodResources: {len(allocations)} allocated device(s), "
                    f"allocatable {dict(sorted(allocatable.items())) or '{}'}"
                )
                status = OK
            except Exception as exc:
                details.append(f"PodResources socket exists but List() "
                               f"failed: {exc}")
        else:
            details.append(f"no kubelet socket at {cfg.kubelet_socket} "
                           f"(normal outside Kubernetes)")
    if cfg.attribution in ("auto", "checkpoint") and status is not OK:
        try:
            from .attribution.checkpoint import CheckpointSource

            count = len(CheckpointSource(cfg.checkpoint_path).fetch())
            details.append(f"checkpoint file: {count} device(s)")
            status = OK
        except Exception as exc:
            details.append(f"checkpoint fallback unavailable: {exc}")
    return _result("attribution", status, "; ".join(details))


def check_topology(cfg: Config) -> CheckResult:
    from . import topology

    labels = topology.topology_labels()
    if any(labels.values()):
        return _result(
            "topology", OK,
            ", ".join(f"{k}={v or '(unset)'}" for k, v in sorted(labels.items())),
        )
    return _result(
        "topology", WARN,
        "no slice/worker/topology labels resolved from the environment; "
        "multi-host aggregation needs them (set KTS_SLICE/KTS_WORKER/"
        "KTS_TOPOLOGY)",
    )


def resilience_result(collector) -> CheckResult:
    """Breaker report for a collector after a short measured run: state,
    trip count, and last error per breaker. FAIL — the doctor exits
    non-zero — when any breaker is OPEN: collection through that edge is
    down right now, not blinking."""
    from . import resilience

    fn = getattr(collector, "breakers", None)
    breakers = fn() if callable(fn) else {}
    if not breakers:
        return _result("resilience", SKIP,
                       "no circuit breakers on this backend")
    parts: list[str] = []
    data: dict[str, dict] = {}
    worst = OK
    for name in sorted(breakers):
        breaker = breakers[name]
        last = (resilience.flatten_error(breaker.last_error)
                if breaker.last_error else "")
        parts.append(
            f"{name}: {breaker.state}, {breaker.trips_total} trip(s)"
            + (f", last error: {last}" if last else ""))
        data[name] = {"state": breaker.state,
                      "trips": breaker.trips_total,
                      "last_error": last}
        if breaker.state == resilience.OPEN:
            worst = FAIL
        elif breaker.state != resilience.CLOSED and worst is not FAIL:
            worst = WARN
        elif breaker.trips_total and worst is OK:
            worst = WARN
    return _result("resilience", worst, "; ".join(parts),
                   data={"breakers": data})


def check_poll(cfg: Config, ticks: int = 5) -> list[CheckResult]:
    """A short real collection run (``ticks`` ticks) through the
    production loop; reports the p50 tick duration against the configured
    deadline, plus a ``resilience`` row describing each circuit breaker's
    state after the run (exit non-zero when one is open)."""
    from .daemon import build_collector
    from .poll import PollLoop
    from .registry import Registry

    try:
        collector = build_collector(cfg)
    except Exception as exc:
        return [_result("poll", FAIL,
                        f"collector construction failed: {exc}")]
    loop = None
    try:
        registry = Registry()
        # Blocking: each tick joins its own reads, so the p50 is the
        # honest cost of a sampling round (the daemon pipelines them).
        loop = PollLoop(collector, registry, deadline=cfg.deadline,
                        pipeline_fetch=False)
        if not loop.devices:
            return [
                _result(
                    "poll", WARN,
                    f"backend={collector.name}: 0 devices — exporter "
                    f"would serve self-metrics only",
                ),
                resilience_result(collector),
            ]
        durations = []
        for _ in range(ticks):
            durations.append(loop.tick())
            # The ticks run back to back: a read that overran the
            # deadline gets the interval the daemon would give it, so
            # one slow read does not serve a healthy card down in every
            # tick after it (the reference's doctor does).
            loop.settle(cfg.interval)
        durations.sort()
        p50 = durations[len(durations) // 2] * 1000.0
        series = registry.snapshot().series
        accelerator = sum(
            1 for s in series if s.spec.name.startswith("accelerator_"))
        ups = sum(s.value for s in series if s.spec.name == "accelerator_up")
        status = OK if p50 <= cfg.deadline * 1000.0 else WARN
        return [
            _result(
                "poll", status,
                f"backend={collector.name}: {len(loop.devices)} device(s), "
                f"{int(ups)} up, {accelerator} accelerator series, tick p50 "
                f"{p50:.1f} ms (deadline {cfg.deadline * 1000.0:.0f} ms)",
                data={"devices": len(loop.devices), "up": int(ups),
                      "accelerator_series": accelerator, "p50_ms": p50},
            ),
            resilience_result(collector),
        ]
    except Exception as exc:
        return [_result("poll", FAIL, f"tick crashed: {exc}")]
    finally:
        if loop is not None:
            loop.stop()
        try:
            collector.close()
        except Exception:
            pass


def check_remote_write(cfg: Config) -> CheckResult:
    """Probe the configured remote-write receiver with an EMPTY
    WriteRequest (zero timeseries — nothing lands in storage): proves
    reachability, TLS, auth token, and content negotiation without
    polluting the receiver."""
    import urllib.error
    import urllib.request

    from . import snappy
    from .remote_write import build_headers

    # Probe with the protocol the daemon will actually use: a 2.0 config
    # must negotiate 2.0 here, or doctor proves the wrong content type.
    headers = build_headers(cfg.remote_write_bearer_token_file,
                            cfg.remote_write_protocol)
    if headers is None:
        return _result(
            "remote-write", FAIL,
            f"bearer token file {cfg.remote_write_bearer_token_file!r} "
            f"unreadable",
        )
    request = urllib.request.Request(
        cfg.remote_write_url, data=snappy.compress(b""), method="POST",
        headers=headers)
    try:
        with urllib.request.urlopen(request, timeout=5):
            pass
        return _result("remote-write", OK,
                       f"{cfg.remote_write_url}: receiver accepts writes")
    except urllib.error.HTTPError as exc:
        if exc.code == 400:
            # Many receivers reject an empty write with 400 — which still
            # proves endpoint, TLS, auth and content negotiation all work.
            return _result(
                "remote-write", OK,
                f"{cfg.remote_write_url}: receiver answered 400 to the "
                f"empty probe write (endpoint + auth OK)",
            )
        if exc.code in (401, 403):
            return _result(
                "remote-write", FAIL,
                f"{cfg.remote_write_url}: auth rejected (HTTP {exc.code}) "
                f"with the configured credentials",
            )
        if exc.code >= 500 or exc.code == 429:
            return _result(
                "remote-write", WARN,
                f"{cfg.remote_write_url}: receiver unhealthy "
                f"(HTTP {exc.code}); exporter will retry with backoff",
            )
        return _result("remote-write", FAIL,
                       f"{cfg.remote_write_url}: HTTP {exc.code}")
    except OSError as exc:
        # URLError wraps BOTH transient network failures (reason is an
        # OSError: refused/timeout/DNS) and permanent config errors
        # (reason is a str, e.g. "unknown url type" for a scheme-less
        # --remote-write-url). Only the former deserves "will retry".
        if isinstance(getattr(exc, "reason", None), str):
            return _result("remote-write", FAIL,
                           f"{cfg.remote_write_url}: {exc.reason}")
        return _result(
            "remote-write", WARN,
            f"{cfg.remote_write_url}: unreachable ({exc}); exporter will "
            f"retry with backoff",
        )
    except Exception as exc:
        # e.g. ValueError from a malformed URL that fails before urllib
        # wraps it: a config error retrying can never fix.
        return _result("remote-write", FAIL,
                       f"{cfg.remote_write_url}: {exc}")


def check_live_resilience(target: str,
                          text: str | None = None) -> CheckResult:
    """Read the RUNNING daemon's breaker state off its own exposition
    (kts_breaker_state). The ``resilience`` row probes a fresh collector,
    whose breakers start closed; the daemon that has been failing for
    hours carries its state here. FAIL (exit non-zero) when any live
    breaker is open."""
    from . import validate

    try:
        if text is None:
            text = validate.fetch_exposition(target)
        series = validate.parse_exposition(text)
    except Exception as exc:  # noqa: BLE001 - scrape row diagnoses this
        return _result("live-resilience", SKIP,
                       f"{target}: not scrapeable here ({exc}); see the "
                       f"scrape row")
    states = {
        labels.get("component", ""): value
        for name, labels, value in series if name == "kts_breaker_state"
    }
    if not states:
        return _result(
            "live-resilience", SKIP,
            f"{target}: no kts_breaker_state series (exporter predates "
            f"the resilience layer, or serves no breakers)")
    names = {0.0: "closed", 1.0: "half_open", 2.0: "open"}
    detail = "; ".join(
        f"{component}: {names.get(value, value)}"
        for component, value in sorted(states.items()))
    if any(value == 2.0 for value in states.values()):
        return _result(
            "live-resilience", FAIL,
            detail + " — the running exporter's breaker is open: "
                     "collection through that edge is down right now",
            data={"breakers": {c: names.get(v, str(v))
                               for c, v in states.items()}})
    worst = WARN if any(v == 1.0 for v in states.values()) else OK
    return _result("live-resilience", worst, detail,
                   data={"breakers": {c: names.get(v, str(v))
                                      for c, v in states.items()}})


def trace_base(url: str) -> str:
    """The server base for /debug/* from a --url scrape target."""
    base = url.rstrip("/")
    if base.endswith("/metrics"):
        base = base[: -len("/metrics")]
    return base


def _fetch_json(url: str, timeout: float = 5.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def trace_post_mortem(ticks: dict, events: list) -> tuple[str, dict]:
    """(detail line, data payload) for the slowest recorded tick: worst
    phase, the responsible device (the slowest attributed span the
    recorder pre-joined as ``blame``), and journal events that fired
    within ±2 ticks of it. Pure, so tests drive it on canned JSON;
    check_trace wraps it with the fetch and auth classification."""
    slowest = ticks.get("slowest") or []
    row = slowest[0]
    seq = row.get("seq")
    parts = [
        f"last slow tick: {row.get('kind', 'tick')} seq {seq} took "
        f"{row.get('dur_ms', 0.0):.1f} ms",
        f"worst phase {row.get('worst_phase')} "
        f"({row.get('worst_phase_ms', 0.0):.1f} ms)",
    ]
    blame = row.get("blame")
    if blame:
        attrs = ",".join(
            f"{key}={value}"
            for key, value in sorted((blame.get("attrs") or {}).items()))
        parts.append(f"responsible: {blame.get('span')}[{attrs}] "
                     f"{blame.get('dur_ms', 0.0):.1f} ms")
    nearby = [
        event for event in events
        if isinstance(seq, int) and isinstance(event.get("tick_seq"), int)
        and abs(event["tick_seq"] - seq) <= 2
    ]
    if nearby:
        parts.append("co-occurring events: " + "; ".join(
            f"[seq {event['tick_seq']}] {event.get('kind')}: "
            f"{event.get('detail')}" for event in nearby[:3]))
    dropped = ticks.get("dropped_spans_total", 0)
    if dropped:
        parts.append(f"{dropped} span(s) dropped — trace truncated")
    return "; ".join(parts), {"slowest": row, "events": nearby[:10]}


def check_trace(base: str) -> CheckResult:
    """--trace: read the RUNNING daemon's flight recorder and print the
    post-mortem. The short measured ``poll`` row probes a FRESH loop whose
    recorder starts empty; the daemon that had one slow tick an hour ago
    carries the evidence here."""
    import urllib.error

    try:
        ticks = _fetch_json(base + "/debug/ticks")
        events = _fetch_json(base + "/debug/events").get("events", [])
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "trace", WARN,
                f"{base}/debug/ticks requires authentication "
                f"(HTTP {exc.code}); the flight recorder sits behind the "
                f"exporter's basic-auth gate by design")
        if exc.code == 404:
            return _result(
                "trace", WARN,
                f"{base}: no /debug/ticks (exporter predates the flight "
                f"recorder, or this server has no tracer wired)")
        return _result("trace", FAIL, f"{base}/debug/ticks: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable daemon, bad JSON
        return _result("trace", FAIL,
                       f"{base}: flight recorder unreadable ({exc})")
    if not ticks.get("enabled", True):
        return _result(
            "trace", WARN,
            "tracing disabled on the daemon (--no-trace); no flight "
            "record to post-mortem")
    if not ticks.get("slowest"):
        return _result(
            "trace", WARN,
            f"no ticks recorded yet (current seq "
            f"{ticks.get('current_seq', 0)}); is the poll loop running?")
    detail, data = trace_post_mortem(ticks, events)
    return _result("trace", OK, detail, data=data)


def check_host(base: str) -> CheckResult:
    """--host: read the RUNNING daemon's /debug/host snapshot and
    summarize the host-side health picture (PSI pressure, IRQ/NIC rates,
    thermal throttle, per-pod cgroup stats, eBPF availability). Same
    live-vs-fresh split as --trace: the daemon that has been
    pressure-stalled for an hour carries the evidence, not a fresh
    probe."""
    import urllib.error

    try:
        payload = _fetch_json(base + "/debug/host")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "host", WARN,
                f"{base}/debug/host requires authentication "
                f"(HTTP {exc.code}); the host snapshot sits behind the "
                f"exporter's basic-auth gate by design")
        if exc.code == 404:
            return _result(
                "host", WARN,
                f"{base}: no /debug/host (exporter predates the host-"
                f"signals collector, or this server has none wired)")
        return _result("host", FAIL, f"{base}/debug/host: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable daemon, bad JSON
        return _result("host", FAIL,
                       f"{base}: host snapshot unreadable ({exc})")
    if not payload.get("enabled", True):
        return _result(
            "host", WARN,
            "host-signals collector disabled on the daemon "
            "(--no-host-stats); no host snapshot to read")
    if not payload.get("read_at"):
        return _result(
            "host", WARN,
            "no host snapshot read yet; is the poll loop running?")
    parts: list[str] = []
    status = OK
    pressure = payload.get("pressure") or {}
    hot = {key: value for key, value in pressure.items()
           if key.endswith("avg10") and value >= 5.0}
    if hot:
        status = WARN
        parts.append("pressure: " + ", ".join(
            f"{key}={value:g}%" for key, value in sorted(hot.items())))
    elif pressure:
        parts.append("pressure: all avg10 shares < 5%")
    else:
        parts.append("pressure: absent (pre-4.20 kernel?)")
    throttle_rate = payload.get("throttle_rate")
    if throttle_rate:
        status = WARN
        parts.append(f"CPU thermal throttle {throttle_rate:g}/s")
    drop_rate = payload.get("nic_drop_rate")
    if drop_rate:
        status = WARN
        parts.append(f"NIC drops {drop_rate:g}/s")
    pods = payload.get("pods") or {}
    parts.append(f"{len(pods)} pod cgroup(s)")
    ebpf = payload.get("ebpf") or {}
    if not ebpf.get("available", False):
        parts.append(f"eBPF runq source off "
                     f"({ebpf.get('reason', 'unavailable')})")
    errors = payload.get("errors") or {}
    if errors:
        status = WARN if status is OK else status
        parts.append("parse errors: " + ", ".join(
            f"{reason}={count}" for reason, count in sorted(errors.items())))
    return _result("host", status, "; ".join(parts),
                   data={"host": payload})


def check_energy(base: str, audit_key: str) -> CheckResult:
    """--energy: read the RUNNING daemon's /debug/energy governance
    digest and verify its HMAC with the locally configured
    --energy-audit-key (the key never rides the wire — both ends hold
    it out of band). FAIL on a signature mismatch (tampered payload, or
    the two ends hold different keys — both are audit-trust failures);
    WARN when either end runs unsigned."""
    import urllib.error

    from .energy import verify_payload

    try:
        digest = _fetch_json(base + "/debug/energy")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "energy", WARN,
                f"{base}/debug/energy requires authentication "
                f"(HTTP {exc.code}); the digest sits behind the "
                f"exporter's basic-auth gate by design")
        if exc.code == 404:
            return _result(
                "energy", WARN,
                f"{base}: no /debug/energy (exporter predates energy "
                f"accounting, or no accountant is wired)")
        return _result("energy", FAIL,
                       f"{base}/debug/energy: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable daemon, bad JSON
        return _result("energy", FAIL,
                       f"{base}: energy digest unreadable ({exc})")
    pods = digest.get("per_pod") or []
    total = sum(float(row[2]) for row in pods if len(row) >= 3)
    coverage = digest.get("coverage_ratio", 0.0)
    summary = (f"{len(pods)} pod total(s), {total:.1f} J, "
               f"burst coverage {coverage:.1%}")
    data = {"digest": digest}
    if not audit_key:
        return _result(
            "energy", WARN,
            f"{summary}; digest NOT verified (no --energy-audit-key "
            f"configured locally)", data=data)
    if not digest.get("signed") or "hmac" not in digest:
        return _result(
            "energy", FAIL,
            f"{summary}; daemon serves an UNSIGNED digest but a local "
            f"audit key is configured — energy totals are not "
            f"attestable", data=data)
    if not verify_payload(digest, audit_key):
        return _result(
            "energy", FAIL,
            f"{summary}; digest signature DOES NOT VERIFY — payload "
            f"tampered in flight, or the daemon holds a different "
            f"audit key", data=data)
    return _result("energy", OK, f"{summary}; signature verified",
                   data=data)


# Human rendering of the fleet lens's host_* anomaly kinds (the joined
# verdict's vocabulary): kind -> (digest["host"] key, format).
_HOST_KIND_TEXT = {
    "host_mem_stall": ("mem_full_avg10", "PSI memory full-stall {:.1f}%"),
    "host_cpu_stall": ("cpu_some_avg10", "PSI cpu some-stall {:.1f}%"),
    "host_io_stall": ("io_full_avg10", "PSI io full-stall {:.1f}%"),
    "host_nic_drops": ("nic_drop_rate", "NIC drops {:.1f}/s"),
    "host_throttle": ("throttle_rate",
                      "CPU thermal throttle {:.1f} events/s"),
}


def _host_verdict_bits(host_kinds: dict, digest_host: dict) -> str:
    """Render active host anomalies with their CURRENT values from the
    target's digest (falling back to the latched z when the digest has
    no value — an older exporter's rollup)."""
    bits = []
    for kind in sorted(host_kinds):
        key, template = _HOST_KIND_TEXT.get(
            kind, (None, kind + " {:.1f}"))
        value = (digest_host or {}).get(key) if key else None
        if value is None:
            bits.append(f"{kind} (z={host_kinds[kind]:g})")
        else:
            bits.append(template.format(value))
    return " + ".join(bits)


def check_egress(base: str) -> CheckResult:
    """--egress: read /debug/egress and summarize the durable-egress
    picture — spill depth/age/loss, durable remote-write shard
    WAL/lag/parked state, per-sender link health. Classified
    401/404/disabled like --host: a WARN row diagnoses config, only a
    broken surface FAILs."""
    import urllib.error

    try:
        payload = _fetch_json(base + "/debug/egress")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "egress", WARN,
                f"{base}/debug/egress requires authentication "
                f"(HTTP {exc.code}); the egress snapshot sits behind "
                f"the exporter's basic-auth gate by design")
        if exc.code == 404:
            return _result(
                "egress", WARN,
                f"{base}: no /debug/egress (exporter predates the "
                f"durable-egress layer, or this server has none wired)")
        return _result("egress", FAIL,
                       f"{base}/debug/egress: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable, bad JSON
        return _result("egress", FAIL,
                       f"{base}: egress snapshot unreadable ({exc})")
    if not payload.get("enabled", True):
        return _result(
            "egress", WARN,
            "no egress durability configured (--hub-spill-dir for the "
            "delta publisher, --remote-write-wal-dir for the exporter); "
            "a partition drops whatever it outlasts")
    parts: list[str] = []
    status = OK
    spill = payload.get("spill")
    if spill:
        depth = spill.get("depth_frames", 0)
        parts.append(
            f"spill: {depth} frame(s) / {spill.get('bytes', 0)}B "
            f"spooled, oldest {spill.get('oldest_age_seconds', 0):g}s")
        if spill.get("dropped_total", 0):
            status = WARN
            parts.append(f"spill DROPPED {spill['dropped_total']} "
                         f"frame(s) at the byte bound (data loss, "
                         f"accounted — see kts_spill_dropped_total)")
        if spill.get("undecodable_total", 0):
            # Name what a nonzero count means and where to look next.
            status = WARN
            parts.append(
                f"{spill['undecodable_total']} spooled frame(s) "
                f"undecodable — version skew (a build this one can't "
                f"read wrote them); see doctor --skew")
        if spill.get("reencoded_total", 0):
            parts.append(
                f"{spill['reencoded_total']} old-format spooled "
                f"frame(s) recovered by re-encoding at the negotiated "
                f"wire version")
        if spill.get("skew_segments_total", 0):
            status = WARN
            parts.append(
                f"{spill['skew_segments_total']} future-format spill "
                f"segment(s) quarantined intact (*.skew — a downgrade "
                f"landed on a newer build's spool); see doctor --skew")
        max_bytes = spill.get("max_bytes") or 0
        if max_bytes and spill.get("bytes", 0) > 0.8 * max_bytes:
            status = WARN
            parts.append("spill near its byte bound (>80%)")
    remote = payload.get("remote_write")
    if remote:
        shards = remote.get("shards") or []
        wal_bytes = sum(s.get("wal_bytes", 0) for s in shards)
        lag = max((s.get("lag_seconds", 0.0) for s in shards),
                  default=0.0)
        parked = sum(s.get("parked_total", 0) for s in shards)
        dropped = sum(s.get("dropped_total", 0) for s in shards)
        parts.append(f"remote-write: {len(shards)} shard(s), "
                     f"{wal_bytes}B WAL pending, lag {lag:g}s")
        if parked:
            status = WARN
            parts.append(f"{parked} poison request(s) parked (receiver "
                         f"rejects the payload — schema mismatch, not "
                         f"an outage)")
        if dropped:
            status = WARN
            parts.append(f"remote-write DROPPED {dropped} request(s) at "
                         f"the WAL bound (accounted loss)")
    down = {mode for mode, s in (payload.get("senders") or {}).items()
            if s.get("consecutive_failures", 0) > 0}
    # The durable senders deliberately pin consecutive_failures to 0
    # (the backoff belongs to the probe / shard loop, not the publish
    # cadence) — their link state lives in the spill queue's
    # link_failures and the shards' own failure counts.
    if spill and spill.get("link_failures", 0) > 0:
        down.add("delta")
    if remote and any(s.get("consecutive_failures", 0) > 0
                      for s in remote.get("shards") or []):
        down.add("remote_write")
    if down:
        status = WARN
        parts.append("link down: " + ", ".join(sorted(down)))
    if not parts:
        parts.append("egress healthy; no backlog")
    return _result("egress", status, "; ".join(parts),
                   data={"egress": payload})


def stores_verdict(payload: dict) -> tuple[str, str]:
    """(status, detail) for a /debug/stores payload — every degraded
    store NAMED with its reason/errno/loss, every restarted thread
    NAMED with its count, storm latches called out. Pure so tests drive
    it on canned JSON; check_stores wraps it with the fetch."""
    parts: list[str] = []
    status = OK
    degraded = []
    lost_total = 0
    faults_total = 0
    for store, info in sorted((payload.get("stores") or {}).items()):
        faults_total += sum((info.get("fault_counts") or {}).values())
        lost_total += info.get("lost_records", 0)
        if info.get("state") == "degraded":
            label = f"{store} ({info.get('reason', '?')}"
            if info.get("errno"):
                label += f", {info['errno']}"
            if "degraded_for_seconds" in info:
                label += f", {info['degraded_for_seconds']:.0f}s"
            label += ")"
            degraded.append(label)
    if degraded:
        status = WARN
        parts.append("degraded store(s): " + ", ".join(degraded)
                     + " — durability off, telemetry in-memory, "
                     "auto-probing for recovery")
    if lost_total:
        status = WARN
        parts.append(f"{lost_total} record(s) lost durability "
                     f"(kts_store_lost_records_total — exactly what a "
                     f"crash during the window would cost)")
    if faults_total and not degraded:
        parts.append(f"{faults_total} disk fault(s) survived and "
                     f"recovered (kts_disk_faults_total)")
    fence = payload.get("accept_fence") or {}
    if fence.get("in_episode"):
        status = WARN
        parts.append(f"accept loop shedding on fd exhaustion "
                     f"({fence.get('fenced_total', 0)} fenced)")
    elif fence.get("fenced_total"):
        parts.append(f"accept loop survived {fence['fenced_total']} "
                     f"fd-exhaustion fault(s)")
    restarted = [row for row in (payload.get("threads") or [])
                 if row.get("restarts", 0) > 0]
    if restarted:
        status = WARN
        parts.append("restarted thread(s): " + ", ".join(
            f"{row['component']} x{row['restarts']}"
            + (f" ({row['last_reason']})" if row.get("last_reason")
               else "")
            for row in restarted))
    storms = [row["component"]
              for row in (payload.get("threads") or [])
              if row.get("storm_latched")]
    if storms:
        status = WARN
        parts.append("RESTART STORM latched: " + ", ".join(storms)
                     + " — respawns paused; the component is dying on "
                     "arrival, read its last restart reason above")
    if not parts:
        parts.append("all stores durable; no thread restarts")
    return status, "; ".join(parts)


def check_stores(base: str) -> CheckResult:
    """--stores: read /debug/stores and summarize the local-fault-
    survival picture. Classified 401/404 like --host: a WARN row
    diagnoses config, only a broken surface FAILs."""
    import urllib.error

    try:
        payload = _fetch_json(base + "/debug/stores")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "stores", WARN,
                f"{base}/debug/stores requires authentication "
                f"(HTTP {exc.code}); the stores snapshot sits behind "
                f"the exporter's basic-auth gate by design")
        if exc.code == 404:
            return _result(
                "stores", WARN,
                f"{base}: no /debug/stores (exporter predates the "
                f"local-fault-survival layer, or this server has none "
                f"wired)")
        return _result("stores", FAIL,
                       f"{base}/debug/stores: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable, bad JSON
        return _result("stores", FAIL,
                       f"{base}: stores snapshot unreadable ({exc})")
    status, detail = stores_verdict(payload)
    return _result("stores", status, detail, data={"stores": payload})


def cardinality_verdict(payload: dict) -> tuple[str, str]:
    """(status, detail) for a /debug/cardinality payload — live series
    vs limits, every clamped source NAMED, shed/evicted totals with
    the top offenders. Pure so tests drive it on canned JSON;
    check_cardinality wraps it with the fetch."""
    parts: list[str] = []
    status = OK
    live = payload.get("live_series", 0)
    sources = payload.get("sources", 0)
    limits = payload.get("limits") or {}
    head = f"{live} series live across {sources} source(s)"
    hard_cap = limits.get("hard_cap", 0)
    high = limits.get("high_watermark", 0)
    if hard_cap:
        head += f" (hard cap {hard_cap})"
    parts.append(head)
    if not payload.get("enabled", True):
        parts.append("admission off (all limits 0) — accounting only; "
                     "set --series-budget-per-source / --series-hard-cap "
                     "to enforce")
    if hard_cap and live >= hard_cap:
        status = WARN
        parts.append("AT HARD CAP — new series are being refused "
                     "(413); find the offender in top_sources and "
                     "raise its budget or fix its labels")
    elif high and live >= high:
        status = WARN
        parts.append(f"above high watermark {high} — idle-source "
                     f"eviction active")
    clamped = payload.get("clamped_sources") or []
    if clamped:
        status = WARN
        shown = ", ".join(sorted(clamped)[:5])
        more = f" (+{len(clamped) - 5} more)" if len(clamped) > 5 else ""
        parts.append(f"clamped source(s) over per-source budget: "
                     f"{shown}{more} — their newest series are being "
                     f"dropped and counted "
                     f"(kts_cardinality_shed_total)")
    shed_total = payload.get("shed_total", 0)
    if shed_total:
        if not clamped:
            status = WARN
        offenders = sorted(
            ((sum((row.get("reasons") or {}).values()), row.get("source"))
             for row in (payload.get("shed") or [])),
            reverse=True)
        named = ", ".join(f"{src} x{n}" for n, src in offenders[:3] if n)
        parts.append(f"{shed_total} series shed"
                     + (f" (top: {named})" if named else ""))
    evicted = payload.get("evicted") or {}
    evicted_total = sum(evicted.values())
    if evicted_total:
        parts.append(f"{evicted_total} idle source(s) evicted to stay "
                     f"under the watermark "
                     f"(kts_cardinality_evicted_total)")
    top = payload.get("top_sources") or []
    if top and (clamped or shed_total or (high and live >= high)):
        biggest = top[0]
        parts.append(f"largest source: {biggest.get('source')} "
                     f"({biggest.get('series', 0)} series)")
    if len(parts) == 1 and status == OK:
        parts.append("no sheds, no evictions")
    return status, "; ".join(parts)


def check_cardinality(base: str) -> CheckResult:
    """--cardinality: read /debug/cardinality and summarize the series
    admission picture. Classified 401/404 like --stores: a WARN row
    diagnoses config, only a broken surface FAILs."""
    import urllib.error

    try:
        payload = _fetch_json(base + "/debug/cardinality")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "cardinality", WARN,
                f"{base}/debug/cardinality requires authentication "
                f"(HTTP {exc.code}); the cardinality ledger sits "
                f"behind the exporter's basic-auth gate by design")
        if exc.code == 404:
            return _result(
                "cardinality", WARN,
                f"{base}: no /debug/cardinality (server predates the "
                f"cardinality admission layer, or this server has "
                f"none wired)")
        return _result("cardinality", FAIL,
                       f"{base}/debug/cardinality: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable, bad JSON
        return _result("cardinality", FAIL,
                       f"{base}: cardinality snapshot unreadable "
                       f"({exc})")
    status, detail = cardinality_verdict(payload)
    return _result("cardinality", status, detail,
                   data={"cardinality": payload})


def skew_verdict(payload: dict) -> tuple[str, str]:
    """(status, detail) for a /debug/skew payload — the fleet version
    census plus every refused/downgraded peer, named. Pure
    so tests drive it on canned JSON; check_skew wraps it with the
    fetch. WARN on anything an operator should act on mid-rollout:
    refused peers (426s — a version outside the accepted window),
    publisher-side refusals or forced downgrades, quarantined
    persisted formats, or a mixed-version census (a rollout in flight
    — or stuck)."""
    parts: list[str] = []
    status = OK
    build = payload.get("build", "unknown")
    parts.append(f"build {build} speaks wire "
                 f"v{payload.get('proto_min', '?')}.."
                 f"v{payload.get('proto_max', '?')}")
    ingest = payload.get("ingest")
    if ingest:
        census = ingest.get("fleet_versions") or {}
        if census:
            parts.append("fleet census: " + ", ".join(
                f"{version}={count}"
                for version, count in sorted(census.items())))
            if len(census) > 1:
                status = WARN
                parts.append("MIXED fleet (rollout in progress — "
                             "census-gate the next wave on "
                             "kts_fleet_version_count)")
        refused = ingest.get("refused_peers") or {}
        if refused or ingest.get("skew_refused_total", 0):
            status = WARN
            names = "; ".join(
                f"{peer} offered v{record.get('version', '?')} "
                f"(x{record.get('count', 0)})"
                for peer, record in sorted(refused.items()))
            parts.append(
                f"REFUSED {ingest.get('skew_refused_total', 0)} "
                f"frame(s) outside accepted "
                f"v{ingest.get('proto_min', '?')}.."
                f"v{ingest.get('proto_max', '?')}"
                + (f": {names}" if names else ""))
        downgraded = ingest.get("downgraded_sessions") or []
        if downgraded:
            extra = ingest.get("downgraded_sessions_truncated", 0)
            names = ", ".join(
                f"{row.get('source', '?')} (v{row.get('proto', '?')}"
                + (f", {row['build']}" if row.get("build") else "")
                + ")"
                for row in downgraded)
            parts.append(
                f"{len(downgraded) + extra} session(s) below this "
                f"hub's max: {names}"
                + (f" … +{extra} more" if extra else ""))
    publisher = payload.get("publisher")
    if publisher:
        hub_hello = publisher.get("hub")
        negotiated = publisher.get("negotiated_proto", "?")
        if hub_hello:
            parts.append(
                f"publisher negotiated v{negotiated} with hub "
                f"{hub_hello.get('build') or 'unknown build'} "
                f"(speaks {hub_hello.get('proto_min', '?')}.."
                f"{hub_hello.get('proto_max', '?')})")
        else:
            parts.append(f"publisher at v{negotiated} (hub hello not "
                         f"seen yet — pre-negotiation hub, or no push "
                         f"landed)")
        if publisher.get("skew_refused_total", 0):
            status = WARN
            parts.append(
                f"upstream hub REFUSED {publisher['skew_refused_total']} "
                f"push(es) for version skew (426) — disjoint ranges "
                f"cannot self-heal; fix the rollout order")
        if publisher.get("proto_downgrades_total", 0):
            status = WARN
            parts.append(
                f"{publisher['proto_downgrades_total']} encoding "
                f"downgrade(s) (hub rolled back or predates "
                f"negotiation — data intact, features masked)")
    quarantined = payload.get("wal_quarantined") or {}
    if quarantined:
        status = WARN
        parts.append(
            "QUARANTINED future-format file(s), byte-identical aside: "
            + ", ".join(f"{store}={count}"
                        for store, count in sorted(quarantined.items()))
            + " — a downgrade landed on newer persisted state; "
            "re-upgrade (or move the .skew file back) to replay")
    return status, "; ".join(parts)


def check_skew(base: str) -> CheckResult:
    """--skew: read /debug/skew from the RUNNING daemon or hub and
    print the rolling-upgrade picture — version census, refused and
    downgraded peers, quarantined persisted formats. Classified
    401/404 like --egress: a WARN row diagnoses config, only a broken
    surface FAILs."""
    import urllib.error

    try:
        payload = _fetch_json(base + "/debug/skew")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "skew", WARN,
                f"{base}/debug/skew requires authentication "
                f"(HTTP {exc.code}); the skew snapshot sits behind "
                f"the exporter's basic-auth gate by design")
        if exc.code == 404:
            return _result(
                "skew", WARN,
                f"{base}: no /debug/skew (exporter predates the "
                f"version-skew layer — which is itself a version-skew "
                f"data point: this build is newer than that one)")
        return _result("skew", FAIL, f"{base}/debug/skew: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable, bad JSON
        return _result("skew", FAIL,
                       f"{base}: skew snapshot unreadable ({exc})")
    status, detail = skew_verdict(payload)
    return _result("skew", status, detail, data={"skew": payload})


def fleet_post_mortem(payload: dict) -> tuple[str, str, dict]:
    """(status, detail line, data) for a /debug/fleet rollup: the
    slice post-mortem — worst node with its phase and blame, every
    anomalous target with its anomaly kinds (and that target's own
    worst phase from its digest), host correlation (a target whose device-side anomaly or worst-phase attribution
    co-occurs with a host_* anomaly in the same refresh window gets
    the joined verdict, e.g. "node-7: fetch_wait spike co-occurs with
    PSI memory full-stall 18%"), and the SLO burn windows. WARN when
    any anomaly is active or any burn window is over budget (burn >
    1.0). Pure so tests drive it on canned JSON; check_fleet wraps it
    with the fetch/auth/version classification."""
    from .linkloc import LINK_EXPLAINED_KINDS

    parts: list[str] = []
    data: dict = {"attribution": payload.get("attribution"),
                  "anomalous": {}, "correlated": {},
                  "slo": payload.get("slo", {})}
    status = OK
    worst = payload.get("attribution")
    if worst:
        line = (f"worst node: {worst.get('target')} "
                f"(phase {worst.get('phase')}, "
                f"{worst.get('seconds', 0.0):.3f}s")
        if worst.get("blame"):
            line += f", blame {worst['blame']}"
        parts.append(line + ")")
    # Interconnect localization: the verdict the whole
    # topology pass exists to print — name the sick LINK first, and
    # below, do NOT also accuse the endpoint nodes whose anomalies the
    # link fully explains (they are the innocent neighbors).
    suspects = (payload.get("links") or {}).get("suspects") or {}
    link_explained: dict[str, str] = {}
    for link, verdict in sorted(suspects.items()):
        status = WARN
        ends = ",".join(verdict.get("endpoints") or ())
        line = f"nodes {ends} slow; shared ICI link {link} suspect"
        reason = verdict.get("reason", "")
        if "host-counter-confirmed" in reason:
            line += ", host-counter-confirmed"
        elif "anomaly-correlated" in reason:
            line += ", anomaly-correlated"
        drop = verdict.get("drop")
        if drop:
            line += f" ({drop:.0%} below baseline)"
        parts.append(line)
        for target in verdict.get("targets") or ():
            if target:
                link_explained[target] = link
    data["link_suspects"] = {link: dict(v)
                            for link, v in sorted(suspects.items())}
    data["link_explained"] = {}
    for target, entry in sorted((payload.get("targets") or {}).items()):
        anomalous = entry.get("anomalous") or {}
        if not anomalous:
            continue
        status = WARN
        if target in link_explained and all(
                kind in LINK_EXPLAINED_KINDS or kind.startswith("host_")
                for kind in anomalous):
            # Every anomaly on this endpoint is a symptom a degraded
            # shared link produces (ici/steps/fetch slowdowns, the host
            # NIC/IRQ corroboration) — the link verdict above already
            # owns them, so the node is not accused.
            data["link_explained"][target] = link_explained[target]
            continue
        data["anomalous"][target] = dict(anomalous)
        # Freshness reports the CURRENT missed count (entry['missed']),
        # not the count frozen at the raise edge — a 100-refresh outage
        # must not read as '3 refreshes missed' forever.
        kinds = ", ".join(
            f"{kind} (z={z:g})" if kind != "freshness"
            else (f"freshness ({int(entry.get('missed', z))} "
                  f"refreshes missed)")
            for kind, z in sorted(anomalous.items()))
        line = f"{target}: {kinds}"
        digest = entry.get("digest") or {}
        slow = digest.get("slowest") or {}
        if slow.get("phase"):
            line += f" [worst phase {slow['phase']}"
            if slow.get("blame"):
                line += f", {slow['blame']}"
            line += "]"
        parts.append(line)
        # Joined verdict: device-side slowness AND host pressure inside
        # the same refresh window on the SAME node — the root-cause
        # sentence the whole host-signals pipeline exists to print.
        host_kinds = {k: z for k, z in anomalous.items()
                      if k.startswith("host_")}
        device_kinds = [k for k in anomalous
                        if not k.startswith("host_") and k != "freshness"]
        is_worst = bool(worst and worst.get("target") == target)
        if host_kinds and (device_kinds or is_worst):
            phase = (slow.get("phase")
                     or (worst.get("phase") if is_worst else "")
                     or (device_kinds[0] if device_kinds else "slow"))
            host_text = _host_verdict_bits(host_kinds,
                                           digest.get("host") or {})
            parts.append(f"{target}: {phase} spike co-occurs with "
                         f"{host_text}")
            data["correlated"][target] = {
                "phase": phase,
                "host": dict(host_kinds),
                "host_values": dict(digest.get("host") or {}),
            }
    burns = []
    for objective, state in sorted((payload.get("slo") or {}).items()):
        windows = state.get("windows") or {}
        rendered = []
        for label in sorted(windows):
            burn = windows[label].get("burn_rate", 0.0)
            flag = "!" if burn > 1.0 else ""
            if burn > 1.0:
                status = WARN
            rendered.append(f"{label}={burn:g}x{flag}")
        if rendered:
            burns.append(f"{objective} " + "/".join(rendered))
    if burns:
        parts.append("burn: " + "; ".join(burns)
                     + " (>1x = over the error budget)")
    if not parts:
        parts.append("no anomalies, burn within budget, no slow-node "
                     "attribution yet")
    return status, "; ".join(parts), data


def check_fleet(base: str) -> CheckResult:
    """--fleet: read the RUNNING hub's fleet lens and print the slice
    post-mortem (which node is dragging the job, which phase, which
    anomalies co-occur, how fast the SLO budget is burning)."""
    import urllib.error

    try:
        payload = _fetch_json(base + "/debug/fleet")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "fleet", WARN,
                f"{base}/debug/fleet requires authentication "
                f"(HTTP {exc.code}); the fleet lens sits behind the "
                f"hub's basic-auth gate by design")
        if exc.code == 404:
            from .hub import DEFAULT_PORT

            return _result(
                "fleet", WARN,
                f"{base}: no /debug/fleet (hub predates the fleet lens, "
                f"runs --no-fleet-lens, or this is a daemon — point "
                f"--url at the hub, default port {DEFAULT_PORT})")
        return _result("fleet", FAIL, f"{base}/debug/fleet: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable hub, bad JSON
        return _result("fleet", FAIL,
                       f"{base}: fleet lens unreadable ({exc})")
    if not payload.get("targets"):
        return _result(
            "fleet", WARN,
            f"no targets scored yet (refresh seq "
            f"{payload.get('seq', 0)}); is the hub refreshing?")
    status, detail, data = fleet_post_mortem(payload)
    # Federation walk: any target that itself serves
    # /debug/fleet is a leaf HUB — descend one level and fold its slice
    # post-mortem in, so a root-hub doctor names the guilty NODE, not
    # just the guilty leaf. Bounded: at most 8 probes, each with the
    # same short fetch timeout; daemons (no /debug/fleet) just 404 out
    # of the walk.
    leaves: dict[str, str] = {}
    for target in sorted(payload.get("targets") or {})[:8]:
        if "://" not in target:
            continue  # .prom file targets can't be hubs
        try:
            sub = _fetch_json(trace_base(target) + "/debug/fleet")
        except Exception:  # noqa: BLE001 - a daemon or a dead leaf
            continue
        if not isinstance(sub, dict) or not sub.get("targets"):
            continue
        sub_status, sub_detail, sub_data = fleet_post_mortem(sub)
        if _ORDER[sub_status] < _ORDER[status]:
            status = sub_status
        leaves[target] = sub_detail
        data.setdefault("leaves", {})[target] = sub_data
    for target, sub_detail in leaves.items():
        detail += f" | leaf {target}: {sub_detail}"
    return _result("fleet", status, detail, data=data)


def parse_at(raw: str, now: float) -> float:
    """``--at`` value -> unix seconds. Accepts absolute unix seconds
    (anything past ~2001), or an ago-style offset: plain seconds, or a
    number with an m/h suffix, optional leading '-' ("600", "10m",
    "-2h" all mean that long before now). Raises ValueError with the
    accepted forms — main() prints it as the usage error."""
    text = raw.strip().lstrip("-")
    if not text:
        raise ValueError("--at requires a time (unix seconds, or an "
                         "ago-offset like 600, 10m, 2h)")
    scale = 1.0
    if text[-1] in ("m", "h"):
        scale = 60.0 if text[-1] == "m" else 3600.0
        text = text[:-1]
    try:
        value = float(text)
    except ValueError:
        raise ValueError(f"--at: {raw!r} is not a time (unix seconds, "
                         f"or an ago-offset like 600, 10m, 2h)")
    if scale == 1.0 and value > 1e9:
        return value  # absolute unix timestamp
    return now - value * scale


def fleet_at_verdict(steps_payload: dict, up_payload: dict,
                     ratio_payload: dict, at_ts: float,
                     links_payload: dict | None = None
                     ) -> tuple[str, str, dict]:
    """(status, detail, data) for a retroactive fleet post-mortem at
    ``at_ts``, computed from the hub history ring's /query?at=
    payloads (named-window nearest-sample semantics: each value is the
    populated bucket nearest the timestamp from the finest tier still
    covering it — the sample's own timestamp is printed as 'as of').
    Pure so the fault-injection test drives it on canned payloads: a
    straggler visible at the timestamp stays named here even after it
    recovers, because the verdict reads the ring, not the live lens."""
    data: dict = {"at": at_ts, "slices": {}, "targets_down": [],
                  "links_suspect": []}
    parts: list[str] = []
    status = OK
    # Per-slice straggler attribution from the per-worker step rates.
    by_slice: dict[str, list[tuple[str, float, float]]] = {}
    for entry in steps_payload.get("series") or []:
        labels = entry.get("labels") or {}
        slice_name = labels.get("slice", "")
        worker = labels.get("worker", "")
        by_slice.setdefault(slice_name, []).append(
            (worker, float(entry.get("v", 0.0)),
             float(entry.get("t", at_ts))))
    ratios = {
        (entry.get("labels") or {}).get("slice", ""):
            float(entry.get("v", 0.0))
        for entry in ratio_payload.get("series") or []
    }
    for slice_name in sorted(by_slice):
        workers = by_slice[slice_name]
        best = max(rate for _w, rate, _t in workers)
        slowest = min(workers, key=lambda w: w[1])
        ratio = ratios.get(
            slice_name,
            (slowest[1] / best) if best > 0 else 1.0)
        data["slices"][slice_name] = {
            "ratio": ratio,
            "slowest_worker": slowest[0],
            "slowest_rate": slowest[1],
            "best_rate": best,
            "sample_ts": slowest[2],
        }
        if best > 0 and ratio < 0.75:
            status = WARN
            parts.append(
                f"slice {slice_name}: straggler worker {slowest[0]} at "
                f"{slowest[1]:g} steps/s vs best {best:g} "
                f"(ratio {ratio:.2f}, as of {_ts(slowest[2])})")
    down = [
        ((entry.get("labels") or {}).get("target", ""),
         float(entry.get("t", at_ts)))
        for entry in up_payload.get("series") or []
        if float(entry.get("v", 1.0)) == 0.0
    ]
    for target, sample_ts in sorted(down):
        status = WARN
        data["targets_down"].append(target)
        parts.append(f"{target} was down (as of {_ts(sample_ts)})")
    # Retroactive link localization: the link-suspect rows
    # the hub recorded into the ring every publish. Ring buckets hold
    # the MEAN of their samples, so any positive value means the link
    # was accused for part of the bucket; the 0.0 tombstones the
    # recovery wrote keep later buckets (and a fully-recovered
    # incident's tail) reading clean — exactly the post-incident
    # semantics a post-mortem wants.
    for entry in (links_payload or {}).get("series") or []:
        if float(entry.get("v", 0.0)) <= 0.0:
            continue
        labels = entry.get("labels") or {}
        link = labels.get("link", "")
        reason = labels.get("reason", "")
        sample_ts = float(entry.get("t", at_ts))
        status = WARN
        data["links_suspect"].append(
            {"link": link, "reason": reason, "sample_ts": sample_ts})
        parts.append(f"ICI link {link} was suspect ({reason}, "
                     f"as of {_ts(sample_ts)})")
    if not (steps_payload.get("series") or up_payload.get("series")
            or (links_payload or {}).get("series")):
        return (WARN,
                f"history has no samples near {_ts(at_ts)} — the ring "
                f"holds 1h/24h/7d tiers from THIS hub boot only (it "
                f"intentionally does not survive a restart)", data)
    if not parts:
        parts.append(f"fleet healthy at {_ts(at_ts)}: no straggler "
                     f"slice, no down target in the nearest samples")
    return status, "; ".join(parts), data


def _ts(ts: float) -> str:
    """Compact UTC render for --at verdict lines."""
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


def check_fleet_at(base: str, at_ts: float) -> CheckResult:
    """--fleet --at: replay the fleet verdict from the hub's history
    ring at a past timestamp (three /query?at= reads; the ring's
    nearest-sample answer, not the live lens)."""
    import urllib.error

    payloads = {}
    for family in ("slice_worker_steps_per_second", "slice_target_up",
                   "slice_straggler_ratio", "kts_fleet_link_suspect"):
        try:
            payloads[family] = _fetch_json(
                f"{base}/query?family={family}&at={at_ts}")
        except urllib.error.HTTPError as exc:
            if exc.code in (401, 403):
                return _result(
                    "fleet-at", WARN,
                    f"{base}/query requires authentication "
                    f"(HTTP {exc.code}); /query sits behind the hub's "
                    f"basic-auth gate by design")
            if exc.code == 404:
                # An unknown family 404s too (e.g. the ring holds no
                # samples for it yet) — the no-samples verdict below
                # covers it.
                payloads[family] = {}
                continue
            return _result("fleet-at", FAIL,
                           f"{base}/query: HTTP {exc.code}")
        except Exception as exc:  # noqa: BLE001 - unreachable hub
            return _result("fleet-at", FAIL,
                           f"{base}: history unreadable ({exc})")
        if payloads[family].get("enabled") is False:
            return _result(
                "fleet-at", WARN,
                f"{base}: history disabled (hub runs --no-history or "
                f"predates the history ring) — --at has nothing to "
                f"replay from")
    status, detail, data = fleet_at_verdict(
        payloads.get("slice_worker_steps_per_second") or {},
        payloads.get("slice_target_up") or {},
        payloads.get("slice_straggler_ratio") or {},
        at_ts,
        links_payload=payloads.get("kts_fleet_link_suspect") or {})
    return _result("fleet-at", status, detail, data=data)


def check_efficiency(base: str, audit_key: str) -> CheckResult:
    """--efficiency: read the hub's /debug/efficiency energy/waste
    attestation, verify its HMAC with the locally configured
    --energy-audit-key (the same contract as --energy: OK verified,
    FAIL on tamper or a wrong key, WARN unsigned), and name the pods
    the hub is accusing of wasting cards right now."""
    import urllib.error

    from .energy import verify_payload

    try:
        payload = _fetch_json(base + "/debug/efficiency")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "efficiency", WARN,
                f"{base}/debug/efficiency requires authentication "
                f"(HTTP {exc.code}); the attestation sits behind the "
                f"hub's basic-auth gate by design")
        if exc.code == 404:
            return _result(
                "efficiency", WARN,
                f"{base}: no /debug/efficiency (hub predates the "
                f"efficiency lens, or runs --no-fleet-lens)")
        return _result("efficiency", FAIL,
                       f"{base}/debug/efficiency: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable hub, bad JSON
        return _result(
            "efficiency", FAIL,
            f"{base}: efficiency attestation unreadable ({exc})")
    if not payload.get("enabled", True):
        return _result(
            "efficiency", WARN,
            "efficiency scoring disabled on the hub (--no-efficiency); "
            "no waste ledger to attest")
    totals = payload.get("totals") or {}
    waste = payload.get("waste") or {}
    suspects = waste.get("suspects") or {}
    summary = (f"{totals.get('leaves', 0)} leaf energy digest(s) "
               f"({totals.get('leaves_signed', 0)} signed), "
               f"{totals.get('joules', 0.0):.1f} J attributed, "
               f"{len(suspects)} waste suspect(s)")
    data = {"attestation": payload}
    if not audit_key:
        return _result(
            "efficiency", WARN,
            f"{summary}; attestation NOT verified (no "
            f"--energy-audit-key configured locally)", data=data)
    if not payload.get("signed") or "hmac" not in payload:
        return _result(
            "efficiency", FAIL,
            f"{summary}; hub serves an UNSIGNED attestation but a "
            f"local audit key is configured — the energy/waste rollup "
            f"is not attestable", data=data)
    if not verify_payload(payload, audit_key):
        return _result(
            "efficiency", FAIL,
            f"{summary}; attestation signature DOES NOT VERIFY — "
            f"payload tampered in flight, or the hub holds a different "
            f"audit key", data=data)
    if suspects:
        names = "; ".join(
            f"{name}: {info.get('reason')} "
            f"({info.get('chips', 0)} chip(s))"
            for name, info in sorted(suspects.items()))
        return _result(
            "efficiency", WARN,
            f"{summary}; signature verified; wasting now: {names}",
            data=data)
    return _result("efficiency", OK, f"{summary}; signature verified",
                   data=data)


def efficiency_at_verdict(waste_payload: dict,
                          at_ts: float) -> tuple[str, str, dict]:
    """(status, detail, data) for a retroactive "who was wasting cards"
    read at ``at_ts`` from the ring's kts_fleet_waste_suspect rows.
    Ring buckets hold sample MEANS, so any positive value means the pod
    was accused for part of the bucket; the 0.0 tombstones the recovery
    wrote keep later buckets reading clean. Pure so the waste scenario
    drives it on canned payloads too."""
    data: dict = {"at": at_ts, "waste_suspects": []}
    parts: list[str] = []
    status = OK
    for entry in waste_payload.get("series") or []:
        if float(entry.get("v", 0.0)) <= 0.0:
            continue
        labels = entry.get("labels") or {}
        pod = labels.get("pod", "")
        namespace = labels.get("namespace", "")
        reason = labels.get("reason", "")
        sample_ts = float(entry.get("t", at_ts))
        status = WARN
        data["waste_suspects"].append(
            {"pod": pod, "namespace": namespace, "reason": reason,
             "sample_ts": sample_ts})
        parts.append(f"{namespace}/{pod} was wasting chips ({reason}, "
                     f"as of {_ts(sample_ts)})")
    if not waste_payload.get("series"):
        return (WARN,
                f"history has no waste samples near {_ts(at_ts)} — the "
                f"ring holds 1h/24h/7d tiers from THIS hub boot only "
                f"(it intentionally does not survive a restart)", data)
    if not parts:
        parts.append(f"no pod was wasting chips at {_ts(at_ts)} in the "
                     f"nearest samples")
    return status, "; ".join(parts), data


def check_efficiency_at(base: str, at_ts: float) -> CheckResult:
    """--efficiency --at: replay the waste verdict from the hub's
    history ring at a past timestamp (one /query?at= read of the
    kts_fleet_waste_suspect rows the hub records every publish)."""
    import urllib.error

    try:
        payload = _fetch_json(
            f"{base}/query?family=kts_fleet_waste_suspect&at={at_ts}")
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            return _result(
                "efficiency-at", WARN,
                f"{base}/query requires authentication "
                f"(HTTP {exc.code}); /query sits behind the hub's "
                f"basic-auth gate by design")
        if exc.code == 404:
            # Unknown family 404s too (no waste row ever recorded) —
            # the no-samples verdict covers it.
            payload = {}
        else:
            return _result("efficiency-at", FAIL,
                           f"{base}/query: HTTP {exc.code}")
    except Exception as exc:  # noqa: BLE001 - unreachable hub
        return _result("efficiency-at", FAIL,
                       f"{base}: history unreadable ({exc})")
    if payload.get("enabled") is False:
        return _result(
            "efficiency-at", WARN,
            f"{base}: history disabled (hub runs --no-history or "
            f"predates the history ring) — --at has nothing to replay "
            f"from")
    status, detail, data = efficiency_at_verdict(payload, at_ts)
    return _result("efficiency-at", status, detail, data=data)


def check_url(target: str) -> list[CheckResult]:
    """Both --url rows — scrape contract + live breaker state — off ONE
    fetch: a node diagnosed because it is degraded must not render its
    exposition twice per doctor run."""
    text, fetch_row = _scrape_fetch(target)
    if text is None:
        return [fetch_row,
                _result("live-resilience", SKIP,
                        f"{target}: not scrapeable here; see the scrape "
                        f"row")]
    return [check_scrape(target, text=text),
            check_live_resilience(target, text=text)]


def check_scrape(target: str, text: str | None = None) -> CheckResult:
    """Validate a live scrape (or saved .prom) against the exposition
    contract — the doctor's hook into the validate tool."""
    from . import validate

    if text is None:
        text, fetch_row = _scrape_fetch(target)
        if text is None:
            return fetch_row
    problems = validate.check(text)
    if problems:
        head = "; ".join(problems[:3])
        more = f" (+{len(problems) - 3} more)" if len(problems) > 3 else ""
        return _result("scrape", FAIL,
                       f"{len(problems)} contract violation(s): {head}{more}")
    series = sum(1 for line in text.splitlines()
                 if line and not line.startswith("#"))
    return _result("scrape", OK, f"{series} series conform "
                                 f"to the accelerator_* contract")


def _scrape_fetch(target: str) -> tuple[str | None, CheckResult | None]:
    """Fetch the --url target once: (text, None) on success, else
    (None, scrape row classifying the failure)."""
    from . import validate

    import http.client
    import ssl
    import urllib.error

    try:
        return validate.fetch_exposition(target), None
    except urllib.error.HTTPError as exc:
        if exc.code in (401, 403):
            # The exporter's own hardening (--auth-username): the endpoint
            # is up and enforcing auth. The doctor holds only the
            # password's sha256 (by design), so it cannot authenticate —
            # a hardened-healthy state, not a collection failure.
            return None, _result(
                "scrape", WARN,
                f"{target}: endpoint is up but requires authentication "
                f"(HTTP {exc.code}); contract not checked",
            )
        return None, _result("scrape", FAIL, f"{target}: HTTP {exc.code}")
    except (OSError, ValueError, http.client.HTTPException) as exc:
        # urlopen wraps certificate failures as URLError(reason=SSLError):
        # with the exporter's own --tls-cert-file self-signed that is a
        # hardened-healthy state, not a dead endpoint.
        reason = getattr(exc, "reason", None)
        if isinstance(exc, ssl.SSLError) or isinstance(reason, ssl.SSLError):
            return None, _result(
                "scrape", WARN,
                f"{target}: TLS handshake failed ({reason or exc}) — "
                f"self-signed --tls-cert-file? scrape it with the cert's "
                f"CA trusted; the endpoint itself is answering TLS",
            )
        # ValueError covers UnicodeDecodeError (binary body); HTTPException
        # covers BadStatusLine — both happen when --url points at
        # something that is not a metrics endpoint. ascii() keeps raw
        # response bytes in the message terminal-safe.
        return None, _result("scrape", FAIL,
                             f"{target}: fetch failed: {ascii(str(exc))}")


# -- orchestration -----------------------------------------------------------

PROBE_TIMEOUT = 15.0  # generous: every probe's own calls are already bounded


def _bounded(name: str, probe: Callable[[], object],
             timeout: float = PROBE_TIMEOUT) -> list[CheckResult]:
    """Run one probe on a daemon thread with a hard timeout. This is the
    "doctor never hangs" guarantee for the unbounded dependencies (a
    wedged driver blocks ``nvmlInit_v2`` with no EINTR to offer): the
    probe thread is abandoned, marked FAIL, and — being daemonic — never
    blocks process exit."""
    import concurrent.futures

    from .workers import DaemonSamplerPool

    pool = DaemonSamplerPool(1, thread_name_prefix=f"doctor-{name}")
    try:
        future = pool.submit(probe)
        try:
            result = future.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            return [_result(
                name, FAIL,
                f"probe hung for {timeout:.0f}s (wedged driver?)",
            )]
        except Exception as exc:  # a probe bug must not abort the pass
            return [_result(name, FAIL, f"probe crashed: {exc}")]
        return result if isinstance(result, list) else [result]
    finally:
        pool.shutdown()


EMBEDDED_PROBE_TIMEOUT = 60.0


def _probe_torch_cuda(timeout: float = EMBEDDED_PROBE_TIMEOUT) -> str | None:
    """Ask a SUBPROCESS whether torch sees a CUDA card: "gpu", "cpu", or
    None when the answer is unknown (no torch here, or its import or CUDA
    init crashed or hung past ``timeout``). A subprocess, not an import:
    the doctor runs in the DaemonSet image, which carries no CUDA
    userspace, and a wedged CUDA init must not wedge the doctor."""
    import subprocess

    try:
        out = subprocess.run(
            [sys.executable, "-c",
             "import torch\n"
             "print('gpu' if torch.cuda.is_available() else 'cpu')"],
            capture_output=True, text=True, timeout=timeout,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    answer = lines[-1] if out.returncode == 0 and lines else ""
    return answer if answer in ("gpu", "cpu") else None


def check_embedded_viability(cfg: Config) -> CheckResult:
    """Reached only under ``--backend auto`` when the ``nvml`` row is not
    OK: ask a bounded subprocess whether in-process torch sees a CUDA card
    anyway — the node where the embedded workload-side exporter is the one
    viable telemetry path (``embedded.py``)."""
    platform = _probe_torch_cuda()
    if platform == "gpu":
        return _result(
            "embedded", WARN,
            "no NVML surface, but in-process torch sees a CUDA card — run "
            "the embedded exporter inside the workload "
            "(kube_gpu_stats_tpu_torch.embedded.start(); same schema and "
            "scrape surface)")
    if platform is None:
        # The probe swallows every failure into None: torch not installed
        # here, an import crash, or a CUDA init hanging past the timeout.
        # That is INCONCLUSIVE, not "no card" — a false all-clear would
        # steer the operator away from the one viable path this row
        # exists to surface.
        return _result(
            "embedded", SKIP,
            "torch probe inconclusive (torch unavailable in this "
            "environment, or its CUDA init hung/crashed); embedded-mode "
            "viability unknown")
    return _result(
        "embedded", SKIP,
        "no CUDA card visible to torch either; nothing to export on this "
        "node")


def run_checks(cfg: Config, url: str = "", trace: bool = False,
               host: bool = False, energy: bool = False,
               egress: bool = False, skew: bool = False,
               stores: bool = False,
               cardinality: bool = False,
               fleet: bool = False,
               fleet_at: float | None = None,
               efficiency: bool = False,
               efficiency_at: float | None = None) -> list[CheckResult]:
    probes: list[tuple[str, Callable[[], object]]] = [
        ("nvml", lambda: check_nvml(cfg)),
        ("attribution", lambda: check_attribution(cfg)),
        ("topology", lambda: check_topology(cfg)),
        ("poll", lambda: check_poll(cfg)),
    ]
    if cfg.remote_write_url:
        probes.append(("remote-write", lambda: check_remote_write(cfg)))
    if url:
        # One probe, one fetch, two rows (scrape + live-resilience).
        probes.append(("scrape", lambda: check_url(url)))
    if trace:
        # Only an http(s) --url names a live daemon; a .prom file target
        # has no flight recorder — fall back to the local daemon on the
        # configured listen port.
        base = (trace_base(url) if url.startswith(("http://", "https://"))
                else f"http://127.0.0.1:{cfg.listen_port}")
        probes.append(("trace", lambda: check_trace(base)))
    if energy:
        # Same live-daemon fallback as --trace: /debug/energy lives on
        # the daemon's own server.
        energy_base = (trace_base(url)
                       if url.startswith(("http://", "https://"))
                       else f"http://127.0.0.1:{cfg.listen_port}")
        probes.append(("energy", lambda: check_energy(
            energy_base, cfg.energy_audit_key)))
    if host:
        # Same live-daemon fallback as --trace: /debug/host lives on the
        # daemon's own server.
        host_base = (trace_base(url)
                     if url.startswith(("http://", "https://"))
                     else f"http://127.0.0.1:{cfg.listen_port}")
        probes.append(("host", lambda: check_host(host_base)))
    if egress:
        # Same fallback: /debug/egress lives on the daemon's server.
        egress_base = (trace_base(url)
                       if url.startswith(("http://", "https://"))
                       else f"http://127.0.0.1:{cfg.listen_port}")
        probes.append(("egress", lambda: check_egress(egress_base)))
    if skew:
        # Same fallback: /debug/skew lives on the daemon's server.
        skew_base = (trace_base(url)
                     if url.startswith(("http://", "https://"))
                     else f"http://127.0.0.1:{cfg.listen_port}")
        probes.append(("skew", lambda: check_skew(skew_base)))
    if stores:
        # Same fallback: /debug/stores lives on the daemon's server.
        stores_base = (trace_base(url)
                       if url.startswith(("http://", "https://"))
                       else f"http://127.0.0.1:{cfg.listen_port}")
        probes.append(("stores", lambda: check_stores(stores_base)))
    if cardinality:
        # /debug/cardinality lives on the HUB (the admission layer
        # guards hub-side state); an http(s) --url names the hub,
        # otherwise fall back to a local hub on its default port.
        from .hub import DEFAULT_PORT as _HUB_PORT

        card_base = (trace_base(url)
                     if url.startswith(("http://", "https://"))
                     else f"http://127.0.0.1:{_HUB_PORT}")
        probes.append(("cardinality",
                       lambda: check_cardinality(card_base)))
    if fleet:
        # The fleet lens lives on the HUB, not the daemon: an http(s)
        # --url names the hub to read; otherwise fall back to a local
        # hub on its default port (9401 — hub.DEFAULT_PORT), NOT the
        # daemon's listen port.
        from .hub import DEFAULT_PORT as HUB_DEFAULT_PORT

        fleet_base = (trace_base(url)
                      if url.startswith(("http://", "https://"))
                      else f"http://127.0.0.1:{HUB_DEFAULT_PORT}")
        if fleet_at is not None:
            # --at: retroactive post-mortem from the history ring
            # instead of the live lens.
            probes.append(("fleet-at",
                           lambda: check_fleet_at(fleet_base, fleet_at)))
        else:
            probes.append(("fleet", lambda: check_fleet(fleet_base)))
    if efficiency:
        # The efficiency attestation lives on the HUB like the fleet
        # lens; same base fallback (9401, hub.DEFAULT_PORT). The local
        # --energy-audit-key verifies the rollup's HMAC — the same key
        # contract as --energy.
        from .hub import DEFAULT_PORT as _EFF_HUB_PORT

        eff_base = (trace_base(url)
                    if url.startswith(("http://", "https://"))
                    else f"http://127.0.0.1:{_EFF_HUB_PORT}")
        if efficiency_at is not None:
            # --at: who was wasting cards during the incident — read
            # from the ring, not the live ledger.
            probes.append(("efficiency-at",
                           lambda: check_efficiency_at(eff_base,
                                                       efficiency_at)))
        else:
            probes.append(("efficiency", lambda: check_efficiency(
                eff_base, cfg.energy_audit_key)))
    results: list[CheckResult] = []
    for name, probe in probes:
        results.extend(_bounded(name, probe))
    # Advisory: with no NVML surface under auto, check (bounded) whether
    # the embedded workload-side path would work — only then, so healthy
    # nodes never pay a torch import.
    if cfg.backend == "auto" and not any(
            r.name == "nvml" and r.status == OK for r in results):
        results.extend(_bounded(
            "embedded", lambda: check_embedded_viability(cfg),
            timeout=EMBEDDED_PROBE_TIMEOUT + 30.0))
    return results


def render_text(results: Sequence[CheckResult],
                out: Callable[[str], None] = print) -> None:
    width = max(len(r.name) for r in results)
    for r in results:
        out(f"[{r.status:>4}] {r.name:<{width}}  {r.detail}")
    counts = {s: sum(1 for r in results if r.status == s)
              for s in (OK, WARN, FAIL, SKIP)}
    verdict = "NOT READY" if counts[FAIL] else "READY"
    out(f"{verdict}: {counts[OK]} ok, {counts[WARN]} warn, "
        f"{counts[FAIL]} fail, {counts[SKIP]} skipped")


def main(argv: Sequence[str] | None = None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    as_json = False
    trace = False
    host = False
    energy = False
    egress = False
    skew = False
    stores = False
    cardinality = False
    fleet = False
    efficiency = False
    url = ""
    at_raw = ""
    args: list[str] = []
    it = iter(raw)
    for token in it:
        if token == "--json":
            as_json = True
        elif token == "--trace":
            trace = True
        elif token == "--host":
            host = True
        elif token == "--energy":
            energy = True
        elif token == "--egress":
            egress = True
        elif token == "--skew":
            skew = True
        elif token == "--stores":
            stores = True
        elif token == "--cardinality":
            cardinality = True
        elif token == "--fleet":
            fleet = True
        elif token == "--efficiency":
            efficiency = True
        elif token == "--url":
            url = next(it, "")
            if not url or url.startswith("--"):
                print("--url requires a target (URL or .prom file)",
                      file=sys.stderr)
                return 2
        elif token.startswith("--url="):
            url = token[len("--url="):]
            if not url:
                print("--url requires a target (URL or .prom file)",
                      file=sys.stderr)
                return 2
        elif token == "--at":
            at_raw = next(it, "")
            if not at_raw or at_raw.startswith("--"):
                print("--at requires a time (unix seconds, or an "
                      "ago-offset like 600, 10m, 2h)", file=sys.stderr)
                return 2
        elif token.startswith("--at="):
            at_raw = token[len("--at="):]
            if not at_raw:
                print("--at requires a time (unix seconds, or an "
                      "ago-offset like 600, 10m, 2h)", file=sys.stderr)
                return 2
        else:
            args.append(token)
    fleet_at = None
    efficiency_at = None
    if at_raw:
        if not fleet and not efficiency:
            print("--at only makes sense with --fleet or --efficiency "
                  "(it replays the verdict from the hub's history "
                  "ring)", file=sys.stderr)
            return 2
        try:
            at_ts = parse_at(at_raw, time.time())
        except ValueError as exc:
            print(str(exc), file=sys.stderr)
            return 2
        if fleet:
            fleet_at = at_ts
        if efficiency:
            efficiency_at = at_ts
    cfg = from_args(args)
    started = time.monotonic()
    results = run_checks(cfg, url=url, trace=trace, host=host,
                         energy=energy, egress=egress, skew=skew,
                         stores=stores, cardinality=cardinality,
                         fleet=fleet, fleet_at=fleet_at,
                         efficiency=efficiency,
                         efficiency_at=efficiency_at)
    results.sort(key=lambda r: _ORDER[r.status])
    if as_json:
        print(json.dumps({
            "ready": not any(r.status == FAIL for r in results),
            "elapsed_seconds": round(time.monotonic() - started, 3),
            "checks": [dataclasses.asdict(r) for r in results],
        }, indent=2))
    else:
        render_text(results)
    return 1 if any(r.status == FAIL for r in results) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
