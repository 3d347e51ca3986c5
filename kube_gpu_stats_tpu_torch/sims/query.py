"""Query: a dashboard stampede on a hub that keeps refreshing.

The port of the reference's ``tools/query_sim.py``: a real hub behind a
real ``MetricsServer`` serves ``/query`` to hundreds of concurrent
readers while its refresh keeps publishing:

- **the stampede**: 256 keep-alive readers, each 4 requests 0.4 s apart,
  against a hub that refreshes every 0.1 s. Every request answers 200;
  the p50 and p99 are reported beside the reference's 15/25 ms pins
  (``pins_met``), which measure the host;
- **conditionals under a steady generation**: with the refreshes
  stopped, 100 requests carrying ``If-None-Match`` draw at least 50%
  304s on ``/query`` and on ``/metrics``;
- **the shed**: with the per-client gate tightened to 2 a second, one
  client's 40 back-to-back requests draw 429s equal to the gate's
  ``shed_total`` delta exactly, each with a ``Retry-After`` of at least
  1, and ``kts_query_shed_total`` agrees after the next publish;
- **the ring's memory**: the storm adds no byte to the history ring,
  which stays within its slab arithmetic (``max_series *
  series_bytes``).

How many requests the gate sheds depends on how fast the host sends
them; that the three counts agree does not. The server runs no render
warmer (``prewarm_renders=False``, as the reference's sim): what is
timed is the serving path alone, without a thread re-rendering and
gzipping ``/metrics`` behind every refresh.
"""

from __future__ import annotations

import http.client
import threading
import time

from ._common import Result
from .chaos import SessionFleet

PUSHERS = 16
READERS = 256
REQUESTS_PER_READER = 4
PERIOD_S = 0.4                # a reader's /query pacing (~2.5 Hz)
P50_PIN_MS = 15.0
P99_PIN_MS = 25.0
RATIO_FLOOR = 0.5             # the 304 floor under a steady generation
CONDITIONALS = 100            # conditional requests a surface
HAMMER = 40                   # the one client's back-to-back requests
GATE_RATE = GATE_BURST = 2.0
FAMILIES = ("slice_chips", "slice_duty_cycle_mean", "slice_power_watts",
            "slice_memory_used_bytes")


def counter_value(text: str, name: str) -> float:
    """The sum of an exported counter's rows (0.0 when absent)."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name) and line[len(name)] in " {":
            total += float(line.rsplit(" ", 1)[1])
    return total


def _stampede(port: int, hub) -> tuple[list[float], list[str]]:
    """(latencies, reader errors) of the readers against a hub that
    refreshes every 0.1 s meanwhile."""
    stop_refresh = threading.Event()

    def refresher() -> None:
        while not stop_refresh.is_set():
            hub.refresh_once()
            stop_refresh.wait(0.1)

    latencies: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()
    barrier = threading.Barrier(READERS + 1)

    def reader(idx: int) -> None:
        mine: list[float] = []
        path = f"/query?family={FAMILIES[idx % len(FAMILIES)]}&window=1h"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10.0)
        try:
            # Connected before the barrier; the first requests spread over
            # one period, as a dashboard fleet holding its connections is
            # never phase-locked.
            conn.connect()
            barrier.wait()
            time.sleep(idx * (PERIOD_S / READERS))
            for _ in range(REQUESTS_PER_READER):
                start = time.perf_counter()
                conn.request("GET", path)
                resp = conn.getresponse()
                body = resp.read()
                mine.append(time.perf_counter() - start)
                if resp.status != 200:
                    raise AssertionError(
                        f"{path} -> {resp.status}: {body[:80]!r}")
                time.sleep(PERIOD_S)
        except Exception as exc:  # noqa: BLE001 - evidence, not a trace
            with lock:
                errors.append(f"reader {idx}: {exc!r}")
            return
        finally:
            conn.close()
        with lock:
            latencies.extend(mine)

    refresh_thread = threading.Thread(target=refresher, daemon=True)
    refresh_thread.start()
    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(READERS)]
    for thread in threads:
        thread.start()
    barrier.wait()
    for thread in threads:
        thread.join(timeout=60.0)
    stop_refresh.set()
    refresh_thread.join(timeout=10.0)
    return sorted(latencies), errors


def conditional_ratio(port: int, path: str) -> float:
    """The share of CONDITIONALS requests carrying the last ETag that
    answer 304."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        resp.read()
        etag = resp.getheader("ETag", "")
        hits = 0
        for _ in range(CONDITIONALS):
            conn.request("GET", path, headers={"If-None-Match": etag})
            resp = conn.getresponse()
            resp.read()
            if resp.status == 304:
                hits += 1
            else:
                etag = resp.getheader("ETag", etag)
        return hits / CONDITIONALS
    finally:
        conn.close()


def run() -> Result:
    from ..exposition import MetricsServer
    from ..history import HistoryStore, QueryGate
    from ..hub import Hub

    result = Result("query")
    problems = result.problems
    fig, timings = result.figures, result.timings
    # No gate for the stampede and the conditionals: every reader here is
    # 127.0.0.1, and one shared bucket would turn them into a shed test.
    store = HistoryStore(query_qps=0.0)
    hub = Hub([], targets_provider=lambda: [], interval=10.0,
              push_fence=1e9, ingest_lanes=2,
              ingest_max_sessions=PUSHERS + 8, history=store)
    server = MetricsServer(hub.registry, host="127.0.0.1", port=0,
                           max_concurrent_scrapes=0,
                           ingest_provider=hub.delta.handle,
                           history_provider=store,
                           prewarm_renders=False)
    server.start()
    port = server.port
    try:
        fleet = SessionFleet(port, PUSHERS, prefix="panel")
        bad = [o for o in fleet.seed() if o[1] != 200]
        if bad:
            problems.append(f"seeding failed: {bad[:3]}")
        hub.refresh_once()
        hub.refresh_once()
        bytes_before = store.bytes()
        bound = store.max_series * store.series_bytes

        stampede_from = time.monotonic()
        latencies, errors = _stampede(port, hub)
        timings["stampede_s"] = time.monotonic() - stampede_from
        if errors:
            problems.append(f"{len(errors)} of {READERS} readers failed: "
                            + "; ".join(errors[:3]))
        if latencies:
            p50 = latencies[len(latencies) // 2] * 1000.0
            p99 = latencies[int(len(latencies) * 0.99) - 1] * 1000.0
        else:
            p50 = p99 = float("inf")
        timings.update(p50_ms=p50, p99_ms=p99, p50_pin_ms=P50_PIN_MS,
                       p99_pin_ms=P99_PIN_MS,
                       pins_met=p50 < P50_PIN_MS and p99 < P99_PIN_MS)
        # The storm read history and must have written none: the ring's
        # bytes are a function of the tracked series alone.
        bytes_after = store.bytes()
        ring_flat = bytes_after == bytes_before
        if not ring_flat:
            problems.append(f"the ring grew under the reader storm: "
                            f"{bytes_before} -> {bytes_after} bytes")
        within = bytes_after <= bound
        if not within:
            problems.append(f"ring {bytes_after} bytes above its bound "
                            f"{bound} (max_series x series_bytes)")
        fig.update(readers=READERS, requests=len(latencies),
                   reader_errors=len(errors), ring_flat=ring_flat,
                   ring_within_bound=within, ring_bytes=bytes_after,
                   ring_bound=bound)

        # A steady generation: the conditionals.
        ratios = {}
        for surface, path in (("query", "/query?family=slice_chips"
                                        "&window=1h"),
                              ("metrics", "/metrics")):
            ratios[surface] = conditional_ratio(port, path)
            if ratios[surface] < RATIO_FLOOR:
                problems.append(f"{path.split('?')[0]} 304 ratio "
                                f"{ratios[surface]:.2f} under a steady "
                                f"generation (floor: {RATIO_FLOOR})")
        fig["ratio_304"] = ratios

        # The tightened gate sheds with exact accounting.
        store.gate = QueryGate(rate=GATE_RATE, burst=GATE_BURST)
        shed_before = store.gate.shed_total
        observed = 0
        retry_afters: list[str | None] = []
        others: list[int] = []
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10.0)
        try:
            for _ in range(HAMMER):
                conn.request("GET", "/query?family=slice_chips&window=1h")
                resp = conn.getresponse()
                resp.read()
                if resp.status == 429:
                    observed += 1
                    retry_afters.append(resp.getheader("Retry-After"))
                elif resp.status != 200:
                    others.append(resp.status)
        finally:
            conn.close()
        if others:
            problems.append(f"the hammer saw {others[:3]}, want 200 or 429")
        shed_delta = store.gate.shed_total - shed_before
        if observed == 0:
            problems.append(f"the gate at {GATE_RATE:g} qps never shed "
                            f"across {HAMMER} back-to-back requests")
        if observed != shed_delta:
            problems.append(f"shed accounting drifted: the client saw "
                            f"{observed} 429s, the gate counted "
                            f"{shed_delta}")
        bad_retry = [r for r in retry_afters
                     if r is None or not r.isdigit() or int(r) < 1]
        if bad_retry:
            problems.append(f"429s without a usable Retry-After: "
                            f"{bad_retry[:3]}")
        # The third view of the same ledger: the exported counter after
        # the next publish.
        hub.refresh_once()
        exported = counter_value(hub.registry.snapshot().render(),
                                 "kts_query_shed_total")
        if exported != store.gate.shed_total:
            problems.append(f"kts_query_shed_total exports {exported:g}, "
                            f"the gate counted {store.gate.shed_total}")
        fig.update(hammer=HAMMER, shed=observed > 0,
                   shed_equals_gate=observed == shed_delta,
                   exported_equals_gate=exported == store.gate.shed_total,
                   bad_retry_after=len(bad_retry), other_statuses=others)
        timings.update(shed_429=observed)
    finally:
        server.stop()
        hub.stop()
    return result


def add_arguments(parser) -> None:
    pass


def main(args) -> Result:
    result = run()
    t = result.timings
    print(result.report(
        f"{READERS} keep-alive readers rode a refreshing hub at p50 "
        f"{t.get('p50_ms', 0.0):.1f} ms / p99 {t.get('p99_ms', 0.0):.1f} ms "
        f"(pins {P50_PIN_MS:g}/{P99_PIN_MS:g}, reported), steady-generation "
        f"conditionals drew >= {RATIO_FLOOR:.0%} 304s, the tightened gate "
        f"shed {t.get('shed_429')} requests with the three counts equal, "
        f"the ring fixed"))
    return result
