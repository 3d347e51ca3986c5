"""How a host's network stack answers senders of a receiver that goes away.

Test support beside ``egress_sink``: it measures what the smoke's
outages look like to a sender on the machine at hand. Three legs, each
timing every request a sender makes:

- ``closed``: POSTs to a port nothing listens on;
- ``close``: ``clients`` threads POST at ``rate_hz`` each while an
  ``EgressSink`` closes its listener and, ``down_s`` later, opens it
  again on the same port, ``cycles`` times;
- ``blackout``: the same, through the sink's ``blackout``/``restore``
  (the listener stays and resets each connection).

A request is slow when it takes over ``slow_s``; on a Linux kernel none
is, while under gVisor a connection made as a listener closes can wait
out the sender's whole timeout. Run it as

    python -m kube_gpu_stats_tpu_torch.testing.listener_probe

which prints one JSON object: per leg the requests, the outcomes by
kind, and each slow request's seconds and outcome.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.error
import urllib.request

from ..delta import push_opener
from .egress_sink import EgressSink


def timed_post(url: str, timeout: float) -> tuple[float, str]:
    """(seconds, outcome) of one small POST: "ok" or the error's kind."""
    request = urllib.request.Request(url, data=b"probe", method="POST")
    start = time.monotonic()
    try:
        with push_opener().open(request, timeout=timeout) as response:
            response.read()
        outcome = "ok"
    except urllib.error.HTTPError as exc:
        outcome = f"HTTP {exc.code}"
    except Exception as exc:  # noqa: BLE001 - the kind is the result
        reason = getattr(exc, "reason", exc)
        outcome = (type(reason).__name__ if isinstance(reason, BaseException)
                   else str(reason))
    return time.monotonic() - start, outcome


class _Leg:
    def __init__(self, slow_s: float) -> None:
        self.slow_s = slow_s
        self.kinds: dict[str, int] = {}
        self.slow: list[tuple[float, str]] = []
        self._lock = threading.Lock()

    def add(self, seconds: float, outcome: str) -> None:
        with self._lock:
            self.kinds[outcome] = self.kinds.get(outcome, 0) + 1
            if seconds > self.slow_s:
                self.slow.append((round(seconds, 3), outcome))

    def row(self) -> dict:
        return {"requests": sum(self.kinds.values()),
                "kinds": dict(sorted(self.kinds.items())),
                "slow": sorted(self.slow, reverse=True)}


def closed_leg(seconds: float, timeout: float, slow_s: float) -> dict:
    sink = EgressSink().start()
    url = sink.url + "/ingest/delta"
    sink.stop()
    leg = _Leg(slow_s)
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        leg.add(*timed_post(url, timeout))
    return leg.row()


def cycling_leg(mode: str, cycles: int, clients: int, rate_hz: float,
                timeout: float, slow_s: float, up_s: float = 0.4,
                down_s: float = 0.6) -> dict:
    """``mode`` "close" (close, then reopen) or "blackout" (reset)."""
    sink = EgressSink().start()
    url = sink.url + "/ingest/delta"
    leg = _Leg(slow_s)
    stop = threading.Event()

    def client() -> None:
        while not stop.is_set():
            leg.add(*timed_post(url, timeout))
            stop.wait(1.0 / rate_hz)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for thread in threads:
        thread.start()
    try:
        for _ in range(cycles):
            time.sleep(up_s)
            if mode == "close":
                sink.stop()
                time.sleep(down_s)
                sink.start()
            else:
                sink.blackout()
                time.sleep(down_s)
                sink.restore()
    finally:
        stop.set()
        for thread in threads:
            thread.join(timeout + 1.0)
        sink.stop()
    return leg.row()


def probe(*, closed_s: float = 10.0, cycles: int = 30, clients: int = 3,
          rate_hz: float = 100.0, timeout: float = 5.0,
          slow_s: float = 0.3) -> dict:
    return {
        "closed": closed_leg(closed_s, timeout, slow_s),
        "close": cycling_leg("close", cycles, clients, rate_hz, timeout,
                             slow_s),
        "blackout": cycling_leg("blackout", cycles, clients, rate_hz,
                                timeout, slow_s),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--closed-seconds", type=float, default=10.0)
    parser.add_argument("--cycles", type=int, default=30)
    parser.add_argument("--clients", type=int, default=3)
    parser.add_argument("--rate-hz", type=float, default=100.0)
    parser.add_argument("--timeout", type=float, default=5.0)
    args = parser.parse_args(argv)
    print(json.dumps(probe(closed_s=args.closed_seconds, cycles=args.cycles,
                           clients=args.clients, rate_hz=args.rate_hz,
                           timeout=args.timeout)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
