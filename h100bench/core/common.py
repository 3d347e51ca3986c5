"""Pieces every driver uses: the scraper child, one-off scrapes, the card's
readings from ``nvidia-smi``, the peak table and the percentile."""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

from . import expo

ROOT = Path(__file__).resolve().parents[2]
SCRAPE_CHILD = Path(__file__).resolve().parent / "scrape.py"

# Peak dense bf16 tensor-core FLOP/s and HBM bytes/s of one card, by a
# substring of its name, from NVIDIA's H100 data sheet (SXM part, 700 W).
PEAKS = (("H100 80GB HBM3", 989e12, 3.35e12),)

# The families whose deltas over the window the per-layer readers take:
# key -> (family, labels).
KEEP = {
    "poll_sum": ("collector_poll_duration_seconds_sum", {}),
    "poll_count": ("collector_poll_duration_seconds_count", {}),
    "http_sum": ("collector_scrape_duration_seconds_sum", {"output": "http"}),
    "http_count": ("collector_scrape_duration_seconds_count", {"output": "http"}),
    "cache_hits": ("kts_render_cache_hits_total", {}),
    "cache_misses": ("kts_render_cache_misses_total", {}),
}


# time.monotonic() at the process's start; run.py sets it.
START = time.monotonic()


def mark(phase: str) -> None:
    """Log a set-up phase's end on stderr, in seconds since the start."""
    print(f"h100bench: {phase} at {time.monotonic() - START:.2f} s",
          file=sys.stderr, flush=True)


def peaks(kind: str) -> tuple[float, float] | None:
    """(FLOP/s, bytes/s) of the card named ``kind``; None when unknown."""
    for needle, flops, bw in PEAKS:
        if needle in kind:
            return flops, bw
    return None


def percentile(sorted_values: list[float], q: float) -> float:
    """The value at rank ``round(q * (n - 1))`` of the sorted values."""
    if not sorted_values:
        return float("nan")
    idx = min(len(sorted_values) - 1,
              max(0, round(q * (len(sorted_values) - 1))))
    return sorted_values[idx]


def child_env() -> dict:
    """The environment of the benchmark's children: the checkout on the
    path, so ``h100bench`` and the program import from it."""
    existing = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=(
        f"{ROOT}{os.pathsep}{existing}" if existing else str(ROOT)))


class ScrapeFanIn:
    """The scraper child: started in set-up, given its window at ``go``,
    read after it.

    Each scraper of the traffic file scrapes every ``period_s`` seconds
    with its own headers and timeout. The phases are one fixed set, the
    scraper's period times (i + 0.5) / n for i < n scrapers, dealt out by
    the seed: every seed sends the same number of scrapes in the window."""

    def __init__(self, url: str, traffic: dict, seed: int,
                 card_labels: dict) -> None:
        self.proc = subprocess.Popen(
            [sys.executable, str(SCRAPE_CHILD)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, env=child_env(), cwd=ROOT)
        n = len(traffic["scrapers"])
        shares = [(i + 0.5) / n for i in range(n)]
        random.Random(seed).shuffle(shares)
        self.job = {
            "url": url,
            "scrapers": [
                {"period_s": s["period_s"], "phase_s": share * s["period_s"],
                 "headers": s["headers"], "timeout_s": s["timeout_s"]}
                for s, share in zip(traffic["scrapers"], shares)],
            "card": {"family": "accelerator_up", "labels": card_labels},
            "keep": {k: [f, labels] for k, (f, labels) in KEEP.items()},
        }

    def go(self, t0: float, seconds: float) -> None:
        self.job.update(t0=t0, seconds=seconds)
        self.proc.stdin.write(json.dumps(self.job).encode())
        self.proc.stdin.close()

    def result(self, timeout: float) -> tuple[list[dict], list[str]]:
        """The child's judged scrapes and the forbidden modules it held."""
        # The child ends within the window plus one scrape timeout.
        out = self.proc.stdout.read()
        self.proc.wait(timeout=timeout)
        if self.proc.returncode != 0:
            raise RuntimeError(f"the scraper child exited {self.proc.returncode}")
        got = json.loads(out)
        return got["scrapes"], got["forbidden"]

    def close(self) -> None:
        end(self.proc)


def end(proc: subprocess.Popen) -> None:
    """Kill ``proc`` if it still runs, wait for it, close its pipes."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    for pipe in (proc.stdin, proc.stdout):
        if pipe is not None and not pipe.closed:
            pipe.close()


def after_tick(url: str, offset: float = 0.2, timeout: float = 5.0) -> float:
    """``offset`` seconds after the exporter's next published tick, on
    time.monotonic: the window opens there, so every run's scrapes fall
    at the same points of the exporter's 1 s cycle."""
    first = expo.total(scrape(url), KEEP["poll_count"][0]) or 0.0
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        seen = time.monotonic()
        if (expo.total(scrape(url), KEEP["poll_count"][0]) or 0.0) > first:
            return seen + offset
        time.sleep(0.01)
    raise RuntimeError(f"the exporter published no tick in {timeout} s")


def report_scrapes(scrapes: list[dict]) -> None:
    """How late the generator ran and each scraper's latency, on stderr."""
    late = sorted(s["late_s"] * 1e3 for s in scrapes)
    if not late:
        return
    series = sorted({s["series"] for s in scrapes if s["ok"]})
    print(f"h100bench: series served per scrape {series[:1] + series[-1:]}",
          file=sys.stderr)
    print(f"h100bench: {len(scrapes)} scrapes; generator late ms p50 "
          f"{percentile(late, 0.5):.3f} p99 {percentile(late, 0.99):.3f} "
          f"max {late[-1]:.3f}", file=sys.stderr)
    lat = sorted(s["latency_s"] * 1e3 for s in scrapes)
    print("h100bench: latency ms " + " ".join(
        f"p{round(q * 100)} {percentile(lat, q):.3f}"
        for q in (0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99))
        + f" mean {sum(lat) / len(lat):.3f}", file=sys.stderr)
    by = {}
    for s in scrapes:
        by.setdefault(s["scraper"], []).append(s["latency_s"] * 1e3)
    print("h100bench: latency ms by scraper (p50/max): " + " ".join(
        f"{k}:{percentile(sorted(v), 0.5):.2f}/{max(v):.2f}"
        for k, v in sorted(by.items())), file=sys.stderr)


def scrape(url: str, timeout: float = 10.0) -> list:
    """One scrape of ``url``, parsed (the harness's own reads, outside the
    fan-in)."""
    req = urllib.request.Request(url, headers={"Accept-Encoding": "gzip"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read()
        encoding = resp.headers.get("Content-Encoding", "")
    return expo.parse(expo.decode(body, encoding))


def wait_ticks(url: str, after: float, ticks: int = 2,
               timeout: float = 15.0) -> list:
    """A scrape taken once the exporter has published ``ticks`` more ticks
    than ``after`` (its poll count), read every half second."""
    deadline = time.monotonic() + timeout
    while True:
        samples = scrape(url)
        count = expo.total(samples, KEEP["poll_count"][0]) or 0.0
        if count >= after + ticks:
            return samples
        if time.monotonic() > deadline:
            raise RuntimeError(f"the exporter published {count - after:.0f} "
                               f"of {ticks} ticks in {timeout} s")
        time.sleep(0.5)


def smi(fields: str) -> list[str]:
    """``nvidia-smi``'s values of ``fields`` for card 0."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={fields}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return [v.strip() for v in out.strip().splitlines()[0].split(",")]


def window_scrapes(scrapes: list[dict], t0: float, seconds: float) -> list[dict]:
    return [s for s in scrapes if t0 <= s["due"] < t0 + seconds]


def counters(scrapes: list[dict]) -> dict:
    """Each kept family's value in the first and in the last good scrape
    that serves it (a histogram is born with its first observation)."""
    first: dict = {}
    last: dict = {}
    for s in scrapes:
        if not s["ok"]:
            continue
        for key, value in s["kept"].items():
            if value is not None:
                first.setdefault(key, value)
                last[key] = value
    return {"first": first, "last": last} if first else {}
