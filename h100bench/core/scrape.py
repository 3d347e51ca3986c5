"""The scrape fan-in: independent scrapers, each an open loop at its own
period and phase with its own request headers, every scrape timed from the
moment it was due to its last byte.

Runs as a child process of the benchmark (``python h100bench/core/scrape.py``,
the job as JSON on stdin, the result as JSON on stdout) and imports only
the standard library: scrapers inside the measured process would measure
the harness's own hold on the interpreter lock. ``run`` is the same loop
in process, for tests.

A scraper whose scrape runs past the next due time sends the overdue
scrapes as soon as it can, each still timed from its own due time, so a
stall shows in every scrape it delays. Bodies are kept raw while the
window runs and decoded, parsed and checked after it, so the generator
spends its time on sending.
"""

from __future__ import annotations

import gc
import http.client
import json
import sys
import threading
import time
import urllib.parse
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100bench.core import expo  # noqa: E402
from h100bench.core.isolation import forbidden_modules  # noqa: E402

SPIN_S = 0.003


def _scraper(job: dict, index: int, out: list) -> None:
    url = urllib.parse.urlsplit(job["url"])
    t0, seconds = job["t0"], job["seconds"]
    me = job["scrapers"][index]
    period, phase = me["period_s"], me["phase_s"]
    # A scraper that asks for ``Connection: close`` (urllib, the hub's
    # client) opens a connection per scrape; the others keep theirs alive.
    one_shot = me["headers"].get("Connection", "").lower() == "close"
    conn = None
    k = 0
    while True:
        due = t0 + phase + k * period
        k += 1
        if due >= t0 + seconds:
            break
        # Sleep to within SPIN_S of the due time, then spin: a sleep alone
        # wakes late by the scheduler's jitter, which would count as
        # latency of the scrape.
        delay = due - SPIN_S - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        while time.monotonic() < due:
            pass
        sent = time.monotonic()
        record = {"scraper": index, "due": due, "sent": sent, "status": None,
                  "error": None, "body": b"", "encoding": ""}
        try:
            if conn is None:
                conn = http.client.HTTPConnection(
                    url.hostname, url.port, timeout=me["timeout_s"])
            conn.request("GET", url.path or "/", headers=me["headers"])
            resp = conn.getresponse()
            record["body"] = resp.read()
            record["status"] = resp.status
            record["encoding"] = resp.getheader("Content-Encoding", "")
            if one_shot or resp.will_close:
                conn.close()
                conn = None
        except (OSError, http.client.HTTPException) as exc:
            record["error"] = f"{type(exc).__name__}: {exc}"
            if conn is not None:
                conn.close()
            conn = None
        record["done"] = time.monotonic()
        out.append(record)
    if conn is not None:
        conn.close()


def _judge(record: dict, job: dict) -> dict:
    """The scrape's latency and verdict; its body decoded, parsed and
    held to the card's identity; the families ``job["keep"]`` names."""
    row = {"scraper": record["scraper"], "due": record["due"],
           "timeout_s": job["scrapers"][record["scraper"]]["timeout_s"],
           "late_s": record["sent"] - record["due"],
           "latency_s": record["done"] - record["due"],
           "status": record["status"], "error": record["error"],
           "ok": False, "bad_body": False, "kept": {}}
    if record["error"] is not None or record["status"] != 200:
        return row
    try:
        samples = expo.parse(expo.decode(record["body"], record["encoding"]))
    except (OSError, EOFError, UnicodeDecodeError, expo.ExpositionError) as exc:
        row.update(bad_body=True, error=f"{type(exc).__name__}: {exc}")
        return row
    card = job["card"]
    if not expo.serves_card(samples, card["family"], card["labels"]):
        row.update(bad_body=True, error="the card is not served")
        return row
    row["ok"] = True
    row["series"] = len(samples)
    for key, (family, labels) in job["keep"].items():
        row["kept"][key] = expo.total(samples, family, labels)
    return row


def run(job: dict) -> dict:
    """Run the scrapers of ``job`` and judge every scrape.

    ``job``: ``url``; ``t0`` (time.monotonic of the window's start) and
    ``seconds``; ``scrapers``, one dict each: ``period_s``, ``phase_s``
    (its first scrape's offset from ``t0``), ``headers``, ``timeout_s``;
    ``card`` (``family`` and ``labels`` a body must serve); ``keep``
    (key -> [family, labels]). The result also names the forbidden
    modules this process holds (``forbidden``)."""
    records: list[dict] = []
    threads = [threading.Thread(target=_scraper, args=(job, i, records),
                                name=f"scraper-{i}", daemon=True)
               for i in range(len(job["scrapers"]))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    rows = [_judge(record, job) for record in records]
    rows.sort(key=lambda row: (row["due"], row["scraper"]))
    return {"scrapes": rows, "forbidden": forbidden_modules()}


def main() -> int:
    job = json.load(sys.stdin)
    # No collector pauses in the generator while the window runs.
    gc.disable()
    json.dump(run(job), sys.stdout)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
