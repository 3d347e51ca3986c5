"""The scrape fan-in and the exposition parser, on local fake servers."""

from __future__ import annotations

import gzip
import http.server
import threading
import time

import pytest

from h100bench.core import expo, scrape

BODY = (b'# TYPE accelerator_up gauge\n'
        b'accelerator_up{accel_type="gpu-h100",chip="0",uuid="GPU-1"} 1\n'
        b'# TYPE collector_poll_duration_seconds histogram\n'
        b'collector_poll_duration_seconds_sum 0.25\n'
        b'collector_poll_duration_seconds_count 5\n'
        b'# EOF\n')


class _Server:
    """A local /metrics server that stalls ``stall_s`` on its first
    request and serves ``body`` gzipped."""

    def __init__(self, body=BODY, stall_s=0.0):
        state = {"first": True}
        self.seen = seen = []

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                seen.append(dict(self.headers))
                if state["first"]:
                    state["first"] = False
                    time.sleep(stall_s)
                data = gzip.compress(body)
                self.send_response(200)
                self.send_header("Content-Encoding", "gzip")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/metrics"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _job(url, phases, seconds, card=None, period_s=1.0):
    return {"url": url, "t0": time.monotonic() + 0.1, "seconds": seconds,
            "scrapers": [{"period_s": period_s, "phase_s": phase,
                          "timeout_s": 10,
                          "headers": {"Accept-Encoding": "gzip"}}
                         for phase in phases],
            "card": card or {"family": "accelerator_up",
                             "labels": {"accel_type": "gpu-h100", "chip": "0"}},
            "keep": {"poll_count": ["collector_poll_duration_seconds_count", {}]}}


def test_the_scraper_times_from_the_due_time_through_a_stall():
    server = _Server(stall_s=2.0)
    try:
        rows = scrape.run(_job(server.url, [0.0], 4.0))["scrapes"]
    finally:
        server.close()
    assert [r["ok"] for r in rows] == [True] * 4
    first, second, third = rows[0], rows[1], rows[2]
    assert first["latency_s"] >= 1.9
    # Due one second in, sent only when the stalled scrape ended.
    assert second["late_s"] >= 0.9
    assert second["latency_s"] >= 0.9
    assert third["latency_s"] < 0.5
    assert all(r["kept"]["poll_count"] == 5 for r in rows)


def test_scrapers_run_open_loop_at_their_phases():
    server = _Server()
    try:
        rows = scrape.run(_job(server.url, [0.0, 0.25, 0.5], 2.0))["scrapes"]
    finally:
        server.close()
    assert len(rows) == 6
    assert [r["scraper"] for r in rows] == [0, 1, 2, 0, 1, 2]
    assert max(r["late_s"] for r in rows) < 0.2


def test_each_scraper_keeps_its_own_period_and_headers():
    server = _Server()
    job = _job(server.url, [0.0, 0.1], 2.0)
    job["scrapers"][1].update(period_s=0.5, headers={
        "Accept-Encoding": "identity", "Connection": "close",
        "User-Agent": "hub-pull"})
    try:
        rows = scrape.run(job)["scrapes"]
    finally:
        server.close()
    assert [r["scraper"] for r in rows].count(0) == 2
    assert [r["scraper"] for r in rows].count(1) == 4
    assert all(r["ok"] for r in rows)
    agents = [h.get("User-Agent", "") for h in server.seen]
    assert agents.count("hub-pull") == 4
    assert all(h["Accept-Encoding"] == "identity"
               for h in server.seen if h.get("User-Agent") == "hub-pull")


def test_the_fan_in_deals_one_set_of_phases_to_every_seed():
    from h100bench.core import common

    traffic = {"scrapers": [{"period_s": 15, "timeout_s": 10, "headers": {}},
                            {"period_s": 15, "timeout_s": 10, "headers": {}},
                            {"period_s": 10, "timeout_s": 5, "headers": {}}]}
    dealt = []
    for seed in (1, 2**31 + 5, 77):
        fanin = common.ScrapeFanIn("http://127.0.0.1:9/metrics", traffic,
                                   seed, {})
        fanin.close()
        dealt.append(sorted(s["phase_s"] / s["period_s"]
                            for s in fanin.job["scrapers"]))
        assert all(0 <= s["phase_s"] < s["period_s"]
                   for s in fanin.job["scrapers"])
    for shares in dealt:
        assert shares == pytest.approx([1 / 6, 1 / 2, 5 / 6])


def test_a_body_without_the_card_is_bad():
    server = _Server()
    try:
        rows = scrape.run(_job(server.url, [0.0], 1.0, card={
            "family": "accelerator_up",
            "labels": {"accel_type": "gpu-h100", "chip": "1"}}))["scrapes"]
    finally:
        server.close()
    assert [(r["ok"], r["bad_body"]) for r in rows] == [(False, True)]


def test_a_refused_scrape_fails_and_counts():
    got = scrape.run(_job("http://127.0.0.1:9/metrics", [0.0], 1.0))
    rows = got["scrapes"]
    assert len(rows) == 1 and not rows[0]["ok"] and not rows[0]["bad_body"]
    assert rows[0]["error"] and rows[0]["timeout_s"] == 10
    assert got["forbidden"] == []


def test_the_parser_reads_labels_escapes_and_openmetrics():
    text = ('# HELP x a\n# TYPE x counter\n'
            'x_total{a="1",b="q\\"uote",c="back\\\\slash"} 3 1700000000\n'
            'y +Inf\nz{} 2.5 # {trace_id="t"} 1\n# EOF\n')
    samples = expo.parse(text)
    assert samples[0] == ("x_total", {"a": "1", "b": 'q"uote',
                                      "c": "back\\slash"}, 3.0)
    assert samples[1][2] == float("inf")
    assert samples[2] == ("z", {}, 2.5)


@pytest.mark.parametrize("text", ["x{a=1} 2\n", "x{a=\"1\" 2\n", "x\n",
                                  "{} 1\n", "x abc\n"])
def test_the_parser_refuses_malformed_lines(text):
    with pytest.raises(expo.ExpositionError):
        expo.parse(text)


def test_decode_gunzips_only_when_told():
    assert expo.decode(gzip.compress(b"a 1\n"), "gzip") == "a 1\n"
    assert expo.decode(b"a 1\n", "") == "a 1\n"
