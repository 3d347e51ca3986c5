"""The reference's soak (``tests/test_soak.py``) on the port's NVML daemon.

The full daemon over 4 fake cards that flap between lost and back every
0.5 s, under 3 scrapers, with remote write 2.0 and a Pushgateway pusher
shipping into a receiver that fails every other request. Held to the
reference's checks: no crash, the generation advancing (more than 100
publishes in 6 s), no thread leak (the count within the reference's slack
of 8 of its settled value), bounded memory, full metrics back after the
flapping, both senders shipping through the flaky receiver; and, beyond
the reference, every scrape ``validate.check``-clean.
"""

from __future__ import annotations

import http.server
import threading
import time
import urllib.request

import pytest

from kube_gpu_stats_tpu_torch import procstats, validate
from kube_gpu_stats_tpu_torch.config import Config
from kube_gpu_stats_tpu_torch.daemon import Daemon
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml
from kube_gpu_stats_tpu_torch.testing.nvml_faults import NvmlFaults

pytestmark = pytest.mark.chaos


class FlakyReceiver(http.server.ThreadingHTTPServer):
    """A remote-write and Pushgateway sink that answers 204 and 503 in
    turn, per method, first attempt 204 (the reference's)."""

    def __init__(self):
        outer = self
        self.hits = {"POST": 0, "PUT": 0}

        class Handler(http.server.BaseHTTPRequestHandler):
            def _serve(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                outer.hits[self.command] += 1
                self.send_response(
                    204 if outer.hits[self.command] % 2 else 503)
                self.end_headers()

            do_POST = do_PUT = _serve

            def log_message(self, *args):
                pass

        super().__init__(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.serve_forever, daemon=True).start()


def test_soak_flapping_cards(tmp_path):
    fake = FakeNvml([FakeDevice(uuid=f"GPU-{i:08x}-0000-0000-0000-"
                                     f"000000000000", minor=i, gpu_util=70,
                                power_mw=250_000,
                                nvlink_kib={0: (0, 0), 1: (0, 0)})
                     for i in range(4)])
    receiver = FlakyReceiver()
    port = receiver.server_address[1]
    cfg = Config(
        backend="nvml",
        interval=0.03,
        deadline=0.5,
        listen_host="127.0.0.1",
        listen_port=0,
        attribution="off",
        rediscovery_interval=0.5,
        textfile_dir=str(tmp_path / "tf"),
        remote_write_url=f"http://127.0.0.1:{port}/push",
        remote_write_interval=0.1,
        remote_write_protocol="2.0",
        pushgateway_url=f"http://127.0.0.1:{port}",
    )
    faults = NvmlFaults(fake)
    daemon = Daemon(cfg, nvml=faults)
    daemon.start()
    stop = threading.Event()
    # Scrapes taken, and those that served a card down (the flap seen).
    seen = {"scrapes": 0, "down": 0}
    problems: list[str] = []

    def scraper():
        url = f"http://127.0.0.1:{daemon.server.port}/metrics"
        while not stop.is_set():
            try:
                body = urllib.request.urlopen(url, timeout=2).read().decode()
            except Exception:  # noqa: BLE001 - a refused scrape is noise
                continue
            seen["scrapes"] += 1
            seen["down"] += "accelerator_duty_cycle{" not in body
            problems.extend(validate.check(body))
            time.sleep(0.01)

    threads = [threading.Thread(target=scraper, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    try:
        assert daemon.registry.wait_for_publish(0, timeout=5)
        settle = threading.active_count()
        rss_start = procstats.read().get("process_resident_memory_bytes", 0)
        start_gen = daemon.registry.generation
        deadline = time.monotonic() + 6.0
        flip = True
        while time.monotonic() < deadline:
            # Flap every card every 500 ms.
            faults.lost = set(range(len(fake.devices))) if flip else set()
            for dev in fake.devices:
                for link, (tx, rx) in dev.nvlink_kib.items():
                    dev.nvlink_kib[link] = (tx + 1000, rx + 1000)
            flip = not flip
            time.sleep(0.5)
        faults.lost = set()

        gens = daemon.registry.generation - start_gen
        assert gens > 100, f"only {gens} publishes in 6s soak"
        assert threading.active_count() <= settle + 8, (
            settle, threading.active_count())
        rss_end = procstats.read().get("process_resident_memory_bytes", 0)
        if rss_start and rss_end:
            assert rss_end - rss_start < 30 * 1024 * 1024, (rss_start,
                                                            rss_end)
        time.sleep(0.5)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{daemon.server.port}/metrics",
            timeout=2).read().decode()
        assert body.count("accelerator_up{") == 4
        assert body.count("} 1\n", body.index("accelerator_up{")) >= 4
        assert "accelerator_duty_cycle{" in body
        # A lost card is per card, even when every card is lost at once:
        # the library answered throughout.
        assert 'kts_breaker_state{component="nvml"} 0' in body
        assert daemon.remote_writer.pushes_total > 0
        assert daemon.remote_writer.failures_total > 0
        assert daemon.pusher.pushes_total > 0
        assert 'collector_push_total{mode="remote_write"}' in body
        # Both halves of the flap were served, and every scrape was clean.
        assert 0 < seen["down"] < seen["scrapes"], seen
        assert seen["scrapes"] > 50 and not problems, problems[:5]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=2)
        daemon.stop()
        receiver.shutdown()
        receiver.server_close()
