"""The port's exposition-contract validator: the reference's own tests
(tests/test_validate.py) carried over onto the port's emitter, then the
port's parsers and checker held against the reference's on the same
texts: scrapes of both packages' mock stacks, of the port's NVML backend
with GPM, and the reference's fuzz corpus."""

import base64
import hashlib
import http.server
import random
import threading
import time
import urllib.error

import pytest

from kube_gpu_stats_tpu import validate as ref_validate
from kube_gpu_stats_tpu.collectors.mock import MockCollector as RefMock
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu_torch import cli, validate
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml


def render_ticks(n=1):
    reg = Registry()
    loop = PollLoop(MockCollector(num_devices=2), reg, deadline=5.0)
    texts = []
    for _ in range(n):
        loop.tick()
        texts.append(reg.snapshot().render())
    loop.stop()
    return texts


def test_own_exposition_conforms():
    (text,) = render_ticks()
    assert validate.check(text) == []


def test_monotone_counters_across_ticks():
    first, second = render_ticks(2)
    assert validate.check(second, previous=first) == []


def test_counter_regression_detected():
    first, second = render_ticks(2)
    # Feed the scrapes in reverse order: counters appear to go backwards.
    problems = validate.check(first, previous=second)
    assert any("went backwards" in p for p in problems)


def test_missing_label_detected():
    bad = 'accelerator_duty_cycle{chip="0"} 50\n'
    problems = validate.check(bad)
    assert any("missing labels" in p for p in problems)


def test_unknown_family_detected():
    (text,) = render_ticks()
    bad = text + (
        "accelerator_bogus_metric"
        '{accel_type="",chip="",device_path="",uuid="",pod="",namespace="",'
        'container="",slice="",worker="",topology=""} 1\n'
    )
    problems = validate.check(bad)
    assert any("not in the accelerator_* contract" in p for p in problems)


def test_out_of_range_detected():
    (text,) = render_ticks()
    line = next(l for l in text.splitlines()
                if l.startswith("accelerator_duty_cycle{"))
    bad = text.replace(line, line.rsplit(" ", 1)[0] + " 150")
    problems = validate.check(bad)
    assert any("outside" in p for p in problems)


def test_out_of_range_bandwidth_util_detected():
    (text,) = render_ticks()
    line = next(l for l in text.splitlines()
                if l.startswith("accelerator_memory_bandwidth_utilization{"))
    bad = text.replace(line, line.rsplit(" ", 1)[0] + " 250")
    problems = validate.check(bad)
    assert any("outside" in p for p in problems)


def test_duplicate_series_detected():
    (text,) = render_ticks()
    line = next(l for l in text.splitlines()
                if l.startswith("accelerator_duty_cycle{"))
    problems = validate.check(text + line + "\n")
    assert any("duplicate series" in p for p in problems)


def test_malformed_line_is_a_violation():
    assert validate.check("accelerator_duty_cycle{chip=0} nope") != []


def test_cli_against_file(tmp_path, capsys):
    (text,) = render_ticks()
    path = tmp_path / "scrape.prom"
    path.write_text(text)
    assert validate.main([str(path)]) == 0
    assert "ok:" in capsys.readouterr().out
    path.write_text('accelerator_duty_cycle{chip="0"} 50\n')
    assert validate.main([str(path)]) == 1


def test_trailing_timestamp_accepted():
    line = ('accelerator_duty_cycle{accel_type="t",chip="0",device_path="d",'
            'uuid="",pod="",namespace="",container="",slice="",worker="",'
            'topology=""} 50 1722249600000\n')
    assert validate.check(line) == []


def test_histogram_buckets_checked_for_monotonicity():
    """_bucket/_count series are cumulative; going backwards between two
    scrapes is the counter-reset bug class and must be flagged."""
    before = (
        'collector_poll_duration_seconds_bucket{le="0.05"} 10\n'
        'collector_poll_duration_seconds_count 12\n'
    )
    after = (
        'collector_poll_duration_seconds_bucket{le="0.05"} 4\n'
        'collector_poll_duration_seconds_count 12\n'
    )
    problems = validate.check(after, previous=before)
    assert any("went backwards" in p for p in problems), problems
    assert validate.check(before, previous=before) == []


def test_slice_rollups_checked_for_ranges_and_labels():
    ok = ('slice_target_up{target="http://a:9400/metrics"} 1\n'
          'slice_duty_cycle_mean{slice="s"} 55.5\n'
          'slice_straggler_ratio{slice="s"} 0.9\n')
    assert validate.check(ok) == []
    bad = ('slice_duty_cycle_mean{slice="s"} 250\n'
           'slice_straggler_ratio{slice="s"} 1.5\n'
           'slice_chips{slice="s",bogus="x"} 4\n'
           'slice_chips{slice="t"} 4\n'
           'slice_chips{slice="t"} 5\n')
    problems = validate.check(bad)
    assert any("outside" in p and "slice_duty_cycle_mean" in p
               for p in problems)
    assert any("outside" in p and "slice_straggler_ratio" in p
               for p in problems)
    assert any("unexpected labels" in p and "bogus" in str(p)
               for p in problems)
    assert any("duplicate series" in p for p in problems)


def test_unknown_slice_family_flagged():
    problems = validate.check('slice_duty_cycle_avg{slice="s"} 50\n')
    assert problems and "not in the slice_* rollup contract" in problems[0]


def test_slice_rollup_missing_labels_flagged():
    problems = validate.check('slice_chips 4\n')
    assert problems and "missing labels" in problems[0]


class _Redirector(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        self.send_response(302)
        self.send_header("Location", "http://127.0.0.1:1/steal")
        self.send_header("Content-Length", "0")
        self.end_headers()


def _serve(handler):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}/metrics"


def test_authed_fetch_refuses_redirects():
    server, url = _serve(_Redirector)
    try:
        # With a credential the redirect is refused (the Authorization
        # header must never chase a cross-origin Location).
        with pytest.raises(urllib.error.HTTPError):
            validate.fetch_exposition(
                url, timeout=5, headers={"Authorization": "Bearer secret"})
    finally:
        server.shutdown()
        server.server_close()


def test_auth_headers_helper(tmp_path):
    token = tmp_path / "token"
    token.write_text("tok123\n")
    assert validate.auth_headers(bearer_token_file=str(token)) == {
        "Authorization": "Bearer tok123"}
    pw = tmp_path / "pw"
    pw.write_text("hubpass\n")
    header = validate.auth_headers(username="scraper", password_file=str(pw))
    assert header["Authorization"] == "Basic " + base64.b64encode(
        b"scraper:hubpass").decode()
    # Unreadable file: {} and a warning, never a crash.
    assert validate.auth_headers(
        bearer_token_file=str(tmp_path / "absent")) == {}


def test_auth_headers_survives_binary_credential_file(tmp_path):
    bad = tmp_path / "token"
    bad.write_bytes(b"\xff\xfe\x00garbage")
    assert validate.auth_headers(bearer_token_file=str(bad)) == {}


def _basic_auth_server(registry, username, password_sha256):
    """The port's exposition behind basic auth. The port's MetricsServer
    has no auth yet, so this small server plays the hardened exporter:
    401 without the right credential, the registry's render with it."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            header = self.headers.get("Authorization", "")
            ok = False
            if header.startswith("Basic "):
                user, _, password = base64.b64decode(
                    header[6:]).decode().partition(":")
                ok = (user == username and hashlib.sha256(
                    password.encode()).hexdigest() == password_sha256)
            body = registry.snapshot().render().encode() if ok else b""
            self.send_response(200 if ok else 401)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return _serve(Handler)


def test_validate_cli_authenticates(tmp_path, capsys):
    reg = Registry()
    loop = PollLoop(MockCollector(num_devices=1), reg, deadline=5.0)
    loop.tick()
    server, url = _basic_auth_server(
        reg, "ci", hashlib.sha256(b"checkpass").hexdigest())
    pw = tmp_path / "pw"
    pw.write_text("checkpass")
    try:
        assert validate.main([url, "--auth-username", "ci",
                              "--auth-password-file", str(pw)]) == 0
        capsys.readouterr()
        assert validate.main([url]) == 2  # 401 without credentials
        capsys.readouterr()
        assert validate.main([url, "--auth-username", "ci"]) == 2  # no file
        capsys.readouterr()
    finally:
        loop.stop()
        server.shutdown()
        server.server_close()


def test_fetch_exposition_caps_response_size():
    class Firehose(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = b"x" * 4096
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server, url = _serve(Firehose)
    try:
        # Under the cap: full body.
        assert len(validate.fetch_exposition(url, timeout=5)) == 4096
        # Over the cap: a ValueError per target, never an OOM.
        with pytest.raises(ValueError, match="exceeds"):
            validate.fetch_exposition(url, timeout=5, max_bytes=1024)
    finally:
        server.shutdown()
        server.server_close()


def test_lowercase_authorization_header_still_refuses_redirects():
    server, url = _serve(_Redirector)
    try:
        with pytest.raises(urllib.error.HTTPError):
            validate.fetch_exposition(
                url, timeout=5, headers={"authorization": "Bearer secret"})
    finally:
        server.shutdown()
        server.server_close()


def _fuzz_corpus(seed=0xC0FFEE, count=300):
    """The reference's fuzz corpus: raw bytes, junk labels, backslash
    runs (regex backtracking bait)."""
    rng = random.Random(seed)
    for _ in range(count):
        kind = rng.randrange(3)
        if kind == 0:
            yield bytes(rng.randrange(256)
                        for _ in range(rng.randrange(0, 300))
                        ).decode("latin-1")
        elif kind == 1:
            labels = "".join(rng.choice('a="b",\\"x{}=') for _ in range(40))
            yield f"metric_{rng.randrange(9)}{{{labels}}} {rng.random()}\n"
        else:
            yield 'm{a="' + "\\" * rng.randrange(1, 120) + '"} 1\n'


def test_parse_exposition_fuzz_never_crashes():
    """The hub/top feed REMOTE text into parse_exposition: any input must
    either parse or raise ValueError — never another exception type and
    never pathological time (the label regex is backtracking-safe)."""
    start = time.monotonic()
    for text in _fuzz_corpus():
        try:
            validate.parse_exposition(text)
        except ValueError:
            pass
    assert time.monotonic() - start < 10.0


def test_stale_label_allowed_on_gauges_only():
    """stale="true" (resilience degradation marker) is legal on
    per-device gauges, illegal on counters (a label flip mid-outage
    blinds increase()) and on accelerator_up (the health contract)."""
    base = ('accel_type="gpu-h100",chip="0",device_path="/dev/nvidia0",'
            'uuid="",pod="",namespace="",container="",slice="",worker="",'
            'topology=""')
    ok = f'accelerator_power_watts{{{base},stale="true"}} 100\n'
    assert validate.check(ok) == []
    bad_counter = (f'accelerator_energy_joules_total{{{base},'
                   f'stale="true"}} 5\n')
    problems = validate.check(bad_counter)
    assert problems and "stale" in problems[0]
    bad_up = f'accelerator_up{{{base},stale="true"}} 0\n'
    problems = validate.check(bad_up)
    assert problems and "stale" in problems[0]


def test_retry_after_seconds_parses_and_bounds():
    """The parser takes only the delta-seconds form, never raises, and
    caps how long one bad header can silence a publisher."""
    assert validate.retry_after_seconds({"Retry-After": "2.5"}) == 2.5
    assert validate.retry_after_seconds({"Retry-After": "0"}) == 0.0
    assert validate.retry_after_seconds({}) == 1.0
    assert validate.retry_after_seconds(None, default=3.0) == 3.0
    # HTTP-date form, garbage, negatives, NaN: the default, not a crash.
    assert validate.retry_after_seconds(
        {"Retry-After": "Wed, 21 Oct 2015 07:28:00 GMT"}) == 1.0
    assert validate.retry_after_seconds({"Retry-After": "-5"}) == 1.0
    assert validate.retry_after_seconds({"Retry-After": "nan"}) == 1.0
    # One hostile header cannot demand an hour of silence.
    assert validate.retry_after_seconds({"Retry-After": "99999"}) == 300.0


# -- the port against the reference -------------------------------------------


@pytest.mark.parametrize("code", [200, 204, 301, 302, 400, 401, 404, 413,
                                  415, 429, 500, 503])
def test_classify_push_status_matches_the_reference(code):
    assert validate.classify_push_status(code) == \
        ref_validate.classify_push_status(code)


def _ref_ticks(n):
    reg = RefRegistry()
    loop = RefPollLoop(RefMock(num_devices=2), reg, deadline=5.0)
    texts = []
    for _ in range(n):
        loop.tick()
        texts.append(reg.snapshot().render())
    loop.stop()
    return texts


def _nvml_gpm_ticks(n):
    """The port's NVML backend over a scripted H100 with GPM: from the
    second tick both GPM families are served."""
    dev = FakeDevice(uuid="GPU-a", minor=2, gpu_util=97, mem_util=40,
                     memory_used=3 << 30, gpm_supported=True,
                     tensor_util=61.5, dram_bw_util=33.25,
                     nvlink_kib={0: (10, 20)})
    reg = Registry()
    # Blocking: each tick serves its own reads, so GPM shows from the
    # second tick.
    loop = PollLoop(NvmlCollector(FakeNvml([dev])), reg, deadline=5.0,
                    pipeline_fetch=False)
    texts = []
    try:
        for tick in range(n):
            dev.energy_mj += 1000
            dev.nvlink_kib[0] = (10 + tick, 20 + tick)
            loop.tick()
            texts.append(reg.snapshot().render())
    finally:
        loop.stop()
    return texts


SCRAPES = {
    "port_mock": lambda: render_ticks(2),
    "reference_mock": lambda: _ref_ticks(2),
    "port_nvml_gpm": lambda: _nvml_gpm_ticks(3)[1:],
}


@pytest.mark.parametrize("source", sorted(SCRAPES))
def test_parsers_and_check_match_the_reference_on_scrapes(source):
    first, second = SCRAPES[source]()
    for text in (first, second):
        assert validate.parse_exposition(text) == \
            ref_validate.parse_exposition(text)
        assert validate.parse_exposition_interned(text) == \
            ref_validate.parse_exposition_interned(text)
        assert validate.parse_exposition_reference(text) == \
            ref_validate.parse_exposition_reference(text)
        assert validate.parse_exposition(text) == \
            validate.parse_exposition_reference(text)
    assert validate.check(second, previous=first) == \
        ref_validate.check(second, previous=first) == []
    reversed_problems = validate.check(first, previous=second)
    assert reversed_problems == ref_validate.check(first, previous=second)


def test_the_port_nvml_scrape_serves_gpm_and_conforms():
    texts = _nvml_gpm_ticks(3)
    names = [{name for name, _, _ in validate.parse_exposition(text)}
             for text in texts]
    gpm = {"accelerator_tensorcore_utilization",
           "accelerator_memory_bandwidth_utilization"}
    assert not gpm & names[0]  # the first tick has no interval yet
    assert gpm <= names[1] and gpm <= names[2]
    for before, after in zip(texts, texts[1:]):
        assert validate.check(after, previous=before) == []


@pytest.mark.parametrize("seed", [0xC0FFEE, 1, 2])
def test_parsers_and_check_match_the_reference_on_the_fuzz_corpus(seed):
    for text in _fuzz_corpus(seed):
        outcomes = []
        for module in (validate, ref_validate):
            for parse in (module.parse_exposition,
                          module.parse_exposition_interned,
                          module.parse_exposition_reference):
                try:
                    outcomes.append(("ok", parse(text)))
                except ValueError as exc:
                    outcomes.append(("ValueError", str(exc)))
        assert outcomes[:3] == outcomes[3:], text
        assert validate.check(text) == ref_validate.check(text), text


def test_cli_validate_subcommand(tmp_path, capsys):
    (text,) = render_ticks()
    path = tmp_path / "scrape.prom"
    path.write_text(text)
    assert cli.main(["validate", str(path)]) == 0
    assert "ok:" in capsys.readouterr().out
    path.write_text('accelerator_duty_cycle{chip="0"} 50\n')
    assert cli.main(["validate", "--two-scrapes", str(path)]) == 1

