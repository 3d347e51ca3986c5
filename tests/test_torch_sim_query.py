"""The port's query sim against the reference's ``tools/query_sim.py``.

Both run at the reference's parameters (16 pushers, 256 readers x 4
requests 0.4 s apart, 100 conditionals a surface, a hammer of 40).
Asserted are the figures the scenario fixes and that they equal the
reference's: every reader's request answered, the ring's bytes unchanged
by the storm and equal to the reference's with the same bound, at least
half 304s on ``/query`` and ``/metrics`` under a steady generation, and
the 429s, the gate's ``shed_total`` and ``kts_query_shed_total`` equal,
each 429 with a ``Retry-After`` of at least 1. The reference's p50 and
p99 pins measure the host (HOST_SPEED): both sides' latencies and how
many requests the gate shed are printed, not asserted. Both sims' servers
run without the render pre-warmer (``prewarm_renders=False``), and the
switch does on both packages' ``MetricsServer`` what it does on the
reference's.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import re
import sys

import pytest

import chip_smoke
from kube_gpu_stats_tpu_torch.sims import query

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import query_sim  # noqa: E402  (the reference's sim)

pytestmark = pytest.mark.chaos

# The reference's checks that pin the host's speed: its latency pins.
HOST_SPEED = ("query p50 ", "query p99 ")


@pytest.mark.parametrize("prewarm", [True, False])
def test_the_render_warmer_switch_as_the_reference(prewarm):
    from kube_gpu_stats_tpu.exposition import MetricsServer as RefServer
    from kube_gpu_stats_tpu.registry import Registry as RefRegistry
    from kube_gpu_stats_tpu_torch.exposition import MetricsServer
    from kube_gpu_stats_tpu_torch.registry import Registry

    alive = {}
    for name, server_cls, registry_cls in (
            ("reference", RefServer, RefRegistry),
            ("port", MetricsServer, Registry)):
        server = server_cls(registry_cls(), host="127.0.0.1", port=0,
                            prewarm_renders=prewarm)
        server.start()
        try:
            alive[name] = (server.prewarm_enabled,
                           server.warm_thread_alive())
            server.respawn_warm()
            alive[name] += (server.warm_thread_alive(),)
        finally:
            server.stop()
    assert alive["port"] == alive["reference"] == (prewarm,) * 3


def test_the_dashboard_stampede_as_the_reference():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = query_sim.run(verbose=True)
    text = out.getvalue()
    print(text)
    problems = [] if rc == 0 else [
        line.strip() for line in text.split("query-sim FAIL:", 1)[1]
        .splitlines() if line.strip()]
    assert [p for p in problems if not p.startswith(HOST_SPEED)] == []
    ring, bound, shed = map(int, re.search(
        r"ring (\d+) bytes \(bound (\d+), flat\); steady-gen 304s >= 50% "
        r"on /query and /metrics; gate shed (\d+) of 40 with Retry-After, "
        r"exported counter agrees", text).groups())

    port = query.run()
    print(port.report(port.name))
    assert port.problems == []
    fig = port.figures
    assert (fig["readers"], fig["requests"], fig["reader_errors"]) \
        == (query_sim.READERS,
            query_sim.READERS * query_sim.REQUESTS_PER_READER, 0)
    assert (fig["ring_bytes"], fig["ring_bound"]) == (ring, bound)
    assert fig["ring_flat"] and fig["ring_within_bound"]
    assert min(fig["ratio_304"].values()) >= query_sim.RATIO_FLOOR
    assert fig["hammer"] == query_sim.HAMMER
    assert fig["shed"] and shed > 0
    assert fig["shed_equals_gate"] and fig["exported_equals_gate"]
    assert fig["bad_retry_after"] == 0 and fig["other_statuses"] == []
    want = chip_smoke.SIMS_EXACT["query"]
    assert {key: fig[key] for key in want} == want
    assert (query.P50_PIN_MS, query.P99_PIN_MS) == (query_sim.P50_PIN_MS,
                                                    query_sim.P99_PIN_MS)
