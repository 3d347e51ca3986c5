"""The port's pipelined tick against the JAX package's, case for case.

The reference's own pipelined cases (``tests/test_poll.py``: a wedged
read not served frozen, a full timeout that does not re-arm the fast
path, the rate-feed dedup on ``runtime_fetch_seq``) run on both loops
with one scripted collector written once per trait (the reference's
``Collector`` and the port's); each case holds its own expectations on
either loop, and then the two loops' tick-by-tick observations (served
``accelerator_up`` and values per card, the ``deadline``/``stuck``/
``fetch_deadline`` counts, the journal's ``pipeline_*`` events) against
each other.

Then the NVML backend: the port's ``NvmlCollector`` over
``testing.fake_nvml`` drives both loops (the reference's loop takes any
collector with the split surface). A memory read that stalls past the
deadline for less than two intervals costs the card no tick when the
loop pipelines, and serves it down for that tick under
``--no-pipeline-fetch``. A round whose NVLink read stalls is re-served
by the next tick; the generation (``runtime_fetch_seq``) then stands
still, so the served bandwidth never reads a zero and then a double.
"""

import concurrent.futures
import threading
import time

import pytest

from kube_gpu_stats_tpu import collectors as ref_collectors
from kube_gpu_stats_tpu import schema as ref_schema
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu_torch import collectors as port_collectors
from kube_gpu_stats_tpu_torch import config, schema
from kube_gpu_stats_tpu_torch.collectors.nvml import NvmlCollector
from kube_gpu_stats_tpu_torch.poll import PollLoop as PortPollLoop
from kube_gpu_stats_tpu_torch.registry import Registry as PortRegistry
from kube_gpu_stats_tpu_torch.testing.fake_nvml import FakeDevice, FakeNvml

SIDES = {
    "reference": (RefPollLoop, lambda: RefRegistry(native=False),
                  ref_collectors),
    "port": (PortPollLoop, PortRegistry, port_collectors),
}
COUNTS = ("deadline", "stuck", "fetch_deadline")


def _loop(side: str, collector, **kwargs):
    loop_cls, registry_cls, _ = SIDES[side]
    registry = registry_cls()
    return loop_cls(collector, registry, **kwargs), registry


def _by_chip(registry, name: str) -> dict[str, float]:
    return {dict(s.labels)["chip"]: s.value
            for s in registry.snapshot().series if s.spec.name == name}


def observe(loop, registry) -> dict:
    """What one tick served, in the terms both loops share."""
    events = loop.tracer.events(0)["events"]
    return {
        "up": _by_chip(registry, schema.DEVICE_UP.name),
        "power": _by_chip(registry, schema.POWER.name),
        "duty": _by_chip(registry, schema.DUTY_CYCLE.name),
        "bandwidth": _by_chip(registry, schema.ICI_BANDWIDTH.name),
        "counts": {reason: loop._errors.get(reason, 0) for reason in COUNTS},
        "events": [(e["kind"], e["attrs"].get("device"))
                   for e in events if e["kind"].startswith("pipeline_")],
    }


def _split_collector(module, wedge_all: bool):
    """The reference's scripted split collectors (WedgeableSplit and
    AlwaysWedged) for either trait: two cards, each read parks on its
    gate while one is set."""

    class Split(module.Collector):
        name = "split"
        pipelined_wait = True

        def __init__(self):
            self.block: dict[str, threading.Event] = {}
            self.gate = threading.Event()

        def discover(self):
            return [module.Device(i, str(i), f"/dev/nvidia{i}", "stub")
                    for i in range(2)]

        def begin_tick(self):
            pass

        def wait_ready(self, timeout=None, max_age=None):
            pass

        def read_environment(self, device):
            if wedge_all:
                self.gate.wait(timeout=5)
            gate = self.block.get(device.device_id)
            if gate is not None:
                gate.wait(timeout=5)
            return {schema.POWER.name: 50.0}

        def assemble(self, device, env, env_err, runtime_ready=True):
            values = {schema.DUTY_CYCLE.name: 42.0}
            values.update(env)
            return module.Sample(device, values)

        def sample(self, device):
            return self.assemble(device, self.read_environment(device), None)

    return Split()


# -- the reference's pipelined cases, on both loops ----------------------------


def run_wedged_read(side: str) -> list[dict]:
    """test_wedged_env_read_not_served_frozen_by_pipelined_tick: card 0's
    read wedges; the fence demotes it to the outstanding guard; later
    pipelined ticks keep it down (stuck) while card 1 pipelines; once it
    unwedges, card 0 recovers."""
    col = _split_collector(SIDES[side][2], wedge_all=False)
    t = [100.0]
    loop, registry = _loop(side, col, interval=0.05, deadline=0.3,
                           clock=lambda: t[0])  # fence = 0.1
    gate = threading.Event()
    seen = []
    try:
        loop.tick()  # blocking cold tick: both reads complete
        seen.append(observe(loop, registry))
        col.block["0"] = gate  # card 0's next read wedges
        t[0] += 0.05
        loop.tick()  # pipelined: serves the cold round, starts one
        seen.append(observe(loop, registry))
        # Card 1's read lands, so the demotion below hits card 0 only.
        concurrent.futures.wait([loop._env_round["1"]], timeout=2)
        t[0] += 0.20  # past the fence: the wedged read is demoted
        loop.tick()  # blocking fallback: card 0 stuck
        seen.append(observe(loop, registry))
        t[0] += 0.05
        loop.tick()  # pipelined again (card 1 refreshed the fence)
        seen.append(observe(loop, registry))
        gate.set()  # the backend unwedges; the parked read completes
        col.block.clear()
        for _ in range(3):  # reap -> re-included round -> harvested
            t[0] += 0.05
            time.sleep(0.05)
            loop.tick()
            seen.append(observe(loop, registry))
    finally:
        gate.set()
        loop.stop()
    return seen


def run_full_timeout(side: str) -> list[dict]:
    """test_full_env_timeout_does_not_rearm_pipelined_fast_path: every
    read misses the deadline; every later tick blocks again."""
    col = _split_collector(SIDES[side][2], wedge_all=True)
    t = [100.0]
    loop, registry = _loop(side, col, interval=0.05, deadline=0.05,
                           clock=lambda: t[0])
    seen = []
    try:
        loop.tick()  # cold blocking tick: both reads time out
        seen.append(observe(loop, registry))
        for _ in range(3):
            t[0] += 0.05
            loop.tick()
            seen.append(observe(loop, registry))
    finally:
        col.gate.set()
        loop.stop()
    return seen


def _seq_collector(module):
    """test_unchanged_fetch_generation_replays_ici_rates' collector."""

    class SeqCollector(module.Collector):
        name = "seq"

        def __init__(self):
            self.counter = 1000
            self.runtime_fetch_seq = 1

        def discover(self):
            return [module.Device(0, "0", "/dev/nvidia0", "stub")]

        def sample(self, device):
            return module.Sample(device, {schema.DUTY_CYCLE.name: 1.0},
                                 ici_counters={"nvlink0": self.counter})

    return SeqCollector()


def run_generation_replay(side: str) -> list[dict]:
    """A tick re-serving the SAME generation replays the previous rates;
    the baseline is untouched by the duplicate."""
    col = _seq_collector(SIDES[side][2])
    t = [50.0]
    loop, registry = _loop(side, col, deadline=5.0, clock=lambda: t[0])
    seen = []
    try:
        for at, counter, seq in ((50.0, 1000, 1), (51.0, 2000, 2),
                                 (52.0, 2000, 2), (53.0, 4000, 3)):
            t[0] = at
            col.counter, col.runtime_fetch_seq = counter, seq
            loop.tick()
            seen.append(observe(loop, registry))
    finally:
        loop.stop()
    return seen


CASES = {"wedged_read": run_wedged_read, "full_timeout": run_full_timeout,
         "generation_replay": run_generation_replay}


@pytest.mark.parametrize("side", SIDES)
def test_wedged_env_read_not_served_frozen_by_pipelined_tick(side):
    seen = run_wedged_read(side)
    assert seen[0]["power"] == {"0": 50.0, "1": 50.0}
    fallback, pipelined = seen[2], seen[3]
    assert fallback["up"] == {"0": 0.0, "1": 1.0}
    # Still wedged: visibly down and counted, never the frozen power.
    assert pipelined["up"]["0"] == 0.0 and "0" not in pipelined["power"]
    assert pipelined["counts"]["stuck"] >= 2
    assert "1" in pipelined["power"]
    assert ("pipeline_fence", None) in pipelined["events"]
    assert ("pipeline_demote", "0") in pipelined["events"]
    assert ("pipeline_resume", None) in pipelined["events"]
    assert seen[-1]["power"] == {"0": 50.0, "1": 50.0}
    assert seen[-1]["up"] == {"0": 1.0, "1": 1.0}


@pytest.mark.parametrize("side", SIDES)
def test_full_env_timeout_does_not_rearm_pipelined_fast_path(side):
    seen = run_full_timeout(side)
    for tick in seen:
        assert tick["up"] == {"0": 0.0, "1": 0.0}
    assert seen[0]["counts"]["deadline"] == 2
    assert seen[-1]["counts"]["stuck"] == 6
    assert all(kind != "pipeline_resume" for kind, _ in seen[-1]["events"])


@pytest.mark.parametrize("side", SIDES)
def test_unchanged_fetch_generation_replays_ici_rates(side):
    bandwidth = [tick["bandwidth"] for tick in run_generation_replay(side)]
    # No rate on the first observation; the re-served generation replays
    # 1000, not 0; the baseline stays (4000-2000)/(53-51), not /1.
    assert bandwidth == [{}, {"0": 1000.0}, {"0": 1000.0}, {"0": 1000.0}]


@pytest.mark.parametrize("case", CASES)
def test_the_port_ticks_as_the_reference_does(case):
    assert CASES[case]("port") == CASES[case]("reference")


# -- the NVML backend: C5, a stalled read ------------------------------------

INTERVAL = 0.15
STALL_S = 0.12  # past the 50 ms deadline, under the 2-interval fence


def _nvml(stall_call: str = "", every: int = 0,
          nvlink_kib=None) -> tuple[FakeNvml, NvmlCollector]:
    dev = FakeDevice(uuid="GPU-0000-c5", minor=3, gpu_util=97,
                     memory_used=3 << 30, power_mw=650_000,
                     nvlink_kib=dict(nvlink_kib or {}))
    if stall_call:
        dev.stalls[stall_call] = (STALL_S, every)
    fake = FakeNvml([dev])
    return fake, NvmlCollector(fake)


def run_stalled_memory_read(side: str, pipeline: bool) -> list[dict]:
    """One card at INTERVAL on the real clock; every 4th memory read
    stalls STALL_S, as NVML's did on the H100 (C5)."""
    fake, collector = _nvml("memory", 4)
    loop, registry = _loop(side, collector, interval=INTERVAL,
                           deadline=0.05, pipeline_fetch=pipeline)
    seen = []
    try:
        for _ in range(7):
            started = time.monotonic()
            loop.tick()
            seen.append(observe(loop, registry))
            time.sleep(max(0.0, INTERVAL - (time.monotonic() - started)))
    finally:
        loop.stop()
        collector.close()
    assert fake.devices[0].calls["memory"] >= 7
    return seen


@pytest.mark.parametrize("side", SIDES)
def test_a_stalled_nvml_read_costs_the_pipelined_tick_nothing(side):
    seen = run_stalled_memory_read(side, pipeline=True)
    assert [tick["up"] for tick in seen] == [{"0": 1.0}] * len(seen)
    assert seen[-1]["counts"] == {"deadline": 0, "stuck": 0,
                                  "fetch_deadline": 0}
    assert seen[-1]["events"] == []
    assert all(tick["power"] == {"0": 650.0} for tick in seen)


@pytest.mark.parametrize("side", SIDES)
def test_without_pipelining_a_stalled_nvml_read_serves_the_card_down(side):
    seen = run_stalled_memory_read(side, pipeline=False)
    ups = [tick["up"]["0"] for tick in seen]
    # The 4th read stalls: its tick misses the deadline.
    assert ups.count(0.0) >= 1 and ups[0] == 1.0
    assert seen[-1]["counts"]["deadline"] >= 1
    assert seen[-1]["events"] == []


@pytest.mark.parametrize("pipeline", [True, False])
def test_the_port_serves_a_stalled_nvml_read_as_the_reference_does(pipeline):
    want = run_stalled_memory_read("reference", pipeline)
    got = run_stalled_memory_read("port", pipeline)
    assert [t["up"] for t in got] == [t["up"] for t in want]
    assert got[-1]["counts"] == want[-1]["counts"]
    assert got[-1]["events"] == want[-1]["events"]


# -- the NVML backend: the rate-feed dedup on runtime_fetch_seq ---------------

KIB_PER_TICK = 1000  # per direction, per link: 2000 KiB a tick in all


class _PerTick(NvmlCollector):
    """The trap the generation avoids: a generation that advances every
    tick, whatever the loop serves."""

    def wait_ready(self, timeout=None, max_age=None):
        self._rounds.join(pipelined=False)


def run_stalled_nvlink_round(side: str, collector_cls=NvmlCollector
                             ) -> list[dict]:
    """The card's NVLink counters grow KIB_PER_TICK a tick on the
    injected clock. One round's NVLink read stalls STALL_S and answers
    the counters of the time it returns (two ticks' growth), so the
    tick after it re-serves the round before."""
    fake = FakeNvml([FakeDevice(uuid="GPU-0000-c5", minor=3,
                                nvlink_kib={0: (0, 0)})])
    collector = collector_cls(fake)
    dev = fake.devices[0]
    t = [100.0]
    loop, registry = _loop(side, collector, interval=1.0, deadline=0.05,
                           clock=lambda: t[0])
    kib = 0

    def grow(ticks: int) -> None:
        nonlocal kib
        kib += ticks * KIB_PER_TICK
        dev.nvlink_kib = {0: (kib, kib)}

    def settle() -> None:
        if loop._env_round:
            concurrent.futures.wait(list(loop._env_round.values()),
                                    timeout=5)

    seen = []
    try:
        for k in range(9):
            if k == 5:
                # The next NVLink read stalls, and answers two ticks'
                # growth; the tick after it comes before it answers.
                dev.stalls["field_values"] = (
                    STALL_S, dev.calls["field_values"] + 1)
                grow(2)
            elif k != 6:
                grow(1)
            loop.tick()
            seen.append(observe(loop, registry))
            if k != 5:
                settle()
            t[0] += 1.0
    finally:
        loop.stop()
        collector.close()
    return seen


@pytest.mark.parametrize("side", SIDES)
def test_a_re_served_round_replays_its_nvlink_rate(side):
    seen = run_stalled_nvlink_round(side)
    assert [tick["up"] for tick in seen] == [{"0": 1.0}] * len(seen)
    rates = [tick["bandwidth"].get("0") for tick in seen]
    steady = 2 * KIB_PER_TICK * 1024.0
    # The cold tick's counters are the first observation; the first
    # pipelined tick re-serves them (no rate yet), so the first rate
    # spans two ticks of the clock and one of growth. From then on the
    # steady 2000 KiB/s — no zero for the re-served tick, no double
    # after it.
    assert rates == [None, None, steady / 2] + [steady] * 6


def test_a_generation_per_tick_would_feed_a_zero_then_a_double():
    rates = [tick["bandwidth"].get("0")
             for tick in run_stalled_nvlink_round("port", _PerTick)]
    steady = 2 * KIB_PER_TICK * 1024.0
    # The first pipelined tick re-serves the cold tick's counters (a
    # zero), and so does the tick after the stalled round — which the
    # round's two ticks of growth then follow as a double.
    assert rates[1] == 0.0
    assert any(rates[k] == 0.0 and rates[k + 1] == 2 * steady
               for k in range(2, len(rates) - 1))


def test_the_port_replays_nvlink_rates_as_the_reference_does():
    got = [tick["bandwidth"] for tick in run_stalled_nvlink_round("port")]
    want = [tick["bandwidth"]
            for tick in run_stalled_nvlink_round("reference")]
    assert got == want


def test_the_generation_advances_once_per_completed_round():
    fake, collector = _nvml(nvlink_kib={0: (1, 1)})
    (dev,) = collector.discover()
    seqs = []
    collector.begin_tick()
    env = collector.read_environment(dev)
    collector.wait_ready(0.05, max_age=2.0)  # the round is complete
    seqs.append(collector.runtime_fetch_seq)
    collector.assemble(dev, env)
    for _ in range(3):  # re-served: no new round
        collector.begin_tick()
        collector.wait_ready(0.05, max_age=2.0)
        seqs.append(collector.runtime_fetch_seq)
    collector.begin_tick()
    collector.read_environment(dev)
    collector.wait_ready(0.05, max_age=2.0)
    seqs.append(collector.runtime_fetch_seq)
    for _ in range(2):  # blocking joins: each serves its own round
        collector.begin_tick()
        collector.wait_ready(0.05)
        seqs.append(collector.runtime_fetch_seq)
    collector.close()
    assert seqs == [1, 1, 1, 1, 2, 3, 4]


def test_sample_is_assemble_of_read_environment():
    fake, collector = _nvml(nvlink_kib={0: (3, 4)})
    (dev,) = collector.discover()
    sample = collector.sample(dev)
    again = collector.assemble(dev, collector.read_environment(dev))
    assert sample.values == again.values
    assert sample.ici_counters == again.ici_counters == {"nvlink0": 7 * 1024}
    fake.devices[0].lost = True
    with pytest.raises(port_collectors.CollectorError):
        collector.read_environment(dev)
    with pytest.raises(port_collectors.CollectorError, match="GPU is lost"):
        collector.sample(dev)
    with pytest.raises(port_collectors.CollectorError):
        collector.assemble(dev, {}, port_collectors.CollectorError("lost"))
    collector.close()


def test_no_pipeline_fetch_flag_matches_the_reference(monkeypatch):
    from kube_gpu_stats_tpu import config as ref_config

    assert config.from_args([]).pipeline_fetch is \
        ref_config.from_args([]).pipeline_fetch is True
    assert config.from_args(["--no-pipeline-fetch"]).pipeline_fetch is False
    monkeypatch.setenv("KTS_NO_PIPELINE_FETCH", "1")
    assert config.from_args([]).pipeline_fetch is \
        ref_config.from_args([]).pipeline_fetch is False


def test_the_daemon_passes_pipeline_fetch(monkeypatch):
    from kube_gpu_stats_tpu_torch import daemon

    for argv, want in (([], 2.0), (["--no-pipeline-fetch"], None)):
        cfg = config.from_args(["--backend", "mock", "--listen-host",
                                "127.0.0.1", "--listen-port", "0",
                                "--attribution", "off", *argv])
        instance = daemon.Daemon(cfg)
        instance.start()
        try:
            assert instance.poll._fetch_max_age == want
        finally:
            instance.stop()
