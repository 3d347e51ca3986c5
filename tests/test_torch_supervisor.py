"""The supervisor: a killed poll thread comes back, and the health report
(and with it ``/healthz``) reads as the JAX package's for the same
component states.
"""

import time
import urllib.request

import pytest

from kube_gpu_stats_tpu.exposition import MetricsServer as RefServer
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.registry import SnapshotBuilder as RefBuilder
from kube_gpu_stats_tpu.resilience import BackoffPolicy as RefBackoff
from kube_gpu_stats_tpu.resilience import CircuitBreaker as RefBreaker
from kube_gpu_stats_tpu.supervisor import Supervisor as RefSupervisor
from kube_gpu_stats_tpu_torch.collectors.mock import MockCollector
from kube_gpu_stats_tpu_torch.exposition import MetricsServer
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.registry import Registry, SnapshotBuilder
from kube_gpu_stats_tpu_torch.resilience import BackoffPolicy, CircuitBreaker
from kube_gpu_stats_tpu_torch.supervisor import Supervisor


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class _Dies(MockCollector):
    """Its first sample after ``armed`` ends the poll thread: an exception
    no ``except Exception`` contains, as an interpreter-level failure
    would."""

    armed = False

    def sample(self, device):
        if self.armed:
            self.armed = False
            raise SystemExit("poll thread killed")
        return super().sample(device)


# The kill is an exception escaping the thread on purpose.
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_killed_poll_thread_is_respawned():
    registry = Registry()
    collector = _Dies(2)
    supervisor = Supervisor(check_interval=0.02)
    loop = PollLoop(collector, registry, interval=0.02, deadline=5.0,
                    health_stats=supervisor.contribute,
                    heartbeat=supervisor.beater("poll"))
    supervisor.register("poll", is_alive=loop.thread_alive,
                        restart=loop.respawn, heartbeat_timeout=5.0,
                        backoff=BackoffPolicy(base=0.02, cap=0.1))
    loop.start()
    supervisor.start()
    try:
        assert registry.wait_for_publish(0, timeout=5)
        first = loop._thread
        collector.armed = True
        deadline = time.monotonic() + 10
        while loop._thread is first or not loop.thread_alive():
            assert time.monotonic() < deadline, "never respawned"
            time.sleep(0.01)
        generation = registry.generation
        assert registry.wait_for_publish(generation, timeout=5)
        (row,) = supervisor.health()
        assert row.restarts == 1
        assert row.state == "degraded"
        assert "thread dead" in row.reason
        text = registry.rendered()[0].decode()
        assert 'kts_component_restarts_total{component="poll"} 1' in text
    finally:
        supervisor.stop()
        loop.stop()
    assert not first.is_alive()


def _states(supervisor_cls, breaker_cls, backoff_cls, clock):
    """Every health state at once: healthy, dead (stale), hung (stale),
    restarted recently (degraded), an owned open breaker (degraded), an
    unowned open breaker and a closed one (own rows)."""
    supervisor = supervisor_cls(clock=clock)
    supervisor.register("poll", is_alive=lambda: True, heartbeat_timeout=5.0)
    supervisor.register("textfile", is_alive=lambda: False)
    supervisor.register("procwatch", is_alive=lambda: True,
                        heartbeat_timeout=2.0)
    revived = {"alive": False}
    supervisor.register("render-warmer", is_alive=lambda: revived["alive"],
                        restart=lambda: revived.update(alive=True),
                        backoff=backoff_cls(base=1.0, cap=2.0))
    supervisor.register("attribution", is_alive=lambda: True,
                        breaker_prefixes=("kubelet",))
    kubelet = breaker_cls("kubelet", failure_threshold=1, clock=clock)
    kubelet.record_failure("connection refused\n  (socket gone)")
    other = breaker_cls("remote", failure_threshold=1, clock=clock)
    other.record_failure("503")
    spare = breaker_cls("spare", clock=clock)
    supervisor.register_breaker_provider(lambda: {"kubelet": kubelet})
    supervisor.register_breaker_provider(
        lambda: {"remote": other, "spare": spare})
    supervisor.beat("poll")
    assert supervisor.check_once() == ["render-warmer"]
    clock.now += 3.0  # procwatch misses its 2 s heartbeat
    supervisor.beat("poll")
    return supervisor


def test_health_report_matches_the_reference():
    ref_clock, port_clock = FakeClock(), FakeClock()
    ref = _states(RefSupervisor, RefBreaker, RefBackoff, ref_clock)
    port = _states(Supervisor, CircuitBreaker, BackoffPolicy, port_clock)
    assert list(port.health_report()) == list(ref.health_report())
    states = {name: state for name, state, _ in port.health_report()}
    assert states == {"poll": "healthy", "textfile": "stale",
                      "procwatch": "stale", "render-warmer": "degraded",
                      "attribution": "degraded", "remote": "degraded",
                      "spare": "healthy"}
    ref_builder, port_builder = RefBuilder(), SnapshotBuilder()
    ref.contribute(ref_builder)
    port.contribute(port_builder)
    assert ([(s.spec.name, s.labels, s.value)
             for s in port_builder.build().series]
            == [(s.spec.name, s.labels, s.value)
                for s in ref_builder.build().series])


def _healthz(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=5) as resp:
        return resp.read().decode()


def test_healthz_body_matches_the_reference():
    bodies = []
    for server_cls, registry, sup_cls, breaker_cls, backoff_cls in (
            (RefServer, RefRegistry(native=False), RefSupervisor, RefBreaker,
             RefBackoff),
            (MetricsServer, Registry(), Supervisor, CircuitBreaker,
             BackoffPolicy)):
        supervisor = _states(sup_cls, breaker_cls, backoff_cls, FakeClock())
        server = server_cls(registry, "127.0.0.1", 0,
                            health_provider=supervisor.health_report)
        server.start()
        try:
            bodies.append(_healthz(server.port))
        finally:
            server.stop()
    want, got = bodies
    assert got == want
    assert got.startswith("ok\n")
    assert "component=textfile state=stale reason=thread dead\n" in got
    assert ("component=attribution state=degraded reason=breaker kubelet "
            "open\n") in got
