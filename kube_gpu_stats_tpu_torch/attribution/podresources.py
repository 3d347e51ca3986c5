"""PodResources v1 allocation source — kubelet unix-socket gRPC client
(``List()`` on the attribution cadence).

The socket is guarded by a circuit breaker (component name "kubelet"): a
kubelet that is persistently gone is refused fast — no 5 s RPC deadline
paid per refresh cycle — while :class:`~..attribution.CachedAttribution`
keeps serving the last-good pod↔device mapping (labeled stale once the
breaker is open). ``grpc`` is imported only when this source is built, so
a node without ``grpcio`` still runs the daemon (``--attribution auto``
then degrades to the checkpoint file or to no pod labels).
"""

from __future__ import annotations

from . import RESOURCE_NAMES, Labels, index_allocations
from ..proto import podresources as pb
from ..resilience import CLOSED, BreakerOpenError, CircuitBreaker


class PodResourcesSource:
    def __init__(self, socket_path: str, rpc_timeout: float = 5.0,
                 breaker: CircuitBreaker | None = None) -> None:
        import grpc

        self._channel = grpc.insecure_channel(
            f"unix://{socket_path}",
            options=[("grpc.enable_http_proxy", 0)],
        )
        self._list = self._channel.unary_unary(
            pb.LIST_METHOD,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        self._allocatable = self._channel.unary_unary(
            pb.ALLOCATABLE_METHOD,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        self._timeout = rpc_timeout
        # Recovery on the attribution cadence: the open breaker admits a
        # probe after ~one refresh interval's worth of seconds, so a
        # returned kubelet is picked up on the next cycle, not minutes
        # later.
        self.breaker = breaker or CircuitBreaker(
            "kubelet", failure_threshold=3, recovery_time=10.0)

    def fetch(self) -> dict[str, Labels]:
        self.breaker.guard()
        try:
            raw = self._list(pb.encode_list_request(), timeout=self._timeout)
            pods = pb.decode_list_response(raw)
        except Exception as exc:
            self.breaker.record_failure(exc)
            raise
        self.breaker.record_success()
        allocations: list[tuple[str, Labels]] = []
        for pod in pods:
            for container in pod.containers:
                labels = {
                    "pod": pod.name,
                    "namespace": pod.namespace,
                    "container": container.name,
                }
                for devices in container.devices:
                    if devices.resource_name not in RESOURCE_NAMES:
                        continue
                    for device_id in devices.device_ids:
                        allocations.append((device_id, labels))
        return index_allocations(allocations)

    def fetch_allocatable(self) -> dict[str, int]:
        """Per-resource allocatable device counts (GetAllocatableResources;
        kubelet >= 1.23). Used as a self-metric cross-check against local
        discovery — not on the poll hot path. A non-closed breaker
        refuses it fast WITHOUT consuming the recovery probe (the probe
        slot belongs to List(), which records its outcome); its own
        outcome does NOT feed the breaker either — older kubelets lack
        the method, a capability gap, not a socket outage."""
        if self.breaker.state != CLOSED:
            raise BreakerOpenError(
                f"kubelet breaker {self.breaker.state}; skipping "
                f"GetAllocatableResources")
        raw = self._allocatable(b"", timeout=self._timeout)
        counts: dict[str, int] = {}
        for devices in pb.decode_allocatable_response(raw):
            if devices.resource_name in RESOURCE_NAMES:
                counts[devices.resource_name] = (
                    counts.get(devices.resource_name, 0) + len(devices.device_ids)
                )
        return counts

    def close(self) -> None:
        self._channel.close()
