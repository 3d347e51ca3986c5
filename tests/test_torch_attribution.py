"""Pod attribution: the port's against the JAX package's.

The reference's fake kubelet (``kube_gpu_stats_tpu.testing.kubelet_server``,
test-side only) serves ``nvidia.com/gpu`` allocations the way the NVIDIA
device plugin names them: by UUID (its default) and by index. The port's
and the reference's PodResources clients, and their checkpoint-file
readers, must give the same labels for the same devices. Then: stale
labels once the kubelet breaker opens, and the label fence, both through
the two poll loops.
"""

import json

import pytest

from kube_gpu_stats_tpu import attribution as ref_attr
from kube_gpu_stats_tpu import collectors as ref_collectors
from kube_gpu_stats_tpu.attribution.checkpoint import \
    CheckpointSource as RefCheckpoint
from kube_gpu_stats_tpu.attribution.podresources import \
    PodResourcesSource as RefPodResources
from kube_gpu_stats_tpu.poll import PollLoop as RefPollLoop
from kube_gpu_stats_tpu.proto import podresources as ref_pb
from kube_gpu_stats_tpu.registry import Registry as RefRegistry
from kube_gpu_stats_tpu.testing.kubelet_server import (FakeKubeletServer,
                                                       tpu_pod)
from kube_gpu_stats_tpu_torch import attribution as port_attr
from kube_gpu_stats_tpu_torch import collectors as port_collectors
from kube_gpu_stats_tpu_torch.attribution.checkpoint import CheckpointSource
from kube_gpu_stats_tpu_torch.attribution.podresources import \
    PodResourcesSource
from kube_gpu_stats_tpu_torch.poll import PollLoop
from kube_gpu_stats_tpu_torch.proto import podresources as port_pb
from kube_gpu_stats_tpu_torch.registry import Registry

GPU = "nvidia.com/gpu"
UUIDS = [f"GPU-{i:08x}-aaaa-bbbb-cccc-{i:012x}" for i in range(4)]


def _devices(module):
    return [module.Device(i, str(i), f"/dev/nvidia{i}", "gpu-h100", UUIDS[i])
            for i in range(4)]


def _pods(strategy: str):
    ids = UUIDS if strategy == "uuid" else [str(i) for i in range(4)]
    return [
        tpu_pod("train-0", "ml", "trainer", ids[:2], resource=GPU),
        tpu_pod("infer-0", "serve", "server", [ids[2]], resource=GPU),
        # Another resource class on the same node is not ours.
        tpu_pod("tpu-job", "ml", "worker", [ids[3]],
                resource="example.com/other"),
    ]


@pytest.fixture
def kubelet(tmp_path):
    server = FakeKubeletServer(str(tmp_path / "kubelet.sock"),
                               allocatable=[ref_pb.ContainerDevices(
                                   GPU, tuple(UUIDS))])
    with server:
        yield server


def _lookups(cached, module):
    return [dict(cached.lookup(dev)) for dev in _devices(module)]


@pytest.mark.parametrize("strategy", ["uuid", "index"])
def test_podresources_labels_match_the_reference(kubelet, strategy):
    kubelet.pods = _pods(strategy)
    ref = ref_attr.CachedAttribution(RefPodResources(kubelet.socket_path))
    port = port_attr.CachedAttribution(PodResourcesSource(kubelet.socket_path))
    try:
        ref.refresh_once()
        port.refresh_once()
        assert _lookups(port, port_collectors) == \
            _lookups(ref, ref_collectors)
        assert _lookups(port, port_collectors)[:3] == [
            {"pod": "train-0", "namespace": "ml", "container": "trainer"},
            {"pod": "train-0", "namespace": "ml", "container": "trainer"},
            {"pod": "infer-0", "namespace": "serve", "container": "server"}]
        assert _lookups(port, port_collectors)[3] == {}
        assert dict(port.allocatable()) == dict(ref.allocatable()) == \
            {GPU: 4}
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("strategy", ["uuid", "index"])
def test_checkpoint_labels_match_the_reference(tmp_path, strategy):
    ids = UUIDS if strategy == "uuid" else [str(i) for i in range(4)]
    path = tmp_path / "kubelet_internal_checkpoint"
    path.write_text(json.dumps({"Data": {"PodDeviceEntries": [
        {"PodUID": "uid-a", "ContainerName": "trainer", "ResourceName": GPU,
         "DeviceIDs": {"-1": ids[:2]}},
        {"PodUID": "uid-b", "ContainerName": "server", "ResourceName": GPU,
         "DeviceIDs": [ids[2]]},
    ], "RegisteredDevices": {GPU: ids}}, "Checksum": 1}))
    ref = ref_attr.CachedAttribution(RefCheckpoint(str(path)))
    port = port_attr.CachedAttribution(CheckpointSource(str(path)))
    ref.refresh_once()
    port.refresh_once()
    got = _lookups(port, port_collectors)
    assert got == _lookups(ref, ref_collectors)
    assert [label.get("pod") for label in got] == \
        ["uid-a", "uid-a", "uid-b", None]
    assert dict(port.allocatable()) == {GPU: 4}


def test_the_list_response_decodes_like_the_reference():
    pods = _pods("uuid")
    data = ref_pb.encode_list_response(pods)
    assert [(p.name, p.namespace, [(c.name, [(d.resource_name,
                                              d.device_ids)
                                             for d in c.devices])
                                   for c in p.containers])
            for p in port_pb.decode_list_response(data)] == \
        [(p.name, p.namespace, [(c.name, [(d.resource_name, d.device_ids)
                                          for d in c.devices])
                                for c in p.containers]) for p in pods]
    with pytest.raises(ValueError):
        port_pb.decode_list_response(b"\x0a\x05ab")


class _Scripted:
    """One collector shape for both packages: four cards, fixed values."""

    @staticmethod
    def make(module):
        class Scripted(module.Collector):
            name = "scripted"

            def discover(self):
                return _devices(module)

            def sample(self, device):
                return module.Sample(device=device, values={
                    "accelerator_duty_cycle": 50.0,
                    "accelerator_memory_used_bytes": 1.0})

        return Scripted()


def _render(loop_cls, registry, collector, attribution, **kw):
    loop = loop_cls(collector, registry, deadline=30.0,
                    attribution=attribution, **kw)
    try:
        loop.tick()
    finally:
        loop.stop()
    return registry.rendered()[0].decode()


def _device_lines(text: str) -> list[str]:
    return [line for line in text.splitlines()
            if line.startswith("accelerator_")]


def test_stale_labels_once_the_kubelet_breaker_opens(kubelet):
    kubelet.pods = _pods("uuid")
    texts = []
    for cached_cls, source_cls, loop_cls, registry, module in (
            (ref_attr.CachedAttribution, RefPodResources, RefPollLoop,
             RefRegistry(native=False), ref_collectors),
            (port_attr.CachedAttribution, PodResourcesSource, PollLoop,
             Registry(), port_collectors)):
        kubelet.fail = False
        cached = cached_cls(source_cls(kubelet.socket_path))
        try:
            cached.refresh_once()
            assert not cached.stale
            kubelet.fail = True
            for _ in range(3):
                cached.refresh_once()
            assert cached.breaker.state == "open"
            assert cached.stale
            texts.append(_render(loop_cls, registry,
                                 _Scripted.make(module), cached))
        finally:
            cached.stop()
    want, got = texts
    assert _device_lines(got) == _device_lines(want)
    duty = [line for line in _device_lines(got)
            if line.startswith("accelerator_duty_cycle{")]
    assert all('stale="true"' in line for line in duty)
    assert 'pod="train-0"' in duty[0]


class _Churning:
    def __init__(self):
        self.tick = 0

    def lookup(self, device):
        return {"pod": f"pod-{self.tick}-{device.index}", "namespace": "ns",
                "container": "c"}


def test_label_fence_matches_the_reference():
    churn = (_Churning(), _Churning())
    loops = [(RefPollLoop(_Scripted.make(ref_collectors),
                          RefRegistry(native=False), deadline=30.0,
                          attribution=churn[0], label_value_cap=3)),
             (PollLoop(_Scripted.make(port_collectors), Registry(),
                       deadline=30.0, attribution=churn[1],
                       label_value_cap=3))]
    try:
        for tick in range(3):
            for c in churn:
                c.tick = tick
            texts = []
            for loop in loops:
                loop.tick()
                texts.append(loop._registry.rendered()[0].decode())
            want, got = texts
            assert _device_lines(got) == _device_lines(want)
            fenced = [line for line in got.splitlines()
                      if line.startswith("kts_cardinality_fenced_total")]
            assert fenced == [line for line in want.splitlines()
                              if line.startswith(
                                  "kts_cardinality_fenced_total")]
    finally:
        for loop in loops:
            loop.stop()
    assert 'pod="overflow"' in got
    assert fenced == ['kts_cardinality_fenced_total{label="pod"} 9']
