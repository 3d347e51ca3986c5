"""kubelet PodResources v1 API — the messages the attribution client reads.

Public API shape (k8s.io/kubelet/pkg/apis/podresources/v1):

    service PodResources { rpc List(ListPodResourcesRequest)
                               returns (ListPodResourcesResponse); }
    message ListPodResourcesResponse { repeated PodResources pod_resources = 1; }
    message PodResources { string name = 1; string namespace = 2;
                           repeated ContainerResources containers = 3; }
    message ContainerResources { string name = 1;
                                 repeated ContainerDevices devices = 2; }
    message ContainerDevices { string resource_name = 1;
                               repeated string device_ids = 2; }
    message AllocatableResourcesResponse {
        repeated ContainerDevices devices = 1; ... }

Fields beyond these (topology hints, cpu_ids, memory) are skipped by the
codec's unknown-field tolerance. The request messages are empty.
"""

from __future__ import annotations

import dataclasses

from . import codec

LIST_METHOD = "/v1.PodResources/List"
ALLOCATABLE_METHOD = "/v1.PodResources/GetAllocatableResources"


@dataclasses.dataclass(frozen=True)
class ContainerDevices:
    resource_name: str
    device_ids: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ContainerResources:
    name: str
    devices: tuple[ContainerDevices, ...]


@dataclasses.dataclass(frozen=True)
class PodResources:
    name: str
    namespace: str
    containers: tuple[ContainerResources, ...]


def encode_list_request() -> bytes:
    return b""


def decode_container_devices(data: bytes) -> ContainerDevices:
    resource_name = ""
    ids: list[str] = []
    try:
        for field, _, value in codec.iter_fields(data):
            if field == 1:
                resource_name = value.decode("utf-8")
            elif field == 2:
                ids.append(value.decode("utf-8"))
    except (AttributeError, TypeError, UnicodeDecodeError) as exc:
        raise ValueError(f"wire-type mismatch in ContainerDevices: {exc}") from exc
    return ContainerDevices(resource_name, tuple(ids))


def decode_container(data: bytes) -> ContainerResources:
    name = ""
    devices: list[ContainerDevices] = []
    for field, _, value in codec.iter_fields(data):
        if field == 1:
            name = value.decode("utf-8")
        elif field == 2:
            devices.append(decode_container_devices(value))
    return ContainerResources(name, tuple(devices))


def decode_pod(data: bytes) -> PodResources:
    name = ""
    namespace = ""
    containers: list[ContainerResources] = []
    try:
        for field, _, value in codec.iter_fields(data):
            if field == 1:
                name = value.decode("utf-8")
            elif field == 2:
                namespace = value.decode("utf-8")
            elif field == 3:
                containers.append(decode_container(value))
    except (AttributeError, TypeError, UnicodeDecodeError) as exc:
        raise ValueError(f"wire-type mismatch in PodResources: {exc}") from exc
    return PodResources(name, namespace, tuple(containers))


def decode_list_response(data: bytes) -> list[PodResources]:
    return [
        decode_pod(value)
        for field, _, value in codec.iter_fields(data)
        if field == 1
    ]


def decode_allocatable_response(data: bytes) -> list[ContainerDevices]:
    return [
        decode_container_devices(value)
        for field, _, value in codec.iter_fields(data)
        if field == 1
    ]
