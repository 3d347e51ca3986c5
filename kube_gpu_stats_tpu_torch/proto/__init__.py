"""Protobuf wire formats: the kubelet PodResources v1 API and Prometheus
remote write (1.0 and 2.0).

The port's copy of the reference's hand-written codec (no generated code,
no protoc plugins): :mod:`.codec` encodes and decodes the wire format,
:mod:`.podresources` models the messages the attribution client reads,
and :mod:`.prompb` / :mod:`.prompb2` the remote-write requests.
"""
