"""Protobuf wire format for the kubelet PodResources v1 API.

The port's copy of the reference's hand-written codec (no generated code,
no protoc plugins): :mod:`.codec` decodes the wire format, and
:mod:`.podresources` models the messages the attribution client reads.
"""
