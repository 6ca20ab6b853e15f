"""gRPC service and stub wiring for the kubelet's device-plugin and
pod-resources APIs: the port of
container_engine_accelerators_tpu/plugin/api/grpc_api.py.

The services are wired with grpcio's generic handler and multi-callable
APIs, with no generated ``*_pb2_grpc.py`` stubs.  The method paths are
the kubelet's: ``/v1beta1.Registration/Register``,
``/v1beta1.DevicePlugin/*`` and ``/v1alpha1.PodResourcesLister/List``.
"""

from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as dp_pb2
from . import podresources_pb2 as pr_pb2

# Kubelet API constants (device-plugin framework contract).
DEVICE_PLUGIN_VERSION = "v1beta1"
DEVICE_PLUGIN_SERVICE = "v1beta1.DevicePlugin"
REGISTRATION_SERVICE = "v1beta1.Registration"
POD_RESOURCES_SERVICE = "v1alpha1.PodResourcesLister"


class DevicePluginServicer:
    """Interface for the plugin-side service.  Subclasses override the five
    RPC methods; each receives (request, context)."""

    def GetDevicePluginOptions(self, request, context):
        raise NotImplementedError

    def ListAndWatch(self, request, context):
        raise NotImplementedError

    def GetPreferredAllocation(self, request, context):
        raise NotImplementedError

    def Allocate(self, request, context):
        raise NotImplementedError

    def PreStartContainer(self, request, context):
        raise NotImplementedError


def add_device_plugin_servicer(server: grpc.Server, servicer: DevicePluginServicer) -> None:
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=dp_pb2.Empty.FromString,
            response_serializer=dp_pb2.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=dp_pb2.Empty.FromString,
            response_serializer=dp_pb2.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=dp_pb2.PreferredAllocationRequest.FromString,
            response_serializer=dp_pb2.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=dp_pb2.AllocateRequest.FromString,
            response_serializer=dp_pb2.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=dp_pb2.PreStartContainerRequest.FromString,
            response_serializer=dp_pb2.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(DEVICE_PLUGIN_SERVICE, handlers),)
    )


class DevicePluginStub:
    """Client stub for the DevicePlugin service (what the kubelet dials;
    tests and the chip check stand in for the kubelet with it)."""

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/GetDevicePluginOptions",
            request_serializer=dp_pb2.Empty.SerializeToString,
            response_deserializer=dp_pb2.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{DEVICE_PLUGIN_SERVICE}/ListAndWatch",
            request_serializer=dp_pb2.Empty.SerializeToString,
            response_deserializer=dp_pb2.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/GetPreferredAllocation",
            request_serializer=dp_pb2.PreferredAllocationRequest.SerializeToString,
            response_deserializer=dp_pb2.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/Allocate",
            request_serializer=dp_pb2.AllocateRequest.SerializeToString,
            response_deserializer=dp_pb2.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/PreStartContainer",
            request_serializer=dp_pb2.PreStartContainerRequest.SerializeToString,
            response_deserializer=dp_pb2.PreStartContainerResponse.FromString,
        )


class RegistrationServicer:
    """Interface for the kubelet-side Registration service (a fake
    kubelet implements it)."""

    def Register(self, request, context):
        raise NotImplementedError


def add_registration_servicer(server: grpc.Server, servicer: RegistrationServicer) -> None:
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=dp_pb2.RegisterRequest.FromString,
            response_serializer=dp_pb2.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(REGISTRATION_SERVICE, handlers),)
    )


class RegistrationStub:
    """Client stub the plugin uses to dial back and register with the
    kubelet."""

    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{REGISTRATION_SERVICE}/Register",
            request_serializer=dp_pb2.RegisterRequest.SerializeToString,
            response_deserializer=dp_pb2.Empty.FromString,
        )


class PodResourcesListerServicer:
    """Interface for the kubelet-side PodResourcesLister service."""

    def List(self, request, context):
        raise NotImplementedError


def add_pod_resources_servicer(server: grpc.Server, servicer: PodResourcesListerServicer) -> None:
    handlers = {
        "List": grpc.unary_unary_rpc_method_handler(
            servicer.List,
            request_deserializer=pr_pb2.ListPodResourcesRequest.FromString,
            response_serializer=pr_pb2.ListPodResourcesResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(POD_RESOURCES_SERVICE, handlers),)
    )


class PodResourcesListerStub:
    """Client stub for per-container device attribution."""

    def __init__(self, channel: grpc.Channel):
        self.List = channel.unary_unary(
            f"/{POD_RESOURCES_SERVICE}/List",
            request_serializer=pr_pb2.ListPodResourcesRequest.SerializeToString,
            response_deserializer=pr_pb2.ListPodResourcesResponse.FromString,
        )
