"""The kubelet DevicePlugin v1beta1 service.  The port of
container_engine_accelerators_tpu/plugin/beta_plugin.py
(`PluginServiceV1Beta1`, `register_with_v1beta1_kubelet`).

  - ListAndWatch: the device list, then the list again on every health
    event from the manager's queue;
  - Allocate: sharing validation, each device's /dev nodes, the default
    devices (nvidiactl, nvidia-uvm, ...), mounts and envs;
  - GetPreferredAllocation: topology-aware for whole cards
    (topology.preferred_allocation), any subset for slices and virtual
    devices;
  - register_with_v1beta1_kubelet: the dial-back to the kubelet.
"""

from __future__ import annotations

import logging
import queue

import grpc

from . import sharing, slices, topology
from .api import deviceplugin_pb2 as dp_pb2
from .api import grpc_api

log = logging.getLogger(__name__)

_HEALTH_POLL_TIMEOUT_S = 1.0


class PluginServiceV1Beta1(grpc_api.DevicePluginServicer):
    def __init__(self, ngm):
        self.ngm = ngm

    def GetDevicePluginOptions(self, request, context):
        return dp_pb2.DevicePluginOptions(get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        log.info("device-plugin: ListAndWatch start")
        yield self._device_list_response()
        while context.is_active() and not self.ngm._stop.is_set():
            try:
                d = self.ngm.health.get(timeout=_HEALTH_POLL_TIMEOUT_S)
            except queue.Empty:
                continue
            log.info("device-plugin: %s device marked as %s", d.ID, d.health)
            self.ngm.set_device_health(d.ID, d.health)
            yield self._device_list_response()

    def _device_list_response(self) -> dp_pb2.ListAndWatchResponse:
        resp = dp_pb2.ListAndWatchResponse()
        for dev in self.ngm.list_devices().values():
            resp.devices.add(ID=dev.ID, health=dev.health)
        return resp

    def Allocate(self, request, context):
        resps = dp_pb2.AllocateResponse()
        for rqt in request.container_requests:
            try:
                sharing.validate_request(
                    list(rqt.devicesIDs),
                    len(self.ngm.list_physical_devices()),
                    self.ngm.gpu_config.gpu_sharing_config.gpu_sharing_strategy,
                )
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

            resp = resps.container_responses.add()
            for device_id in rqt.devicesIDs:
                try:
                    specs = self.ngm.device_spec(device_id)
                except ValueError as e:
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                for spec in specs:
                    resp.devices.add().CopyFrom(spec)
            for d in self.ngm.default_devices:
                resp.devices.add(host_path=d, container_path=d, permissions="mrw")
            for mount in self.ngm.mount_paths:
                resp.mounts.add().CopyFrom(mount)
            for k, v in self.ngm.envs(list(rqt.devicesIDs)).items():
                resp.envs[k] = v
        return resps

    def PreStartContainer(self, request, context):
        log.error(
            "device-plugin: PreStart should NOT be called for the GPU device plugin"
        )
        return dp_pb2.PreStartContainerResponse()

    def GetPreferredAllocation(self, request, context):
        resp = dp_pb2.PreferredAllocationResponse()
        for rqt in request.container_requests:
            creq = resp.container_responses.add()
            try:
                creq.deviceIDs.extend(
                    self._preferred_ids(
                        list(rqt.available_deviceIDs),
                        list(rqt.must_include_deviceIDs),
                        rqt.allocation_size,
                    )
                )
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        return resp

    def _preferred_ids(self, available, required, size):
        """Topology-aware preference for whole cards; slices (already
        blocks of the grid) and virtual devices take any subset."""
        if size > len(available):
            raise ValueError(
                f"requested allocation size {size} exceeds {len(available)} "
                "available devices"
            )
        card_ids = [d for d in available if self.ngm.platform is not None
                    and not sharing.is_virtual_device_id(d)
                    and not slices.SLICE_DEVICE_RE.match(d)]
        if len(card_ids) != len(available):
            preferred = [d for d in required]
            preferred += [d for d in available if d not in preferred]
            return preferred[:size]
        avail_idx = self.ngm.physical_chip_indices(available)
        req_idx = self.ngm.physical_chip_indices(required)
        chosen = topology.preferred_allocation(
            self.ngm.platform, avail_idx, req_idx, size
        )
        return self.ngm.card_names_at(chosen)


def register_with_v1beta1_kubelet(
    kubelet_socket_path: str, plugin_endpoint: str, resource_name: str
) -> None:
    """Dial back to the kubelet's Registration service over its unix
    socket."""
    with grpc.insecure_channel(f"unix:{kubelet_socket_path}") as channel:
        stub = grpc_api.RegistrationStub(channel)
        stub.Register(
            dp_pb2.RegisterRequest(
                version=grpc_api.DEVICE_PLUGIN_VERSION,
                endpoint=plugin_endpoint,
                resource_name=resource_name,
                options=dp_pb2.DevicePluginOptions(
                    get_preferred_allocation_available=True
                ),
            ),
            timeout=10,
        )
