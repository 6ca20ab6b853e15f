"""Kubelet PodResources client: which devices each container holds.  The
port of container_engine_accelerators_tpu/plugin/podresources.py.

Dial the kubelet's pod-resources unix socket, List, and collect the
device IDs of our resource per container, skipping time-shared virtual
devices, which cannot be attributed to one container.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List

import grpc

from . import sharing
from .api import RESOURCE_NAME, grpc_api
from .api import podresources_pb2 as pr_pb2

log = logging.getLogger(__name__)

DEFAULT_SOCKET_PATH = "/var/lib/kubelet/pod-resources/kubelet.sock"
CONNECTION_TIMEOUT_S = 10


@dataclasses.dataclass(frozen=True)
class ContainerID:
    namespace: str
    pod: str
    container: str


def get_devices_for_all_containers(
    socket_path: str = DEFAULT_SOCKET_PATH,
    resource_name: str = RESOURCE_NAME,
) -> Dict[ContainerID, List[str]]:
    """Map each container to the device IDs of `resource_name` it holds."""
    container_devices: Dict[ContainerID, List[str]] = {}
    with grpc.insecure_channel(f"unix:{socket_path}") as channel:
        stub = grpc_api.PodResourcesListerStub(channel)
        resp = stub.List(
            pr_pb2.ListPodResourcesRequest(), timeout=CONNECTION_TIMEOUT_S
        )
    for pod in resp.pod_resources:
        for c in pod.containers:
            cid = ContainerID(
                namespace=pod.namespace, pod=pod.name, container=c.name
            )
            for d in c.devices:
                if not d.device_ids or d.resource_name != resource_name:
                    continue
                ids = container_devices.setdefault(cid, [])
                for device_id in d.device_ids:
                    if sharing.is_virtual_device_id(device_id):
                        continue
                    ids.append(device_id)
    return container_devices
