"""GPU device manager: the core of the plugin daemon.  The port of
container_engine_accelerators_tpu/plugin/manager.py (`TPUManager`).

  - discovery: the /dev nodes `nvidia<minor>` that NVML lists.  The
    control nodes (nvidiactl, nvidia-uvm, nvidia-modeset) do not match
    the pattern; a card node NVML does not list is no card of this host
    (a machine may expose another card's node) and is skipped;
  - readiness: at least one card, and nvidiactl and nvidia-uvm;
  - the device registry with health, the time-sharing fan-out, the
    device specs (each card's node; a slice's member cards), and the
    default devices every container gets (nvidiactl, nvidia-uvm and
    nvidia-uvm-tools, where present);
  - envs: the mesh env contract (topology.mesh_envs) and, for a
    time-shared device, each client's share of the card's memory as
    NVML totals it, and of its duty cycle;
  - the serve loop: gRPC server, kubelet registration re-probed every
    cycle, the socket watchdog, hotplug, and an idempotent stop.

NVML is opened when the manager is made (NvmlUnavailable without the
library); no device is ever listed without it.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional, Sequence, Tuple

import grpc

from ..native import nvml as nvml_mod
from . import sharing, slices, topology
from .api import HEALTHY, RESOURCE_NAME
from .api import deviceplugin_pb2 as dp_pb2
from .api import grpc_api
from .config import GPUConfig

log = logging.getLogger(__name__)

CARD_DEVICE_RE = slices.CARD_DEVICE_RE
# The driver's nodes a card is useless without.
REQUIRED_CONTROL_DEVICES = ("nvidiactl", "nvidia-uvm")
# Mounted into every GPU container where present on the host.
OPTIONAL_DEFAULT_DEVICES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")

GPU_CHECK_INTERVAL_S = 10.0           # hotplug scan
PLUGIN_SOCKET_CHECK_INTERVAL_S = 1.0  # socket watchdog


class GPUManager:
    """Manages the node's cards and serves them to the kubelet."""

    def __init__(
        self,
        dev_directory: str = "/dev",
        mount_paths: Sequence[dp_pb2.Mount] = (),
        gpu_config: Optional[GPUConfig] = None,
        accelerator_type: Optional[str] = None,
        worker_id: int = 0,
        worker_hostnames: Sequence[str] = ("localhost",),
        process_bounds: Optional[str] = None,
        multislice: Optional[Tuple[str, int, int]] = None,
        nvml=None,
    ):
        self.nvml = nvml_mod.Nvml() if nvml is None else nvml
        self.dev_directory = dev_directory
        self.mount_paths = list(mount_paths)
        self.gpu_config = gpu_config or GPUConfig()
        self.accelerator_type = accelerator_type
        self.platform: Optional[topology.Platform] = None
        # Grid index of each card (slices.chip_index_map).
        self.index_of: Dict[str, int] = {}
        # This node's identity within a multi-host job; the defaults
        # describe one host.  multislice = (coordinator_address,
        # num_slices, slice_id) adds the MEGASCALE_* layer.
        self.worker_id = worker_id
        self.worker_hostnames = list(worker_hostnames)
        if process_bounds is not None:
            # Fail at startup, not on the first full-host Allocate.
            parts = process_bounds.split(",")
            if len(parts) != 3 or not all(
                p.isdigit() and int(p) > 0 for p in parts
            ):
                raise ValueError(
                    f"invalid process_bounds {process_bounds!r}: want "
                    "'x,y,z' of positive ints"
                )
        self.process_bounds = process_bounds
        self.multislice = multislice

        # Written by ListAndWatch's health events and by discovery, read
        # by the gRPC threads.
        self.devices_lock = threading.Lock()
        self.devices: Dict[str, dp_pb2.Device] = {}  # guarded-by: devices_lock
        self.default_devices: List[str] = []
        self.slice_manager = slices.SliceManager(dev_directory, self.nvml)
        # Health events flow health checker -> this queue -> ListAndWatch.
        self.health: "queue.Queue[dp_pb2.Device]" = queue.Queue()

        self.grpc_server: Optional[grpc.Server] = None
        self.socket = ""
        self._stop = threading.Event()
        self._skipped: List[str] = []

    # ------------------------------------------------------------------
    # Discovery.
    # ------------------------------------------------------------------

    def check_device_paths(self) -> None:
        """Driver readiness: raises FileNotFoundError until a card NVML
        lists has its /dev node and nvidiactl and nvidia-uvm exist."""
        missing = [d for d in REQUIRED_CONTROL_DEVICES
                   if not os.path.exists(os.path.join(self.dev_directory, d))]
        if missing:
            raise FileNotFoundError(
                f"no {', '.join(missing)} under {self.dev_directory}")
        if not self.scan_card_names():
            raise FileNotFoundError(
                f"no /dev/nvidia<minor> node of a card NVML lists under "
                f"{self.dev_directory}"
            )

    def scan_card_names(self) -> List[str]:
        """The cards: /dev nodes `nvidia<minor>` that NVML lists, in
        minor order.  Raises NvmlError where NVML cannot list them."""
        try:
            entries = os.listdir(self.dev_directory)
        except OSError:
            entries = []
        nodes = {e for e in entries
                 if CARD_DEVICE_RE.match(e)
                 and not os.path.isdir(os.path.join(self.dev_directory, e))}
        self.nvml.sync_device_count()
        listed = set(self.nvml.device_names())
        skipped = sorted(nodes ^ listed, key=slices.chip_sort_key)
        if skipped != self._skipped:
            self._skipped = skipped
            if skipped:
                log.warning(
                    "skipping %s: a /dev node NVML does not list, or an NVML "
                    "card without a node under %s", skipped,
                    self.dev_directory)
        return sorted(nodes & listed, key=slices.chip_sort_key)

    def discover_gpus(self) -> List[str]:
        """Register newly found cards as Healthy (a known card keeps its
        health) and place every card on the host grid; returns the
        cards."""
        names = self.scan_card_names()
        if not names:
            raise FileNotFoundError(
                f"no card NVML lists has a node under {self.dev_directory}")
        self.platform = topology.detect_platform(len(names), self.accelerator_type)
        self.index_of = slices.chip_index_map(self.platform, names, self.nvml)
        with self.devices_lock:
            for name in names:
                if name not in self.devices:
                    log.debug("Found GPU %s", name)
                    self.devices[name] = dp_pb2.Device(ID=name, health=HEALTHY)
        return names

    def has_additional_gpus_installed(self) -> bool:
        with self.devices_lock:
            original = len(self.devices)
        count = len(self.scan_card_names())
        if count > original:
            log.info(
                "Found %d GPUs while only %d are registered; restarting "
                "device-plugin server.", count, original)
            return True
        return False

    # ------------------------------------------------------------------
    # Lifecycle.
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Discover the cards, resolve the platform, and partition the
        host where the config asks for slices."""
        self.default_devices = [
            path for path in (os.path.join(self.dev_directory, rel)
                              for rel in OPTIONAL_DEFAULT_DEVICES)
            if os.path.exists(path)
        ]
        names = self.discover_gpus()
        log.info(
            "GPU platform: %s (%d cards, topology %s): %s",
            self.platform.accelerator_type, self.platform.chips,
            self.platform.topology_str, self.index_of)
        if self.gpu_config.slice_partition_size:
            self.slice_manager.start(
                self.gpu_config.slice_partition_size, self.platform, names
            )

    # ------------------------------------------------------------------
    # Device views.
    # ------------------------------------------------------------------

    def list_physical_devices(self) -> Dict[str, dp_pb2.Device]:
        """The physical schedulable devices: cards, or slices when
        partitioned.  A snapshot, so callers never iterate the registry
        while a health event writes it."""
        if not self.gpu_config.slice_partition_size:
            with self.devices_lock:
                return dict(self.devices)
        with self.devices_lock:
            return dict(self.slice_manager.list_slice_devices())

    def list_health_critical_errors(self) -> List[int]:
        return self.gpu_config.health_critical_errors

    def list_devices(self) -> Dict[str, dp_pb2.Device]:
        """The schedulable devices, fanned out into virtual devices under
        time-sharing (each inheriting its physical device's health)."""
        physical = self.list_physical_devices()
        max_shared = self.gpu_config.gpu_sharing_config.max_shared_clients_per_gpu
        if max_shared > 0:
            virtual: Dict[str, dp_pb2.Device] = {}
            for device in physical.values():
                for i in range(max_shared):
                    vid = f"{device.ID}/vgpu{i}"
                    virtual[vid] = dp_pb2.Device(ID=vid, health=device.health)
            return virtual
        return physical

    def device_spec(self, device_id: str) -> List[dp_pb2.DeviceSpec]:
        """The device nodes to inject for one requested device ID."""
        if self.gpu_config.sharing_enabled:
            device_id = sharing.virtual_to_physical_device_id(device_id)
        if not self.gpu_config.slice_partition_size:
            with self.devices_lock:
                dev = self.devices.get(device_id)
            if dev is None:
                raise ValueError(
                    f"invalid allocation request with non-existing device {device_id}"
                )
            if dev.health != HEALTHY:
                raise ValueError(
                    f"invalid allocation request with unhealthy device {device_id}"
                )
            path = os.path.join(self.dev_directory, device_id)
            return [
                dp_pb2.DeviceSpec(
                    host_path=path, container_path=path, permissions="mrw"
                )
            ]
        with self.devices_lock:
            return self.slice_manager.device_spec(device_id)

    def _physical(self, device_ids: Sequence[str]) -> List[str]:
        return [sharing.virtual_to_physical_device_id(d)
                if sharing.is_virtual_device_id(d) else d for d in device_ids]

    def physical_chip_indices(self, device_ids: Sequence[str]) -> List[int]:
        """The grid indices of the cards that device IDs (cards, slices
        or virtual devices) cover."""
        indices: List[int] = []
        for device_id in self._physical(device_ids):
            if slices.SLICE_DEVICE_RE.match(device_id):
                indices.extend(self.slice_manager.slice_chip_indices(device_id))
            elif device_id in self.index_of:
                indices.append(self.index_of[device_id])
        return sorted(set(indices))

    def card_names(self, device_ids: Sequence[str]) -> List[str]:
        """The present cards that device IDs cover."""
        names: List[str] = []
        for device_id in self._physical(device_ids):
            if slices.SLICE_DEVICE_RE.match(device_id):
                names.extend(self.slice_manager.slice_chip_names(device_id))
            elif device_id in self.index_of:
                names.append(device_id)
        return sorted(set(names), key=slices.chip_sort_key)

    def card_names_at(self, indices: Sequence[int]) -> List[str]:
        """The cards at grid indices."""
        name_of = {i: n for n, i in self.index_of.items()}
        return [name_of[i] for i in indices]

    def envs(self, device_ids: Sequence[str]) -> Dict[str, str]:
        """The env contract for a container allocated `device_ids`
        (topology.mesh_envs); a time-shared allocation also carries each
        client's budget: GPU_HBM_TOTAL_BYTES (NVML's total of the card,
        the least over a slice's cards), GPU_HBM_LIMIT_BYTES and
        GPU_DUTY_CYCLE_LIMIT_PCT, split evenly over the clients."""
        if self.platform is None:
            return {}
        chip_indices = self.physical_chip_indices(device_ids)
        if not chip_indices:
            return {}
        # The multi-host identity applies to full-host allocations only:
        # a partial or time-shared job handed TPU_WORKER_HOSTNAMES=a,b
        # would wait forever for a peer that was never scheduled.
        full_host = len(chip_indices) == self.platform.chips
        multi_host = full_host and len(self.worker_hostnames) > 1
        result = topology.mesh_envs(
            self.platform,
            chip_indices,
            worker_id=self.worker_id if multi_host else 0,
            worker_hostnames=(
                self.worker_hostnames if multi_host else ("localhost",)
            ),
            process_bounds=self.process_bounds if multi_host else None,
        )
        if self.multislice is not None and full_host:
            coordinator, num_slices, slice_id = self.multislice
            result.update(
                topology.multislice_envs(coordinator, num_slices, slice_id)
            )
        max_shared = self.gpu_config.gpu_sharing_config.max_shared_clients_per_gpu
        if max_shared > 0 and any(
            sharing.is_virtual_device_id(d) for d in device_ids
        ):
            listed = self.nvml.device_names()
            hbm_bytes = min(
                self.nvml.memory_total_bytes(listed.index(name))
                for name in self.card_names(device_ids)
            )
            result["GPU_HBM_TOTAL_BYTES"] = str(hbm_bytes)
            result["GPU_HBM_LIMIT_BYTES"] = str(hbm_bytes // max_shared)
            result["GPU_DUTY_CYCLE_LIMIT_PCT"] = str(100 // max_shared)
        return result

    def set_device_health(self, name: str, health: str) -> None:
        """Card names update the card registry (and, when partitioned,
        their slice); anything else goes to the slice manager."""
        with self.devices_lock:
            if CARD_DEVICE_RE.match(name):
                self.devices[name] = dp_pb2.Device(ID=name, health=health)
                if self.gpu_config.slice_partition_size:
                    self.slice_manager.set_device_health(name, health)
            else:
                self.slice_manager.set_device_health(name, health)

    # ------------------------------------------------------------------
    # Serving.
    # ------------------------------------------------------------------

    def serve(
        self,
        plugin_mount_path: str,
        kubelet_endpoint: str,
        plugin_endpoint: str,
    ) -> None:
        """The gRPC server's restart loop: listen on the plugin socket,
        register with the kubelet, and serve again when the socket is
        deleted (a kubelet restart), a card appears, or a kubelet appears
        after an unregistered start.  Blocks until stop()."""
        from . import beta_plugin

        kubelet_socket = os.path.join(plugin_mount_path, kubelet_endpoint)
        first_cycle = True

        while not self._stop.is_set():
            # Probed every cycle: a kubelet that appears after the plugin
            # started gets a registration on the next cycle.
            register_with_kubelet = os.path.exists(kubelet_socket)
            if register_with_kubelet:
                log.info("kubelet socket found; will register with kubelet")
            else:
                log.info("no kubelet socket at %s; serving without registration",
                         kubelet_socket)
            endpoint_path = os.path.join(plugin_mount_path, plugin_endpoint)
            log.info("starting device-plugin server at: %s", endpoint_path)
            if os.path.lexists(endpoint_path):
                os.unlink(endpoint_path)
            server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
            grpc_api.add_device_plugin_servicer(
                server, beta_plugin.PluginServiceV1Beta1(self))
            server.add_insecure_port(f"unix:{endpoint_path}")
            server.start()
            self.grpc_server = server
            self.socket = endpoint_path

            if register_with_kubelet:
                try:
                    beta_plugin.register_with_v1beta1_kubelet(
                        kubelet_socket, plugin_endpoint, RESOURCE_NAME
                    )
                except grpc.RpcError as e:
                    server.stop(grace=0)
                    if first_cycle:
                        # A kubelet that is there and refuses us at
                        # startup is a configuration error.
                        raise RuntimeError(
                            f"device-plugin: cannot register with kubelet: {e}"
                        ) from e
                    # Mid-run the socket can exist while the kubelet is
                    # still coming up: retry the cycle.
                    log.warning("kubelet registration failed (%s); retrying", e)
                    time.sleep(1)
                    continue
                finally:
                    first_cycle = False
                log.info("device-plugin registered with the kubelet")
            first_cycle = False

            last_gpu_check = time.monotonic()
            while not self._stop.is_set():
                time.sleep(PLUGIN_SOCKET_CHECK_INTERVAL_S)
                if not os.path.lexists(endpoint_path):
                    log.info("stopping device-plugin server at: %s", endpoint_path)
                    break
                if time.monotonic() - last_gpu_check >= GPU_CHECK_INTERVAL_S:
                    last_gpu_check = time.monotonic()
                    try:
                        if self.has_additional_gpus_installed():
                            self.discover_gpus()
                            break
                    except nvml_mod.NvmlError as e:
                        # No rediscovery this round; nothing is listed
                        # from a failed read.
                        log.error("hotplug scan failed: %s", e)
                if not register_with_kubelet and os.path.exists(kubelet_socket):
                    log.info("kubelet socket appeared; restarting to register")
                    break
            server.stop(grace=1)

    def stop(self) -> None:
        """Stop serving and remove the plugin socket.  Idempotent, also
        against the serve loop's own watchdog removing the socket."""
        log.info("removing device plugin socket %s", self.socket)
        self._stop.set()
        if self.socket:
            try:
                os.unlink(self.socket)
            except FileNotFoundError:
                pass
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=1)
