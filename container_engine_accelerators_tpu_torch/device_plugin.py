"""The GPU device-plugin daemon: serves the resource `nvidia.com/gpu` to
the kubelet over the node's /dev/nvidia<minor> nodes and NVML.  The port
of cmd/tpu_device_plugin/main.py (flags :28-140, `main` :141).

    python -m container_engine_accelerators_tpu_torch.device_plugin [flags]

It loads the node config (--gpu-config), waits until the driver's nodes
are there (`GPUManager.check_device_paths`), starts the manager and,
where asked, the metrics exporter (plugin/metrics.py `MetricServer`) and
the health checker (plugin/health.py `GPUHealthChecker` over the
manager's own devices and health queue), then serves until SIGTERM or
SIGINT.  One NVML session serves all three; without libnvidia-ml.so.1
the daemon raises NvmlUnavailable at once.

The flags are the reference's with tpu -> gpu.  --sysfs-directory has
no counterpart: NVML answers what the sysfs tree did.  The port reads
no environment, so a multi-host job's identity comes from
--gpu-worker-id, --gpu-worker-hostnames and --gpu-process-bounds only
(the reference falls back to TPU_WORKER_ID, TPU_WORKER_HOSTNAMES and
TPU_PROCESS_BOUNDS in its environment).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import signal
import sys
import time
from typing import Optional

from .native import nvml as nvml_mod
from .plugin import config as config_mod
from .plugin import health as health_mod
from .plugin import manager as manager_mod
from .plugin import metrics as metrics_mod
from .plugin import podresources
from .plugin.api import deviceplugin_pb2 as dp_pb2

KUBELET_ENDPOINT = "kubelet.sock"
PLUGIN_ENDPOINT_PREFIX = "gpuDevicePlugin"
DEV_DIRECTORY = "/dev"
DRIVER_WAIT_S = 5.0

log = logging.getLogger("gpu_device_plugin")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GPU kubelet device plugin")
    p.add_argument("--host-path", default="/home/kubernetes/bin/nvidia",
                   help="Path on the host holding the NVIDIA driver's "
                   "libraries; mounted into containers at --container-path")
    p.add_argument("--container-path", default="/usr/local/nvidia",
                   help="Path in the container where --host-path is mounted")
    p.add_argument("--plugin-directory", default="/device-plugin",
                   help="Directory for the plugin unix socket")
    p.add_argument("--enable-container-gpu-metrics", action="store_true",
                   help="Expose GPU metrics for containers with allocated GPUs")
    p.add_argument("--enable-health-monitoring", action="store_true",
                   help="Detect critical GPU errors and mark cards "
                   "unallocatable")
    p.add_argument("--gpu-metrics-port", type=int, default=2112,
                   help="Port of the metrics endpoint (0: a free port)")
    p.add_argument("--gpu-metrics-source", choices=metrics_mod.SOURCES,
                   default="auto",
                   help="metric source: auto layers the nvml-fields reads "
                   "over the NVML collector where NVML serves them; native "
                   "the NVML collector alone; nvml-fields requires them")
    p.add_argument("--gpu-health-source", choices=health_mod.SOURCES,
                   default="auto",
                   help="health event source: auto layers the nvml-fields "
                   "reads (NVLink state, clocks-event reasons) over NVML's "
                   "Xid events where NVML serves them; native the Xid "
                   "events alone; nvml-fields requires them")
    p.add_argument("--gpu-metrics-collection-interval", type=int,
                   default=30000, help="Collection interval in milliseconds")
    p.add_argument("--gpu-config", default="/etc/nvidia/gpu_config.json",
                   help="Node GPU configuration file")
    p.add_argument("--accelerator-type", default=None,
                   help="Host accelerator type (e.g. nvidia-h100-80gb-8); "
                   "otherwise from the card count")
    p.add_argument("--pod-resources-socket", default=None,
                   help="Kubelet pod-resources socket for per-container "
                   "attribution (default: the kubelet's standard path)")
    p.add_argument("--gpu-worker-id", type=int, default=0,
                   help="This node's worker index within its multi-host job")
    p.add_argument("--gpu-worker-hostnames", default="localhost",
                   help="Comma-separated hostnames of every worker of the "
                   "job, in worker-id order")
    p.add_argument("--gpu-process-bounds", default=None,
                   help="Host (process) grid of the job as 'x,y,z' "
                   "(default 1,1,1)")
    p.add_argument("--gpu-coordinator-address", default=None,
                   help="Multi-slice coordinator address; enables the "
                   "MEGASCALE_* env layer on allocations")
    p.add_argument("--gpu-num-slices", type=int, default=1)
    p.add_argument("--gpu-slice-id", type=int, default=0)
    p.add_argument("--dev-directory", default=DEV_DIRECTORY,
                   help="Device-node directory to scan for nvidia<minor> "
                   "(a fake node's for development runs)")
    return p.parse_args(argv)


@dataclasses.dataclass
class Daemon:
    """The started pieces: `serve()` blocks until `stop()`."""

    manager: manager_mod.GPUManager
    plugin_directory: str
    metrics: Optional[metrics_mod.MetricServer] = None
    health: Optional[health_mod.GPUHealthChecker] = None

    def serve(self) -> None:
        self.manager.serve(
            self.plugin_directory, KUBELET_ENDPOINT,
            f"{PLUGIN_ENDPOINT_PREFIX}-{int(time.time())}.sock",
        )

    def stop(self) -> None:
        self.manager.stop()
        if self.health is not None:
            self.health.stop()
        if self.metrics is not None:
            self.metrics.stop()


def start(args, nvml=None) -> Daemon:
    """Build and start the daemon's pieces from parsed flags.  `nvml`: an
    open nvml.Nvml (default: open the NVIDIA driver's)."""
    if nvml is None:
        nvml = nvml_mod.Nvml()
    gpu_config = config_mod.load_gpu_config(args.gpu_config)
    log.info("Using GPU config: %s", gpu_config)
    worker_hostnames = [h for h in args.gpu_worker_hostnames.split(",") if h]
    multislice = None
    if args.gpu_coordinator_address:
        multislice = (args.gpu_coordinator_address, args.gpu_num_slices,
                      args.gpu_slice_id)
    if len(worker_hostnames) > 1 or multislice:
        log.info("multi-host job: worker %d of %s, process bounds %s, "
                 "multislice %s", args.gpu_worker_id, worker_hostnames,
                 args.gpu_process_bounds, multislice)
    ngm = manager_mod.GPUManager(
        dev_directory=args.dev_directory,
        mount_paths=[dp_pb2.Mount(host_path=args.host_path,
                                  container_path=args.container_path,
                                  read_only=True)],
        gpu_config=gpu_config,
        accelerator_type=args.accelerator_type,
        worker_id=args.gpu_worker_id,
        worker_hostnames=worker_hostnames,
        process_bounds=args.gpu_process_bounds,
        multislice=multislice,
        nvml=nvml,
    )
    # Wait for the driver's nodes: the driver installer may still be
    # setting up the node.
    while True:
        try:
            ngm.check_device_paths()
            break
        except FileNotFoundError as e:
            log.info("GPUManager.check_device_paths() failed: %s", e)
            time.sleep(DRIVER_WAIT_S)
    while True:
        try:
            ngm.start()
            break
        except (OSError, ValueError, nvml_mod.NvmlError) as e:
            log.error("failed to start GPU device manager: %s", e)
            time.sleep(DRIVER_WAIT_S)
    daemon = Daemon(manager=ngm, plugin_directory=args.plugin_directory)

    if args.enable_container_gpu_metrics:
        pod_resources_fn = None
        if args.pod_resources_socket:
            def pod_resources_fn():
                return podresources.get_devices_for_all_containers(
                    socket_path=args.pod_resources_socket,
                    resource_name=manager_mod.RESOURCE_NAME,
                )
        daemon.metrics = metrics_mod.MetricServer(
            collection_interval_ms=args.gpu_metrics_collection_interval,
            port=args.gpu_metrics_port,
            collector=metrics_mod.make_collector(
                nvml, ngm.platform, args.gpu_metrics_source),
            device_resolver=lambda device_id: ngm.card_names([device_id]),
            pod_resources_fn=pod_resources_fn,
        )
        daemon.metrics.start()
        log.info("metrics server on port %d (interval %d ms)",
                 daemon.metrics.port, args.gpu_metrics_collection_interval)

    if args.enable_health_monitoring:
        daemon.health = health_mod.GPUHealthChecker(
            devices=ngm.list_physical_devices(),
            health_queue=ngm.health,
            critical_errors=ngm.list_health_critical_errors(),
            event_source=health_mod.make_event_source(
                nvml, args.gpu_health_source),
        )
        daemon.health.start()
        if daemon.metrics is not None:
            daemon.metrics.health_sdk_state_fn = daemon.health.sdk_state
    return daemon


def main(argv=None, nvml=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    args = parse_args(argv)
    log.info("device-plugin started")
    daemon = start(args, nvml)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: daemon.stop())
    try:
        daemon.serve()
    finally:
        daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
