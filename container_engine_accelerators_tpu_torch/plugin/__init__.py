"""The device-plugin side of the port: plugin/ of the JAX package for an
NVIDIA card.  The daemon's layers, from the kubelet down: beta_plugin.py
(the DevicePlugin gRPC service) over manager.py (`GPUManager`: discovery
of /dev/nvidia<minor> over NVML, the registry, envs, the serve loop),
with config.py, sharing.py, topology.py and slices.py for its policy;
health.py (`GPUHealthChecker` and the NVML event sources) feeding the
manager's health queue; metrics.py (the Prometheus exporter) with
podresources.py for attribution; api/ for the kubelet's messages; and
util.py.  The entry points are the package's device_plugin.py and
partition.py."""
