"""The kubelet device-plugin API: the resource name and the device
health strings, and the port's own copies of the generated message modules (deviceplugin_pb2.py,
podresources_pb2.py) and of the service wiring (grpc_api.py).  This
package's own import loads no protobuf: the serving health path imports
it for the strings alone."""

RESOURCE_NAME = "nvidia.com/gpu"
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"
