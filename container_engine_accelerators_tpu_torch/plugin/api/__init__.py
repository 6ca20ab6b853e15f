"""The kubelet device-plugin API: the device health strings and the
port's own copy of the generated message module (deviceplugin_pb2.py,
imported only where a Device message is built, so that the serving
health path needs no protobuf)."""

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"
