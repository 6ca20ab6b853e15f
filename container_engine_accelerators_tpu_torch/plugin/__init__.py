"""The device-plugin side of the port: plugin/ of the JAX package for
an NVIDIA card.  So far the health layer (health.py over native/nvml.py),
its helpers (util.py) and the kubelet API messages (api/); the plugin
daemon itself is still to port."""
