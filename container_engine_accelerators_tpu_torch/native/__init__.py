"""The native seam: NVML through ctypes (nvml.py), the counterpart of
container_engine_accelerators_tpu/native/tpuinfo.py."""
