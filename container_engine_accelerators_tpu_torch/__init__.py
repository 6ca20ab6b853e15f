"""PyTorch/CUDA port of container_engine_accelerators_tpu for NVIDIA
Hopper (H100).

Same subpackage layout as the JAX package (models/, ops/, serving/),
so every module sits at the relative path of the module it ports.
Kernels the JAX package wrote in Pallas for the TPU are hand-written
CUDA C++ for sm_90a under csrc/, built with nvcc at first use
(ops/_build.py); each sits beside its plain PyTorch version, which the
CPU tests use.  The port imports torch, never jax, and nothing of the
JAX package.
"""
