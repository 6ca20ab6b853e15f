"""The benchmark of the PyTorch and CUDA port
(container_engine_accelerators_tpu_torch): one command runs one cell of
BENCHMARK.json once (run.py).  The traffic generator, the device
weights, the trace reader, the per-layer metric readers, the plain
reference and the comparison that decides `correct` live here; from the
program it takes only the system under test, its counters and its
kernels' names."""
