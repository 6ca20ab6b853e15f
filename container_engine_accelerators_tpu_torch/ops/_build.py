"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a
plain C interface (one or more entry points, ENTRY_POINTS), at first
use, into `_kernels_build/` beside the package (listed in .gitignore).
The library's file name carries a hash of the source, of every shared
header (csrc/*.cuh) and of the flags, so an edited source or header
rebuilds and an unchanged one loads from disk.
`build_all()` starts one nvcc per source together and waits for all of
them, so a cold start costs the slowest compile, not the sum; it keeps
what ptxas reported (registers, spills, serialized wgmma) in `PTXAS`.

Binding is ctypes: pointers and the CUDA stream pass as c_void_p, ints
as c_int, element strides as c_longlong, and every entry point returns
cudaGetLastError() (checked by `check`).  Nothing here runs at import:
the CPU tests import every module, and this box has neither nvcc nor a
card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kernels_build")
CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: symbol -> (source under csrc/, argtypes).
ENTRY_POINTS = {
    "cea_paged_attention": ("paged_attention", [_P] * 8 + [_I] * 8 + [_P]),
    "cea_int8_matmul": ("quant_matmul", [_P] * 4 + [_I] * 6 + [_P]),
    "cea_flash_fwd": (
        "flash_attention", [_P] * 5 + [_L] * 9 + [_I] * 5 + [_P],
    ),
    "cea_flash_bwd": (
        "flash_attention", [_P] * 10 + [_L] * 9 + [_I] * 5 + [_P],
    ),
    "cea_xent_fwd": ("fused_xent", [_P] * 4 + [_I] * 4 + [_P]),
    "cea_xent_bwd": ("fused_xent", [_P] * 5 + [_I] * 4 + [_P]),
    "cea_fused_matmul": ("fused_linear", [_P] * 7 + [_I] * 7 + [_P]),
    "cea_conv3x3": ("fused_conv3x3", [_P] * 7 + [_I] * 12 + [_P]),
}
SOURCES = tuple(sorted({src for src, _ in ENTRY_POINTS.values()}))

_lock = threading.Lock()
_libs: Dict[str, object] = {}  # symbol -> bound C entry point


def nvcc() -> str:
    """Path of nvcc; raises when the CUDA toolkit is absent."""
    path = shutil.which("nvcc") or os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _target(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def _compile_cmd(name: str, out: str):
    return [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


# What ptxas reported for each source built in this process: source ->
# {"kernels": {entry: [registers, spill store bytes, spill load bytes]},
#  "serialized": [ptxas's "wgmma ... serialized" lines]}.
PTXAS: Dict[str, dict] = {}


def parse_ptxas(log: str) -> dict:
    """Registers and spills per entry function, and the lines where
    ptxas serialized wgmma, from nvcc's -Xptxas -v output."""
    kernels, serialized, entry = {}, [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            kernels[entry] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            kernels[entry][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            kernels[entry][0] = int(m.group(1))
        if "wgmma" in line and "serialized" in line:
            serialized.append(line.strip())
    return {"kernels": kernels, "serialized": serialized}


def build_all() -> float:
    """Compile every missing library, one nvcc per source, all started
    together.  Returns the wall seconds spent (0.0 when all were
    cached).  Raises with nvcc's output on a failed compile."""
    t0 = time.monotonic()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((name, out, tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
            PTXAS[name] = parse_ptxas(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.monotonic() - t0 if procs else 0.0


def load(symbol: str):
    """The bound C entry point `symbol` (ENTRY_POINTS), building its
    source first if needed.  Bound once per process: later calls are one
    dict lookup."""
    fn = _libs.get(symbol)
    if fn is not None:
        return fn
    with _lock:
        fn = _libs.get(symbol)
        if fn is None:
            source, argtypes = ENTRY_POINTS[symbol]
            if not os.path.exists(_target(source)):
                build_all()
            fn = getattr(ctypes.CDLL(_target(source)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[symbol] = fn
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device, read once."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


# Launch counts: each wrapper's `launches` attribute counts its kernel's
# launches.  Engines on several threads (replicas of an in-process
# fleet) launch concurrently, so a count is added under one lock, and a
# thread inside `tally()` also counts its own launches there.
_count_lock = threading.Lock()
_tallies = threading.local()


def add_launches(wrapper, n: int = 1) -> None:
    """Add `n` to `wrapper.launches`, and to the calling thread's tally
    when it keeps one."""
    with _count_lock:
        wrapper.launches += n
    counts = getattr(_tallies, "counts", None)
    if counts is not None:
        counts[wrapper] = counts.get(wrapper, 0) + n


@contextlib.contextmanager
def tally():
    """The launches the calling thread makes inside the block, by
    wrapper (other threads' launches are not in it)."""
    outer = getattr(_tallies, "counts", None)
    _tallies.counts = {}
    try:
        yield _tallies.counts
    finally:
        _tallies.counts = outer


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a launch error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (code {rc})")
