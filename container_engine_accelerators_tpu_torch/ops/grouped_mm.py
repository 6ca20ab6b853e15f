"""Grouped matrix product over experts: rows of `x` that lie in group g
(the rows between offs[g - 1] and offs[g]) times w[g].

Replaces no TPU kernel: the JAX package's experts are einsums over a
fixed capacity (parallel/moe.py), and a dropless expert layer has no
counterpart there.  On the card it is PyTorch's grouped GEMM
(`torch._grouped_mm`: CUTLASS's sm90 grouped kernels, one launch for
every group, its gradient the same kernels through autograd), bound by
its operations: at 6,144 tokens an expert, 2,048 x 2,816 and 1,408 x
2,048 products are well above the card's ~295 operations a byte.  The
plain version, a loop of matmuls over the groups, is the wrapper's path
for CPU tensors; on a CUDA tensor it launches the grouped kernels or
raises.
"""

from __future__ import annotations

import torch


def grouped_mm_plain(x, w, offs):
    """x (rows, k) by w (groups, k, n) over the groups' rows ending at
    `offs` (groups,) -> (rows, n); rows past offs[-1] come out zero."""
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    lo = 0
    for g, hi in enumerate(offs.tolist()):
        if hi > lo:
            out[lo:hi] = x[lo:hi] @ w[g]
        lo = hi
    return out


def grouped_mm(x, w, offs):
    """Rows [offs[g - 1], offs[g]) of x (rows, k) times w[g] (k, n), for
    every group g; offs (groups,) int32 cumulative ends on x's device,
    the last equal to rows.  bf16 on the card."""
    if x.ndim != 2 or w.ndim != 3 or x.shape[1] != w.shape[1] or (
            offs.shape != w.shape[:1]):
        raise ValueError(
            f"grouped_mm: x (rows, k), w (groups, k, n), offs (groups,); "
            f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(offs.shape)}")
    if x.device.type == "cpu":
        return grouped_mm_plain(x, w, offs)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or (
            offs.dtype != torch.int32 or offs.device != x.device):
        raise ValueError(
            "grouped_mm: the card's grouped kernels take bf16 x and w and "
            "int32 offs on x's device")
    grouped_mm.launches += 1
    return torch._grouped_mm(x, w, offs=offs)


grouped_mm.launches = 0
