"""Int8 weight-only matmul: a hand-written CUDA kernel
(csrc/quant_matmul.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel container_engine_accelerators_tpu/
ops/quant_matmul.py `_kernel` (:31) via `_int8_matmul_pallas` (:122,
pallas_call :145); entries `quantize_weight` (:66) and
`int8_weight_matmul` (:77).

Decode streams every weight once per token, so the matmul is bound by
the weight bytes; storing W as int8 with a per-output-channel f32 scale
halves them against bf16.  The kernel converts each int8 weight in
registers and keeps f32 sums, applying the scale once per output in the
epilogue, so device memory sees only int8 weight bytes.  At decode
shapes it is a skinny GEMM (rows = the slot count, or 1 for the prefill
head); the wrapper splits the `in` range over blocks so enough of them
are in flight, and a second pass adds the slices in a fixed order.  See
the source's header for the layout.

The plain version is the reference's fallback (:110-113): dequantize,
then one f32-accumulated dot.  The wrapper takes it only for CPU
tensors; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

_ROWS_TILE = 16
_COLS_TILE = 256
_MAX_KRANGE = 256
_MIN_KRANGE = 64
_BLOCKS_PER_SM = 2  # first-pass blocks wanted in flight on each SM


def quantize_weight(w):
    """(w_i8, scale): per-output-channel symmetric int8 quantization of
    a (in_dim, out_dim) weight; true weight = w_i8 * scale[None, :]."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=0), min=1e-8) / 127.0
    w_i8 = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(
        torch.int8
    )
    return w_i8, scale


def int8_weight_matmul_plain(x, w_i8, scale):
    """Dequantize, then one f32-accumulated dot; result in x's dtype."""
    w = (w_i8.float() * scale[None, :]).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def split_plan(rows: int, in_dim: int, out_dim: int, sms: int):
    """(ksplit, krange): how many `in` slices the kernel's first pass
    runs on a card of `sms` SMs and how many weight rows each covers."""
    tiles = -(-out_dim // _COLS_TILE) * -(-rows // _ROWS_TILE)
    lo = -(-in_dim // _MAX_KRANGE)
    hi = max(lo, in_dim // _MIN_KRANGE)
    ksplit = min(max(lo, -(-(_BLOCKS_PER_SM * sms) // tiles)), hi)
    krange = -(-in_dim // ksplit)
    krange = -(-krange // 8) * 8
    return -(-in_dim // krange), krange


_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x, w_i8, scale):
    for t in (x, w_i8, scale):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(
                "int8_weight_matmul: the CUDA kernel takes CUDA tensors "
                "on one device"
            )
        if not t.is_contiguous():
            raise ValueError(
                "int8_weight_matmul: tensors must be contiguous"
            )
    x_type = _X_TYPES.get(x.dtype)
    if x_type is None or w_i8.dtype != torch.int8 or (
        scale.dtype != torch.float32
    ):
        raise ValueError(
            f"int8_weight_matmul: takes bf16/f32 x, int8 W, f32 scale; "
            f"got {x.dtype}, {w_i8.dtype}, {scale.dtype}"
        )
    rows, in_dim = x.shape
    out_dim = w_i8.shape[1]
    if out_dim % 8 or w_i8.data_ptr() % 8:
        raise ValueError(
            f"int8_weight_matmul: the kernel loads 8 weights at a time: "
            f"out_dim ({out_dim}) must be a multiple of 8 and W 8-byte "
            f"aligned"
        )
    ksplit, krange = split_plan(
        rows, in_dim, out_dim, _build.sm_count(x.device.index)
    )
    fn = _build.load("cea_int8_matmul")
    out = torch.empty((rows, out_dim), dtype=x.dtype, device=x.device)
    partial = torch.empty(
        (ksplit * rows * out_dim,), dtype=torch.float32, device=x.device
    )
    rc = fn(
        x.data_ptr(), w_i8.data_ptr(), scale.data_ptr(),
        partial.data_ptr(), out.data_ptr(), x_type, rows, in_dim,
        out_dim, ksplit, krange,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "int8_weight_matmul")
    int8_weight_matmul.launches += 1
    return out


def int8_weight_matmul(x, w_i8, scale):
    """x (rows, in_dim) bf16/f32 @ dequant(w_i8 (in_dim, out_dim),
    scale (out_dim,)) -> (rows, out_dim) in x's dtype.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    rows, in_dim = x.shape
    if w_i8.shape[0] != in_dim:
        raise ValueError(
            f"x in_dim {in_dim} != w in_dim {w_i8.shape[0]}"
        )
    if tuple(scale.shape) != (w_i8.shape[1],):
        raise ValueError(
            f"scale shape {tuple(scale.shape)} != (out_dim,) = "
            f"({w_i8.shape[1]},)"
        )
    if x.device.type == "cpu":
        return int8_weight_matmul_plain(x, w_i8, scale)
    return _launch(x, w_i8, scale)


int8_weight_matmul.launches = 0
