"""Int8 weight-only matmul: a hand-written CUDA kernel
(csrc/quant_matmul.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel container_engine_accelerators_tpu/
ops/quant_matmul.py `_kernel` (:31) via `_int8_matmul_pallas` (:122,
pallas_call :145); entries `quantize_weight` (:66) and
`int8_weight_matmul` (:77).

Decode streams every weight once per token, so the matmul is bound by
the weight bytes; storing W as int8 with a per-output-channel f32 scale
halves them against bf16.  The kernel is one launch: a block streams a
64-column tile of W over a slice of the `in` range through a cp.async
ring, turns each int8 tile into bf16 on chip and multiplies it on the
tensor cores (mma.sync, f32 accumulate; f32 x as three bf16 parts,
`split_bf16x3`), and the slices of one column tile, a thread-block
cluster, add their partials in rank order through distributed shared
memory before the scale is applied.  `qmm_plan` chooses the slices.
See the source's header for the layout.

The plain version is the reference's fallback (:110-113): dequantize,
then one f32-accumulated dot.  The wrapper takes it only for CPU
tensors; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

_ROWS_TILE = 16  # rows of x per block (one m16 tile)
# The planner's choices, from timing every projection shape on the H100
# at clusters of 1-8 (PERF.md): about one block for every two SMs,
# a bf16 block's slice at most 4 stages, and clusters of at most 4 (8
# was slower at every shape).
_SM_SHARE = 0.45
_MAX_STAGES_BF16 = 4
_PLAN_CLUSTER = 4


def block_shape(x_dtype):
    """(weight columns, weight rows a stage) of one block, as
    csrc/quant_matmul.cu `Layout`: (128, 64) for f32 x, (64, 128) for
    bf16 x."""
    return (128, 64) if x_dtype == torch.float32 else (64, 128)


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


def split_bf16x3(x):
    """(hi, mid, lo) bf16 with hi + mid + lo == x to f32's 24 bits: how
    the kernel feeds f32 x to the bf16 tensor cores (three products into
    one f32 accumulator; int8 times bf16 is exact in f32)."""
    hi = x.float().to(torch.bfloat16)
    r = x.float() - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def qmm_plan(rows: int, in_dim: int, out_dim: int, sms: int,
             x_dtype=torch.bfloat16):
    """(ks, krange): the kernel's cluster size along `in` and the weight
    rows each of its blocks covers (whole stages).  ks is the least
    power of two up to 4 that gives about one block to every two of
    `sms` SMs over the (column, 16-row) tiles and, for bf16 x, at most 4
    stages to a block; the cap of 4 comes first, so fc1 (4096 in, 32
    stages of 128 rows) gets ks 4 and 8 stages a block.  ks * krange
    covers in_dim and no block is empty."""
    cols, stage = block_shape(x_dtype)
    tiles = -(-out_dim // cols) * -(-rows // _ROWS_TILE)
    stages = -(-in_dim // stage)
    ks = 1
    while ks < min(_PLAN_CLUSTER, stages) and (
        tiles * ks < _SM_SHARE * sms
        or (x_dtype != torch.float32
            and -(-stages // ks) > _MAX_STAGES_BF16)
    ):
        ks *= 2
    krange = -(-in_dim // (ks * stage)) * stage
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
    ks, krange = qmm_plan(
        rows, in_dim, out_dim, _build.sm_count(x.device.index), x.dtype
    )
    fn = _build.load("cea_int8_matmul")
    out = torch.empty((rows, out_dim), dtype=x.dtype, device=x.device)
    rc = fn(
        x.data_ptr(), w_i8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        x_type, rows, in_dim, out_dim, ks, krange,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "int8_weight_matmul")
    _build.add_launches(int8_weight_matmul)
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
