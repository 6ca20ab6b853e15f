"""Fused 1x1-conv matmuls with BatchNorm statistics: a hand-written CUDA
kernel (csrc/fused_linear.cu, core in csrc/fused_gemm.cuh) and its plain
PyTorch version.

Replaces the Pallas TPU kernel container_engine_accelerators_tpu/ops/
fused_linear.py `_fused_matmul_kernel` (:65) via `_fused_matmul_call`
(:109, pallas_call :136); entries `matmul_stats` (:170, VJP
`_matmul_stats_bwd` :182) and `affine_relu_matmul_stats` (:206, VJP
`_affine_bwd` :226).

    matmul_stats(a, b)                     -> y, colsum(y), colsum(y^2)
    affine_relu_matmul_stats(u, sc, sh, b) -> the same for
                                              relu(u * sc + sh) @ b

a / u (M, K), b (K, N), scale / shift (K,) f32; y (M, N) in a's type,
the statistics (N,) f32, taken from the f32 accumulator before the cast.
The prologue's relu(u * sc + sh) is computed in f32 and rounded to bf16
before the product, as the reference's kernel does (also for f32 u).

Both are autograd Functions.  Their backward rules are the reference's,
in torch ops outside the kernel (the reference's are `jnp.dot`s outside
Pallas): the statistics' gradients fold into g as ds + 2 y dss, then the
two products.  The wrapper takes the plain version only for CPU
tensors; on a CUDA tensor it launches the kernel or raises.  The kernel
takes bf16 operands with K and N multiples of 8 and any M; it raises on
anything else.  The reference's `interpret` argument and its VMEM block
plan (`_blocks`, `_ROW_BLOCK_CANDIDATES`) are not carried over.
"""

from __future__ import annotations

import torch

from . import _build

_ALIGN = 16  # bytes: the kernels read and write 16 bytes a thread


def fused_matmul_plain(a, b, scale=None, shift=None):
    """The kernel's function in torch ops: (y, s, ss)."""
    if scale is not None:
        a_op = torch.relu(a.float() * scale + shift).to(torch.bfloat16)
    else:
        a_op = a
    acc = torch.matmul(a_op.float(), b.float())
    return acc.to(a.dtype), acc.sum(0), (acc * acc).sum(0)


def _check_aligned(what, *tensors):
    for t in tensors:
        if t is not None and t.data_ptr() % _ALIGN:
            raise ValueError(f"{what}: every operand must be {_ALIGN}-byte "
                             "aligned for the CUDA kernel")


def stats_groups(m_tiles: int, col_tiles: int, device) -> int:
    """Blocks that share the M tiles of each column tile: about two
    resident blocks per SM in all, at most one block per tile."""
    sms = _build.sm_count(device.index if device.index is not None
                          else torch.cuda.current_device())
    return max(1, min(m_tiles, -(-2 * sms // col_tiles)))


def _launch(what, a, b, scale, shift):
    """(y, s, ss) from the CUDA kernel, after checking what it takes: a
    (M, K) and b (K, N) bf16 on one CUDA device, K and N multiples of 8;
    scale / shift (K,) f32 or both None."""
    for t in (a, b, scale, shift):
        if t is not None and (not t.is_cuda or t.device != a.device):
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors "
                             "on one device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the CUDA kernel takes bf16 operands, got "
                         f"{a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"{what}: the CUDA kernel needs K ({k}) and N ({n}) "
                         "to be multiples of 8")
    if scale is not None:
        if scale.shape != (k,) or shift.shape != (k,):
            raise ValueError(f"{what}: scale / shift must be ({k},)")
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
    a, b = a.contiguous(), b.contiguous()
    _check_aligned(what, a, b, scale, shift)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    col_tiles = -(-n // (64 if n <= 64 else 128))
    groups = stats_groups(-(-m // 128), col_tiles, a.device)
    part = torch.empty((2, groups, n), dtype=torch.float32, device=a.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=a.device)
    rc = _build.load("cea_fused_matmul")(
        a.data_ptr(), None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), b.data_ptr(),
        y.data_ptr(), part.data_ptr(), stats.data_ptr(), m, k, n, groups,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, what)
    return y, stats[0], stats[1]


def fused_matmul(a, b):
    """(y, s, ss) of a @ b from the CUDA kernel (matmul_stats' forward)."""
    out = _launch("matmul_stats", a, b, None, None)
    fused_matmul.launches += 1
    return out


def fused_affine_matmul(u, scale, shift, b):
    """(y, s, ss) of bf16(relu(u * scale + shift)) @ b from the CUDA
    kernel (affine_relu_matmul_stats' forward)."""
    out = _launch("affine_relu_matmul_stats", u, b, scale, shift)
    fused_affine_matmul.launches += 1
    return out


fused_matmul.launches = 0
fused_affine_matmul.launches = 0


def _forward(a, b, scale, shift):
    if a.device.type == "cpu":
        return fused_matmul_plain(a, b, scale, shift)
    if scale is None:
        return fused_matmul(a, b)
    return fused_affine_matmul(a, scale, shift, b)


def dot_f32(x, y):
    """x @ y with an f32 result from operands of one type (jnp.dot with
    preferred_element_type=f32): bf16 products summed in f32."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.matmul(x.float(), y.float())


def _g_total(g, ds, dss, y, dtype):
    # s = colsum(y), ss = colsum(y^2)  =>  dy += ds + 2 y dss.
    return (g.float() + ds[None, :] + 2.0 * y.float() * dss[None, :]).to(
        dtype)


class _MatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        y, s, ss = _forward(a, b, None, None)
        ctx.save_for_backward(a, b, y)
        return y, s, ss

    @staticmethod
    def backward(ctx, g, ds, dss):
        a, b, y = ctx.saved_tensors
        g_tot = _g_total(g, ds, dss, y, a.dtype)
        da = torch.matmul(g_tot, b.t()).to(a.dtype)
        db = torch.matmul(a.t(), g_tot).to(b.dtype)
        return da, db


class _AffineReluMatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, scale, shift, b):
        y, s, ss = _forward(u, b, scale, shift)
        ctx.save_for_backward(u, scale, shift, b, y)
        return y, s, ss

    @staticmethod
    def backward(ctx, g, ds, dss):
        u, scale, shift, b, y = ctx.saved_tensors
        g_tot = _g_total(g, ds, dss, y, u.dtype)
        uf = u.float()
        pre = uf * scale[None, :] + shift[None, :]
        z = torch.relu(pre).to(u.dtype)
        e = dot_f32(g_tot, b.t())  # dL/dz
        em = torch.where(pre > 0.0, e, 0.0)
        du = (em * scale[None, :]).to(u.dtype)
        dscale = (em * uf).sum(0)
        dshift = em.sum(0)
        db = torch.matmul(z.t(), g_tot).to(b.dtype)
        return du, dscale, dshift, db


def matmul_stats(a, b):
    """y = a @ b plus the f32 column sum and sum of squares of y, taken
    in the epilogue: the producer side of conv+BN fusion."""
    return _MatmulStats.apply(a, b)


def affine_relu_matmul_stats(u, scale, shift, b):
    """y = relu(u * scale + shift) @ b with the per-input-channel affine
    (a folded BatchNorm) applied as the operand is read, plus the column
    statistics of y: the consumer side of conv+BN fusion."""
    return _AffineReluMatmulStats.apply(u, scale, shift, b)
