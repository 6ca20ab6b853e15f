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
takes bf16 operands with K and N multiples of 8 and any M >= 1; it
raises on anything else.  `plan_matmul` chooses its launch (column
tile, ring depth, persistent grid) in Python, where the CPU tests reach
it.  The reference's `interpret` argument and its VMEM block
plan (`_blocks`, `_ROW_BLOCK_CANDIDATES`) are not carried over.
"""

from __future__ import annotations

import torch

from . import _build

_ALIGN = 16  # bytes: TMA's alignment of a tensor's base and strides
# The GEMM core's tiling (csrc/fused_gemm.cuh): 128 output rows a tile,
# 64 channels a k-step, 2-4 ring stages, shared memory an H100 block may
# use.
BM = 128
BK = 64
MAX_STAGES = 4
SMEM_LIMIT = 232448


def fused_matmul_plain(a, b, scale=None, shift=None):
    """The kernel's function in torch ops: (y, s, ss)."""
    if scale is not None:
        a_op = torch.relu(a.float() * scale + shift).to(torch.bfloat16)
    else:
        a_op = a
    acc = torch.matmul(a_op.float(), b.float())
    return acc.to(a.dtype), acc.sum(0), (acc * acc).sum(0)


def check_tma(what, *tensors):
    """Raise unless each tensor (None skipped) can back a TMA map: its
    base 16-byte aligned, dense row-major, every stride but the last a
    multiple of 16 bytes."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel takes contiguous "
                             "operands")
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{what}: every operand must be {_ALIGN}-byte "
                             "aligned for the CUDA kernel")
        if any(s * t.element_size() % _ALIGN for s in t.stride()[:-1]):
            raise ValueError(f"{what}: strides {t.stride()} are not "
                             f"multiples of {_ALIGN} bytes")


def smem_bytes(bn, a_stages, b_stages, a_rows, n, c, stats, affine):
    """Shared memory of one block of the GEMM core (its `Smem`): barriers,
    the A ring (tiles of a_rows rows of 128 bytes, 1 KB aligned), the B
    ring, y's staging tile, the statistics' scratch, scale / shift, and
    1 KB of alignment."""
    cpad = -(-c // BK) * BK
    a_stage = -(-a_rows * 128 // 1024) * 1024
    return (1024 + a_stages * a_stage + b_stages * bn * 128 + BM * bn * 2
            + ((2 * 8 * 2 * bn * 4 + 8 * n) if stats else 0)
            + (8 * cpad if affine else 0) + 1024)


def plan_gemm(what, pixel_tiles, n, c, sms, stats, affine, a_rows=BM,
              conv=False):
    """The launch of the GEMM core over `pixel_tiles` tiles of output
    rows: dict(bn, a_stages, b_stages, a_rows, grid, tiles) with the
    column tile bn (64 for N <= 64, else 128), the deepest rings that fit
    in shared memory (a matmul's A and B tiles go together; the conv
    keeps two A tiles, each read by nine taps), and one persistent block
    per SM (at most one per tile)."""
    bn = 64 if n <= 64 else 128
    tiles = pixel_tiles * -(-n // bn)
    for b_stages in range(MAX_STAGES, 1, -1):
        a_stages = 2 if conv else b_stages
        if smem_bytes(bn, a_stages, b_stages, a_rows, n, c, stats,
                      affine) <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"{what}: N ({n}) and C ({c}) need more shared "
                         "memory than a block has")
    return dict(bn=bn, a_stages=a_stages, b_stages=b_stages, a_rows=a_rows,
                grid=max(1, min(tiles, sms)), tiles=tiles)


def plan_matmul(m, k, n, sms, stats=True, affine=False):
    """plan_gemm for a (m, k) @ (k, n) matmul: tiles of BM rows."""
    return plan_gemm("matmul_stats", -(-m // BM), n, k, sms, stats, affine)


def _sms(device):
    return _build.sm_count(device.index if device.index is not None
                           else torch.cuda.current_device())


def check_matmul(what, a, b, scale=None, shift=None):
    """(m, k, n) after checking what the kernel takes, on any device: a
    (M, K) and b (K, N) bf16, K and N multiples of 8, M >= 1; scale /
    shift (K,) or both None."""
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
    if m < 1:
        raise ValueError(f"{what}: the CUDA kernel needs M >= 1, got {m}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{what}: scale and shift come together")
    if scale is not None and (scale.shape != (k,) or shift.shape != (k,)):
        raise ValueError(f"{what}: scale / shift must be ({k},)")
    return m, k, n


def _launch(what, a, b, scale, shift):
    """(y, s, ss) from the CUDA kernel, after checking what it takes: a
    (M, K) and b (K, N) bf16 on one CUDA device (check_matmul)."""
    for t in (a, b, scale, shift):
        if t is not None and (not t.is_cuda or t.device != a.device):
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors "
                             "on one device")
    m, k, n = check_matmul(what, a, b, scale, shift)
    if scale is not None:
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
    a, b = a.contiguous(), b.contiguous()
    check_tma(what, a, b, scale, shift)
    plan = plan_matmul(m, k, n, _sms(a.device), True, scale is not None)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    part = torch.empty((2, plan["grid"], n), dtype=torch.float32,
                       device=a.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=a.device)
    rc = _build.load("cea_fused_matmul")(
        a.data_ptr(), None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), b.data_ptr(),
        y.data_ptr(), part.data_ptr(), stats.data_ptr(), m, k, n,
        plan["bn"], plan["a_stages"], plan["b_stages"], plan["grid"],
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
