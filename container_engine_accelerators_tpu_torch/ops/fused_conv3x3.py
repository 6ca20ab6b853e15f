"""3x3 SAME stride-1 convolution with BatchNorm folded in, NHWC: a
hand-written CUDA kernel (csrc/fused_conv3x3.cu, core in
csrc/fused_gemm.cuh) and its plain PyTorch version.

Replaces the Pallas TPU kernel container_engine_accelerators_tpu/ops/
fused_conv3x3.py `_conv_kernel` (:55) via `_conv_call` (:112,
pallas_call :131); entry `conv3x3_bn_stats` (:166) with its VJP (`_fwd`
:180, `_bwd` :186).

    y = conv3x3_same(relu(x * scale + shift), w), plus the per-channel
    f32 sum and sum of squares of y

x (N, H, W, C); w (3, 3, C, C4) as flax stores it, read in tap order
tap = (dy + 1) * 3 + (dx + 1) as (9, C, C4); scale / shift (C,) f32 or
both None.  The prologue is applied first and the halo filled with
zeros after it, as the reference shifts its transformed block: a border
pixel contributes 0, not relu(shift).

The backward is the reference's: g folds in the statistics' gradients,
the data gradient is the same kernel with no prologue on the rotated,
transposed weights (`rot180_t`, its statistics discarded), and the
weight gradient nine per-tap products of the shifted input with g in
torch ops.  The wrapper takes the plain version only for CPU tensors; on
a CUDA tensor it launches the kernel or raises (bf16 only, C and C4
multiples of 8).  No model of the JAX package calls this op; the port
keeps it an op as well.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from .fused_linear import BM, _sms, check_tma, dot_f32, plan_gemm

TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def shift2d(x, dy, dx):
    """(N, H, W, C) shifted by (dy, dx) with zero fill: output (h, w)
    reads input (h + dy, w + dx)."""
    _, h, w, _ = x.shape
    pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    return pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :]


def conv3x3_plain(x, w9, scale=None, shift=None):
    """The kernel's function in torch ops: (y, s, ss), the nine taps
    summed in f32."""
    z = x
    if scale is not None:
        z = torch.relu(x.float() * scale + shift).to(x.dtype)
    n, h, w, c = x.shape
    c4 = w9.shape[-1]
    acc = torch.zeros((n * h * w, c4), dtype=torch.float32, device=x.device)
    for tap, (dy, dx) in enumerate(TAPS):
        acc += torch.matmul(shift2d(z, dy, dx).reshape(-1, c).float(),
                            w9[tap].float())
    return (acc.to(x.dtype).reshape(n, h, w, c4), acc.sum(0),
            (acc * acc).sum(0))


# Rows of the conv's A tile (its box of pixels with a one-pixel halo): a
# TMA box dimension is at most 256.
HALO_ROWS = 256


@functools.lru_cache(maxsize=None)
def tile_box(n, h, w):
    """The box of output pixels a conv tile covers, (wb, r, bi): wb
    pixels along w (w split evenly), r rows, bi images, at most BM
    pixels, with its one-pixel halo at most HALO_ROWS rows (a TMA box
    dimension); of those, the one whose tiles leave the fewest of their
    BM rows empty, then the one with the fewest tiles, then the one with
    the fewest halo rows (A tiles are read through the L2 once a tap
    chunk, halo and all)."""
    best = None
    for splits in range(1, w + 1):
        wb = -(-w // splits)
        if wb > BM or -(-w // wb) != splits:
            continue
        for r in range(1, min(h, BM // wb) + 1):
            for bi in range(1, min(n, BM // (wb * r)) + 1):
                if (wb + 2) * (r + 2) * bi > HALO_ROWS:
                    break
                tiles = splits * -(-h // r) * -(-n // bi)
                key = (n * h * w / (tiles * BM), -tiles,
                       -(wb + 2) * (r + 2) * bi)
                if best is None or key > best[0]:
                    best = (key, (wb, r, bi))
    return best[1]


def plan_conv(n, h, w, c, c4, sms, stats=True, affine=False):
    """The GEMM core's launch for the conv: plan_gemm's dict plus the
    tile's box of output pixels (tile_box)."""
    wb, r, bi = tile_box(n, h, w)
    pixel_tiles = -(-w // wb) * -(-h // r) * -(-n // bi)
    plan = plan_gemm("conv3x3_bn_stats", pixel_tiles, c4, c, sms, stats,
                     affine, a_rows=(wb + 2) * (r + 2) * bi, conv=True)
    plan.update(wb=wb, r=r, bi=bi)
    return plan


def check_conv(what, x, w9, scale=None, shift=None):
    """(n, h, w, c, c4) after checking what the kernel takes, on any
    device: x (N, H, W, C) and w9 (9, C, C4) bf16, C and C4 multiples of
    8; scale / shift (C,) or both None."""
    if x.dtype != torch.bfloat16 or w9.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the CUDA kernel takes bf16 operands, got "
                         f"{x.dtype} and {w9.dtype}")
    if x.ndim != 4 or w9.ndim != 3 or w9.shape[:2] != (9, x.shape[3]):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w9 "
                         f"{tuple(w9.shape)}")
    n, h, w, c = x.shape
    c4 = w9.shape[2]
    if c % 8 or c4 % 8:
        raise ValueError(f"{what}: the CUDA kernel needs C ({c}) and C4 "
                         f"({c4}) to be multiples of 8")
    if min(n, h, w) < 1:
        raise ValueError(f"{what}: empty input {tuple(x.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{what}: scale and shift come together")
    if scale is not None and (scale.shape != (c,) or shift.shape != (c,)):
        raise ValueError(f"{what}: scale / shift must be ({c},)")
    return n, h, w, c, c4


def conv3x3(x, w9, scale=None, shift=None, stats=True):
    """(y, s, ss) from the CUDA kernel; with stats=False, s and ss are
    None and not computed.  x (N, H, W, C) and w9 (9, C, C4) bf16 on one
    CUDA device (check_conv); scale / shift (C,) f32 or None."""
    what = "conv3x3_bn_stats"
    for t in (x, w9, scale, shift):
        if t is not None and (not t.is_cuda or t.device != x.device):
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors "
                             "on one device")
    n, h, w, c, c4 = check_conv(what, x, w9, scale, shift)
    if scale is not None:
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
    x, w9 = x.contiguous(), w9.contiguous()
    check_tma(what, x, w9, scale, shift)
    plan = plan_conv(n, h, w, c, c4, _sms(x.device), stats,
                     scale is not None)
    y = torch.empty((n, h, w, c4), dtype=torch.bfloat16, device=x.device)
    part = out = None
    if stats:
        part = torch.empty((2, plan["grid"], c4), dtype=torch.float32,
                           device=x.device)
        out = torch.empty((2, c4), dtype=torch.float32, device=x.device)
    rc = _build.load("cea_conv3x3")(
        x.data_ptr(), None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), w9.data_ptr(),
        y.data_ptr(), None if part is None else part.data_ptr(),
        None if out is None else out.data_ptr(), n, h, w, c, c4,
        plan["wb"], plan["r"], plan["bi"], plan["bn"], plan["a_stages"],
        plan["b_stages"], plan["grid"],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, what)
    conv3x3.launches += 1
    if not stats:
        return y, None, None
    return y, out[0], out[1]


conv3x3.launches = 0


def _conv(x, w9, scale, shift, stats=True):
    if x.device.type == "cpu":
        return conv3x3_plain(x, w9, scale, shift)
    return conv3x3(x, w9, scale, shift, stats)


def rot180_t(w9):
    """(9, C, C4) tap-ordered weights -> rotated and transposed (9, C4,
    C) for the data gradient: dx = conv(dy, rot180(W)^T)."""
    return torch.flip(w9, dims=(0,)).transpose(1, 2).contiguous()


class _Conv3x3BnStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, w):
        w9 = w.reshape(9, w.shape[2], w.shape[3]).to(x.dtype)
        y, s, ss = _conv(x, w9, scale, shift)
        ctx.has_affine = scale is not None
        ctx.save_for_backward(x, scale, shift, w9, y)
        return y, s, ss

    @staticmethod
    def backward(ctx, g, ds, dss):
        x, scale, shift, w9, y = ctx.saved_tensors
        g_tot = (g.float() + ds + 2.0 * y.float() * dss).to(x.dtype)
        # Data gradient: the same 9-tap kernel, statistics discarded.
        dz = _conv(g_tot, rot180_t(w9), None, None, stats=False)[0]
        dscale = dshift = None
        if ctx.has_affine:
            xf = x.float()
            pre = xf * scale + shift
            z = torch.relu(pre).to(x.dtype)
            dzm = torch.where(pre > 0.0, dz.float(), 0.0)
            dx = (dzm * scale).to(x.dtype)
            dscale = (dzm * xf).sum((0, 1, 2))
            dshift = dzm.sum((0, 1, 2))
        else:
            z, dx = x, dz
        # Weight gradient: dW[tap] = shifted(z)^T @ g, f32 results.
        c, c4 = z.shape[-1], g_tot.shape[-1]
        g2 = g_tot.reshape(-1, c4)
        dw = torch.stack([
            dot_f32(shift2d(z, dy, dx_).reshape(-1, c).t(), g2)
            for dy, dx_ in TAPS
        ]).reshape(3, 3, c, c4)
        return dx, dscale, dshift, dw


def conv3x3_bn_stats(x, scale, shift, w):
    """y = conv3x3_same(relu(x * scale + shift), w), plus the f32
    per-channel sum and sum of squares of y.  x (N, H, W, C); w (3, 3, C,
    C4); scale / shift (C,) f32 or both None.  Stride 1 only."""
    return _Conv3x3BnStats.apply(x, scale, shift, w)
