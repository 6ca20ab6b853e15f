"""Causal flash attention: hand-written CUDA kernels
(csrc/flash_attention.cu), forward and backward, and their plain
PyTorch version.

Replaces the Pallas TPU kernels that container_engine_accelerators_tpu/
ops/flash_attention.py reaches: the classic `_flash_fn` (:112) and the
splash `_splash_fn` (:90); entry `flash_causal_attention` (:136), gate
`flash_supports_seq` (:39).  Splash and the classic kernel compute the
same function, so one CUDA kernel serves every length, and the
reference's splash routing with its warn-and-fall-back path is not
carried over.

The kernels are built for Hopper and take any head dim that is a
multiple of 8 up to 256 (`head_dim_instance`): instances at d 64, 128
and 256, a smaller d running the next instance up with its columns past
d zero-filled on load and never stored (d 32 on the d-64 instance, d 96
on the d-128 one); HEAD_DIMS names the widths they are sized for.
v may be narrower than q and k for one pair, (192, 128): latent
attention's q . k over 192 columns and p . v over 128 (`WIDE_PAIR`),
which runs kernels of its own sized for it (v, O, dO and dV 128 wide; q,
k, dQ and dK 192), v read through its strides where it lies.
Every product is a wgmma, a block of two warpgroups owns 128 query (or
key) rows (at d 256 the tiles shrink to fit: see the source), shared
tiles lie in wgmma's 128-byte swizzle, and the
streamed K / V (or Q / dO) tiles go through a ring of shared-memory
stages that TMA fills one or two steps ahead of their use (tensor maps
encoded per call from the views' own strides, completion on mbarriers),
so copies are in flight while the tensor cores work.  The forward keeps
each score tile in registers with an online softmax in base 2 (no
(b, h, s, s) score or probability tensor reaches device memory), does
one tile's softmax under the previous tile's P V product and the other
warpgroup's products, and saves the per-row logsumexp (b, h, s) in
f32.  The backward is FA2's in two passes: D = rowsum(dO * O), one pass
per key tile for dK / dV and one per query tile for dQ, tiles above the
diagonal skipped, f32 sums in a fixed order, no atomics: two runs give
the same bits.  The kernels read q, k and v through their strides (head
dim contiguous), so the strided views of the fused qkv projection are
read in place, with no copy; O and the gradients are written
contiguous.  Any seq that is a multiple of 64 is taken: the ragged half
of a last 128-row tile is zero-filled, masked and not stored.  See the
source's header for the layout and the bound.

The plain version is the reference's dense math (transformer.py
`full_causal_attention` :32): f32 scores with q divided by sqrt(d), a
-1e30 causal fill, softmax, cast back to q's type; autograd gives its
gradients.  The wrapper takes it only for CPU tensors (the reference's
tests run flash on the CPU through the same dense math); on a CUDA
tensor it launches the kernels or raises.  MIN_SEQ and
`flash_supports_seq` are the reference's, verbatim, so `attn_impl=
"auto"` picks the same path for the same shape, and the length checks
raise as the reference's do.
"""

from __future__ import annotations

import torch

from . import _build

# The reference kernel's minimum block and default classic blocks
# (flash_causal_attention :159-160): kept so that both packages accept
# the same lengths.
MIN_SEQ = 128
_BLOCK_Q, _BLOCK_K = 256, 512
# The head dims the CUDA kernels are sized for: d 32 runs the d-64
# instance, d 64 / 128 / 256 their own.
HEAD_DIMS = (32, 64, 128, 256)
MAX_HEAD_DIM = 256
_INSTANCES = (64, 128, 256)
# The (q . k width, v width) pair with v narrower that has an instance of
# its own.
WIDE_PAIR = (192, 128)
_TILE = 64  # a warpgroup's rows: s must be a multiple of it


def flash_supports_seq(s: int, block_q: int = 256, block_k: int = 512) -> bool:
    """The reference's gate (ops/flash_attention.py :39), verbatim: s at
    least MIN_SEQ, a multiple of it, and divisible by both blocks
    clamped to s.  Auto-selection falls back to dense attention
    otherwise."""
    return (
        s >= MIN_SEQ
        and s % MIN_SEQ == 0
        and s % min(block_q, s) == 0
        and s % min(block_k, s) == 0
    )


def causal_attention_plain(q, k, v):
    """Dense causal attention on (batch, seq, heads, head_dim): f32
    scores, softmax, the result in q's dtype."""
    b, s, h, d = q.shape
    qf = q.float() / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    scores = torch.where(mask[None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _check_seq(s: int) -> None:
    """The reference's length checks (flash_causal_attention :162-173)."""
    if s < MIN_SEQ:
        raise ValueError(
            f"flash attention needs seq >= {MIN_SEQ} (got {s}): the "
            "reference kernel's minimum block, kept so that both packages "
            "accept the same lengths"
        )
    block_q, block_k = min(_BLOCK_Q, s), min(_BLOCK_K, s)
    if s % block_q or s % block_k:
        raise ValueError(
            f"flash attention needs seq ({s}) divisible by blocks "
            f"({block_q}, {block_k})"
        )


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def head_dim_instance(d: int) -> int:
    """The kernel instance head dim d runs: the smallest of 64, 128 and
    256 at or above it (its columns past d zero-filled)."""
    return next(n for n in _INSTANCES if n >= d)


def check_head_dim_and_seq(d: int, s: int) -> None:
    """The kernels' shape rule: a head dim that is a multiple of 8 up to
    MAX_HEAD_DIM (16-byte rows, and the largest instance) and a seq that
    is a multiple of a warpgroup's 64 rows."""
    if d % 8 or not 0 < d <= MAX_HEAD_DIM or s % _TILE:
        raise ValueError(
            f"flash attention: the kernels take a head dim that is a "
            f"multiple of 8 up to {MAX_HEAD_DIM} and a seq multiple of "
            f"{_TILE}; got d {d}, seq {s}"
        )


def flash_instance(d: int, dv: int) -> tuple:
    """The kernel instance, as (q . k width, v width), that q and k of
    head dim d and v of head dim dv run: (n, n) for dv == d, n the
    instance `head_dim_instance` names; WIDE_PAIR as itself.  Raises
    ValueError for any other pair."""
    if dv == d:
        return (head_dim_instance(d),) * 2
    if (d, dv) == WIDE_PAIR:
        return WIDE_PAIR
    raise ValueError(
        f"flash attention: v's head dim must equal q's, or the pair be "
        f"{WIDE_PAIR}; got d {d}, v's {dv}"
    )


def _check_qkv(q, k, v):
    """The instance (flash_instance) q, k and v run, after the checks."""
    b, s, h, d = q.shape
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(
                "flash attention: the CUDA kernels take CUDA tensors on one "
                "device"
            )
        if t.dtype != torch.bfloat16 or k.shape != q.shape or (
            v.shape[:-1] != q.shape[:-1]
        ):
            raise ValueError(
                f"flash attention: the kernels take bf16 q and k of one "
                f"shape and v of their (batch, seq, heads); got {q.dtype} "
                f"{tuple(q.shape)}, {k.dtype} {tuple(k.shape)}, {v.dtype} "
                f"{tuple(v.shape)}"
            )
        if t.stride(3) != 1 or any(x % 8 for x in _strides(t)) or (
            t.data_ptr() % 16
        ):
            raise ValueError(
                "flash attention: the kernels read 16-byte rows: the head "
                "dim must be contiguous, the other strides multiples of 8 "
                "and the data 16-byte aligned"
            )
    check_head_dim_and_seq(d, s)
    return flash_instance(d, v.shape[-1])


def _count(wrapper, instance):
    wrapper.launches += 1
    wrapper.by_instance[instance] = wrapper.by_instance.get(instance, 0) + 1


def flash_attention_fwd(q, k, v):
    """(out, lse): out (b, s, h, v's head dim) bf16 contiguous and lse
    (b, h, s) f32 from the forward kernel."""
    instance = _check_qkv(q, k, v)
    b, s, h, d = q.shape
    d_v = v.shape[-1]
    out = torch.empty((b, s, h, d_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rc = _build.load("cea_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_strides(q), *_strides(k), *_strides(v), b, s, h,
        d, d_v, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash attention forward")
    _count(flash_attention_fwd, instance)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout):
    """(dq, dk, dv) bf16 contiguous, dq and dk of q's shape and dv of v's,
    from the backward kernels; out and lse from flash_attention_fwd."""
    instance = _check_qkv(q, k, v)
    b, s, h, d = q.shape
    d_v = v.shape[-1]
    dout = dout.contiguous()
    if dout.dtype != q.dtype or dout.shape != out.shape or (
        out.shape != (b, s, h, d_v) or not out.is_contiguous()
        or not lse.is_contiguous()
    ):
        raise ValueError(
            "flash attention backward: dout must match out, and out / lse "
            "come from flash_attention_fwd"
        )
    delta = torch.empty_like(lse)
    dq, dk = (
        torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        for _ in range(2)
    )
    dv = torch.empty((b, s, h, d_v), dtype=q.dtype, device=q.device)
    rc = _build.load("cea_flash_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_strides(q), *_strides(k),
        *_strides(v), b, s, h, d, d_v,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash attention backward")
    _count(flash_attention_bwd, instance)
    return dq, dk, dv


# Launch counts: in all, and by instance (flash_instance's pair).
flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_attention_fwd.by_instance = {}
flash_attention_bwd.by_instance = {}


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return flash_attention_bwd(*ctx.saved_tensors, dout)


def flash_causal_attention(q, k, v):
    """Causal flash attention on (batch, seq, heads, head_dim) inputs.
    Scale is 1/sqrt(head_dim) on the f32 scores, the output in q's
    dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernels, or raise on a dtype, shape or layout they do not take."""
    _check_seq(q.shape[1])
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v)
    return _FlashAttention.apply(q, k, v)
