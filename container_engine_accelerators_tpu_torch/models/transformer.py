"""Decoder-only transformer LM in PyTorch: the port of
container_engine_accelerators_tpu/models/transformer.py
(`full_causal_attention` :32, `DecoderBlock` :43, `apply_embed` :357,
`apply_head` :381, `_HeadParams` :392, `TransformerLM` :415).

The numerics follow the flax module: parameters of the embedding,
positional table, LayerNorms and vocab head are f32; the block
projections compute in `dtype` (bf16 at serving width, f32 in the parity
tests); LayerNorm takes f32 statistics with epsilon 1e-6 and flax's
mean-of-squares variance; GELU is the tanh form, op for op; the head is
an f32 matmul.  Weights are laid out (in, out) as flax stores them.

Decode paths ported in this slice (a `cache` argument selects them):
  - the PAGED single-token step (:177-265): the cache holds page pools
    (n_pages, page, heads, d_head); this step's k/v land at each row's
    (page, offset) through its block table, positions past the mapped
    view land in the reserved null page 0, and attention runs through
    ops.paged_attention (the CUDA kernel on the card, the gather math on
    the CPU);
  - the SCALAR `write_pos` contiguous path (:319-354): the s new k/v
    rows land at [write_pos, write_pos + s) of a (b, cache_len, heads,
    d_head) buffer and query i sees slots <= write_pos + i (chunked
    prefill and the oracle).
The per-row contiguous path and the s > 1 verify windows (:266-318)
come with the speculative-decode slice (ROADMAP A2).

Caches are lists with one {"k", "v"} dict per block, updated IN PLACE
(the reference returns a new cache; the port mutates to keep one copy
of the pool resident).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from .._device import resolve_device
from ..ops.paged_attention import paged_attention


@functools.lru_cache(maxsize=None)
def _gelu_consts(dtype):
    """sqrt(2/pi) and 0.044715 rounded to `dtype`, as JAX's weakly typed
    scalars are when they meet an array of that type."""
    return tuple(
        float(torch.tensor(v, dtype=dtype))
        for v in (math.sqrt(2.0 / math.pi), 0.044715)
    )


def gelu_tanh(x):
    """jax.nn.gelu(approximate=True) op for op, with its constants in
    x's dtype (torch's own gelu rounds once, JAX once per op)."""
    c, a = _gelu_consts(x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x ** 3))))
    return x * cdf


def full_causal_attention(q, k, v):
    b, s, h, d = q.shape
    qf = q.float() / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    scores = torch.where(mask[None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm: f32 statistics (variance as the mean of
    squares minus the squared mean), epsilon 1e-6, f32 scale/bias,
    output in `dtype`."""

    def __init__(self, dim, dtype, device, eps=1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(
            (xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0
        )
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Dense(nn.Module):
    """flax.linen.Dense in `dtype`: kernel (in, out), bias (out,)."""

    def __init__(self, d_in, d_out, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.zeros((d_in, d_out), dtype=dtype, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros((d_out,), dtype=dtype, device=device)
        )

    def forward(self, x):
        return torch.matmul(x.to(self.dtype), self.kernel) + self.bias


def _decode_attention(q, k, v, cache, kv_mask, write_pos, block_tables):
    """DecoderBlock._decode_attention for the two ported paths (module
    docstring).  Writes this call's k/v into `cache` in place."""
    b, s, h, d = q.shape
    ck, cv = cache["k"], cache["v"]
    if block_tables is not None:
        if s != 1:
            raise NotImplementedError(
                "paged verify windows (s > 1) come with the "
                "speculative-decode slice (ROADMAP A2)"
            )
        if write_pos is None or not torch.is_tensor(write_pos) or (
            write_pos.ndim != 1
        ):
            raise ValueError("block_tables requires per-row (b,) write_pos")
        page = ck.shape[1]
        n_rows = block_tables.shape[1]
        view_len = n_rows * page
        if kv_mask is None or tuple(kv_mask.shape) != (b, view_len):
            raise ValueError(
                "block_tables requires a per-row (b, pages_per_row * "
                "page) kv_mask"
            )
        wp = write_pos.long()
        page_i = torch.clamp(wp // page, 0, n_rows - 1)
        phys = block_tables.long().gather(1, page_i[:, None])[:, 0]
        flat = torch.where(wp < view_len, phys * page + wp % page, 0)
        ck.view(-1, h, d)[flat] = k[:, 0].to(ck.dtype)
        cv.view(-1, h, d)[flat] = v[:, 0].to(cv.dtype)
        out = paged_attention(
            q[:, 0].contiguous(), ck, cv, block_tables, kv_mask
        )
        return out[:, None].to(q.dtype)
    if write_pos is None or (torch.is_tensor(write_pos) and write_pos.ndim):
        raise NotImplementedError(
            "the decode cache takes a scalar write_pos in this slice; "
            "per-row contiguous writes come with the speculative-decode "
            "slice (ROADMAP A2)"
        )
    if kv_mask is not None and kv_mask.ndim not in (1, 2):
        raise ValueError("scalar write_pos takes a (cache_len,) kv_mask")
    t = int(write_pos)
    cache_len = ck.shape[1]
    ck[:, t:t + s] = k.to(ck.dtype)
    cv[:, t:t + s] = v.to(cv.dtype)
    qf = q.float() / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, ck.float())
    slots = torch.arange(cache_len, device=q.device)
    rows = torch.arange(s, device=q.device)
    visible = slots[None, :] <= t + rows[:, None]  # (s, cache_len)
    if kv_mask is not None and kv_mask.ndim == 2:
        vis = visible[None] & kv_mask[:, None, :]
        scores = torch.where(vis[:, None], scores, -1e30)
    else:
        if kv_mask is not None:
            visible = visible & kv_mask[None, :]
        scores = torch.where(visible[None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, cv.float()).to(q.dtype)


class DecoderBlock(nn.Module):
    """One pre-norm decoder block (flax names: LayerNorm_0 -> ln0, qkv,
    proj, LayerNorm_1 -> ln1, Dense_0 -> fc0, Dense_1 -> fc1).  The qkv
    kernel is the flax DenseGeneral (dim, 3, heads, d_head) flattened to
    (dim, 3 * heads * d_head)."""

    def __init__(self, dim, heads, dtype, device, mlp_ratio=4):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.ln0 = LayerNorm(dim, dtype, device)
        self.qkv = Dense(dim, 3 * dim, dtype, device)
        self.proj = Dense(dim, dim, dtype, device)
        self.ln1 = LayerNorm(dim, dtype, device)
        self.fc0 = Dense(dim, dim * mlp_ratio, dtype, device)
        self.fc1 = Dense(dim * mlp_ratio, dim, dtype, device)

    def forward(self, x, cache=None, kv_mask=None, write_pos=None,
                block_tables=None):
        b, s, _ = x.shape
        h = self.ln0(x)
        qkv = self.qkv(h).view(b, s, 3, self.heads, self.dim // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is None:
            attn = full_causal_attention(q, k, v)
        else:
            attn = _decode_attention(
                q, k, v, cache, kv_mask, write_pos, block_tables
            )
        x = x + self.proj(attn.reshape(b, s, self.dim))
        h = self.ln1(x)
        return x + self.fc1(gelu_tanh(self.fc0(h)))


class TransformerLM(nn.Module):
    """Decoder-only LM.  `forward(tokens)` is the training forward
    (full causal attention); with `cache` it runs a decode path (module
    docstring).  head_impl="chunked" returns (f32 hidden, head kernel,
    head bias) instead of logits, so only the rows that sample pay the
    vocab matmul.  `decode` marks the decode-mode twin (make_decoder),
    as in the reference.  Parameters are zeros until loaded
    (models/convert.py) or drawn (`init_random`)."""

    def __init__(self, vocab=32000, dim=512, depth=4, heads=8,
                 max_seq=8192, dtype=torch.bfloat16, decode=False,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if dim % heads:
            raise ValueError(f"dim {dim} must divide over {heads} heads")
        self.config = dict(
            vocab=vocab, dim=dim, depth=depth, heads=heads,
            max_seq=max_seq, dtype=dtype, decode=decode, device=dev,
        )
        self.vocab, self.dim, self.depth = vocab, dim, depth
        self.heads, self.max_seq = heads, max_seq
        self.dtype, self.decode, self.device = dtype, decode, dev
        self.embed = nn.Parameter(torch.zeros((vocab, dim), device=dev))
        self.pos_emb = nn.Parameter(torch.zeros((max_seq, dim), device=dev))
        self.blocks = nn.ModuleList(
            DecoderBlock(dim, heads, dtype, dev) for _ in range(depth)
        )
        self.ln_f = LayerNorm(dim, dtype, dev)
        self.head_kernel = nn.Parameter(
            torch.zeros((dim, vocab), device=dev)
        )
        self.head_bias = nn.Parameter(torch.zeros((vocab,), device=dev))
        self.requires_grad_(False)

    def init_random(self, generator: torch.Generator, scale: float = 1.0):
        """Draw every parameter from `generator`: matmul kernels
        N(0, scale^2 / fan_in), biases N(0, (0.1 scale)^2), the token
        table N(0, 1), the positional table N(0, 0.02^2), LayerNorm
        scale 1 and bias 0.  Drawn on the CPU in f32, then moved, so a
        seed gives the same weights on every device."""

        def draw(p, std):
            w = torch.randn(p.shape, generator=generator) * std
            p.copy_(w.to(p.dtype))

        with torch.no_grad():
            draw(self.embed, 1.0)
            draw(self.pos_emb, 0.02)
            dense = [self.head_kernel] + [
                m.kernel for m in self.modules() if isinstance(m, Dense)
            ]
            for k in dense:
                draw(k, scale / math.sqrt(k.shape[0]))
            for m in self.modules():
                if isinstance(m, Dense):
                    draw(m.bias, 0.1 * scale)
            draw(self.head_bias, 0.1 * scale)
        return self

    def apply_embed(self, tokens, positions=None):
        """Token + learned positional embedding (apply_embed :357)."""
        s = tokens.shape[1]
        x = self.embed[tokens.long()].to(self.dtype)
        pos = self.pos_emb[:s] if positions is None else self.pos_emb[
            positions.long()
        ]
        if pos.ndim == 2:
            pos = pos[None]
        return x + pos.to(self.dtype)

    def forward(self, tokens, positions=None, cache=None, kv_mask=None,
                write_pos=None, block_tables=None, head_impl="dense"):
        x = self.apply_embed(tokens, positions)
        for i, blk in enumerate(self.blocks):
            x = blk(
                x, None if cache is None else cache[i], kv_mask,
                write_pos, block_tables,
            )
        x = self.ln_f(x)
        if head_impl == "chunked":
            return x.float(), self.head_kernel, self.head_bias
        return torch.matmul(x.float(), self.head_kernel) + self.head_bias
