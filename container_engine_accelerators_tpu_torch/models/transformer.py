"""Decoder-only transformer LM in PyTorch: the port of
container_engine_accelerators_tpu/models/transformer.py
(`full_causal_attention` :32, `DecoderBlock` :43, `apply_embed` :357,
`apply_head` :381, `_HeadParams` :392, `TransformerLM` :415,
`_auto_use_flash` :501, `resolve_attn` :521, `build_lm_training` :776).

The numerics follow the flax module: parameters of the embedding,
positional table, LayerNorms and vocab head are f32; the block
projections compute in `dtype` (bf16 at serving width, f32 in the parity
tests); LayerNorm takes f32 statistics with epsilon 1e-6 and flax's
mean-of-squares variance; GELU is the tanh form, op for op; the head is
an f32 matmul.  Weights are laid out (in, out) as flax stores them.
The block projections store their weights in `param_dtype`: f32 masters
for training, cast to `dtype` at each call as flax does (an optimizer
stepping bf16 weights would drift from optax within a few steps), and
`dtype` itself for serving, which keeps one copy of the weights.

Training (`build_lm_training`, single chip): attention through
`attn_fn` (flash, ops/flash_attention.py, or the dense math); the dense
head's loss through ops/fused_xent.py or ops/losses.py, or the chunked
head (ops/chunked_xent.py) that never holds the (tokens, vocab) logits;
AdamW as optax's.

Decode paths ported (a `cache` argument selects them):
  - the PAGED path (:177-265): the cache holds page pools (n_pages,
    page, heads, d_head); this call's s k/v rows land at each row's
    (page, offset) pairs for slots [write_pos[b], write_pos[b] + s)
    through its block table, and slots past the mapped view land in the
    reserved null page 0.  A single token with a per-row (b, view)
    kv_mask attends through ops.paged_attention (the CUDA kernel on the
    card, the gather math on the CPU); the s > 1 VERIFY window of
    speculative decoding takes the per-query (b, s, view) kv_mask and
    runs the gather math, as the reference's does (its kernel gate is
    s == 1 with a 2-D mask);
  - the PER-ROW contiguous path (:266-318): a (b,) `write_pos` puts
    row b's s new k/v rows at [write_pos[b], write_pos[b] + s) of its
    own row, and a per-row kv_mask carries the visibility (the
    contiguous-slot engine's decode step);
  - the SCALAR `write_pos` contiguous path (:319-354): the s new k/v
    rows land at [write_pos, write_pos + s) of a (b, cache_len, heads,
    d_head) buffer and query i sees slots <= write_pos + i (chunked
    prefill and the oracle).
Caches are lists with one {"k", "v"} dict per block, updated IN PLACE
(the reference returns a new cache; the port mutates to keep one copy
of the pool resident).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.chunked_xent import chunked_softmax_xent
from ..ops.flash_attention import (
    causal_attention_plain as full_causal_attention,
    flash_causal_attention,
    flash_supports_seq,
)
from ..ops.fused_xent import fused_cross_entropy_loss
from ..ops.losses import cross_entropy_loss
from ..ops.paged_attention import paged_attention
from .convert import load_flax_params


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
    """flax.linen.Dense in `dtype`: kernel (in, out), bias (out,), stored
    in `param_dtype` (default: `dtype`) and cast to `dtype` per call."""

    def __init__(self, d_in, d_out, dtype, device, param_dtype=None):
        super().__init__()
        self.dtype = dtype
        pd = param_dtype or dtype
        self.kernel = nn.Parameter(
            torch.zeros((d_in, d_out), dtype=pd, device=device)
        )
        self.bias = nn.Parameter(torch.zeros((d_out,), dtype=pd, device=device))

    def forward(self, x):
        kernel, bias = self.kernel, self.bias
        if kernel.dtype != self.dtype:  # f32 masters (training)
            kernel, bias = kernel.to(self.dtype), bias.to(self.dtype)
        return torch.matmul(x.to(self.dtype), kernel) + bias


def _rowwise_attention(q, k, v, ck, cv, kv_mask, write_pos):
    """The per-row contiguous path (reference :266-318): row b's s new
    k/v rows land at slots [write_pos[b], write_pos[b] + s) of its own
    (cache_len, heads, d_head) buffer, in place, and kv_mask (b,
    cache_len), or (b, s, cache_len) when s > 1, carries the whole
    visibility.  A single-token write past the buffer writes nothing, as
    the reference's one-hot select does; a window clips to the last
    slot, as its scatter does."""
    b, s, h, d = q.shape
    cache_len = ck.shape[1]
    if kv_mask is None or kv_mask.ndim not in (2, 3) or (
        s > 1 and kv_mask.ndim != 3
    ):
        raise ValueError(
            "write_pos requires a per-row (b, cache_len) kv_mask carrying "
            "full visibility (per-query (b, s, cache_len) when s > 1)"
        )
    rows = torch.arange(b, device=q.device)
    wp = write_pos.long()
    if s == 1:
        inside = (wp >= 0) & (wp < cache_len)
        at = torch.where(inside, wp, 0)
        for buf, new in ((ck, k), (cv, v)):
            keep = buf[rows, at]
            buf[rows, at] = torch.where(
                inside[:, None, None], new[:, 0].to(buf.dtype), keep
            )
    else:
        cols = torch.clamp(
            wp[:, None] + torch.arange(s, device=q.device), 0, cache_len - 1
        )
        ck[rows[:, None], cols] = k.to(ck.dtype)
        cv[rows[:, None], cols] = v.to(cv.dtype)
    qf = q.float() / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, ck.float())
    vis = kv_mask[:, None, None, :] if kv_mask.ndim == 2 else kv_mask[:, None]
    p = torch.softmax(torch.where(vis, scores, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, cv.float()).to(q.dtype)


def _decode_attention(q, k, v, cache, kv_mask, write_pos, block_tables):
    """DecoderBlock._decode_attention for the ported paths (module
    docstring).  Writes this call's k/v into `cache` in place."""
    b, s, h, d = q.shape
    ck, cv = cache["k"], cache["v"]
    if block_tables is not None:
        if write_pos is None or not torch.is_tensor(write_pos) or (
            write_pos.ndim != 1
        ):
            raise ValueError("block_tables requires per-row (b,) write_pos")
        page = ck.shape[1]
        n_rows = block_tables.shape[1]
        view_len = n_rows * page
        if kv_mask is None or kv_mask.shape[-1] != view_len or not (
            tuple(kv_mask.shape) == (b, s, view_len)
            or (s == 1 and kv_mask.ndim == 2 and kv_mask.shape[0] == b)
        ):
            raise ValueError(
                "block_tables requires a per-row (b, pages_per_row * "
                "page) kv_mask (per-query (b, s, pages_per_row * page) "
                "when s > 1)"
            )
        # Slots [wp, wp + s) scatter to (page, offset) up-front; a slot
        # past the mapped view lands in the null page 0.
        slot = write_pos.long()[:, None] + torch.arange(s, device=q.device)
        page_i = torch.clamp(slot // page, 0, n_rows - 1)
        phys = block_tables.long().gather(1, page_i)
        flat = torch.where(slot < view_len, phys * page + slot % page, 0)
        ck.view(-1, h, d)[flat] = k.to(ck.dtype)
        cv.view(-1, h, d)[flat] = v.to(cv.dtype)
        if kv_mask.ndim == 2:
            out = paged_attention(
                q[:, 0].contiguous(), ck, cv, block_tables, kv_mask
            )
            return out[:, None].to(q.dtype)
        rows = block_tables.reshape(-1).long()
        kview = ck[rows].reshape(b, view_len, h, d)
        vview = cv[rows].reshape(b, view_len, h, d)
        qf = q.float() / (d ** 0.5)
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kview.float())
        p = torch.softmax(
            torch.where(kv_mask[:, None], scores, -1e30), dim=-1
        )
        return torch.einsum("bhqk,bkhd->bqhd", p, vview.float()).to(q.dtype)
    if torch.is_tensor(write_pos) and write_pos.ndim == 1:
        return _rowwise_attention(q, k, v, ck, cv, kv_mask, write_pos)
    if write_pos is None:
        raise NotImplementedError(
            "the decode cache takes an explicit write_pos: the shared "
            "cache index of the reference's flax cache is not ported"
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

    def __init__(self, dim, heads, dtype, device, mlp_ratio=4,
                 param_dtype=None, attn_fn=full_causal_attention):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.attn_fn = attn_fn
        self.ln0 = LayerNorm(dim, dtype, device)
        self.qkv = Dense(dim, 3 * dim, dtype, device, param_dtype)
        self.proj = Dense(dim, dim, dtype, device, param_dtype)
        self.ln1 = LayerNorm(dim, dtype, device)
        self.fc0 = Dense(dim, dim * mlp_ratio, dtype, device, param_dtype)
        self.fc1 = Dense(dim * mlp_ratio, dim, dtype, device, param_dtype)

    def forward(self, x, cache=None, kv_mask=None, write_pos=None,
                block_tables=None):
        b, s, _ = x.shape
        h = self.ln0(x)
        qkv = self.qkv(h).view(b, s, 3, self.heads, self.dim // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is None:
            attn = self.attn_fn(q, k, v)
        else:
            attn = _decode_attention(
                q, k, v, cache, kv_mask, write_pos, block_tables
            )
        x = x + self.proj(attn.reshape(b, s, self.dim))
        h = self.ln1(x)
        return x + self.fc1(gelu_tanh(self.fc0(h)))


class TransformerLM(nn.Module):
    """Decoder-only LM.  `forward(tokens)` is the training forward
    (causal attention through `attn_fn`; `remat` recomputes each block's
    activations in the backward, as the reference's nn.remat does); with
    `cache` it runs a decode path (module docstring).
    head_impl="chunked" returns (f32 hidden, head kernel, head bias)
    instead of logits, so only the rows that sample pay the vocab
    matmul.  `decode` marks the decode-mode twin (make_decoder), as in
    the reference.  `param_dtype` is the block projections' storage
    (default `dtype`; f32 masters for training).  Parameters are zeros
    until loaded (models/convert.py) or drawn (`init_random`), and take
    no gradient until a trainer asks for one."""

    def __init__(self, vocab=32000, dim=512, depth=4, heads=8,
                 max_seq=8192, dtype=torch.bfloat16, decode=False,
                 device="cuda", param_dtype=None,
                 attn_fn=full_causal_attention, remat=False):
        super().__init__()
        dev = resolve_device(device)
        if dim % heads:
            raise ValueError(f"dim {dim} must divide over {heads} heads")
        self.config = dict(
            vocab=vocab, dim=dim, depth=depth, heads=heads,
            max_seq=max_seq, dtype=dtype, decode=decode, device=dev,
            param_dtype=param_dtype, attn_fn=attn_fn, remat=remat,
        )
        self.vocab, self.dim, self.depth = vocab, dim, depth
        self.heads, self.max_seq = heads, max_seq
        self.dtype, self.decode, self.device = dtype, decode, dev
        self.remat = remat
        self.embed = nn.Parameter(torch.zeros((vocab, dim), device=dev))
        self.pos_emb = nn.Parameter(torch.zeros((max_seq, dim), device=dev))
        self.blocks = nn.ModuleList(
            DecoderBlock(dim, heads, dtype, dev, param_dtype=param_dtype,
                         attn_fn=attn_fn)
            for _ in range(depth)
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
        """Token + learned positional embedding (apply_embed :357).  A
        position past the table reads its last row, as the reference's
        gather clamps (a fused block's dead tail may run past max_seq:
        its tokens are never committed)."""
        s = tokens.shape[1]
        x = self.embed[tokens.long()].to(self.dtype)
        pos = self.pos_emb[:s] if positions is None else self.pos_emb[
            positions.long().clamp(max=self.max_seq - 1)
        ]
        if pos.ndim == 2:
            pos = pos[None]
        return x + pos.to(self.dtype)

    def forward(self, tokens, positions=None, cache=None, kv_mask=None,
                write_pos=None, block_tables=None, head_impl="dense"):
        x = self.apply_embed(tokens, positions)
        for i, blk in enumerate(self.blocks):
            if cache is None and self.remat:
                x = checkpoint(blk, x, use_reentrant=False)
                continue
            x = blk(
                x, None if cache is None else cache[i], kv_mask,
                write_pos, block_tables,
            )
        x = self.ln_f(x)
        if head_impl == "chunked":
            return x.float(), self.head_kernel, self.head_bias
        return torch.matmul(x.float(), self.head_kernel) + self.head_bias


def _auto_use_flash(attn_impl: str, seq_len: int, device="cuda") -> bool:
    """THE flash auto-gate (reference :501): explicit 'flash' forces it;
    'auto' requires the card (the reference: a Pallas-TPU backend) and a
    length the reference's gate accepts, so that both packages pick the
    same path for the same shape.  The card's kernels take every head
    dim that is a multiple of 8 up to 256 (flash_attention's rule), so
    every lm_main `--heads` that gives such a dim trains on them; the
    wrapper raises for any other, naming the rule."""
    if attn_impl not in ("auto", "dense", "flash"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    return attn_impl == "flash" or (
        attn_impl == "auto"
        and torch.device(device).type == "cuda"
        and flash_supports_seq(seq_len)
    )


def resolve_attn(attn_impl: str, seq_len: int, mesh=None, batch_axes=None,
                 device="cuda"):
    """Attention selection (reference :521): flash on the card when the
    length passes the gate, the dense math otherwise.  Explicit 'flash'
    skips the gate (the wrapper raises at call time on a shape it does
    not take).  A mesh raises: data-parallel wrapping comes with
    parallel/ (ROADMAP A10)."""
    if mesh is not None or batch_axes is not None:
        raise NotImplementedError(
            "attention under a device mesh comes with the port of "
            "parallel/ (ROADMAP A10)"
        )
    if _auto_use_flash(attn_impl, seq_len, device):
        return flash_causal_attention
    return full_causal_attention


def resolve_loss(loss_impl: str, rows: int, device="cuda") -> str:
    """'fused' or 'xla' (reference :836-851, single chip): 'auto' takes
    the fused kernels on the card where the row count divides the
    reference's 8-row blocks."""
    if loss_impl not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    if loss_impl != "auto":
        return loss_impl
    cuda = torch.device(device).type == "cuda"
    return "fused" if cuda and rows and rows % 8 == 0 else "xla"


def build_lm_training(
    mesh=None,
    seq_axis=None,
    vocab: int = 1024,
    dim: int = 256,
    depth: int = 2,
    heads: int = 4,
    seq_len: int = 512,
    batch: int = 4,
    learning_rate: float = 1e-3,
    seed: int = 0,
    remat: bool = False,
    seq_layout: str = "contiguous",
    attn_impl: str = "auto",
    loss_impl: str = "auto",
    head_impl: str = "dense",
    head_chunk: int = 8192,
    *,
    dtype=torch.bfloat16,
    device="cuda",
    params=None,
):
    """(step_fn, state, batch_fn) for single-chip LM training (reference
    :776, its `mesh=None` path).  head_impl "chunked" takes the model's
    f32 hidden rows, head kernel and bias and the loss from
    ops/chunked_xent.py in `head_chunk`-column blocks (reference
    :902-910); "dense" the f32 logits and the resolved loss.

    state: {"model": TransformerLM with f32 master weights, "opt": AdamW,
    "step": int}.  step_fn(state, tokens, targets) -> (state, loss) runs
    one forward, backward and AdamW update in place; the step's
    gradients stay on the parameters (`.grad`) until the next step.
    batch_fn(generator) draws (tokens, targets), each (batch, seq_len),
    from a torch.Generator.  params: a flax TransformerLM tree of numpy
    arrays to start from instead of the seeded draw.  dtype: the blocks'
    compute type (the reference's TransformerLM default bf16; f32 for
    parity tests).  Runs on the card unless device="cpu"."""
    if seq_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown seq_layout {seq_layout!r}")
    if seq_layout == "zigzag" and (mesh is None or seq_axis is None):
        raise ValueError("seq_layout='zigzag' needs mesh + seq_axis")
    if mesh is not None:
        raise NotImplementedError(
            "data- and sequence-parallel LM training come with the port of "
            "parallel/ (ROADMAP A10)"
        )
    dev = resolve_device(device)
    attn_fn = resolve_attn(attn_impl, seq_len, device=dev)
    loss_kind = resolve_loss(loss_impl, batch * seq_len, dev)
    if head_impl not in ("dense", "chunked"):
        raise ValueError(f"unknown head_impl {head_impl!r}")
    if head_impl == "chunked":
        if head_chunk <= 0:
            raise ValueError(f"head_chunk must be positive, got {head_chunk}")
        if loss_impl == "fused":
            raise ValueError(
                "head_impl='chunked' subsumes the loss; it is "
                "incompatible with loss_impl='fused'"
            )
    loss_of = (
        fused_cross_entropy_loss if loss_kind == "fused"
        else cross_entropy_loss
    )
    model = TransformerLM(
        vocab=vocab, dim=dim, depth=depth, heads=heads, max_seq=seq_len,
        dtype=dtype, device=dev, param_dtype=torch.float32,
        attn_fn=attn_fn, remat=remat,
    )
    if params is None:
        model.init_random(torch.Generator().manual_seed(seed))
    else:
        load_flax_params(model, params)
    model.requires_grad_(True)
    # optax.adamw(learning_rate) as this repo's optax builds it: b1 0.9,
    # b2 0.999, eps 1e-8, decoupled weight decay 1e-4 on every leaf (no
    # mask: biases, LayerNorms and embeddings decay too).
    opt = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4,
    )
    state = {"model": model, "opt": opt, "step": 0}

    def step_fn(state, tokens, targets):
        model, opt = state["model"], state["opt"]
        opt.zero_grad(set_to_none=True)
        if head_impl == "chunked":
            hidden, head_k, head_b = model(tokens, head_impl="chunked")
            loss = chunked_softmax_xent(
                hidden.reshape(-1, dim), head_k, head_b,
                targets.reshape(-1), chunk_size=head_chunk,
            )
        else:
            logits = model(tokens)
            loss = loss_of(logits.reshape(-1, vocab), targets.reshape(-1))
        loss.backward()
        opt.step()
        state["step"] += 1
        return state, loss.detach()

    def batch_fn(generator: torch.Generator):
        tok = torch.randint(
            0, vocab, (batch, seq_len + 1), generator=generator,
            device=generator.device,
        ).to(dev)
        return tok[:, :-1], tok[:, 1:]

    return step_fn, state, batch_fn
