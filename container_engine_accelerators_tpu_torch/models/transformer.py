"""Decoder-only transformer LM in PyTorch: the port of
container_engine_accelerators_tpu/models/transformer.py
(`full_causal_attention` :32, `DecoderBlock` :43, `apply_embed` :357,
`apply_head` :381, `_HeadParams` :392, `TransformerLM` :415,
`_auto_use_flash` :501, `resolve_attn` :521 (with `shard_batch_fn`
:545 and `shard_heads_fn` :568), `lm_tp_param_specs` :593,
`build_lm_training_tp` :631, `build_ring_attn` :761,
`build_lm_training` :776).

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

Training (`build_lm_training`): attention through `attn_fn` (flash,
ops/flash_attention.py, or the dense math); the dense head's loss
through ops/fused_xent.py or ops/losses.py, or the chunked head
(ops/chunked_xent.py) that never holds the (tokens, vocab) logits;
AdamW as optax's.  Over a mesh (parallel/, one process a rank) it trains
data parallel (flash and the fused loss on each rank's batch shard) or
sequence parallel (the KV ring, parallel/ring_attention.py), and
`build_lm_training_tp` tensor parallel (TPTransformerLM: this rank's
heads and vocab columns, the vocab-parallel cross entropy).

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
    prefill and the oracle).  `write_pos` is a Python int or a 0-dim
    tensor on the cache's device, which no step reads back.
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
    cache_len = ck.shape[1]
    # Written by index, so a 0-dim device operand (a prefill seam
    # captured in a CUDA graph) is never read back to the host.
    at = torch.arange(s, device=q.device) + write_pos
    ck.index_copy_(1, at, k.to(ck.dtype))
    cv.index_copy_(1, at, v.to(cv.dtype))
    qf = q.float() / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, ck.float())
    slots = torch.arange(cache_len, device=q.device)
    visible = slots[None, :] <= at[:, None]  # (s, cache_len)
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
        return x + self.ffn(h)

    def ffn(self, h):
        """The MLP (models/moe_lm.py's block overrides this alone)."""
        return self.fc1(gelu_tanh(self.fc0(h)))


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
        self.qkv_heads = heads  # the heads this rank's qkv holds
        self.dtype, self.decode, self.device = dtype, decode, dev
        self.embed_dtype = dtype
        self.remat = remat
        self.embed = nn.Parameter(torch.zeros((vocab, dim), device=dev))
        self.pos_emb = nn.Parameter(torch.zeros((max_seq, dim), device=dev))
        self.blocks = nn.ModuleList(
            self._block(i, dim, heads, dtype, dev, param_dtype, attn_fn)
            for i in range(depth)
        )
        self.ln_f = LayerNorm(dim, dtype, dev)
        head_cols = vocab // self._head_shards()
        self.head_kernel = nn.Parameter(
            torch.zeros((dim, head_cols), device=dev)
        )
        self.head_bias = nn.Parameter(torch.zeros((head_cols,), device=dev))
        self.requires_grad_(False)

    def _block(self, i, dim, heads, dtype, dev, param_dtype, attn_fn):
        return DecoderBlock(dim, heads, dtype, dev, param_dtype=param_dtype,
                            attn_fn=attn_fn)

    def _head_shards(self) -> int:
        return 1

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
        x = self.embed[tokens.long()].to(self.embed_dtype)
        pos = self.pos_emb[:s] if positions is None else self.pos_emb[
            positions.long().clamp(max=self.max_seq - 1)
        ]
        if pos.ndim == 2:
            pos = pos[None]
        return x + pos.to(self.embed_dtype)

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


def resolve_attn(attn_impl: str, seq_len: int, device="cuda"):
    """Attention selection (reference :521): flash on the card when the
    length passes the gate, the dense math otherwise.  Explicit 'flash'
    skips the gate (the wrapper raises at call time on a shape it does
    not take).  Under a mesh it is the same choice: the port runs one
    program per rank, so a rank's activations already are its batch
    (or, tensor parallel, its heads) shard, and the kernel runs on them
    as they are, where the reference wraps it in shard_map
    (`shard_batch_fn` :545, `shard_heads_fn` :568)."""
    if not _auto_use_flash(attn_impl, seq_len, device):
        return full_causal_attention
    return flash_causal_attention


def resolve_loss(loss_impl: str, rows: int, device="cuda") -> str:
    """'fused' or 'xla' (reference :836-851): 'auto' takes the fused
    kernels on the card where the row count (a rank's shard under a
    mesh) divides the reference's 8-row blocks."""
    if loss_impl not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    if loss_impl != "auto":
        return loss_impl
    cuda = torch.device(device).type == "cuda"
    return "fused" if cuda and rows and rows % 8 == 0 else "xla"


def build_ring_attn(mesh, axis_name: str, layout: str = "contiguous"):
    """Causal ring attention over `axis_name` of `mesh` on each rank's
    sequence shard (reference :761); layout "zigzag" takes shards in
    zigzag storage order."""
    from ..parallel import ring_attention as RA

    group = mesh.get_group(axis_name)
    if layout == "zigzag":
        return lambda q, k, v: RA.ring_attention_zigzag(q, k, v, group)
    if layout != "contiguous":
        raise ValueError(f"unknown ring attention layout {layout!r}")
    return lambda q, k, v: RA.ring_attention(q, k, v, group, causal=True)


def _adamw(model, learning_rate):
    # optax.adamw(learning_rate) as this repo's optax builds it: b1 0.9,
    # b2 0.999, eps 1e-8, decoupled weight decay 1e-4 on every leaf (no
    # mask: biases, LayerNorms and embeddings decay too).
    return torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4,
    )


def _random_batch_fn(vocab, batch, seq_len, dev, perm=None):
    def batch_fn(generator: torch.Generator):
        tok = torch.randint(
            0, vocab, (batch, seq_len + 1), generator=generator,
            device=generator.device,
        ).to(dev)
        tokens, targets = tok[:, :-1], tok[:, 1:]
        if perm is not None:
            # Zigzag storage order; targets ride along, so each slot
            # still predicts its own next global token.
            tokens, targets = tokens[:, perm], targets[:, perm]
        return tokens, targets

    return batch_fn


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
    """(step_fn, state, batch_fn) for LM training (reference :776).
    head_impl "chunked" takes the model's f32 hidden rows, head kernel
    and bias and the loss from ops/chunked_xent.py in `head_chunk`-column
    blocks (reference :902-910); "dense" the f32 logits and the resolved
    loss.

    With a mesh (a DeviceMesh, parallel/mesh.py; this process one of its
    ranks): without seq_axis, data parallelism, the batch split over
    every mesh axis, flash on each rank's shard and the fused loss per
    shard, its mean over the shards; with seq_axis, sequence
    parallelism, the sequence split over that axis and attention by the
    KV ring (seq_layout "zigzag": the balanced layout, tokens, targets
    and positions in zigzag storage order), the XLA loss.  Every rank
    holds the whole model; the gradients are summed over the mesh
    (parallel/layout.py `step_on_mesh`).

    state: {"model": TransformerLM with f32 master weights, "opt": AdamW,
    "step": int} (plus "mesh" and "layout" under a mesh).
    step_fn(state, tokens, targets) -> (state, loss) runs one forward,
    backward and AdamW update in place on the GLOBAL batch (each rank
    takes its shard) and returns the global mean loss; the step's
    gradients stay on the parameters (`.grad`) until the next step.
    batch_fn(generator) draws the global (tokens, targets), each (batch,
    seq_len), from a torch.Generator (zigzag order under that layout).
    params: a flax TransformerLM tree of numpy arrays to start from
    instead of the seeded draw.  dtype: the blocks' compute type (bf16,
    the reference's default; f32 for parity tests).  Runs on the card
    unless device="cpu"."""
    if seq_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown seq_layout {seq_layout!r}")
    sp = mesh is not None and seq_axis is not None
    if seq_layout == "zigzag" and not sp:
        raise ValueError("seq_layout='zigzag' needs mesh + seq_axis")
    dev = resolve_device(device)
    world = 1 if mesh is None else mesh.size()
    if sp:
        if attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        attn_fn = build_ring_attn(mesh, seq_axis, layout=seq_layout)
    else:
        attn_fn = resolve_attn(attn_impl, seq_len, device=dev)
    if mesh is not None and not sp and batch % world:
        raise ValueError(
            f"data-parallel LM: batch {batch} must divide evenly across "
            f"{world} devices (pass seq_axis for sequence parallelism "
            "instead)"
        )
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
    # Under sequence parallelism the logits are seq-sharded: the XLA
    # loss (reference :845-851).
    shard_rows = (batch // world) * seq_len
    loss_kind = ("xla" if sp and loss_impl == "auto"
                 else resolve_loss(loss_impl, shard_rows, dev))
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
    opt = _adamw(model, learning_rate)
    state = {"model": model, "opt": opt, "step": 0}

    perm = None
    if seq_layout == "zigzag":
        from ..parallel.mesh import axis_len
        from ..parallel.ring_attention import zigzag_permutation

        perm = torch.as_tensor(
            zigzag_permutation(seq_len, axis_len(mesh, seq_axis)), device=dev)
    take = positions = None
    if mesh is not None:
        from ..parallel import layout as LY
        from ..parallel.mesh import Sharding, batch_sharding, world_groups

        if sp:
            take = Sharding(mesh, (seq_axis,), dim=1)
            order = perm if perm is not None else torch.arange(
                seq_len, device=dev)
            positions = take.shard(order[None])[0]
        else:
            take = batch_sharding(mesh)
        state.update(mesh=mesh,
                     layout=LY.identity_layout(model, world_groups(mesh)))

    def loss_on(tokens, targets):
        labels = targets.reshape(-1)
        if head_impl == "chunked":
            hidden, head_k, head_b = model(tokens, positions=positions,
                                           head_impl="chunked")
            return chunked_softmax_xent(
                hidden.reshape(-1, dim), head_k, head_b, labels,
                chunk_size=head_chunk,
            )
        logits = model(tokens, positions=positions)
        return loss_of(logits.reshape(-1, vocab), labels)

    def step_fn(state, tokens, targets):
        if mesh is not None:
            loss, _ = LY.step_on_mesh(state, lambda: (
                loss_on(take.shard(tokens), take.shard(targets)), None))
            return state, loss
        opt.zero_grad(set_to_none=True)
        loss = loss_on(tokens, targets)
        loss.backward()
        opt.step()
        state["step"] += 1
        return state, loss.detach()

    return step_fn, state, _random_batch_fn(vocab, batch, seq_len, dev, perm)


# ---- tensor parallelism (reference :568-759) ----

def lm_tp_param_specs(tree, tp_axis: str):
    """The reference's tensor-parallel placements of a flax
    TransformerLM tree (reference :593), as the dim each leaf splits
    along over `tp_axis` (None: replicated): column-parallel qkv (heads),
    row-parallel proj, the Dense_0 / Dense_1 pair, the vocab-split head;
    embeddings, LayerNorms and the biases that add after a reduction are
    replicated.  The axis is the reference's argument; the dims serve
    any tp axis (models/convert.py `shard_flax_params` cuts by them)."""

    def spec(path, leaf):
        name = path[-1]
        if "qkv" in path:
            return 2 if name == "kernel" else 1
        if "proj" in path or "Dense_1" in path:
            return 0 if name == "kernel" else None
        if "Dense_0" in path or "lm_head" in path:
            return 1 if name == "kernel" else 0
        return None

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return spec(path, node)

    return walk(tree, ())


def _tp_placement(name, shape, dim, heads, vocab, index, count):
    """Where a TPTransformerLM parameter sits in the one-rank model's."""
    from ..parallel.layout import split_placement, whole

    d_head = dim // heads
    full = {
        "qkv.kernel": ((dim, 3 * dim), (dim, 3, heads, d_head), 2),
        "qkv.bias": ((3 * dim,), (3, heads, d_head), 1),
        "proj.kernel": ((dim, dim), None, 0),
        "fc0.kernel": ((dim, 4 * dim), None, 1),
        "fc0.bias": ((4 * dim,), None, 0),
        "fc1.kernel": ((4 * dim, dim), None, 0),
        "head_kernel": ((dim, vocab), None, 1),
        "head_bias": ((vocab,), None, 0),
    }
    for suffix, (cshape, view, split) in full.items():
        if name == suffix or name.endswith("." + suffix):
            return split_placement(name, cshape, split, index, count, view)
    return whole(name, shape)


class TPDecoderBlock(DecoderBlock):
    """DecoderBlock over a tensor-parallel group: this rank's heads of
    qkv and rows of proj, columns of Dense_0 and rows of Dense_1; the
    row-parallel partial products are psum'd and their (replicated)
    biases added after the sum, as the reference's layout has GSPMD do.
    Names and shapes otherwise DecoderBlock's, so the flax loaders
    serve a rank's shard tree."""

    def __init__(self, dim, heads, dtype, device, group, n_tp,
                 param_dtype=None, attn_fn=full_causal_attention):
        nn.Module.__init__(self)
        self.dim, self.heads = dim, heads // n_tp
        self.d_head = dim // heads
        self.group, self.attn_fn = group, attn_fn
        local = self.heads * self.d_head
        self.ln0 = LayerNorm(dim, dtype, device)
        self.qkv = Dense(dim, 3 * local, dtype, device, param_dtype)
        self.proj = Dense(local, dim, dtype, device, param_dtype)
        self.ln1 = LayerNorm(dim, dtype, device)
        self.fc0 = Dense(dim, 4 * dim // n_tp, dtype, device, param_dtype)
        self.fc1 = Dense(4 * dim // n_tp, dim, dtype, device, param_dtype)

    @staticmethod
    def _row_parallel(dense, x, group):
        from ..parallel import _collectives as C

        part = torch.matmul(x.to(dense.dtype), dense.kernel.to(dense.dtype))
        return C.psum(part, group) + dense.bias.to(dense.dtype)

    def forward(self, x, cache=None, kv_mask=None, write_pos=None,
                block_tables=None):
        if cache is not None:
            raise NotImplementedError("tensor-parallel decode is not ported")
        b, s, _ = x.shape
        h = self.ln0(x)
        qkv = self.qkv(h).view(b, s, 3, self.heads, self.d_head)
        attn = self.attn_fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + self._row_parallel(self.proj, attn.reshape(b, s, -1),
                                   self.group)
        h = self.ln1(x)
        return x + self._row_parallel(self.fc1, gelu_tanh(self.fc0(h)),
                                      self.group)


class TPTransformerLM(TransformerLM):
    """TransformerLM over a tensor-parallel group: TPDecoderBlocks and
    this rank's vocab columns of the head, so forward returns (tokens,
    vocab / tp) logits.  `heads` is the model's; `qkv_heads` this
    rank's."""

    def __init__(self, group, index, n_tp, **kw):
        object.__setattr__(self, "_tp", (group, index, n_tp))
        super().__init__(**kw)
        self.qkv_heads = self.heads // n_tp
        self.tp_index, self.tp_size = index, n_tp

    def _block(self, i, dim, heads, dtype, dev, param_dtype, attn_fn):
        group, _, n_tp = self._tp
        return TPDecoderBlock(dim, heads, dtype, dev, group, n_tp,
                              param_dtype=param_dtype, attn_fn=attn_fn)

    def _head_shards(self) -> int:
        return self._tp[2]


def vocab_parallel_xent(logits, labels, group, vocab_start: int):
    """Per-row softmax cross entropy of logits split over the vocab:
    logits (rows, vocab / tp) this rank's columns from `vocab_start`.
    The row max and the sum of exponentials are reduced over the group
    and each row's label logit comes from the rank that holds it."""
    from ..parallel import _collectives as C

    m = C.pmax(logits.max(-1).values, group)
    sumexp = C.psum(torch.exp(logits - m[:, None]).sum(-1), group)
    local = labels.long() - vocab_start
    inside = (local >= 0) & (local < logits.shape[1])
    picked = logits.gather(1, local.clamp(0, logits.shape[1] - 1)[:, None])
    target = C.psum(torch.where(inside, picked[:, 0], 0.0), group)
    return torch.log(sumexp) + m - target


def _draw_flax_params(vocab, dim, depth, heads, seq_len, seed):
    """The seeded draw of the one-rank trainer as a flax tree, on the
    CPU (every rank draws the same, then keeps its shard)."""
    from .convert import to_flax_params

    full = TransformerLM(vocab=vocab, dim=dim, depth=depth, heads=heads,
                         max_seq=seq_len, dtype=torch.float32, device="cpu",
                         param_dtype=torch.float32)
    return to_flax_params(full.init_random(torch.Generator().manual_seed(seed)))


def build_lm_training_tp(
    mesh,
    tp_axis: str,
    vocab: int = 1024,
    dim: int = 256,
    depth: int = 2,
    heads: int = 4,
    seq_len: int = 512,
    batch: int = 4,
    learning_rate: float = 1e-3,
    seed: int = 0,
    attn_impl: str = "auto",
    data_axis=None,
    *,
    dtype=torch.bfloat16,
    device="cuda",
    params=None,
):
    """(step_fn, state, batch_fn) for tensor-parallel LM training
    (reference :631): this rank holds its shard of every split parameter
    (lm_tp_param_specs) and its AdamW moments, flash runs on its heads,
    the loss is the vocab-parallel cross entropy.  data_axis: a second
    mesh axis for 2-D dp x tp, the batch split over it.  The same seed
    (or `params`, a one-rank flax tree) gives the one-rank trainer's
    weights, so the loss matches build_lm_training's.  step_fn and
    batch_fn as build_lm_training's; gradients are summed over the data
    axis for split parameters and over the whole mesh for replicated
    ones."""
    from ..parallel import layout as LY
    from ..parallel.mesh import Sharding, axis_len, world_groups
    from .convert import shard_flax_params

    n_tp = axis_len(mesh, tp_axis)
    if data_axis is not None:
        if data_axis == tp_axis:
            raise ValueError("data_axis must differ from tp_axis")
        n_dp = axis_len(mesh, data_axis)
        if batch % n_dp:
            raise ValueError(
                f"2D dp x tp: batch {batch} must divide over {n_dp} "
                "data-parallel replicas"
            )
    if heads % n_tp:
        raise ValueError(
            f"tensor parallel: heads {heads} must divide over {n_tp} devices")
    if (4 * dim) % n_tp:
        raise ValueError(
            f"tensor parallel: MLP hidden {4 * dim} must divide over "
            f"{n_tp} devices")
    if vocab % n_tp:
        raise ValueError(
            f"tensor parallel: vocab {vocab} must divide over {n_tp} "
            "devices (the head is split by vocab)")
    dev = resolve_device(device)
    tp_group = mesh.get_group(tp_axis)
    t = mesh.get_local_rank(tp_axis)
    attn_fn = resolve_attn(attn_impl, seq_len, device=dev)
    model = TPTransformerLM(
        tp_group, t, n_tp, vocab=vocab, dim=dim, depth=depth, heads=heads,
        max_seq=seq_len, dtype=dtype, device=dev,
        param_dtype=torch.float32, attn_fn=attn_fn,
    )
    tree = params if params is not None else _draw_flax_params(
        vocab, dim, depth, heads, seq_len, seed)
    load_flax_params(model, shard_flax_params(
        tree, lm_tp_param_specs(tree, tp_axis), t, n_tp))
    model.requires_grad_(True)
    opt = _adamw(model, learning_rate)
    groups = world_groups(mesh)
    dp_groups = [mesh.get_group(data_axis)] if data_axis else []
    placements, grad_groups = {}, {}
    for name, p in model.named_parameters():
        pl = _tp_placement(name, tuple(p.shape), dim, heads, vocab, t, n_tp)
        placements[name] = pl
        grad_groups[name] = groups if pl.dim is None else dp_groups
    canon = [n for n, _ in TransformerLM(
        vocab=vocab, dim=dim, depth=depth, heads=heads, max_seq=seq_len,
        device="meta").named_parameters()]
    state = {"model": model, "opt": opt, "step": 0, "mesh": mesh,
             "layout": LY.Layout(placements, grad_groups, canon)}
    take = Sharding(mesh, (data_axis,) if data_axis else ())
    v_local = vocab // n_tp

    def loss_on(tokens, targets):
        logits = model(tokens)
        rows = vocab_parallel_xent(logits.reshape(-1, v_local),
                                   targets.reshape(-1), tp_group,
                                   t * v_local)
        return rows.mean(), None

    def step_fn(state, tokens, targets):
        loss, _ = LY.step_on_mesh(state, lambda: loss_on(
            take.shard(tokens), take.shard(targets)))
        return state, loss

    return step_fn, state, _random_batch_fn(vocab, batch, seq_len, dev)
