"""Int8 weight-only decode in PyTorch: the port of
container_engine_accelerators_tpu/models/quant_generate.py
(`quantize_decode_params` :43, `dequantize_decode_params` :84, `_ln`
:129, `_qmm` :137, `_quantize_kv` :141, `quantize_kv_cache` :152,
`_cache_write` :165 (its per-row index math in `_row_slots`),
`_paged_flat_idx` :184, `_paged_write` :194, `quant_decode_step` :211,
the oracle
`generate_prefill_quant` :365, `init_quant_decode_cache` :460,
`init_quant_paged_cache` :490, `quant_paged_preload_scratch` :527,
`quant_paged_prefill_finish` :569, `quant_paged_engine_decode_step`
:634, `quant_paged_engine_decode_steps` :672,
`quant_verify_step` :721, `draft_chain` :870, `draft_fill_row` :914,
`quant_prefill_finish_into_slot` :1062, `quant_engine_decode_step`
:1132).

Every 2D matmul weight of the decoder (qkv, proj, both MLP matmuls, the
vocab head) is stored int8 with a per-output-channel f32 scale and runs
through ops.quant_matmul (the CUDA kernel on the card).  Prefill runs
the bf16 model with DEQUANTIZED weights (one model for prefill and
decode); decode runs `quant_decode_step`, whose activations are bf16 as
in the reference, whatever the model's dtype.  With quant_kv the KV
pool is int8 with per-(slot, head) scales and attention dequantizes
inside ops.paged_attention; over the contiguous engine cache attention
stays torch ops, as the reference leaves it to XLA.  Caches update in
place.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..ops.paged_attention import paged_attention
from ..ops.quant_matmul import int8_weight_matmul, quantize_weight
from .generate import (
    _as,
    _sample,
    _verify_sample,
    init_decode_cache,
    paged_scatter_row,
    write_slot_row,
)
from .transformer import TransformerLM, gelu_tanh

_DENSE = ("qkv", "proj", "fc0", "fc1")


def quantize_decode_params(model: TransformerLM):
    """Port TransformerLM -> quantized decode tree: {"embed", "pos_emb",
    "blocks": [{"ln0", "qkv", "proj", "ln1", "fc0", "fc1"}], "ln_f",
    "head"}, matmul entries {"i8", "scale", "bias"}; embeddings,
    LayerNorms and biases stay f32."""

    def q(kernel, bias):
        w_i8, scale = quantize_weight(kernel)
        return {"i8": w_i8, "scale": scale, "bias": bias.float()}

    def ln(m):
        return {"scale": m.scale.float(), "bias": m.bias.float()}

    blocks = []
    for blk in model.blocks:
        entry = {"ln0": ln(blk.ln0), "ln1": ln(blk.ln1)}
        for name in _DENSE:
            dense = getattr(blk, name)
            entry[name] = q(dense.kernel, dense.bias)
        blocks.append(entry)
    return {
        "embed": model.embed.float(),
        "pos_emb": model.pos_emb.float(),
        "blocks": blocks,
        "ln_f": ln(model.ln_f),
        "head": q(model.head_kernel, model.head_bias),
    }


def dequantize_decode_params(qparams, like: TransformerLM) -> TransformerLM:
    """Quantized tree -> a TransformerLM of `like`'s config holding the
    dequantized weights (the prefill model and the oracle's)."""
    model = TransformerLM(**like.config)

    def deq(entry):
        return entry["i8"].float() * entry["scale"][None, :]

    with torch.no_grad():
        model.embed.copy_(qparams["embed"])
        model.pos_emb.copy_(qparams["pos_emb"])
        model.ln_f.scale.copy_(qparams["ln_f"]["scale"])
        model.ln_f.bias.copy_(qparams["ln_f"]["bias"])
        model.head_kernel.copy_(deq(qparams["head"]))
        model.head_bias.copy_(qparams["head"]["bias"])
        for blk, qb in zip(model.blocks, qparams["blocks"]):
            for name in ("ln0", "ln1"):
                getattr(blk, name).scale.copy_(qb[name]["scale"])
                getattr(blk, name).bias.copy_(qb[name]["bias"])
            for name in _DENSE:
                getattr(blk, name).kernel.copy_(deq(qb[name]))
                getattr(blk, name).bias.copy_(qb[name]["bias"])
    return model


def _ln(x, p, eps=1e-6):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _qmm(x, entry):
    return int8_weight_matmul(x.contiguous(), entry["i8"], entry["scale"])


def _quantize_kv(arr):
    """(..., d) -> (int8 values, f32 scales (...)): symmetric int8 over
    the last axis."""
    af = arr.float()
    scale = torch.clamp(af.abs().amax(dim=-1), min=1e-8) / 127.0
    vals = torch.clamp(torch.round(af / scale[..., None]), -127, 127)
    return vals.to(torch.int8), scale


def quantize_kv_cache(cache):
    """[{"k", "v"}] float cache -> the int8 layout with per-(slot, head)
    scales."""
    out = []
    for c in cache:
        k_i8, k_s = _quantize_kv(c["k"])
        v_i8, v_s = _quantize_kv(c["v"])
        out.append({"k": k_i8, "k_scale": k_s, "v": v_i8, "v_scale": v_s})
    return out


def _row_slots(t, length):
    """(rows, slot, inside) of one write a row at per-row slots t (b,)
    of buffers `length` slots long: a slot past the buffer reads as 0
    with inside False.  Computed once a pass, not once a leaf: each op
    here costs the host more than its kernel costs the card."""
    t = t.long()
    inside = (t >= 0) & (t < length)
    rows = torch.arange(t.shape[0], device=t.device)
    return rows, torch.where(inside, t, 0), inside


def _cache_write(buf, new, t):
    """Write new (b, 1, ...) at slot t of buf (b, max_seq, ...): a shared
    scalar slot, or one slot per row as _row_slots gives them.  A
    per-row slot past the buffer writes nothing, as the reference's
    one-hot select does (the draft chain's passes may run past max_seq
    at a row's end)."""
    if not isinstance(t, tuple):
        t = int(t)
        buf[:, t:t + 1] = new.to(buf.dtype)
    else:
        rows, at, inside = t
        keep = buf[rows, at]
        inside = inside.view((-1,) + (1,) * (keep.ndim - 1))
        buf[rows, at] = torch.where(inside, new[:, 0].to(buf.dtype), keep)


def _paged_flat_idx(bt, t, page):
    """Per-row flat pool index of slot t through block table bt (b, P):
    physical page * page + offset; past the view -> null page 0."""
    n_rows = bt.shape[1]
    t = t.long()
    page_i = torch.clamp(t // page, 0, n_rows - 1)
    phys = bt.long().gather(1, page_i[:, None])[:, 0]
    return torch.where(t < n_rows * page, phys * page + t % page, 0)


def _paged_write(buf, new, flat):
    """Write new (b, 1, ...) into the pool buf (n_pages, page, ...) at
    per-row flat indices, in place."""
    buf.view((-1,) + tuple(buf.shape[2:]))[flat] = new[:, 0].to(buf.dtype)


def quant_decode_step(qparams, cache, tok, pos, t, kv_mask, heads,  # hot-path
                      block_tables=None, with_head=True):
    """One generated token through the quantized decoder.  tok (b,) at
    positions `pos` (scalar or (b,)), writing slot `t` (scalar, or (b,)
    with block_tables: the paged pool).  cache: per block {"k", "v"}
    (+ "k_scale"/"v_scale" for the int8 KV layout), updated in place.
    kv_mask: None, (view,) or (b, view).  Returns (cache, logits (b,
    vocab) f32).  The paged per-row form attends through
    ops.paged_attention; the contiguous form keeps the reference's
    einsum math.  with_head=False skips the last LayerNorm and the vocab
    head and returns (cache, None): the KV-write-only pass that ends a
    draft chain."""
    embed = qparams["embed"]
    dim = embed.shape[1]
    d_head = dim // heads
    dev = embed.device
    quant_kv = "k_scale" in cache[0]
    page = cache[0]["k"].shape[1]
    bt = None
    if block_tables is not None:
        bt = block_tables
        view_len = bt.shape[1] * page
        flat = _paged_flat_idx(bt, t, page)
    else:
        view_len = page  # contiguous: dim 1 is max_seq
        where = (_row_slots(t, view_len)
                 # analysis: disable=host-sync -- t is a Python int here: the engine seams pass per-row slots as a 1-d tensor (the other branch), and only generate_prefill_quant's loop passes its host-side slot
                 if torch.is_tensor(t) and t.ndim == 1 else int(t))
    table = qparams["pos_emb"]  # clamped, as the reference's gather is
    pe = table[_as(pos, torch.int64, dev).clamp(max=table.shape[0] - 1)]
    if pe.ndim == 1:
        pe = pe[None]
    x = (embed[tok.long()] + pe).to(torch.bfloat16)  # (b, dim)
    b = x.shape[0]
    slots = torch.arange(view_len, device=dev)
    if torch.is_tensor(t) and t.ndim == 1:
        visible = slots[None, :] <= t[:, None]
    else:
        # analysis: disable=host-sync -- t is a Python int here: the engine seams pass per-row slots as a 1-d tensor (the other branch), and only generate_prefill_quant's loop passes its host-side slot
        visible = slots <= int(t)
    if kv_mask is not None:
        visible = visible & kv_mask
    vis = visible[None, None] if visible.ndim == 1 else visible[:, None]
    for blk, c in zip(qparams["blocks"], cache):
        h = _ln(x, blk["ln0"])
        qkv = _qmm(h, blk["qkv"]) + blk["qkv"]["bias"]
        qkv = qkv.reshape(b, 3, heads, d_head).to(x.dtype)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        if quant_kv:
            k_i8, k_s = _quantize_kv(k[:, None])
            v_i8, v_s = _quantize_kv(v[:, None])
            pairs = (("k", k_i8), ("k_scale", k_s), ("v", v_i8),
                     ("v_scale", v_s))
        else:
            pairs = (("k", k[:, None]), ("v", v[:, None]))
        for name, new in pairs:
            if bt is None:
                _cache_write(c[name], new, where)
            else:
                _paged_write(c[name], new, flat)
        if bt is not None:
            attn = paged_attention(
                q.contiguous(), c["k"], c["v"], bt, visible,
                k_scale=c.get("k_scale"), v_scale=c.get("v_scale"),
            )
        else:
            rk, rv = c["k"], c["v"]
            rk_s, rv_s = c.get("k_scale"), c.get("v_scale")
            qf = q.float() / (d_head ** 0.5)
            if quant_kv:
                scores = (
                    torch.einsum("bhd,bkhd->bkh", qf, rk.float()) * rk_s
                ).permute(0, 2, 1)
                rvf = rv.float() * rv_s[..., None]
            else:
                scores = torch.einsum("bhd,bkhd->bhk", qf, rk.float())
                rvf = rv.float()
            scores = torch.where(vis, scores, -1e30)
            p = torch.softmax(scores, dim=-1)
            attn = torch.einsum("bhk,bkhd->bhd", p, rvf)
        attn = attn.reshape(b, dim).to(x.dtype)
        x = x + (_qmm(attn, blk["proj"]) + blk["proj"]["bias"]).to(x.dtype)
        h2 = _ln(x, blk["ln1"])
        m = gelu_tanh(
            (_qmm(h2, blk["fc0"]) + blk["fc0"]["bias"]).to(x.dtype)
        )
        x = x + (_qmm(m, blk["fc1"]) + blk["fc1"]["bias"]).to(x.dtype)
    if not with_head:
        return cache, None
    xf = _ln(x, qparams["ln_f"])
    logits = _qmm(xf.float(), qparams["head"]) + qparams["head"]["bias"]
    return cache, logits


@torch.no_grad()
def generate_prefill_quant(
    model: TransformerLM,
    prompt,
    prompt_len,
    max_new: int,
    temperature,
    generator: torch.Generator,
    qparams=None,
    quant_kv: bool = True,
    top_k=None,
    top_p=None,
    deq=None,
):
    """The int8 oracle: generate_prefill's bucketing, with the prompt
    prefilled through the dequantized model, tok0 from the QUANT head,
    and every later token through quant_decode_step.  Quantizes `model`
    when `qparams` is not given, and dequantizes `qparams` when `deq`
    (dequantize_decode_params' model of the same tree) is not given:
    a caller that decodes many batches builds both once.  Returns
    (b, max_new) int32."""
    if not model.decode:
        raise ValueError("generate_prefill_quant needs a decode=True model")
    dev = model.device
    prompt = _as(prompt, torch.int64, dev)
    b, p_max = prompt.shape
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    if p_max + max_new > model.max_seq:
        raise ValueError(
            f"prompt bucket ({p_max}) + max_new ({max_new}) exceeds the "
            f"model's max_seq ({model.max_seq})"
        )
    plen = _as(prompt_len, torch.int64, dev)
    temperature = _as(temperature, torch.float32, dev)
    per_row = plen.ndim == 1
    if qparams is None:
        qparams = quantize_decode_params(model)
    if deq is None:
        deq = dequantize_decode_params(qparams, model)
    slots = torch.arange(model.max_seq, device=dev)
    if per_row:
        kv_mask = (slots[None, :] < plen[:, None]) | (slots[None, :] >= p_max)
    else:
        kv_mask = (slots < plen) | (slots >= p_max)
    cache = init_decode_cache(deq, b, device=dev)
    hidden, _, _ = deq(
        prompt, positions=torch.arange(p_max, device=dev), cache=cache,
        kv_mask=kv_mask, write_pos=0, head_impl="chunked",
    )
    hidden_row = hidden[torch.arange(b, device=dev), (plen - 1).expand(b)]
    logits0 = _qmm(hidden_row, qparams["head"]) + qparams["head"]["bias"]
    tok = _sample(logits0, temperature, generator, top_k, top_p)
    qcache = quantize_kv_cache(cache) if quant_kv else cache
    toks = [tok]
    for k in range(max_new - 1):
        _, logits = quant_decode_step(
            qparams, qcache, tok, plen + k, p_max + k, kv_mask, model.heads
        )
        tok = _sample(logits, temperature, generator, top_k, top_p)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def _quant_layout(model, shape, quant_kv, device):
    dev = resolve_device(device)
    if quant_kv:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1], device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v_scale": torch.zeros(shape[:-1], device=dev),
        }
    return {
        "k": torch.zeros(shape, dtype=model.dtype, device=dev),
        "v": torch.zeros(shape, dtype=model.dtype, device=dev),
    }


def init_quant_decode_cache(model: TransformerLM, n_slots: int,
                            quant_kv: bool = True, device="cuda"):
    """Zero contiguous quant-layout KV buffers (n_slots, max_seq, heads,
    d_head) per block on `device` (+ scales when quant_kv)."""
    shape = (n_slots, model.max_seq, model.heads, model.dim // model.heads)
    return [
        _quant_layout(model, shape, quant_kv, device)
        for _ in range(model.depth)
    ]


def init_quant_paged_cache(model: TransformerLM, n_pages: int,
                           page_size: int, quant_kv: bool = True,
                           device="cuda"):
    """Zero PAGED quant-layout KV pools (n_pages, page_size, heads,
    d_head) per block on `device` (+ per-slot scale pools when
    quant_kv).  Page 0 is the reserved null page."""
    if n_pages < 2 or page_size < 1:
        raise ValueError(
            f"paged cache needs n_pages >= 2 (page 0 is the null page) "
            f"and page_size >= 1, got {n_pages}/{page_size}"
        )
    shape = (n_pages, page_size, model.heads, model.dim // model.heads)
    return [
        _quant_layout(model, shape, quant_kv, device)
        for _ in range(model.depth)
    ]


def quant_paged_preload_scratch(  # hot-path
    cache, scratch, block_table, upto: int
):
    """Gather a row's matched prefix pages from the quant pool,
    DEQUANTIZE them, and write positions [0, upto) of the float scratch
    the resumed prefill chunks run against (in place).  Returns the
    scratch."""
    dev = cache[0]["k"].device
    bt = _as(block_table, torch.int64, dev)
    for c, scr in zip(cache, scratch):
        for name in ("k", "v"):
            pool = c[name][bt]  # (P, page, h, d)
            if f"{name}_scale" in c:
                pool = pool.float() * c[f"{name}_scale"][bt][..., None]
            view = pool.reshape((1, -1) + tuple(pool.shape[2:]))
            scr[name][:, :upto] = view[:, :upto].to(scr[name].dtype)
    return scratch


@torch.no_grad()
def quant_paged_prefill_finish(  # hot-path
    deq_model: TransformerLM,
    qparams,
    cache,
    scratch,
    chunk,
    block_table,
    start: int,
    write_from: int,
    prompt_len: int,
    temperature,
    generator: torch.Generator,
    top_k=None,
    top_p=None,
):
    """paged_prefill_finish for the int8 engine: the final chunk runs
    through the dequantized model on the scratch, tok0 samples through
    the QUANT head, and the scratch's KV (quantized when the pool is
    int8) scatters into the row's pages from `write_from` on.  Returns
    (cache, tok0 (1,) int32)."""
    chunk = _as(chunk, torch.int64, deq_model.device)
    if chunk.shape[0] != 1:
        raise ValueError(
            f"quant_paged_prefill_finish admits one request at a time, "
            f"got batch {chunk.shape[0]}"
        )
    c = chunk.shape[1]
    hidden, _, _ = deq_model(
        chunk, positions=start + torch.arange(c, device=deq_model.device),
        cache=scratch, write_pos=start, head_impl="chunked",
    )
    hidden_row = hidden[:, prompt_len - 1 - start]
    logits0 = _qmm(hidden_row, qparams["head"]) + qparams["head"]["bias"]
    tok0 = _sample(logits0, temperature, generator, top_k, top_p)
    fresh = quantize_kv_cache(scratch) if "k_scale" in cache[0] else scratch
    paged_scatter_row(cache, fresh, block_table, write_from)
    return cache, tok0


@torch.no_grad()
def quant_paged_engine_decode_step(  # hot-path
    qparams,
    cache,
    tok,
    pos,
    active,
    block_tables,
    temperature,
    generator: torch.Generator,
    heads: int,
    top_k=None,
    top_p=None,
):
    """paged_decode_step for the int8 engine (same in-step position
    clamp and block-table zeroing for inactive rows).  Returns (cache,
    next_tok (B,) int32)."""
    pos = torch.where(active, pos, 0)
    bt = torch.where(active[:, None], block_tables, 0)
    cache, logits = quant_decode_step(
        qparams, cache, tok, pos, pos, None, heads, block_tables=bt
    )
    nxt = _sample(logits, temperature, generator, top_k, top_p)
    return cache, nxt


@torch.no_grad()
def quant_paged_engine_decode_steps(  # hot-path
    qparams,
    cache,
    tok,
    pos,
    active,
    block_tables,
    temperature,
    generator: torch.Generator,
    heads: int,
    n_steps: int,
    top_k=None,
    top_p=None,
):
    """generate.paged_decode_steps for the int8 engine: `n_steps`
    chained quant_paged_engine_decode_step calls, each step's token and
    `pos + 1` feeding the next (greedy tokens equal n_steps separate
    calls; the caller truncates at commit).  Returns (cache, toks (B,
    n_steps) int32)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    cols = []
    for _ in range(n_steps):
        cache, tok = quant_paged_engine_decode_step(
            qparams, cache, tok, pos, active, block_tables, temperature,
            generator, heads, top_k, top_p,
        )
        cols.append(tok)
        pos = pos + 1
    return cache, torch.stack(cols, dim=1)


@torch.no_grad()
def quant_prefill_finish_into_slot(  # hot-path
    deq_model: TransformerLM,
    qparams,
    cache,
    scratch,
    chunk,
    row_idx: int,
    start: int,
    prompt_len: int,
    temperature,
    generator: torch.Generator,
    top_k=None,
    top_p=None,
):
    """generate.prefill_finish_into_slot for the int8 engine: the final
    chunk runs through the dequantized model on the scratch, tok0
    samples through the QUANT head, and the scratch's KV (quantized when
    the cache is int8) is written over engine-cache row `row_idx`.
    Returns (cache, tok0 (1,) int32)."""
    chunk = _as(chunk, torch.int64, deq_model.device)
    if chunk.shape[0] != 1:
        raise ValueError(
            f"quant_prefill_finish_into_slot admits one request at a "
            f"time, got batch {chunk.shape[0]}"
        )
    c = chunk.shape[1]
    hidden, _, _ = deq_model(
        chunk, positions=start + torch.arange(c, device=deq_model.device),
        cache=scratch, write_pos=start, head_impl="chunked",
    )
    hidden_row = hidden[:, prompt_len - 1 - start]
    logits0 = _qmm(hidden_row, qparams["head"]) + qparams["head"]["bias"]
    tok0 = _sample(logits0, temperature, generator, top_k, top_p)
    fresh = quantize_kv_cache(scratch) if "k_scale" in cache[0] else scratch
    write_slot_row(cache, fresh, row_idx)
    return cache, tok0


@torch.no_grad()
def quant_engine_decode_step(  # hot-path
    qparams,
    cache,
    tok,
    pos,
    active,
    temperature,
    generator: torch.Generator,
    heads: int,
    top_k=None,
    top_p=None,
):
    """generate.decode_step for the int8 engine: every active row
    advances one token through quant_decode_step with per-row slots
    (slot == position); inactive rows clamp to position 0.  Returns
    (cache, next_tok (B,) int32)."""
    pos = torch.where(active, pos, 0)
    cache, logits = quant_decode_step(
        qparams, cache, tok, pos, pos, None, heads
    )
    nxt = _sample(logits, temperature, generator, top_k, top_p)
    return cache, nxt


@torch.no_grad()
def quant_verify_step(  # hot-path
    qparams,
    cache,
    toks,
    pos,
    active,
    temperature,
    generator: torch.Generator,
    heads: int,
    block_tables=None,
    top_k=None,
    top_p=None,
    greedy: bool = False,
):
    """generate.verify_step for the int8 engine: a speculative window
    toks (B, s) (column 0 the last committed token, the rest the
    drafter's proposals) in one batched pass through the quantized
    decoder, its B * s rows through each int8 matmul at once.  All s k/v
    rows write up-front: per-row contiguous slots [pos, pos + s) (clipped
    to the last slot), or (page, offset) pairs through `block_tables`
    (inactive rows' tables zeroed: the null page).  Query j sees slots
    <= pos + j only, so each position's logits are what
    quant_decode_step gives after committing the window's first j
    tokens.  Attention runs the reference's einsum math over the
    (dequantized) view.  Returns (cache, out (B, s) int32)."""
    embed = qparams["embed"]
    dim = embed.shape[1]
    d_head = dim // heads
    dev = embed.device
    b, s = toks.shape
    pos = torch.where(active, pos, 0).long()
    page = cache[0]["k"].shape[1]
    slot = pos[:, None] + torch.arange(s, device=dev)  # (b, s)
    if block_tables is not None:
        bt = torch.where(active[:, None], block_tables, 0).long()
        view_len = bt.shape[1] * page
        page_i = torch.clamp(slot // page, 0, bt.shape[1] - 1)
        flat = torch.where(slot < view_len,
                           bt.gather(1, page_i) * page + slot % page, 0)
    else:
        bt = None
        view_len = page  # contiguous: dim 1 is max_seq
        rows = torch.arange(b, device=dev)[:, None]
        cols = torch.clamp(slot, 0, view_len - 1)

    def write(buf, val):
        if bt is None:
            buf[rows, cols] = val.to(buf.dtype)
        else:
            buf.view((-1,) + tuple(buf.shape[2:]))[flat] = val.to(buf.dtype)

    def view(buf):
        if bt is None:
            return buf
        return buf[bt.reshape(-1)].reshape(
            (b, view_len) + tuple(buf.shape[2:]))

    table = qparams["pos_emb"]  # clamped, as the reference's gather is
    pe = table[slot.clamp(max=table.shape[0] - 1)]
    x = (embed[toks.long()] + pe).to(torch.bfloat16).reshape(b * s, dim)
    slots = torch.arange(view_len, device=dev)
    vis = (slots[None, None, :] <= slot[:, :, None])[:, None]  # (b,1,s,v)
    quant_kv = "k_scale" in cache[0]
    for blk, c in zip(qparams["blocks"], cache):
        h = _ln(x, blk["ln0"])
        qkv = _qmm(h, blk["qkv"]) + blk["qkv"]["bias"]
        qkv = qkv.reshape(b, s, 3, heads, d_head).to(x.dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qf = q.float() / (d_head ** 0.5)
        if quant_kv:
            k_i8, k_s = _quantize_kv(k)
            v_i8, v_s = _quantize_kv(v)
            for name, new in (("k", k_i8), ("k_scale", k_s), ("v", v_i8),
                              ("v_scale", v_s)):
                write(c[name], new)
            scores = (
                torch.einsum("bqhd,bkhd->bqkh", qf, view(c["k"]).float())
                * view(c["k_scale"])[:, None]
            ).permute(0, 3, 1, 2)  # (b, h, q, k)
            rvf = view(c["v"]).float() * view(c["v_scale"])[..., None]
        else:
            write(c["k"], k)
            write(c["v"], v)
            scores = torch.einsum("bqhd,bkhd->bhqk", qf,
                                  view(c["k"]).float())
            rvf = view(c["v"]).float()
        p = torch.softmax(torch.where(vis, scores, -1e30), dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", p, rvf)
        attn = attn.reshape(b * s, dim).to(x.dtype)
        x = x + (_qmm(attn, blk["proj"]) + blk["proj"]["bias"]).to(x.dtype)
        h2 = _ln(x, blk["ln1"])
        m = gelu_tanh(
            (_qmm(h2, blk["fc0"]) + blk["fc0"]["bias"]).to(x.dtype)
        )
        x = x + (_qmm(m, blk["fc1"]) + blk["fc1"]["bias"]).to(x.dtype)
    xf = _ln(x, qparams["ln_f"])
    logits = _qmm(xf.float(), qparams["head"]) + qparams["head"]["bias"]
    return cache, _verify_sample(logits.reshape(b, s, -1), temperature,
                                 generator, top_k, top_p, greedy)


@torch.no_grad()
def draft_chain(qparams, cache, tok, pos, active, heads: int,  # hot-path
                n_steps: int):
    """The speculative engine's draft phase: n_steps greedy passes of the
    int8 drafter (quant_decode_step) against its own contiguous cache
    (init_quant_decode_cache), unrolled.  From each row's last committed
    token `tok` (B,) at base position `pos` (B,), pass j writes its
    input's KV at slot pos + j and proposes the next token.  The chain
    runs one pass past the last proposal the verify window reads: that
    pass closes the hole a fully accepted window would leave at its bonus
    token's slot, and is KV-write-only (with_head=False).  Inactive rows
    clamp to position 0 (their drafter rows are refilled at their next
    admission).  Nothing syncs with the host, so the chain can be
    captured into one CUDA graph.  Returns (cache, proposals (B,
    n_steps - 1) int32)."""
    if n_steps < 2:
        raise ValueError(f"n_steps must be >= 2, got {n_steps}")
    pos = torch.where(active, pos, 0)
    cur = tok
    cols = []
    for j in range(n_steps):
        last = j == n_steps - 1
        _, logits = quant_decode_step(
            qparams, cache, cur, pos + j, pos + j, None, heads,
            with_head=not last,
        )
        if not last:
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            cols.append(cur)
    return cache, torch.stack(cols, dim=1)


@torch.no_grad()
def draft_fill_row(draft_cache, cache, row_idx: int, upto: int,  # hot-path
                   block_table=None):
    """Fill ONE row of the drafter's contiguous int8 KV cache from the
    target engine's cache after an admission (and when the drafter's
    frontier lags): the drafter gets the prompt's KV without a second
    prefill.  The source is read only.  It may be any target layout: the
    float cache (contiguous rows, or the paged pool when `block_table`,
    the row's (pages_per_row,) table, is given) is quantized on the way
    in; the int8 layout copies values and scales as they are.  Positions
    from `upto` on are zeroed (invisible to the drafter either way).
    Returns `draft_cache`, updated in place."""
    dev = draft_cache[0]["k"].device
    bt = None if block_table is None else _as(block_table, torch.int64, dev)
    for dblk, c in zip(draft_cache, cache):
        max_seq = dblk["k"].shape[1]

        def row(buf):
            if bt is None:
                return buf[row_idx]
            return buf[bt].reshape(
                (bt.shape[0] * buf.shape[1],) + tuple(buf.shape[2:])
            )[:max_seq]

        if "k_scale" in c:
            leaves = {name: row(c[name]) for name in dblk}
        else:
            leaves = {}
            for name in ("k", "v"):
                leaves[name], leaves[f"{name}_scale"] = _quantize_kv(
                    row(c[name]))
        keep = torch.arange(max_seq, device=dev) < upto
        for name, val in leaves.items():
            mask = keep.view((-1,) + (1,) * (val.ndim - 1))
            dblk[name][row_idx] = torch.where(
                mask, val.to(dblk[name].dtype), 0)
    return draft_cache
