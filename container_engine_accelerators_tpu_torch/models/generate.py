"""LM decode seams in PyTorch: the port of
container_engine_accelerators_tpu/models/generate.py for the paged
and the contiguous serving paths (`make_decoder` :36, `_sample` :122,
`generate_padded` :171, the oracle `generate_prefill` :241,
`init_decode_cache` :356, `prefill_chunk` :446,
`generate_sharded` :1072,
`prefill_finish_into_slot` :491,
`init_paged_cache` :566, `paged_scatter_row` :595,
`paged_preload_scratch` :627, `_pool_leaves` :660, `gather_kv_pages`
:671, `scatter_kv_pages` :683, `paged_prefill_finish` :702,
`paged_decode_step` :757, `paged_decode_steps` :813, `_verify_sample`
:890, `verify_step` :908, `paged_verify_step` :969, `decode_step`
:1026).

Differences of idiom, not of math:
  - parameters live in the model (an nn.Module), so no `params`
    argument travels beside it;
  - caches are lists of per-block dicts updated IN PLACE (the reference
    returns new pytrees; the engine always replaced its reference
    anyway);
  - a `torch.Generator` on the model's device replaces the jax.random
    key and advances in place, so seams return tokens, not keys.  The
    two generators give different numbers: sampled rows are held to
    the same keep mask, greedy rows to equal tokens;
  - offsets that the reference traces (chunk start, preload length)
    are host ints here, since PyTorch runs eagerly;
  - the reference's lax.scan over k chained steps is a Python loop of k
    steps; on the card the engine captures that loop into one CUDA
    graph (serving/decode_graph.py), so nothing in a step's body may
    read a device value back to the host;
  - the reference's dp mesh is one SPMD program; here a mesh is a
    parallel.mesh.LocalMesh of local devices, and `generate_sharded`
    runs each shard's rows through `generate_prefill` on its own device.
"""

from __future__ import annotations

import torch

from .._device import canonical_device, resolve_device
from .transformer import TransformerLM


def make_decoder(vocab, dim, depth, heads, max_seq, dtype=torch.bfloat16,
                 device="cuda") -> TransformerLM:
    """The decode-mode twin of a TransformerLM config, on `device`
    (raises without a card unless device="cpu").  Parameters are zeros
    until loaded (convert.load_flax_params) or drawn (init_random)."""
    return TransformerLM(
        vocab=vocab, dim=dim, depth=depth, heads=heads, max_seq=max_seq,
        dtype=dtype, decode=True, device=device,
    )


def _as(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def keep_mask(scaled, top_k=None, top_p=None):
    """(sorted_logits, sorted_idx, keep) of the top-k / top-p rule in
    `_sample`: ranks below top_k, and the nucleus whose cumulative
    probability before the token is below top_p (the best token always
    stays).  top_k / top_p: scalars or per-row (b,)."""
    b, vocab = scaled.shape
    sorted_logits, sorted_idx = torch.sort(
        scaled, dim=-1, descending=True, stable=True
    )
    keep = torch.ones((b, vocab), dtype=torch.bool, device=scaled.device)
    ranks = torch.arange(vocab, device=scaled.device)[None, :]
    if top_k is not None:
        tk = _as(top_k, torch.int64, scaled.device)
        tk = tk[:, None] if tk.ndim == 1 else tk
        keep &= ranks < torch.clamp(tk, min=1)
    if top_p is not None:
        tp = _as(top_p, torch.float32, scaled.device)
        tp = tp[:, None] if tp.ndim == 1 else tp
        probs = torch.softmax(sorted_logits, dim=-1)
        cum_before = torch.cumsum(probs, dim=-1) - probs
        keep &= cum_before < torch.clamp(tp, 1e-6, 1.0)
    return sorted_logits, sorted_idx, keep


def _gumbel_argmax(logits, generator):
    """A categorical draw without a host sync: argmax(logits + Gumbel)
    with the noise from `generator`."""
    e = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(logits - torch.log(e), dim=-1)


def _sample(logits, temperature, generator, top_k=None, top_p=None):  # hot-path
    """Token choice per row: argmax at temperature 0, a categorical draw
    at temperature > 0 (restricted by top_k / top_p when given).
    temperature: scalar or per-row (b,).  Returns (b,) int32."""
    temperature = _as(temperature, torch.float32, logits.device)
    safe_t = torch.clamp(temperature, min=1e-6)
    if safe_t.ndim == 1:
        safe_t = safe_t[:, None]
    scaled = logits / safe_t
    if top_k is None and top_p is None:
        sampled = _gumbel_argmax(scaled, generator)
    else:
        sorted_logits, sorted_idx, keep = keep_mask(scaled, top_k, top_p)
        # analysis: disable=host-sync -- float("-inf") is a literal, not a device value
        masked = torch.where(keep, sorted_logits, float("-inf"))
        pick = _gumbel_argmax(masked, generator)
        sampled = sorted_idx.gather(1, pick[:, None])[:, 0]
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)


@torch.no_grad()
def generate_padded(
    model: TransformerLM,
    prompt,
    prompt_len: int,
    max_new: int,
    temperature,
    generator: torch.Generator,
):
    """The bucket-shaped twin of `generate`: prompt (b, P) holds the
    real prompt in its first `prompt_len` columns (1 <= prompt_len <=
    P).  One token a step over a contiguous cache, slot == position:
    teacher-forced inside the real prompt, sampled after it.
    temperature: scalar.  Returns (b, max_new) int32, the tokens after
    the real prompt; greedy rows equal generate_prefill's."""
    if not model.decode:
        raise ValueError("generate_padded needs a decode=True model")
    dev = model.device
    prompt = _as(prompt, torch.int64, dev)
    b, p_max = prompt.shape
    if p_max < 1:
        raise ValueError("prompt bucket must contain at least one column")
    total = p_max + max_new
    if total > model.max_seq:
        raise ValueError(
            f"prompt bucket ({p_max}) + max_new ({max_new}) exceeds the "
            f"model's max_seq ({model.max_seq})"
        )
    plen = int(prompt_len)
    temperature = _as(temperature, torch.float32, dev)
    cache = init_decode_cache(model, b, device=dev)
    tok = prompt[:, 0]
    toks = []
    # Step t feeds the token at position t; from t = plen - 1 on, its
    # sample is the next generated token.
    for t in range(plen - 1 + max_new):
        logits = model(
            tok[:, None], positions=torch.full((1,), t, device=dev),
            cache=cache, write_pos=t,
        )
        if t + 1 < plen:
            tok = prompt[:, t + 1]
        else:
            tok = _sample(logits[:, 0], temperature, generator).long()
            toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32)


@torch.no_grad()
def generate_prefill(  # hot-path
    model: TransformerLM,
    prompt,
    prompt_len,
    max_new: int,
    temperature,
    generator: torch.Generator,
    top_k=None,
    top_p=None,
):
    """The oracle: prefill the whole prompt bucket in one forward into a
    contiguous cache, then decode `max_new` tokens one step at a time.
    prompt (b, P) int; prompt_len / temperature scalars or per-row (b,).
    The bucket tail [prompt_len, P) stays invisible; generated tokens
    write slots P.. with their true positions prompt_len... Returns
    (b, max_new) int32."""
    if not model.decode:
        raise ValueError("generate_prefill needs a decode=True model")
    dev = model.device
    prompt = _as(prompt, torch.int64, dev)
    b, p_max = prompt.shape
    if p_max < 1:
        raise ValueError("prompt bucket must contain at least one column")
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
    cache = init_decode_cache(model, b, device=dev)
    slots = torch.arange(model.max_seq, device=dev)
    if per_row:
        kv_mask = (slots[None, :] < plen[:, None]) | (slots[None, :] >= p_max)
    else:
        kv_mask = (slots < plen) | (slots >= p_max)
    hidden, head_k, head_b = model(
        prompt, positions=torch.arange(p_max, device=dev), cache=cache,
        kv_mask=kv_mask, write_pos=0, head_impl="chunked",
    )
    rows = (plen - 1).expand(b)
    hidden_row = hidden[torch.arange(b, device=dev), rows]
    tok = _sample(hidden_row @ head_k + head_b, temperature, generator,
                  top_k, top_p)
    toks = [tok]
    for k in range(max_new - 1):
        pos = plen + k
        logits = model(
            tok[:, None], positions=pos[:, None] if per_row else pos[None],
            cache=cache, kv_mask=kv_mask, write_pos=p_max + k,
        )
        tok = _sample(logits[:, 0], temperature, generator, top_k, top_p)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def model_copy(model: TransformerLM, device) -> TransformerLM:
    """A copy of `model` (same config, same weights) on `device`."""
    copy = type(model)(**dict(model.config, device=device))
    copy.load_state_dict(model.state_dict())
    return copy


def models_on(model: TransformerLM, devices) -> dict:
    """{device: model} over the distinct `devices` (canonical, see
    _device.canonical_device): `model` itself on its own device and a
    copy on each other one, so the weights are placed once a device."""
    out = {canonical_device(model.device): model}
    for d in devices:
        d = canonical_device(d)
        if d not in out:
            out[d] = model_copy(model, d)
    return out


def generate_sharded(
    model: TransformerLM,
    prompt,
    max_new: int,
    mesh,
    temperature=0.0,
    seed: int = 0,
    prompt_len=None,
    top_k=None,
    top_p=None,
    models=None,
):
    """Data-parallel batched decode over a LocalMesh: the prompt rows
    split into one contiguous block a shard, each block decodes through
    `generate_prefill` on its shard's device with the model placed there
    (`models`: a `models_on` dict made once by the caller, default made
    here), and the outputs concatenate in row order on the mesh's first
    device.  No step exchanges anything between shards.  prompt_len /
    temperature / top_k / top_p: scalars (broadcast) or per-row (b,)
    vectors, which split with their rows.  Shard s samples from a
    generator seeded `seed + s` on its device (the reference's rng key;
    greedy rows ignore it).  Greedy output equals `generate_prefill` on
    one device.  Requires batch % shards == 0.  Returns (b, max_new)."""
    devs = [canonical_device(d) for d in mesh.devices]
    n_shard = len(devs)
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device="cpu")
    b, p_max = prompt.shape
    if b % n_shard:
        raise ValueError(
            f"sharded decode: batch {b} must divide over {n_shard} "
            f"devices (axes {tuple(mesh.axis_names)})"
        )
    if models is None:
        models = models_on(model, devs)
    per = b // n_shard

    def rows(x, lo, dtype):
        x = torch.as_tensor(x, dtype=dtype)
        return x[lo:lo + per] if x.ndim == 1 else x

    outs = []
    for s, dev in enumerate(devs):
        lo = s * per
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) + s)
        kw = {}
        if top_k is not None:
            kw["top_k"] = rows(top_k, lo, torch.int64)
        if top_p is not None:
            kw["top_p"] = rows(top_p, lo, torch.float32)
        toks = generate_prefill(
            models[dev], prompt[lo:lo + per],
            rows(p_max if prompt_len is None else prompt_len, lo,
                 torch.int64),
            max_new, rows(temperature, lo, torch.float32), gen, **kw,
        )
        outs.append(toks.to(devs[0], non_blocking=True))
    return torch.cat(outs)


def _kv_buffers(model, shape, device):
    dev = resolve_device(device)
    return [
        {
            "k": torch.zeros(shape, dtype=model.dtype, device=dev),
            "v": torch.zeros(shape, dtype=model.dtype, device=dev),
        }
        for _ in range(model.depth)
    ]


def init_decode_cache(model: TransformerLM, n_slots: int, device="cuda"):
    """Zero contiguous KV buffers on `device`: per block {"k", "v"} of
    (n_slots, max_seq, heads, d_head) in the model's dtype."""
    if not model.decode:
        raise ValueError("init_decode_cache needs a decode=True model")
    shape = (n_slots, model.max_seq, model.heads, model.dim // model.heads)
    return _kv_buffers(model, shape, device)


def init_scratch(model: TransformerLM, device="cuda"):
    """A batch-1 contiguous cache for one admission's chunks, as
    init_decode_cache(model, 1) lays it out, held in ONE zeroed buffer:
    returns (buffer, leaves), the leaves views of the buffer, so a
    single `buffer.zero_()` clears every one in place and their
    addresses never change."""
    if not model.decode:
        raise ValueError("init_scratch needs a decode=True model")
    buf = torch.zeros(
        (model.depth, 2, 1, model.max_seq, model.heads,
         model.dim // model.heads),
        dtype=model.dtype, device=resolve_device(device),
    )
    return buf, [{"k": blk[0], "v": blk[1]} for blk in buf]


@torch.no_grad()
def prefill_chunk(model: TransformerLM, scratch, chunk, start: int):  # hot-path
    """One fixed-width chunk (1, C) of a prompt prefilled into the batch-1
    contiguous `scratch` at positions [start, start + C).  Returns the
    scratch (updated in place)."""
    if not model.decode:
        raise ValueError("prefill_chunk needs a decode=True model")
    chunk = _as(chunk, torch.int64, model.device)
    if chunk.shape[0] != 1:
        raise ValueError(
            f"prefill_chunk prefills one request at a time, got batch "
            f"{chunk.shape[0]}"
        )
    c = chunk.shape[1]
    model(
        chunk, positions=start + torch.arange(c, device=model.device),
        cache=scratch, write_pos=start, head_impl="chunked",
    )
    return scratch


@torch.no_grad()
def prefill_finish_into_slot(  # hot-path
    model: TransformerLM,
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
    """The final chunk of an admission into the contiguous engine cache
    (init_decode_cache): run it through the scratch, sample tok0 from
    the last real prompt row, and copy the scratch over row `row_idx`
    WHOLESALE (the slot's previous occupant's KV included; the bucket
    tail stays invisible under slot == position visibility and is
    overwritten by generated tokens).  Returns (cache, tok0 (1,)
    int32)."""
    if not model.decode:
        raise ValueError(
            "prefill_finish_into_slot needs a decode=True model"
        )
    chunk = _as(chunk, torch.int64, model.device)
    if chunk.shape[0] != 1:
        raise ValueError(
            f"prefill_finish_into_slot admits one request at a time, got "
            f"batch {chunk.shape[0]}"
        )
    c = chunk.shape[1]
    hidden, head_k, head_b = model(
        chunk, positions=start + torch.arange(c, device=model.device),
        cache=scratch, write_pos=start, head_impl="chunked",
    )
    hidden_row = hidden[:, prompt_len - 1 - start]
    tok0 = _sample(hidden_row @ head_k + head_b, temperature, generator,
                   top_k, top_p)
    write_slot_row(cache, scratch, row_idx)
    return cache, tok0


def write_slot_row(cache, row, row_idx: int):
    """Copy a batch-1 contiguous cache `row` over row `row_idx` of the
    engine cache, leaf by leaf, in place.  Returns `cache`."""
    for dst_blk, src_blk in zip(cache, row):
        for name, dst in dst_blk.items():
            dst[row_idx] = src_blk[name][0].to(dst.dtype)
    return cache


def init_paged_cache(model: TransformerLM, n_pages: int, page_size: int,
                     device="cuda"):
    """Zero PAGED KV pools on `device`: per block {"k", "v"} of
    (n_pages, page_size, heads, d_head).  Physical page 0 is the
    reserved null page."""
    if not model.decode:
        raise ValueError("init_paged_cache needs a decode=True model")
    if n_pages < 2 or page_size < 1:
        raise ValueError(
            f"paged cache needs n_pages >= 2 (page 0 is the null page) "
            f"and page_size >= 1, got {n_pages}/{page_size}"
        )
    shape = (n_pages, page_size, model.heads, model.dim // model.heads)
    return _kv_buffers(model, shape, device)


def paged_scatter_row(cache, row, block_table, write_from):
    """Scatter one row's contiguous (1, max_seq, ...) scratch into its
    pool pages, in place: position p lands at slot p % page of physical
    page block_table[p // page].  Positions below `write_from` (shared
    prefix pages) and past the mapped view go to the null page 0, so an
    admission never writes a shared page.  write_from: a Python int or
    a 0-dim tensor on the cache's device.  Generic over the leaves
    (bf16 k/v and the int8 twin's value and scale pools), which share
    one map of positions to pool slots.  Returns `cache`."""
    dev = cache[0]["k"].device
    bt = _as(block_table, torch.int64, dev)
    flats = {}  # (page, max_seq) -> the positions' flat pool slots
    for pool_blk, row_blk in zip(cache, row):
        for name, pool in pool_blk.items():
            src = row_blk[name]
            page = pool.shape[1]
            max_seq = src.shape[1]
            flat = flats.get((page, max_seq))
            if flat is None:
                posn = torch.arange(max_seq, device=dev)
                page_i = torch.clamp(posn // page, 0, bt.shape[0] - 1)
                flat = flats[(page, max_seq)] = torch.where(
                    (posn >= write_from) & (posn < bt.shape[0] * page),
                    bt[page_i] * page + posn % page,
                    0,
                )
            pool.view((-1,) + tuple(pool.shape[2:]))[flat] = src[0].to(
                pool.dtype
            )
    return cache


def paged_preload_scratch(cache, scratch, block_table, upto: int):  # hot-path
    """Gather a row's prefix pages from the pool into positions
    [0, upto) of its batch-1 contiguous scratch, in place (the
    prefix-cache admission seam).  Returns the scratch."""
    dev = cache[0]["k"].device
    bt = _as(block_table, torch.int64, dev)
    for pool_blk, scr_blk in zip(cache, scratch):
        for name in ("k", "v"):
            pool, scr = pool_blk[name], scr_blk[name]
            view = pool[bt].reshape(
                (1, bt.shape[0] * pool.shape[1]) + tuple(pool.shape[2:])
            )
            scr[:, :upto] = view[:, :upto]
    return scratch


def _pool_leaves(cache):
    """The page-pool leaves of a paged cache in a fixed order: block by
    block, each block's pools in key order (bf16: k, v; the int8 twin:
    k, k_scale, v, v_scale), every tensor's leading axis the physical
    page axis.  For the int8 twin this is the reference's tree order;
    for the bf16 cache the reference sorts its block names as strings
    (block_0, block_1, block_10, ...), which agrees up to depth 10."""
    return [blk[name] for blk in cache for name in sorted(blk)]


def gather_kv_pages(cache, page_ids):
    """Gather physical pages `page_ids` out of EVERY pool leaf of a
    paged cache (bf16 or int8-twin layout alike) — the device half of
    page EXPORT: one (n, page, ...) tensor a leaf in _pool_leaves order,
    on the cache's device.  The caller copies them to the host (a
    synchronous .cpu(), so no byte is read before the copy lands)."""
    leaves = _pool_leaves(cache)
    ids = _as(page_ids, torch.int64, leaves[0].device)
    return [leaf.index_select(0, ids) for leaf in leaves]


def scatter_kv_pages(cache, page_ids, parts):
    """Write migrated page data `parts` (one tensor a pool leaf, in
    _pool_leaves order — gather_kv_pages' output shape) into the paged
    cache at physical pages `page_ids`, IN PLACE (index_copy_), so every
    pool keeps its address and CUDA graphs captured over the cache stay
    valid — the device half of page ADOPTION.  The caller passes
    exactly the pages it allocated (no null-page padding lanes).
    Returns `cache`."""
    leaves = _pool_leaves(cache)
    if len(parts) != len(leaves):
        raise ValueError(
            f"{len(parts)} page parts for a cache of {len(leaves)} pool "
            f"leaves"
        )
    dev = leaves[0].device
    ids = _as(page_ids, torch.int64, dev)
    for leaf, part in zip(leaves, parts):
        part = part.to(device=dev)
        if part.dtype != leaf.dtype or part.shape[1:] != leaf.shape[1:] \
                or part.shape[0] != ids.shape[0]:
            raise ValueError(
                f"page part {tuple(part.shape)} {part.dtype} does not fit "
                f"{ids.shape[0]} pages of pool {tuple(leaf.shape)} "
                f"{leaf.dtype}"
            )
        leaf.index_copy_(0, ids, part)
    return cache


@torch.no_grad()
def paged_prefill_finish(  # hot-path
    model: TransformerLM,
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
    """The final chunk of an admission: run it through the scratch,
    sample tok0 from the last real prompt row (only that row pays the
    vocab matmul), and scatter the scratch into the row's pool pages
    from `write_from` on.  start / write_from / prompt_len /
    temperature (and top_k / top_p) are Python numbers, or 0-dim
    tensors and block_table a tensor on the model's device, so that
    nothing is read back and the call can be captured into a CUDA graph
    (serving/decode_graph.py); both give the same tokens and pages.
    Returns (cache, tok0 (1,) int32)."""
    if not model.decode:
        raise ValueError("paged_prefill_finish needs a decode=True model")
    chunk = _as(chunk, torch.int64, model.device)
    if chunk.shape[0] != 1:
        raise ValueError(
            f"paged_prefill_finish admits one request at a time, got "
            f"batch {chunk.shape[0]}"
        )
    c = chunk.shape[1]
    hidden, head_k, head_b = model(
        chunk, positions=start + torch.arange(c, device=model.device),
        cache=scratch, write_pos=start, head_impl="chunked",
    )
    # The last real prompt row, picked on the device for numbers and
    # operands alike.
    last = torch.arange(1, device=model.device) + (prompt_len - 1 - start)
    hidden_row = hidden.index_select(1, last)[:, 0]
    tok0 = _sample(hidden_row @ head_k + head_b, temperature, generator,
                   top_k, top_p)
    paged_scatter_row(cache, scratch, block_table, write_from)
    return cache, tok0


@torch.no_grad()
def paged_decode_step(  # hot-path
    model: TransformerLM,
    cache,
    tok,
    pos,
    active,
    block_tables,
    temperature,
    generator: torch.Generator,
    top_k=None,
    top_p=None,
):
    """Advance every active row one token over the paged pool.
    Inactive rows clamp to position 0 AND get a zeroed block-table row
    here, so their clamped write lands in the null page whatever the
    scheduler staged (a stale table would write offset 0 of a prompt
    page the prefix cache may share).  All tensors on the model's
    device; block_tables int32.  Returns (cache, next_tok (B,) int32)."""
    if not model.decode:
        raise ValueError("paged_decode_step needs a decode=True model")
    pos = torch.where(active, pos, 0)
    bt = torch.where(active[:, None], block_tables, 0)
    page = cache[0]["k"].shape[1]
    slots = torch.arange(bt.shape[1] * page, device=pos.device)
    kv_mask = slots[None, :] <= pos[:, None]
    logits = model(
        tok[:, None], positions=pos[:, None], cache=cache,
        kv_mask=kv_mask, write_pos=pos, block_tables=bt,
    )
    nxt = _sample(logits[:, 0], temperature, generator, top_k, top_p)
    return cache, nxt


@torch.no_grad()
def paged_decode_steps(  # hot-path
    model: TransformerLM,
    cache,
    tok,
    pos,
    active,
    block_tables,
    temperature,
    generator: torch.Generator,
    n_steps: int,
    top_k=None,
    top_p=None,
):
    """`n_steps` chained paged_decode_step calls: each step's sampled
    token and `pos + 1` feed the next, and every step's k/v land at the
    row's next (page, offset) through its block table.  Step semantics
    are exactly paged_decode_step's, so greedy tokens equal n_steps
    separate calls.  Every row advances all n_steps; the caller
    truncates at stop / cancel / max_new when it commits.  Nothing here
    syncs with the host, so the chain can be captured into one CUDA
    graph.  Returns (cache, toks (B, n_steps) int32): column j is the
    token at position pos + 1 + j."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if not model.decode:
        raise ValueError("paged_decode_steps needs a decode=True model")
    cols = []
    for _ in range(n_steps):
        cache, tok = paged_decode_step(
            model, cache, tok, pos, active, block_tables, temperature,
            generator, top_k, top_p,
        )
        cols.append(tok)
        pos = pos + 1
    return cache, torch.stack(cols, dim=1)


def _verify_sample(logits, temperature, generator, top_k=None,  # hot-path
                   top_p=None, greedy=False):
    """Per-position token choice over a verify window: logits (b, s,
    vocab) -> (b, s) int32.  Greedy rows take the argmax per position,
    so column j is what the one-token step would have sampled after
    committing the window's first j tokens (the accept rule's parity
    anchor).  Sampled rows draw once per column from `generator` (they
    ride a window at width 1: only column 0 is ever committed).
    greedy=True (every row at temperature 0, no top_k / top_p) takes the
    argmax of the whole window and draws nothing."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.stack(
        [_sample(logits[:, j], temperature, generator, top_k, top_p)
         for j in range(logits.shape[1])],
        dim=1,
    )


def _window_mask(pos, s, view_len):
    """(query positions (B, s), per-query kv_mask (B, s, view_len)): query
    j of row b sits at pos[b] + j and sees slots <= pos[b] + j, the
    committed history plus the window's causal prefix."""
    qpos = pos[:, None] + torch.arange(s, device=pos.device)
    slots = torch.arange(view_len, device=pos.device)
    return qpos, slots[None, None, :] <= qpos[:, :, None]


@torch.no_grad()
def verify_step(  # hot-path
    model: TransformerLM,
    cache,
    toks,
    pos,
    active,
    temperature,
    generator: torch.Generator,
    top_k=None,
    top_p=None,
    greedy: bool = False,
):
    """decode_step widened to a speculative VERIFY window over the
    contiguous engine cache: toks (B, s), column 0 each row's last
    committed token and columns 1.. the drafter's proposals, at base
    positions `pos` (B,).  All s k/v rows are written up-front to slots
    [pos, pos + s) of each row; the engine commits the longest agreeing
    prefix plus the first disagreeing target token and rewinds the rest
    (the rejected slots stay invisible and are rewritten by the next
    window).  Inactive rows clamp to position 0.  Returns (cache, out
    (B, s) int32): out[:, j] is the target's token at position pos + j,
    conditioned on toks[:, :j + 1]."""
    if not model.decode:
        raise ValueError("verify_step needs a decode=True model")
    pos = torch.where(active, pos, 0)
    qpos, kv_mask = _window_mask(pos, toks.shape[1], model.max_seq)
    logits = model(toks, positions=qpos, cache=cache, kv_mask=kv_mask,
                   write_pos=pos)
    return cache, _verify_sample(logits, temperature, generator, top_k,
                                 top_p, greedy)


@torch.no_grad()
def paged_verify_step(  # hot-path
    model: TransformerLM,
    cache,
    toks,
    pos,
    active,
    block_tables,
    temperature,
    generator: torch.Generator,
    top_k=None,
    top_p=None,
    greedy: bool = False,
):
    """verify_step over the PAGED pool: the window's s k/v rows scatter
    through each row's block table up-front (generated positions live in
    the row's private pages, so a speculative write never touches a
    shared prefix page), and a rejected suffix is a position rewind,
    never a page copy.  Inactive rows clamp to position 0 and get a
    zeroed block-table row (their writes land in the null page).
    Returns (cache, out (B, s) int32), as verify_step."""
    if not model.decode:
        raise ValueError("paged_verify_step needs a decode=True model")
    pos = torch.where(active, pos, 0)
    bt = torch.where(active[:, None], block_tables, 0)
    page = cache[0]["k"].shape[1]
    qpos, kv_mask = _window_mask(pos, toks.shape[1], bt.shape[1] * page)
    logits = model(toks, positions=qpos, cache=cache, kv_mask=kv_mask,
                   write_pos=pos, block_tables=bt)
    return cache, _verify_sample(logits, temperature, generator, top_k,
                                 top_p, greedy)


@torch.no_grad()
def decode_step(  # hot-path
    model: TransformerLM,
    cache,
    tok,
    pos,
    active,
    temperature,
    generator: torch.Generator,
    top_k=None,
    top_p=None,
):
    """Advance every active row of the contiguous engine cache by one
    token: row b writes slot pos[b] (slot == position) and sees slots
    <= pos[b].  Inactive rows clamp to position 0 (their sampled token
    is ignored; slot 0 is rewritten by the slot's next admission).
    Returns (cache, next_tok (B,) int32)."""
    if not model.decode:
        raise ValueError("decode_step needs a decode=True model")
    pos = torch.where(active, pos, 0)
    slots = torch.arange(model.max_seq, device=pos.device)
    kv_mask = slots[None, :] <= pos[:, None]
    logits = model(
        tok[:, None], positions=pos[:, None], cache=cache,
        kv_mask=kv_mask, write_pos=pos,
    )
    nxt = _sample(logits[:, 0], temperature, generator, top_k, top_p)
    return cache, nxt
