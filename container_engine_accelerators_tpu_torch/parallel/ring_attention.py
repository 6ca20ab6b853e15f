"""Ring attention: sequence parallelism over one mesh axis, the port of
container_engine_accelerators_tpu/parallel/ring_attention.py
(`_rotate_kv` :57, `_merge` :66, `ring_attention` :87,
`zigzag_permutation` :151, `ring_attention_zigzag` :175,
`ring_attention_sharded` :276).

Each rank holds a shard of the sequence; the KV shards travel round the
ring by ppermute (parallel/_collectives.py: paired isend / irecv, the
reverse permutation in the backward) while each rank merges its queries'
softmax online, so no rank holds the whole score matrix.  The math is
torch ops, as the reference's is jnp: no Pallas kernel there either.
The contiguous layout masks by global position and skips the last
rotation; the zigzag layout gives rank i the global chunks
(i, 2 * ring - 1 - i) and computes only the visible chunk pairs, a
branch on the block's source rank.  Every rank runs the same sequence
of collectives, so the backward's exchanges pair up.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _collectives as C

NEG_INF = -1e30


def _rotate_kv(k_blk, v_blk, group):
    """One ring hop: the KV block to the next rank."""
    return C.ppermute([k_blk, v_blk], group, 1)


def _merge(m, l, o, scores, v_blk):
    """One online-softmax step.  m, l (b, h, sq); o (b, h, sq, d);
    scores (b, h, sq, skv); v_blk (b, skv, h, d)."""
    blk_max = scores.max(-1).values
    new_m = torch.maximum(m, blk_max)
    # A fully masked row: exp(NEG_INF - NEG_INF) must not be 1.
    safe_m = torch.where(new_m <= NEG_INF, 0.0, new_m)
    correction = torch.exp(torch.where(m <= NEG_INF, NEG_INF, m - safe_m))
    p = torch.exp(scores - safe_m[..., None])
    new_l = l * correction + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
    return new_m, new_l, o * correction[..., None] + pv


def ring_attention(q, k, v, group, causal: bool = False,
                   scale: Optional[float] = None):
    """Blockwise ring attention for this rank's contiguous shard: q, k,
    v (batch, seq_shard, heads, head_dim); returns the local output,
    equal to full (optionally causal) attention over the global
    sequence."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    ring, me = C.axis_size(group), C.axis_index(group)
    dev = q.device
    qt = (q.float() * scale).transpose(1, 2)  # (b, h, sq, d)
    q_pos = me * sq + torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), NEG_INF, device=dev)
    l = torch.zeros((b, h, sq), device=dev)
    o = torch.zeros((b, h, sq, d), device=dev)
    k_blk, v_blk = k, v
    for step in range(ring):
        src = (me - step) % ring
        scores = torch.einsum("bhqd,bkhd->bhqk", qt, k_blk.float())
        if causal:
            kv_pos = src * sq + torch.arange(sq, device=dev)
            mask = q_pos[:, None] >= kv_pos[None, :]
            scores = torch.where(mask, scores, NEG_INF)
        m, l, o = _merge(m, l, o, scores, v_blk.float())
        if step < ring - 1:  # the last rotation would be discarded
            k_blk, v_blk = _rotate_kv(k_blk, v_blk, group)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def zigzag_permutation(seq_len: int, ring: int) -> np.ndarray:
    """Storage order -> global position for the zigzag layout: x[perm]
    split evenly over `ring` ranks gives rank i the global chunks (i,
    2 * ring - 1 - i), early chunk first."""
    if seq_len % (2 * ring):
        raise ValueError(
            f"zigzag layout needs seq_len divisible by 2*ring "
            f"({seq_len} vs 2*{ring})"
        )
    c = seq_len // (2 * ring)
    chunks = []
    for i in range(ring):
        chunks.append(np.arange(i * c, (i + 1) * c))
        a1 = 2 * ring - 1 - i
        chunks.append(np.arange(a1 * c, (a1 + 1) * c))
    return np.concatenate(chunks)


def ring_attention_zigzag(q, k, v, group, scale: Optional[float] = None):
    """Causal ring attention over zigzag shards (this rank's shard holds
    global chunks (i, 2 * ring - 1 - i), in that order); computes only
    the visible chunk pairs:
      step 0 (local KV): qe@ke and ql@kl triangular, ql@ke full;
      step s > 0: ql@ke full, then qe@ke if the block's source rank is
      below this one, else ql@kl."""
    b, sq, h, d = q.shape
    if sq % 2:
        raise ValueError("zigzag shard length must be even (two chunks)")
    c = sq // 2
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    ring, me = C.axis_size(group), C.axis_index(group)
    dev = q.device
    qf = (q.float() * scale).reshape(b, 2, c, h, d)
    qe, ql = qf[:, 0].transpose(1, 2), qf[:, 1].transpose(1, 2)

    def block_scores(qc, kc):
        return torch.einsum("bhqd,bkhd->bhqk", qc, kc.float())

    tri = torch.arange(c, device=dev)[:, None] >= torch.arange(c, device=dev)
    neg = torch.where(tri, 0.0, NEG_INF)

    def split(blk):
        return blk[:, :c], blk[:, c:]

    ke0, kl0 = split(k)
    ve0, vl0 = (t.float() for t in split(v))
    z = torch.zeros((b, h, c), device=dev)
    zo = torch.zeros((b, h, c, d), device=dev)
    nf = torch.full((b, h, c), NEG_INF, device=dev)
    me_, le, oe = _merge(nf, z, zo, block_scores(qe, ke0) + neg, ve0)
    ml, ll, ol = _merge(nf, z, zo, block_scores(ql, kl0) + neg, vl0)
    ml, ll, ol = _merge(ml, ll, ol, block_scores(ql, ke0), ve0)
    k_blk, v_blk = k, v
    for step in range(1, ring):
        k_blk, v_blk = _rotate_kv(k_blk, v_blk, group)
        src = (me - step) % ring
        ke, kl = split(k_blk)
        ve, vl = (t.float() for t in split(v_blk))
        ml, ll, ol = _merge(ml, ll, ol, block_scores(ql, ke), ve)
        if src < me:
            me_, le, oe = _merge(me_, le, oe, block_scores(qe, ke), ve)
        else:
            ml, ll, ol = _merge(ml, ll, ol, block_scores(ql, kl), vl)
    out_e = oe / torch.clamp(le, min=1e-30)[..., None]
    out_l = ol / torch.clamp(ll, min=1e-30)[..., None]
    out = torch.stack([out_e, out_l], 1)  # (b, 2, h, c, d)
    return out.permute(0, 1, 3, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name: str,
                           causal: bool = False, layout: str = "contiguous"):
    """Ring attention over `axis_name` of `mesh` from global (batch,
    seq, heads, dim) tensors split on seq; returns the global output on
    every rank.  layout "zigzag" takes inputs already in zigzag storage
    order and must be causal."""
    from .mesh import Sharding

    if layout == "zigzag":
        if not causal:
            raise ValueError("zigzag layout is causal-only")
    elif layout != "contiguous":
        raise ValueError(f"unknown ring attention layout {layout!r}")
    sh = Sharding(mesh, (axis_name,), dim=1)
    group = mesh.get_group(axis_name)
    ql, kl, vl = (sh.shard(t) for t in (q, k, v))
    if layout == "zigzag":
        out = ring_attention_zigzag(ql, kl, vl, group)
    else:
        out = ring_attention(ql, kl, vl, group, causal=causal)
    return sh.unshard(out)
