"""Mixture-of-experts transformer LM: the port of
container_engine_accelerators_tpu/models/moe_lm.py (`MoEDecoderBlock`
:40, `MoETransformerLM` :87, `build_moe_lm_training` :135).

Every `moe_every`-th decoder block swaps its MLP for the routed expert
FFN (parallel/moe.py), its experts split over the `ep` mesh axis (this
rank holds experts_total / ep of them, and their AdamW moments), tokens
travelling over that axis by all_to_all; attention stays data parallel
over the batch, flash on each rank's shard.  Where flax sows each MoE
layer's aux loss and drop fraction, the port's forward returns them per
layer beside the logits.  Parameter names follow the reference's tree:
the blocks' router, w_in and w_out beside the attention sublayer's
(models/convert.py `load_flax_moe` carries a flax tree across).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from ..ops.losses import cross_entropy_loss
from ..parallel.moe import moe_ffn_forward
from .transformer import (
    Dense,
    DecoderBlock,
    LayerNorm,
    TransformerLM,
    _adamw,
    _random_batch_fn,
    full_causal_attention,
    resolve_attn,
)


class MoEDecoderBlock(DecoderBlock):
    """DecoderBlock whose MLP is the expert-parallel routed FFN: router
    (dim, experts) replicated, w_in (experts_local, dim, hidden) and
    w_out (experts_local, hidden, dim) this rank's experts, from
    `expert_start`.  After each forward `sown` holds (aux, drop_frac).
    `trace` (a dict) records the layer's routing (parallel/moe.py
    moe_ffn_forward)."""

    def __init__(self, dim, heads, dtype, device, n_experts, expert_hidden,
                 group, ep_size, expert_start, capacity_factor=1.25,
                 top_k=2, n_reroute=2, param_dtype=None,
                 attn_fn=full_causal_attention):
        nn.Module.__init__(self)
        if n_experts <= 0 or n_experts % ep_size:
            raise ValueError(
                f"MoEDecoderBlock needs n_experts ({n_experts}) that "
                f"divide over {ep_size} ranks")
        self.dim, self.heads, self.attn_fn = dim, heads, attn_fn
        self.group = group
        self.capacity_factor, self.top_k = capacity_factor, top_k
        self.n_reroute = n_reroute
        self.n_experts, self.expert_start = n_experts, expert_start
        e_local = n_experts // ep_size
        self.ln0 = LayerNorm(dim, dtype, device)
        self.qkv = Dense(dim, 3 * dim, dtype, device, param_dtype)
        self.proj = Dense(dim, dim, dtype, device, param_dtype)
        self.ln1 = LayerNorm(dim, dtype, device)
        self.router = nn.Parameter(torch.zeros((dim, n_experts), device=device))
        self.w_in = nn.Parameter(
            torch.zeros((e_local, dim, expert_hidden), device=device))
        self.w_out = nn.Parameter(
            torch.zeros((e_local, expert_hidden, dim), device=device))
        self.sown = self.trace = None

    def ffn(self, h):
        b, s, d = h.shape
        out, aux, drop = moe_ffn_forward(
            h.reshape(b * s, d), self.router, self.w_in, self.w_out,
            self.group, capacity_factor=self.capacity_factor,
            top_k=self.top_k, n_reroute=self.n_reroute, trace=self.trace)
        self.sown = (aux, drop)
        return out.reshape(b, s, d).to(h.dtype)


class MoETransformerLM(TransformerLM):
    """Decoder-only LM with routed FFNs every `moe_every` blocks.
    forward(tokens) -> (logits, {"aux_loss": [...], "drop_frac": [...]}),
    one entry per MoE layer.  The embedding and the final LayerNorm
    compute in `fringe_dtype` (bf16, the reference's default for them).  group: the expert axis (None builds the
    one-rank layout, e.g. on the meta device); ep_index / ep_size: this
    rank's place on it."""

    def __init__(self, group=None, ep_index=0, ep_size=1, vocab=1024,
                 dim=256, depth=4, heads=4, n_experts=8, expert_hidden=0,
                 moe_every=2, max_seq=512, dtype=torch.bfloat16,
                 device="cuda", param_dtype=None,
                 attn_fn=full_causal_attention, capacity_factor=1.25,
                 top_k=2, n_reroute=2, fringe_dtype=torch.bfloat16):
        object.__setattr__(self, "_moe", dict(
            group=group, ep_size=ep_size, n_experts=n_experts,
            expert_start=ep_index * (n_experts // max(1, ep_size)),
            expert_hidden=expert_hidden or 4 * dim, moe_every=moe_every,
            capacity_factor=capacity_factor, top_k=top_k,
            n_reroute=n_reroute))
        super().__init__(vocab=vocab, dim=dim, depth=depth, heads=heads,
                         max_seq=max_seq, dtype=dtype, device=device,
                         param_dtype=param_dtype, attn_fn=attn_fn)
        self.n_experts, self.moe_every = n_experts, moe_every
        # The reference builds its EmbedIn and HeadOut at their default
        # bf16 whatever the blocks' dtype: the embedding and the final
        # LayerNorm round to bf16 there.
        self.embed_dtype = fringe_dtype
        self.ln_f = LayerNorm(dim, fringe_dtype, self.device)
        self.requires_grad_(False)

    def _block(self, i, dim, heads, dtype, dev, param_dtype, attn_fn):
        m = self._moe
        if (i + 1) % m["moe_every"]:
            return DecoderBlock(dim, heads, dtype, dev,
                                param_dtype=param_dtype, attn_fn=attn_fn)
        return MoEDecoderBlock(
            dim, heads, dtype, dev, m["n_experts"], m["expert_hidden"],
            m["group"], m["ep_size"], m["expert_start"],
            capacity_factor=m["capacity_factor"], top_k=m["top_k"],
            n_reroute=m["n_reroute"], param_dtype=param_dtype,
            attn_fn=attn_fn)

    def moe_blocks(self):
        return [b for b in self.blocks if isinstance(b, MoEDecoderBlock)]

    def init_random(self, generator: torch.Generator, scale: float = 1.0):
        """TransformerLM's draw, then each MoE block's router N(0, 0.02^2)
        and experts N(0, 1 / fan_in) drawn whole and cut to this rank's,
        so a seed gives the same model at every world size."""
        super().init_random(generator, scale)
        with torch.no_grad():
            for blk in self.moe_blocks():
                blk.router.copy_(torch.randn(blk.router.shape,
                                             generator=generator) * 0.02)
                for w in (blk.w_in, blk.w_out):
                    shape = (self.n_experts,) + tuple(w.shape[1:])
                    full = torch.randn(shape, generator=generator) * (
                        scale / math.sqrt(shape[1]))
                    w.copy_(full[blk.expert_start:
                                 blk.expert_start + w.shape[0]])
        return self

    def forward(self, tokens, positions=None):
        x = self.apply_embed(tokens, positions)
        metrics = {"aux_loss": [], "drop_frac": []}
        for blk in self.blocks:
            x = blk(x)
            if isinstance(blk, MoEDecoderBlock):
                metrics["aux_loss"].append(blk.sown[0])
                metrics["drop_frac"].append(blk.sown[1])
        x = self.ln_f(x)
        return torch.matmul(x.float(), self.head_kernel) + self.head_bias, (
            metrics)


def build_moe_lm_training(
    mesh,
    ep_axis: str,
    vocab: int = 1024,
    dim: int = 256,
    depth: int = 4,
    heads: int = 4,
    n_experts: int = 8,
    moe_every: int = 2,
    seq_len: int = 512,
    batch: int = 8,
    learning_rate: float = 1e-3,
    aux_weight: float = 0.01,
    capacity_factor: float = 1.25,
    top_k: int = 2,
    seed: int = 0,
    attn_impl: str = "auto",
    *,
    n_reroute: int = 2,
    fringe_dtype=torch.bfloat16,
    dtype=torch.bfloat16,
    device="cuda",
    params=None,
):
    """(step_fn, state, batch_fn) for MoE-LM training over `ep_axis` of
    `mesh` (this process one of its ranks).  step_fn(state, tokens,
    targets) takes the global batch (this rank trains its rows) and
    returns (state, (loss, aux_mean, drop_mean)), each the global value:
    the loss is the cross entropy plus aux_weight times the layers' mean
    aux loss.  batch_fn and state as build_lm_training's (state["model"]
    a MoETransformerLM).  params: the reference's flax tree (numpy
    leaves, every expert) to start from instead of the seeded draw.
    fringe_dtype: the embedding's and final LayerNorm's compute type
    (MoETransformerLM)."""
    from ..parallel import layout as LY
    from ..parallel.mesh import Sharding, axis_len, world_groups

    n_dev = axis_len(mesh, ep_axis)
    if batch % n_dev:
        raise ValueError(
            f"batch {batch} must divide the {n_dev}-way expert axis "
            "(tokens shard over it)")
    if n_experts % n_dev:
        raise ValueError(
            f"n_experts {n_experts} must divide over {n_dev} devices")
    if depth // moe_every < 1:
        raise ValueError(
            f"depth {depth} with moe_every {moe_every} yields zero MoE "
            "blocks; use build_lm_training for a dense LM")
    dev = resolve_device(device)
    group = mesh.get_group(ep_axis)
    e = mesh.get_local_rank(ep_axis)
    kw = dict(vocab=vocab, dim=dim, depth=depth, heads=heads,
              n_experts=n_experts, moe_every=moe_every, max_seq=seq_len,
              capacity_factor=capacity_factor, top_k=top_k,
              n_reroute=n_reroute, fringe_dtype=fringe_dtype)
    model = MoETransformerLM(
        group, e, n_dev, dtype=dtype, device=dev, param_dtype=torch.float32,
        attn_fn=resolve_attn(attn_impl, seq_len, device=dev), **kw)
    if params is None:
        model.init_random(torch.Generator().manual_seed(seed))
    else:
        from .convert import load_flax_moe

        load_flax_moe(model, params)
    model.requires_grad_(True)
    opt = _adamw(model, learning_rate)

    groups = world_groups(mesh)
    others = [mesh.get_group(a) for a in mesh.mesh_dim_names if a != ep_axis]
    placements, grad_groups = {}, {}
    for name, p in model.named_parameters():
        if name.endswith((".w_in", ".w_out")):
            shape = (n_experts,) + tuple(p.shape[1:])
            placements[name] = LY.split_placement(name, shape, 0, e, n_dev)
            grad_groups[name] = others
        else:
            placements[name] = LY.whole(name, tuple(p.shape))
            grad_groups[name] = groups
    canon = [n for n, _ in MoETransformerLM(device="meta", **kw)
             .named_parameters()]
    state = {"model": model, "opt": opt, "step": 0, "mesh": mesh,
             "layout": LY.Layout(placements, grad_groups, canon)}
    take = Sharding(mesh, (ep_axis,))

    def loss_on(tokens, targets):
        logits, metrics = model(tokens)
        xent = cross_entropy_loss(logits.reshape(-1, vocab),
                                  targets.reshape(-1))
        aux = torch.stack(metrics["aux_loss"]).mean()
        drop = torch.stack(metrics["drop_frac"]).mean()
        return xent + aux_weight * aux, (aux.detach(), drop)

    def step_fn(state, tokens, targets):
        loss, (aux, drop) = LY.step_on_mesh(state, lambda: loss_on(
            take.shard(tokens), take.shard(targets)))
        return state, (loss, aux, drop)

    return step_fn, state, _random_batch_fn(vocab, batch, seq_len, dev)
