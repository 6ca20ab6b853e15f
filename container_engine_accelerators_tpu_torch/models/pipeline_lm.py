"""Pipeline-parallel transformer LM: the port of
container_engine_accelerators_tpu/models/pipeline_lm.py (`StageStack`
:43, `build_lm_training_pp` :70, `sequential_reference_loss` :226).

The decoder blocks split into S * V chunks of depth / (S * V) layers;
rank d holds chunks (virtual stages c * S + d, c < V) and their AdamW
moments, the embedding and the head (a constant-size fringe) are
replicated, and microbatches march through parallel/pipeline.py's
interleaved schedule.  Attention is resolve_attn's choice (flash on the
card), each rank running it on whole microbatches.  The loss is taken
from the outputs psum'd over the axis, so every rank holds it.  The
chunks are the one-rank TransformerLM's blocks in depth order, so a seed
gives build_lm_training's weights, and a checkpoint is that trainer's.
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from ..ops.losses import cross_entropy_loss
from ..parallel import layout as LY
from ..parallel.mesh import axis_len, world_groups
from ..parallel.pipeline import (
    bubble_fraction,
    chunk_shard_order,
    pipeline_apply,
)
from .transformer import (
    DecoderBlock,
    TransformerLM,
    _adamw,
    _random_batch_fn,
    full_causal_attention,
    resolve_attn,
)


def stage_apply(chunk, x):
    """A chunk (StageStack): its decoder blocks in order."""
    for blk in chunk:
        x = blk(x)
    return x


class PipelineLM(TransformerLM):
    """The embedding and head of a TransformerLM, and `chunks`: this
    rank's n_virtual ModuleLists of layers_per_stage DecoderBlocks,
    chunk c at shard slot `slots[c]` = d * V + c (virtual stage
    c * S + d)."""

    def __init__(self, n_stages, stage_index, n_virtual, layers_per_stage,
                 vocab=1024, dim=256, heads=4, max_seq=512,
                 dtype=torch.bfloat16, device="cuda", param_dtype=None,
                 attn_fn=full_causal_attention):
        super().__init__(vocab=vocab, dim=dim, depth=0, heads=heads,
                         max_seq=max_seq, dtype=dtype, device=device,
                         param_dtype=param_dtype, attn_fn=attn_fn)
        self.n_stages, self.n_virtual = n_stages, n_virtual
        self.layers_per_stage = layers_per_stage
        self.depth = n_stages * n_virtual * layers_per_stage
        self.slots = [stage_index * n_virtual + c for c in range(n_virtual)]
        order = chunk_shard_order(n_stages, n_virtual)
        self.virtual_stages = [order[s] for s in self.slots]
        self.chunks = nn.ModuleList(
            nn.ModuleList(
                DecoderBlock(dim, heads, dtype, self.device,
                             param_dtype=param_dtype, attn_fn=attn_fn)
                for _ in range(layers_per_stage))
            for _ in range(n_virtual))
        self.requires_grad_(False)

    def canon_name(self, name: str) -> str:
        """The one-rank TransformerLM's name of a parameter."""
        if not name.startswith("chunks."):
            return name
        _, c, layer, rest = name.split(".", 3)
        j = self.virtual_stages[int(c)] * self.layers_per_stage + int(layer)
        return f"blocks.{j}.{rest}"

    def load_dense(self, dense_sd) -> "PipelineLM":
        """Copy a one-rank TransformerLM's state dict in (this rank's
        layers of it)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(dense_sd[self.canon_name(name)])
        return self


def build_lm_training_pp(
    mesh,
    pp_axis: str,
    n_micro: int,
    vocab: int = 1024,
    dim: int = 256,
    depth: int = 8,
    heads: int = 4,
    seq_len: int = 512,
    batch: int = 8,
    learning_rate: float = 1e-3,
    seed: int = 0,
    attn_impl: str = "auto",
    n_virtual: int = 1,
    *,
    dtype=torch.bfloat16,
    device="cuda",
    params=None,
):
    """(step_fn, state, batch_fn, info) for pipeline-parallel LM
    training over `pp_axis` of `mesh`.  depth must split into S *
    n_virtual chunks and batch into n_micro microbatches; n_virtual > 1
    (the interleaved schedule) needs n_micro >= S.  params: the
    reference's pipeline tree (numpy leaves, {"embed", "stages",
    "head"}) to start from; else the seeded draw of build_lm_training.
    step_fn(state, tokens, targets) -> (state, loss) on the global batch,
    as build_lm_training's; info: the bubble fraction and the in-flight
    activation ticks."""
    n_stages = axis_len(mesh, pp_axis)
    n_chunks = n_stages * n_virtual
    if depth % n_chunks:
        raise ValueError(
            f"depth {depth} must split evenly over {n_stages} stages * "
            f"{n_virtual} virtual chunks")
    if batch % n_micro:
        raise ValueError(f"batch {batch} must split into {n_micro} microbatches")
    if n_virtual > 1 and n_micro < n_stages:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) >= "
            f"n_stages ({n_stages})")
    dev = resolve_device(device)
    group = mesh.get_group(pp_axis)
    d = mesh.get_local_rank(pp_axis)
    lps, mb = depth // n_chunks, batch // n_micro
    model = PipelineLM(
        n_stages, d, n_virtual, lps, vocab=vocab, dim=dim, heads=heads,
        max_seq=seq_len, dtype=dtype, device=dev, param_dtype=torch.float32,
        attn_fn=resolve_attn(attn_impl, seq_len, device=dev))
    if params is None:
        dense = TransformerLM(vocab=vocab, dim=dim, depth=depth, heads=heads,
                              max_seq=seq_len, dtype=torch.float32,
                              device="cpu", param_dtype=torch.float32)
        dense.init_random(torch.Generator().manual_seed(seed))
        model.load_dense(dense.state_dict())
        del dense
    else:
        from .convert import load_flax_pipeline

        load_flax_pipeline(model, params)
    model.requires_grad_(True)
    opt = _adamw(model, learning_rate)
    groups = world_groups(mesh)
    others = [mesh.get_group(a) for a in mesh.mesh_dim_names if a != pp_axis]
    placements, grad_groups = {}, {}
    for name, p in model.named_parameters():
        placements[name] = LY.whole(model.canon_name(name), tuple(p.shape))
        grad_groups[name] = others if name.startswith("chunks.") else groups
    canon = [n for n, _ in TransformerLM(
        vocab=vocab, dim=dim, depth=depth, heads=heads, max_seq=seq_len,
        device="meta").named_parameters()]
    state = {"model": model, "opt": opt, "step": 0, "mesh": mesh,
             "layout": LY.Layout(placements, grad_groups, canon)}

    def loss_on(tokens, targets):
        from ..parallel import _collectives as C

        emb = model.apply_embed(tokens)
        micro = emb.reshape(n_micro, mb, seq_len, dim)
        outs = C.psum(pipeline_apply(stage_apply, list(model.chunks), micro,
                                     group, n_virtual=n_virtual), group)
        x = model.ln_f(outs.reshape(batch, seq_len, dim))
        logits = torch.matmul(x.float(), model.head_kernel) + model.head_bias
        return cross_entropy_loss(logits.reshape(-1, vocab),
                                  targets.reshape(-1)), None

    def step_fn(state, tokens, targets):
        loss, _ = LY.step_on_mesh(state, lambda: loss_on(tokens, targets))
        return state, loss

    info = {
        "n_stages": n_stages, "n_micro": n_micro, "n_virtual": n_virtual,
        "layers_per_stage": lps,
        "bubble_fraction": bubble_fraction(n_stages, n_micro, n_virtual),
        # One microbatch activation a tick a rank is kept for the
        # backward: V * M + S - 1 ticks.
        "activation_ticks": n_virtual * n_micro + n_stages - 1,
    }
    return step_fn, state, _random_batch_fn(vocab, batch, seq_len, dev), info


def sequential_reference_loss(state, tokens, targets, attn_impl="auto",
                              n_virtual=1):
    """The non-pipelined loss of the same parameters: the chunks in
    depth order on the whole batch, as one TransformerLM.  Every rank
    calls it and gets the loss.  n_virtual is the reference's argument
    (the port's layout knows its chunks' depths)."""
    import torch.distributed as dist

    model = state["model"]
    full = LY.gather_state(state)
    box = [full]
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast_object_list(box, src=0)
    dense = TransformerLM(
        vocab=model.vocab, dim=model.dim, depth=model.depth,
        heads=model.heads, max_seq=model.max_seq, dtype=model.dtype,
        device=model.device, param_dtype=torch.float32,
        attn_fn=resolve_attn(attn_impl, tokens.shape[1], device=model.device))
    dense.load_state_dict(box[0]["model"])
    with torch.no_grad():
        logits = dense(tokens)
        return cross_entropy_loss(logits.reshape(-1, model.vocab),
                                  targets.reshape(-1))
