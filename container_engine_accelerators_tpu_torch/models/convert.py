"""Carry weights across: the reference's flax TransformerLM param tree
(nested dicts of numpy-convertible arrays) into the port's modules, and
back; and a flax ResNet's or Inception-v3's params and batch_stats
trees (`load_flax_vision`, `to_flax_vision`, `to_flax_vision_grads`; the
ResNet names are the same functions), named leaf by leaf
by models/resnet.py's or models/inception.py's `flax_leaves`, for
either ResNet block_impl.

The MoE LM's tree (`load_flax_moe`, `to_flax_moe_grads`:
embed and head subtrees, a MoE block's router, w_in and w_out), the
pipeline LM's (`load_flax_pipeline`, `to_flax_pipeline_grads`: stages
stacked over chunks in shard order) and a rank's tensor-parallel shard
of a tree (`shard_flax_params`) carry the parallel models across too.

Names map as the flax module builds them: Embed_0/embedding -> embed,
pos_emb, block_i/{LayerNorm_0 -> ln0, qkv, proj, LayerNorm_1 -> ln1,
Dense_0 -> fc0, Dense_1 -> fc1}, LayerNorm_0 -> ln_f, lm_head ->
head_kernel/head_bias.  Kernels stay (in, out); the qkv DenseGeneral
kernel (dim, 3, heads, d_head) and bias (3, heads, d_head) flatten to
(dim, 3 * dim) and (3 * dim,).  Only numpy crosses the boundary: this
module imports no JAX.  A training model holds f32 master weights, so
both directions are exact there; `to_flax_grads` lays a trained step's
gradients out the same way, so tests compare them leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

_LN = {"ln0": "LayerNorm_0", "ln1": "LayerNorm_1"}
_DENSE = {"qkv": "qkv", "proj": "proj", "fc0": "Dense_0", "fc1": "Dense_1"}


def _put(param, value):
    arr = torch.from_numpy(np.asarray(value, np.float32).copy())
    if tuple(arr.shape) != tuple(param.shape):
        arr = arr.reshape(param.shape)
    param.copy_(arr.to(param.dtype))


def load_flax_params(model, params):
    """Copy a flax param tree into `model` (a port TransformerLM) in
    place; returns the model.  Raises KeyError on a foreign tree."""
    n_blocks = len([k for k in params if k.startswith("block_")])
    if n_blocks != model.depth:
        raise ValueError(
            f"param tree has {n_blocks} blocks, model depth {model.depth}"
        )
    with torch.no_grad():
        _put(model.embed, params["Embed_0"]["embedding"])
        _put(model.pos_emb, params["pos_emb"])
        for i, blk in enumerate(model.blocks):
            _load_block(blk, params[f"block_{i}"])
        _put(model.ln_f.scale, params["LayerNorm_0"]["scale"])
        _put(model.ln_f.bias, params["LayerNorm_0"]["bias"])
        _put(model.head_kernel, params["lm_head"]["kernel"])
        _put(model.head_bias, params["lm_head"]["bias"])
    return model


def _load_block(blk, p):
    """One decoder block's flax subtree into `blk`: the LayerNorms and
    whichever projections it has, and a MoE block's router and this
    rank's experts (rows expert_start.. of the tree's w_in / w_out)."""
    for mine, theirs in _LN.items():
        _put(getattr(blk, mine).scale, p[theirs]["scale"])
        _put(getattr(blk, mine).bias, p[theirs]["bias"])
    for mine, theirs in _DENSE.items():
        if hasattr(blk, mine):
            _put(getattr(blk, mine).kernel, p[theirs]["kernel"])
            _put(getattr(blk, mine).bias, p[theirs]["bias"])
    if hasattr(blk, "router"):
        _put(blk.router, p["router"])
        for name in ("w_in", "w_out"):
            w = getattr(blk, name)
            _put(w, np.asarray(p[name])[blk.expert_start:
                                        blk.expert_start + w.shape[0]])


def _flax_block(blk, np32, dim, heads, d_head):
    p = {}
    for mine, theirs in _LN.items():
        ln = getattr(blk, mine)
        p[theirs] = {"scale": np32(ln.scale), "bias": np32(ln.bias)}
    for mine, theirs in _DENSE.items():
        if hasattr(blk, mine):
            dense = getattr(blk, mine)
            p[theirs] = {"kernel": np32(dense.kernel),
                         "bias": np32(dense.bias)}
    if hasattr(blk, "router"):
        for name in ("router", "w_in", "w_out"):
            p[name] = np32(getattr(blk, name))
    p["qkv"]["kernel"] = p["qkv"]["kernel"].reshape(dim, 3, heads, d_head)
    p["qkv"]["bias"] = p["qkv"]["bias"].reshape(3, heads, d_head)
    return p


def load_flax_moe(model, params):
    """A reference MoETransformerLM tree ({"embed", "block_i", "head"},
    every expert) into a port MoETransformerLM, which keeps its own
    rank's experts; returns the model."""
    flat = {"Embed_0": params["embed"]["Embed_0"],
            "pos_emb": params["embed"]["pos_emb"],
            "LayerNorm_0": params["head"]["LayerNorm_0"],
            "lm_head": params["head"]["lm_head"]}
    flat.update({k: v for k, v in params.items() if k.startswith("block_")})
    return load_flax_params(model, flat)


def _nest_moe(tree):
    out = {"embed": {"Embed_0": tree.pop("Embed_0"),
                     "pos_emb": tree.pop("pos_emb")},
           "head": {"LayerNorm_0": tree.pop("LayerNorm_0"),
                    "lm_head": tree.pop("lm_head")}}
    out.update(tree)
    return out


def to_flax_moe_grads(model):
    """A port MoETransformerLM's gradients as the reference's tree (this
    rank's experts only)."""
    return _nest_moe(_flax_tree(model, lambda p: p.grad))


def load_flax_pipeline(model, params):
    """A reference pipeline LM tree ({"embed", "stages", "head"}, the
    stages' leaves stacked over every chunk in shard order) into a port
    PipelineLM (models/pipeline_lm.py), which keeps the chunks of its
    own shard slots; returns the model."""
    with torch.no_grad():
        _put(model.embed, params["embed"]["Embed_0"]["embedding"])
        _put(model.pos_emb, params["embed"]["pos_emb"])
        for slot, chunk in zip(model.slots, model.chunks):
            for j, blk in enumerate(chunk):
                tree = params["stages"][f"layer_{j}"]
                _load_block(blk, _index_tree(tree, slot))
        head = params["head"]
        _put(model.ln_f.scale, head["LayerNorm_0"]["scale"])
        _put(model.ln_f.bias, head["LayerNorm_0"]["bias"])
        _put(model.head_kernel, head["lm_head"]["kernel"])
        _put(model.head_bias, head["lm_head"]["bias"])
    return model


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def to_flax_pipeline_grads(model):
    """A port PipelineLM's gradients as the reference's tree, the stages
    stacked over this rank's chunks (its shard slots, in order)."""
    def np32(p):
        return p.grad.detach().float().cpu().numpy()

    d_head = model.dim // model.heads
    chunks = [[_flax_block(blk, np32, model.dim, model.heads, d_head)
               for blk in chunk] for chunk in model.chunks]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    return {
        "embed": {"Embed_0": {"embedding": np32(model.embed)},
                  "pos_emb": np32(model.pos_emb)},
        "stages": {f"layer_{j}": stack(*(c[j] for c in chunks))
                   for j in range(len(chunks[0]))},
        "head": {"LayerNorm_0": {"scale": np32(model.ln_f.scale),
                                 "bias": np32(model.ln_f.bias)},
                 "lm_head": {"kernel": np32(model.head_kernel),
                             "bias": np32(model.head_bias)}},
    }


def to_flax_params(model):
    """The inverse of load_flax_params: a flax-shaped tree of f32 numpy
    arrays (qkv restored to its DenseGeneral shapes)."""
    return _flax_tree(model, lambda p: p)


def to_flax_grads(model):
    """The parameters' gradients (`.grad`, after a backward) as a flax
    tree of f32 numpy arrays, laid out as to_flax_params."""
    return _flax_tree(model, lambda p: p.grad)


def shard_flax_params(tree, specs, index: int, count: int):
    """This rank's shard of a flax tree (numpy leaves): each leaf whose
    spec (a tree of the same shape, models/transformer.py
    `lm_tp_param_specs`) names a dim is cut along it into `count` equal
    pieces, of which the rank keeps piece `index`; a leaf with None is
    kept whole."""
    if isinstance(tree, dict):
        return {k: shard_flax_params(v, specs[k], index, count)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if specs is None:
        return arr
    if arr.shape[specs] % count:
        raise ValueError(f"dim {specs} of {arr.shape} does not split "
                         f"into {count}")
    return np.split(arr, count, axis=specs)[index]


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _vision_leaves(model):
    from . import inception, resnet

    if isinstance(model, inception.InceptionV3):
        return inception.flax_leaves(model)
    return resnet.flax_leaves(model)


def load_flax_vision(model, params, batch_stats):
    """Copy a flax ResNet's or Inception-v3's `params` and `batch_stats`
    trees (numpy leaves) into `model` (a port ResNet, models/resnet.py,
    or InceptionV3, models/inception.py) in place; returns the model.
    Conv kernels go from flax's HWIO to torch's OIHW.  Raises KeyError
    on a tree of another configuration."""
    trees = {"params": params, "batch_stats": batch_stats}
    with torch.no_grad():
        for coll, path, t, layout in _vision_leaves(model):
            value = np.asarray(_get(trees[coll], path), np.float32)
            if layout == "oihw":
                value = value.transpose(3, 2, 0, 1)
            _put(t, value)
    return model


def _vision_trees(model, leaf):
    trees = {"params": {}, "batch_stats": {}}
    for coll, path, t, layout in _vision_leaves(model):
        value = leaf(coll, t)
        if value is None:
            continue
        value = value.detach().float().cpu().numpy()
        if layout == "oihw":
            value = value.transpose(2, 3, 1, 0)
        _set(trees[coll], path, value)
    return trees


def to_flax_vision(model):
    """The inverse of load_flax_vision: (params, batch_stats), flax-shaped
    trees of f32 numpy arrays."""
    trees = _vision_trees(model, lambda coll, t: t)
    return trees["params"], trees["batch_stats"]


def to_flax_vision_grads(model):
    """The parameters' gradients (`.grad`, after a backward) as a flax
    params tree of f32 numpy arrays, laid out as to_flax_vision's."""
    return _vision_trees(
        model, lambda coll, t: t.grad if coll == "params" else None
    )["params"]


load_flax_resnet = load_flax_vision
to_flax_resnet = to_flax_vision
to_flax_resnet_grads = to_flax_vision_grads


def _flax_tree(model, leaf):
    dim, heads = model.dim, model.qkv_heads
    d_head = dim // model.heads

    def np32(p):
        return leaf(p).detach().float().cpu().numpy()

    out = {
        "Embed_0": {"embedding": np32(model.embed)},
        "pos_emb": np32(model.pos_emb),
        "LayerNorm_0": {
            "scale": np32(model.ln_f.scale),
            "bias": np32(model.ln_f.bias),
        },
        "lm_head": {
            "kernel": np32(model.head_kernel),
            "bias": np32(model.head_bias),
        },
    }
    for i, blk in enumerate(model.blocks):
        out[f"block_{i}"] = _flax_block(blk, np32, dim, heads, d_head)
    return out
