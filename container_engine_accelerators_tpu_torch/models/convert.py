"""Carry weights across: the reference's flax TransformerLM param tree
(nested dicts of numpy-convertible arrays) into the port's modules, and
back; and a flax ResNet's or Inception-v3's params and batch_stats
trees (`load_flax_vision`, `to_flax_vision`, `to_flax_vision_grads`; the
ResNet names are the same functions), named leaf by leaf
by models/resnet.py's or models/inception.py's `flax_leaves`, for
either ResNet block_impl.

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
            p = params[f"block_{i}"]
            for mine, theirs in _LN.items():
                _put(getattr(blk, mine).scale, p[theirs]["scale"])
                _put(getattr(blk, mine).bias, p[theirs]["bias"])
            for mine, theirs in _DENSE.items():
                _put(getattr(blk, mine).kernel, p[theirs]["kernel"])
                _put(getattr(blk, mine).bias, p[theirs]["bias"])
        _put(model.ln_f.scale, params["LayerNorm_0"]["scale"])
        _put(model.ln_f.bias, params["LayerNorm_0"]["bias"])
        _put(model.head_kernel, params["lm_head"]["kernel"])
        _put(model.head_bias, params["lm_head"]["bias"])
    return model


def to_flax_params(model):
    """The inverse of load_flax_params: a flax-shaped tree of f32 numpy
    arrays (qkv restored to its DenseGeneral shapes)."""
    return _flax_tree(model, lambda p: p)


def to_flax_grads(model):
    """The parameters' gradients (`.grad`, after a backward) as a flax
    tree of f32 numpy arrays, laid out as to_flax_params."""
    return _flax_tree(model, lambda p: p.grad)


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
    dim, heads = model.dim, model.heads
    d_head = dim // heads

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
        p = {}
        for mine, theirs in _LN.items():
            ln = getattr(blk, mine)
            p[theirs] = {"scale": np32(ln.scale), "bias": np32(ln.bias)}
        for mine, theirs in _DENSE.items():
            dense = getattr(blk, mine)
            p[theirs] = {
                "kernel": np32(dense.kernel), "bias": np32(dense.bias),
            }
        p["qkv"]["kernel"] = p["qkv"]["kernel"].reshape(
            dim, 3, heads, d_head
        )
        p["qkv"]["bias"] = p["qkv"]["bias"].reshape(3, heads, d_head)
        out[f"block_{i}"] = p
    return out
