"""Random GPT-2 weights drawn from the seed on the device, in a few large
calls, in the types they are served or trained in.  The program and the
reference are both handed these tensors (the reference draws them again
after the window, from the same seed).

Layout: matrices (in, out); per-layer leaves stacked on a leading layer
axis (reference.gpt2.STACKED).  Draws: projection matrices N(0, 1/fan_in),
biases N(0, 0.1^2), LayerNorm scales 1 + N(0, 0.1^2) and biases
N(0, 0.1^2), the token table N(0, 1), the positional table N(0, 0.02^2).
"""

from __future__ import annotations

import math

import torch


def make(model, seed, device, block_dtype):
    """{leaf: tensor} on `device`: the per-layer projections and their
    biases in `block_dtype`, everything else float32."""
    d, n_layer = model["n_embd"], model["n_layer"]
    v, p, f = model["vocab_size"], model["n_positions"], 4 * model["n_embd"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def draw(shape, std, dtype=torch.float32, mean=0.0):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * std + mean).to(dtype)

    bd = block_dtype
    return {
        "wte": draw((v, d), 1.0),
        "wpe": draw((p, d), 0.02),
        "ln0_g": draw((n_layer, d), 0.1, mean=1.0),
        "ln0_b": draw((n_layer, d), 0.1),
        "qkv_w": draw((n_layer, d, 3 * d), 1 / math.sqrt(d), bd),
        "qkv_b": draw((n_layer, 3 * d), 0.1, bd),
        "proj_w": draw((n_layer, d, d), 1 / math.sqrt(d), bd),
        "proj_b": draw((n_layer, d), 0.1, bd),
        "ln1_g": draw((n_layer, d), 0.1, mean=1.0),
        "ln1_b": draw((n_layer, d), 0.1),
        "fc_w": draw((n_layer, d, f), 1 / math.sqrt(d), bd),
        "fc_b": draw((n_layer, f), 0.1, bd),
        "out_w": draw((n_layer, f, d), 1 / math.sqrt(f), bd),
        "out_b": draw((n_layer, d), 0.1, bd),
        "lnf_g": draw((d,), 0.1, mean=1.0),
        "lnf_b": draw((d,), 0.1),
        "head_w": draw((d, v), 1 / math.sqrt(d)),
        "head_b": draw((v,), 0.1),
    }
