"""Random Moonlight-16B-A3B weights of one card's share (the moonlight
configurations), drawn from the seed on the device in float32, one
tensor a leaf, named as the program's parameters and the reference's
leaves (reference/moonlight.py).  The program and the reference are both
handed these tensors (the reference draws them again after the window,
from the same seed).

Layout: matrices (in, out); a SwiGLU's w13 = [gate | up]; the held
experts stacked on a leading axis.  Draws: matrices N(0, 1 / fan_in)
(the router's fan-in is the hidden size), RMSNorm weights
1 + N(0, 0.1^2), the token table N(0, 1).
"""

from __future__ import annotations

import math

import torch


def shapes(cfg):
    """{leaf: (shape, kind)} in drawing order; kind "norm", "embed" or
    "matrix" (fan-in the shape's second-to-last size)."""
    D, H, V = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["vocab_size"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    r, F, Fe = cfg["kv_lora_rank"], cfg["intermediate_size"], \
        cfg["moe_intermediate_size"]
    Fs, held = cfg["n_shared_experts"] * Fe, cfg["n_routed_experts"]
    out = {"embed": ((V, D), "embed")}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({
            p + "attn_norm": ((D,), "norm"),
            p + "attn.wq": ((D, H * (dn + dr)), "matrix"),
            p + "attn.wkva": ((D, r + dr), "matrix"),
            p + "attn.kv_norm": ((r,), "norm"),
            p + "attn.wkvb": ((r, H * (dn + dv)), "matrix"),
            p + "attn.wo": ((H * dv, D), "matrix"),
            p + "ffn_norm": ((D,), "norm"),
        })
        if i >= cfg["first_k_dense_replace"] and (
                i % cfg["moe_layer_freq"] == 0):
            out.update({
                p + "moe.router": ((D, cfg["experts_total"]), "matrix"),
                p + "moe.w13": ((held, D, 2 * Fe), "matrix"),
                p + "moe.w2": ((held, Fe, D), "matrix"),
                p + "moe.shared.w13": ((D, 2 * Fs), "matrix"),
                p + "moe.shared.w2": ((Fs, D), "matrix"),
            })
        else:
            out.update({p + "mlp.w13": ((D, 2 * F), "matrix"),
                        p + "mlp.w2": ((F, D), "matrix")})
    out.update({"final_norm": ((D,), "norm"), "head": ((D, V), "matrix")})
    return out


def make(cfg, seed, device):
    """{leaf: float32 tensor} on `device`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    W = {}
    for name, (shape, kind) in shapes(cfg).items():
        x = torch.randn(shape, generator=gen, device=dev)
        if kind == "norm":
            x = 1.0 + 0.1 * x
        elif kind == "matrix":
            x *= 1.0 / math.sqrt(shape[-2])
        W[name] = x
    return W
