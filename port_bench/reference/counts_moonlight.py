"""Operations of the moonlight configurations' training step, counted
from shapes at the true dimensions (q . k over qk_nope + qk_rope, p . v
over v_head_dim, however a kernel pads them), a multiply-add as two.
The card's peak is reference/counts.py's.

Per token of one forward: each layer's MLA projections (W_q, W_kva,
W_kvb, W_o), the dense layer's SwiGLU (three matrices of the hidden size
by intermediate_size), each MoE layer's router and shared SwiGLU, the
head over the vocabulary slice; each route to a held expert its SwiGLU
(three matrices of hidden by moe_intermediate_size).  Causal attention
of one sequence of s: s (s + 1) / 2 (query, key) pairs a head.
"""

from __future__ import annotations


def _moe(cfg, i):
    return i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] \
        == 0


def token_flops(cfg):
    """One token's forward outside the routed experts and attention's
    products."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    r = cfg["kv_lora_rank"]
    mla = D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D
    total = 0
    for i in range(cfg["num_hidden_layers"]):
        total += mla
        if _moe(cfg, i):
            total += D * cfg["experts_total"] + 3 * D * (
                cfg["n_shared_experts"] * cfg["moe_intermediate_size"])
        else:
            total += 3 * D * cfg["intermediate_size"]
    return 2 * (total + D * cfg["vocab_size"])


def expert_route_flops(cfg):
    """One route's forward through its held expert's SwiGLU."""
    return 2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def _pairs(batch, heads, seq):
    return batch * heads * seq * (seq + 1) // 2


def mla_fwd_flops(cfg, batch, seq):
    """One layer's causal attention forward: q . k and p . v."""
    H = cfg["num_attention_heads"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2 * _pairs(batch, H, seq) * (dqk + cfg["v_head_dim"])


def mla_bwd_flops(cfg, batch, seq):
    """Its backward: p again (q . k), dV (p . dO), dP (dO . v), dQ and dK
    (dS . k and dS . q)."""
    H = cfg["num_attention_heads"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2 * _pairs(batch, H, seq) * (3 * dqk + 2 * cfg["v_head_dim"])


def train_flops(cfg, steps, batch, seq, held_routes):
    """Model operations of `steps` training steps (forward and backward,
    3 x the forward) of batch x seq tokens in which `held_routes` routes
    reached a held expert."""
    fwd = steps * (batch * seq * token_flops(cfg) + cfg[
        "num_hidden_layers"] * mla_fwd_flops(cfg, batch, seq))
    return 3 * (fwd + held_routes * expert_route_flops(cfg))
