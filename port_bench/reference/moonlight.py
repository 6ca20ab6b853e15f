"""Plain Moonlight-16B-A3B (the DeepSeek-V3 block) in float32 PyTorch:
the yardstick that decides `correct` for the moonlight cells, and the
reference the port's CPU tests hold its MLA / MoE model against.

Follows the published model (https://huggingface.co/moonshotai/
Moonlight-16B-A3B, `model_type` deepseek_v3; the layer equations of
DeepSeek-V3's own inference code and report, arXiv:2412.19437):
  - RMSNorm x / sqrt(mean(x^2) + eps) * w, eps `rms_norm_eps`;
  - latent attention (MLA) without a q-LoRA: q = x W_q, per head
    [q_nope (qk_nope_head_dim) | q_pe (qk_rope_head_dim)];
    [c_kv (kv_lora_rank) | k_pe] = x W_kva, c_kv through an RMSNorm;
    [k_nope | v] = c_kv W_kvb per head; RoPE (theta `rope_theta`, no
    scaling) on q_pe and k_pe over interleaved pairs (x[2i], x[2i+1])
    at frequency theta^(-2i / qk_rope_head_dim), as DeepSeek-V3's
    `apply_rotary_emb`; k_pe shared by every head; causal softmax of
    q . k / sqrt(qk_nope + qk_rope) times v, then W_o;
  - the first `first_k_dense_replace` layers a SwiGLU of width
    `intermediate_size` (W_13 = [gate | up], silu(gate) * up, W_2);
  - every other layer the MoE FFN: sigmoid scores s = sigmoid(x W_r)
    over `experts_total` experts (`noaux_tc`): the top
    `num_experts_per_tok` of s + b (the correction bias, a state, not a
    weight) chosen, their s normalised (`norm_topk_prob`) and times
    `routed_scaling_factor`; the shared experts one SwiGLU of width
    n_shared_experts x moe_intermediate_size; each chosen expert a
    SwiGLU of width `moe_intermediate_size`;
  - a final RMSNorm and the untied head, no biases anywhere.

Training adds DeepSeek-V3's auxiliary-loss-free balancing: after each
step b_i += gamma * sign(mean load - load_i) over every expert of the
router, the loads counted over the step's routes; and the sequence-wise
balance loss alpha * sum_i f_i P_i a sequence (f_i = E / (K T) times
the routes to expert i in the sequence, P_i the mean over its tokens of
s_i / sum_j s_j), averaged over the sequences and summed over the MoE
layers, added to the mean cross entropy.

Departures from the published model, each one the trained program's
(the configuration file lists them under `reduced` and `assumed`):
  - one expert-parallel rank's share: this card holds `n_routed_experts`
    experts from `expert_start` of each MoE layer's `experts_total`;
    the router scores and picks over all of them, and only the held
    experts' part of the routed sum is computed (the absent cards'
    experts add nothing here, in the program and in this file alike);
  - fewer layers (`num_hidden_layers`) and a vocabulary slice
    (`vocab_size`): the first pipeline stage's share, the head over the
    slice;
  - gamma and alpha are the DeepSeek-V3 report's (the config gives
    none); the optimizer is AdamW (Moonlight was trained with Muon);
  - weights are random, drawn from the seed (port_bench/
    weights_moonlight.py), and the correction bias starts at zero.

Everything is float32 with TF32 off (`strict_fp32`), each expert a loop
of plain matmuls, attention in blocks of query rows over their causal
prefix (the same function, held in less memory), with no kernel, cache
or grouping.  It imports nothing but torch.  `routes`, where given, are
the program's expert choices (one (tokens, K) tensor a MoE layer a
step): the reference then routes as the program did and judges the
expert arithmetic, and counts how many of those routes its own scores
pick too (`route_agree`).

`mm` is the one matmul every projection, the router and the head go
through, so the lower-precision control (`fp8_mm`) replaces it alone.
"""

from __future__ import annotations

import math

import torch

# Rows of queries a block of the reference's attention (memory only).
ATTN_BLOCK = 1024


def strict_fp32():
    """float32 matmuls and convolutions in full precision (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def moe_layers(cfg):
    """Indices of the MoE layers."""
    return [i for i in range(cfg["num_hidden_layers"])
            if i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0]


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """Interleaved-pair rotary embedding of x (..., seq, heads, d)."""
    d = x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    ang = positions.float()[:, None] * freq[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack((a * cos - b * sin, a * sin + b * cos),
                       -1).flatten(-2)


def swiglu(x, w13, w2, mm):
    gate, up = mm(x, w13).chunk(2, -1)
    return mm(torch.nn.functional.silu(gate) * up, w2)


def attention(W, p, cfg, x, mm):
    """MLA of layer prefix `p` on x (b, s, D)."""
    b, s, _ = x.shape
    H = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    pos = torch.arange(s, device=x.device)
    q = mm(x, W[p + "attn.wq"]).view(b, s, H, dn + dr)
    kva = mm(x, W[p + "attn.wkva"])
    c = rms_norm(kva[..., :r], W[p + "attn.kv_norm"], cfg["rms_norm_eps"])
    k_pe = rope(kva[..., None, r:], pos, cfg["rope_theta"])
    kv = mm(c, W[p + "attn.wkvb"]).view(b, s, H, dn + dv)
    q = torch.cat((q[..., :dn], rope(q[..., dn:], pos, cfg["rope_theta"])),
                  -1)
    k = torch.cat((kv[..., :dn], k_pe.expand(b, s, H, dr)), -1)
    v = kv[..., dn:]
    scale = 1.0 / math.sqrt(dn + dr)
    outs = []
    for lo in range(0, s, ATTN_BLOCK):
        hi = min(s, lo + ATTN_BLOCK)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, lo:hi], k[:, :hi]) * scale
        seen = (torch.arange(hi, device=x.device)[None]
                <= torch.arange(lo, hi, device=x.device)[:, None])
        pr = torch.softmax(sc.masked_fill(~seen, float("-inf")), -1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", pr, v[:, :hi]))
    o = torch.cat(outs, 1).reshape(b, s, H * dv)
    return mm(o, W[p + "attn.wo"])


def moe(W, p, cfg, x, bias, forced, mm, tally):
    """The held experts' share of the MoE FFN of layer prefix `p` on x
    (b, s, D), the shared experts added.  Returns (out, balance loss
    averaged over the sequences).  forced: the program's (b * s, K)
    choices or None; tally gets the routes' loads and agreements."""
    b, s, D = x.shape
    E, K = cfg["experts_total"], cfg["num_experts_per_tok"]
    start, held = cfg["expert_start"], cfg["n_routed_experts"]
    h = x.reshape(b * s, D)
    scores = torch.sigmoid(mm(h, W[p + "moe.router"]))
    own = torch.topk(scores.detach() + bias, K, -1).indices
    choice = own if forced is None else forced.long()
    w = scores.gather(1, choice)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    gates = w * cfg["routed_scaling_factor"]
    out = swiglu(h, W[p + "moe.shared.w13"], W[p + "moe.shared.w2"], mm)
    for e in range(held):
        rows, slot = (choice == start + e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(h[rows], W[p + "moe.w13"][e], W[p + "moe.w2"][e], mm)
            out = out.index_add(0, rows, gates[rows, slot, None] * y)
    # Sequence-wise balance loss (DeepSeek-V3 eqs. 17-20).
    picks = torch.zeros(b * s, E, device=x.device).scatter_(1, choice, 1.0)
    f = picks.view(b, s, E).sum(1) * (E / (K * s))
    P = (scores / scores.sum(-1, keepdim=True)).view(b, s, E).mean(1)
    balance = (f * P).sum(-1).mean()
    tally["load"] = tally.get("load", 0) + picks.sum(0)
    tally["agree"] = tally.get("agree", 0) + int(
        (own[:, :, None] == choice[:, None, :]).any(-1).sum())
    tally["routes"] = tally.get("routes", 0) + choice.numel()
    return out.view(b, s, D), balance


def forward(W, cfg, tokens, bias, routes=None, mm=torch.matmul,
            tallies=None):
    """(logits (b, s, V), summed balance loss) of token ids (b, s).
    bias: {layer: (E,) correction bias}; routes: {layer: (b * s, K)
    forced choices} or None; tallies: {layer: dict} filled by moe()."""
    eps = cfg["rms_norm_eps"]
    x = W["embed"][tokens]
    balance = x.new_zeros(())
    tallies = {} if tallies is None else tallies
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        x = x + attention(W, p, cfg, rms_norm(x, W[p + "attn_norm"], eps),
                          mm)
        h = rms_norm(x, W[p + "ffn_norm"], eps)
        if i in bias:
            y, bal = moe(W, p, cfg, h, bias[i],
                         None if routes is None else routes[i], mm,
                         tallies.setdefault(i, {}))
            balance = balance + bal
        else:
            y = swiglu(h, W[p + "mlp.w13"], W[p + "mlp.w2"], mm)
        x = x + y
    x = rms_norm(x, W["final_norm"], eps)
    return mm(x, W["head"]), balance


def _fp8(x, dtype):
    """x rounded to an fp8 format with one scale a tensor (amax to the
    format's largest finite value), returned in float32."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in e4m3 forward, and the incoming
    gradient in e5m2 backward: the precision one step below bf16."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        gb = (qa.reshape(-1, qa.shape[-1]).transpose(0, 1)
              @ qg.reshape(-1, qg.shape[-1]))
        return ga, gb.reshape(qb.shape)


def fp8_mm(a, b):
    return _Fp8Matmul.apply(a, b)


# ---- training: three steps of the loss, the gradient and AdamW ----

EXPERT_LEAVES = ("moe.w13", "moe.w2")


def leaf_norms(T):
    """{name: L2 norm} of a dict of tensors named as the weights: each
    held expert of an expert leaf apart (`<leaf>.e<j>`)."""
    out = {}
    for k, t in T.items():
        t = t.detach().double()
        if k.endswith(EXPERT_LEAVES):
            out.update({f"{k}.e{j}": float(t[j].norm())
                        for j in range(t.shape[0])})
        else:
            out[k] = float(t.norm())
    return out


def adamw_step(W, grads, state, lr, betas, eps, weight_decay):
    """Decoupled AdamW (Loshchilov and Hutter) with bias correction, as
    torch.optim.AdamW steps it: a leaf with no gradient (an expert no
    route chose, in every block) is left as it is, and each leaf counts
    its own steps."""
    b1, b2 = betas
    with torch.no_grad():
        for k, p in W.items():
            g = grads[k]
            if g is None:
                continue
            m, v, n = state.get(k, (torch.zeros_like(p),
                                    torch.zeros_like(p), 0))
            n += 1
            state[k] = (m, v, n)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * weight_decay)
            mhat = m / (1 - b1 ** n)
            vhat = v / (1 - b2 ** n)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))


def update_bias(bias, tallies, cfg, gamma):
    """b_i += gamma * sign(mean load - load_i), in place, a MoE layer."""
    with torch.no_grad():
        for i, b in bias.items():
            load = tallies[i]["load"]
            b.add_(gamma * torch.sign(load.mean() - load))


def loss_and_grads(W, cfg, tokens, targets, bias, alpha, micro,
                   routes=None, mm=torch.matmul):
    """Mean next-token cross entropy of (tokens, targets) (B, S) plus
    alpha times the summed balance loss, and its gradients, accumulated
    over blocks of `micro` sequences.  Returns (loss, balance, grads,
    tallies)."""
    for v in W.values():
        v.grad = None
    B, S = tokens.shape
    total = bal_total = 0.0
    tallies = {}
    for lo in range(0, B, micro):
        hi = min(B, lo + micro)
        part = None if routes is None else {
            i: r[lo * S:hi * S] for i, r in routes.items()}
        logits, balance = forward(W, cfg, tokens[lo:hi], bias, part, mm,
                                  tallies)
        xent = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets[lo:hi].reshape(-1))
        loss = xent + alpha * balance
        (loss * ((hi - lo) / B)).backward()
        total += float(loss.detach()) * (hi - lo) / B
        bal_total += float(balance.detach()) * (hi - lo) / B
        del logits, loss, xent
    return total, bal_total, {k: v.grad for k, v in W.items()}, tallies


def train_readings(W, cfg, batches, trainer, routes=None, mm=torch.matmul):
    """The readings of a training run from `W` (float32 leaves, updated
    in place) and a zero correction bias: each step's loss and balance
    loss, the first step's gradient norm a leaf, each leaf's change norm
    after all the steps, the correction bias after them, and the share
    of the routes its own scores pick.  routes: a list, a step, of
    {layer: (tokens, K) choices} to route as the program did."""
    dev = W["embed"].device
    bias = {i: torch.zeros(cfg["experts_total"], device=dev)
            for i in moe_layers(cfg)}
    W0 = {k: v.detach().clone() for k, v in W.items()}
    for v in W.values():
        v.requires_grad_(True)
    opt = trainer["adamw"]
    state, losses, balances, grad1 = {}, [], [], None
    agree = routes_n = 0
    for n, (tokens, targets) in enumerate(batches, start=1):
        loss, bal, grads, tallies = loss_and_grads(
            W, cfg, tokens, targets, bias, trainer["balance_alpha"],
            trainer["reference_micro_batch"],
            None if routes is None else routes[n - 1], mm)
        losses.append(loss)
        balances.append(bal)
        agree += sum(t["agree"] for t in tallies.values())
        routes_n += sum(t["routes"] for t in tallies.values())
        if grad1 is None:
            grad1 = leaf_norms({k: torch.zeros_like(W[k]) if g is None
                                else g for k, g in grads.items()})
        adamw_step(W, grads, state, opt["learning_rate"],
                   tuple(opt["betas"]), opt["eps"], opt["weight_decay"])
        update_bias(bias, tallies, cfg, trainer["bias_update_speed"])
    with torch.no_grad():
        change = leaf_norms({k: W[k] - W0[k] for k in W})
    return {"loss": losses, "balance": balances, "grad": grad1,
            "change": change, "bias": bias,
            "route_agree": agree / max(1, routes_n)}
