"""DeepSeek-V3-style decoder (Moonlight-16B-A3B's block) and its trainer
(port-only: the JAX package has no such model).

The layer equations (DeepSeek-V3's inference code; the configuration is
a Hugging Face `deepseek_v3` config.json as a dict):
  - RMSNorm, f32 statistics, its output in the blocks' type;
  - latent attention (MLA) without a q-LoRA: q = x W_q, per head
    [q_nope | q_pe]; [c_kv | k_pe] = x W_kva, c_kv through an RMSNorm;
    [k_nope | v] = c_kv W_kvb per head; RoPE (no scaling) on q_pe and
    k_pe over interleaved pairs, in f32; k_pe shared by every head;
    causal softmax(q . k / sqrt(d_nope + d_rope)) v, then W_o.  On the
    card through the flash kernels (ops/flash_attention.py), whose
    (192, 128) instance takes q and k at 192 and v at 128: v is the
    strided view of the kv projection, read in place, and the output is
    (b, s, h, v_head_dim) contiguous; on the CPU the plain version takes
    the same operands;
  - the first `first_k_dense_replace` layers a SwiGLU FFN, the others
    the expert layer of parallel/moe.py (`HeldExperts`: this rank's
    share of the routed experts, the router over all of them, the shared
    experts);
  - a final RMSNorm and the untied head (no biases anywhere).

Parameters carry the benchmark's names (`layers.<i>.attn.wq`, ...,
`embed`, `final_norm`, `head`).  Norm weights, the router, the embedding
and the head's master are f32; the projections are stored in
`param_dtype` (f32 masters for training) and computed in `dtype` (bf16
on the card), the head too, its logits in `dtype`.

Training (`build_mla_moe_training`): the cross entropy over the
vocabulary (the fused kernels on the card, ops/fused_xent.py), plus
alpha times the MoE layers' summed sequence-wise balance loss; AdamW as
the LM trainer's; after each step every MoE layer's correction bias
moves by gamma toward balance (DeepSeek-V3's auxiliary-loss-free
balancing; alpha and gamma from its report).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from ..ops.flash_attention import causal_attention_plain, \
    flash_causal_attention
from ..ops.fused_xent import fused_cross_entropy_loss
from ..ops.losses import cross_entropy_loss
from ..parallel.moe import HeldExperts, SwiGLU, profiler_range
from .transformer import _adamw, _random_batch_fn, resolve_attn, \
    resolve_loss

# DeepSeek-V3's report (arXiv:2412.19437 sec. 4.2): the bias update speed
# gamma and the sequence-wise balance weight alpha.
BIAS_UPDATE_SPEED = 1e-3
BALANCE_ALPHA = 1e-4


def experts_total(cfg):
    """The router's width: `experts_total` where a rank holds a share,
    else every routed expert."""
    return cfg.get("experts_total", cfg["n_routed_experts"])


def is_moe_layer(cfg, i):
    return (i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


class _RMSNorm(torch.autograd.Function):
    """x / sqrt(mean(x^2) + eps) * w with f32 statistics, the output in
    `dtype`; saves x in its own type and the row scale, not f32 copies."""

    @staticmethod
    def forward(ctx, x, w, eps, dtype):
        xf = x.float()
        r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, w, r)
        return (xf * r * w).to(dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, r = ctx.saved_tensors
        xhat = x.float() * r
        dxhat = dy.float() * w
        dw = (dy.float() * xhat).reshape(-1, w.shape[0]).sum(0)
        dx = r * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        return dx.to(x.dtype), dw, None, None


def rms_norm(x, w, eps, dtype):
    return _RMSNorm.apply(x, w, eps, dtype)


def rope_tables(seq, d, theta, device):
    """(cos, sin), each (seq, 1, d / 2) f32, of positions 0..seq-1 at
    frequencies theta^(-2i / d)."""
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=device) / d)
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * (
        freq[None])
    return torch.cos(ang)[:, None], torch.sin(ang)[:, None]


def apply_rope(x, cos, sin):
    """Rotate the interleaved pairs (x[2i], x[2i+1]) of x (b, s, h, d) in
    f32, the result in x's type."""
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    return torch.stack((a * cos - b * sin, a * sin + b * cos),
                       -1).flatten(-2).to(x.dtype)


class MLAttention(nn.Module):
    """Latent attention without a q-LoRA (module docstring)."""

    def __init__(self, cfg, dtype, device, param_dtype, attn_fn):
        super().__init__()
        D, H = cfg["hidden_size"], cfg["num_attention_heads"]
        self.heads, self.r = H, cfg["kv_lora_rank"]
        self.dn, self.dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        self.dv = cfg["v_head_dim"]
        self.eps, self.theta = cfg["rms_norm_eps"], cfg["rope_theta"]
        self.dtype, self.attn_fn = dtype, attn_fn

        def mat(i, o):
            return nn.Parameter(torch.zeros((i, o), dtype=param_dtype,
                                            device=device))

        self.wq = mat(D, H * (self.dn + self.dr))
        self.wkva = mat(D, self.r + self.dr)
        self.kv_norm = nn.Parameter(torch.ones(self.r, device=device))
        self.wkvb = mat(self.r, H * (self.dn + self.dv))
        self.wo = mat(H * self.dv, D)

    def forward(self, x):
        b, s, _ = x.shape
        H, dn, dr, dv, r = self.heads, self.dn, self.dr, self.dv, self.r
        dt = self.dtype
        with profiler_range("mla.attention"):
            q = (x @ self.wq.to(dt)).view(b, s, H, dn + dr)
            kva = x @ self.wkva.to(dt)
            c = rms_norm(kva[..., :r], self.kv_norm, self.eps, dt)
            cos, sin = rope_tables(s, dr, self.theta, x.device)
            k_pe = apply_rope(kva[..., None, r:], cos, sin)
            kv = (c @ self.wkvb.to(dt)).view(b, s, H, dn + dv)
            q = torch.cat((q[..., :dn], apply_rope(q[..., dn:], cos, sin)),
                          -1)
            k = torch.cat((kv[..., :dn], k_pe.expand(b, s, H, dr)), -1)
            o = self.attn_fn(q, k, kv[..., dn:])  # v read in place
            return o.reshape(b, s, H * dv) @ self.wo.to(dt)


class Block(nn.Module):
    """Pre-norm block: x + MLA(norm(x)), then + FFN(norm(x)), the FFN the
    dense SwiGLU (`mlp`) or the expert layer (`moe`)."""

    def __init__(self, cfg, i, dtype, device, param_dtype, attn_fn):
        super().__init__()
        D, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.eps, self.dtype = eps, dtype
        self.attn_norm = nn.Parameter(torch.ones(D, device=device))
        self.attn = MLAttention(cfg, dtype, device, param_dtype, attn_fn)
        self.ffn_norm = nn.Parameter(torch.ones(D, device=device))
        if is_moe_layer(cfg, i):
            self.moe = HeldExperts(
                D, cfg["moe_intermediate_size"],
                cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
                experts_total(cfg), cfg["n_routed_experts"],
                cfg.get("expert_start", 0), cfg["num_experts_per_tok"],
                cfg["routed_scaling_factor"], cfg["norm_topk_prob"], dtype,
                device, param_dtype)
        else:
            self.mlp = SwiGLU(D, cfg["intermediate_size"], dtype, device,
                              param_dtype)

    def forward(self, x):
        x = x + self.attn(rms_norm(x, self.attn_norm, self.eps, self.dtype))
        h = rms_norm(x, self.ffn_norm, self.eps, self.dtype)
        return x + (self.moe(h) if hasattr(self, "moe") else self.mlp(h))


class MLAMoELM(nn.Module):
    """The decoder.  forward(tokens (b, s)) -> logits (b, s, vocab) in
    `dtype`.  Parameters are zeros (norms ones) until loaded or drawn
    (`init_random`), and take no gradient until a trainer asks."""

    def __init__(self, cfg, dtype=torch.bfloat16, device="cuda",
                 param_dtype=None, attn_fn=causal_attention_plain):
        super().__init__()
        dev = resolve_device(device)
        if cfg.get("q_lora_rank") is not None:
            raise ValueError("MLAMoELM: a q-LoRA (q_lora_rank) is not built")
        if cfg["scoring_func"] != "sigmoid" or cfg["topk_method"] != (
                "noaux_tc") or cfg["n_group"] != 1 or cfg["topk_group"] != 1:
            raise ValueError(
                "MLAMoELM routes by sigmoid scores and a correction bias "
                "(noaux_tc) with no group limit (n_group = topk_group = 1)")
        if cfg.get("rope_scaling"):
            raise ValueError("MLAMoELM: RoPE scaling is not built")
        if cfg.get("tie_word_embeddings"):
            raise ValueError("MLAMoELM: the head is untied")
        self.cfg, self.dtype = dict(cfg), dtype
        D, V = cfg["hidden_size"], cfg["vocab_size"]
        self.embed = nn.Parameter(torch.zeros((V, D), device=dev))
        self.layers = nn.ModuleList(
            Block(cfg, i, dtype, dev, param_dtype or dtype, attn_fn)
            for i in range(cfg["num_hidden_layers"]))
        self.final_norm = nn.Parameter(torch.ones(D, device=dev))
        self.head = nn.Parameter(torch.zeros((D, V), device=dev))
        self.bias_updates = 0
        self.requires_grad_(False)

    def expert_layers(self):
        return [blk.moe for blk in self.layers if hasattr(blk, "moe")]

    def init_random(self, generator: torch.Generator):
        """Every parameter from `generator`, in the order of
        named_parameters: matrices N(0, 1 / fan_in), the router
        N(0, 1 / dim), the embedding N(0, 1), norms ones.  Each held
        expert from a generator of its own (the seed's next draw plus the
        expert's index), so a seed gives the same experts at every
        share.  Drawn on the CPU in f32, then moved."""
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator))

        def draw(p, std, gen=generator):
            w = torch.randn(p.shape, generator=gen) * std
            p.copy_(w.to(p.dtype))

        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm"):
                    p.fill_(1.0)
                elif name == "embed":
                    draw(p, 1.0)
                elif name.endswith(("moe.w13", "moe.w2")):
                    continue
                else:
                    draw(p, 1.0 / math.sqrt(p.shape[0]))
            for m in self.expert_layers():
                for j in range(m.n_local):
                    gen = torch.Generator().manual_seed(
                        (base + m.expert_start + j) % (1 << 63))
                    for w in (m.w13, m.w2):
                        draw(w[j], 1.0 / math.sqrt(w.shape[1]), gen)
        return self

    def forward(self, tokens):
        x = self.embed[tokens.long()].to(self.dtype)
        for blk in self.layers:
            x = blk(x)
        x = rms_norm(x, self.final_norm, self.cfg["rms_norm_eps"],
                     self.dtype)
        return x @ self.head.to(self.dtype)

    def balance_loss(self):
        """The MoE layers' balance losses of the last forward, summed."""
        return sum(m.balance for m in self.expert_layers())

    def update_bias(self, gamma):
        for m in self.expert_layers():
            m.update_bias(gamma)
            self.bias_updates += 1

    def moe_counters(self):
        """The expert layers' counts since the model was built (read at a
        step boundary: one synchronisation)."""
        layers = self.expert_layers()
        held, load_max = torch.stack([m.tally for m in layers]).sum(
            0).tolist()
        return {"moe_routes": sum(m.routes for m in layers),
                "moe_held_routes": held, "moe_load_max": load_max,
                "moe_layer_steps": sum(m.forwards for m in layers),
                "bias_updates": self.bias_updates}


def expert_layout(model):
    """parallel/layout.py's Layout of a one-card share: each held expert
    leaf a piece (along experts) of its layer's every expert, the rest
    whole; no gradient exchange."""
    from ..parallel import layout as LY

    cfg = model.cfg
    total, held = experts_total(cfg), cfg["n_routed_experts"]
    start = cfg.get("expert_start", 0)
    if total % held or start % held:
        raise ValueError(
            f"a share of {held} experts from {start} does not tile "
            f"{total}")
    placements = {}
    for name, p in model.named_parameters():
        if name.endswith(("moe.w13", "moe.w2")) and held < total:
            placements[name] = LY.split_placement(
                name, (total,) + tuple(p.shape[1:]), 0, start // held,
                total // held)
        else:
            placements[name] = LY.whole(name, tuple(p.shape))
    names = list(placements)
    return LY.Layout(placements, {n: [] for n in names}, names,
                     {n: n for n, _ in model.named_buffers()})


def build_mla_moe_training(
    cfg,
    seq_len: int = 8192,
    batch: int = 8,
    learning_rate: float = 3e-4,
    attn_impl: str = "auto",
    balance_alpha: float = BALANCE_ALPHA,
    bias_update_speed: float = BIAS_UPDATE_SPEED,
    *,
    dtype=torch.bfloat16,
    device="cuda",
    params=None,
):
    """(step_fn, state, batch_fn) for the DeepSeek-V3-style decoder of
    config `cfg` on one card, as build_lm_training's.

    state: {"model": MLAMoELM with f32 masters, "opt": AdamW, "step",
    "layout": the held experts' placement (expert_layout)}.  Attention
    and the loss resolve as build_lm_training's "auto" do: flash and the
    fused cross entropy on the card.
    step_fn(state, tokens, targets) -> (state, loss) runs one forward,
    backward and AdamW step in place and then the correction bias
    update; the loss is the mean cross entropy plus balance_alpha times
    the summed balance loss.  batch_fn(generator) draws (tokens,
    targets), each (batch, seq_len).  params: {name: tensor} to start
    from instead of init_random's draw from seed 0."""
    dev = resolve_device(device)
    attn = resolve_attn(attn_impl, seq_len, device=dev)
    model = MLAMoELM(
        cfg, dtype=dtype, device=dev, param_dtype=torch.float32,
        attn_fn=(flash_causal_attention if attn is flash_causal_attention
                 else causal_attention_plain))
    if params is None:
        model.init_random(torch.Generator().manual_seed(0))
    else:
        load_params(model, params)
    model.requires_grad_(True)
    opt = _adamw(model, learning_rate)
    state = {"model": model, "opt": opt, "step": 0,
             "layout": expert_layout(model)}
    vocab = cfg["vocab_size"]
    loss_of = (fused_cross_entropy_loss
               if resolve_loss("auto", batch * seq_len, dev) == "fused"
               else cross_entropy_loss)

    def step_fn(state, tokens, targets):
        opt.zero_grad(set_to_none=True)
        logits = model(tokens)
        loss = loss_of(logits.reshape(-1, vocab), targets.reshape(-1))
        loss = loss + balance_alpha * model.balance_loss()
        loss.backward()
        opt.step()
        model.update_bias(bias_update_speed)
        state["step"] += 1
        return state, loss.detach()

    return step_fn, state, _random_batch_fn(vocab, batch, seq_len, dev)


def load_params(model, params):
    """Copy {name: tensor} (every parameter, by name) into the model."""
    mine = dict(model.named_parameters())
    if set(params) != set(mine):
        raise ValueError(
            "params and the model differ in "
            f"{sorted(set(params) ^ set(mine))[:4]}")
    with torch.no_grad():
        for name, p in mine.items():
            p.copy_(params[name])
