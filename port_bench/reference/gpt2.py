"""Plain GPT-2 in float32 PyTorch: the yardstick that decides `correct`.

Follows the published GPT-2 block (Radford et al. 2019; the Hugging Face
`GPT2LMHeadModel` layer equations): token and learned positional
embeddings, then per layer a pre-norm LayerNorm, a fused q/k/v
projection with bias, causal softmax attention scaled by 1/sqrt(d_head),
an output projection, a second LayerNorm and an MLP of width 4 x n_embd
with the tanh GELU; a final LayerNorm and the vocabulary head.

Departures from the published model, each one the served program's
(the configuration file lists them under `assumed`):
  - LayerNorm epsilon is the configuration's `layer_norm_epsilon`
    (the program uses 1e-6; GPT-2 1e-5);
  - the head is its own (n_embd, vocab) matrix with a bias, not the
    transposed token table;
  - no dropout (inference, and training as the program runs it);
  - weights are random, drawn from the seed (port_bench/weights.py).

Everything is float32 with TF32 off (`strict_fp32`), with no kernels,
cache or batching of its own.  It imports nothing of the program: the
weights are the benchmark's own tensors (weights.py), and the tokens it
judges are the program's outputs, read only to judge them.

`mm` is the one matmul every projection and the head go through, so
the lower-precision control (`fp8_mm`) replaces it alone.
"""

from __future__ import annotations

import math

import torch

STACKED = ("ln0_g", "ln0_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
           "ln1_g", "ln1_b", "fc_w", "fc_b", "out_w", "out_b")
SINGLE = ("wte", "wpe", "lnf_g", "lnf_b", "head_w", "head_b")


def strict_fp32():
    """float32 matmuls and convolutions in full precision (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def as_f32(weights):
    """The benchmark's weights (weights.make) as float32 leaves."""
    return {k: v.float() for k, v in weights.items()}


def layer_norm(x, g, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def forward(W, tokens, model, mm=torch.matmul):
    """Logits (B, S, vocab) of token ids (B, S) at positions 0..S-1."""
    L, H = model["n_layer"], model["n_head"]
    eps = model["layer_norm_epsilon"]
    b, s = tokens.shape
    d = W["wte"].shape[1]
    dh = d // H
    x = W["wte"][tokens] + W["wpe"][:s]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(L):
        h = layer_norm(x, W["ln0_g"][i], W["ln0_b"][i], eps)
        qkv = (mm(h, W["qkv_w"][i]) + W["qkv_b"][i]).view(b, s, 3, H, dh)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        scores = q @ k.transpose(-1, -2) / math.sqrt(dh)
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        att = (p @ v).transpose(1, 2).reshape(b, s, d)
        x = x + mm(att, W["proj_w"][i]) + W["proj_b"][i]
        h = layer_norm(x, W["ln1_g"][i], W["ln1_b"][i], eps)
        x = x + mm(gelu_tanh(mm(h, W["fc_w"][i]) + W["fc_b"][i]),
                   W["out_w"][i]) + W["out_b"][i]
    x = layer_norm(x, W["lnf_g"], W["lnf_b"], eps)
    return mm(x, W["head_w"]) + W["head_b"]


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


# ---- serving: the served tokens against the reference's logits ----

@torch.no_grad()
def served_gaps(W, model, prompt, served, control=False):
    """(gap, control gap) over one served request.

    gap: the widest amount by which a served token's reference logit lies
    below the reference's best logit at its position.  The reference runs
    once over the prompt and the served tokens (teacher forcing).
    control gap (control=True, else None): the same widest amount for the
    tokens that the fp8 reference (`fp8_mm`) puts first at the same
    positions of the same prompt and tokens."""
    dev = W["wte"].device
    p = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    t = torch.as_tensor(served, dtype=torch.long, device=dev)
    toks = torch.cat([p, t[:-1]])[None]
    rows = forward(W, toks, model)[0, p.numel() - 1:]
    best = rows.max(-1).values
    gap = float((best - rows.gather(1, t[:, None])[:, 0]).max())
    cgap = None
    if control:
        crow = forward(W, toks, model, mm=fp8_mm)[0, p.numel() - 1:]
        pick = crow.argmax(-1)
        cgap = float((best - rows.gather(1, pick[:, None])[:, 0]).max())
    return gap, cgap


# ---- training: three steps of the loss, the gradient and AdamW ----

def part_norms(leaf, layer, t):
    """{name: L2 norm} of one leaf (one layer's slice of a stacked one):
    the fused q/k/v projection's three parts apart, as `leaf.layer.q`
    and so on, so a part whose gradient is nought (the key bias, under
    softmax) is a leaf of its own; others as `leaf.layer` or `leaf`."""
    base = leaf if layer is None else f"{leaf}.{layer}"
    t = t.detach().double()
    if leaf in ("qkv_w", "qkv_b"):
        parts = t.reshape(*t.shape[:-1], 3, -1)
        return {f"{base}.{p}": float(parts.select(-2, j).norm())
                for j, p in enumerate("qkv")}
    return {base: float(t.norm())}


def leaf_norms(T, model):
    """part_norms over a dict of stacked tensors shaped as weights.make's."""
    out = {}
    for k in SINGLE:
        out.update(part_norms(k, None, T[k]))
    for k in STACKED:
        for i in range(model["n_layer"]):
            out.update(part_norms(k, i, T[k][i]))
    return out


def loss_and_grads(W, model, tokens, targets, micro, mm=torch.matmul,
                   rows=None):
    """Mean next-token cross entropy of (tokens, targets) (B, S) and its
    gradients, accumulated over blocks of `micro` sequences.  rows: the
    sequences the mean is taken over (default all; a fault of the
    benchmark's test takes half)."""
    for v in W.values():
        v.grad = None
    rows = tokens.shape[0] if rows is None else rows
    total = 0.0
    for lo in range(0, rows, micro):
        hi = min(rows, lo + micro)
        logits = forward(W, tokens[lo:hi], model, mm=mm)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets[lo:hi].reshape(-1))
        (loss * ((hi - lo) / rows)).backward()
        total += float(loss.detach()) * (hi - lo) / rows
        del logits, loss
    return total, {k: v.grad for k, v in W.items()}


def adamw_step(W, grads, state, step, lr, betas, eps, weight_decay):
    """Decoupled AdamW (Loshchilov and Hutter), with bias correction."""
    b1, b2 = betas
    with torch.no_grad():
        for k, p in W.items():
            g = grads[k]
            m, v = state.setdefault(k, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * weight_decay)
            mhat = m / (1 - b1 ** step)
            vhat = v / (1 - b2 ** step)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))


def train_readings(W, model, batches, opt, micro, mm=torch.matmul,
                   half_batch=False):
    """The three readings of a training run, from `W` (float32 leaves,
    updated in place): each step's loss, the first step's gradient norm
    a leaf, and each leaf's change norm after all the steps."""
    W0 = {k: v.detach().clone() for k, v in W.items()}
    for v in W.values():
        v.requires_grad_(True)
    state, losses, grad1 = {}, [], None
    for n, (tokens, targets) in enumerate(batches, start=1):
        rows = tokens.shape[0] // 2 if half_batch else None
        loss, grads = loss_and_grads(W, model, tokens, targets, micro,
                                     mm=mm, rows=rows)
        losses.append(loss)
        if grad1 is None:
            grad1 = leaf_norms(grads, model)
        adamw_step(W, grads, state, n, opt["learning_rate"],
                   tuple(opt["betas"]), opt["eps"], opt["weight_decay"])
    with torch.no_grad():
        change = leaf_norms({k: W[k] - W0[k] for k in W}, model)
    return {"loss": losses, "grad": grad1, "change": change}
