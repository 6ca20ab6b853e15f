"""The port's DeepSeek-V3-style decoder (models/mla_moe_lm.py) and its
dropless expert layer (parallel/moe.py `HeldExperts`) against the plain
float32 reference the benchmark judges them by
(port_bench/reference/moonlight.py), at a small size on the CPU with
seeded random weights, everything in f32.

Tolerances: the program and the reference compute the same f32
function by other routes (a fused [gate | up] matmul against two, the
norm's hand-written backward against autograd's, blocked attention
against one softmax, a grouped product against a loop), so they agree to
f32 round-off: 1e-5 relative on values, 1e-4 on gradients, which pass
through a few more sums.  Routing compares exactly: the same f32 scores
order the experts alike unless two lie within round-off, which these
draws do not.
"""

import json
import math
import subprocess
import sys

import pytest
import torch

from container_engine_accelerators_tpu_torch import lm_main
from container_engine_accelerators_tpu_torch.models import mla_moe_lm as M
from container_engine_accelerators_tpu_torch.ops import grouped_mm as GM
from container_engine_accelerators_tpu_torch.ops.flash_attention import (
    causal_attention_plain,
)
from container_engine_accelerators_tpu_torch.parallel import layout as LY
from container_engine_accelerators_tpu_torch.parallel.moe import (
    HeldExperts,
)
from port_bench.reference import moonlight as R

VAL, GRAD = 1e-5, 1e-4

# Moonlight-16B-A3B's config.json keys at a small size: 3 layers (one
# dense), 8 experts of which the rank holds 4 (from expert 4), 3 a token.
SMALL = {
    "hidden_size": 32, "num_hidden_layers": 3, "num_attention_heads": 2,
    "q_lora_rank": None, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
    "qk_rope_head_dim": 4, "v_head_dim": 8, "intermediate_size": 48,
    "moe_intermediate_size": 12, "n_routed_experts": 4, "experts_total": 8,
    "expert_start": 4, "n_shared_experts": 2, "num_experts_per_tok": 3,
    "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "rms_norm_eps": 1e-5, "rope_theta": 50000.0,
    "vocab_size": 64, "tie_word_embeddings": False,
}


def _model(cfg=SMALL, seed=0):
    model = M.MLAMoELM(cfg, dtype=torch.float32, device="cpu",
                       param_dtype=torch.float32)
    return model.init_random(torch.Generator().manual_seed(seed))


def _weights(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _tokens(cfg, b, s, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg["vocab_size"], (b, s + 1), generator=g)


def test_mla_attention_plain_path_matches_reference():
    model = _model()
    W = _weights(model)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 24, SMALL["hidden_size"], generator=g)
    x1 = x.clone().requires_grad_(True)
    model.requires_grad_(True)
    got = model.layers[0].attn(x1)
    x2 = x.clone().requires_grad_(True)
    for v in W.values():
        v.requires_grad_(True)
    want = R.attention(W, "layers.0.", SMALL, x2, torch.matmul)
    assert _rel(got, want) < VAL
    dy = torch.randn(got.shape, generator=g)
    got.backward(dy)
    want.backward(dy)
    assert _rel(x1.grad, x2.grad) < GRAD
    attn = model.layers[0].attn
    for name in ("wq", "wkva", "kv_norm", "wkvb", "wo"):
        assert _rel(getattr(attn, name).grad,
                    W[f"layers.0.attn.{name}"].grad) < GRAD, name


def test_mla_pads_v_for_the_flash_route():
    """The flash route gets v NOT padded (the name is kept from when the
    route zero-padded v to q's width): the v_head_dim-wide strided view
    of the kv projection, which the kernels' (192, 128) instance reads in
    place; through it the plain version gives the plain path's output
    and gradients."""
    model = _model()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 16, SMALL["hidden_size"], generator=g)
    attn = model.layers[0].attn
    attn.requires_grad_(True)
    plain = attn(x)
    plain.sum().backward()
    want = {n: p.grad.clone() for n, p in attn.named_parameters()}
    attn.zero_grad()
    seen = []

    def route(q, k, v):
        seen.append((tuple(q.shape), tuple(v.shape), v.stride(2)))
        return causal_attention_plain(q, k, v)

    attn.attn_fn = route
    out = attn(x)
    out.sum().backward()
    h, dn = SMALL["num_attention_heads"], SMALL["qk_nope_head_dim"]
    qw, dv = dn + SMALL["qk_rope_head_dim"], SMALL["v_head_dim"]
    assert seen == [((1, 16, h, qw), (1, 16, h, dv), dn + dv)]
    assert _rel(out, plain) < VAL
    for n, p in attn.named_parameters():
        assert _rel(p.grad, want[n]) < GRAD, n


def test_rope_rotates_interleaved_pairs():
    """Pairs (x[2i], x[2i+1]) turn by position x theta^(-2i/d), as
    DeepSeek-V3's complex-number apply_rotary_emb; the reference's and
    the program's agree, and position 0 is the identity."""
    d, s, theta = 8, 5, 50000.0
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, s, 2, d, generator=g)
    cos, sin = M.rope_tables(s, d, theta, "cpu")
    got = M.apply_rope(x, cos, sin)
    freq = theta ** (-torch.arange(0, d, 2).float() / d)
    cis = torch.polar(torch.ones(s, d // 2),
                      torch.arange(s).float()[:, None] * freq)
    want = torch.view_as_real(
        torch.view_as_complex(x.view(1, s, 2, d // 2, 2))
        * cis[None, :, None]).flatten(-2)
    assert _rel(got, want) < VAL
    assert _rel(R.rope(x, torch.arange(s), theta), want) < VAL
    assert torch.equal(got[:, 0], x[:, 0])


def _layer_weights(m, prefix="layers.1."):
    return {prefix + "moe." + n: p.detach().clone()
            for n, p in m.named_parameters()}


def _held(cfg, start, n_local, seed=7, skew=0.0):
    """A HeldExperts of `cfg`'s widths holding [start, start + n_local),
    its weights drawn whole and cut (so every share holds the same
    experts); skew tilts the router along the first coordinate, which
    _skewed inputs raise, so low experts take most routes and some high
    ones none."""
    E, D = cfg["experts_total"], cfg["hidden_size"]
    F = cfg["moe_intermediate_size"]
    m = HeldExperts(D, F, cfg["n_shared_experts"] * F, E, n_local, start,
                    cfg["num_experts_per_tok"],
                    cfg["routed_scaling_factor"], cfg["norm_topk_prob"],
                    torch.float32, "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        router = torch.randn(D, E, generator=g) / math.sqrt(D)
        router[0] += skew * torch.linspace(1.0, -1.0, E) / 3.0
        m.router.copy_(router)
        w13 = torch.randn(E, D, 2 * F, generator=g) / math.sqrt(D)
        w2 = torch.randn(E, F, D, generator=g) / math.sqrt(F)
        m.w13.copy_(w13[start:start + n_local])
        m.w2.copy_(w2[start:start + n_local])
        m.shared.w13.copy_(torch.randn(m.shared.w13.shape, generator=g)
                           / math.sqrt(D))
        m.shared.w2.copy_(torch.randn(m.shared.w2.shape, generator=g)
                          / math.sqrt(m.shared.w2.shape[0]))
    return m


def _ref_layer(m, cfg, h, forced=None):
    W = _layer_weights(m)
    for v in W.values():
        v.requires_grad_(True)
    tally = {}
    out, bal = R.moe(W, "layers.1.", dict(cfg, expert_start=m.expert_start,
                                          n_routed_experts=m.n_local),
                     h, m.bias, forced, torch.matmul, tally)
    return out, bal, W, tally


@pytest.mark.parametrize("skew,bias_on", [(0.0, False), (1.5, False),
                                          (0.0, True)])
def test_dropless_layer_matches_reference_loop(skew, bias_on):
    cfg = SMALL
    m = _held(cfg, cfg["expert_start"], cfg["n_routed_experts"], skew=skew)
    m.requires_grad_(True)
    if bias_on:
        with torch.no_grad():
            m.bias[5] = 10.0  # every token picks expert 5
    g = torch.Generator().manual_seed(8)
    h = torch.randn(2, 16, cfg["hidden_size"], generator=g)
    h[..., 0] += 3.0
    m.record = []
    h1 = h.clone().requires_grad_(True)
    got = m(h1)
    choice = m.record[0].long()
    counts = torch.bincount(choice.flatten(), minlength=8)
    if skew:
        assert counts[4:].min() == 0  # a held expert with no tokens
        assert counts.max() > 2 * counts.float().mean()
    if bias_on:
        assert (choice == 5).any(-1).all()
    h2 = h.clone().requires_grad_(True)
    want, bal, W, tally = _ref_layer(m, cfg, h2)
    assert _rel(got, want) < VAL
    got_bal, want_bal = float(m.balance.detach()), float(bal.detach())
    assert abs(got_bal - want_bal) < VAL * want_bal
    assert torch.equal(m.load, tally["load"])
    dy = torch.randn(got.shape, generator=g)
    ((got * dy).sum() + m.balance).backward()
    ((want * dy).sum() + bal).backward()
    assert _rel(h1.grad, h2.grad) < GRAD
    for n, p in m.named_parameters():
        assert _rel(p.grad, W["layers.1.moe." + n].grad) < GRAD, n


def test_bias_changes_the_choice_not_the_weights():
    """The correction bias picks the experts; the gates are the chosen
    experts' own sigmoid scores, normalised and scaled."""
    cfg = SMALL
    m = _held(cfg, 4, 4)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(32, cfg["hidden_size"], generator=g)
    gates0, choice0 = m.route(x, 2)
    with torch.no_grad():
        m.bias[0] = 10.0
    gates1, choice1 = m.route(x, 2)
    assert (choice1 == 0).any(-1).all() and not torch.equal(choice0, choice1)
    scores = torch.sigmoid(x @ m.router)
    for gates, choice in ((gates0, choice0), (gates1, choice1)):
        w = scores.gather(1, choice)
        want = w / w.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]
        assert _rel(gates, want) < VAL


def test_held_shares_sum_to_the_uncut_layer():
    """Every rank's share, with the shared experts (which every rank
    computes alike) counted once, adds up to the layer holding all 8."""
    cfg = SMALL
    g = torch.Generator().manual_seed(10)
    h = torch.randn(2, 16, cfg["hidden_size"], generator=g)
    whole = _held(cfg, 0, 8)
    total = whole(h)
    shares = [_held(cfg, s, 2) for s in range(0, 8, 2)]
    parts = [m(h) for m in shares]
    shared = whole.shared(h.reshape(-1, cfg["hidden_size"])).view_as(h)
    summed = sum(parts) - (len(parts) - 1) * shared
    assert _rel(summed, total) < VAL
    # Each share routes over all 8 experts, as the whole layer does.
    assert all(torch.equal(m.load, whole.load) for m in shares)
    # The reference's uncut layer agrees too.
    want, _, _, _ = _ref_layer(whole, cfg, h)
    assert _rel(total, want) < VAL


def test_bias_update_and_balance_loss():
    cfg = SMALL
    m = _held(cfg, 4, 4, skew=2.0)
    g = torch.Generator().manual_seed(11)
    b, s = 3, 8
    x = torch.randn(b * s, cfg["hidden_size"], generator=g)
    gates, choice = m.route(x, b)
    E, K = cfg["experts_total"], cfg["num_experts_per_tok"]
    load = torch.bincount(choice.flatten(), minlength=E).float()
    assert torch.equal(m.load, load)
    scores = torch.sigmoid(x @ m.router)
    bal = 0.0
    for j in range(b):
        rows = slice(j * s, (j + 1) * s)
        f = torch.bincount(choice[rows].flatten(), minlength=E) * (
            E / (K * s))
        P = (scores[rows] / scores[rows].sum(-1, keepdim=True)).mean(0)
        bal += float((f * P).sum().detach()) / b
    assert abs(float(m.balance.detach()) - bal) < VAL * bal
    m.update_bias(1e-3)
    mean = load.mean()
    want = 1e-3 * torch.sign(mean - load)
    assert torch.equal(m.bias, want)
    assert torch.all(m.load == 0)
    # The busiest experts lose and the idle ones gain.
    assert m.bias[int(load.argmax())] < 0 < m.bias[int(load.argmin())]


def test_whole_model_logits_loss_and_gradients():
    cfg = SMALL
    model = _model(cfg)
    W = _weights(model)
    tok = _tokens(cfg, 2, 16)
    tokens, targets = tok[:, :-1], tok[:, 1:]
    model.requires_grad_(True)
    logits = model(tokens)
    xent = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg["vocab_size"]), targets.reshape(-1))
    loss = xent + M.BALANCE_ALPHA * model.balance_loss()
    loss.backward()
    bias = {i: torch.zeros(cfg["experts_total"]) for i in R.moe_layers(cfg)}
    for v in W.values():
        v.requires_grad_(True)
    want_logits, _ = R.forward(W, cfg, tokens, bias)
    assert _rel(logits.detach(), want_logits.detach()) < VAL
    want_loss, want_bal, grads, _ = R.loss_and_grads(
        W, cfg, tokens, targets, bias, M.BALANCE_ALPHA, 1)
    assert abs(float(loss.detach()) - want_loss) < VAL * want_loss
    assert abs(float(model.balance_loss().detach()) - want_bal) < (
        VAL * want_bal)
    got = dict(model.named_parameters())
    assert set(got) == set(grads)
    for n, p in got.items():
        assert _rel(p.grad, grads[n]) < GRAD, n


def test_training_steps_match_reference_readings():
    """Three steps of build_mla_moe_training against the reference's
    train_readings from the same weights: each step's loss, the first
    gradient, every leaf's change and the correction biases."""
    cfg = SMALL
    tr = {"adamw": {"learning_rate": 3e-3, "betas": [0.9, 0.999],
                    "eps": 1e-8, "weight_decay": 1e-4},
          "balance_alpha": M.BALANCE_ALPHA,
          "bias_update_speed": M.BIAS_UPDATE_SPEED,
          "reference_micro_batch": 1}
    step_fn, state, batch_fn = M.build_mla_moe_training(
        cfg, seq_len=16, batch=2, learning_rate=3e-3, dtype=torch.float32,
        device="cpu")
    model = state["model"]
    W = _weights(model)
    g = torch.Generator().manual_seed(12)
    batches = [batch_fn(g) for _ in range(3)]
    losses = []
    for tokens, targets in batches:
        state, loss = step_fn(state, tokens, targets)
        losses.append(float(loss))
    want = R.train_readings({k: v.clone() for k, v in W.items()}, cfg,
                            batches, tr)
    assert want["route_agree"] == 1.0
    for a, b in zip(losses, want["loss"]):
        assert abs(a - b) < VAL * b
    change = R.leaf_norms({n: p.detach() - W[n].detach()
                           for n, p in model.named_parameters()})
    for k, v in want["change"].items():
        assert abs(change[k] - v) <= GRAD * max(v, 1e-12) + 1e-9, k
    for i, m in zip(R.moe_layers(cfg), model.expert_layers()):
        assert torch.equal(m.bias, want["bias"][i])
    counts = model.moe_counters()
    assert counts["moe_layer_steps"] == 3 * len(model.expert_layers())
    assert counts["bias_updates"] == counts["moe_layer_steps"]
    assert counts["moe_routes"] == counts["moe_layer_steps"] * 32 * 3
    assert 0 < counts["moe_held_routes"] < counts["moe_routes"]
    assert counts["moe_load_max"] * 4 >= counts["moe_held_routes"]


def test_forced_routes_reproduce_and_agreement_counts():
    """Handed the program's own choices, the reference's readings are the
    free-running ones, and it counts every route as agreed; handed
    altered choices, it counts the changed routes as not agreed."""
    cfg = SMALL
    model = _model(cfg)
    W = _weights(model)
    tok = _tokens(cfg, 2, 16)
    tokens = tok[:, :-1]
    layers = model.expert_layers()
    for m in layers:
        m.record = []
    model(tokens)
    routes = {i: m.record[0] for i, m in zip(R.moe_layers(cfg), layers)}
    bias = {i: torch.zeros(cfg["experts_total"]) for i in R.moe_layers(cfg)}
    free, _ = R.forward(W, cfg, tokens, bias)
    tallies = {}
    forced, _ = R.forward(W, cfg, tokens, bias, routes, tallies=tallies)
    assert torch.equal(free, forced)
    assert all(t["agree"] == t["routes"] for t in tallies.values())
    first = R.moe_layers(cfg)[0]
    altered = dict(routes)
    r = routes[first].clone()
    r[:4, 0] = (r[:4, 0] + 1) % cfg["experts_total"]
    clash = (r[:4, :1] == r[:4, 1:]).any(-1)
    r[:4, 0] = torch.where(clash, (r[:4, 0] + 1) % 8, r[:4, 0])
    altered[first] = r
    tallies = {}
    R.forward(W, cfg, tokens, bias, altered, tallies=tallies)
    t = tallies[first]
    assert t["routes"] - t["agree"] >= 1


def test_grouped_mm_plain_matches_per_group_matmuls():
    g = torch.Generator().manual_seed(13)
    x = torch.randn(10, 6, generator=g, requires_grad=True)
    w = torch.randn(3, 6, 5, generator=g, requires_grad=True)
    offs = torch.tensor([3, 3, 10], dtype=torch.int32)
    y = GM.grouped_mm(x, w, offs)
    want = torch.cat([x[:3] @ w[0], x[3:] @ w[2]])
    assert torch.allclose(y, want)
    y.sum().backward()
    assert torch.all(w.grad[1] == 0)
    with pytest.raises(ValueError):
        GM.grouped_mm(x, w[:2], offs)


def test_layout_names_the_held_experts_placement():
    model = M.MLAMoELM(SMALL, dtype=torch.float32, device="cpu",
                       param_dtype=torch.float32)
    lay = M.expert_layout(model)
    pl = lay.placements["layers.1.moe.w13"]
    assert pl.shape[0] == SMALL["experts_total"] and pl.dim == 0
    assert (pl.index, pl.count) == (1, 2)
    assert lay.placements["layers.1.moe.router"].dim is None
    w13 = model.layers[1].moe.w13
    full = torch.arange(8.0)[:, None, None].expand(
        (8,) + tuple(w13.shape[1:])).contiguous()
    piece = pl.cut(full, w13)
    assert piece.shape == w13.shape
    assert piece[:, 0, 0].tolist() == [4.0, 5.0, 6.0, 7.0]
    whole = M.expert_layout(M.MLAMoELM(
        dict(SMALL, n_routed_experts=8, expert_start=0), dtype=torch.float32,
        device="cpu"))
    assert all(p.dim is None for p in whole.placements.values())
    assert isinstance(lay, LY.Layout)


def test_lm_main_trains_the_architecture_on_the_cpu(tmp_path):
    path = tmp_path / "arch.json"
    path.write_text(json.dumps(SMALL))
    out = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.lm_main", "--device",
         "cpu", "--arch", "deepseek_v3", "--arch-config", str(path),
         "--seq-len", "16", "--batch", "2", "--train-steps", "3",
         "--log-every", "1"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    steps = [ln for ln in out.stderr.splitlines() if ":step " in ln]
    assert len(steps) == 3, out.stderr
    assert "done: 3 steps" in out.stderr


def test_lm_main_refuses_what_the_architecture_does_not_build(tmp_path):
    path = tmp_path / "arch.json"
    path.write_text(json.dumps(SMALL))
    log = lm_main.logging.getLogger("test")
    args = lm_main.parse_args(["--arch", "deepseek_v3"])
    with pytest.raises(lm_main.Refusal):
        lm_main.plan(args, 1, log)  # no --arch-config
    args = lm_main.parse_args(["--arch", "deepseek_v3", "--arch-config",
                               str(tmp_path / "missing.json")])
    with pytest.raises(lm_main.Refusal):
        lm_main.plan(args, 1, log)
    args = lm_main.parse_args(["--arch", "deepseek_v3", "--arch-config",
                               str(path), "--mode", "tp"])
    with pytest.raises(lm_main.Refusal):
        lm_main.plan(args, 2, log)
    args = lm_main.parse_args(["--arch", "deepseek_v3", "--arch-config",
                               str(path), "--model-dir", str(tmp_path)])
    with pytest.raises(lm_main.Refusal):
        lm_main.plan(args, 1, log)  # a share of 4 of 8 experts
