"""Expert parallelism: the mixture-of-experts FFN with token routing
over an all_to_all, the port of
container_engine_accelerators_tpu/parallel/moe.py (`moe_ffn_forward`
:34, `moe_ffn_sharded` :242).

Each rank holds `experts_local` expert FFNs; expert e lives on rank
e // experts_local of the axis.  A replicated router picks `top_k`
experts a token; every expert takes exactly `capacity` tokens a step
(ceil(capacity_factor * k * local tokens / experts)), later routes that
overflow fall back through the token's next-ranked experts for up to
`n_reroute` rounds, and what still overflows is dropped and counted.
Token copies travel to their experts' ranks in one all_to_all and come
back in another; the per-expert FFNs are torch einsums, as the reference
leaves them to XLA.

The reference's semantics, op for op:
  - top-k ties break to the lower expert index (a stable descending
    sort; torch.topk promises no order among equal values);
  - routes are flattened route-major (route j of every token before
    route j + 1 of any), and a cumulative count in that order decides
    which route wins a capacity race; rounds commit one after another;
  - `.at[idx].set(..., mode="drop")` drops out-of-range lanes, where
    torch's indexed write raises: writes go to a buffer with one spare
    row for the dropped routes, which is cut off;
  - the GELU is the tanh form (jax.nn.gelu's default);
  - the combine gate is the final expert's probability over the token's
    original top-k mass (k > 1), the raw probability for k = 1.
The aux loss and the drop fraction are pmean'd over the axis.  The aux
value returned is that mean, but its gradient is the local term's (see
parallel/_collectives.py: each rank's objective is its share of the
global loss, and the mean of the local terms sums to the reference's).

Beside it, port-only, `HeldExperts`: DeepSeek-V3's dropless MoE FFN as
one expert-parallel rank holds it (sigmoid scores and a correction bias
choose each token's experts over all of them; the rank computes its
held experts' part through a grouped matrix product, ops/grouped_mm.py,
and adds the shared experts).  On one card it runs without the
exchange; the JAX package has no such layer.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

from . import _collectives as C
from ..models.transformer import gelu_tanh
from ..ops.grouped_mm import grouped_mm


def _straight_through_pmean(local, group):
    """The axis mean's value with the local term's gradient."""
    mean = C.pmean(local.detach(), group)
    return local + (mean - local.detach())


def top_candidates(probs: torch.Tensor, n_cand: int) -> torch.Tensor:
    """Each token's `n_cand` likeliest experts, best first, ties to the
    lower index (lax.top_k's order; a stable descending sort)."""
    _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return order[:, :n_cand]


def moe_ffn_forward(
    x: torch.Tensor,
    router_w: torch.Tensor,
    w_in: torch.Tensor,
    w_out: torch.Tensor,
    group,
    capacity_factor: float = 1.25,
    top_k: int = 2,
    n_reroute: int = 2,
    trace: Optional[dict] = None,
):
    """One expert-parallel MoE FFN pass for this rank's tokens.

    x (tokens_local, dim); router_w (dim, experts_total) replicated;
    w_in (experts_local, dim, hidden) and w_out (experts_local, hidden,
    dim) this rank's experts; group: the expert axis.  Returns (out
    (tokens_local, dim), aux, drop_frac).  `trace`, when a dict, gets
    the routing: keep (routes,), expert (routes,), pos (routes,) and the
    lanes' tokens `send_slots` (lanes,), token + 1 or 0 for an empty
    lane, and the candidate experts `cand_idx` (tokens, candidates)."""
    if int(n_reroute) < 0:
        raise ValueError(f"n_reroute must be >= 0, got {n_reroute}")
    tokens, dim = x.shape
    e_local, _, hidden = w_in.shape
    n_dev = C.axis_size(group)
    e_total = e_local * n_dev
    k = min(top_k, e_total)
    n_rounds = min(int(n_reroute), e_total // k - 1)
    n_cand = k * (1 + n_rounds)
    dev = x.device

    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    cand_idx = top_candidates(probs, n_cand)
    cand_probs = probs.gather(1, cand_idx)

    # Switch Transformer eq. 4 on the primary assignment.
    assign1 = torch.nn.functional.one_hot(cand_idx[:, 0], e_total).float()
    aux_local = e_total * torch.sum(assign1.mean(0) * probs.mean(0))
    aux = _straight_through_pmean(aux_local, group)

    capacity = int(max(1, math.ceil(capacity_factor * k * tokens / e_total)))

    n_routes = k * tokens
    cur_slot = torch.arange(k, device=dev).repeat_interleave(tokens)
    tok_of_route = torch.arange(tokens, device=dev).repeat(k)
    pending = torch.ones(n_routes, dtype=torch.bool, device=dev)
    final_keep = torch.zeros_like(pending)
    final_e = torch.zeros(n_routes, dtype=torch.int64, device=dev)
    final_pos = torch.zeros_like(final_e)
    committed = torch.zeros(e_total, dtype=torch.int64, device=dev)
    for _ in range(n_rounds + 1):
        e_r = cand_idx[tok_of_route, cur_slot]
        onehot = (torch.nn.functional.one_hot(e_r, e_total)
                  * pending[:, None]).to(torch.int32)
        # The running count down the routes, scanned along each expert's
        # contiguous row: a scan down a (routes, experts) column runs a
        # thread a column on the card.
        within = torch.cumsum(onehot.t().contiguous(), 1).t() - onehot
        pos = within.gather(1, e_r[:, None])[:, 0] + committed[e_r]
        keep_r = pending & (pos < capacity)
        final_keep = final_keep | keep_r
        final_e = torch.where(keep_r, e_r, final_e)
        final_pos = torch.where(keep_r, pos, final_pos)
        committed = committed + (onehot * keep_r[:, None]).sum(0)
        pending = pending & ~keep_r
        cur_slot = torch.where(
            pending, torch.clamp(cur_slot + k, max=n_cand - 1), cur_slot)
    keep = final_keep
    flat_e = torch.where(keep, final_e, 0)
    pos = final_pos
    drop_frac = C.pmean((1.0 - keep.float().mean()).detach(), group)

    raw_gate = torch.where(keep, probs[tok_of_route, flat_e], 0.0)
    if k > 1:
        topk_mass = cand_probs[:, :k].sum(-1)
        flat_gate = raw_gate / torch.clamp(topk_mass[tok_of_route], min=1e-9)
    else:
        flat_gate = raw_gate

    # Lanes: expert e's `capacity` slots, experts of one rank contiguous,
    # so the buffer reshapes into per-rank chunks.  Dropped routes land
    # in the spare row n_lanes.
    n_lanes = e_total * capacity
    flat_idx = flat_e * capacity + torch.where(keep, pos, 0)
    scatter_idx = torch.where(keep, flat_idx, n_lanes)
    x_routes = x.repeat(k, 1)
    send = x.new_zeros((n_lanes + 1, dim)).index_put(
        (scatter_idx,), x_routes)[:n_lanes].reshape(
            n_dev, e_local * capacity, dim)
    send_slots = torch.zeros(n_lanes + 1, dtype=torch.int64,
                             device=dev).index_put(
        (scatter_idx,), tok_of_route + 1)[:n_lanes]
    lane_gates = torch.zeros(n_lanes + 1, dtype=torch.float32,
                             device=dev).index_put(
        (scatter_idx,), flat_gate)[:n_lanes]
    if trace is not None:
        trace.update(keep=keep, expert=final_e, pos=pos,
                     send_slots=send_slots, cand_idx=cand_idx)

    recv = C.all_to_all(send, group)
    rt = (recv.reshape(n_dev, e_local, capacity, dim).transpose(0, 1)
          .reshape(e_local, n_dev * capacity, dim))
    h = torch.einsum("etd,edh->eth", rt, w_in.to(rt.dtype))
    h = gelu_tanh(h)
    y = torch.einsum("eth,ehd->etd", h, w_out.to(rt.dtype))
    y = (y.reshape(e_local, n_dev, capacity, dim).transpose(0, 1)
         .reshape(n_dev, e_local * capacity, dim))
    back = C.all_to_all(y, group)

    contrib = back.reshape(n_lanes, dim).float() * lane_gates[:, None]
    out = torch.zeros((tokens + 1, dim), dtype=torch.float32,
                      device=dev).index_add(0, send_slots, contrib)[1:]
    return out.to(x.dtype), aux, drop_frac


def moe_ffn_sharded(x, router_w, w_in, w_out, mesh, axis_name: str,
                    capacity_factor: float = 1.25, top_k: int = 2,
                    n_reroute: int = 2):
    """moe_ffn_forward over `axis_name` of `mesh` from global tensors:
    x (tokens, dim) split over the axis, w_in / w_out (experts_total,
    ...) cut to this rank's experts, the router replicated.  Returns the
    global (out, aux, drop_frac) on every rank, as the reference's
    out_specs do."""
    from .mesh import Sharding

    sh = Sharding(mesh, (axis_name,))
    out, aux, drop = moe_ffn_forward(
        sh.shard(x), router_w, sh.shard(w_in), sh.shard(w_out),
        mesh.get_group(axis_name), capacity_factor=capacity_factor,
        top_k=top_k, n_reroute=n_reroute)
    return sh.unshard(out), aux, drop


# ---- the dropless expert layer of one expert-parallel rank (port-only) ----

def profiler_range(name):
    """A profiler range named `name` while a torch profiler runs (made as
    torch's own cheap ranges are), else nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return contextlib.nullcontext()


def silu_mul(hu):
    """silu(gate) * up of a [gate | up] row."""
    gate, up = hu.chunk(2, -1)
    return torch.nn.functional.silu(gate) * up


class SwiGLU(nn.Module):
    """silu(x W_gate) * (x W_up) W_2 in `dtype`: w13 (dim, 2 * hidden) =
    [gate | up], w2 (hidden, dim), stored in `param_dtype`."""

    def __init__(self, dim, hidden, dtype, device, param_dtype=None):
        super().__init__()
        pd = param_dtype or dtype
        self.dtype = dtype
        self.w13 = nn.Parameter(torch.zeros((dim, 2 * hidden), dtype=pd,
                                            device=device))
        self.w2 = nn.Parameter(torch.zeros((hidden, dim), dtype=pd,
                                           device=device))

    def forward(self, x):
        hu = x.to(self.dtype) @ self.w13.to(self.dtype)
        return silu_mul(hu) @ self.w2.to(self.dtype)


class _Combine(torch.autograd.Function):
    """out (tokens, dim) f32 = sum over routes r of gate[r] * y[r] into
    row tok[r]; saves y in its own type, not the f32 products."""

    @staticmethod
    def forward(ctx, y, gate, tok, tokens):
        out = y.new_zeros((tokens, y.shape[1]), dtype=torch.float32)
        out.index_add_(0, tok, y.float() * gate[:, None])
        ctx.save_for_backward(y, gate, tok)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, gate, tok = ctx.saved_tensors
        picked = dout[tok]
        return ((picked * gate[:, None]).to(y.dtype),
                (picked * y.float()).sum(-1), None, None)


class HeldExperts(nn.Module):
    """DeepSeek-V3's MoE FFN as one expert-parallel rank holds it.

    router (dim, n_experts) f32, scoring every token over all
    `n_experts`: s = sigmoid(x W_r) in f32; the top `top_k` of s + bias
    (`bias`, the correction bias, a buffer) chosen, their s normalised
    (`norm_topk`) and times `scaling`.  This rank holds experts
    [expert_start, expert_start + n_local): w13 (n_local, dim,
    2 * hidden) = [gate | up] and w2 (n_local, hidden, dim), SwiGLU
    each, computed for exactly the routes that chose them (no capacity,
    nothing dropped) by a grouped matrix product over the held experts;
    the shared experts (`shared`, one SwiGLU of width `shared_hidden`)
    take every token.  Routes to experts held elsewhere add nothing
    here: on one card the layer runs without the exchange.

    Sizing the grouped product needs the number of held routes on the
    host: one synchronisation a forward.  After each forward `balance`
    holds the sequence-wise balance loss (DeepSeek-V3 eqs. 17-20) with
    its gradient, and the step's loads over every expert accumulate
    until `update_bias`.  `record`, when a list, gets each forward's
    choices ((tokens, top_k) int16).  `tally` counts on the device,
    with no synchronisation, the routes to held experts and the busiest
    held expert's routes, summed over forwards; `forwards` and `routes`
    count the forwards and all their routes."""

    def __init__(self, dim, hidden, shared_hidden, n_experts, n_local,
                 expert_start, top_k, scaling, norm_topk, dtype, device,
                 param_dtype=None):
        super().__init__()
        if not 0 <= expert_start <= n_experts - n_local or n_local < 1:
            raise ValueError(
                f"HeldExperts: experts [{expert_start}, "
                f"{expert_start + n_local}) are not among {n_experts}")
        if not 0 < top_k <= n_experts:
            raise ValueError(f"top_k {top_k} of {n_experts} experts")
        pd = param_dtype or dtype
        self.dtype = dtype
        self.n_experts, self.n_local = n_experts, n_local
        self.expert_start, self.top_k = expert_start, top_k
        self.scaling, self.norm_topk = scaling, norm_topk
        self.router = nn.Parameter(torch.zeros((dim, n_experts),
                                               device=device))
        self.w13 = nn.Parameter(torch.zeros((n_local, dim, 2 * hidden),
                                            dtype=pd, device=device))
        self.w2 = nn.Parameter(torch.zeros((n_local, hidden, dim), dtype=pd,
                                           device=device))
        self.shared = SwiGLU(dim, shared_hidden, dtype, device, pd)
        self.register_buffer("bias", torch.zeros(n_experts, device=device))
        self.load = torch.zeros(n_experts, device=device)
        self.tally = torch.zeros(2, dtype=torch.int64, device=device)
        self.balance = None
        self.record = None
        self.forwards = self.routes = 0

    def route(self, x, seqs):
        """(gates (tokens, top_k) f32 with their gradient, choices
        (tokens, top_k)) of x (tokens, dim); sets `balance` over `seqs`
        sequences and adds the loads."""
        E, K = self.n_experts, self.top_k
        scores = torch.sigmoid(x.float() @ self.router)
        choice = torch.topk(scores.detach() + self.bias, K, -1).indices
        w = scores.gather(1, choice)
        if self.norm_topk:
            w = w / w.sum(-1, keepdim=True)
        picks = torch.zeros_like(scores, dtype=torch.float32).scatter_(
            1, choice, 1.0)
        s = x.shape[0] // seqs
        f = picks.view(seqs, s, E).sum(1) * (E / (K * s))
        P = (scores / scores.sum(-1, keepdim=True)).view(seqs, s, E).mean(1)
        self.balance = (f * P).sum(-1).mean()
        self.load += picks.sum(0)
        return w * self.scaling, choice

    def forward(self, h):
        """h (seqs, seq, dim) -> (seqs, seq, dim) in h's type."""
        b, s, d = h.shape
        x = h.reshape(b * s, d)
        K, n_local = self.top_k, self.n_local
        self.forwards += 1
        self.routes += b * s * K
        with profiler_range("moe.route"):
            gates, choice = self.route(x, b)
            if self.record is not None:
                self.record.append(choice.to(torch.int16))
            local = choice - self.expert_start
            key = torch.where((local >= 0) & (local < n_local), local,
                              n_local).flatten()
            counts = torch.bincount(key, minlength=n_local + 1)[:n_local]
            offs = counts.cumsum(0).to(torch.int32)
            self.tally += torch.stack((offs[-1].long(), counts.max()))
            n = int(offs[-1])  # the layer's one host synchronisation
            order = torch.argsort(key, stable=True)[:n]
            tok = order // K
            gate = gates.reshape(-1)[order]
        with profiler_range("moe.experts"):
            hu = grouped_mm(x[tok], self.w13.to(self.dtype), offs)
            y = grouped_mm(silu_mul(hu), self.w2.to(self.dtype), offs)
        with profiler_range("moe.combine"):
            routed = _Combine.apply(y, gate, tok, b * s).to(h.dtype)
            out = routed + self.shared(x)
        return out.view(b, s, d)

    @torch.no_grad()
    def update_bias(self, gamma):
        """b_i += gamma * sign(mean load - load_i) over every expert, the
        loads since the last update; then the loads restart."""
        self.bias += gamma * torch.sign(self.load.mean() - self.load)
        self.load.zero_()
