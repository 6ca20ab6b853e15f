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
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _collectives as C
from ..models.transformer import gelu_tanh


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
