"""Pipeline parallelism: GPipe microbatches over one mesh axis, with the
interleaved (virtual-stage) schedule, the port of
container_engine_accelerators_tpu/parallel/pipeline.py
(`chunk_shard_order` :56, `bubble_fraction` :70, `pipeline_apply` :81,
`pipeline_sharded` :181).

Rank d holds n_virtual chunks of the layer stack; chunk c there is
virtual stage c * S + d.  At tick t rank d applies chunk
clip((t - d) // M, 0, V - 1) to microbatch (t - d) mod M, taking virtual
stage 0's input from the microbatches and every other's from its left
neighbour's handoff (interleaved: from an M-slot bank, where chunk
boundaries wait M - S ticks).  The schedule is the reference's tick for
tick, with its masks as tensors, so every rank builds the same autograd
graph: outside a rank's live window its output is zeroed before it is
sent, and bubble-tick arrivals are zeros that no live tick reads.
Handoffs are ppermutes that also carry a scalar token from the one
before, and the last token joins the result: every exchange is then
reachable from the loss on every rank, and the backward runs them in
reverse tick order everywhere (a banked arrival is read ticks later or
never, and without the token two ranks could skip, or order
differently, an exchange's backward, and deadlock).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import _collectives as C


def chunk_shard_order(n_stages: int, n_virtual: int):
    """Shard slot d * V + c (rank d's c-th chunk) holds virtual stage
    c * S + d: the virtual stage of each slot, in slot order."""
    return [c * n_stages + d for d in range(n_stages)
            for c in range(n_virtual)]


def bubble_fraction(n_stages: int, n_micro: int, n_virtual: int = 1) -> float:
    """(S - 1) / (V * M + S - 1): the idle share of the schedule's
    stage-ticks, forward and backward alike."""
    return (n_stages - 1) / (n_virtual * n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable, stage_params: Sequence,
                   microbatches: torch.Tensor, group, n_virtual: int = 1):
    """This rank's half of the pipeline.  stage_fn(params, x) -> y of
    x's shape; stage_params: this rank's n_virtual chunks, chunk c being
    virtual stage c * S + d; microbatches (M, mb, ...), the same on
    every rank (only virtual stage 0 reads them).  Returns (M, mb, ...):
    the final stage's outputs on the last rank, zeros elsewhere."""
    n_stages, my_stage = C.axis_size(group), C.axis_index(group)
    n_micro = microbatches.shape[0]
    V = int(n_virtual)
    if V < 1:
        raise ValueError(f"n_virtual must be >= 1, got {V}")
    if V > 1 and n_micro < n_stages:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) >= "
            f"n_stages ({n_stages})"
        )
    if len(stage_params) != V:
        raise ValueError(f"{len(stage_params)} chunks for n_virtual {V}")
    dev, dtype = microbatches.device, microbatches.dtype
    mb_shape = microbatches.shape[1:]

    def flag(b: bool):
        return torch.tensor(bool(b), device=dev)

    zero = torch.zeros(mb_shape, dtype=dtype, device=dev)
    out = [zero] * n_micro
    bank = [zero] * n_micro
    x_recv, token = zero, torch.zeros((), device=dev)
    prev_stage = (my_stage - 1) % n_stages
    for t in range(V * n_micro + n_stages - 1):
        if V > 1:
            bank[(t - 1 - prev_stage) % n_micro] = x_recv
        q = t - my_stage
        c = min(max(q // n_micro, 0), V - 1)
        m = q % n_micro
        handoff = x_recv if V == 1 else bank[m]
        x_in = torch.where(flag(my_stage == 0 and c == 0),
                           microbatches[m].to(dtype), handoff)
        y = stage_fn(stage_params[c], x_in)
        live = 0 <= q < V * n_micro
        y = torch.where(flag(live), y, 0)
        is_last = my_stage == n_stages - 1 and c == V - 1
        out[m] = out[m] + torch.where(flag(live and is_last), y, 0)
        x_recv, token = C.ppermute([y, token], group, 1)
    # The last token joins the result (times zero), so every exchange
    # is reachable from the loss on every rank: a rank whose late
    # arrivals are never read would otherwise skip their backward
    # while its neighbour waits in it.
    return torch.stack(out) + 0 * token.to(dtype)


def pipeline_sharded(stage_fn: Callable, stacked_params: Sequence,
                     microbatches: torch.Tensor, mesh, axis_name: str,
                     n_virtual: int = 1):
    """pipeline_apply over `axis_name` of `mesh`: stacked_params holds
    all S * V chunks in shard order (chunk_shard_order), of which this
    rank runs its own; the outputs are psum'd over the axis, so every
    rank holds them."""
    from .mesh import axis_len

    n_stages = axis_len(mesh, axis_name)
    want = n_stages * int(n_virtual)
    if len(stacked_params) != want:
        raise ValueError(
            f"stacked_params has {len(stacked_params)} chunks, not "
            f"{n_stages} pipeline stages * {n_virtual} virtual chunks "
            f"(axis {axis_name!r})"
        )
    group = mesh.get_group(axis_name)
    d = C.axis_index(group)
    out = pipeline_apply(stage_fn, stacked_params[d * n_virtual:
                                                  (d + 1) * n_virtual],
                         microbatches, group, n_virtual=n_virtual)
    return C.psum(out, group)
