"""Collectives with gradients over one mesh axis (a torch.distributed
process group), the port's counterparts of the reference's lax.psum,
lax.pmean, lax.pmax, lax.all_to_all and lax.ppermute inside shard_map.

The port runs one program per rank, and a rank's backward is the
gradient of the SUM of every rank's objective: each Function's backward
is the adjoint of its forward (psum's is psum, all_to_all's the reverse
exchange, ppermute's the reverse permutation, a tiled all-gather's the
reduce-scatter of its cotangent).  A trainer therefore backpropagates
its local loss divided by the world size, so that the ranks' objectives
sum to the reference's global loss, and then sums each replicated
parameter's gradient over the axes it is replicated on (`reduce_grads`).

On an axis of size 1 ppermute is the identity and sends nothing (torch
refuses a send to the sending rank); that is the reference's semantics
there.  Every other collective runs on the group whatever its size.
Gloo serves the CPU tests and NCCL the cards; sends and receives of one
exchange are paired in one batch_isend_irecv, or gloo deadlocks.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def axis_size(group) -> int:
    return dist.get_world_size(group)


def axis_index(group) -> int:
    return dist.get_rank(group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return None, g


def psum(x, group):
    """lax.psum: the sum over the axis, on every rank."""
    return _PSum.apply(group, x)


def pmean(x, group):
    """lax.pmean."""
    return psum(x, group) / axis_size(group)


def pmax(x, group):
    """lax.pmax of a value that takes no gradient (the softmax shift of
    a sharded logsumexp)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _all_to_all(x, group):
    # Both buffers contiguous: empty_like would keep a permuted view's
    # strides, and the collective writes the raw buffer.
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _all_to_all(g, ctx.group)


def all_to_all(x, group):
    """lax.all_to_all(x, axis, 0, 0, tiled=False) for x (axis_size,
    ...): slice i goes to rank i, and slice j of the result came from
    rank j."""
    if x.shape[0] != axis_size(group):
        raise ValueError(
            f"all_to_all: leading dim {x.shape[0]} != axis size "
            f"{axis_size(group)}"
        )
    return _AllToAll.apply(group, x)


def _exchange(xs: Sequence[torch.Tensor], group, shift: int):
    n, me = axis_size(group), axis_index(group)
    ranks = dist.get_process_group_ranks(group)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x, memory_format=torch.contiguous_format)
            for x in xs]
    ops = []
    for tag, (x, o) in enumerate(zip(xs, outs)):
        ops.append(dist.P2POp(dist.isend, x, dst, group, tag))
        ops.append(dist.P2POp(dist.irecv, o, src, group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        return tuple(_exchange(xs, group, shift))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_exchange(gs, ctx.group, -ctx.shift))


def ppermute(xs: Sequence[torch.Tensor], group, shift: int = 1):
    """lax.ppermute with perm [(p, (p + shift) % n)] over the axis, on
    several tensors in one exchange: each goes to rank + shift and the
    result is what rank - shift sent.  Identity on an axis of size 1."""
    xs = list(xs)
    if axis_size(group) == 1:
        return xs
    return list(_PPermute.apply(group, shift, *xs))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        x = x.contiguous()
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(axis_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        mine = g.chunk(axis_size(ctx.group), ctx.dim)[axis_index(ctx.group)]
        return None, None, mine.contiguous()


def all_gather(x, group, dim: int = 0):
    """The axis's shards of a tensor concatenated along `dim` in rank
    order (lax.all_gather(..., tiled=True)), on every rank."""
    return _AllGather.apply(group, dim, x)


BUCKET_BYTES = 25 * 2**20


def _buckets(grads, limit: int):
    bucket, size = [], 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and size + nbytes > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        yield bucket


def reduce_grads(params_groups: Iterable, bucket_bytes: int = BUCKET_BYTES
                 ) -> None:
    """Sum each parameter's gradient over the groups it is replicated
    on: params_groups yields (parameter, [group, ...]).  The gradients
    that share their groups and dtype are flattened into buckets of at
    most `bucket_bytes` (DDP's default size), and each bucket is
    all-reduced once over each group, after the whole backward."""
    by_key = {}
    for p, groups in params_groups:
        if p.grad is not None and groups:
            key = (tuple(groups), p.grad.dtype, p.grad.device)
            by_key.setdefault(key, []).append(p.grad)
    for (groups, _, _), grads in by_key.items():
        for bucket in _buckets(grads, bucket_bytes):
            flat = _flatten_dense_tensors(bucket)
            for g in groups:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g)
            for t, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                t.copy_(r)
