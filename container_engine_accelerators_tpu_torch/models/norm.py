"""Fused train-time BatchNorm(+ReLU) with an xhat-only residual, in
PyTorch: the port of container_engine_accelerators_tpu/models/norm.py
(`ema_update` :54, `_batch_stats` :66, the custom VJPs `_bn_act` :74-118
and `_bn_act_y` :135-175, `FusedBatchNormAct` :178).

Semantics are flax.linen.BatchNorm's, written out (torch's BatchNorm2d
differs on both counts): the running statistics are an EMA with momentum
0.9 on the OLD value, of the biased variance E[y^2] - E[y]^2 in f32;
parameters and statistics are f32, activations NHWC in the compute type.
The EMA runs outside autograd.

Training runs an autograd Function whose forward is the reference's fwd
rule (`_bn_act_fwd`): xhat is rounded to the activation type BEFORE the
affine, and xhat (residual "xhat") or y (residual "y") is the only
activation-sized tensor kept for the backward, whose ReLU mask is
gamma * xhat + beta > 0 in f32.  Without autograd (no_grad, or nothing
requiring a gradient) the primal runs, which does not round xhat, as
JAX evaluates the primal outside a derivative.

Under a data-parallel mesh (models/train.py) a norm's `groups` are the
mesh's axes: the statistics are those of the global batch, as GSPMD has
flax's BatchNorm take them.  Every rank holds as many rows (the
trainer's batch sharding), so the forward's moments E[y] and E[y^2] are
the ranks' mean of each rank's (`global_moments`), and the backward
all-reduces its two per-channel sums over a row count of this rank's
times the ranks; on a group of one rank both are the one-rank
arithmetic, bit for bit.  The scale and bias gradients stay this rank's
share, which the trainer sums.  The all-reduces go through
`psum_groups`, whose backward is the adjoint all-reduce, so the modules
that differentiate through the moments (the fused block,
models/fused_block.py, and flax's BatchNorm, resnet.py `BNAct`) get the
statistics' cross-rank gradient term too.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def ema_update(ra_mean, ra_var, mean, var, momentum):
    """The momentum EMA of the running statistics, in place, outside
    autograd."""
    with torch.no_grad():
        ra_mean.mul_(momentum).add_((1.0 - momentum) * mean.detach())
        ra_var.mul_(momentum).add_((1.0 - momentum) * var.detach())


def psum_groups(t, groups):
    """`t` summed over the ranks of each group in turn (all of a mesh's
    ranks, given world_groups); differentiable: its backward sums the
    cotangent likewise (parallel/_collectives.py `psum`), which carries
    the cross-rank term of a statistic's gradient."""
    from ..parallel._collectives import psum

    for g in groups:
        t = psum(t, g)
    return t


def group_size(groups) -> int:
    """The number of ranks that `groups` (a mesh's axes) span."""
    import torch.distributed as dist

    return math.prod(dist.get_world_size(g) for g in groups)


def global_moments(mean, ex2, groups):
    """Per-channel moments E[y] and E[y^2] of the global batch from this
    rank's (`mean`, `ex2`): their mean over the ranks of `groups`, as
    every rank holds the same number of rows (the trainer's batch
    sharding splits evenly or raises).  Unchanged without groups, and
    bitwise so on a group of one rank."""
    if not groups:
        return mean, ex2
    both = psum_groups(torch.cat([mean, ex2]), groups) / group_size(groups)
    return both[:mean.shape[0]], both[mean.shape[0]:]


def batch_stats(y, groups=()):
    """Per-channel (mean, biased variance) in f32 over every axis but the
    last: E[y^2] - E[y]^2, as the reference computes it; over the global
    batch of the ranks of `groups` when given."""
    yf = y.float()
    axes = tuple(range(y.ndim - 1))
    mean, ex2 = global_moments(yf.mean(axes), (yf * yf).mean(axes), groups)
    return mean, ex2 - mean * mean


def _bn_act_primal(y, gamma, beta, eps, act, residual, groups=()):
    mean, var = batch_stats(y, groups)
    inv = torch.rsqrt(var + eps)
    if residual == "y":
        z = (y.float() - mean) * inv * gamma + beta
    else:
        z = gamma * ((y.float() - mean) * inv) + beta
    if act:
        z = torch.relu(z)
    return z.to(y.dtype), mean, var


def _bn_act_backward(xf, dz, gamma, beta, inv, act, groups=()):
    dzf = dz.float()
    dp = torch.where(gamma * xf + beta > 0.0, dzf, 0.0) if act else dzf
    axes = tuple(range(xf.ndim - 1))
    m = xf.numel() // xf.shape[-1]
    dbeta = dp.sum(axes)
    dgamma = (dp * xf).sum(axes)
    sum_b, sum_g = dbeta, dgamma
    if groups:  # the global batch's sums and rows (as many on every rank)
        c = xf.shape[-1]
        both = psum_groups(torch.cat([dbeta, dgamma]), groups)
        sum_b, sum_g, m = both[:c], both[c:], m * group_size(groups)
    dy = (gamma * inv) * (dp - (sum_b + xf * sum_g) * (1.0 / m))
    return dy, dgamma, dbeta


class _BnAct(torch.autograd.Function):
    """_bn_act (xhat residual) with its custom VJP."""

    @staticmethod
    def forward(ctx, y, gamma, beta, eps, act, groups):
        mean, var = batch_stats(y, groups)
        inv = torch.rsqrt(var + eps)
        # xhat in the compute type is the ONLY activation-sized residual.
        xhat = ((y.float() - mean) * inv).to(y.dtype)
        z = gamma * xhat.float() + beta
        if act:
            z = torch.relu(z)
        ctx.act, ctx.groups = act, groups
        ctx.save_for_backward(xhat, gamma, beta, inv)
        ctx.mark_non_differentiable(mean, var)
        return z.to(y.dtype), mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        xhat, gamma, beta, inv = ctx.saved_tensors
        dy, dgamma, dbeta = _bn_act_backward(
            xhat.float(), dz, gamma, beta, inv, ctx.act, ctx.groups)
        return dy.to(xhat.dtype), dgamma, dbeta, None, None, None


class _BnActY(torch.autograd.Function):
    """_bn_act_y (y residual, xhat recomputed in f32) with its VJP."""

    @staticmethod
    def forward(ctx, y, gamma, beta, eps, act, groups):
        mean, var = batch_stats(y, groups)
        inv = torch.rsqrt(var + eps)
        z = (y.float() - mean) * inv * gamma + beta
        if act:
            z = torch.relu(z)
        ctx.act, ctx.groups = act, groups
        ctx.save_for_backward(y, gamma, beta, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return z.to(y.dtype), mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        y, gamma, beta, mean, inv = ctx.saved_tensors
        xf = (y.float() - mean) * inv
        dy, dgamma, dbeta = _bn_act_backward(
            xf, dz, gamma, beta, inv, ctx.act, ctx.groups)
        return dy.to(y.dtype), dgamma, dbeta, None, None, None


def bn_act(y, gamma, beta, eps, act, residual="xhat", groups=()):
    """(z, mean, var) of the fused train-time BatchNorm(+ReLU): the
    autograd Function when a gradient is wanted, else the primal;
    global statistics over `groups` when given."""
    groups = tuple(groups)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (y, gamma, beta)
    ):
        fn = _BnActY if residual == "y" else _BnAct
        return fn.apply(y, gamma, beta, eps, act, groups)
    return _bn_act_primal(y, gamma, beta, eps, act, residual, groups)


class FusedBatchNormAct(nn.Module):
    """Train/eval BatchNorm with optional fused ReLU over the last axis.

    Parameters `scale` and `bias` (f32) and buffers `mean` and `var` (f32,
    the running statistics) carry flax's names.  forward(x, train):
    train uses the batch statistics and updates the running ones; eval
    normalizes with the running statistics and returns `dtype`."""

    flax_class = "FusedBatchNormAct"

    def __init__(self, features, act=False, momentum=0.9, epsilon=1e-5,
                 dtype=torch.bfloat16, zero_scale=False, residual="xhat"):
        super().__init__()
        if residual not in ("xhat", "y"):
            raise ValueError(f"unknown residual {residual!r}")
        self.act, self.momentum, self.epsilon = act, momentum, epsilon
        self.dtype, self.residual = dtype, residual
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.groups = ()  # a data-parallel mesh's axes: global statistics

    def forward(self, x, train=True):
        if not train:
            inv = torch.rsqrt(self.var + self.epsilon)
            z = (x.float() - self.mean) * inv * self.scale + self.bias
            if self.act:
                z = torch.relu(z)
            return z.to(self.dtype)
        z, mean, var = bn_act(x, self.scale, self.bias, self.epsilon,
                              self.act, self.residual, self.groups)
        ema_update(self.mean, self.var, mean, var, self.momentum)
        return z
