"""Chunked vocab head + softmax cross-entropy: the LM loss without the
(tokens, vocab) logits, the port of container_engine_accelerators_tpu/
ops/chunked_xent.py (`chunked_softmax_xent` :33).

The reference is pure JAX (a `lax.scan` over vocab chunks with an
online logsumexp under `jax.checkpoint`, no Pallas kernel), so the port
is torch ops, not a kernel: a `torch.autograd.Function` whose forward
streams the head matmul over vocab chunks (the running row max, the
rescaled sum of exponentials and the label's logit) and saves only the
row logsumexp, and whose backward recomputes each chunk's logits from x
and that logsumexp, turns them into (softmax - onehot) * g / N in place,
and accumulates dX and writes the chunk's columns of dW and db.  Peak
memory beyond the inputs and the gradients is one (N, chunk) f32 block,
never (N, V): at lm_large's 4096 rows and vocab 32000 that is 134 MB a
chunk of 8192 where the dense head's logits are 524 MB.

Numerics are the reference's: x and the kernel in f32 (TF32 is off for
the port's f32 head), so the loss and gradients equal the dense f32
head's up to the order of the sums.  A vocab that the chunk does not
divide ends in a short chunk, which gives what the reference's
-1e30-padded tail gives (the padded columns add exp(-inf) = 0).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _chunks(v: int, chunk_size: int):
    c = int(min(chunk_size, v))
    return [(off, min(c, v - off)) for off in range(0, v, c)]


def _logits(x32, kernel, bias, off, width):
    w = kernel[:, off:off + width].float()
    return torch.addmm(bias[off:off + width].float(), x32, w)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, labels, chunk_size):
        n = x.shape[0]
        x32 = x.float()
        labels = labels.long()
        rows = torch.arange(n, device=x.device)
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        picked = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for off, width in _chunks(kernel.shape[1], chunk_size):
            logits = _logits(x32, kernel, bias, off, width)
            local = labels - off
            in_chunk = (local >= 0) & (local < width)
            pick = logits[rows, local.clamp(0, width - 1)]
            picked += torch.where(in_chunk, pick, 0.0)
            new_m = torch.maximum(m, logits.amax(-1))
            # exp(logits - new_m) in place: the block is not needed after.
            s = s * torch.exp(m - new_m) + logits.sub_(new_m[:, None]).exp_(
            ).sum(-1)
            m = new_m
        lse = torch.log(s) + m
        ctx.save_for_backward(x, kernel, bias, labels, lse)
        ctx.chunk_size = chunk_size
        return torch.mean(lse - picked)

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias, labels, lse = ctx.saved_tensors
        n = x.shape[0]
        x32 = x.float()
        rows = torch.arange(n, device=x.device)
        scale = g.float() / n
        dx = torch.zeros_like(x32)
        dw = torch.empty(kernel.shape, dtype=torch.float32,
                         device=kernel.device)
        db = torch.empty(bias.shape, dtype=torch.float32, device=bias.device)
        for off, width in _chunks(kernel.shape[1], ctx.chunk_size):
            # softmax - onehot, times g / N, in the logits' own block.
            p = _logits(x32, kernel, bias, off, width)
            p.sub_(lse[:, None]).exp_()
            local = labels - off
            hit = ((local >= 0) & (local < width)).float()
            p[rows, local.clamp(0, width - 1)] -= hit
            p.mul_(scale)
            w = kernel[:, off:off + width].float()
            dx.addmm_(p, w.t())
            dw[:, off:off + width] = x32.t() @ p
            db[off:off + width] = p.sum(0)
        return (dx.to(x.dtype), dw.to(kernel.dtype), db.to(bias.dtype), None,
                None)


def chunked_softmax_xent(x, kernel, bias, labels, chunk_size: int = 8192):
    """Mean cross-entropy of softmax(x @ kernel + bias) against labels.

    x: (N, D) any float dtype; kernel: (D, V); bias: (V,); labels: (N,)
    int.  Equal to the dense f32 head and log-softmax loss, at one
    (N, chunk_size) f32 block of memory instead of (N, V)."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return _ChunkedXent.apply(x, kernel, bias, labels, chunk_size)
