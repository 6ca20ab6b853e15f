"""Fused softmax cross-entropy: hand-written CUDA kernels
(csrc/fused_xent.cu), forward and backward, and their plain PyTorch
version.

Replaces the Pallas TPU kernels container_engine_accelerators_tpu/
ops/fused_xent.py `_fwd_kernel` (:34, pallas_call :86) and `_bwd_kernel`
(:46, pallas_call :104); entries `fused_softmax_xent` (:66) and
`fused_cross_entropy_loss` (:119).

The loss is bound by the bytes of the logits: at the LM head (16384 x
32000 f32) one pass over them is 2.1 GB.  The forward kernel makes one
online max / sum-of-exp pass per row, reads the picked logit by index
and keeps the row's logsumexp; the backward reads that back and writes
(softmax - onehot) * g once, in the logits' type.  Neither materializes
a softmax or one-hot matrix.  A torch.autograd.Function ties the two
together.  The reference pads the classes to 128 lanes for the TPU's
tiles; the CUDA kernels take any class count.

The plain version is the same function in torch ops (logsumexp minus
the picked logit, differentiated by autograd).  The wrapper takes it
only for CPU tensors; on a CUDA tensor it launches the kernels or
raises.  Both keep the reference's contract that the row count is a
multiple of 8 (`build_lm_training`'s auto gate keys on it).
"""

from __future__ import annotations

import torch

from . import _build

ROW_BLOCK = 8  # the reference's f32 sublane tile: rows must divide by it
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def softmax_xent_plain(logits, labels):
    """Per-row logsumexp(logits) - logits[label] in f32; a label outside
    [0, C) picks 0, as the reference's one-hot compare does."""
    x = logits.float()
    c = x.shape[1]
    lab = labels.long()
    picked = x.gather(1, lab.clamp(0, c - 1)[:, None])[:, 0]
    valid = (lab >= 0) & (lab < c)
    return torch.logsumexp(x, dim=1) - torch.where(
        valid, picked, torch.zeros_like(picked)
    )


def _vec(logits) -> int:
    """1 when every row can be read 4 elements at a time."""
    c = logits.shape[1]
    return int(c % 4 == 0 and logits.data_ptr() % (4 * logits.element_size())
               == 0)


def _check(logits, labels):
    for t in (logits, labels):
        if not t.is_cuda or t.device != logits.device:
            raise ValueError(
                "fused_softmax_xent: the CUDA kernels take CUDA tensors on "
                "one device"
            )
    if logits.dtype not in _TYPES:
        raise ValueError(
            f"fused_softmax_xent: takes f32 or bf16 logits, got "
            f"{logits.dtype}"
        )
    if logits.ndim != 2 or not logits.is_contiguous():
        raise ValueError(
            "fused_softmax_xent: logits must be a contiguous (rows, C) "
            "tensor"
        )
    if labels.dtype != torch.int32 or labels.shape != logits.shape[:1] or (
        not labels.is_contiguous()
    ):
        raise ValueError(
            "fused_softmax_xent: the kernels take contiguous (rows,) int32 "
            "labels"
        )


def xent_fwd(logits, labels):
    """(loss, lse), each (rows,) f32, from the forward kernel.  labels:
    (rows,) int32 on the logits' device."""
    _check(logits, labels)
    rows, c = logits.shape
    loss = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    rc = _build.load("cea_xent_fwd")(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), _TYPES[logits.dtype], rows, c, _vec(logits),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(rc, "fused_softmax_xent forward")
    xent_fwd.launches += 1
    return loss, lse


def xent_bwd(logits, labels, lse, g):
    """(softmax(logits) - onehot(labels)) * g[:, None] in the logits'
    type, from the backward kernel; lse from xent_fwd."""
    _check(logits, labels)
    rows, c = logits.shape
    g = g.float().contiguous()
    grad = torch.empty_like(logits)
    rc = _build.load("cea_xent_bwd")(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        grad.data_ptr(), _TYPES[logits.dtype], rows, c, _vec(logits),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check(rc, "fused_softmax_xent backward")
    xent_bwd.launches += 1
    return grad


xent_fwd.launches = 0
xent_bwd.launches = 0


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        labels = labels.to(torch.int32).contiguous()
        loss, lse = xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return xent_bwd(logits, labels, lse, g), None


def fused_softmax_xent(logits, labels):
    """Per-sample softmax cross entropy.  logits [B, C] (f32 or bf16),
    labels [B] int -> loss [B] float32.  B must be a multiple of 8.  CPU
    tensors take the plain version; CUDA tensors launch the kernels or
    raise."""
    b = logits.shape[0]
    if b % ROW_BLOCK:
        raise ValueError(
            f"fused_softmax_xent needs rows ({b}) divisible by "
            f"{ROW_BLOCK}; pad the batch or use the XLA loss"
        )
    if logits.device.type == "cpu":
        return softmax_xent_plain(logits, labels)
    return _FusedXent.apply(logits, labels)


def fused_cross_entropy_loss(logits, labels):
    """Mean fused cross entropy (drop-in for ops.losses.cross_entropy_loss)."""
    return torch.mean(fused_softmax_xent(logits, labels))
