"""Loss ops: the port of container_engine_accelerators_tpu/ops/losses.py
(`onehot` :11, `cross_entropy_loss` :15).

`cross_entropy_loss` is the trainer's `loss_impl="xla"` path, left to
torch ops as the reference leaves it to XLA, and the plain yardstick of
the fused loss (ops/fused_xent.py)."""

from __future__ import annotations

import torch


def onehot(labels, num_classes: int, dtype=torch.float32):
    """(..., num_classes) one-hot rows; a label outside [0, num_classes)
    gives a zero row, as jax.nn.one_hot does."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy.  logits [B, C] float32, labels [B]
    int."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    return nll.mean()
