"""The port's chunked vocab head + cross-entropy (container_engine_
accelerators_tpu_torch/ops/chunked_xent.py) against the reference's
`chunked_softmax_xent` on the same numpy-drawn hidden rows, head kernel,
bias and labels: the mean loss and its gradients dX, dW and db, at a
chunk that divides the vocab, one that does not (a short last chunk in
the port, a -1e30-padded one in the reference), and one chunk as wide as
the vocab; with f32 and bf16 hidden rows; and against the dense f32 head
with the log-softmax loss.

Tolerances: 1e-5 relative to the largest magnitude of each quantity (both
sides compute in f32 and differ only in the order of their sums: the
matmuls, the per-chunk exponential sums and the gradients' row sums);
dX of bf16 rows, which both sides round once to bf16, one bf16 ulp of
max|dX| (2**-8 relative), where the f32 values straddle a rounding
edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import chunked_xent as JC
from container_engine_accelerators_tpu_torch.ops import chunked_xent as TC
from container_engine_accelerators_tpu_torch.ops import losses as TL

N, D, V = 24, 16, 200
REL = 1e-5


def _case(seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    kernel = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(V)).astype(np.float32)
    labels = rng.integers(0, V, size=(N,)).astype(np.int32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
            jnp.float32))
    return x, kernel, bias, labels


def _jax(x, kernel, bias, labels, chunk, dtype):
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32)
    loss, grads = jax.value_and_grad(
        lambda a, w, b: JC.chunked_softmax_xent(
            a, w, b, jnp.asarray(labels), chunk_size=chunk),
        argnums=(0, 1, 2),
    )(jx, jnp.asarray(kernel), jnp.asarray(bias))
    return float(loss), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port(x, kernel, bias, labels, chunk, dtype):
    tx = torch.from_numpy(x).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32
    ).requires_grad_(True)
    tw, tb = (torch.from_numpy(a).requires_grad_(True)
              for a in (kernel, bias))
    loss = TC.chunked_softmax_xent(tx, tw, tb, torch.from_numpy(labels),
                                   chunk_size=chunk)
    loss.backward()
    assert tx.grad.dtype == tx.dtype
    return float(loss.detach()), [t.grad.float().numpy()
                                  for t in (tx, tw, tb)]


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("chunk", [50, 64, V])  # divides, does not, one
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_and_gradients_match_reference(chunk, dtype):
    case = _case(chunk, dtype)
    j_loss, j_grads = _jax(*case, chunk, dtype)
    t_loss, t_grads = _port(*case, chunk, dtype)
    assert abs(t_loss - j_loss) <= REL * abs(j_loss)
    for name, got, want in zip(("dx", "dw", "db"), t_grads, j_grads):
        rel = 2.0 ** -8 if (name == "dx" and dtype == "bf16") else REL
        _close(got, want, rel)


def test_matches_dense_head_and_log_softmax_loss():
    x, kernel, bias, labels = _case(7, "f32")
    t_loss, t_grads = _port(x, kernel, bias, labels, 64, "f32")
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, kernel, bias))
    dense = TL.cross_entropy_loss(tx @ tw + tb, torch.from_numpy(labels))
    dense.backward()
    assert abs(t_loss - float(dense)) <= REL * abs(float(dense))
    for got, t in zip(t_grads, (tx, tw, tb)):
        _close(got, t.grad.numpy(), REL)


def test_chunk_size_must_be_positive():
    x = torch.zeros((2, D))
    with pytest.raises(ValueError, match="positive"):
        TC.chunked_softmax_xent(x, torch.zeros((D, V)), torch.zeros(V),
                                torch.zeros(2, dtype=torch.long), 0)
