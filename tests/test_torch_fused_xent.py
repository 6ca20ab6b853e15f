"""The port's fused softmax cross-entropy (container_engine_accelerators_
tpu_torch/ops/fused_xent.py, its plain path on the CPU) against the
reference's Pallas kernel run in interpret mode, on the same numpy-drawn
logits and labels: per-row loss, mean loss and the gradient of the mean,
at 128, 1000 and 32000 classes with bf16 and f32 logits; and the
reference's rows % 8 contract.

Tolerances: f32 logits, 1e-5 relative to the largest loss (both sum
exp(x - max) in f32 over up to 32000 terms, in another order) and 1e-7
absolute on the gradient (whose entries are at most 1 / rows); bf16
logits, the same, since both cast the bf16 logits to f32 first and round
only the gradient to bf16, where they may differ by one bf16 ulp of
max|grad| (2**-8 relative) when the f32 values straddle a rounding
edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import fused_xent as JX
from container_engine_accelerators_tpu.ops import losses as JL
from container_engine_accelerators_tpu_torch.ops import fused_xent as TX
from container_engine_accelerators_tpu_torch.ops import losses as TL

ROWS = 16


def _case(seed, c, rows=ROWS):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((rows, c))).astype(np.float32)
    labels = rng.integers(0, c, size=(rows,)).astype(np.int32)
    return logits, labels


def _jax(logits, labels, dtype):
    x = jnp.asarray(logits).astype(dtype)
    lab = jnp.asarray(labels)
    per_row = JX.fused_softmax_xent(x, lab, True)
    mean, grad = jax.value_and_grad(
        lambda z: JX.fused_cross_entropy_loss(z, lab, True)
    )(x)
    return (np.asarray(per_row), float(mean),
            np.asarray(grad.astype(jnp.float32)))


def _port(logits, labels, dtype):
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    lab = torch.from_numpy(labels)
    per_row = TX.fused_softmax_xent(x.detach(), lab)
    mean = TX.fused_cross_entropy_loss(x, lab)
    mean.backward()
    assert x.grad.dtype == dtype
    return per_row.numpy(), float(mean.detach()), x.grad.float().numpy()


@pytest.mark.parametrize("c", [128, 1000, 32000])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_matches_reference(c, dtype):
    jdt, tdt = {
        "bf16": (jnp.bfloat16, torch.bfloat16),
        "f32": (jnp.float32, torch.float32),
    }[dtype]
    logits, labels = _case(c, c)
    j_rows, j_mean, j_grad = _jax(logits, labels, jdt)
    t_rows, t_mean, t_grad = _port(logits, labels, tdt)
    assert t_rows.dtype == np.float32
    tol = 1e-5 * np.abs(j_rows).max()
    np.testing.assert_allclose(t_rows, j_rows, rtol=0, atol=tol)
    assert abs(t_mean - j_mean) <= tol
    g_tol = 1e-7 if dtype == "f32" else 2.0 ** -8 * np.abs(j_grad).max()
    np.testing.assert_allclose(t_grad, j_grad, rtol=0, atol=g_tol)


def test_mean_equals_the_xla_loss():
    # The fused loss and the loss_impl="xla" path are one function.
    logits, labels = _case(7, 1000)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    fused = float(TX.fused_cross_entropy_loss(x, lab))
    xla = float(TL.cross_entropy_loss(x, lab))
    assert abs(fused - xla) <= 1e-5 * abs(xla)


def test_label_outside_classes_picks_zero():
    # The reference's one-hot compare picks nothing for such a label:
    # the row's loss is its logsumexp.
    logits, labels = _case(3, 128, rows=8)
    labels[2], labels[5] = -1, 128
    j = np.asarray(JX.fused_softmax_xent(
        jnp.asarray(logits), jnp.asarray(labels), True))
    t = TX.fused_softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_rows_not_divisible_by_8_raise_like_the_reference():
    logits = np.zeros((12, 32), np.float32)
    labels = np.zeros((12,), np.int32)
    with pytest.raises(ValueError, match="divisible") as ref:
        JX.fused_softmax_xent(jnp.asarray(logits), jnp.asarray(labels), True)
    with pytest.raises(ValueError, match="divisible") as port:
        TX.fused_softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    assert str(port.value) == str(ref.value)


def test_onehot_matches_reference():
    labels = np.array([0, 3, 9, -1, 10], np.int32)
    np.testing.assert_array_equal(
        TL.onehot(torch.from_numpy(labels), 10).numpy(),
        np.asarray(JL.onehot(jnp.asarray(labels), 10)),
    )


def test_cuda_wrappers_refuse_cpu_tensors():
    # The kernel wrappers never compute on the CPU: only
    # fused_softmax_xent chooses the plain version, by device.
    x = torch.zeros((8, 128))
    lab = torch.zeros((8,), dtype=torch.int32)
    before = (TX.xent_fwd.launches, TX.xent_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        TX.xent_fwd(x, lab)
    with pytest.raises(ValueError, match="CUDA"):
        TX.xent_bwd(x, lab, torch.zeros(8), torch.ones(8))
    assert (TX.xent_fwd.launches, TX.xent_bwd.launches) == before
