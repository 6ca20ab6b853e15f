"""The port's int8 weight-only matmul (container_engine_accelerators_tpu_
torch/ops/quant_matmul.py) against the reference: quantize_weight is
bit-equal, and the plain matmul matches the reference's
int8_weight_matmul (its CPU fallback, as the reference suite runs it)
for bf16 and f32 activations.  The CUDA kernel is held against the
plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # caps torch's CPU threads
from container_engine_accelerators_tpu.ops import quant_matmul as QM
from container_engine_accelerators_tpu_torch.ops import (
    quant_matmul as TQM,
)


def _weight(seed, din, dout):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 scale floor
    return w / np.sqrt(din)


@pytest.mark.parametrize("shape", [(32, 96), (128, 64), (256, 520)])
def test_quantize_weight_bit_equal(shape):
    w = _weight(0, *shape)
    ji8, js = QM.quantize_weight(jnp.asarray(w))
    ti8, ts = TQM.quantize_weight(torch.from_numpy(w))
    assert ti8.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(ti8.numpy(), np.asarray(ji8))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


@pytest.mark.parametrize("rows", [1, 3, 16])
def test_plain_matches_reference_f32(rows):
    w = _weight(1, 64, 96)
    x = np.random.default_rng(2).standard_normal((rows, 64)).astype(
        np.float32
    )
    ji8, js = QM.quantize_weight(jnp.asarray(w))
    ref = np.asarray(QM.int8_weight_matmul(jnp.asarray(x), ji8, js))
    got = TQM.int8_weight_matmul(
        torch.from_numpy(x), torch.from_numpy(np.array(ji8)),
        torch.from_numpy(np.array(js)),
    )
    assert got.dtype == torch.float32
    # f32 sums of 64 products in another order.
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 16])
def test_plain_matches_reference_bf16(rows):
    w = _weight(3, 64, 96)
    x = np.random.default_rng(4).standard_normal((rows, 64)).astype(
        np.float32
    )
    ji8, js = QM.quantize_weight(jnp.asarray(w))
    ref = QM.int8_weight_matmul(jnp.asarray(x, jnp.bfloat16), ji8, js)
    got = TQM.int8_weight_matmul(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(np.array(ji8)),
        torch.from_numpy(np.array(js)),
    )
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    # Both accumulate bf16 products in f32 and round once to bf16: at
    # most one bf16 ulp (2**-8 relative) apart.
    np.testing.assert_allclose(
        got.float().numpy(), ref, rtol=2 ** -8, atol=1e-6
    )


@pytest.mark.parametrize(
    "rows,din,dout",
    [(16, 1024, 3072), (16, 1024, 1024), (16, 1024, 4096),
     (16, 4096, 1024), (16, 1024, 32000), (1, 1024, 32000), (3, 40, 64)],
)
@pytest.mark.parametrize("sms", _torch_port.H100_SMS)
def test_split_plan_covers_in_dim(rows, din, dout, sms):
    # The kernel's first pass: every weight row lands in exactly one
    # slice, slices fit the block's shared-memory staging (<= 256 rows,
    # a multiple of the 8 warps), and no slice is empty.
    ksplit, krange = TQM.split_plan(rows, din, dout, sms)
    assert krange <= 256 and krange % 8 == 0
    assert ksplit * krange >= din > (ksplit - 1) * krange


def test_cuda_path_raises_on_non_cuda_tensor():
    w = torch.zeros((64, 96), dtype=torch.int8, device="meta")
    x = torch.zeros((2, 64), device="meta")
    s = torch.zeros((96,), device="meta")
    before = TQM.int8_weight_matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        TQM.int8_weight_matmul(x, w, s)
    assert TQM.int8_weight_matmul.launches == before


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="in_dim"):
        TQM.int8_weight_matmul(
            torch.zeros((2, 8)), torch.zeros((9, 8), dtype=torch.int8),
            torch.ones(8),
        )
