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
def test_qmm_plan_covers_in_dim_once(rows, din, dout, sms):
    # The kernel's cluster along `in`: block y of a column tile covers
    # weight rows [y * krange, (y + 1) * krange) of in_dim, so every row
    # lands in exactly one block, no block is empty, the cluster holds
    # 1-8 blocks and krange whole 64-row stages.
    xdt = torch.float32 if dout == 32000 else torch.bfloat16  # the head
    ks, krange = TQM.qmm_plan(rows, din, dout, sms, xdt)
    assert 1 <= ks <= 8
    assert krange % 64 == 0
    covered = np.zeros(din, np.int64)
    for y in range(ks):
        covered[y * krange:(y + 1) * krange] += 1
        assert y * krange < din
    assert (covered == 1).all()


def test_f32_three_part_split_matches_reference():
    # The kernel's f32-x path: x = hi + mid + lo in bf16, three products
    # with the int8 weight (each exact in f32) into one f32 sum, the
    # scale after the sum.  Emulated in plain torch at the vocab head's
    # shape cut to out 2048, held to the reference's f32 matmul within
    # the card check's limit, 1e-4 x max|out|.
    w = _weight(5, 1024, 2048)
    x = np.random.default_rng(6).standard_normal((16, 1024)).astype(
        np.float32
    )
    ji8, js = QM.quantize_weight(jnp.asarray(w))
    ref = np.asarray(QM.int8_weight_matmul(jnp.asarray(x), ji8, js))
    parts = TQM.split_bf16x3(torch.from_numpy(x))
    assert all(p.dtype == torch.bfloat16 for p in parts)
    w8 = torch.from_numpy(np.array(ji8)).double()
    acc = sum(p.double() @ w8 for p in parts).float()
    got = (acc * torch.from_numpy(np.array(js))).numpy()
    limit = 1e-4 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= limit
    # The parts carry x to f32's 24 bits.
    rebuilt = sum(p.double() for p in parts)
    assert (rebuilt - torch.from_numpy(x).double()).abs().max() <= (
        2.0 ** -23 * np.abs(x).max()
    )


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
