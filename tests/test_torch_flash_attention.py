"""The port's causal flash attention (container_engine_accelerators_tpu_
torch/ops/flash_attention.py, its plain path on the CPU) against the
reference's `full_causal_attention` — the reference's own tests hold
flash through that dense math on the CPU, since the stock Pallas TPU
kernel has no interpret mode — on the same numpy-drawn q, k, v: the
output and the q / k / v gradients of a numpy-drawn cotangent, at seq
128 and 256 and head dims 32, 64, 96, 128 and 256 (the CUDA kernels'
instances are 64, 128 and 256; 32 and 96 run the next one up with
zero-filled columns), in f32 and bf16.  Also the `flash_supports_seq`
truth table over 1..4096 and the length errors, against the
reference's, and the kernels' head-dim rule by name and their rule for
v's width (equal to q's, or the (192, 128) pair of latent attention).

Tolerances: f32, 1e-5 absolute (scores and softmax in f32 in both, sums
in another order); bf16, one bf16 ulp of max|out| (both compute in f32
from the same bf16 inputs and round once to bf16, so they differ only
where the f32 values straddle a rounding edge)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import transformer as T
from container_engine_accelerators_tpu.ops import flash_attention as JF
from container_engine_accelerators_tpu_torch.ops import (
    flash_attention as TF,
)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def _case(seed, s, b=2, h=2, d=32):
    rng = np.random.default_rng(seed)
    q, k, v, g = (
        rng.standard_normal((b, s, h, d)).astype(np.float32)
        for _ in range(4)
    )
    return q, k, v, g


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_forward_and_gradients_match_reference(s, dtype, d):
    jdt, tdt = {
        "f32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16),
    }[dtype]
    q, k, v, g = _case(s + d, s, d=d)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    j_out, vjp = jax.vjp(T.full_causal_attention, jq, jk, jv)
    j_grads = vjp(jnp.asarray(g).astype(jdt))
    tq, tk, tv = (
        torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)
    )
    t_out = TF.flash_causal_attention(tq, tk, tv)
    t_out.backward(torch.from_numpy(g).to(tdt))
    assert t_out.dtype == tdt
    pairs = [(t_out, j_out)] + [
        (t.grad, jg) for t, jg in zip((tq, tk, tv), j_grads)
    ]
    for got, want in pairs:
        want = np.asarray(want.astype(jnp.float32))
        got = got.detach().float().numpy()
        tol = 1e-5 if dtype == "f32" else _bf16_ulp(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_supports_seq_truth_table_matches_reference():
    port = [TF.flash_supports_seq(s) for s in range(1, 4097)]
    ref = [JF.flash_supports_seq(s) for s in range(1, 4097)]
    assert port == ref
    assert sum(port) == 10  # 128, 256, and the 8 multiples of 512


@pytest.mark.parametrize("s", [64, 127, 384, 640, 1000])
def test_length_errors_match_reference(s):
    q = np.zeros((1, s, 1, 128), np.float32)
    with pytest.raises(ValueError) as ref:
        JF.flash_causal_attention(*(jnp.asarray(q),) * 3)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError) as port:
        TF.flash_causal_attention(t, t, t)
    # The same verdict and the same leading clause; the reason given
    # after the colon names the port's own rule.
    assert str(port.value).split(":")[0] == str(ref.value).split(":")[0]


def test_cuda_wrappers_refuse_cpu_tensors():
    # The kernel wrappers never compute on the CPU: only
    # flash_causal_attention chooses the plain version, by device.
    q = torch.zeros((1, 128, 1, 128), dtype=torch.bfloat16)
    before = (TF.flash_attention_fwd.launches,
              TF.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        TF.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        TF.flash_attention_bwd(q, q, q, q, torch.zeros((1, 1, 128)), q)
    assert (TF.flash_attention_fwd.launches,
            TF.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("d", TF.HEAD_DIMS)
def test_kernel_shape_rule_accepts_built_head_dims(d):
    assert TF.HEAD_DIMS == (32, 64, 128, 256)
    for s in (128, 192, 2048, 8192):  # any multiple of 64
        TF.check_head_dim_and_seq(d, s)
    with pytest.raises(ValueError, match="seq multiple of 64"):
        TF.check_head_dim_and_seq(d, 96)


def test_every_multiple_of_8_up_to_256_runs_an_instance():
    for d in range(8, 257, 8):
        TF.check_head_dim_and_seq(d, 128)
        inst = TF.head_dim_instance(d)
        assert inst in (64, 128, 256) and inst >= d
        assert inst == 64 or inst // 2 < d  # the smallest at or above d


@pytest.mark.parametrize("d", [264, 512, 20])
def test_kernel_shape_rule_rejects_other_head_dims_by_name(d):
    with pytest.raises(ValueError) as err:
        TF.check_head_dim_and_seq(d, 128)
    assert "a head dim that is a multiple of 8 up to 256" in str(err.value)
    assert f"got d {d}" in str(err.value)


@pytest.mark.parametrize("d, dv, want", [
    (192, 128, (192, 128)),  # latent attention's own instance
    (128, 192, None),  # v wider than q
    (64, 256, None),
    (128, 64, None),  # other narrower pairs
    (192, 96, None),
    (256, 128, None),
    (32, 32, (64, 64)),  # equal widths: head_dim_instance's
    (64, 64, (64, 64)),
    (96, 96, (128, 128)),
    (128, 128, (128, 128)),
    (192, 192, (256, 256)),
    (256, 256, (256, 256)),
])
def test_kernel_width_pair_rule(d, dv, want):
    if want is None:
        with pytest.raises(ValueError) as err:
            TF.flash_instance(d, dv)
        assert f"got d {d}, v's {dv}" in str(err.value)
        return
    assert TF.flash_instance(d, dv) == want
    if dv == d:
        assert want == (TF.head_dim_instance(d),) * 2
    else:
        assert (d, dv) == TF.WIDE_PAIR
