"""The port's fused 1x1-conv matmuls with BatchNorm statistics
(container_engine_accelerators_tpu_torch/ops/fused_linear.py, the plain
path on the CPU) against the reference's Pallas kernel run in interpret
mode, on the same numpy-drawn operands: y, the column sum and sum of
squares, and the gradients of a loss touching all three (the statistics'
gradients flow into g), for matmul_stats and affine_relu_matmul_stats.

Tolerances: f32 operands, 1e-5 relative to each output's or gradient's
largest entry (f32 sums of the same products in another order; the
prologue rounds relu(u * scale + shift) to bf16 in both, as the
reference's kernel does for every dtype).  bf16 operands, the
reference's own tests' (tests/test_fused_linear.py): y within rtol 2e-2,
atol 1e-2; the statistics rtol 2e-2, atol 0.5; gradients rtol 5e-2 and
atol 2e-2 of max(max|grad|, 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch on 2 CPU threads per worker)
from container_engine_accelerators_tpu.ops import fused_linear as JL
from container_engine_accelerators_tpu_torch.ops import fused_linear as TL

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}
# The cotangent weights of (y, s, ss) in the loss: every path is live.
W_Y, W_S, W_SS = 0.3, 0.7, 0.1


def _case(seed, m, k, n, affine):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    if not affine:
        return a, b, None, None
    scale = (np.abs(rng.standard_normal(k)) + 0.5).astype(np.float32)
    shift = (0.3 * rng.standard_normal(k)).astype(np.float32)
    return a, b, scale, shift


def _jax(a, b, scale, shift, dtype):
    ja, jb = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    if scale is None:
        def op(a_, b_):
            return JL.matmul_stats(a_, b_, True)
        args = (ja, jb)
    else:
        def op(a_, sc, sh, b_):
            return JL.affine_relu_matmul_stats(a_, sc, sh, b_, True)
        args = (ja, jnp.asarray(scale), jnp.asarray(shift), jb)

    def loss(*xs):
        y, s, ss = op(*xs)
        return (jnp.sum(y.astype(jnp.float32) * W_Y) + jnp.sum(s * W_S)
                + jnp.sum(ss * W_SS))

    outs = op(*args)
    grads = jax.grad(loss, tuple(range(len(args))))(*args)
    return ([np.asarray(o.astype(jnp.float32)) for o in outs],
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(a, b, scale, shift, dtype):
    leaves = [torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)]
    if scale is not None:
        leaves = [leaves[0], torch.from_numpy(scale),
                  torch.from_numpy(shift), leaves[1]]
    leaves = [t.requires_grad_(True) for t in leaves]
    if scale is None:
        y, s, ss = TL.matmul_stats(*leaves)
    else:
        y, s, ss = TL.affine_relu_matmul_stats(*leaves)
    assert y.dtype == dtype and s.dtype == ss.dtype == torch.float32
    loss = (y.float() * W_Y).sum() + (s * W_S).sum() + (ss * W_SS).sum()
    grads = torch.autograd.grad(loss, leaves)
    for g, leaf in zip(grads, leaves):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
    return ([t.detach().float().numpy() for t in (y, s, ss)],
            [g.float().numpy() for g in grads])


SHAPES = [(128, 64, 64), (256, 128, 128), (96, 32, 16), (40, 24, 136)]


@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_outputs_and_gradients_match_reference(m, k, n, affine, dtype):
    jdt, tdt = DT[dtype]
    case = _case(m + k + n, m, k, n, affine)
    (jy, js, jss), jg = _jax(*case, jdt)
    (ty, ts, tss), tg = _port(*case, tdt)
    if dtype == "f32":
        for got, want in [(ty, jy), (ts, js), (tss, jss), *zip(tg, jg)]:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        return
    np.testing.assert_allclose(ty, jy, rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(ts, js, rtol=2e-2, atol=0.5)
    np.testing.assert_allclose(tss, jss, rtol=2e-2, atol=0.5)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(
            got, want, rtol=5e-2, atol=2e-2 * max(np.abs(want).max(), 1.0))


def test_prologue_rounds_to_bf16_before_the_product():
    # The reference rounds relu(u * scale + shift) to bf16 even for f32 u:
    # y equals the product of the rounded operand, not of the f32 one.
    a, b, scale, shift = _case(3, 64, 32, 16, True)
    y = TL.affine_relu_matmul_stats(
        torch.from_numpy(a), torch.from_numpy(scale),
        torch.from_numpy(shift), torch.from_numpy(b))[0].numpy()
    z = np.maximum(a * scale + shift, 0.0)
    z_bf16 = np.asarray(jnp.asarray(z).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    np.testing.assert_allclose(y, z_bf16 @ b, rtol=1e-5, atol=1e-5)
    assert np.abs(y - z @ b).max() > 1e-4


def test_statistics_are_those_of_the_f32_accumulator():
    # bf16 operands: s and ss sum the f32 products, not the bf16 y.
    a, b, _, _ = _case(4, 64, 32, 16, False)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(b).to(torch.bfloat16)
    y, s, ss = TL.matmul_stats(ta, tb)
    acc = ta.double() @ tb.double()
    np.testing.assert_allclose(s.numpy(), acc.sum(0).numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(ss.numpy(), (acc * acc).sum(0).numpy(),
                               rtol=1e-5)
    assert not torch.equal(s.double(), y.double().sum(0))


def test_cuda_wrapper_refuses_cpu_tensors():
    a, b = torch.zeros((16, 8), dtype=torch.bfloat16), torch.zeros(
        (8, 8), dtype=torch.bfloat16)
    sc = torch.ones(8)
    before = (TL.fused_matmul.launches, TL.fused_affine_matmul.launches)
    with pytest.raises(ValueError, match="CUDA"):
        TL.fused_matmul(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        TL.fused_affine_matmul(a, sc, sc, b)
    TL.matmul_stats(a, b)  # the plain version, by device
    TL.affine_relu_matmul_stats(a, sc, sc, b)
    assert (TL.fused_matmul.launches,
            TL.fused_affine_matmul.launches) == before


# The kernel's launch plan and the checks on what it takes: pure Python,
# so they are held here; the kernel itself only on the card (chip_smoke).
PLAN_SHAPES = [(802816, 64, 64), (802816, 64, 256), (200704, 512, 128),
               (50176, 1024, 512), (12544, 2048, 512), (12544, 512, 2048),
               (1000, 72, 200), (1, 8, 8)]


@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_covers_every_tile_and_fits(m, k, n, affine):
    plan = TL.plan_matmul(m, k, n, 132, True, affine)
    assert plan["bn"] == (64 if n <= 64 else 128)
    assert plan["tiles"] == -(-m // TL.BM) * -(-n // plan["bn"])
    assert plan["grid"] == min(plan["tiles"], 132)
    assert 2 <= plan["b_stages"] <= TL.MAX_STAGES
    assert plan["a_stages"] == plan["b_stages"]  # A and B tiles go together
    assert plan["a_rows"] == TL.BM

    def smem(stages):
        return TL.smem_bytes(plan["bn"], stages, stages, TL.BM, n, k, True,
                             affine)

    assert smem(plan["b_stages"]) <= TL.SMEM_LIMIT
    # The deepest ring that fits: one more stage would not.
    if plan["b_stages"] < TL.MAX_STAGES:
        assert smem(plan["b_stages"] + 1) > TL.SMEM_LIMIT


def test_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match=r"N \(40000\)"):
        TL.plan_matmul(128, 64, 40000, 132)
    # Without the statistics' per-block row the same N fits.
    assert TL.plan_matmul(128, 64, 40000, 132, stats=False)["b_stages"] >= 2


@pytest.mark.parametrize("m", [1, 127, 1000, 4097])
@pytest.mark.parametrize("k,n", [(72, 200), (8, 8), (64, 2048)])
def test_check_matmul_takes_multiples_of_8_and_any_m(m, k, n):
    a = torch.zeros((m, k), dtype=torch.bfloat16)
    b = torch.zeros((k, n), dtype=torch.bfloat16)
    assert TL.check_matmul("t", a, b) == (m, k, n)
    sc = torch.ones(k)
    assert TL.check_matmul("t", a, b, sc, sc) == (m, k, n)
    TL.check_tma("t", a, b, sc, sc)


@pytest.mark.parametrize("k,n,word", [(12, 8, r"K \(12\)"),
                                      (8, 20, r"N \(20\)")])
def test_check_matmul_refuses_k_or_n_off_8(k, n, word):
    a = torch.zeros((16, k), dtype=torch.bfloat16)
    b = torch.zeros((k, n), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=word):
        TL.check_matmul("t", a, b)


def test_check_matmul_refuses_other_dtypes_shapes_and_empty_m():
    b = torch.zeros((8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        TL.check_matmul("t", torch.zeros((4, 8)), b)
    with pytest.raises(ValueError, match="shapes"):
        TL.check_matmul("t", torch.zeros((4, 16), dtype=torch.bfloat16), b)
    with pytest.raises(ValueError, match="M >= 1"):
        TL.check_matmul("t", torch.zeros((0, 8), dtype=torch.bfloat16), b)
    with pytest.raises(ValueError, match="together"):
        TL.check_matmul("t", torch.zeros((4, 8), dtype=torch.bfloat16), b,
                        torch.ones(8), None)


def test_check_tma_refuses_misaligned_or_strided_operands():
    buf = torch.zeros(16 * 8 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        TL.check_tma("t", buf[1:].view(16, 8))
    with pytest.raises(ValueError, match="contiguous"):
        TL.check_tma("t", buf[:128].view(16, 8).t())
    TL.check_tma("t", buf[:128].view(16, 8), None)


def test_ptxas_report_is_parsed_per_entry_function():
    # The build keeps registers, spills and serialized-wgmma lines, which
    # chip_smoke records (and fails on the last).
    from container_engine_accelerators_tpu_torch.ops import _build

    log = "\n".join([
        "ptxas info    : Compiling entry function 'k1' for 'sm_90a'",
        "ptxas info    : Function properties for k1",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 162 registers, used 2 barriers",
        "ptxas info    : Compiling entry function 'k2' for 'sm_90a'",
        "ptxas info    : (C7520) Potential Performance Loss: "
        "wgmma.mma_async instructions are serialized due to x in 'k2'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 94 registers, used 2 barriers",
    ])
    got = _build.parse_ptxas(log)
    assert got["kernels"] == {"k1": [162, 8, 4], "k2": [94, 0, 0]}
    assert len(got["serialized"]) == 1 and "k2" in got["serialized"][0]
