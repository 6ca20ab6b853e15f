"""The port's 3x3 conv with BatchNorm folded in
(container_engine_accelerators_tpu_torch/ops/fused_conv3x3.py, the plain
path on the CPU) against the reference's Pallas kernel run in interpret
mode, on the same numpy-drawn x, w, scale and shift: y, the per-channel
sum and sum of squares, and the gradients (dx, dscale, dshift, dw) of a
loss touching all three, with and without the prologue.

Tolerances: f32, 1e-5 relative to each tensor's largest entry (the same
nine tap products summed in another order).  bf16, the reference's own
tests' (tests/test_fused_conv3x3.py): y within 0.125 absolute, s within
2.0, ss within 1e-2 relative, each gradient within 1e-2 relative L2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch on 2 CPU threads per worker)
from container_engine_accelerators_tpu.ops import fused_conv3x3 as JC
from container_engine_accelerators_tpu_torch.ops import fused_conv3x3 as TC

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}
W_Y, W_S, W_SS = 0.3, 0.5, 0.1


def _case(seed, shape=(4, 8, 8, 16), c4=8):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, c, c4))).astype(np.float32)
    scale = (np.abs(rng.standard_normal(c)) + 0.5).astype(np.float32)
    shift = (0.5 * rng.standard_normal(c)).astype(np.float32)
    return x, w, scale, shift


def _jax(x, w, scale, shift, dtype, affine):
    jx = jnp.asarray(x).astype(dtype)
    sc = jnp.asarray(scale) if affine else None
    sh = jnp.asarray(shift) if affine else None

    def loss(x_, sc_, sh_, w_):
        y, s, ss = JC.conv3x3_bn_stats(x_, sc_, sh_, w_, True)
        return (jnp.sum(y.astype(jnp.float32) * W_Y) + jnp.sum(s * W_S)
                + jnp.sum(ss * W_SS))

    outs = JC.conv3x3_bn_stats(jx, sc, sh, jnp.asarray(w), True)
    argnums = (0, 1, 2, 3) if affine else (0, 3)
    grads = jax.grad(loss, argnums)(jx, sc, sh, jnp.asarray(w))
    return ([np.asarray(o.astype(jnp.float32)) for o in outs],
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(x, w, scale, shift, dtype, affine):
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    sc = torch.from_numpy(scale).requires_grad_(True) if affine else None
    sh = torch.from_numpy(shift).requires_grad_(True) if affine else None
    y, s, ss = TC.conv3x3_bn_stats(tx, sc, sh, tw)
    assert y.dtype == dtype
    loss = (y.float() * W_Y).sum() + (s * W_S).sum() + (ss * W_SS).sum()
    leaves = [tx, sc, sh, tw] if affine else [tx, tw]
    grads = torch.autograd.grad(loss, leaves)
    return ([t.detach().float().numpy() for t in (y, s, ss)],
            [g.float().numpy() for g in grads])


@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,c4", [((4, 8, 8, 16), 8),
                                      ((2, 5, 7, 8), 24)])
def test_outputs_and_gradients_match_reference(shape, c4, dtype, affine):
    jdt, tdt = DT[dtype]
    case = _case(sum(shape) + c4, shape, c4)
    (jy, js, jss), jg = _jax(*case, jdt, affine)
    (ty, ts, tss), tg = _port(*case, tdt, affine)
    if dtype == "f32":
        for got, want in [(ty, jy), (ts, js), (tss, jss), *zip(tg, jg)]:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        return
    np.testing.assert_allclose(ty, jy, rtol=0, atol=0.125)
    np.testing.assert_allclose(ts, js, atol=2.0)
    np.testing.assert_allclose(tss, jss, rtol=1e-2)
    for got, want in zip(tg, jg):
        rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-9)
        assert rel < 1e-2, rel


def test_border_pixels_contribute_zero_not_relu_shift():
    # The prologue runs first and the halo is zero after it.  Padding x
    # with zeros BEFORE the prologue (the easy mistake) would feed
    # relu(shift) from outside the image.
    x, w, scale, shift = _case(9, (1, 4, 4, 8), 8)
    shift = np.abs(shift) + 1.0  # relu(shift) > 0 everywhere
    y = TC.conv3x3_bn_stats(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(shift),
                            torch.from_numpy(w))[0].numpy()
    jy = np.asarray(JC.conv3x3_bn_stats(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift),
        jnp.asarray(w), True)[0])
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-5 * np.abs(jy).max())
    z = np.maximum(np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))) * scale
                   + shift, 0.0)
    wrong = sum(np.einsum("nhwc,cd->nhwd", z[:, 1 + dy:5 + dy, 1 + dx:5 + dx],
                          w[dy + 1, dx + 1])
                for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    assert np.abs(y - wrong).max() > 0.1


def test_rot180_t_matches_reference():
    w9 = np.random.default_rng(2).standard_normal((9, 4, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TC.rot180_t(torch.from_numpy(w9)).numpy(),
        np.asarray(JC._rot180_t(jnp.asarray(w9))))


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16)
    w9 = torch.zeros((9, 8, 8), dtype=torch.bfloat16)
    before = TC.conv3x3.launches
    with pytest.raises(ValueError, match="CUDA"):
        TC.conv3x3(x, w9)
    TC.conv3x3_bn_stats(x, None, None, torch.zeros((3, 3, 8, 8)))
    assert TC.conv3x3.launches == before


# The conv's tile plan and the checks on what the kernel takes (pure
# Python; the kernel itself is held on the card by chip_smoke).
@pytest.mark.parametrize("n,h,w,box", [
    (256, 56, 56, (8, 8, 2)), (256, 28, 28, (7, 6, 3)),
    (256, 14, 14, (14, 3, 3)), (256, 7, 7, (7, 7, 2)),
    (3, 9, 11, (11, 9, 1)), (2, 7, 7, (7, 7, 2)), (2, 5, 300, (25, 5, 1)),
    (256, 1, 1, (1, 1, 26)),
])
def test_plan_conv_box_fills_the_tile(n, h, w, box):
    c, c4 = 64, 200
    plan = TC.plan_conv(n, h, w, c, c4, 132)
    wb, r, bi = box
    assert (plan["wb"], plan["r"], plan["bi"]) == box
    assert wb * r * bi <= TC.BM
    # The A tile is the box with a one-pixel halo, within a TMA box.
    assert plan["a_rows"] == (wb + 2) * (r + 2) * bi <= TC.HALO_ROWS
    assert plan["a_stages"] == 2 and 2 <= plan["b_stages"] <= 4
    pixel_tiles = -(-w // wb) * -(-h // r) * -(-n // bi)
    assert plan["tiles"] == pixel_tiles * -(-c4 // plan["bn"])
    assert plan["grid"] == min(plan["tiles"], 132)
    # No box of whole image rows of one image (the simplest choice)
    # needs fewer tiles.
    if w <= TC.BM:
        assert pixel_tiles <= -(-h // min(h, TC.BM // w)) * n


@pytest.mark.parametrize("c,c4,word", [(12, 8, r"C \(12\)"),
                                       (24, 20, r"C4 \(20\)")])
def test_check_conv_refuses_channels_off_8(c, c4, word):
    x = torch.zeros((1, 4, 4, c), dtype=torch.bfloat16)
    w9 = torch.zeros((9, c, c4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=word):
        TC.check_conv("t", x, w9)


def test_check_conv_takes_ragged_shapes():
    x = torch.zeros((3, 9, 11, 24), dtype=torch.bfloat16)
    w9 = torch.zeros((9, 24, 40), dtype=torch.bfloat16)
    sc = torch.ones(24)
    assert TC.check_conv("t", x, w9, sc, sc) == (3, 9, 11, 24, 40)
    with pytest.raises(ValueError, match="bf16"):
        TC.check_conv("t", x.float(), w9)
    with pytest.raises(ValueError, match=r"\(24,\)"):
        TC.check_conv("t", x, w9, torch.ones(8), torch.ones(8))
