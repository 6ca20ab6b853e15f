"""The port's BatchNorms (container_engine_accelerators_tpu_torch/models/
norm.py FusedBatchNormAct, both residuals, and models/resnet.py BNAct,
flax's nn.BatchNorm) against the reference's (models/norm.py
FusedBatchNormAct, models/resnet.py _BNAct) on the same numpy-drawn
activations and parameters: train-mode outputs, the gradients of
x, scale and bias, the EMA-updated running statistics, and eval mode.

Tolerances: f32, 1e-5 relative to each tensor's largest entry (the same
f32 statistics summed in another order).  bf16 activations: outputs
within one bf16 ulp of max|z| (2**-8 relative; both compute in f32 and
round once, and the xhat residual is rounded to bf16 in both); gradients
within 2**-8 relative L2 (the bf16 xhat residual and bf16 dy); the
running statistics within 1e-5 relative (f32 in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch on 2 CPU threads per worker)
from container_engine_accelerators_tpu.models import norm as JN
from container_engine_accelerators_tpu.models import resnet as JR
from container_engine_accelerators_tpu_torch.models import norm as TN
from container_engine_accelerators_tpu_torch.models import resnet as TR

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}
SHAPE = (8, 6, 6, 16)
MOMENTUM, EPS = 0.9, 1e-5


def _case(seed):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal(SHAPE) + 0.3).astype(np.float32)
    c = SHAPE[-1]
    params = {"scale": (1.0 + 0.3 * rng.standard_normal(c)).astype(
        np.float32), "bias": (0.2 * rng.standard_normal(c)).astype(
        np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
             "var": (1.0 + 0.2 * np.abs(rng.standard_normal(c))).astype(
                 np.float32)}
    dz = rng.standard_normal(SHAPE).astype(np.float32)
    return x, params, stats, dz


def _jax_module(kind, act, dtype, train):
    if kind == "flax":
        return JR._BNAct(use_running_average=not train, momentum=MOMENTUM,
                         epsilon=EPS, dtype=dtype, act=act)
    return JN.FusedBatchNormAct(use_running_average=not train,
                                momentum=MOMENTUM, epsilon=EPS, dtype=dtype,
                                act=act, residual=kind)


def _port_module(kind, act, dtype):
    c = SHAPE[-1]
    if kind == "flax":
        return TR.BNAct(c, act=act, momentum=MOMENTUM, epsilon=EPS,
                        dtype=dtype)
    return TN.FusedBatchNormAct(c, act=act, momentum=MOMENTUM, epsilon=EPS,
                                dtype=dtype, residual=kind)


def _jax(kind, act, dtype, case, train=True):
    x, params, stats, dz = case
    mod = _jax_module(kind, act, dtype, train)
    if kind == "flax":
        params, stats = {"BatchNorm_0": params}, {"BatchNorm_0": stats}
    jx = jnp.asarray(x).astype(dtype)
    jdz = jnp.asarray(dz).astype(dtype)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jax.tree_util.tree_map(jnp.asarray, stats)
    if not train:
        return np.asarray(mod.apply({"params": p, "batch_stats": s},
                                    jx).astype(jnp.float32))

    def f(x_, p_):
        z, ns = mod.apply({"params": p_, "batch_stats": s}, x_,
                          mutable=["batch_stats"])
        return z, ns

    z, pull, ns = jax.vjp(f, jx, p, has_aux=True)
    dx, dp = pull(jdz)
    if kind == "flax":
        dp, ns = dp["BatchNorm_0"], ns["batch_stats"]["BatchNorm_0"]
    else:
        ns = ns["batch_stats"]
    f32 = lambda t: np.asarray(jnp.asarray(t).astype(jnp.float32))  # noqa
    return (f32(z), f32(dx), f32(dp["scale"]), f32(dp["bias"]),
            f32(ns["mean"]), f32(ns["var"]))


def _port(kind, act, dtype, case, train=True):
    x, params, stats, dz = case
    mod = _port_module(kind, act, dtype)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(params["scale"]))
        mod.bias.copy_(torch.from_numpy(params["bias"]))
        mod.mean.copy_(torch.from_numpy(stats["mean"]))
        mod.var.copy_(torch.from_numpy(stats["var"]))
    tx = torch.from_numpy(x).to(dtype)
    if not train:
        with torch.no_grad():
            return mod(tx, train=False).float().numpy()
    tx.requires_grad_(True)
    z = mod(tx, train=True)
    assert z.dtype == dtype
    dx, dscale, dbias = torch.autograd.grad(
        z, (tx, mod.scale, mod.bias), torch.from_numpy(dz).to(dtype))
    f32 = lambda t: t.detach().float().numpy()  # noqa
    return (f32(z), f32(dx), f32(dscale), f32(dbias), f32(mod.mean),
            f32(mod.var))


KINDS = ["xhat", "y", "flax"]


@pytest.mark.parametrize("act", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_matches_reference(kind, act, dtype):
    jdt, tdt = DT[dtype]
    case = _case(len(kind) + 3 * act)
    want = _jax(kind, act, jdt, case)
    got = _port(kind, act, tdt, case)
    names = ["z", "dx", "dscale", "dbias", "mean", "var"]
    for name, g, w in zip(names, got, want):
        if dtype == "f32" or name in ("mean", "var"):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
        elif name == "z":
            np.testing.assert_allclose(
                g, w, rtol=0, atol=2.0 ** -8 * np.abs(w).max(), err_msg=name)
        else:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= 2.0 ** -8, (name, rel)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_eval_uses_running_statistics(kind, dtype):
    jdt, tdt = DT[dtype]
    case = _case(11)
    want = _jax(kind, True, jdt, case, train=False)
    got = _port(kind, True, tdt, case, train=False)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


def test_training_forward_rounds_xhat_before_the_affine():
    # Under a gradient the fused norm follows the reference's fwd rule
    # (xhat rounded to bf16, then the affine); without one, the primal.
    x, params, _, _ = _case(5)
    mod = _port_module("xhat", False, torch.bfloat16)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(params["scale"]) * 3.0)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    z_grad = mod(tx.clone().requires_grad_(True)).detach()
    with torch.no_grad():
        z_primal = mod(tx)
    jz = np.asarray(JN._bn_act_fwd(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mod.scale.detach()
                                                         .numpy()),
        jnp.asarray(mod.bias.detach().numpy()), EPS, False)[0][0]
        .astype(jnp.float32))
    jp = np.asarray(JN._bn_act(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(mod.scale.detach().numpy()),
        jnp.asarray(mod.bias.detach().numpy()), EPS, False)[0]
        .astype(jnp.float32))
    ulp = 2.0 ** -8 * np.abs(jz).max()
    np.testing.assert_allclose(z_grad.float().numpy(), jz, rtol=0, atol=ulp)
    np.testing.assert_allclose(z_primal.float().numpy(), jp, rtol=0,
                               atol=ulp)
    assert not torch.equal(z_grad, z_primal)


def test_zero_scale_blocks_the_gradient():
    # ResNet's zero-initialized last norm of a block: dx is exactly 0.
    mod = TN.FusedBatchNormAct(SHAPE[-1], zero_scale=True,
                               dtype=torch.float32)
    x = torch.from_numpy(_case(6)[0]).requires_grad_(True)
    (dx,) = torch.autograd.grad(mod(x).sum() + 0.0 * x.sum(), (x,))
    assert torch.count_nonzero(dx) == 0


def test_ema_is_flax_not_torch_batchnorm():
    # momentum 0.9 on the OLD value and the biased variance.
    x = torch.from_numpy(_case(7)[0])
    mod = TN.FusedBatchNormAct(SHAPE[-1], dtype=torch.float32)
    mod(x)
    xf = x.double().reshape(-1, SHAPE[-1])
    np.testing.assert_allclose(mod.mean.numpy(), 0.1 * xf.mean(0).numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        mod.var.numpy(), 0.9 + 0.1 * xf.var(0, unbiased=False).numpy(),
        rtol=1e-5)
