"""The port's ResNet (container_engine_accelerators_tpu_torch/models/
resnet.py, fused_block.py, convert.py; its kernels' plain versions on the
CPU) against the reference's flax modules on the same numpy-drawn
weights, running statistics and images.

  (a) the pieces: flax "SAME" padding (asymmetric where the total is
      odd), the conv7 stem's explicit padding, space_to_depth;
  (b) the bottleneck blocks, flax and fused, stride 1 and stride 2 with
      projection, every norm scale nonzero (the last one of a block is
      zero at init, which would hide the main path's backward): the
      output, every parameter's gradient and the new running statistics
      — f32 within 1e-4 relative L2 per leaf, bf16 within 0.08 (the
      reference's own bound, tests/test_fused_block.py: the fused block
      takes its statistics from the f32 accumulator, flax from the bf16
      tensor);
  (c) a tiny whole ResNet (stages [1, 1], 8 filters, 16 x 16 images,
      batch 8) on both stems and both block_impls, and with norm_impl
      "flax", conv1x1 "dot" and remat "block": the train-mode logits,
      every gradient and the new batch_stats, and the eval-mode logits
      after the update, in f32.  Limits: logits 1e-5 of max|logit|,
      batch_stats 1e-5 relative, gradients 1e-4 relative L2 per leaf.
      block_impl "fused_pallas" is held looser, at limits set after
      reading it (worst readings: logits 6.7e-5, batch_stats 1.5e-5,
      gradients 1.4e-2 on block 0's bn1): logits 1e-3, batch_stats
      1e-4, gradients 5e-2.  The reference rounds the kernel's
      prologue relu(u * scale + shift) to bf16 even in f32, so
      (probably) the f32 noise of the layers before a block flips a few
      of those roundings by one bf16 ulp, and with them a few ReLU masks
      of elements near 0, each of which moves one gradient element by
      its full size; the BatchNorm parameters' gradients are sums that
      cancel, so such a flip reads as 1% of them.  On identical inputs
      the fused block is held to 1e-4 by (b).

The reference's Pallas kernels run in interpret mode; each JAX result
is computed once per module (interpret mode costs ~20 s for the tiny
fused model)."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import draw_vision_trees
from container_engine_accelerators_tpu.models import fused_block as JFB
from container_engine_accelerators_tpu.models import norm as JN
from container_engine_accelerators_tpu.models import resnet as JR
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import fused_block as TFB
from container_engine_accelerators_tpu_torch.models import norm as TN
from container_engine_accelerators_tpu_torch.models import resnet as TR

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# -- (a) the pieces ---------------------------------------------------------
@pytest.mark.parametrize("size,k,s,pads", [
    (56, 3, 2, (0, 1)), (57, 3, 2, (1, 1)), (56, 3, 1, (1, 1)),
    (112, 4, 1, (1, 2)), (56, 1, 2, (0, 0)), (7, 1, 2, (0, 0)),
])
def test_same_pads_are_flax_s(size, k, s, pads):
    assert TR.same_pads(size, k, s) == pads


@pytest.mark.parametrize("k,s,padding,hw", [
    ((3, 3), (2, 2), "SAME", 8), ((3, 3), (1, 1), "SAME", 7),
    ((4, 4), (1, 1), "SAME", 8), ((1, 1), (2, 2), "SAME", 8),
    ((7, 7), (2, 2), ((3, 3), (3, 3)), 16),
])
def test_conv_matches_flax_conv(k, s, padding, hw):
    rng = np.random.default_rng(hw + k[0])
    x = rng.standard_normal((2, hw, hw, 5)).astype(np.float32)
    w = rng.standard_normal((*k, 5, 6)).astype(np.float32)
    want = np.asarray(fnn.Conv(6, k, s, padding=padding, use_bias=False,
                               dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x)))
    conv = TR.Conv(5, 6, k, s, padding, dtype=torch.float32)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_space_to_depth_matches_reference():
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    np.testing.assert_array_equal(
        TR.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(JR.space_to_depth(jnp.asarray(x))))


# -- (b) the bottleneck blocks -----------------------------------------------
BLOCKS = [  # (impl, strides, c_in)
    ("flax", (1, 1), 32), ("flax", (2, 2), 16),
    ("fused", (1, 1), 32), ("fused", (2, 2), 16),
]


def _block_pair(impl, strides, c_in, dtype):
    jdt, tdt = DT[dtype]
    norm = functools.partial(JN.FusedBatchNormAct, use_running_average=False,
                             momentum=0.9, epsilon=1e-5, dtype=jdt)
    conv = functools.partial(fnn.Conv, use_bias=False, dtype=jdt)
    jcls = JR.BottleneckResNetBlock if impl == "flax" else (
        JFB.FusedBottleneckBlock)
    jblock = jcls(8, conv=conv, norm=norm, act=fnn.relu, strides=strides)
    # The port's block, built by a one-block scope of ResNet's factories.
    names = TR._names()
    t_conv = TR._Named(names, lambda ci, co, k, s=(1, 1), padding="SAME":
                       TR.Conv(ci, co, k, s, padding, tdt))
    t_norm = TR._Named(names, lambda f, act=False, zero_scale=False:
                       TN.FusedBatchNormAct(f, act, 0.9, 1e-5, tdt,
                                            zero_scale))
    tcls = TR.BottleneckResNetBlock if impl == "flax" else (
        TFB.FusedBottleneckBlock)
    tblock = tcls(c_in, 8, conv=t_conv, norm=t_norm, strides=strides)
    return jblock, tblock


def _block_case(impl, strides, c_in, dtype):
    jblock, tblock = _block_pair(impl, strides, c_in, dtype)
    x_shape = (8, 8, 8, c_in)
    params, stats = draw_vision_trees(jblock, x_shape, 7 + c_in)
    x = np.random.default_rng(3).standard_normal(x_shape).astype(np.float32)
    dz = np.random.default_rng(4).standard_normal(
        (8, 8 // strides[0], 8 // strides[1], 32)).astype(np.float32)
    return jblock, tblock, params, stats, x, dz


@functools.lru_cache(maxsize=None)
def _jax_block(impl, strides, c_in, dtype):
    jblock, _, params, stats, x, dz = _block_case(impl, strides, c_in, dtype)
    jdt = DT[dtype][0]

    def f(p):
        z, ns = jblock.apply({"params": p, "batch_stats": stats},
                             jnp.asarray(x).astype(jdt),
                             mutable=["batch_stats"])
        return z, ns

    z, pull, ns = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, params),
                          has_aux=True)
    (grads,) = pull(jnp.asarray(dz).astype(jdt))
    return (np.asarray(z.astype(jnp.float32)), _leaves(grads),
            _leaves(ns["batch_stats"]))


@pytest.mark.parametrize("impl,strides,c_in", BLOCKS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_matches_reference(impl, strides, c_in, dtype):
    jz, jgrads, jstats = _jax_block(impl, strides, c_in, dtype)
    _, tblock, params, stats, x, dz = _block_case(impl, strides, c_in,
                                                  dtype)
    tdt = DT[dtype][1]
    leaves = TR.module_leaves(tblock)
    trees = {"params": params, "batch_stats": stats}
    with torch.no_grad():
        for coll, path, t, layout in leaves:
            v = functools.reduce(lambda d, k: d[k], path, trees[coll])
            v = v.transpose(3, 2, 0, 1) if layout == "oihw" else v
            t.copy_(torch.from_numpy(np.ascontiguousarray(v)).reshape(
                t.shape))
    tblock.requires_grad_(True)
    z = tblock(torch.from_numpy(x).to(tdt), train=True)
    z.backward(torch.from_numpy(dz).to(tdt))
    tol = 1e-4 if dtype == "f32" else 0.08
    assert _rel_l2(z.detach().float().numpy(), jz) <= tol
    got = {}
    for coll, path, t, layout in leaves:
        key = "".join(f"['{k}']" for k in path)
        v = (t.grad if coll == "params" else t).detach().float().numpy()
        got[(coll, key)] = v.transpose(2, 3, 1, 0) if layout == "oihw" else (
            v.reshape(-1))
    for key, want in jgrads.items():
        g = got[("params", key)].reshape(want.shape)
        assert _rel_l2(g, want) <= tol, (key, _rel_l2(g, want))
    for key, want in jstats.items():
        g = got[("batch_stats", key)].reshape(want.shape)
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=(1e-5 if dtype == "f32" else 1e-3)
                                   * np.abs(want).max(), err_msg=key)


def test_fused_block_eval_mode_matches_reference():
    jblock, tblock, params, stats, x, _ = _block_case("fused", (2, 2), 16,
                                                      "f32")
    jblock = jblock.clone(norm=functools.partial(
        jblock.norm, use_running_average=True))
    want = np.asarray(jblock.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x)))
    trees = {"params": params, "batch_stats": stats}
    with torch.no_grad():
        for coll, path, t, layout in TR.module_leaves(tblock):
            v = functools.reduce(lambda d, k: d[k], path, trees[coll])
            v = v.transpose(3, 2, 0, 1) if layout == "oihw" else v
            t.copy_(torch.from_numpy(np.ascontiguousarray(v)).reshape(
                t.shape))
        got = tblock(torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# -- (c) a tiny whole ResNet ------------------------------------------------
TINY = dict(stage_sizes=[1, 1], num_classes=4, num_filters=8)
X_SHAPE = (8, 16, 16, 3)
MODELS = {  # id -> model kwargs
    "s2d-fused": dict(stem="s2d", block_impl="fused_pallas"),
    "conv7-fused": dict(stem="conv7", block_impl="fused_pallas"),
    "s2d-flax": dict(stem="s2d"),
    "conv7-flax": dict(stem="conv7"),
    "normflax-dot": dict(norm_impl="flax", conv1x1="dot"),
    "fused_y-remat": dict(norm_impl="fused_y", remat="block"),
    "fused-remat": dict(stem="s2d", block_impl="fused_pallas",
                        remat="block"),
}


def _jax_model(kw):
    return JR.ResNet(block_cls=JR.BottleneckResNetBlock, dtype=jnp.float32,
                     **TINY, **kw)


def _model_case(name):
    kw = MODELS[name]
    params, stats = draw_vision_trees(_jax_model(kw), X_SHAPE, 11,
                                      {"train": False})
    x = np.random.default_rng(12).standard_normal(X_SHAPE).astype(
        np.float32)
    return kw, params, stats, x


@functools.lru_cache(maxsize=None)
def _jax_model_results(name):
    kw, params, stats, x = _model_case(name)
    model = _jax_model(kw)

    def loss(p):
        logits, ns = model.apply({"params": p, "batch_stats": stats},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        return jnp.mean(logits ** 2), (logits, ns["batch_stats"])

    (_, (logits, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    eval_logits = model.apply({"params": params, "batch_stats": new_stats},
                              jnp.asarray(x), train=False)
    return (np.asarray(logits), _leaves(grads), _leaves(new_stats),
            np.asarray(eval_logits))


@pytest.mark.parametrize("name", list(MODELS))
def test_tiny_resnet_matches_reference(name):
    j_logits, j_grads, j_stats, j_eval = _jax_model_results(name)
    kw, params, stats, x = _model_case(name)
    model = TR.ResNet(block_cls=TR.BottleneckResNetBlock, dtype=torch.float32,
                      device="cpu", **TINY, **kw)
    convert.load_flax_resnet(model, params, stats)
    model.requires_grad_(True)
    logits = model(torch.from_numpy(x), train=True)
    (logits ** 2).mean().backward()
    fused = kw.get("block_impl") == "fused_pallas"
    l_tol, s_tol, g_tol = (1e-3, 1e-4, 5e-2) if fused else (1e-5, 1e-5, 1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, rtol=0,
                               atol=l_tol * np.abs(j_logits).max())
    t_grads = _leaves(convert.to_flax_resnet_grads(model))
    assert t_grads.keys() == j_grads.keys()
    for key, want in j_grads.items():
        assert _rel_l2(t_grads[key], want) <= g_tol, (
            key, _rel_l2(t_grads[key], want))
    t_params, t_stats = (_leaves(t) for t in convert.to_flax_resnet(model))
    assert t_stats.keys() == j_stats.keys()
    for key, want in j_stats.items():
        np.testing.assert_allclose(t_stats[key], want, rtol=0,
                                   atol=s_tol * np.abs(want).max(),
                                   err_msg=key)
    with torch.no_grad():
        t_eval = model(torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(t_eval, j_eval, rtol=0,
                               atol=l_tol * np.abs(j_eval).max())
    # The trees round-trip: params unchanged by the step (no update ran).
    for key, want in _leaves(params).items():
        np.testing.assert_array_equal(t_params[key], want)


def test_tree_names_cover_both_block_impls():
    for kw in (dict(block_impl="fused_pallas"), dict(conv1x1="dot"),
               dict(remat="block"), dict(norm_impl="flax")):
        model = TR.ResNet(block_cls=TR.BottleneckResNetBlock, device="cpu",
                          **TINY, **kw)
        want_p, want_s = draw_vision_trees(_jax_model(kw), X_SHAPE, 1,
                                           {"train": False})
        got_p, got_s = convert.to_flax_resnet(model)
        assert _leaves(got_p).keys() == _leaves(want_p).keys(), kw
        assert _leaves(got_s).keys() == _leaves(want_s).keys(), kw
        for key, want in _leaves(want_p).items():
            assert _leaves(got_p)[key].shape == want.shape, key


def test_resnet18_tree_matches_reference():
    model = TR.ResNet18(num_classes=4, num_filters=8, device="cpu")
    want_p, want_s = draw_vision_trees(
        JR.ResNet18(num_classes=4, num_filters=8), X_SHAPE, 1,
        {"train": False})
    got_p, got_s = convert.to_flax_resnet(model)
    assert {k: v.shape for k, v in _leaves(got_p).items()} == {
        k: v.shape for k, v in _leaves(want_p).items()}
    assert _leaves(got_s).keys() == _leaves(want_s).keys()


def test_init_random_draws_lecun_normal_and_flax_norm_inits():
    model = TR.ResNet50(device="cpu").init_random(
        torch.Generator().manual_seed(0))
    w = model.blocks[3].conv_1.kernel.detach()  # 3x3, 128 -> 128
    fan_in = w.shape[1] * 9
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
    assert torch.count_nonzero(model.blocks[0].norm_2.scale) == 0
    assert torch.all(model.blocks[0].norm_0.scale == 1)
    again = TR.ResNet50(device="cpu").init_random(
        torch.Generator().manual_seed(0))
    assert torch.equal(again.head_kernel, model.head_kernel)


@pytest.mark.parametrize("kw,msg", [
    (dict(norm_impl="bogus"), "unknown norm_impl"),
    (dict(remat="everything"), "unknown remat"),
    (dict(act=torch.tanh), "supports act=relu only"),
])
def test_validation(kw, msg):
    with pytest.raises(ValueError, match=msg):
        TR.ResNet(block_cls=TR.BottleneckResNetBlock, device="cpu", **TINY,
                  **kw)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.ResNet50()
