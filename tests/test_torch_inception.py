"""The port's Inception v3 (container_engine_accelerators_tpu_torch/
models/inception.py) and its training through models/train.py against
the reference's (models/inception.py, models/train.py), in f32 on the
CPU at 75 x 75 images (the smallest Inception v3 takes: its stages reach
3 x 3 and then 1 x 1 pixels), with weights and running statistics drawn
with numpy (tests/_torch_port.py `draw_vision_trees`) and carried over by
models/convert.py:

  (a) every stage alone (the five stem ConvBNs, the eleven Inception
      blocks, the head) on the reference's own input to it, batch 2:
      the output, the updated batch statistics, and the gradients of a
      numpy-drawn cotangent w.r.t. the stage's parameters and its input,
      each within 1e-4 of its largest magnitude.  The two InceptionE
      blocks are held to 2**-8: they see 1 x 1 pixels, so at batch 2
      each of their BatchNorms normalizes two values, and the fast
      variance E[x^2] - E[x]^2 (flax's, which the port keeps) amplifies
      the f32 rounding of its inputs by mean^2 / var (measured: up to
      1e-3 relative);
  (b) the whole train-mode forward at batch 8: the logits and every
      updated batch statistic within 2**-7 of their largest magnitude,
      since the stages' f32 roundings compound through 94 BatchNorms
      (measured: 1e-3 on the logits);
  (c) one build_training step at batch 8 from the same trees: the loss
      and the head's gradients within 2**-9 of the reference's (the
      forward's rounding compounds as in (b): measured 2.7e-4 on the
      loss), and the updated parameters equal to optax's chain applied
      to the port's own gradients (1e-6 absolute and relative: the same
      f32 formula on kernels up to ~10).  The other leaves' gradients
      are held by (a), not here: a conv kernel's gradient under a
      BatchNorm is a difference of near-equal terms (the norm cancels
      the kernel's scale), so the step's 1e-3 on the activations moves
      a late kernel's gradient by up to 47% (measured on
      InceptionE_1/ConvBN_6), and at batch 8 the reference's own input
      gradient of ConvBN_2 is 1.7% away from a float64 evaluation of the
      same function, where the port's is 8e-7 away;
  (d) the model factory, the job (resnet_main --model inception_v3) on
      the CPU, and the names of the flax tree.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import draw_vision_trees
from container_engine_accelerators_tpu.models import inception as JI
from container_engine_accelerators_tpu.models import train as JT
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import inception as TI
from container_engine_accelerators_tpu_torch.models import train as TT
from container_engine_accelerators_tpu_torch.models.resnet import (
    module_leaves,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE, CLASSES = 75, 10
F32 = jnp.float32
STEM = [(32, (3, 3), (2, 2), "VALID"), (32, (3, 3), (1, 1), "VALID"),
        (64, (3, 3), (1, 1), "SAME"), (80, (1, 1), (1, 1), "VALID"),
        (192, (3, 3), (1, 1), "VALID")]
TOL = 1e-4
TOL_ONE_PIXEL = 2.0 ** -8
TOL_STEP = 2.0 ** -9


def _ref_stages():
    """The reference's stages as standalone flax modules, in order."""
    return ([JI.ConvBN(*c, dtype=F32) for c in STEM]
            + [JI.InceptionA(p, dtype=F32) for p in (32, 64, 64)]
            + [JI.InceptionB(dtype=F32)]
            + [JI.InceptionC(c, dtype=F32) for c in (128, 160, 160, 192)]
            + [JI.InceptionD(dtype=F32)]
            + [JI.InceptionE(dtype=F32) for _ in range(2)])


STAGE_NAMES = ([f"ConvBN_{i}" for i in range(5)]
               + [f"InceptionA_{i}" for i in range(3)] + ["InceptionB_0"]
               + [f"InceptionC_{i}" for i in range(4)] + ["InceptionD_0"]
               + [f"InceptionE_{i}" for i in range(2)])


def _images(seed, batch):
    return np.random.default_rng(seed).standard_normal(
        (batch, IMAGE, IMAGE, 3)).astype(np.float32)


def _setup(batch, seed=0):
    ref = JI.InceptionV3(num_classes=CLASSES, dtype=F32)
    params, stats = draw_vision_trees(ref, (batch, IMAGE, IMAGE, 3), seed)
    port = TI.InceptionV3(num_classes=CLASSES, dtype=torch.float32,
                          device="cpu")
    convert.load_flax_vision(port, params, stats)
    return ref, port, params, stats


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def staged():
    """The reference's forward at batch 2 with every stage's output."""
    ref, port, params, stats = _setup(2)
    x = _images(1, 2)
    logits, state = ref.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True)
    inter = state["intermediates"]
    outs = {n: np.asarray(inter[n]["__call__"][0]) for n in STAGE_NAMES}
    return port, params, stats, x, outs, np.asarray(logits)


# -- (a) stage by stage ------------------------------------------------
@pytest.mark.parametrize("index", range(len(STAGE_NAMES)))
def test_stage_matches_reference(staged, index):
    port, params, stats, x, outs, _ = staged
    name = STAGE_NAMES[index]
    stage = [*port.stem, *port.blocks][index]
    assert stage.flax_name == name
    inp = x if index == 0 else outs[STAGE_NAMES[index - 1]]
    if name in ("ConvBN_3", "InceptionA_0"):  # after the stem's max pools
        inp = TI.max_pool_valid(torch.tensor(inp)).numpy()
    g = np.random.default_rng(index).standard_normal(
        outs[name].shape).astype(np.float32)
    module = _ref_stages()[index]

    def apply(p, xx):
        return module.apply({"params": p, "batch_stats": stats[name]}, xx,
                            train=True, mutable=["batch_stats"])

    j_out, j_state = apply(params[name], jnp.asarray(inp))
    _, vjp = jax.vjp(lambda p, xx: apply(p, xx)[0], params[name],
                     jnp.asarray(inp))
    j_dp, j_dx = vjp(jnp.asarray(g))

    t_in = torch.tensor(np.array(inp), requires_grad=True)
    stage.requires_grad_(True)
    stage.zero_grad(set_to_none=True)
    t_out = stage(t_in, True)
    t_out.backward(torch.from_numpy(g))
    tol = TOL_ONE_PIXEL if name.startswith("InceptionE") else TOL
    errs = {"out": _rel(t_out.detach().numpy(), j_out),
            "dx": _rel(t_in.grad.numpy(), j_dx)}
    for coll, path, t, layout in module_leaves(stage):
        if coll == "params":
            got, want = t.grad.numpy(), _at(j_dp, path)
        else:
            got, want = t.numpy(), _at(j_state["batch_stats"], path)
        if layout == "oihw":
            got = got.transpose(2, 3, 1, 0)
        errs["/".join(path)] = _rel(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (name, worst, errs[worst])


def test_head_matches_reference(staged):
    port, _, _, _, outs, logits = staged
    feats = torch.from_numpy(outs["InceptionE_1"]).mean((1, 2))
    got = torch.matmul(feats, port.head_kernel) + port.head_bias
    assert _rel(got.detach().numpy(), logits) <= TOL


# -- (b) the whole forward ---------------------------------------------
def test_train_forward_logits_and_stats_match_reference():
    ref, port, params, stats = _setup(8)
    x = _images(2, 8)
    logits, state = ref.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    got = port(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32 and got.shape == (8, CLASSES)
    assert _rel(got.detach().numpy(), logits) <= 2.0 ** -7
    _, t_stats = convert.to_flax_vision(port)
    want = jax.tree_util.tree_leaves_with_path(state["batch_stats"])
    for path, leaf in want:
        keys = [p.key for p in path]
        assert _rel(_at(t_stats, keys), leaf) <= 2.0 ** -7, keys


# -- (c) one training step ---------------------------------------------
def test_one_build_training_step_matches_reference():
    batch = 8
    ref, _, params, stats = _setup(batch, seed=3)
    x = _images(4, batch)
    labels = np.random.default_rng(5).integers(
        0, CLASSES, size=(batch,)).astype(np.int32)

    def loss_fn(p):
        logits, _ = ref.apply({"params": p, "batch_stats": stats},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return JT.cross_entropy_loss(logits, jnp.asarray(labels))

    j_loss, j_grads = jax.value_and_grad(loss_fn)(params)
    step, _, state = TT.build_training(
        model_name="inception_v3", image_size=IMAGE, num_classes=CLASSES,
        model_kwargs=dict(dtype=torch.float32), device="cpu",
        params=params, batch_stats=stats,
    )
    state, loss = step(state, torch.from_numpy(x),
                       torch.from_numpy(labels).long())
    assert state["step"] == 1
    assert abs(float(loss) - float(j_loss)) <= TOL_STEP * abs(float(j_loss))
    t_grads = convert.to_flax_vision_grads(state["model"])
    for leaf in ("kernel", "bias"):
        assert _rel(t_grads["head"][leaf], j_grads["head"][leaf]) <= (
            TOL_STEP), leaf
    # The update is optax's chain on the port's own gradients.
    tx = JT.make_optimizer(0.1)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, t_grads),
                           tx.init(p), p)
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, optax.apply_updates(p, updates)))
    got = convert.to_flax_vision(state["model"])[0]
    for path, leaf in want:
        keys = [k.key for k in path]
        np.testing.assert_allclose(_at(got, keys), leaf, rtol=1e-6,
                                   atol=1e-6, err_msg="/".join(keys))


# -- (d) the factory, the job and the tree names ---------------------------
def test_factory_builds_inception_with_reference_tree_names():
    model = TT.create_model("inception_v3", CLASSES, device="cpu")
    assert isinstance(model, TI.InceptionV3)
    ref = JI.InceptionV3(num_classes=CLASSES)
    variables = jax.eval_shape(lambda: ref.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)),
        train=False))
    want = {(coll, tuple(p.key for p in path))
            for coll in ("params", "batch_stats")
            for path, _ in jax.tree_util.tree_leaves_with_path(
                variables[coll])}
    got = {(coll, tuple(path)) for coll, path, _, _ in TI.flax_leaves(model)}
    assert got == want
    model.init_random(torch.Generator().manual_seed(0))
    assert all(bool(t.isfinite().all()) for t in model.parameters())


def test_job_trains_inception_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.resnet_main",
         "--model", "inception_v3", "--device", "cpu", "--image-size",
         str(IMAGE), "--batch-per-chip", "2", "--train-steps", "2",
         "--log-every", "1"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "training inception_v3 on 1 devices (cpu), global batch 2" in (
        out.stderr)
    logged = re.findall(r"step (\d+) loss ([0-9.]+) images/sec", out.stderr)
    assert [int(s) for s, _ in logged] == [1, 2], out.stderr
