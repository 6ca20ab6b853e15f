"""The port's data- and sequence-parallel trainers against the
reference's, and its data-parallel ResNet trainer with global BatchNorm
statistics: the reference's model and loss on a 2-device sub-mesh of
the virtual CPU mesh (batch-sharded for dp; the KV ring of
parallel/ring_attention.py for sp, in the contiguous and the zigzag
layout), the port's build_lm_training / build_training over a mesh of
as many gloo ranks (tests/torch_ranks.py), on the same numpy-drawn f32
weights and batch (the ring alone also runs at 4 ranks, in
test_torch_ring_attention.py).

Held: the losses of two AdamW steps within 1e-5 relative (the second
holds the update, made from the summed gradients); the first step's
gradients, every leaf within 1e-4 of its largest entry.  The reference's
builders compute in bf16, so its side is their step written out in f32
(reference_adamw: value_and_grad and optax.adamw, as the builders'
step_fn).  dp runs the port's fused per-shard loss (its plain version
on the CPU) and its mean.  Vision: one step of the reference's
train_step math on the 2-device mesh (BatchNorm over the global batch
under jit) against the port's, for every model and norm the reference
trains under a mesh (ResNet-18 with the fused norm and with flax's,
ResNet-50's fused block on the fused-matmul kernels' plain versions,
Inception v3 at 75 pixels): the loss within 1e-5, gradients within
1e-4, the running statistics within 1e-5; Inception v3 at the whole-
model limits of test_torch_inception.py (reason at INCEPTION_LOSS_REL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_port import (
    assert_trees_close,
    draw_params,
    draw_vision_trees,
    rank_pools,
    reference_adamw,
)
from container_engine_accelerators_tpu.models import inception as JI
from container_engine_accelerators_tpu.models import resnet as JRN
from container_engine_accelerators_tpu.models import transformer as T
from container_engine_accelerators_tpu.ops.losses import cross_entropy_loss
from container_engine_accelerators_tpu.parallel.ring_attention import (
    zigzag_permutation,
)

MODEL = dict(vocab=64, dim=32, depth=2, heads=2)
SEQ, BATCH, LR = 32, 4, 1e-2
CFG = dict(MODEL, seq_len=SEQ, batch=BATCH, learning_rate=LR)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from rank_pools(tmp_path_factory)


def _batch(seed, batch=BATCH, vocab=MODEL["vocab"]):
    tok = np.random.default_rng(seed).integers(
        0, vocab, size=(batch, SEQ + 1)).astype(np.int64)
    return tok[:, :-1], tok[:, 1:]


def _lm_loss(attn_fn, positions=None):
    model = T.TransformerLM(dtype=jnp.float32, max_seq=SEQ, attn_fn=attn_fn,
                            **MODEL)

    def loss_fn(params, tokens, targets):
        logits = model.apply({"params": params}, tokens, positions=positions)
        return cross_entropy_loss(logits.reshape(-1, MODEL["vocab"]),
                                  targets.reshape(-1))

    return loss_fn


@pytest.mark.parametrize("kind,world", [
    ("dp", 2), ("sp", 2), ("zigzag", 2)])
def test_lm_trainer_matches_reference(pools, kind, world):
    params = draw_params(3, dict(MODEL, max_seq=SEQ))
    tokens, targets = _batch(world)
    devs = np.array(jax.devices()[:world])
    if kind == "dp":
        mesh = Mesh(devs.reshape(world, 1), ("data", "model"))
        data = NamedSharding(mesh, P(("data", "model")))
        rep = NamedSharding(mesh, P())
        loss_fn = _lm_loss(T.full_causal_attention)
        jit_kw = dict(in_shardings=(rep, data, data))
        kw = dict(loss_impl="fused", attn_impl="dense")
    else:
        mesh = Mesh(devs.reshape(1, world), ("data", "model"))
        layout = "zigzag" if kind == "zigzag" else "contiguous"
        perm = None
        if kind == "zigzag":
            perm = zigzag_permutation(SEQ, world)
            tokens, targets = tokens[:, perm], targets[:, perm]
        loss_fn = _lm_loss(T.build_ring_attn(mesh, "model", layout=layout),
                           None if perm is None else jnp.asarray(perm))
        jit_kw = None
        kw = {}
    losses, grads = reference_adamw(loss_fn, params, 2, LR, tokens, targets,
                                    jit_kw=jit_kw)
    got = pools(world).run("train", kind=kind, cfg=CFG, tokens=tokens,
                           targets=targets, steps=2, params=params, **kw)
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        assert_trees_close(r["grads"], grads, 1e-4, kind)


def test_seeded_dp_trainer_equals_the_one_rank_trainer(pools):
    # Without params every rank draws the one-rank trainer's weights.
    import torch

    from container_engine_accelerators_tpu_torch.models import (
        transformer as PT,
    )

    tokens, targets = _batch(11)
    step, state, _ = PT.build_lm_training(**CFG, device="cpu",
                                          dtype=torch.float32)
    _, loss = step(state, torch.from_numpy(tokens), torch.from_numpy(targets))
    got = pools(2).run("train", kind="dp", cfg=CFG, tokens=tokens,
                       targets=targets)
    assert got[0]["losses"][0] == pytest.approx(float(loss), rel=1e-6)


RESNET = dict(stage_sizes=[1, 1], num_filters=8)
CLASSES, IMAGE, RBATCH = 4, 16, 8
INCEPTION_IMAGE = 75  # the smallest image Inception v3 takes
# The whole Inception v3 step is held at tests/test_torch_inception.py's
# whole-model limits: its late BatchNorms see 1 x 1 pixels, where the
# fast variance amplifies f32 rounding, so a reordered sum (the
# reference's own 2-device mesh against its one-device step) moves a
# late kernel's gradient by up to 70% of the leaf's largest entry.
INCEPTION_LOSS_REL, INCEPTION_HEAD_REL, INCEPTION_STATS_REL = (
    2.0 ** -9, 2.0 ** -9, 2.0 ** -7)

# (port model name, the reference's module, the port's model kwargs,
# image size): the configurations the reference trains under a mesh.
DP_CASES = {
    "resnet18-fused": ("resnet18", lambda: JRN.ResNet18(
        num_classes=CLASSES, dtype=jnp.float32, **RESNET), RESNET, IMAGE),
    "resnet18-flax_norm": ("resnet18", lambda: JRN.ResNet18(
        num_classes=CLASSES, dtype=jnp.float32, norm_impl="flax", **RESNET),
        dict(RESNET, norm_impl="flax"), IMAGE),
    "resnet50-fused_pallas": ("resnet50", lambda: JRN.ResNet50(
        num_classes=CLASSES, dtype=jnp.float32, block_impl="fused_pallas",
        stem="s2d", **RESNET),
        dict(RESNET, block_impl="fused_pallas", stem="s2d"), IMAGE),
    "inception_v3": ("inception_v3", lambda: JI.InceptionV3(
        num_classes=CLASSES, dtype=jnp.float32), {}, INCEPTION_IMAGE),
}


@pytest.mark.parametrize("case", list(DP_CASES))
def test_resnet_dp_takes_global_batch_norm_statistics(pools, case):
    import optax  # noqa: F401  (the reference's optimizer module)

    name, make, kw, image = DP_CASES[case]
    module = make()
    params, stats = draw_vision_trees(module, (1, image, image, 3), 5,
                                      {"train": False})
    rng = np.random.default_rng(6)
    images = rng.standard_normal((RBATCH, image, image, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=(RBATCH,)).astype(np.int64)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    data = NamedSharding(mesh, P(("data", "model")))
    rep = NamedSharding(mesh, P())

    def loss_fn(p, images, labels):
        logits, new = module.apply({"params": p, "batch_stats": stats},
                                   images, train=True,
                                   mutable=["batch_stats"])
        return cross_entropy_loss(logits, labels), new["batch_stats"]

    (loss, new_stats), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True),
        in_shardings=(rep, data, data))(params, images, labels)
    got = pools(2).run(
        "resnet", params=params, batch_stats=stats, images=images,
        labels=labels, num_classes=CLASSES, model_name=name,
        model_kwargs=dict(kw, dtype=__import__("torch").float32),
        timeout_s=300)
    for r in got:
        if name == "inception_v3":
            assert r["loss"] == pytest.approx(float(loss),
                                              rel=INCEPTION_LOSS_REL)
            assert_trees_close(r["grads"]["head"], grads["head"],
                               INCEPTION_HEAD_REL, case)
            assert_trees_close(r["batch_stats"], new_stats,
                               INCEPTION_STATS_REL, "stats")
            continue
        assert r["loss"] == pytest.approx(float(loss), rel=1e-5)
        assert_trees_close(r["grads"], grads, 1e-4, case)
        assert_trees_close(r["batch_stats"], new_stats, 1e-5, "stats")
