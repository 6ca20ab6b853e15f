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
on the CPU) and its mean.  ResNet: one step of the reference's
train_step math on the 2-device mesh (flax BatchNorm over the global
batch under jit) against the port's, the loss within 1e-5, gradients
within 1e-4, the running statistics within 1e-5."""

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


def test_resnet_dp_takes_global_batch_norm_statistics(pools):
    import optax  # noqa: F401  (the reference's optimizer module)

    module = JRN.ResNet18(num_classes=CLASSES, dtype=jnp.float32, **RESNET)
    params, stats = draw_vision_trees(module, (1, IMAGE, IMAGE, 3), 5,
                                      {"train": False})
    rng = np.random.default_rng(6)
    images = rng.standard_normal((RBATCH, IMAGE, IMAGE, 3)).astype(np.float32)
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
        labels=labels, num_classes=CLASSES,
        model_kwargs=dict(RESNET, dtype=__import__("torch").float32))
    for r in got:
        assert r["loss"] == pytest.approx(float(loss), rel=1e-5)
        assert_trees_close(r["grads"], grads, 1e-4, "resnet")
        assert_trees_close(r["batch_stats"], new_stats, 1e-5, "stats")
