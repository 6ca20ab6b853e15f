"""The port's pipeline parallelism (container_engine_accelerators_tpu_
torch/parallel/pipeline.py and models/pipeline_lm.py) against the
reference's (parallel/pipeline.py, models/pipeline_lm.py): the
reference's embed, StageStack and head modules marched through its
pipeline_sharded on a 2-device sub-mesh ("pp"), in f32, and the port's
build_lm_training_pp on two gloo ranks (tests/torch_ranks.py), from the
same numpy-drawn tree (stages stacked in chunk_shard_order), plain GPipe
(n_virtual 1) and interleaved (n_virtual 2).

Held: the first loss within 1e-5 relative of the reference's pipelined
loss and of the port's own sequential_reference_loss, and within 1e-2
of the reference's sequential_reference_loss (whose modules compute in
bf16); the second (after an AdamW update) within 1e-4; the first
step's gradients, each rank's chunks against the reference's stacked
gradients at its shard slots, the replicated embedding and head whole,
every leaf within 1e-4 of its largest entry.  pipeline_sharded itself
on tanh(x @ w) stages (2 stages, V 1 and 2, 4 microbatches): the
output and the gradients of the chunks and microbatches within 1e-5.
chunk_shard_order and bubble_fraction equal the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_port import (
    assert_trees_close,
    draw_params,
    rank_pools,
    reference_adamw,
)
from container_engine_accelerators_tpu.models import pipeline_lm as JPL
from container_engine_accelerators_tpu.models import transformer as T
from container_engine_accelerators_tpu.ops.losses import cross_entropy_loss
from container_engine_accelerators_tpu.parallel import pipeline as JP
from container_engine_accelerators_tpu_torch.parallel import pipeline as PP

MODEL = dict(vocab=64, dim=32, heads=2)
SEQ, BATCH, LR, MICRO, STAGES = 32, 4, 1e-2, 4, 2


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from rank_pools(tmp_path_factory)


def _pipeline_tree(depth, n_virtual, seed):
    """A reference pipeline tree from a TransformerLM draw: block j of
    the draw is layer j % lps of virtual stage j // lps."""
    flat = draw_params(seed, dict(MODEL, depth=depth, max_seq=SEQ))
    n_chunks = STAGES * n_virtual
    lps = depth // n_chunks
    order = JP.chunk_shard_order(STAGES, n_virtual)
    stages = {
        f"layer_{l}": jax.tree_util.tree_map(
            lambda *xs: np.stack(xs),
            *[flat[f"block_{order[i] * lps + l}"] for i in range(n_chunks)])
        for l in range(lps)}
    return {"embed": {"Embed_0": flat["Embed_0"], "pos_emb": flat["pos_emb"]},
            "stages": stages,
            "head": {"LayerNorm_0": flat["LayerNorm_0"],
                     "lm_head": flat["lm_head"]}}, lps


def _slot(tree, i):
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[i], tree)


@pytest.mark.parametrize("n_virtual", [1, 2])
def test_pipeline_trainer_matches_reference(pools, n_virtual):
    depth = 2 * STAGES * n_virtual // 2
    params, lps = _pipeline_tree(depth, n_virtual, 8 + n_virtual)
    tok = np.random.default_rng(n_virtual).integers(
        0, MODEL["vocab"], size=(BATCH, SEQ + 1))
    tokens, targets = tok[:, :-1], tok[:, 1:]
    mesh = Mesh(np.array(jax.devices()[:STAGES]), ("pp",))
    f32 = jnp.float32
    embed = T.EmbedIn(MODEL["vocab"], MODEL["dim"], max_seq=SEQ, dtype=f32)
    head = T.HeadOut(MODEL["vocab"], dtype=f32)
    stage = JPL.StageStack(MODEL["dim"], MODEL["heads"], lps, dtype=f32,
                           attn_fn=T.full_causal_attention)
    mb = BATCH // MICRO

    def loss_fn(p, tokens, targets):
        emb = embed.apply({"params": p["embed"]}, tokens)
        outs = JP.pipeline_sharded(
            lambda sp, x: stage.apply({"params": sp}, x), p["stages"],
            emb.reshape(MICRO, mb, SEQ, MODEL["dim"]), mesh, "pp",
            n_virtual=n_virtual)
        logits = head.apply({"params": p["head"]},
                            outs.reshape(BATCH, SEQ, MODEL["dim"]))
        return cross_entropy_loss(logits.reshape(-1, MODEL["vocab"]),
                                  targets.reshape(-1))

    losses, grads = reference_adamw(loss_fn, params, 2, LR, tokens, targets)
    sequential = float(JPL.sequential_reference_loss(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        jnp.asarray(tokens), jnp.asarray(targets), attn_impl="dense",
        n_virtual=n_virtual))
    cfg = dict(MODEL, depth=depth, seq_len=SEQ, batch=BATCH,
               learning_rate=LR, n_micro=MICRO, n_virtual=n_virtual)
    got = pools(STAGES).run("train", kind="pp", cfg=cfg, tokens=tokens,
                            targets=targets, steps=2, params=params)
    order = JP.chunk_shard_order(STAGES, n_virtual)
    for d, r in enumerate(got):
        assert r["losses"][0] == pytest.approx(losses[0], rel=1e-5)
        assert r["sequential"] == pytest.approx(losses[0], rel=1e-5)
        assert r["losses"][0] == pytest.approx(sequential, rel=1e-2)
        # After an update: ~lr * sign(g) where |g| is near eps (see
        # test_torch_tensor_parallel.py).
        assert r["losses"][1] == pytest.approx(losses[1], rel=1e-4)
        assert r["info"]["bubble_fraction"] == pytest.approx(
            JP.bubble_fraction(STAGES, MICRO, n_virtual))
        slots = [d * n_virtual + c for c in range(n_virtual)]
        want = {"embed": grads["embed"], "head": grads["head"],
                "stages": jax.tree_util.tree_map(
                    lambda a: np.asarray(a)[slots], grads["stages"])}
        assert_trees_close(r["grads"], want, 1e-4, f"rank {d}")
        assert [order[s] for s in slots] == [c * STAGES + d
                                             for c in range(n_virtual)]


@pytest.mark.parametrize("n_virtual", [1, 2])
def test_pipeline_sharded_matches_reference(pools, n_virtual):
    rng = np.random.default_rng(20 + n_virtual)
    n_chunks, width = STAGES * n_virtual, 8
    w = (rng.standard_normal((n_chunks, width, width)) /
         np.sqrt(width)).astype(np.float32)
    micro = rng.standard_normal((4, 3, width)).astype(np.float32)
    g = rng.standard_normal(micro.shape).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:STAGES]), ("pp",))

    def objective(w, micro):
        out = JP.pipeline_sharded(lambda wc, h: jnp.tanh(h @ wc), w, micro,
                                  mesh, "pp", n_virtual=n_virtual)
        return jnp.sum(out * g), out

    (_, out), (dw, dx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(w, micro)
    got = pools(STAGES).run("pipeline_toy", w=list(w), micro=micro,
                            g_out=g, n_virtual=n_virtual)
    for r in got:
        np.testing.assert_allclose(r["out"], out, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.stack(r["dw"]), dw, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["dx"], dx, rtol=0, atol=1e-5)


@pytest.mark.parametrize("s,v", [(1, 1), (2, 1), (2, 2), (4, 3), (8, 2)])
def test_schedule_helpers_match_reference(s, v):
    assert PP.chunk_shard_order(s, v) == JP.chunk_shard_order(s, v)
    for m in (1, 4, 16):
        assert PP.bubble_fraction(s, m, v) == JP.bubble_fraction(s, m, v)
