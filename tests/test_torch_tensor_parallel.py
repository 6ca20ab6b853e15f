"""The port's tensor-parallel LM trainer (container_engine_accelerators_
tpu_torch/models/transformer.py build_lm_training_tp: TPTransformerLM,
the vocab-parallel cross entropy) against the reference's
(build_lm_training_tp :631 with lm_tp_param_specs :593): the reference's
model with its parameters placed by lm_tp_param_specs on a 2-device
sub-mesh (tp), or a 2 x 2 one (dp x tp, the batch over "data"), GSPMD
partitioning the f32 step under jit; the port on as many gloo ranks
(tests/torch_ranks.py), each holding its shard of the same numpy-drawn
weights (models/convert.py shard_flax_params).

Held: the first loss within 1e-5 relative of the reference's and of
the single-device loss, the second (after an AdamW update) within 1e-4;
the first step's gradients,
the ranks' shards joined along lm_tp_param_specs' dims, every leaf
within 1e-4 of its largest entry.  The reference's builders compute in
bf16, so its side is the step written out in f32 (reference_adamw)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from _torch_port import (
    assert_trees_close,
    draw_params,
    rank_pools,
    reference_adamw,
)
from container_engine_accelerators_tpu.models import transformer as T
from container_engine_accelerators_tpu.ops.losses import cross_entropy_loss
from container_engine_accelerators_tpu_torch.models import (
    transformer as PT,
)

MODEL = dict(vocab=64, dim=32, depth=2, heads=4)
SEQ, BATCH, LR = 32, 4, 1e-2
CFG = dict(MODEL, seq_len=SEQ, batch=BATCH, learning_rate=LR)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from rank_pools(tmp_path_factory)


def _join(shards, specs):
    """The whole tree from the tp ranks' shard trees."""
    if isinstance(specs, dict):
        return {k: _join([s[k] for s in shards], specs[k]) for k in specs}
    if specs is None:
        return shards[0]
    return np.concatenate(shards, axis=specs)


@pytest.mark.parametrize("kind,world", [("tp", 2), ("dptp", 4)])
def test_tp_trainer_matches_reference(pools, kind, world):
    params = draw_params(4, dict(MODEL, max_seq=SEQ))
    tok = np.random.default_rng(world).integers(
        0, MODEL["vocab"], size=(BATCH, SEQ + 1))
    tokens, targets = tok[:, :-1], tok[:, 1:]
    n_dp = 2 if kind == "dptp" else 1
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(n_dp, world // n_dp),
                ("data", "model"))
    ref_specs = T.lm_tp_param_specs(params, "model")
    shardings = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), ref_specs,
        is_leaf=lambda x: isinstance(x, P))
    data = NamedSharding(mesh, P("data" if n_dp > 1 else None))
    model = T.TransformerLM(dtype=jnp.float32, max_seq=SEQ,
                            attn_fn=T.full_causal_attention, **MODEL)

    def loss_fn(p, tokens, targets):
        logits = model.apply({"params": p}, tokens)
        return cross_entropy_loss(logits.reshape(-1, MODEL["vocab"]),
                                  targets.reshape(-1))

    losses, grads = reference_adamw(
        loss_fn, params, 2, LR, tokens, targets,
        jit_kw=dict(in_shardings=(shardings, data, data)))
    single, _ = reference_adamw(loss_fn, params, 1, LR, tokens, targets)
    got = pools(world).run("train", kind=kind, cfg=CFG, tokens=tokens,
                           targets=targets, steps=2, params=params)
    specs = PT.lm_tp_param_specs(params, "model")
    n_tp = world // n_dp
    for r in got:
        assert r["losses"][0] == pytest.approx(losses[0], rel=1e-5)
        assert r["losses"][0] == pytest.approx(single[0], rel=1e-5)
        # After one AdamW update: the update is ~lr * sign(g) wherever
        # |g| is near eps, so the f32 noise of another summation order
        # (the psums of partial products) moves the next loss by ~2e-5.
        assert r["losses"][1] == pytest.approx(losses[1], rel=1e-4)
    for d in range(n_dp):
        joined = _join([got[d * n_tp + t]["grads"] for t in range(n_tp)],
                       specs)
        assert_trees_close(joined, grads, 1e-4, kind)


def test_port_specs_are_the_references_dims():
    params = draw_params(4, dict(MODEL, max_seq=SEQ))
    ref = jax.tree_util.tree_map(
        lambda s: next((i for i, a in enumerate(s) if a == "model"), None),
        T.lm_tp_param_specs(params, "model"),
        is_leaf=lambda x: isinstance(x, P))
    assert PT.lm_tp_param_specs(params, "model") == ref


@pytest.mark.parametrize("kw,match", [
    (dict(heads=3), "heads"),
    (dict(vocab=63), "vocab"),
])
def test_indivisible_shapes_raise(pools, kw, match):
    got = pools(2).run("tp_refusal", cfg=dict(CFG, **kw))
    assert all(match in r for r in got), got
