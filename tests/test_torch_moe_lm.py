"""The port's MoE LM trainer (container_engine_accelerators_tpu_torch/
models/moe_lm.py) against the reference's (models/moe_lm.py): the
reference's MoETransformerLM on a 2-device sub-mesh ("ep", f32, dense
attention: the reference's CPU path), its build_moe_lm_training step
written out in f32 (xent + aux_weight * the layers' mean aux loss,
optax.adamw), and the port's build_moe_lm_training on two gloo ranks
(tests/torch_ranks.py), from the same numpy-drawn tree.  The reference
builds its embedding and head modules at their default bf16 whatever
the blocks' dtype; both sides run them in f32 (the reference's modules
through functools.partial, the port's through fringe_dtype).

Held: three steps' losses, aux losses and drop fractions within 1e-4
relative; the first step's gradients, each rank's experts against the
reference's rows of w_in / w_out, the rest whole, every leaf within
1e-4 of its largest entry.  On one rank the seeded trainer's loss falls
over 20 steps, and its routing metrics stay in range.  A checkpoint
written by two ranks, each holding half the experts, restores on one:
its parameters and AdamW moments are the two ranks' pieces, bitwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_port import assert_trees_close, rank_pools
from container_engine_accelerators_tpu.models import moe_lm as JM
from container_engine_accelerators_tpu.models import transformer as T
from container_engine_accelerators_tpu.ops.losses import cross_entropy_loss

MODEL = dict(vocab=64, dim=32, depth=2, heads=2, n_experts=4, moe_every=2)
SEQ, BATCH, LR, AUX_W, CF = 16, 4, 1e-2, 0.01, 1.25
CFG = dict(MODEL, seq_len=SEQ, batch=BATCH, learning_rate=LR,
           aux_weight=AUX_W, capacity_factor=CF)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from rank_pools(tmp_path_factory)


def _draw(model, seed):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"])
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        name, parent = names[-1], names[-2]
        if name == "embedding":
            std = 1.0
        elif name == "pos_emb":
            std = 0.5
        elif name in ("w_in", "w_out"):
            std = 1.0 / np.sqrt(s.shape[1])
        elif name in ("kernel", "router"):
            std = 2.0 / np.sqrt(s.shape[0])
        elif parent.startswith("LayerNorm") and name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        else:
            std = 0.1
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_three_steps_match_reference(pools, monkeypatch):
    import optax
    import torch

    # The reference's MoE LM builds its embedding and head modules at
    # their default bf16; both sides run them in f32 here.
    for name in ("EmbedIn", "HeadOut"):
        monkeypatch.setattr(JM, name, functools.partial(
            getattr(T, name), dtype=jnp.float32))
    world = 2
    mesh = Mesh(np.array(jax.devices()[:world]), ("ep",))
    model = JM.MoETransformerLM(
        mesh=mesh, ep_axis="ep", max_seq=SEQ, dtype=jnp.float32,
        attn_fn=T.full_causal_attention, capacity_factor=CF, **MODEL)
    params = _draw(model, 12)
    tok = np.random.default_rng(13).integers(0, MODEL["vocab"],
                                             size=(BATCH, SEQ + 1))
    tokens, targets = tok[:, :-1], tok[:, 1:]

    def loss_fn(p):
        logits, cols = model.apply({"params": p}, tokens,
                                   mutable=["moe_metrics"])
        xent = cross_entropy_loss(logits.reshape(-1, MODEL["vocab"]),
                                  targets.reshape(-1))
        m = cols["moe_metrics"]
        aux = jnp.mean(jnp.stack([v[0] for _, v in JM._iter_sown(
            m, "aux_loss")]))
        drop = jnp.mean(jnp.stack([v[0] for _, v in JM._iter_sown(
            m, "drop_frac")]))
        return xent + AUX_W * aux, (aux, drop)

    tx = optax.adamw(LR)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(p)
    want, first = [], None
    for _ in range(3):
        (loss, (aux, drop)), grads = grad_fn(p)
        want.append((float(loss), float(aux), float(drop)))
        first = grads if first is None else first
        updates, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, updates)
    got = pools(world).run("train", kind="ep", cfg=CFG, tokens=tokens,
                           targets=targets, steps=3, params=params,
                           fringe_dtype=torch.float32)
    e_local = MODEL["n_experts"] // world
    for rank, r in enumerate(got):
        np.testing.assert_allclose(r["losses"], [w[0] for w in want],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["aux"], [w[1] for w in want],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["drop"], [w[2] for w in want],
                                   rtol=1e-4, atol=1e-6)
        mine = functools.partial(
            lambda a, path: (np.asarray(a)[rank * e_local:
                                           (rank + 1) * e_local]
                             if path[-1].key in ("w_in", "w_out")
                             else np.asarray(a)))
        local = jax.tree_util.tree_map_with_path(
            lambda path, a: mine(a, path), first)
        assert_trees_close(r["grads"], local, 1e-4, f"rank {rank}")


def test_one_rank_loss_falls_over_20_steps(pools):
    tok = np.random.default_rng(14).integers(0, MODEL["vocab"],
                                             size=(BATCH, SEQ + 1))
    (r,) = pools(1).run("train", kind="ep", cfg=CFG, tokens=tok[:, :-1],
                        targets=tok[:, 1:], steps=20)
    assert all(np.isfinite(r["losses"]))
    assert r["losses"][-1] < r["losses"][0]
    assert all(0.0 < a < MODEL["n_experts"] for a in r["aux"])
    assert all(0.0 <= d <= 1.0 for d in r["drop"])


def test_checkpoint_from_two_ranks_restores_on_one(pools, tmp_path):
    path = str(tmp_path / "moe")
    saved = pools(2).run("moe_checkpoint", cfg=CFG, path=path, save=True)
    (restored,) = pools(1).run("moe_checkpoint", cfg=CFG, path=path,
                               save=False)
    assert restored["step"] == saved[0]["step"] == 2
    for key, value in restored.items():
        if key == "step":
            continue
        if ".w_in" in key or ".w_out" in key:
            want = np.concatenate([r[key] for r in saved])
        else:
            want = saved[0][key]
            np.testing.assert_array_equal(saved[1][key], want)
        np.testing.assert_array_equal(value, want, err_msg=key)
