"""Shared fixtures of the port's parity tests (tests/test_torch_*.py):
one flax param tree drawn with numpy from a seed, loaded into the JAX
reference and into the PyTorch port, at a small f32 configuration.

The params are drawn wider than flax's default init, so that greedy
decoding does not collapse onto one repeated token (at the default
init the tiny LM emits the same token every step, and token equality
would prove nothing).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from container_engine_accelerators_tpu.models import transformer as T
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import (
    transformer as PT,
)

# The suite may run under several xdist workers: keep torch's CPU
# thread pool small so they do not oversubscribe the cores.
torch.set_num_threads(2)

CFG = dict(vocab=64, dim=32, depth=2, heads=2, max_seq=64)
PAGE = 8
# SM counts of the H100 SXM and PCIe cards, for the kernels' grid plans.
H100_SMS = (132, 114)


def draw_params(seed: int, cfg=None):
    """A flax TransformerLM param tree (numpy f32 leaves) drawn from
    `seed`: kernels N(0, 4 / fan_in), biases N(0, 0.2^2), the token
    table N(0, 1), the positional table N(0, 0.5^2), LayerNorm scales
    1 + N(0, 0.1^2) and biases N(0, 0.1^2)."""
    cfg = cfg or CFG
    shapes = jax.eval_shape(
        lambda: T.TransformerLM(dtype=jnp.float32, **cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)
        )["params"]
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        name, parent = names[-1], names[-2] if len(names) > 1 else ""
        if name == "embedding":
            std = 1.0
        elif name == "pos_emb":
            std = 0.5
        elif name == "kernel":
            std = 2.0 / np.sqrt(s.shape[0])
        elif parent.startswith("LayerNorm") and name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32
            )
        elif parent.startswith("LayerNorm"):
            std = 0.1
        else:
            std = 0.2
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def draw_vision_trees(module, x_shape, seed, init_kw=None):
    """(params, batch_stats) of a flax vision module (numpy f32 leaves)
    drawn from `seed`: kernels N(0, 2 / fan_in), every norm scale
    1 + N(0, 0.2^2) (nonzero, so that the zero-initialized last norm of
    each block passes gradients), biases N(0, 0.1^2), running means
    N(0, 0.1^2) and variances 1 + |N(0, 0.2^2)|."""
    variables = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            jnp.zeros(x_shape, jnp.float32),
                            **(init_kw or {}))
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            v = np.sqrt(2.0 / fan_in) * rng.standard_normal(s.shape)
        elif name.endswith("scale"):
            v = 1.0 + 0.2 * rng.standard_normal(s.shape)
        elif name.endswith("var"):
            v = 1.0 + np.abs(0.2 * rng.standard_normal(s.shape))
        else:  # biases, running means
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    trees = jax.tree_util.tree_map_with_path(leaf, dict(variables))
    return trees["params"], trees.get("batch_stats", {})


def jax_decoder(cfg=None):
    return T.TransformerLM(dtype=jnp.float32, decode=True, **(cfg or CFG))


def jax_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def port_model(params, cfg=None, decode=True):
    """The port's f32 TransformerLM on the CPU holding `params`."""
    model = PT.TransformerLM(
        dtype=torch.float32, decode=decode, device="cpu", **(cfg or CFG)
    )
    return convert.load_flax_params(model, params)


def rand_prompt(seed: int, p_len: int, vocab: int = CFG["vocab"]):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(1, p_len)
    ).astype(np.int32)


def rank_pools(tmp_path_factory):
    """A module fixture's body: get(world) gives a pool of `world` gloo
    ranks (tests/torch_ranks.py), started once per test module and
    restarted after a failure; all are closed at the module's end."""
    from torch_ranks import RankPool

    made = {}

    def get(world):
        pool = made.get(world)
        if pool is None or pool.broken:
            if pool is not None:
                pool.close()
            pool = made[world] = RankPool(
                world, str(tmp_path_factory.mktemp(f"ranks{world}")))
        return pool

    yield get
    for pool in made.values():
        pool.close()


def assert_trees_close(got, want, rel, what=""):
    """Every leaf of `want` (a flax tree) within rel * max|leaf| of the
    same leaf of `got`."""
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert got.keys() == want.keys(), (what, sorted(map(str, got)),
                                       sorted(map(str, want)))
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[path], np.float32)
        assert g.shape == w.shape, (what, path)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(float(np.abs(w).max()), 1e-30),
            err_msg=what + jax.tree_util.keystr(path))


def reference_adamw(loss_fn, params, steps, lr, *args, jit_kw=None):
    """The reference trainers' step (value_and_grad, optax.adamw) run
    `steps` times on `loss_fn(params, *args)` -> (losses, the first
    step's gradients)."""
    import optax

    tx = optax.adamw(lr)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn), **(jit_kw or {}))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(params)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = grad_fn(params, *args)
        losses.append(float(loss))
        first = grads if first is None else first
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    return losses, first
