"""The port's expert-parallel MoE FFN (container_engine_accelerators_
tpu_torch/parallel/moe.py) against the reference's (parallel/moe.py):
the reference's moe_ffn_sharded on a 1-, 2- or 4-device sub-mesh of the
virtual CPU mesh, the port's moe_ffn_forward on as many gloo ranks
(tests/torch_ranks.py), on the same numpy-drawn f32 tokens and weights.

Held: the output, the aux loss and the drop fraction within 1e-5; the
routing itself, lane by lane (which token each expert lane holds,
read from the buffer the reference hands its first all_to_all, and
which routes were kept); the gradients of sum(out * g) + 0.3 * aux with
respect to the tokens, the router and both expert weights within 1e-4
(relative to the largest entry).  Top-1 and top-2, zero and two reroute
rounds, and a capacity factor of 0.5 that drops routes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_port import rank_pools
from container_engine_accelerators_tpu.parallel import moe as JM

TOKENS, DIM, HIDDEN, EXPERTS = 16, 8, 16, 8
C_AUX = 0.3
CASES = [  # (top_k, n_reroute, capacity_factor)
    (2, 2, 1.25), (1, 0, 1.25), (2, 0, 0.5), (2, 2, 0.5), (1, 2, 0.5),
]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from rank_pools(tmp_path_factory)


def _draw(seed, world):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((TOKENS * world, DIM)).astype(f),
        router=(0.5 * rng.standard_normal((DIM, EXPERTS))).astype(f),
        w_in=(rng.standard_normal((EXPERTS, DIM, HIDDEN)) /
              np.sqrt(DIM)).astype(f),
        w_out=(rng.standard_normal((EXPERTS, HIDDEN, DIM)) /
               np.sqrt(HIDDEN)).astype(f),
        g_out=rng.standard_normal((TOKENS * world, DIM)).astype(f),
    )


def _reference(d, world, top_k, n_reroute, cf, monkeypatch):
    mesh = Mesh(np.array(jax.devices()[:world]), ("ep",))
    sends = {}
    real = JM.lax

    class _Lax:
        def __getattr__(self, name):
            return getattr(real, name)

        def all_to_all(self, x, axis_name, *a, **kw):
            def record(i, buf):
                sends.setdefault(int(i), np.asarray(buf))

            jax.debug.callback(record, real.axis_index(axis_name), x)
            return real.all_to_all(x, axis_name, *a, **kw)

    monkeypatch.setattr(JM, "lax", _Lax())
    fn = functools.partial(JM.moe_ffn_sharded, mesh=mesh, axis_name="ep",
                           capacity_factor=cf, top_k=top_k,
                           n_reroute=n_reroute)

    def objective(x, router, w_in, w_out):
        out, aux, drop = fn(x, router, w_in, w_out)
        return jnp.sum(out * d["g_out"]) + C_AUX * aux, (out, aux, drop)

    args = [jnp.asarray(d[k]) for k in ("x", "router", "w_in", "w_out")]
    (_, (out, aux, drop)), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    jax.effects_barrier()
    # The first exchange's buffer of each device (the second exchange
    # records after it and is ignored by setdefault).
    return out, aux, drop, grads, sends


def _lane_tokens(send, x_local):
    """Token + 1 held by each lane of a send buffer, 0 for an empty."""
    flat = send.reshape(-1, send.shape[-1])
    out = np.zeros(len(flat), np.int64)
    for lane, row in enumerate(flat):
        hit = np.flatnonzero((x_local == row).all(1))
        if hit.size:
            out[lane] = hit[0] + 1
        else:
            assert not row.any(), lane
    return out


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("top_k,n_reroute,cf", CASES)
def test_moe_matches_reference(pools, world, top_k, n_reroute, cf,
                               monkeypatch):
    d = _draw(7 + world, world)
    out, aux, drop, grads, sends = _reference(d, world, top_k, n_reroute,
                                              cf, monkeypatch)
    got = pools(world).run("moe", c_aux=C_AUX, capacity_factor=cf,
                           top_k=top_k, n_reroute=n_reroute, **d)
    _close(got[0]["out"], out, 1e-5)
    for r in got:
        assert r["aux"] == pytest.approx(float(aux), abs=1e-5)
        assert r["drop"] == pytest.approx(float(drop), abs=1e-5)
    for rank, r in enumerate(got):
        x_local = d["x"][rank * TOKENS:(rank + 1) * TOKENS]
        want = _lane_tokens(sends[rank], x_local)
        np.testing.assert_array_equal(r["send_slots"], want)
        assert int(r["keep"].sum()) == int((want > 0).sum())
    if cf < 1:
        assert float(drop) > 0, "the case must drop routes"
    for name, g in zip(("dx", "drouter", "dw_in", "dw_out"), grads):
        _close(got[0][name], g, 1e-4)


def test_negative_reroute_raises():
    import torch

    from container_engine_accelerators_tpu_torch.parallel.moe import (
        moe_ffn_forward,
    )

    with pytest.raises(ValueError, match="n_reroute"):
        moe_ffn_forward(torch.zeros(4, 2), torch.zeros(2, 2),
                        torch.zeros(2, 2, 3), torch.zeros(2, 3, 2), None,
                        n_reroute=-1)
