"""The port's ring attention (container_engine_accelerators_tpu_torch/
parallel/ring_attention.py) against the reference's
(parallel/ring_attention.py): ring_attention_sharded of both packages,
the reference's on a 2- or 4-device sub-mesh of the virtual CPU mesh,
the port's on as many gloo ranks (tests/torch_ranks.py), causal, in the
contiguous and the zigzag layout, on the same numpy-drawn f32 q, k, v.

Held: the output against the reference's and against full causal
attention over the whole sequence, and the gradients of sum(out * g)
with respect to q, k and v against the reference's, each within 1e-5
of the largest entry.  The zigzag permutation is the reference's, and
its inverse maps the output back to the contiguous order."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_port import rank_pools
from container_engine_accelerators_tpu.models import transformer as JT
from container_engine_accelerators_tpu_torch.parallel import (
    ring_attention as PR,
)

# The package's __init__ exports the function under the module's name.
JR = importlib.import_module(
    "container_engine_accelerators_tpu.parallel.ring_attention")
B, S, H, D = 2, 32, 2, 8
TOL = 1e-5


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from rank_pools(tmp_path_factory)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("ring", [2, 4])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_matches_reference_and_full_attention(pools, ring, layout):
    rng = np.random.default_rng(ring * 10 + len(layout))
    q, k, v, g = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    perm = PR.zigzag_permutation(S, ring) if layout == "zigzag" else None
    if perm is not None:
        np.testing.assert_array_equal(perm, JR.zigzag_permutation(S, ring))
        q, k, v, g = (a[:, perm] for a in (q, k, v, g))
    mesh = Mesh(np.array(jax.devices()[:ring]), ("sp",))

    def objective(q, k, v):
        out = JR.ring_attention_sharded(q, k, v, mesh, "sp", causal=True,
                                        layout=layout)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    got = pools(ring).run("ring", q=q, k=k, v=v, g_out=g, layout=layout)
    _close(got[0]["out"], out)
    for name, want in zip(("dq", "dk", "dv"), grads):
        _close(got[0][name], want)
    # Against full causal attention in the contiguous order.
    full = np.asarray(JT.full_causal_attention(
        *(jnp.asarray(a if perm is None else a[:, np.argsort(perm)])
          for a in (q, k, v))))
    port = got[0]["out"]
    if perm is not None:
        port = port[:, np.argsort(perm)]
    _close(port, full)


def test_zigzag_needs_divisible_sequence():
    with pytest.raises(ValueError, match="divisible"):
        PR.zigzag_permutation(30, 4)
