"""The port's dp-mesh serving (parallel/mesh.py LocalMesh) against the
reference's on its virtual 8-device CPU mesh, on the same numpy-drawn
f32 weights: the mesh engine's greedy tokens at 2, 4 and 8 shards, its
per-step logits against the reference model's forward, generate_sharded
with per-row prompt lengths, temperatures and top-k, the misuse errors,
a fleet of dp submeshes, and the process fleet's refusal of them.  The
server's --mesh dp is held in tests/test_torch_server_parity.py."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_port import (
    CFG, PAGE, draw_params, jax_decoder, jax_params, port_model,
    rand_prompt,
)
from container_engine_accelerators_tpu.models import generate as RG
from container_engine_accelerators_tpu.models import transformer as RT
from container_engine_accelerators_tpu.parallel.mesh import (
    dp_submeshes as ref_dp_submeshes,
)
from container_engine_accelerators_tpu.serving import (
    ContinuousBatchingEngine as RefEngine,
)
from container_engine_accelerators_tpu.serving.fleet import (
    FleetManager as RefFleet,
)
from container_engine_accelerators_tpu_torch.models import generate as G
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    LocalMesh, local_dp_submeshes,
)
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
)
from container_engine_accelerators_tpu_torch.serving.fleet import (
    FleetManager, ProcessFleetManager,
)

ATOL = 1e-4
# Staggered traffic: more requests than slots, so rows retire and
# refill on every shard.
SHAPES = [(11, 3, 6), (12, 7, 3), (13, 17, 8), (14, 9, 2), (15, 25, 5),
          (16, 6, 4), (17, 12, 7), (18, 4, 5), (19, 20, 3), (20, 8, 6)]
SHARDS = pytest.mark.parametrize("n", [2, 4, 8])


@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return params, port_model(params)


def _ref_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _fire(eng, shapes):
    handles = {}
    for seed, p_len, n in shapes:
        handles[seed] = eng.submit_nowait(rand_prompt(seed, p_len), n, 0.0)
        time.sleep(0.01)
    return {seed: h.wait(timeout=300) for seed, h in handles.items()}


@pytest.fixture(scope="module")
def reference(setup):
    """The reference mesh engine's greedy tokens on SHAPES, one engine a
    shard count (n_slots = shards), each run once."""
    params, _ = setup
    memo = {}

    def tokens(n):
        if n not in memo:
            eng = RefEngine(jax_decoder(), jax_params(params), n,
                            mesh=_ref_mesh(n), prompt_grid=4,
                            prefill_chunk=PAGE, observe=False)
            try:
                memo[n] = _fire(eng, SHAPES)
            finally:
                eng.close()
        return memo[n]

    return tokens


def _mesh_engine(pm, n, **kw):
    return ContinuousBatchingEngine(
        pm, n, mesh=LocalMesh(["cpu"] * n), prompt_grid=4,
        prefill_chunk=PAGE, observe=False, device="cpu", **kw)


def test_local_dp_submeshes_contract():
    devs = [f"cpu:{i}" for i in range(8)]
    subs = local_dp_submeshes(2, devs)
    assert [[str(d) for d in m.devices] for m in subs] == [
        devs[:4], devs[4:]]
    assert subs[0].axis_names == ("data",) and subs[0].shape == {"data": 4}
    assert local_dp_submeshes(8, devs) == [None] * 8
    for n in (3, 0):
        with pytest.raises(ValueError):
            local_dp_submeshes(n, devs)
    # The reference's contract on the same counts.
    ref = ref_dp_submeshes(2, jax.devices())
    assert [m.devices.size for m in ref] == [m.size for m in subs]
    assert ref_dp_submeshes(8, jax.devices()) == [None] * 8
    with pytest.raises(ValueError, match="divide"):
        ref_dp_submeshes(3, jax.devices())


@SHARDS
def test_mesh_engine_matches_reference_mesh_engine(setup, reference, n):
    # Every request's greedy tokens equal the reference's dp engine's,
    # and the engine really ran sharded: one cache block a shard, each
    # holding its share of the slot rows.
    _, pm = setup
    eng = _mesh_engine(pm, n, spec_k=4, decode_steps=4, paged=True)
    try:
        assert not eng._paged and eng._spec_k == 0
        assert eng._decode_steps == 0
        assert len(eng._cache) == n
        assert all(c[0]["k"].shape[0] == 1 for c in eng._cache)
        outs = _fire(eng, SHAPES)
        snap = eng.snapshot()
    finally:
        eng.close()
    want = reference(n)
    assert outs == want
    assert len({t for row in want.values() for t in row[0]}) > 3
    assert snap["admitted"] == snap["retired"] == len(SHAPES)
    assert "kv_pages_total" not in snap


def test_mesh_engine_per_step_logits_match_reference_forward(setup):
    # One request through a 4-shard engine with its slot on shard 2 (the
    # other slots busy first): each decode step's logits on its row
    # equal the reference model's full forward at that position.
    params, pm = setup
    full = RT.TransformerLM(dtype=jnp.float32, **CFG)
    seen = []

    def hook(module, args, kwargs, out):
        pos = kwargs.get("positions")
        if (torch.is_tensor(out) and out.shape[1] == 1
                and pos is not None and pos.ndim == 2):
            seen.append((pos[:, 0].clone(), out[:, 0].clone()))

    eng = ContinuousBatchingEngine(
        pm, 8, mesh=LocalMesh(["cpu"] * 4), prompt_grid=4,
        prefill_chunk=PAGE, observe=False, device="cpu")
    hook_h = None
    try:
        blockers = [eng.submit_nowait(rand_prompt(70 + i, 5), 40, 0.0)
                    for i in range(4)]
        deadline = time.monotonic() + 120
        while eng.active_rows < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        hook_h = pm.register_forward_hook(hook, with_kwargs=True)
        prompt = rand_prompt(77, 9)
        toks = eng.submit(prompt, 6, 0.0, timeout=300)[0]
        for b in blockers:
            b.wait(timeout=300)
    finally:
        if hook_h is not None:
            hook_h.remove()
        eng.close()
    seq = np.concatenate([prompt[0], np.asarray(toks[:-1], np.int32)])
    logits = np.asarray(full.apply({"params": jax_params(params)},
                                   jnp.asarray(seq[None])))[0]
    # Slot 4 is row 0 of shard 2 (2 rows a shard); its decode steps sit
    # at positions 9.. with the rows of the other shards interleaved.
    checked = 0
    for k in range(1, len(toks)):
        p = 9 + k - 1
        rows = [(pos, lg) for pos, lg in seen
                if pos.shape[0] == 2 and int(pos[0]) == p]
        assert any(np.allclose(lg[0].numpy(), logits[p], atol=ATOL)
                   for _, lg in rows), (k, p)
        assert int(np.argmax(logits[p])) == toks[k]
        checked += 1
    assert checked == len(toks) - 1


def test_generate_sharded_matches_reference(setup):
    # Per-row prompt lengths and temperatures, and per-row top-k (top-k
    # 1 makes a sampled row deterministic), split with their rows.
    params, pm = setup
    b = 8
    prompt = np.random.default_rng(5).integers(0, 64, (b, 12)).astype(
        np.int32)
    plens = np.array([12, 5, 9, 3, 12, 7, 1, 10], np.int32)
    temps = np.array([0.0, 0.8, 0.0, 1.3, 0.0, 0.5, 0.0, 2.0], np.float32)
    top_k = np.where(temps > 0, 1, CFG["vocab"]).astype(np.int32)
    want = np.asarray(RG.generate_sharded(
        jax_decoder(), jax_params(params), jnp.asarray(prompt), 6,
        _ref_mesh(8), temperature=jnp.asarray(temps),
        prompt_len=jnp.asarray(plens), top_k=jnp.asarray(top_k)))
    for n in (2, 4, 8):
        got = G.generate_sharded(pm, prompt, 6, LocalMesh(["cpu"] * n),
                                 temperature=temps, prompt_len=plens,
                                 top_k=top_k, seed=3)
        np.testing.assert_array_equal(got.numpy(), want)
    # Greedy with scalar arguments equals one device's generate_prefill.
    one = G.generate_prefill(pm, prompt, 12, 6, 0.0, torch.Generator())
    got = G.generate_sharded(pm, prompt, 6, LocalMesh(["cpu"] * 4))
    assert torch.equal(got, one)
    assert len(set(want.ravel().tolist())) > 3


def test_misuse_errors_match_reference(setup):
    params, pm = setup
    jdec, jp = jax_decoder(), jax_params(params)
    with pytest.raises(ValueError, match="single-chip") as ref:
        RefEngine(jdec, jp, 8, quant=True, mesh=_ref_mesh(8))
    with pytest.raises(ValueError, match="single-chip"):
        _mesh_engine(pm, 8, quant=True)
    assert "bf16 engine for a mesh" in str(ref.value)
    with pytest.raises(ValueError) as ref:
        RefEngine(jdec, jp, 6, mesh=_ref_mesh(4))
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(pm, 6, mesh=LocalMesh(["cpu"] * 4),
                                 device="cpu")
    assert str(got.value) == str(ref.value)
    prompt = np.zeros((6, 4), np.int32)
    with pytest.raises(ValueError) as ref:
        RG.generate_sharded(jdec, jp, jnp.asarray(prompt), 2, _ref_mesh(4))
    with pytest.raises(ValueError) as got:
        G.generate_sharded(pm, prompt, 2, LocalMesh(["cpu"] * 4))
    assert str(got.value) == str(ref.value)
    # A mesh that does not start at the engine's device.
    with pytest.raises(ValueError, match="mesh starts"):
        ContinuousBatchingEngine(pm, 2, mesh=LocalMesh(["meta", "meta"]),
                                 device="cpu")


def test_submesh_fleet_matches_reference_fleet(setup):
    # Two replicas, each a 4-shard dp engine of 4 slots: the same
    # sequential traffic gives the reference fleet's tokens.
    params, pm = setup
    kw = dict(prompt_grid=4, prefill_chunk=PAGE, observe=False)
    ref = RefFleet(jax_decoder(), jax_params(params), 2, 4, engine_kw=kw,
                   submeshes=ref_dp_submeshes(2, jax.devices()))
    try:
        want = [ref.submit(rand_prompt(s, 5 + s), 4, 0.0, timeout=300)
                for s in range(6)]
    finally:
        ref.close()
    subs = local_dp_submeshes(2, ["cpu"] * 8)
    fleet = FleetManager(pm, 2, 4, engine_kw=kw, submeshes=subs)
    try:
        assert [e._mesh for e in fleet.engines] == subs
        assert all(len(e._cache) == 4 for e in fleet.engines)
        got = [fleet.submit(rand_prompt(s, 5 + s), 4, 0.0, timeout=300)
               for s in range(6)]
    finally:
        fleet.close()
    assert got == want
    with pytest.raises(ValueError, match="submeshes for"):
        FleetManager(pm, 3, 4, engine_kw=kw, submeshes=subs)


def test_process_fleet_refuses_submeshes():
    with pytest.raises(ValueError, match="process fleet"):
        ProcessFleetManager(
            "container_engine_accelerators_tpu_torch.serving.worker"
            ":demo_lm_factory", dict(device="cpu"), 2, 4,
            submeshes=local_dp_submeshes(2, ["cpu"] * 4))
