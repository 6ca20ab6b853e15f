"""The port's meshes and multi-host bootstrap (container_engine_
accelerators_tpu_torch/parallel/mesh.py, distributed.py) against the
reference's (parallel/mesh.py, distributed.py): the same shapes, axis
names and rank grids as the reference's meshes over as many virtual CPU
devices, from the same env contract (the reference reads os.environ,
the port a mapping); the split and replicated layouts; the bucketed
gradient reduction (exactly the per-tensor sums); the reference's
decisions on the env contract, one host to multi-slice; and
initialize_from_env across two processes on this machine (gloo over
tcp on a free localhost port), which join one group."""

import multiprocessing as mp
import socket

import jax
import numpy as np
import pytest

from _torch_port import rank_pools
from container_engine_accelerators_tpu.parallel import distributed as JD
from container_engine_accelerators_tpu.parallel import mesh as JM
from container_engine_accelerators_tpu_torch.parallel import (
    distributed as PD,
)
from container_engine_accelerators_tpu_torch.parallel import mesh as PM


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from rank_pools(tmp_path_factory)


def _grid(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices).tolist()


@pytest.mark.parametrize("world,bounds,mp_,n_sub", [
    (4, None, None, 2),
    (4, "2,2,1", None, 4),
    (4, "2,2,1", 2, 1),
    (4, "4,1,1", None, 2),
    (2, "3,1,1", None, 1),
])
def test_meshes_match_reference(pools, monkeypatch, world, bounds, mp_,
                                n_sub):
    devs = jax.devices()[:world]
    env = {} if bounds is None else {"TPU_CHIPS_PER_PROCESS_BOUNDS": bounds}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if bounds == "3,1,1":
        with pytest.warns(UserWarning):
            want_env = JM.mesh_from_env(mp_, devices=devs)
    else:
        want_env = JM.mesh_from_env(mp_, devices=devs)
    want_sub = JM.dp_submeshes(n_sub, devs)
    got = pools(world).run("meshes", env=env, model_parallel=mp_,
                           n_sub=n_sub)
    for rank, r in enumerate(got):
        assert r["flat"]["grid"] == _grid(JM.make_mesh(devs))
        assert r["env"]["names"] == list(want_env.axis_names)
        assert r["env"]["grid"] == _grid(want_env)
        assert [s is None for s in r["sub"]] == [s is None for s in want_sub]
        for s, w in zip(r["sub"], want_sub):
            if w is not None:
                assert s["grid"] == _grid(w)
                assert s["names"] == list(w.axis_names)
        np.testing.assert_array_equal(r["shard"],
                                      [[2.0 * rank], [2.0 * rank + 1]])
        np.testing.assert_array_equal(r["unshard"],
                                      np.arange(2.0 * world)[:, None])
        np.testing.assert_array_equal(r["replicated"],
                                      np.arange(2.0 * world)[:, None])


@pytest.mark.parametrize("env", [
    {},
    {"TPU_WORKER_HOSTNAMES": "a"},
    {"TPU_WORKER_HOSTNAMES": "a,b,c", "TPU_WORKER_ID": "2"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": ""},
    {"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "1",
     "MEGASCALE_COORDINATOR_ADDRESS": "coord:9999",
     "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
    {"MEGASCALE_COORDINATOR_ADDRESS": "coord", "MEGASCALE_NUM_SLICES": "3",
     "MEGASCALE_SLICE_ID": "2"},
    {"MEGASCALE_COORDINATOR_ADDRESS": "coord", "MEGASCALE_NUM_SLICES": "1"},
])
def test_env_contract_decisions_match_reference(monkeypatch, env):
    for k in ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
              "MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES",
              "MEGASCALE_SLICE_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    ran = JD.initialize_from_env(1234)
    got = PD.cluster_from_env(env, 1234)
    assert (got is not None) == ran
    if ran:
        assert got == (seen["coordinator_address"], seen["num_processes"],
                       seen["process_id"])
    if not ran:
        assert PD.initialize_from_env(env, 1234, device="cpu") is False


@pytest.mark.parametrize("world,bucket_bytes", [(2, 64), (4, 64),
                                                (4, 25 * 2**20)])
def test_reduce_grads_buckets_equal_per_tensor_sums(pools, world,
                                                    bucket_bytes):
    # Exact: integer-valued gradients (f32 and bf16) sum exactly in any
    # order; 64 bytes puts one or two tensors in a bucket, 25 MiB all.
    for r in pools(world).run("bucketed_reduce", bucket_bytes=bucket_bytes):
        assert r == {"equal": [True] * 6, "skipped": True}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_from_env_across_two_processes():
    from torch_ranks import distributed_main

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=distributed_main, args=(r, port, results),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=90) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for rank in range(2):
        r = got[rank]
        assert isinstance(r, dict), r
        assert r == {"ran": True, "rank": rank, "world": 2, "sum": 3.0,
                     "mesh": [2, 1], "modules": []}
