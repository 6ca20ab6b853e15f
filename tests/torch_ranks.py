"""Ranks for the port's parallel tests (tests/test_torch_*.py): a pool
of spawned processes, each one rank of a gloo process group, running the
tasks below by name on numpy inputs and returning numpy results.

This module imports torch and the port only, never JAX or the JAX
package (tests/test_torch_isolation.py holds this, and each rank's own
sys.modules): the spawned ranks import it by name.  The pytest process
has JAX loaded, so ranks start with the spawn method, never fork; they
meet through a FileStore under the test's temporary directory, not a
fixed port (several test workers run at once); every init, collective
and result has a timeout, so a hung rank fails its test in seconds.
"""

from __future__ import annotations

import datetime
import os
import queue
import sys
import traceback

import numpy as np
import torch

TIMEOUT_S = 90.0


class RankPool:
    """`world` ranks that run one task at a time: pool.run(name, **kw)
    calls name(rank, world, **kw) on every rank and returns the ranks'
    results in rank order, or raises AssertionError with the first
    rank's traceback (a pool whose task failed or timed out is broken
    and must be closed)."""

    def __init__(self, world: int, store_dir: str, timeout_s=TIMEOUT_S):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout_s, self.broken = world, timeout_s, False
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        path = os.path.join(store_dir, "store")
        self.procs = [
            ctx.Process(target=_serve, daemon=True, args=(
                r, world, path, self.tasks[r], self.results, timeout_s))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, timeout_s=None, **kw):
        if self.broken:
            raise AssertionError("the rank pool is broken")
        for q in self.tasks:
            q.put((name, kw))
        out = {}
        try:
            while len(out) < self.world:
                rank, ok, value = self.results.get(
                    timeout=timeout_s or self.timeout_s)
                if not ok:
                    self.broken = True
                    raise AssertionError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        except queue.Empty:
            self.broken = True
            raise AssertionError(
                f"task {name} timed out; ranks done: {sorted(out)}") from None
        return [out[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)


def _serve(rank, world, path, tasks, results, timeout_s):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    while True:
        item = tasks.get()
        if item is None:
            break
        name, kw = item
        try:
            results.put((rank, True, globals()[name](rank, world, **kw)))
        except BaseException:  # noqa: BLE001 - the test reports it
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


# ---- helpers ----

def _t(a, requires_grad=False):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.requires_grad_(requires_grad) if requires_grad else t


def _np(t):
    return t.detach().float().cpu().numpy()


def _sum_over(t, groups):
    import torch.distributed as dist

    t = t.detach().clone()
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


# ---- tasks ----

def modules(rank, world):
    """The rank's JAX and JAX-package modules (the isolation test)."""
    return sorted(k for k in sys.modules if k == "jax" or k.startswith(
        "jax.") or k == "flax" or k.split(".")[0] ==
        "container_engine_accelerators_tpu")


def meshes(rank, world, env=None, model_parallel=None, n_sub=1):
    """Shapes and groups of the port's meshes on these ranks."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import mesh as M

    def describe(m):
        if m is None:
            return None
        return {"names": list(m.mesh_dim_names),
                "grid": m.mesh.tolist(),
                "groups": {a: dist.get_process_group_ranks(m.get_group(a))
                           for a in m.mesh_dim_names
                           if m.get_coordinate() is not None}}

    out = {"flat": describe(M.make_mesh()),
           "env": describe(M.mesh_from_env(env, model_parallel)),
           "sub": [describe(s) for s in M.dp_submeshes(n_sub)]}
    x = torch.arange(world * 2.0).reshape(world * 2, 1)
    sh = M.batch_sharding(M.make_mesh())
    out["shard"] = _np(sh.shard(x))
    out["unshard"] = _np(sh.unshard(sh.shard(x)))
    out["replicated"] = _np(M.replicated_sharding(M.make_mesh()).shard(x))
    return out


def bucketed_reduce(rank, world, bucket_bytes):
    """reduce_grads over a (data, model) mesh's groups, in buckets of
    `bucket_bytes`, against one all_reduce a tensor and group.  The
    gradients hold small integers, so every summation order is exact."""
    from container_engine_accelerators_tpu_torch.parallel import (
        _collectives as C,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(model_parallel=2 if world % 2 == 0 else 1)
    data, model = mesh.get_group(M.DATA_AXIS), mesh.get_group(M.MODEL_AXIS)
    shapes = [(3, 5), (7,), (2, 2, 2), (11, 4), (1,), (6, 6)]
    plan = [(), (data,), (data, model), (model,), (data,), (data, model)]
    params = []
    for i, (shape, groups) in enumerate(zip(shapes, plan)):
        dtype = torch.bfloat16 if i == 3 else torch.float32
        p = torch.nn.Parameter(torch.zeros(shape, dtype=dtype))
        n = p.numel()
        p.grad = (torch.arange(n, dtype=torch.float32) % 7 + rank * 3 + i
                  ).reshape(shape).to(dtype)
        params.append((p, list(groups)))
    skipped = torch.nn.Parameter(torch.zeros(4))  # no gradient
    want = [_sum_over(p.grad, g) for p, g in params]
    C.reduce_grads(params + [(skipped, [data])], bucket_bytes)
    return {"equal": [bool(torch.equal(p.grad, w))
                      for (p, _), w in zip(params, want)],
            "skipped": skipped.grad is None}


def moe(rank, world, x, router, w_in, w_out, g_out, c_aux, **kw):
    """moe_ffn_forward on this rank's tokens and experts, and the
    gradients of sum(out * g_out) + c_aux * aux (the global objective:
    each rank backpropagates its share)."""
    from container_engine_accelerators_tpu_torch.parallel import (
        _collectives as C,
        mesh as M,
    )
    from container_engine_accelerators_tpu_torch.parallel.moe import (
        moe_ffn_forward,
    )

    mesh = M.mesh_1d("ep")
    group = mesh.get_group("ep")
    sh = M.Sharding(mesh, ("ep",))
    xs = sh.shard(_t(x)).clone().requires_grad_(True)
    r = _t(router, True)
    wi = sh.shard(_t(w_in)).clone().requires_grad_(True)
    wo = sh.shard(_t(w_out)).clone().requires_grad_(True)
    trace = {}
    out, aux, drop = moe_ffn_forward(xs, r, wi, wo, group, trace=trace, **kw)
    obj = (out * sh.shard(_t(g_out))).sum() + c_aux * aux / world
    obj.backward()
    return {"out": _np(sh.unshard(out.detach())), "aux": float(aux),
            "drop": float(drop),
            "keep": trace["keep"].numpy(), "send_slots":
                trace["send_slots"].numpy(),
            "dx": _np(sh.unshard(xs.grad)),
            "drouter": _np(_sum_over(r.grad, [group])),
            "dw_in": _np(sh.unshard(wi.grad)),
            "dw_out": _np(sh.unshard(wo.grad))}


def ring(rank, world, q, k, v, g_out, layout="contiguous"):
    """ring_attention_sharded on the global inputs (in storage order),
    and the gradients of sum(out * g_out): every rank holds the whole
    output, so each backpropagates its share and the gradients of the
    inputs (replicated) are summed over the ranks."""
    from container_engine_accelerators_tpu_torch.parallel import mesh as M
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention as RA,
    )

    mesh = M.mesh_1d("sp")
    ins = [_t(a, True) for a in (q, k, v)]
    out = RA.ring_attention_sharded(*ins, mesh, "sp", causal=True,
                                    layout=layout)
    ((out * _t(g_out)).sum() / world).backward()
    res = {"out": _np(out)}
    for name, t in zip(("dq", "dk", "dv"), ins):
        res[name] = _np(_sum_over(t.grad, [mesh.get_group("sp")]))
    return res


def pipeline_toy(rank, world, w, micro, g_out, n_virtual):
    """pipeline_sharded with tanh(x @ w_c) stages over every chunk w
    (in shard order), and the gradients of sum(out * g_out) with
    respect to the chunks and the microbatches."""
    from container_engine_accelerators_tpu_torch.parallel import mesh as M
    from container_engine_accelerators_tpu_torch.parallel import (
        pipeline as PP,
    )

    mesh = M.mesh_1d("pp")
    chunks = [_t(c, True) for c in w]
    x = _t(micro, True)
    out = PP.pipeline_sharded(lambda wc, h: torch.tanh(h @ wc), chunks, x,
                              mesh, "pp", n_virtual=n_virtual)
    ((out * _t(g_out)).sum() / world).backward()
    group = mesh.get_group("pp")
    # A rank's backward reaches its own chunks only: the others' grads
    # are None there (zeros in the sum every rank takes part in).
    return {"out": _np(out),
            "dw": [_np(_sum_over(torch.zeros_like(c) if c.grad is None
                                 else c.grad, [group])) for c in chunks],
            "dx": _np(_sum_over(x.grad, [group]))}


def _lm_mesh(kind, world):
    from container_engine_accelerators_tpu_torch.parallel import mesh as M

    if kind == "dptp":
        return M.make_mesh(data_parallel=2, model_parallel=world // 2)
    if kind in ("sp", "zigzag"):
        return M.make_mesh(model_parallel=world)
    if kind == "tp":
        return M.mesh_1d(M.MODEL_AXIS)
    if kind in ("ep", "pp"):
        return M.mesh_1d(kind)
    return M.make_mesh()


def train(rank, world, kind, cfg, tokens, targets, steps=1, params=None,
          **kw):
    """`steps` steps of the port's mesh trainer `kind` (dp, sp, zigzag,
    tp, dptp, ep, pp) from `params` (a flax tree) or the seed; returns
    the losses, the flax gradients of the first step (this rank's
    shard), and for ep the aux and drop, for pp the sequential loss."""
    from container_engine_accelerators_tpu_torch.models import convert
    from container_engine_accelerators_tpu_torch.models import (
        transformer as T,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as M

    mesh = _lm_mesh(kind, world)
    common = dict(device="cpu", dtype=torch.float32, params=params, **cfg)
    extra = {}
    if kind in ("dp", "sp", "zigzag"):
        step, state, _ = T.build_lm_training(
            mesh=mesh, seq_axis=None if kind == "dp" else M.MODEL_AXIS,
            seq_layout="zigzag" if kind == "zigzag" else "contiguous",
            **common, **kw)
        grads = convert.to_flax_grads
    elif kind in ("tp", "dptp"):
        step, state, _ = T.build_lm_training_tp(
            mesh, M.MODEL_AXIS,
            data_axis=M.DATA_AXIS if kind == "dptp" else None,
            **common, **kw)
        grads = convert.to_flax_grads
    elif kind == "ep":
        from container_engine_accelerators_tpu_torch.models import moe_lm

        step, state, _ = moe_lm.build_moe_lm_training(
            mesh, "ep", **common, **kw)
        grads = convert.to_flax_moe_grads
    else:
        from container_engine_accelerators_tpu_torch.models import (
            pipeline_lm as PL,
        )

        step, state, _, info = PL.build_lm_training_pp(
            mesh, "pp", **common, **kw)
        grads = convert.to_flax_pipeline_grads
        extra["info"] = info
        extra["sequential"] = float(PL.sequential_reference_loss(
            state, _t(tokens), _t(targets)))
    losses, first = [], None
    for i in range(steps):
        state, out = step(state, _t(tokens), _t(targets))
        if kind == "ep":
            out, aux, drop = out
            extra.setdefault("aux", []).append(float(aux))
            extra.setdefault("drop", []).append(float(drop))
        losses.append(float(out))
        if i == 0:
            first = grads(state["model"])
    return {"losses": losses, "grads": first, **extra}


def resnet(rank, world, params, batch_stats, images, labels, model_kwargs,
           num_classes, model_name="resnet18"):
    """One data-parallel step of the port's vision trainer (`model_name`:
    a ResNet or inception_v3) on the global batch: the loss, the
    gradients, the running statistics after."""
    from container_engine_accelerators_tpu_torch.models import convert
    from container_engine_accelerators_tpu_torch.models import train as TT
    from container_engine_accelerators_tpu_torch.parallel import mesh as M

    step, _, state = TT.build_training(
        mesh=M.make_mesh(), model_name=model_name, image_size=images.shape[1],
        num_classes=num_classes, model_kwargs=model_kwargs, device="cpu",
        params=params, batch_stats=batch_stats)
    state, loss = step(state, _t(images), _t(labels))
    _, stats = convert.to_flax_vision(state["model"])
    return {"loss": float(loss),
            "grads": convert.to_flax_vision_grads(state["model"]),
            "batch_stats": stats}


def distributed_main(rank, port, results):
    """A process of its own (not a pool rank): parallel/distributed.py
    from a two-host env contract on this machine; both processes join
    and an all-reduce sums their ranks + 1."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import (
        distributed as D,
    )

    torch.set_num_threads(1)
    env = {"TPU_WORKER_HOSTNAMES": "localhost,localhost",
           "TPU_WORKER_ID": str(rank)}
    try:
        ran = D.initialize_from_env(env, coordinator_port=port,
                                    device="cpu", timeout_s=60.0)
        t = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(t)
        mesh = D.global_mesh()
        results.put((rank, {"ran": ran, "rank": dist.get_rank(),
                            "world": dist.get_world_size(), "sum": float(t),
                            "mesh": list(mesh.mesh.shape),
                            "modules": modules(rank, 2)}))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the test reports it
        results.put((rank, traceback.format_exc()))


def moe_checkpoint(rank, world, cfg, path, save):
    """The seeded MoE trainer on these ranks: with `save`, two steps and
    save_checkpoint into `path`; else a trainer from another seed that
    restores it.  Returns this rank's parameters and AdamW moments."""
    from container_engine_accelerators_tpu_torch.models import moe_lm
    from container_engine_accelerators_tpu_torch.parallel import mesh as M
    from container_engine_accelerators_tpu_torch.utils import checkpoint

    step, state, batch_fn = moe_lm.build_moe_lm_training(
        M.mesh_1d("ep"), "ep", device="cpu", dtype=torch.float32,
        seed=0 if save else 1, **cfg)
    if save:
        tokens, targets = batch_fn(torch.Generator().manual_seed(0))
        for _ in range(2):
            state, _ = step(state, tokens, targets)
        checkpoint.save_checkpoint(path, state, state["step"])
    else:
        assert checkpoint.restore_checkpoint(path, state) is not None
    opt = state["opt"]
    out = {"step": state["step"]}
    for name, p in state["model"].named_parameters():
        out[name] = _np(p)
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{name}/{k}"] = _np(opt.state[p][k])
    return out


def tp_refusal(rank, world, cfg):
    """The ValueError build_lm_training_tp raises on `cfg`."""
    from container_engine_accelerators_tpu_torch.models import (
        transformer as T,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as M

    try:
        T.build_lm_training_tp(M.mesh_1d(M.MODEL_AXIS), M.MODEL_AXIS,
                               device="cpu", **cfg)
    except ValueError as e:
        return str(e)
    return "built"
