"""Starting the ranks of a per-rank program (port-only; the reference's
one SPMD process drives every local chip, where the port runs one
process per card).

`spawn_ranks` starts n processes with the spawn start method (a fork of
a process that has touched CUDA, or loaded JAX, is unsafe), each joining
one process group, and runs `target` ("module:function", imported by
name in each child) as `target(rank, world, *payload)`.  On one host the
group is the n processes, met through a TCPStore this process serves on
a free localhost port; given a multi-host job's `cluster`
(distributed.cluster_from_env), the n processes are this host's local
ranks of the global group (distributed.init_cluster).  `one_rank_group`
initializes a group of this process alone (one card, or the CPU), for
the mesh paths on one rank.  On the card each rank takes the card of its
local rank and NCCL; on the CPU gloo.  Every init has an explicit
timeout.
"""

from __future__ import annotations

import datetime
import importlib
import sys

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
LOCALHOST = "127.0.0.1"


def init_rank(rank: int, world: int, store, device="cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group as `rank` of `world` through `store`;
    returns this rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def one_rank_group(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S):
    """A process group of this process alone, unless one exists."""
    if dist.is_initialized():
        return torch.device(device)
    return init_rank(0, 1, dist.HashStore(), device, timeout_s)


def _entry(local_rank, local_world, port, target, payload, device,
           timeout_s, cluster):
    torch.set_num_threads(max(1, torch.get_num_threads() // local_world))
    if cluster is None:
        store = dist.TCPStore(LOCALHOST, port, None, False,
                              datetime.timedelta(seconds=timeout_s))
        init_rank(local_rank, local_world, store, device, timeout_s)
    else:
        from .distributed import init_cluster

        init_cluster(cluster, device, timeout_s, local_rank, local_world)
    module, name = target.split(":")
    try:
        rc = getattr(importlib.import_module(module), name)(
            dist.get_rank(), dist.get_world_size(), *payload)
    finally:
        dist.destroy_process_group()
    if rc:
        sys.exit(int(rc))


def spawn_ranks(target: str, world: int, payload=(), device="cuda",
                timeout_s: float = DEFAULT_TIMEOUT_S, cluster=None) -> int:
    """Run `target` on `world` spawned ranks of this host (this host's
    share of `cluster`'s group when given); returns 0, or the exit code
    of the first rank that failed (1 for an exception)."""
    import torch.multiprocessing as mp

    store = None
    if cluster is None:
        store = dist.TCPStore(LOCALHOST, 0, None, True,
                              datetime.timedelta(seconds=timeout_s),
                              wait_for_workers=False)
    try:
        mp.start_processes(
            _entry, args=(world, None if store is None else store.port, target,
                          tuple(payload), str(device), timeout_s,
                          cluster),
            nprocs=world, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        return e.exit_code or 1
    except mp.ProcessRaisedException as e:
        print(e, file=sys.stderr)
        return 1
    finally:
        del store
    return 0
