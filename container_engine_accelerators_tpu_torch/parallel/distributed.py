"""Multi-host bootstrap from the plugin's env contract: the port of
container_engine_accelerators_tpu/parallel/distributed.py
(`initialize_from_env` :20, `global_mesh` :78).

The decisions are the reference's, made from a mapping the caller
passes (lm_main and resnet_main pass os.environ under --distributed;
the port reads no environment itself): one host and no multi-slice job
is no initialization and False; otherwise the coordinator is the first
of TPU_WORKER_HOSTNAMES (or, for a multi-slice job, the host of
MEGASCALE_COORDINATOR_ADDRESS) at `coordinator_port`, and the process id
is TPU_WORKER_ID, offset by MEGASCALE_SLICE_ID times the hosts of a
slice.  Where the reference calls jax.distributed.initialize, once per
host for every local chip, the port calls
torch.distributed.init_process_group over tcp with an explicit timeout
once per local rank (`init_cluster`): a host of `local_ranks` cards runs
that many processes, rank process_id * local_ranks + local_rank of
num_processes * local_ranks, each on its card with NCCL (or on the CPU
with gloo when the caller asks for it).  `initialize_from_env` is the
reference's call, one rank a host.
"""

from __future__ import annotations

import datetime
import logging
from typing import Mapping, Optional, Tuple

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = 8476
DEFAULT_TIMEOUT_S = 600.0


def cluster_from_env(
    env: Mapping[str, str], coordinator_port: int = DEFAULT_COORDINATOR_PORT
) -> Optional[Tuple[str, int, int]]:
    """(coordinator "host:port", number of processes, process id), or
    None for a single-host job that needs no initialization."""
    hostnames = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    # An empty value disables a knob, as unset does.
    worker_id = int(env.get("TPU_WORKER_ID") or "0")
    megascale_coord = env.get("MEGASCALE_COORDINATOR_ADDRESS", "")
    num_slices = int(env.get("MEGASCALE_NUM_SLICES") or "1")
    multislice = bool(megascale_coord) and num_slices > 1
    if len(hostnames) <= 1 and not multislice:
        return None
    hosts_per_slice = max(1, len(hostnames))
    if multislice:
        # Every slice's workers join one cluster at the megascale
        # coordinator's host (its own port belongs to the DCN transport).
        slice_id = int(env.get("MEGASCALE_SLICE_ID") or "0")
        coordinator = f"{megascale_coord.split(':')[0]}:{coordinator_port}"
        return (coordinator, hosts_per_slice * num_slices,
                worker_id + slice_id * hosts_per_slice)
    return f"{hostnames[0]}:{coordinator_port}", len(hostnames), worker_id


def init_cluster(
    cluster: Tuple[str, int, int],
    device: str = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
    local_rank: int = 0,
    local_ranks: int = 1,
) -> None:
    """Join the group `cluster` (cluster_from_env's triple) describes,
    as local rank `local_rank` of this host's `local_ranks`."""
    import torch
    import torch.distributed as dist

    coordinator, num_processes, process_id = cluster
    rank = process_id * local_ranks + local_rank
    world = num_processes * local_ranks
    log.info("initializing torch.distributed: coordinator=%s rank=%d/%d",
             coordinator, rank, world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def initialize_from_env(
    env: Mapping[str, str],
    coordinator_port: int = DEFAULT_COORDINATOR_PORT,
    device: str = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Initialize torch.distributed from the env contract in `env`, this
    process the one rank of its host.  Returns True when the multi-host
    init ran, False for a single host (nothing initialized)."""
    cluster = cluster_from_env(env, coordinator_port)
    if cluster is None:
        log.info("single-host slice; skipping torch.distributed init")
        return False
    init_cluster(cluster, device, timeout_s)
    return True


def global_mesh(model_parallel: int = 1):
    """The global (data, model) mesh after initialize_from_env: the data
    axis spans hosts and the model axis stays inside a host's ranks."""
    from .mesh import make_mesh

    return make_mesh(model_parallel=model_parallel)
