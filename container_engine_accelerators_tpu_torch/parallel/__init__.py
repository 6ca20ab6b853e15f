"""Meshes, collectives and the parallel layers: the port of
container_engine_accelerators_tpu/parallel/ (mesh.py, distributed.py,
moe.py, ring_attention.py, pipeline.py) over torch.distributed, one
process per rank, and LocalMesh, the serving side's mesh of local
devices in one process; _collectives.py and launch.py are the port's
own."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    LocalMesh,
    MODEL_AXIS,
    batch_sharding,
    local_dp_submeshes,
    make_mesh,
    mesh_from_env,
    replicated_sharding,
)
