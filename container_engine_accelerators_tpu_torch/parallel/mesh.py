"""Device meshes over torch.distributed ranks: the port of
container_engine_accelerators_tpu/parallel/mesh.py (`_env_bounds` :25,
`make_mesh` :35, `mesh_from_env` :60, `dp_submeshes` :117,
`batch_sharding` :151, `replicated_sharding` :158).

A mesh is a torch DeviceMesh over ranks, one rank per card, with the
reference's axis names and order: (DATA_AXIS, MODEL_AXIS), the model
axis innermost (adjacent ranks).  Each axis is one process group
(`mesh.get_group(axis)`), NCCL on the cards and gloo on the CPU; the
mesh's device type is the process group's.  The reference's
NamedShardings become `Sharding`s, which cut this rank's piece out of a
global tensor (`shard`) and put the pieces back together (`unshard`):
the port runs one program per rank, so a tensor is either whole on every
rank (replicated) or held in pieces.  `mesh_from_env` reads the
plugin's env contract from a mapping the caller passes; the port reads
no environment itself.

Serving meshes are another thing: the reference's dp engine is one
SPMD program over the local devices, and one scheduler cannot span
processes.  `LocalMesh` is that mesh in one process: a list of torch
devices along the data axis, one shard of the batch each.  It may name
one device more than once (two shards on one card), and
`local_dp_submeshes` carves it into fleet replicas.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import _collectives as C

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _env_bounds(env: Optional[Mapping[str, str]]) -> Optional[Tuple[int, int, int]]:
    raw = (env or {}).get("TPU_CHIPS_PER_PROCESS_BOUNDS")
    if not raw:
        return None
    parts = raw.split(",")
    if len(parts) != 3:
        return None
    return tuple(int(p) for p in parts)  # type: ignore[return-value]


def axis_len(mesh: DeviceMesh, axis: str) -> int:
    """The size of the named axis of `mesh`."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _ranks(ranks: Optional[Sequence[int]]) -> list:
    return list(range(dist.get_world_size())) if ranks is None else list(ranks)


def _mesh(ranks, shape, names) -> DeviceMesh:
    """A mesh of the process group's device type: cuda over NCCL, the
    CPU over gloo."""
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, grid, mesh_dim_names=names)


def make_mesh(
    ranks: Optional[Sequence[int]] = None,
    data_parallel: Optional[int] = None,
    model_parallel: int = 1,
) -> DeviceMesh:
    """A (data, model) mesh over `ranks` (default: every rank of the
    process group).  model_parallel=1 is pure data parallelism; raising
    it keeps the model axis innermost, on adjacent ranks."""
    ranks = _ranks(ranks)
    n = len(ranks)
    if data_parallel is None:
        if n % model_parallel:
            raise ValueError(
                f"{n} devices not divisible by model_parallel={model_parallel}"
            )
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} != {n} devices")
    return _mesh(ranks, (data_parallel, model_parallel),
                 (DATA_AXIS, MODEL_AXIS))


def mesh_1d(axis: str, ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A one-axis mesh over `ranks` (lm_main's `mesh_1d`)."""
    ranks = _ranks(ranks)
    return _mesh(ranks, (len(ranks),), (axis,))


def mesh_from_env(
    env: Optional[Mapping[str, str]] = None,
    model_parallel: Optional[int] = None,
    ranks: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """The mesh from the plugin's env contract, read from `env`:
    TPU_CHIPS_PER_PROCESS_BOUNDS (x, y, z) is the granted sub-grid.  By
    default the data axis is the outermost grid dim and the model axis
    the rest; model_parallel=k carves the model axis from the innermost
    ranks.  Absent bounds, or bounds that disagree with the rank count
    (a warning), give the flat mesh.  Ranks are in grid order."""
    ranks = _ranks(ranks)
    mp_flat = 1 if model_parallel is None else model_parallel
    bounds = _env_bounds(env)
    if bounds is None or math.prod(bounds) == 0:
        return make_mesh(ranks, model_parallel=mp_flat)
    expected = math.prod(bounds)
    if expected != len(ranks):
        warnings.warn(
            f"TPU_CHIPS_PER_PROCESS_BOUNDS={bounds} covers {expected} "
            f"chips but the runtime enumerates {len(ranks)} (sparse "
            "grant or multi-host process); building a flat mesh instead "
            "of the grid",
            stacklevel=2,
        )
        return make_mesh(ranks, model_parallel=mp_flat)
    mp = bounds[1] * bounds[2] if model_parallel is None else model_parallel
    if mp <= 0 or expected % mp:
        raise ValueError(
            f"model_parallel={mp} does not divide the {bounds} grant"
        )
    return _mesh(ranks, (expected // mp, mp), (DATA_AXIS, MODEL_AXIS))


def dp_submeshes(n: int, ranks: Optional[Sequence[int]] = None) -> list:
    """Carve the ranks into `n` contiguous data-parallel groups, one
    serving replica each: a (data,)-axis mesh per multi-rank group, None
    for single-rank groups.  Every rank builds every group's mesh (a
    process group is made collectively)."""
    ranks = _ranks(ranks)
    n = int(n)
    if n < 1:
        raise ValueError(f"need >= 1 replica group, got {n}")
    if len(ranks) % n:
        raise ValueError(
            f"{len(ranks)} devices do not divide into {n} replica groups"
        )
    per = len(ranks) // n
    if per == 1:
        return [None] * n
    return [_mesh(ranks[i * per:(i + 1) * per], (per,), (DATA_AXIS,))
            for i in range(n)]


class LocalMesh:
    """A data-parallel mesh of local devices in one process (the
    reference's `Mesh(np.array(devices), (DATA_AXIS,))` under a serving
    engine): `devices` in shard order, `axis_names` (DATA_AXIS,) and
    `shape` {DATA_AXIS: n}.  A device may repeat: each entry is one
    shard."""

    axis_names = (DATA_AXIS,)

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a LocalMesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(
                f"a LocalMesh's devices share one type, got {self.devices}")

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"LocalMesh({[str(d) for d in self.devices]})"


def local_dp_submeshes(n: int, devices: Sequence) -> list:
    """`dp_submeshes` over local devices: `n` contiguous groups of
    `devices`, a LocalMesh per multi-device group and None for a group
    of one device (a single-device replica needs no mesh, so it keeps
    the paged cache and the int8 path)."""
    devices = list(devices)
    n = int(n)
    if n < 1:
        raise ValueError(f"need >= 1 replica group, got {n}")
    if len(devices) % n:
        raise ValueError(
            f"{len(devices)} devices do not divide into {n} replica groups"
        )
    per = len(devices) // n
    if per == 1:
        return [None] * n
    return [LocalMesh(devices[i * per:(i + 1) * per]) for i in range(n)]


@dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh: split along `dim` over `axes` (the
    pieces in the axes' row-major order), or whole on every rank when
    `axes` is empty."""

    mesh: DeviceMesh
    axes: Tuple[str, ...]
    dim: int = 0

    @property
    def count(self) -> int:
        return math.prod(axis_len(self.mesh, a) for a in self.axes)

    @property
    def index(self) -> int:
        i = 0
        for a in self.axes:
            i = i * axis_len(self.mesh, a) + self.mesh.get_local_rank(a)
        return i

    def shard(self, x):
        """This rank's piece of the global tensor `x`."""
        n = self.count
        if x.shape[self.dim] % n:
            raise ValueError(
                f"dim {self.dim} of {tuple(x.shape)} does not split over "
                f"{n} shards ({self.axes})"
            )
        return x.chunk(n, self.dim)[self.index]

    def unshard(self, x):
        """The global tensor from every rank's piece `x` (a gather with
        a gradient)."""
        for a in reversed(self.axes):
            x = C.all_gather(x, self.mesh.get_group(a), self.dim)
        return x


def batch_sharding(mesh: DeviceMesh, dim: int = 0) -> Sharding:
    """The leading (batch) dim split over every mesh axis: pure data
    parallelism over all ranks."""
    return Sharding(mesh, tuple(mesh.mesh_dim_names), dim)


def replicated_sharding(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, ())


def world_groups(mesh: DeviceMesh) -> list:
    """One process group per axis: summing over each in turn sums over
    every rank of the mesh."""
    return [mesh.get_group(a) for a in mesh.mesh_dim_names]
