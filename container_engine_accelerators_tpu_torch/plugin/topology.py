"""GPU host topology and the mesh environment Allocate injects.  The port
of container_engine_accelerators_tpu/plugin/topology.py.

The grid math is the reference's, unchanged: `parse_topology` :131,
`chip_coord` / `chip_index` :146-157, `partition_table` :163,
`enumerate_slices` :184, `bounding_shape` / `is_contiguous_block`
:228-238, `preferred_allocation` :309 and `_block_shapes` :384.  The
platform table (:55-128) holds H100 hosts of 1, 2, 4 and 8 cards of 80
GiB, each named as its public accelerator label with the host's card
count, the way a TPU accelerator type counts chips.  The reference's
HBM per chip has no field: the time-shared budget is NVML's total of
the card (manager.py).  An H100 host joins its cards through NVSwitch,
every card reaching every other, so its grid is one line of `n` cards,
(n, 1, 1): a slice of k cards is any k cards in the host's card order,
and the k-card blocks tile it.

`mesh_envs` and `multislice_envs` keep the env names the port's own
consumers read: TPU_CHIPS_PER_PROCESS_BOUNDS (parallel/mesh.py
`mesh_from_env`), TPU_WORKER_ID, TPU_WORKER_HOSTNAMES and MEGASCALE_*
(parallel/distributed.py `cluster_from_env`).  The accelerator type is
an argument (the daemon's --accelerator-type flag): the port reads no
environment.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Coord = Tuple[int, int, int]
Shape = Tuple[int, int, int]

log = logging.getLogger(__name__)

# The public accelerator label of an H100 80 GB card; a host's type adds
# its card count.
H100_LABEL = "nvidia-h100-80gb"


@dataclasses.dataclass(frozen=True)
class Platform:
    """Static description of one host's cards."""

    # Accelerator type of the whole host, e.g. "nvidia-h100-80gb-8".
    accelerator_type: str
    # Card family: "h100".
    generation: str
    # Cards attached to this host.
    chips: int
    # Host grid (always 3D).
    topology: Shape

    @property
    def topology_str(self) -> str:
        return format_topology(self.topology)


PLATFORMS: Dict[str, Platform] = {
    p.accelerator_type: p
    for p in [
        Platform(f"{H100_LABEL}-{n}", "h100", n, (n, 1, 1))
        for n in (1, 2, 4, 8)
    ]
}

# Card count -> platform, where the accelerator type is not given.
_CHIP_COUNT_DEFAULTS = {p.chips: p.accelerator_type for p in PLATFORMS.values()}


def detect_platform(num_chips: int, accelerator_type: Optional[str] = None) -> Platform:
    """The host Platform: a declared accelerator type wins; else the
    card count picks one; else a synthesized one-line platform, so
    unknown hardware still schedules whole cards.

    A declared type with FEWER cards than were discovered is foreign and
    ignored.  One with slightly more is kept: a degraded host (7 of 8
    cards after a card failure) keeps its type and grid.  "Slightly" is a
    strict majority of the declared cards present."""
    if accelerator_type and accelerator_type in PLATFORMS:
        platform = PLATFORMS[accelerator_type]
        if num_chips <= 0 or platform.chips == num_chips or (
            platform.chips > num_chips and 2 * num_chips > platform.chips
        ):
            if 0 < num_chips < platform.chips:
                log.warning(
                    "accelerator type %s declares %d cards but only %d were "
                    "discovered; keeping the declared type (degraded host)",
                    accelerator_type, platform.chips, num_chips,
                )
            return platform
        log.warning(
            "accelerator type %s declares %d cards but %d were discovered; "
            "ignoring the declared type",
            accelerator_type, platform.chips, num_chips,
        )
        accelerator_type = None
    if num_chips in _CHIP_COUNT_DEFAULTS:
        return PLATFORMS[_CHIP_COUNT_DEFAULTS[num_chips]]
    return Platform(
        accelerator_type=accelerator_type or f"gpu-{num_chips}",
        generation="unknown",
        chips=num_chips,
        topology=(max(num_chips, 1), 1, 1),
    )


def parse_topology(size: str) -> Shape:
    """Parse "2x2" or "2x2x2" into a 3D shape.  Raises ValueError on
    malformed input."""
    parts = size.split("x")
    if len(parts) not in (2, 3) or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"invalid topology {size!r}: want AxB or AxBxC of positive ints")
    dims = tuple(int(p) for p in parts)
    return dims if len(dims) == 3 else (dims[0], dims[1], 1)


def format_topology(shape: Shape) -> str:
    x, y, z = shape
    return f"{x}x{y}x{z}" if z > 1 else f"{x}x{y}"


def chip_coord(index: int, topology: Shape) -> Coord:
    """Card index -> grid coordinate, row-major over (x, y, z)."""
    x_dim, y_dim, _z_dim = topology
    x = index % x_dim
    y = (index // x_dim) % y_dim
    z = index // (x_dim * y_dim)
    return (x, y, z)


def chip_index(coord: Coord, topology: Shape) -> int:
    x_dim, y_dim, _ = topology
    x, y, z = coord
    return x + x_dim * (y + y_dim * z)


def partition_table(platform: Platform) -> Dict[str, int]:
    """Every valid slice size for this host and how many fit: a shape is
    valid iff each of its dims divides the host's.  The full host is
    included."""
    table: Dict[str, int] = {}
    hx, hy, hz = platform.topology
    for sx, sy, sz in itertools.product(
        _divisors(hx), _divisors(hy), _divisors(hz)
    ):
        count = (hx // sx) * (hy // sy) * (hz // sz)
        table[format_topology((sx, sy, sz))] = count
    return table


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_slices(platform: Platform, size: str) -> List[List[int]]:
    """Tile the host grid with blocks of `size`: each slice as a list of
    card indices, slice K block K in x-then-y-then-z block order.  Raises
    ValueError if size does not tile the grid."""
    shape = parse_topology(size)
    hx, hy, hz = platform.topology
    sx, sy, sz = shape
    if hx % sx or hy % sy or hz % sz:
        raise ValueError(
            f"partition size {size} does not tile host topology "
            f"{platform.topology_str} (valid: {sorted(partition_table(platform))})"
        )
    slices: List[List[int]] = []
    for bz in range(0, hz, sz):
        for by in range(0, hy, sy):
            for bx in range(0, hx, sx):
                members = [
                    chip_index((bx + dx, by + dy, bz + dz), platform.topology)
                    for dz in range(sz)
                    for dy in range(sy)
                    for dx in range(sx)
                ]
                slices.append(sorted(members))
    return slices


def subslice_accelerator_type(platform: Platform, num_chips: int) -> str:
    """Accelerator type of `num_chips` cards of this host, e.g. 4 cards
    of an "nvidia-h100-80gb-8" host are "nvidia-h100-80gb-4"."""
    if platform.generation == "h100":
        return f"{H100_LABEL}-{num_chips}"
    return f"gpu-{num_chips}"


def bounding_shape(coords: Sequence[Coord]) -> Shape:
    """Axis-aligned bounding-box shape of a set of coordinates."""
    xs, ys, zs = zip(*coords)
    return (
        max(xs) - min(xs) + 1,
        max(ys) - min(ys) + 1,
        max(zs) - min(zs) + 1,
    )


def is_contiguous_block(coords: Sequence[Coord]) -> bool:
    """True if the coords form an exact dense rectangular block."""
    shape = bounding_shape(coords)
    return shape[0] * shape[1] * shape[2] == len(set(coords))


# ---------------------------------------------------------------------------
# The mesh environment.
# ---------------------------------------------------------------------------

def mesh_envs(
    platform: Platform,
    chip_indices: Sequence[int],
    worker_id: int = 0,
    worker_hostnames: Sequence[str] = ("localhost",),
    process_bounds: Optional[str] = None,
) -> Dict[str, str]:
    """The env a container allocated `chip_indices` of this host gets:
    the granted grid (TPU_CHIPS_PER_PROCESS_BOUNDS, read by
    parallel/mesh.py), the host grid of the job (TPU_PROCESS_BOUNDS), the
    worker identity (TPU_WORKER_ID / TPU_WORKER_HOSTNAMES, read by
    parallel/distributed.py), the granted cards' host indices
    (TPU_VISIBLE_DEVICES: the container sees only its /dev nodes, which
    CUDA numbers from 0) and the grant's accelerator type.  The defaults
    describe one host."""
    coords = [chip_coord(i, platform.topology) for i in sorted(chip_indices)]
    shape = bounding_shape(coords)
    # The accelerator type names the whole job: local cards times the
    # number of host processes.
    num_processes = 1
    if process_bounds:
        px, py, pz = (int(p) for p in process_bounds.split(","))
        num_processes = max(1, px * py * pz)
    return {
        "TPU_CHIPS_PER_PROCESS_BOUNDS": f"{shape[0]},{shape[1]},{shape[2]}",
        "TPU_PROCESS_BOUNDS": process_bounds or "1,1,1",
        "TPU_VISIBLE_DEVICES": ",".join(str(i) for i in sorted(chip_indices)),
        "TPU_WORKER_ID": str(worker_id),
        "TPU_WORKER_HOSTNAMES": ",".join(worker_hostnames),
        "TPU_ACCELERATOR_TYPE": subslice_accelerator_type(
            platform, len(chip_indices) * num_processes
        ),
    }


def multislice_envs(
    coordinator_address: str,
    num_slices: int,
    slice_id: int,
) -> Dict[str, str]:
    """The multi-slice layer over mesh_envs, for jobs that span hosts."""
    return {
        "MEGASCALE_COORDINATOR_ADDRESS": coordinator_address,
        "MEGASCALE_NUM_SLICES": str(num_slices),
        "MEGASCALE_SLICE_ID": str(slice_id),
    }


# ---------------------------------------------------------------------------
# Topology-aware preferred allocation.
# ---------------------------------------------------------------------------

def preferred_allocation(
    platform: Platform,
    available: Sequence[int],
    required: Sequence[int],
    size: int,
) -> List[int]:
    """Choose `size` cards from `available` (a superset of `required`):
    first an exact block of a shape that could tile the host, aligned to
    that tiling where one fits; else the tightest bounding box grown from
    the required cards.  Returns card indices; raises ValueError if
    infeasible."""
    avail = sorted(set(available))
    req = sorted(set(required))
    if size < len(req) or size > len(avail) or not set(req) <= set(avail):
        raise ValueError(
            f"infeasible allocation: size={size} required={req} available={avail}"
        )
    if size == len(avail):
        return avail

    avail_set = set(avail)
    req_set = set(req)
    topo = platform.topology

    best: Optional[List[int]] = None
    for shape in _block_shapes(size, topo):
        for origin in _block_origins(shape, topo):
            members = [
                chip_index(
                    (origin[0] + dx, origin[1] + dy, origin[2] + dz), topo
                )
                for dz in range(shape[2])
                for dy in range(shape[1])
                for dx in range(shape[0])
            ]
            mset = set(members)
            if not mset <= avail_set or not req_set <= mset:
                continue
            # Shapes come most compact first: the first aligned block
            # wins, the first unaligned one is the fallback.
            if all(o % s == 0 for o, s in zip(origin, shape)):
                return sorted(members)
            if best is None:
                best = sorted(members)
    if best is not None:
        return best

    chosen = list(req)
    if not chosen:
        chosen = [avail[0]]
    while len(chosen) < size:
        candidates = [c for c in avail if c not in chosen]
        coords_chosen = [chip_coord(i, topo) for i in chosen]

        def cost(c: int) -> Tuple[int, int]:
            shape = bounding_shape(coords_chosen + [chip_coord(c, topo)])
            return (shape[0] * shape[1] * shape[2], c)

        chosen.append(min(candidates, key=cost))
    return sorted(chosen)


def _block_shapes(size: int, topo: Shape) -> List[Shape]:
    """Every 3D factorization of `size` that fits inside `topo`, most
    compact first."""
    shapes = []
    for sx in _divisors(size):
        for sy in _divisors(size // sx):
            sz = size // (sx * sy)
            if sx <= topo[0] and sy <= topo[1] and sz <= topo[2]:
                shapes.append((sx, sy, sz))
    shapes.sort(key=lambda s: (max(s) - min(s), s))
    return shapes


def _block_origins(shape: Shape, topo: Shape) -> Iterable[Coord]:
    for oz in range(0, topo[2] - shape[2] + 1):
        for oy in range(0, topo[1] - shape[1] + 1):
            for ox in range(0, topo[0] - shape[0] + 1):
                yield (ox, oy, oz)
