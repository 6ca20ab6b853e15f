"""The device plugin's policy modules (plugin/config.py, sharing.py,
topology.py, slices.py) against the reference's on the same inputs,
TPU names mapped to GPU ones (accelN -> nvidiaN, /vtpuK -> /vgpuK,
tpu -> gpu in the config's keys): config parsing, defaulting and its
errors; validate_request; partition tables, slice enumerations,
preferred allocations and mesh envs on the reference's own grids (2x2,
2x4, 2x2x2) and on the H100 hosts (n x 1 x 1); the platform rules; and
SliceManager on full and degraded hosts, with the card order from
minor numbers and from NVML's PCI bus order (tests/torch_fake_nvml.py)."""

import json
import re

import pytest

from torch_fake_nvml import FakeNvml
from container_engine_accelerators_tpu.plugin import config as ref_config
from container_engine_accelerators_tpu.plugin import sharing as ref_sharing
from container_engine_accelerators_tpu.plugin import slices as ref_slices
from container_engine_accelerators_tpu.plugin import topology as ref_topo
from container_engine_accelerators_tpu_torch.native import nvml as N
from container_engine_accelerators_tpu_torch.plugin import config as C
from container_engine_accelerators_tpu_torch.plugin import sharing as S
from container_engine_accelerators_tpu_torch.plugin import slices as SL
from container_engine_accelerators_tpu_torch.plugin import topology as T
from container_engine_accelerators_tpu_torch.plugin.api import (
    HEALTHY, UNHEALTHY,
)


def to_gpu(text: str) -> str:
    """A reference name, key or message in the port's terms."""
    text = re.sub(r"accel(\d+)", r"nvidia\1", text)
    return (text.replace("vtpu", "vgpu").replace("TPU", "GPU")
            .replace("tpu", "gpu"))


# -- config ------------------------------------------------------------------
CONFIG_DOCS = [
    {},
    {"slicePartitionSize": "2x2"},
    {"maxTimeSharedClientsPerTPU": 3},
    {"maxTimeSharedClientsPerTPU": 3, "tpuSharingConfig": {
        "tpuSharingStrategy": "time-sharing", "maxSharedClientsPerTPU": 7}},
    {"tpuSharingConfig": {"tpuSharingStrategy": "time-sharing"}},
    {"tpuSharingConfig": {"maxSharedClientsPerTPU": 2}},
    {"tpuSharingConfig": {"tpuSharingStrategy": "mps",
                          "maxSharedClientsPerTPU": 2}},
    {"tpuSharingConfig": {"tpuSharingStrategy": "time-sharing",
                          "maxSharedClientsPerTPU": 4},
     "healthCriticalErrors": [2, 3], "slicePartitionSize": "1x2"},
]


def _config_view(cfg, mod):
    sc = (cfg.tpu_sharing_config if mod is ref_config
          else cfg.gpu_sharing_config)
    return (cfg.slice_partition_size,
            sc.tpu_sharing_strategy if mod is ref_config
            else sc.gpu_sharing_strategy,
            sc.max_shared_clients_per_tpu if mod is ref_config
            else sc.max_shared_clients_per_gpu,
            list(cfg.health_critical_errors), cfg.sharing_enabled)


@pytest.mark.parametrize("doc", CONFIG_DOCS, ids=range(len(CONFIG_DOCS)))
def test_config_parse_and_validate_match_the_reference(doc):
    text = json.dumps(doc)
    ref = ref_config.parse_tpu_config(text)
    port = C.parse_gpu_config(to_gpu(text))
    assert _config_view(port, C) == _config_view(ref, ref_config)
    try:
        ref.add_defaults_and_validate()
        want = None
    except ValueError as e:
        want = to_gpu(str(e))
    if want is None:
        port.add_defaults_and_validate()
        assert _config_view(port, C) == _config_view(ref, ref_config)
    else:
        with pytest.raises(ValueError) as exc:
            port.add_defaults_and_validate()
        assert str(exc.value) == want


@pytest.mark.parametrize("content", [
    None, "{not json", '{"gpuSharingConfig": {"maxSharedClientsPerGPU": 2}}',
    '{"slicePartitionSize": "2x1", "maxTimeSharedClientsPerGPU": 2}',
])
def test_load_falls_back_like_the_reference(tmp_path, content):
    ref_path, port_path = tmp_path / "tpu_config.json", tmp_path / "gpu.json"
    if content is not None:
        ref_path.write_text(to_tpu_keys(content))
        port_path.write_text(content)
    ref = ref_config.load_tpu_config(str(ref_path))
    port = C.load_gpu_config(str(port_path))
    assert _config_view(port, C) == _config_view(ref, ref_config)
    assert (port == C.GPUConfig()) == (ref == ref_config.TPUConfig())


def to_tpu_keys(text: str) -> str:
    return text.replace("GPU", "TPU").replace("gpu", "tpu")


# -- sharing -----------------------------------------------------------------
@pytest.mark.parametrize("device_id", [
    "accel0/vtpu0", "accel12/vtpu3", "slice0/vtpu1", "accel0", "slice0",
    "accel0/vtpu", "vtpu0", "accel0/vtpu0/extra",
])
def test_virtual_ids_match_the_reference(device_id):
    gid = to_gpu(device_id)
    assert S.is_virtual_device_id(gid) is ref_sharing.is_virtual_device_id(
        device_id)
    try:
        want = to_gpu(ref_sharing.virtual_to_physical_device_id(device_id))
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            S.virtual_to_physical_device_id(gid)
        assert str(exc.value) == to_gpu(str(e))
    else:
        assert S.virtual_to_physical_device_id(gid) == want


def test_the_tpu_forms_are_not_virtual_gpus():
    assert not S.is_virtual_device_id("accel0/vtpu0")
    assert not S.is_virtual_device_id("slice0/vtpu1")


@pytest.mark.parametrize("ids,count,strategy", [
    (["accel0/vtpu0"], 4, "time-sharing"),
    (["accel0/vtpu0", "accel0/vtpu1"], 4, "time-sharing"),
    (["accel0/vtpu0", "accel0/vtpu1"], 4, "future-concurrent"),
    (["accel0/vtpu0", "accel0/vtpu1"], 1, "future-concurrent"),
    (["accel0", "accel1"], 4, ""),
    (["accel0", "accel1"], 4, "time-sharing"),
    (["slice0/vtpu0", "slice1/vtpu0"], 2, "time-sharing"),
])
def test_validate_request_matches_the_reference(ids, count, strategy):
    try:
        ref_sharing.validate_request(ids, count, strategy)
        want = None
    except ValueError as e:
        want = to_gpu(str(e)).replace("google.com/gpu", "nvidia.com/gpu")
    gids = [to_gpu(d) for d in ids]
    if want is None:
        S.validate_request(gids, count, strategy)
    else:
        with pytest.raises(ValueError) as exc:
            S.validate_request(gids, count, strategy)
        assert str(exc.value) == want


# -- topology ----------------------------------------------------------------
GRIDS = [(2, 2, 1), (2, 4, 1), (2, 2, 2), (1, 1, 1), (2, 1, 1), (4, 1, 1),
         (8, 1, 1)]


def _platforms(grid):
    n = grid[0] * grid[1] * grid[2]
    return (ref_topo.Platform("grid", "unknown", n, grid, 16),
            T.Platform("grid", "unknown", n, grid))


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_grid_math_matches_the_reference(grid):
    ref, port = _platforms(grid)
    assert T.partition_table(port) == ref_topo.partition_table(ref)
    for size in ref_topo.partition_table(ref):
        got = T.enumerate_slices(port, size)
        assert got == ref_topo.enumerate_slices(ref, size)
        for members in got:
            coords = [T.chip_coord(i, grid) for i in members]
            assert T.is_contiguous_block(coords)
            assert T.bounding_shape(coords) == ref_topo.bounding_shape(coords)
    for i in range(port.chips):
        c = T.chip_coord(i, grid)
        assert c == ref_topo.chip_coord(i, grid)
        assert T.chip_index(c, grid) == ref_topo.chip_index(c, grid) == i
    for size in (1, 2, 3, 4, 8):
        assert T._block_shapes(size, grid) == ref_topo._block_shapes(size, grid)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_preferred_allocation_matches_the_reference(grid):
    ref, port = _platforms(grid)
    n = port.chips
    cases = [(list(range(n)), [], k) for k in range(1, n + 1)]
    cases += [(list(range(n)), [n - 1], k) for k in range(1, n + 1)]
    cases += [([i for i in range(n) if i % 3 != 1], [], 2),
              (list(range(n)), [0, n - 1], 2), ([0, 1], [], 4),
              ([0, 1], [2], 2)]
    for avail, req, size in cases:
        try:
            want = ref_topo.preferred_allocation(ref, avail, req, size)
        except ValueError as e:
            with pytest.raises(ValueError) as exc:
                T.preferred_allocation(port, avail, req, size)
            assert str(exc.value) == str(e)
        else:
            assert T.preferred_allocation(port, avail, req, size) == want


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_mesh_envs_match_the_reference(grid):
    ref, port = _platforms(grid)
    shared = ("TPU_CHIPS_PER_PROCESS_BOUNDS", "TPU_PROCESS_BOUNDS",
              "TPU_VISIBLE_DEVICES", "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES")
    for chips in ([0], list(range(port.chips)), list(range(port.chips))[-2:]):
        for kw in ({}, dict(worker_id=1, worker_hostnames=("a", "b"),
                            process_bounds="2,1,1")):
            want = ref_topo.mesh_envs(ref, chips, **kw)
            got = T.mesh_envs(port, chips, **kw)
            assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
            assert set(got) == set(shared) | {"TPU_ACCELERATOR_TYPE"}
    assert T.multislice_envs("10.0.0.2:8080", 4, 1) == \
        ref_topo.multislice_envs("10.0.0.2:8080", 4, 1)


@pytest.mark.parametrize("bad", ["", "2", "2x", "0x2", "2x-1", "axb",
                                 "1x2x3x4"])
def test_parse_topology_errors_match(bad):
    with pytest.raises(ValueError) as ref_exc:
        ref_topo.parse_topology(bad)
    with pytest.raises(ValueError) as exc:
        T.parse_topology(bad)
    assert str(exc.value) == str(ref_exc.value)
    assert T.parse_topology("2x2x2") == ref_topo.parse_topology("2x2x2")


def test_h100_hosts():
    assert sorted(T.PLATFORMS) == [f"nvidia-h100-80gb-{n}" for n in
                                   (1, 2, 4, 8)]
    for n in (1, 2, 4, 8):
        p = T.detect_platform(n)
        assert (p.accelerator_type, p.chips, p.topology, p.generation) == (
            f"nvidia-h100-80gb-{n}", n, (n, 1, 1), "h100")
    p8 = T.PLATFORMS["nvidia-h100-80gb-8"]
    assert T.partition_table(p8) == {"1x1": 8, "2x1": 4, "4x1": 2, "8x1": 1}
    assert T.enumerate_slices(p8, "2x1") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert T.mesh_envs(p8, [4, 5, 6, 7])["TPU_ACCELERATOR_TYPE"] == \
        "nvidia-h100-80gb-4"
    assert T.preferred_allocation(p8, range(8), [5], 2) == [4, 5]
    assert T.preferred_allocation(p8, [0, 2, 3, 6], [], 2) == [2, 3]
    synth = T.detect_platform(3)
    assert (synth.accelerator_type, synth.topology) == ("gpu-3", (3, 1, 1))


# (cards discovered, declared count): the reference's degraded-host and
# foreign-type rules, v5litepod-K against nvidia-h100-80gb-K.
@pytest.mark.parametrize("n,declared", [
    (8, 8), (7, 8), (5, 8), (4, 8), (1, 8), (8, 4), (0, 4), (4, 4), (3, 4),
    (2, 4), (1, 1), (2, 1)])
def test_declared_type_rules_match_the_reference(n, declared):
    ref = ref_topo.detect_platform(n, f"v5litepod-{declared}")
    port = T.detect_platform(n, f"nvidia-h100-80gb-{declared}")
    ref_kept = ref.accelerator_type == f"v5litepod-{declared}"
    port_kept = port.accelerator_type == f"nvidia-h100-80gb-{declared}"
    assert port_kept == ref_kept
    assert port.chips == (declared if port_kept else max(n, port.chips))


# -- slices ------------------------------------------------------------------
V5E8_GRID = (2, 4, 1)


def _slice_pair(tmp_path, grid, present, size):
    n = grid[0] * grid[1] * grid[2]
    ref_p, port_p = _platforms(grid)
    ref_m = ref_slices.SliceManager(str(tmp_path / "dev"), str(tmp_path / "sys"))
    ref_m.start(size, ref_p, [f"accel{i}" for i in present])
    port_m = SL.SliceManager(str(tmp_path / "dev"))
    port_m.start(size, port_p, [f"nvidia{i}" for i in present])
    assert n == port_p.chips
    return ref_m, port_m


def _slice_view(m):
    return {k: ([to_gpu(c) for c in s.chip_names], s.chip_indices, s.shape,
                m.devices[k].health) for k, s in m.slices.items()}


@pytest.mark.parametrize("grid,size,dead", [
    ((2, 4, 1), "2x2", None), ((2, 4, 1), "1x2", None),
    ((2, 4, 1), "1x1", None), ((2, 4, 1), "2x2", 5), ((2, 4, 1), "2x2", 1),
    ((2, 2, 2), "2x2", 7), ((2, 2, 2), "1x1x2", None), ((8, 1, 1), "2x1", 3),
    ((8, 1, 1), "4x1", None), ((4, 1, 1), "1x1", 0),
])
def test_slice_manager_matches_the_reference(tmp_path, grid, size, dead):
    n = grid[0] * grid[1] * grid[2]
    present = [i for i in range(n) if i != dead]
    ref_m, port_m = _slice_pair(tmp_path, grid, present, size)
    assert _slice_view(port_m) == _slice_view(ref_m)
    for sid in port_m.slices:
        if port_m.devices[sid].health == HEALTHY:
            assert [s.host_path for s in port_m.device_spec(sid)] == [
                to_gpu(s.host_path) for s in ref_m.device_spec(sid)]
        else:
            with pytest.raises(ValueError, match="unhealthy"):
                port_m.device_spec(sid)
    for name in ("accel2", "accel99", "slice0"):
        ref_m.set_device_health(name, UNHEALTHY)
        port_m.set_device_health(to_gpu(name), UNHEALTHY)
        assert _slice_view(port_m) == _slice_view(ref_m)


@pytest.mark.parametrize("size,names,msg", [
    ("3x1", 8, "invalid slice partition size"),
    ("2x1", 9, "expects 8"),
])
def test_slice_manager_errors(tmp_path, size, names, msg):
    m = SL.SliceManager(str(tmp_path))
    with pytest.raises(ValueError, match=msg):
        m.start(size, T.PLATFORMS["nvidia-h100-80gb-8"],
                [f"nvidia{i}" for i in range(names)])
    with pytest.raises(ValueError, match="non-existing"):
        m.device_spec("slice9")


def test_pci_order_places_the_cards(tmp_path):
    # NVML's PCI bus order runs against the minors: nvidia7 first.
    fake = FakeNvml(n=8)
    fake.pci = [(0, 0x90 - 0x10 * i, 0) for i in range(8)]
    nv = N.Nvml(lib=fake)
    p8 = T.PLATFORMS["nvidia-h100-80gb-8"]
    names = [f"nvidia{i}" for i in range(8)]
    assert SL.chip_index_map(p8, names, nv) == {
        f"nvidia{i}": 7 - i for i in range(8)}
    m = SL.SliceManager(str(tmp_path), nv)
    m.start("4x1", p8, names)
    assert sorted(m.slices["slice0"].chip_names) == [
        "nvidia4", "nvidia5", "nvidia6", "nvidia7"]
    # Without a PCI read, the minors; on a degraded host, the minors too.
    fake.rc["nvmlDeviceGetPciInfo_v3"] = N.NVML_ERROR_NOT_SUPPORTED
    assert SL.chip_index_map(p8, names, nv) == {n: i for i, n in
                                                enumerate(names)}
    fake.rc.clear()
    degraded = [n for n in names if n != "nvidia2"]
    assert SL.chip_index_map(p8, degraded, nv) == {
        n: int(n[6:]) for n in degraded}


def test_minors_outside_the_grid_rank_in_minor_order():
    # One card exposed as nvidia7 (a machine's only card), two as
    # nvidia3 and nvidia9.
    p1, p2 = T.PLATFORMS["nvidia-h100-80gb-1"], T.PLATFORMS["nvidia-h100-80gb-2"]
    assert SL.chip_index_map(p1, ["nvidia7"]) == {"nvidia7": 0}
    assert SL.chip_index_map(p2, ["nvidia9", "nvidia3"]) == {
        "nvidia3": 0, "nvidia9": 1}
    with pytest.raises(ValueError, match="not injective"):
        SL.chip_index_map(p1, ["nvidia0", "nvidia1"])
