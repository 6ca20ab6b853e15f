"""The port's GPUManager (plugin/manager.py) against the reference's
TPUManager on the same hosts, names mapped (accelN -> nvidiaN, /vtpuK ->
/vgpuK): discovery, list_devices, device_spec, health, hotplug and envs
on whole-card, time-shared, partitioned and both hosts of 2 and 3 cards
(where the reference's platform is the same (n, 1, 1) line); then what
the port adds: discovery is the /dev nodes NVML lists, readiness needs
nvidiactl and nvidia-uvm, the default devices, the time-shared budget
from NVML's total, no NVML raises, and the envs Allocate injects parse
through the port's parallel/mesh.py `mesh_from_env` (on two gloo ranks)
and parallel/distributed.py `cluster_from_env` to the granted grid and
process id."""

import os

import pytest

from torch_fake_nvml import FakeNvml
from _torch_port import rank_pools
from container_engine_accelerators_tpu.plugin import config as ref_config
from container_engine_accelerators_tpu.plugin import manager as ref_manager
from container_engine_accelerators_tpu_torch.native import nvml as N
from container_engine_accelerators_tpu_torch.parallel import distributed
from container_engine_accelerators_tpu_torch.plugin import config as C
from container_engine_accelerators_tpu_torch.plugin import manager as M
from container_engine_accelerators_tpu_torch.plugin.api import UNHEALTHY
from container_engine_accelerators_tpu_torch.utils.fake_node import (
    make_fake_node,
)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    yield from rank_pools(tmp_path_factory)


def to_gpu(name):
    return name.replace("accel", "nvidia").replace("vtpu", "vgpu")


def port_manager(root, n, config=None, fake=None, **kw):
    dev = make_fake_node(str(root), n)
    fake = fake or FakeNvml(n=n)
    m = M.GPUManager(dev_directory=dev, gpu_config=config,
                     nvml=N.Nvml(lib=fake), **kw)
    return m, dev, fake


def configs(partition="", shared=0):
    sharing = "time-sharing" if shared else ""
    return (ref_config.TPUConfig(
                slice_partition_size=partition,
                tpu_sharing_config=ref_config.TPUSharingConfig(sharing, shared)),
            C.GPUConfig(
                slice_partition_size=partition,
                gpu_sharing_config=C.GPUSharingConfig(sharing, shared)))


def pair(tmp_path, n, partition="", shared=0):
    ref_cfg, port_cfg = configs(partition, shared)
    dev = tmp_path / "ref" / "dev"
    dev.mkdir(parents=True)
    for i in range(n):
        (dev / f"accel{i}").touch()
    ref = ref_manager.TPUManager(str(dev), str(tmp_path / "ref" / "sys"),
                                 tpu_config=ref_cfg)
    port, _, _ = port_manager(tmp_path / "port", n, port_cfg)
    ref.start()
    port.start()
    return ref, port


def devices(m):
    return {to_gpu(k): v.health for k, v in m.list_devices().items()}


CASES = [(2, "", 0), (3, "", 0), (2, "", 2), (2, "1x1", 0), (2, "2x1", 0),
         (2, "1x1", 3), (3, "3x1", 2)]


@pytest.mark.parametrize("n,partition,shared", CASES)
def test_views_specs_and_envs_match_the_reference(tmp_path, n, partition,
                                                  shared):
    ref, port = pair(tmp_path, n, partition, shared)
    assert devices(port) == devices(ref)
    assert port.platform.topology == ref.platform.topology
    ids = sorted(ref.list_devices())
    shared_envs = ("TPU_CHIPS_PER_PROCESS_BOUNDS", "TPU_PROCESS_BOUNDS",
                   "TPU_VISIBLE_DEVICES", "TPU_WORKER_ID",
                   "TPU_WORKER_HOSTNAMES")
    for grant in [[d] for d in ids] + ([ids] if not shared else []):
        want_paths = [to_gpu(s.host_path).replace("/ref/", "/port/")
                      for d in grant for s in ref.device_spec(d)]
        got_paths = [s.host_path for d in grant
                     for s in port.device_spec(to_gpu(d))]
        assert got_paths == want_paths
        want = ref.envs(grant)
        got = port.envs([to_gpu(d) for d in grant])
        assert {k: got[k] for k in shared_envs} == {
            k: want[k] for k in shared_envs}
        assert ("GPU_DUTY_CYCLE_LIMIT_PCT" in got) == (
            "TPU_DUTY_CYCLE_LIMIT_PCT" in want)
        if shared:
            assert got["GPU_DUTY_CYCLE_LIMIT_PCT"] == want[
                "TPU_DUTY_CYCLE_LIMIT_PCT"]
    # A card's event, then a slice's, then an unknown name.
    for name in ("accel1", "slice0", "accel9"):
        ref.set_device_health(name, UNHEALTHY)
        port.set_device_health(to_gpu(name), UNHEALTHY)
        assert devices(port) == devices(ref)
    for d in ids:
        try:
            ref.device_spec(d)
        except ValueError as e:
            with pytest.raises(ValueError) as exc:
                port.device_spec(to_gpu(d))
            assert str(exc.value) == to_gpu(str(e))
    with pytest.raises(ValueError, match="non-existing"):
        port.device_spec("slice9/vgpu0" if shared else
                         ("slice9" if partition else "nvidia42"))


def test_discovery_and_hotplug_match_the_reference(tmp_path):
    ref, port = pair(tmp_path, 2)
    assert not ref.has_additional_tpus_installed()
    assert not port.has_additional_gpus_installed()
    (tmp_path / "ref" / "dev" / "accel2").touch()
    (tmp_path / "port" / "dev" / "nvidia2").touch()
    fake = port.nvml._lib
    fake.n, fake.minors = 3, [0, 1, 2]
    for attr in ("total", "used", "util", "pci", "uuids"):
        getattr(fake, attr).append(getattr(fake, attr)[-1])
    assert ref.has_additional_tpus_installed()
    assert port.has_additional_gpus_installed()
    ref.discover_tpus()
    port.discover_gpus()
    assert devices(port) == devices(ref)


def test_discovery_is_the_nodes_nvml_lists(tmp_path):
    # /dev holds nvidia0 and nvidia7 and the control nodes, and names
    # no card under a directory; NVML lists one card, minor 7.
    m, dev, fake = port_manager(tmp_path, 0, fake=FakeNvml(n=1, minors=[7]))
    for name in ("nvidia0", "nvidia7", "nvidia-modeset", "nvidia-uvm-tools",
                 "nvidia7x"):
        open(f"{dev}/{name}", "w").close()
    m.check_device_paths()
    m.start()
    assert sorted(m.devices) == ["nvidia7"]
    assert m.platform.accelerator_type == "nvidia-h100-80gb-1"
    assert m.index_of == {"nvidia7": 0}
    assert m.default_devices == [f"{dev}/nvidiactl", f"{dev}/nvidia-uvm",
                                 f"{dev}/nvidia-uvm-tools"]
    assert m.envs(["nvidia7"])["TPU_CHIPS_PER_PROCESS_BOUNDS"] == "1,1,1"
    assert m.card_names(["nvidia7", "nvidia0"]) == ["nvidia7"]


@pytest.mark.parametrize("missing", ["nvidiactl", "nvidia-uvm", "cards",
                                     "nvml_cards"])
def test_readiness_and_start_raise_without_the_nodes(tmp_path, missing):
    fake = FakeNvml(n=0) if missing == "nvml_cards" else FakeNvml(n=2)
    m, dev, _ = port_manager(tmp_path, 0 if missing == "cards" else 2,
                             fake=fake)
    if missing in ("nvidiactl", "nvidia-uvm"):
        os.unlink(f"{dev}/{missing}")
    with pytest.raises(FileNotFoundError):
        m.check_device_paths()
    if missing in ("cards", "nvml_cards"):
        with pytest.raises(FileNotFoundError):
            m.start()
        assert m.list_devices() == {}


def test_no_nvml_raises(tmp_path):
    make_fake_node(str(tmp_path), 2)
    with pytest.raises(N.NvmlUnavailable):
        M.GPUManager(dev_directory=str(tmp_path / "dev"))


def test_a_failed_nvml_read_lists_nothing(tmp_path):
    m, _, fake = port_manager(tmp_path, 2)
    fake.rc["nvmlDeviceGetCount_v2"] = 999
    with pytest.raises(N.NvmlError):
        m.start()
    assert m.list_devices() == {}


def test_time_shared_budget_is_nvml_total(tmp_path):
    fake = FakeNvml(n=2)
    fake.total = [40 << 30, 80 << 30]
    _, cfg = configs("2x1", 4)
    m, _, _ = port_manager(tmp_path, 2, cfg, fake=fake)
    m.start()
    envs = m.envs(["slice0/vgpu3"])
    assert envs["GPU_HBM_TOTAL_BYTES"] == str(40 << 30)
    assert envs["GPU_HBM_LIMIT_BYTES"] == str(10 << 30)
    assert envs["GPU_DUTY_CYCLE_LIMIT_PCT"] == "25"
    assert "GPU_HBM_TOTAL_BYTES" not in m.envs(["slice0"])


def test_allocated_envs_parse_to_the_grant(tmp_path, pools):
    # A two-card slice of an 8-card host: parallel/mesh.py builds the
    # granted (2, 1) grid on two ranks.
    _, cfg = configs("2x1")
    m, _, _ = port_manager(tmp_path, 8, cfg, worker_id=1,
                           worker_hostnames=["host-a", "host-b"],
                           process_bounds="2,1,1",
                           multislice=("coord:9999", 2, 1))
    m.start()
    env = m.envs(["slice2"])
    assert env["TPU_VISIBLE_DEVICES"] == "4,5"
    assert distributed.cluster_from_env(env) is None  # a partial grant
    got = pools(2).run("meshes", env=env)
    assert got[0]["env"]["grid"] == got[1]["env"]["grid"] == [[0], [1]]
    assert got[0]["env"]["names"] == ["data", "model"]
    # The whole host: worker 1 of two hosts, slice 1 of two slices.
    full = m.envs([f"slice{k}" for k in range(4)])
    assert full["TPU_CHIPS_PER_PROCESS_BOUNDS"] == "8,1,1"
    assert distributed.cluster_from_env(full) == ("coord:8476", 4, 3)
    del full["MEGASCALE_COORDINATOR_ADDRESS"]
    assert distributed.cluster_from_env(full) == ("host-a:8476", 2, 1)
