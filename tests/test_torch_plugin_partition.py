"""The port's partitioner (partition.py) against the reference's
cmd/partition_tpu/main.py: exit codes 0 (nothing to do, or a plan
written and verified), 1 (bad config or size) and 2 (no card, or a plan
NVML disagrees with); the plan itself on full and degraded H100 hosts
over a fake node (utils/fake_node.py) and the fake NVML, verified
against NVML's cards and PCI bus order; and the reference's own plans
on the same (n, 1, 1) host, names mapped."""

import importlib.util
import json
import os

import pytest

from torch_fake_nvml import FakeNvml
from container_engine_accelerators_tpu_torch import partition
from container_engine_accelerators_tpu_torch.native import nvml as N
from container_engine_accelerators_tpu_torch.utils.fake_node import (
    make_fake_node,
)

_REF_MAIN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cmd", "partition_tpu", "main.py")
_spec = importlib.util.spec_from_file_location("ref_partition_tpu", _REF_MAIN)
ref_partition = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_partition)


def run(tmp_path, config, n=8, fake=None, dead=None, accelerator_type=None,
        raw=None):
    dev = make_fake_node(str(tmp_path), n)
    fake = fake or FakeNvml(n=n)
    if dead is not None:
        os.unlink(os.path.join(dev, f"nvidia{dead}"))
        fake.n -= 1
        fake.minors.remove(dead)
        fake.pci.pop(dead)
    cfg = tmp_path / "gpu_config.json"
    cfg.write_text(raw if raw is not None else json.dumps(config))
    plan = tmp_path / "etc" / "slice_plan.json"
    argv = ["--gpu-config", str(cfg), "--plan-file", str(plan),
            "--dev-directory", dev]
    if accelerator_type:
        argv += ["--accelerator-type", accelerator_type]
    rc = partition.main(argv, nvml=N.Nvml(lib=fake))
    return rc, (json.loads(plan.read_text()) if plan.exists() else None)


def ref_run(tmp_path, config, n):
    dev = tmp_path / "ref" / "dev"
    dev.mkdir(parents=True)
    for i in range(n):
        (dev / f"accel{i}").touch()
    cfg = tmp_path / "ref" / "tpu_config.json"
    cfg.write_text(json.dumps(config))
    plan = tmp_path / "ref" / "plan.json"
    argv = ["--tpu-config", str(cfg), "--plan-file", str(plan),
            "--dev-directory", str(dev), "--sysfs-directory",
            str(tmp_path / "ref" / "sys"), "--tpu-ctl", "/nonexistent"]
    rc = ref_partition.main(argv)
    return rc, (json.loads(plan.read_text()) if plan.exists() else None)


def cards(plan):
    return [s["chips"] for s in plan["slices"]]


@pytest.mark.parametrize("config,n", [
    ({}, 3), ({"slicePartitionSize": "1x1"}, 3),
    ({"slicePartitionSize": "3x1"}, 3), ({"slicePartitionSize": "2x1"}, 3),
    ({"tpuSharingConfig": {"maxSharedClientsPerTPU": 2}}, 3),
])
def test_plans_and_exit_codes_match_the_reference(tmp_path, config, n):
    # Three cards: both packages' platform is the (3, 1, 1) line.
    want_rc, want = ref_run(tmp_path, config, n)
    text = json.dumps(config).replace("TPU", "GPU").replace("tpu", "gpu")
    rc, got = run(tmp_path / "port", None, n=n, raw=text)
    assert rc == want_rc
    assert (got is None) == (want is None)
    if want is not None:
        assert cards(got) == [[c.replace("accel", "nvidia") for c in s]
                              for s in cards(want)]
        assert got["hostTopology"] == want["hostTopology"]
        assert got["partitionSize"] == want["partitionSize"]


def test_plan_on_an_h100_host(tmp_path):
    rc, plan = run(tmp_path, {"slicePartitionSize": "2x1"})
    assert rc == 0
    assert plan["acceleratorType"] == "nvidia-h100-80gb-8"
    assert plan["hostTopology"] == "8x1"
    assert cards(plan) == [[f"nvidia{i}", f"nvidia{i + 1}"]
                           for i in range(0, 8, 2)]


def test_plan_follows_the_pci_order(tmp_path):
    fake = FakeNvml(n=4)
    fake.pci = [(0, 0x40, 0), (0, 0x10, 0), (0, 0x30, 0), (0, 0x20, 0)]
    rc, plan = run(tmp_path, {"slicePartitionSize": "2x1"}, n=4, fake=fake)
    assert rc == 0
    assert [sorted(s) for s in cards(plan)] == [
        ["nvidia1", "nvidia3"], ["nvidia0", "nvidia2"]]


@pytest.mark.parametrize("dead", [3, 7, 0])
def test_degraded_host_plan(tmp_path, dead):
    rc, plan = run(tmp_path, {"slicePartitionSize": "4x1"}, dead=dead,
                   accelerator_type="nvidia-h100-80gb-8")
    assert rc == 0
    s0, s1 = plan["slices"]
    for s, block in ((s0, range(4)), (s1, range(4, 8))):
        assert s["chips"] == [f"nvidia{i}" for i in block if i != dead]
        assert s.get("degraded", False) == (dead in block)


class CountFailsLater(FakeNvml):
    """NVML whose device count fails after the session opened."""

    opened = False

    def nvmlDeviceGetCount_v2(self, out):
        if self.opened:
            return 999
        self.opened = True
        return FakeNvml.nvmlDeviceGetCount_v2(self, out)


@pytest.mark.parametrize("case,want", [
    ("no_cards", 2), ("no_nvml_cards", 2), ("pci_mismatch", 2),
    ("count_read_fails", 2), ("bad_json", 1), ("bad_size", 1),
    ("pci_unsupported", 0)])
def test_exit_codes(tmp_path, monkeypatch, case, want):
    config = {"slicePartitionSize": "2x1"}
    fake = CountFailsLater(n=4) if case == "count_read_fails" else (
        FakeNvml(n=0 if case == "no_nvml_cards" else 4))
    raw = "{not json" if case == "bad_json" else None
    if case == "bad_size":
        config = {"slicePartitionSize": "3x1"}
    elif case == "pci_unsupported":
        fake.rc["nvmlDeviceGetPciInfo_v3"] = N.NVML_ERROR_NOT_SUPPORTED
    elif case == "pci_mismatch":
        # The PCI order changes between the plan and its verification.
        verify = partition.verify_plan

        def reordered(nvml, platform, plan):
            fake.pci.reverse()
            return verify(nvml, platform, plan)

        monkeypatch.setattr(partition, "verify_plan", reordered)
    rc, plan = run(tmp_path, config, n=0 if case == "no_cards" else 4,
                   fake=fake, raw=raw)
    assert rc == want
    assert (plan is not None) == (case in ("pci_mismatch", "pci_unsupported"))


def test_no_nvml_raises(tmp_path):
    dev = make_fake_node(str(tmp_path), 2)
    cfg = tmp_path / "gpu_config.json"
    cfg.write_text('{"slicePartitionSize": "1x1"}')
    with pytest.raises(N.NvmlUnavailable):
        partition.main(["--gpu-config", str(cfg), "--dev-directory", dev,
                        "--plan-file", str(tmp_path / "plan.json")])
