"""Multi-card slices of the host grid as schedulable devices.  The port of
container_engine_accelerators_tpu/plugin/slices.py (`SliceManager`).

A slice is a block of the host grid (topology.enumerate_slices); its
device spec hands out every member card's /dev node.  Device IDs are
"sliceK", K in block order.  A card's health event marks its slice.
These are slices of the host, not MIG instances of one card.

A card's grid index (`chip_index_map`) comes from the host's card order:
NVML's PCI bus order where NVML serves every card's address on a
complete host, in place of the reference's sysfs chip_coord override;
otherwise the minor number in the name (`nvidia3` -> 3), which keeps a
dead card's slot on a degraded host, as `accelN` -> N does; and where a
minor falls outside the grid (one card exposed as `nvidia7`), the rank
in minor order.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Dict, List, Sequence

from ..native import nvml as nvml_mod
from . import topology as topo_mod
from .api import HEALTHY, UNHEALTHY
from .api import deviceplugin_pb2 as dp_pb2

log = logging.getLogger(__name__)

SLICE_DEVICE_RE = re.compile(r"^slice([0-9]+)$")
CARD_DEVICE_RE = re.compile(r"^nvidia([0-9]+)$")


@dataclasses.dataclass
class SliceInfo:
    slice_id: str
    chip_names: List[str]       # ["nvidia0", "nvidia1", ...]
    chip_indices: List[int]
    shape: str                  # e.g. "2x1"
    accelerator_type: str       # e.g. "nvidia-h100-80gb-2"


def chip_sort_key(name: str):
    m = CARD_DEVICE_RE.match(name)
    return (0, int(m.group(1))) if m else (1, name)


def _pci_order(nvml, chip_names: Sequence[str]):
    """The names in NVML's PCI bus order, or None where NVML does not
    list every name or serves no PCI address."""
    try:
        names = nvml.device_names()
        if sorted(names) != sorted(chip_names):
            return None
        address = {n: nvml.pci_address(i) for i, n in enumerate(names)}
    except nvml_mod.NvmlError as e:
        if e.code != nvml_mod.NVML_ERROR_NOT_SUPPORTED:
            log.warning("unreadable PCI order (%s); using minor numbers", e)
        return None
    return sorted(chip_names, key=lambda n: address[n])


def chip_index_map(
    platform: topo_mod.Platform, chip_names: Sequence[str], nvml=None
) -> Dict[str, int]:
    """Card name -> grid index (module docstring).  The map must place
    each present card at a distinct index of the full host grid: an
    injective map into range(platform.chips), not a permutation of
    range(len(chip_names)), since a dead card's index is absent."""
    names = sorted(chip_names, key=chip_sort_key)
    order = None
    if nvml is not None and len(names) == platform.chips:
        order = _pci_order(nvml, names)
    minors = [chip_sort_key(n) for n in names]
    if order is not None:
        index_of = {n: i for i, n in enumerate(order)}
    elif all(k == 0 and m < platform.chips for k, m in minors):
        index_of = {n: m for n, (_, m) in zip(names, minors)}
    else:
        index_of = {n: i for i, n in enumerate(names)}
    values = list(index_of.values())
    if len(set(values)) != len(values) or not all(
        0 <= v < platform.chips for v in values
    ):
        raise ValueError(
            f"card index map is not injective into the "
            f"{platform.chips}-card grid: {index_of}"
        )
    return index_of


class SliceManager:
    """Slice partitions of the host as schedulable devices."""

    def __init__(self, dev_directory: str = "/dev", nvml=None):
        self.dev_directory = dev_directory
        self.nvml = nvml
        self.slices: Dict[str, SliceInfo] = {}
        self.devices: Dict[str, dp_pb2.Device] = {}
        self._chip_to_slice: Dict[str, str] = {}
        self.partition_size = ""

    def start(
        self,
        partition_size: str,
        platform: topo_mod.Platform,
        chip_names: Sequence[str],
    ) -> None:
        """Partition this host.  The cards must fit the platform and the
        size must tile its grid.  A degraded host (fewer cards than the
        platform declares) still partitions: a slice missing a card is
        advertised Unhealthy, so the kubelet sees the capacity but never
        schedules onto it."""
        chip_names = sorted(chip_names, key=chip_sort_key)
        if len(chip_names) > platform.chips:
            raise ValueError(
                f"found {len(chip_names)} GPUs, but platform "
                f"{platform.accelerator_type} expects {platform.chips}"
            )
        table = topo_mod.partition_table(platform)
        if partition_size not in table:
            raise ValueError(
                f"invalid slice partition size {partition_size!r} for "
                f"{platform.accelerator_type}: valid sizes {sorted(table)}"
            )

        index_of = chip_index_map(platform, chip_names, self.nvml)
        name_of = {v: k for k, v in index_of.items()}
        self.partition_size = partition_size
        self.slices = {}
        self.devices = {}
        self._chip_to_slice = {}
        for k, members in enumerate(topo_mod.enumerate_slices(platform, partition_size)):
            slice_id = f"slice{k}"
            names = [name_of[i] for i in members if i in name_of]
            self.slices[slice_id] = SliceInfo(
                slice_id=slice_id,
                chip_names=names,
                chip_indices=list(members),
                shape=partition_size,
                accelerator_type=topo_mod.subslice_accelerator_type(
                    platform, len(members)
                ),
            )
            health = HEALTHY if len(names) == len(members) else UNHEALTHY
            self.devices[slice_id] = dp_pb2.Device(ID=slice_id, health=health)
            for name in names:
                self._chip_to_slice[name] = slice_id
        log.info(
            "partitioned %s into %d %s slices: %s",
            platform.accelerator_type, len(self.slices), partition_size,
            {s.slice_id: s.chip_names for s in self.slices.values()},
        )

    def list_slice_devices(self) -> Dict[str, dp_pb2.Device]:
        return self.devices

    def device_spec(self, slice_id: str) -> List[dp_pb2.DeviceSpec]:
        """DeviceSpecs for every member card of the slice."""
        info = self.slices.get(slice_id)
        if info is None:
            raise ValueError(
                f"invalid allocation request with non-existing slice {slice_id}"
            )
        if self.devices[slice_id].health != HEALTHY:
            raise ValueError(
                f"invalid allocation request with unhealthy slice {slice_id}"
            )
        specs = []
        for name in info.chip_names:
            path = os.path.join(self.dev_directory, name)
            specs.append(
                dp_pb2.DeviceSpec(host_path=path, container_path=path, permissions="mrw")
            )
        return specs

    def set_device_health(self, name: str, health: str) -> None:
        """Takes a slice ID or a member card's name; a card's event marks
        its slice."""
        if SLICE_DEVICE_RE.match(name):
            if name in self.devices:
                self.devices[name] = dp_pb2.Device(ID=name, health=health)
            return
        slice_id = self._chip_to_slice.get(name)
        if slice_id is not None:
            self.devices[slice_id] = dp_pb2.Device(ID=slice_id, health=health)
        else:
            log.warning("health event for unknown device %s ignored", name)

    def slice_chip_indices(self, slice_id: str) -> List[int]:
        return list(self.slices[slice_id].chip_indices)

    def slice_chip_names(self, slice_id: str) -> List[str]:
        return list(self.slices[slice_id].chip_names)
