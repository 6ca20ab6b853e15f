"""One-shot GPU slice partitioner (an init container).  The port of
cmd/partition_tpu/main.py.

    python -m container_engine_accelerators_tpu_torch.partition [flags]

It reads the node config the daemon reads (--gpu-config), checks the
slice size against the host's grid, and writes the slice plan
(--plan-file) that the daemon's slice manager will serve.  Slicing is a
plan over the host's cards: nothing on a card changes.  The plan is then
verified against NVML: its cards must be the cards NVML lists, and on a
complete host each slice must be a block of NVML's PCI bus order (where
NVML serves no PCI address, the card check alone stands).

Exit codes: 0 success or nothing to do; 1 bad config or size; 2 no card,
or the plan disagrees with NVML.  Without libnvidia-ml.so.1 it raises
NvmlUnavailable.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .native import nvml as nvml_mod
from .plugin import config as config_mod
from .plugin import manager as manager_mod
from .plugin import slices as slices_mod
from .plugin import topology

log = logging.getLogger("partition_gpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GPU slice partitioner")
    p.add_argument("--gpu-config", default="/etc/nvidia/gpu_config.json")
    p.add_argument("--plan-file", default="/etc/nvidia/slice_plan.json")
    p.add_argument("--dev-directory", default="/dev")
    p.add_argument("--accelerator-type", default=None)
    return p.parse_args(argv)


def verify_plan(nvml, platform: topology.Platform, plan: dict) -> bool:
    """The plan against NVML's cards and, on a complete host, its PCI
    order (module docstring)."""
    names = nvml.device_names()
    planned = [n for s in plan["slices"] for n in s["chips"]]
    if sorted(names) != sorted(planned):
        log.error("slice plan cards %s are not NVML's %s", planned, names)
        return False
    if len(names) != platform.chips:
        log.info("degraded host: plan verified against NVML's cards only")
        return True
    try:
        address = {n: nvml.pci_address(i) for i, n in enumerate(names)}
    except nvml_mod.NvmlError as e:
        if e.code != nvml_mod.NVML_ERROR_NOT_SUPPORTED:
            raise
        log.warning("NVML serves no PCI address; plan verified against "
                    "NVML's cards only")
        return True
    order = sorted(names, key=lambda n: address[n])
    want = [sorted(order[i] for i in members) for members in
            topology.enumerate_slices(platform, plan["partitionSize"])]
    got = [sorted(s["chips"]) for s in plan["slices"]]
    if got != want:
        log.error("slice plan disagrees with NVML's PCI order:\n"
                  "  plan: %s\n  NVML: %s", got, want)
        return False
    return True


def main(argv=None, nvml=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = parse_args(argv)

    # Strict: a malformed config fails provisioning visibly, where the
    # daemon falls back to the default config.
    try:
        with open(args.gpu_config, "r", encoding="utf-8") as f:
            cfg = config_mod.parse_gpu_config(f.read())
        cfg.add_defaults_and_validate()
    except (OSError, ValueError) as e:
        log.error("failed to read GPU config %s: %s", args.gpu_config, e)
        return 1

    if not cfg.slice_partition_size:
        log.info("No slice partition size specified; nothing to do.")
        return 0

    m = manager_mod.GPUManager(dev_directory=args.dev_directory,
                               accelerator_type=args.accelerator_type,
                               nvml=nvml)
    try:
        chip_names = m.scan_card_names()
    except nvml_mod.NvmlError as e:
        log.error("NVML cannot list the cards: %s", e)
        return 2
    if not chip_names:
        log.error("no /dev/nvidia<minor> card NVML lists under %s",
                  args.dev_directory)
        return 2
    platform = topology.detect_platform(len(chip_names), args.accelerator_type)
    sm = slices_mod.SliceManager(dev_directory=args.dev_directory, nvml=m.nvml)
    try:
        sm.start(cfg.slice_partition_size, platform, chip_names)
    except ValueError as e:
        log.error("slice partition failed: %s", e)
        return 1
    degraded = len(chip_names) < platform.chips
    plan_slices = []
    for info in sm.slices.values():  # slice0..N-1
        entry = {"id": info.slice_id, "chips": list(info.chip_names)}
        if len(info.chip_names) != len(info.chip_indices):
            entry["degraded"] = True
        plan_slices.append(entry)
    plan = {
        "acceleratorType": platform.accelerator_type,
        "hostTopology": platform.topology_str,
        "partitionSize": cfg.slice_partition_size,
        "slices": plan_slices,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.plan_file)), exist_ok=True)
    with open(args.plan_file, "w", encoding="utf-8") as f:
        json.dump(plan, f, indent=2)
        f.write("\n")
    log.info(
        "wrote slice plan: %d x %s slices -> %s%s",
        len(plan_slices), cfg.slice_partition_size, args.plan_file,
        " (degraded host: %d of %d cards present)"
        % (len(chip_names), platform.chips) if degraded else "",
    )
    try:
        ok = verify_plan(m.nvml, platform, plan)
    except nvml_mod.NvmlError as e:
        log.error("NVML verification failed: %s", e)
        return 2
    if not ok:
        return 2
    log.info("slice plan verified against NVML")
    return 0


if __name__ == "__main__":
    sys.exit(main())
