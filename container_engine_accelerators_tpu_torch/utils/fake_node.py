"""Fake GPU node: the /dev surface the device-plugin daemon scans, for
development runs without a card.  The port of
container_engine_accelerators_tpu/utils/fake_node.py.

Writes `dev/nvidia0` .. `dev/nvidia<N-1>`, `dev/nvidiactl` and
`dev/nvidia-uvm` under a root.  The rest of a card (its NVML answers)
comes from an NVML function table, such as tests/torch_fake_nvml.py's
FakeNvml, passed to the daemon in place of the NVIDIA driver's library.

    python3 -m container_engine_accelerators_tpu_torch.utils.fake_node \\
        --root /tmp/fake-gpu --gpus 8
"""

from __future__ import annotations

import argparse
import os

CONTROL_NODES = ("nvidiactl", "nvidia-uvm")


def make_fake_node(root: str, gpus: int = 8) -> str:
    """Create root/dev with `gpus` card nodes and the control nodes;
    returns the dev directory."""
    dev = os.path.join(root, "dev")
    os.makedirs(dev, exist_ok=True)
    for name in [f"nvidia{i}" for i in range(gpus)] + list(CONTROL_NODES):
        open(os.path.join(dev, name), "w").close()
    return dev


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--gpus", type=int, default=8)
    args = p.parse_args(argv)
    dev = make_fake_node(args.root, args.gpus)
    print(f"fake GPU node ready: --dev-directory {dev}")


if __name__ == "__main__":
    main()
