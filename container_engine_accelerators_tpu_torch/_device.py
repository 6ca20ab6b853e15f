"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.  The default is the
    card; without one this raises unless the caller asks for the CPU
    (`device="cpu"`), so a missing card never silently turns into a CPU
    run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU"
        )
    return dev


def canonical_device(device) -> torch.device:
    """`device` with its index filled in: "cuda" is the current card
    (so "cuda" and "cuda:0" compare equal on one card); other devices
    as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
