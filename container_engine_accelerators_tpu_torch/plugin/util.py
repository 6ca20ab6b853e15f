"""Small shared helpers: the port of
container_engine_accelerators_tpu/plugin/util.py, for `nvidia0`-style
device names (the card's /dev node)."""

from __future__ import annotations

import os
import re


def device_name_from_path(path: str, dev_directory: str = "/dev") -> str:
    """``/dev/nvidia0`` -> ``nvidia0``.  Raises ValueError if the path is
    not under the device directory."""
    rel = os.path.relpath(path, dev_directory)
    if rel.startswith("..") or os.sep in rel:
        raise ValueError(f"device path {path} is not directly under {dev_directory}")
    return rel


def device_path_from_name(name: str, dev_directory: str = "/dev") -> str:
    """``nvidia0`` -> ``/dev/nvidia0``."""
    return os.path.join(dev_directory, name)


def device_index(name: str) -> int:
    """``nvidia3`` -> ``3``: the index encoded in a device name.
    Raises ValueError for names without a trailing integer."""
    m = re.search(r"(\d+)$", name)
    if m is None:
        raise ValueError(f"device name {name!r} has no trailing index")
    return int(m.group(1))


# Liveness states of a vendor layer, most-alive first.  Shared by the
# health event source's vendor layer and anything that exports its
# state, so the two can never drift.
SDK_STATES = ("active", "unparseable", "empty", "absent")


def aggregate_sdk_state(states) -> str:
    """Most-alive state across per-metric observations: one served
    metric makes the layer "active" even while others are absent."""
    seen = set(states)
    for s in SDK_STATES:
        if s in seen:
            return s
    return "absent"
