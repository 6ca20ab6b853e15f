"""GPU sharing: the virtual-device ID scheme and request validation.  The
port of container_engine_accelerators_tpu/plugin/sharing.py
(`is_virtual_device_id` :33, `virtual_to_physical_device_id` :40,
`validate_request` :49).

Time-sharing fans each card (or slice) out into N virtual devices named
``<physical>/vgpuK``; a container requests ``nvidia.com/gpu`` and is
given a virtual device that maps back to the underlying /dev nodes.
"""

from __future__ import annotations

import re

UNDEFINED = ""
TIME_SHARING = "time-sharing"

VALID_STRATEGIES = (UNDEFINED, TIME_SHARING)

# Card form: "nvidia0/vgpu1" (physical "nvidia0").
_CARD_VIRTUAL_RE = re.compile(r"nvidia([0-9]+)/vgpu([0-9]+)$")
# Slice form: "slice0/vgpu1" (physical "slice0", one or more cards).
_SLICE_VIRTUAL_RE = re.compile(r"slice([0-9]+)/vgpu([0-9]+)$")
_VGPU_SUFFIX_RE = re.compile(r"/vgpu([0-9]+)$")


def is_virtual_device_id(device_id: str) -> bool:
    """True if the ID names a virtual (time-shared) device."""
    return bool(_CARD_VIRTUAL_RE.match(device_id)) or bool(
        _SLICE_VIRTUAL_RE.match(device_id)
    )


def virtual_to_physical_device_id(virtual_device_id: str) -> str:
    """``nvidia0/vgpu1`` -> ``nvidia0`` (``slice0/vgpu1`` -> ``slice0``).
    Raises ValueError for IDs that are not virtual."""
    if not is_virtual_device_id(virtual_device_id):
        raise ValueError(f"virtual device ID ({virtual_device_id}) is not valid")
    return _VGPU_SUFFIX_RE.sub("", virtual_device_id)


def validate_request(request_device_ids, device_count: int, strategy: str) -> None:
    """Validate a container's device request under the sharing strategy:
      - time-sharing: at most one virtual device per container;
      - any other concurrent strategy: a request for several virtual
        devices only on a node with one physical device.
    Raises ValueError on an invalid request."""
    if len(request_device_ids) > 1 and is_virtual_device_id(request_device_ids[0]):
        if strategy == TIME_SHARING:
            raise ValueError(
                "invalid request for sharing GPU (time-sharing): at most 1 "
                "nvidia.com/gpu can be requested on time-shared GPU nodes"
            )
        if device_count > 1:
            raise ValueError(
                "invalid request for sharing GPU: multiple shared GPUs can "
                "only be requested on nodes with a single physical GPU"
            )
