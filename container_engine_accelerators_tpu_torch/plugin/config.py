"""Node GPU configuration: the file both the device-plugin daemon and the
partitioner read.  The port of
container_engine_accelerators_tpu/plugin/config.py (`TPUSharingConfig`
:41, `TPUConfig` :53, `parse_tpu_config` :109, `load_tpu_config` :124),
with TPU -> GPU in the names and the JSON keys.

Schema (JSON, camelCase keys), read from ``/etc/nvidia/gpu_config.json``:

    {
      "slicePartitionSize": "2x1",
      "maxTimeSharedClientsPerGPU": 2,        # deprecated
      "gpuSharingConfig": {
        "gpuSharingStrategy": "time-sharing",
        "maxSharedClientsPerGPU": 2
      },
      "healthCriticalErrors": [2, 3]
    }

``slicePartitionSize`` is validated by the slice manager against the
host's grid, not here.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import List

from . import sharing

log = logging.getLogger(__name__)


@dataclasses.dataclass
class GPUSharingConfig:
    """How cards (or slices) on this node may be shared between
    containers."""

    # "" (off) or "time-sharing": the only concurrent strategy, enforced
    # through the envs Allocate injects.
    gpu_sharing_strategy: str = sharing.UNDEFINED
    # Most clients allowed to share one card or slice.
    max_shared_clients_per_gpu: int = 0


@dataclasses.dataclass
class GPUConfig:
    """Settings used to configure the cards on a node."""

    # Slice partition size over the host grid, e.g. "1x1", "2x1", "4x1".
    # Empty: whole cards are the schedulable unit.
    slice_partition_size: str = ""
    # Deprecated in favour of gpu_sharing_config.
    max_time_shared_clients_per_gpu: int = 0
    gpu_sharing_config: GPUSharingConfig = dataclasses.field(
        default_factory=GPUSharingConfig)
    # Error codes (plugin/health.py) that mark a device unhealthy, beyond
    # the always-critical set.
    health_critical_errors: List[int] = dataclasses.field(default_factory=list)

    def add_defaults_and_validate(self) -> None:
        """Apply the deprecation default, then validate.  Raises
        ValueError on an invalid config."""
        if self.max_time_shared_clients_per_gpu > 0:
            if (
                self.gpu_sharing_config.gpu_sharing_strategy != sharing.UNDEFINED
                or self.gpu_sharing_config.max_shared_clients_per_gpu > 0
            ):
                log.info(
                    "Both maxTimeSharedClientsPerGPU and gpuSharingConfig are "
                    "set; using the value of maxTimeSharedClientsPerGPU"
                )
            self.gpu_sharing_config.gpu_sharing_strategy = sharing.TIME_SHARING
            self.gpu_sharing_config.max_shared_clients_per_gpu = (
                self.max_time_shared_clients_per_gpu
            )
            return
        strategy = self.gpu_sharing_config.gpu_sharing_strategy
        if strategy == sharing.TIME_SHARING:
            if self.gpu_sharing_config.max_shared_clients_per_gpu <= 0:
                raise ValueError(
                    "maxSharedClientsPerGPU should be > 0 for the "
                    "time-sharing GPU sharing strategy"
                )
        elif strategy == sharing.UNDEFINED:
            if self.gpu_sharing_config.max_shared_clients_per_gpu > 0:
                raise ValueError(
                    "GPU sharing strategy needs to be specified when "
                    "maxSharedClientsPerGPU > 0"
                )
        else:
            raise ValueError(
                f"invalid GPU sharing strategy: {strategy!r}, should be "
                "time-sharing"
            )

    @property
    def sharing_enabled(self) -> bool:
        return self.gpu_sharing_config.max_shared_clients_per_gpu > 0


def parse_gpu_config(text: str) -> GPUConfig:
    """Parse the JSON config document.  Raises on malformed input."""
    raw = json.loads(text)
    sharing_raw = raw.get("gpuSharingConfig", {})
    return GPUConfig(
        slice_partition_size=raw.get("slicePartitionSize", ""),
        max_time_shared_clients_per_gpu=raw.get("maxTimeSharedClientsPerGPU", 0),
        gpu_sharing_config=GPUSharingConfig(
            gpu_sharing_strategy=sharing_raw.get(
                "gpuSharingStrategy", sharing.UNDEFINED),
            max_shared_clients_per_gpu=sharing_raw.get(
                "maxSharedClientsPerGPU", 0),
        ),
        health_critical_errors=list(raw.get("healthCriticalErrors", [])),
    )


def load_gpu_config(path: str) -> GPUConfig:
    """Load and validate the node config file.  On any failure (missing
    file, bad JSON, invalid values) returns the empty default config, so
    a bad file never prevents whole-card scheduling."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            config = parse_gpu_config(f.read())
        config.add_defaults_and_validate()
        return config
    except (OSError, ValueError) as e:
        log.error("failed to load GPU config from %s: %s; using default config",
                  path, e)
        return GPUConfig()
