"""serving/: the continuous-batching decode engine on PyTorch (the port
of container_engine_accelerators_tpu/serving/), with its page pool,
radix prefix cache, host/disk KV tiers, supervisor, and the
observability layer (observe.py + otel.py: a Prometheus text-format
registry, per-request trace spans and a flight recorder)."""

from .engine import ContinuousBatchingEngine, SubmitHandle
from .errors import QueueFullError, ReplicaUnavailable, StepFailure
from .observe import (
    EngineObservability,
    FlightRecorder,
    NullObservability,
    Registry,
)
from .supervisor import EngineSupervisor

__all__ = [
    "ContinuousBatchingEngine",
    "EngineObservability",
    "EngineSupervisor",
    "FlightRecorder",
    "NullObservability",
    "QueueFullError",
    "Registry",
    "ReplicaUnavailable",
    "StepFailure",
    "SubmitHandle",
]
