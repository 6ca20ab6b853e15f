"""serving/: the continuous-batching decode engine on PyTorch (the port
of container_engine_accelerators_tpu/serving/), with its page pool,
radix prefix cache and supervisor."""

from .engine import ContinuousBatchingEngine, SubmitHandle
from .errors import QueueFullError, ReplicaUnavailable, StepFailure
from .supervisor import EngineSupervisor

__all__ = [
    "ContinuousBatchingEngine",
    "EngineSupervisor",
    "QueueFullError",
    "ReplicaUnavailable",
    "StepFailure",
    "SubmitHandle",
]
