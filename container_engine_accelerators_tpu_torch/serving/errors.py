"""Serving error taxonomy: the port's own copy of
container_engine_accelerators_tpu/serving/errors.py (stdlib only).

These exceptions are the serving stack's contract types: HTTP mapping
(429 vs 500), fleet re-route classification and the RPC wire codec all
dispatch on them.
"""


class QueueFullError(RuntimeError):
    """submit() would push the queued row count past max_queue; the
    caller should shed load (HTTP 429) rather than wait."""


class StepFailure(RuntimeError):
    """decode_step failed persistently (retries exhausted): the active
    rows' device state is lost.  Queued requests are unaffected."""


class ReplicaUnavailable(RuntimeError):
    """The replica serving (or about to serve) this request went away
    — the fleet's signal to re-route rather than fail.  Carries the
    replica index for bookkeeping/tests."""

    def __init__(self, replica: int, why: str):
        super().__init__(
            f"replica {replica} unavailable ({why}); re-routing"
        )
        self.replica = replica
        self.why = why
