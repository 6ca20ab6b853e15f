"""Engine supervisor: restart a crashed scheduler OR a dead worker
process; bound the crash loop either way.  The port's own copy of
container_engine_accelerators_tpu/serving/supervisor.py, same
behaviour.

The ContinuousBatchingEngine contains failures per-request (admit) and
per-step-batch (decode retry, then fail-active-rows) — but a persistent
decode failure, or any unexpected error escaping the scheduler loop,
ends the scheduler THREAD.  This module is the layer that keeps the
node serving through that, the serving-side analog of the reference
stack's health checker keeping a node schedulable past a bad chip:

  - the supervisor watches the engine's crash handshake
    (engine._crashed) and calls engine.revive(): fresh KV cache (the
    active rows' device state died with the crash and was already
    failed), the SAME compiled programs, and the queued requests
    preserved — waiting submitters ride through the restart;
  - restarts are budgeted (`max_restarts` within `window_s`): a
    crash-looping engine (persistent compile breakage, dead device)
    must not burn the host re-prefilling the same doomed queue forever.
    Budget exhausted => engine.kill(): everything fails fast and
    subsequent submits raise, which a fronting server surfaces as 503
    (orchestration restarts the pod — the right layer for a
    non-recovering fault).

THE SUPERVISED THING IS A CONTRACT, NOT A CLASS.  The watch loop
consumes only the engine crash protocol — `_crashed` (Event, set
after `_crash_error` publishes under `_cv`), `_closed` / `_dead`
(read under `_cv`), `revive()`, `kill(err)`, `snapshot()["restarts"]`,
`attach_supervisor()` — so the SAME supervisor that revives a crashed
scheduler thread respawns a dead engine-worker PROCESS: serving/rpc.py
RemoteEngine implements the protocol with process semantics
(`revive()` = spawn + socket handshake + readiness gate, bounded by a
spawn timeout so a worker that never comes up consumes budget instead
of hanging the loop; `kill()` = SIGKILL + reap).  One documented
divergence: a dead process takes its queue with it, so queued tickets
are NOT preserved across a process respawn — RemoteEngine fails them
with WorkerLost at connection loss and the fleet re-route path
(serving/fleet.py) re-homes them on siblings, which is where a fleet
wants them anyway.

The supervisor thread is a daemon and exits on its own when the engine
closes; stop() exists for embedders that tear down mid-test.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


# state-machine: engine field: state states: live,crashed,reviving,dead terminal: dead
class EngineSupervisor:
    """Watchdog over one ContinuousBatchingEngine's scheduler thread.

    `state` is the supervisor's own view of its engine — the `engine`
    lifecycle machine (statecheck/interleave enforce the edges): live
    (serving) -> crashed (handshake observed) -> reviving (budget
    spent, revive() in flight) -> live again, with dead terminal
    (budget exhausted, or a crash pending at stop()).  It is a
    REPORTING surface (tests/embedders poll it); the engine's own
    crash protocol stays the source of truth.

    max_restarts/window_s: the restart budget — more than max_restarts
    revivals within a sliding window_s marks the engine permanently
    failed.  restart_backoff_s: pause before each revival (a crash
    right after restart usually means the fault is still there; don't
    hot-loop the prefill path against it).  on_restart/on_giveup:
    optional callbacks (restart count / terminal error) for the
    server's drain + metrics hooks."""

    def __init__(
        self,
        engine,
        *,
        max_restarts: int = 3,
        window_s: float = 60.0,
        restart_backoff_s: float = 0.2,
        on_restart: Optional[Callable[[int], None]] = None,
        on_giveup: Optional[Callable[[BaseException], None]] = None,
    ):
        self._engine = engine
        self._max_restarts = int(max_restarts)
        self._window_s = float(window_s)
        self._backoff_s = float(restart_backoff_s)
        self._on_restart = on_restart
        self._on_giveup = on_giveup
        # Restart-budget state: written by the watch thread, readable
        # by embedders/tests polling the budget.
        self._lock = threading.Lock()
        self._restart_times: "collections.deque[float]" = collections.deque()  # guarded-by: _lock
        self.state = "live"  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        engine.attach_supervisor(self)

    def start(self) -> "EngineSupervisor":
        self._thread = threading.Thread(
            target=self._watch, name="cb-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Detach BEFORE joining: a crash after stop() must take the
        # engine's unsupervised fail-fast path (mark dead, fail all) —
        # a still-attached-but-stopped supervisor would leave the
        # engine waiting forever for a revive that never comes.
        self._engine.attach_supervisor(None)
        # Wake the watch loop promptly (it waits on the crash event
        # with a short timeout, so a plain set suffices).
        if self._thread is not None:
            self._thread.join(timeout=10)
        # A crash pending at stop time would otherwise be abandoned
        # (neither revived nor failed): resolve it the unsupervised
        # way so waiters are answered instead of wedged.  The engine's
        # crash state is guarded by its _cv (reentrant), so the read is
        # taken under it and kill() runs after release.
        eng = self._engine
        with eng._cv:
            pending = (
                eng._crashed.is_set()
                and not eng._closed
                and eng._dead is None
            )
            err = (
                eng._crash_error
                or RuntimeError("engine scheduler crashed")
            )
        if pending:
            with self._lock:
                # transition: live|crashed|reviving -> dead
                self.state = "dead"
            eng.kill(err)

    # -- watchdog --------------------------------------------------------
    def _watch(self) -> None:
        eng = self._engine
        while not self._stop.is_set():
            crashed = eng._crashed.wait(timeout=0.25)
            # The engine's crash fields are guarded by its _cv
            # (an unlocked cross-thread read here would race the
            # scheduler).  The idle poll
            # stays cheap: one brief lock acquisition per 0.25s —
            # noise next to the scheduler's own per-step acquisitions
            # — and the fallback error is only built after a crash.
            with eng._cv:
                closed = eng._closed
                crash_error = eng._crash_error
            if self._stop.is_set() or closed:
                return
            if not crashed:
                continue
            err = crash_error or RuntimeError("scheduler crashed")
            with self._lock:
                if self.state != "crashed":
                    # transition: live|reviving -> crashed
                    self.state = "crashed"
            now = time.monotonic()
            with self._lock:
                while (
                    self._restart_times
                    and now - self._restart_times[0] > self._window_s
                ):
                    self._restart_times.popleft()
                n_used = len(self._restart_times)
            if n_used >= self._max_restarts:
                log.error(
                    "engine crashed %d times within %.0fs; giving up: %s",
                    n_used + 1, self._window_s, err,
                )
                # Flight-recorder breadcrumb BEFORE kill() dumps: the
                # budget decision itself is a scheduler event the
                # post-mortem should show (budget used vs window).
                obs = getattr(eng, "observability", None)
                if obs is not None:
                    obs.event(
                        "restart_budget_exhausted",
                        used=n_used, window_s=self._window_s,
                    )
                with self._lock:
                    # transition: crashed -> dead
                    self.state = "dead"
                eng.kill(
                    RuntimeError(
                        f"engine exceeded the restart budget "
                        f"({self._max_restarts} in {self._window_s:.0f}s); "
                        f"last crash: {err}"
                    )
                )
                if self._on_giveup is not None:
                    try:
                        self._on_giveup(err)
                    except Exception:  # pylint: disable=broad-except
                        log.exception("on_giveup callback failed")
                return
            # Backoff before rebuilding: an immediately-recurring fault
            # should cost idle time, not a prefill storm.
            if self._stop.wait(self._backoff_s):
                return
            with self._lock:
                self._restart_times.append(time.monotonic())
                # transition: crashed -> reviving
                self.state = "reviving"
            try:
                revived = eng.revive()
            except Exception as e:  # pylint: disable=broad-except
                # revive() itself failed (e.g. cache rebuild OOM): that
                # consumes budget like any crash; the engine is still
                # marked crashed, so the next loop iteration retries or
                # gives up.
                log.error("engine revive failed: %s", e)
                with self._lock:
                    # transition: reviving -> crashed
                    self.state = "crashed"
                continue
            if not revived:
                return  # closed/dead underneath us
            with self._lock:
                # transition: reviving -> live
                self.state = "live"
            if self._on_restart is not None:
                try:
                    # The engine's stats["restarts"] is the ONE restart
                    # counter (revive() increments it); the supervisor
                    # does not keep a second copy that could drift.
                    self._on_restart(eng.snapshot()["restarts"])
                except Exception:  # pylint: disable=broad-except
                    log.exception("on_restart callback failed")
