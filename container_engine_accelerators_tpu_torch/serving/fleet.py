"""Fleet-scale serving: N engine replicas behind a health-routed,
prefix-affine router.

The port's own copy of container_engine_accelerators_tpu/serving/
fleet.py.  Everything above `_build_replicas` is the reference's:
placement, drains, eviction, re-route-not-fail, migrate-or-recompute,
tier fetch, traces and the metrics relabel.  The replicas are the
port's engines: `submeshes=` gives replica i the dp mesh submeshes[i]
(parallel/mesh.py `local_dp_submeshes`; None for a one-device replica),
and `devices=` places single-device replicas (one torch device each;
default every replica on the model's device).  Replicas on one device
share the model: an engine only reads the weights.  The process fleet
spawns the port's worker
(container_engine_accelerators_tpu_torch.serving.worker), each worker
an interpreter with its own CUDA context.

This is the serving analog of the source paper's node broker closing
the loop with its cluster scheduler: each replica is one
ContinuousBatchingEngine (its own KV cache, its own iteration-level
scheduler, its own supervisor), and the FleetManager is the layer
above the engine lock domain that

  - PLACES each admission through serving/router.py — load-aware
    scoring from live per-engine stats, prefix affinity steering
    shared-prefix requests to the replica whose radix prefix cache
    already holds the pages, consistent-hash fallback for cold
    prefixes;
  - consumes a plugin/health.py EventSource PER REPLICA
    (ListAndWatch-style, the same wait/recover loop shape as
    TPUHealthChecker): a critical device event drains THAT replica
    only — no new placements, queued tickets pulled back and
    re-routed to siblings, in-flight rows left to finish on the
    still-running engine — and an ERROR_CLEARED recovery event
    rejoins it;
  - handles replica DEATH (supervisor restart budget exhausted) with
    zero collateral: the dead replica is evicted from the hash ring
    and the affinity index, its queued tickets are RE-ROUTED rather
    than failed (the re-route-not-fail contract below), and siblings
    never see anything but their own traffic;
  - exports per-engine labelled gauges/counters through ONE
    observe.Registry — each replica keeps its own private registry
    (no second books), and a collect-time callback relabels every
    replica's families with engine="<i>" so /metrics (and the
    plugin/metrics.py bridge) shows the whole fleet on one scrape,
    the paper's exporter-next-to-allocator shape end to end.

The re-route-not-fail contract: a request failed by a replica is
re-placed on a sibling iff (a) the failure is REPLICA loss — the
engine is dead/killed, or the fleet itself withdrew the ticket from a
draining replica — never per-request containment (a poison prompt
fails on any replica; re-running it would turn one bad request into N
admission failures), and (b) the caller has observed nothing yet: a
request with no on_token observer re-runs transparently at any point,
a streaming request only while zero tokens have been delivered
(re-streaming from token 0 would corrupt the consumer).  Everything
else propagates to the caller exactly as the single-engine contract
says it should.

Threading: fleet.submit runs on the caller's thread (placements and
re-route loops live there); health watches and supervisor callbacks
mutate membership from their own threads.  All fleet-shared state
rides `_lock`; the fleet lock
never nests inside any engine's lock — fleet code only calls engine
APIs that take their own locks (snapshot/submit_nowait/cancel), which
is what keeps the router ABOVE the engine lock domain.
"""

from __future__ import annotations

import collections
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import observe as observe_mod
from . import otel
from . import rpc as rpc_mod
# ReplicaUnavailable lives in serving/errors.py so the RPC wire codec
# round-trips the type without a fleet import; re-exported here, as the
# reference does.
from .errors import QueueFullError, ReplicaUnavailable, StepFailure
from .router import NoReplicasError, Router
from .supervisor import EngineSupervisor

# The engine import happens inside FleetManager._build_replicas: a
# ProcessFleetManager router places, drains and scrapes without ever
# building a model or touching a device (each worker process owns its
# own).

log = logging.getLogger(__name__)

def _model_on(model, device):
    """A copy of `model` (same config, same weights) on `device`."""
    from ..models.generate import model_copy

    return model_copy(model, device)


# Replica lifecycle (mirrors the server drain-state machine, per
# replica): UP takes traffic; DRAINING finishes in-flight rows but
# accepts no placements (health event, recoverable); DEAD is evicted
# (restart budget exhausted, terminal).
UP = "up"
DRAINING = "draining"
DEAD = "dead"

# Replica roles (disaggregated prefill/decode): a scheduling
# policy over identical engines, never a capability split.
PREFILL = "prefill"
DECODE = "decode"

# fleet_kv_migrate_seconds ladder: local-socket page moves sit in the
# ms range; the tail prices a congested or cross-host transfer.
MIGRATE_SECONDS_BUCKETS = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]

# fleet_scrape_seconds ladder: a local worker scrape is sub-ms; the
# tail is exactly the slow/wedged-worker signal the histogram exists
# to surface (scraper self-observability).
SCRAPE_SECONDS_BUCKETS = [
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0,
]

# Bound on one assembled trace's span count: a pathological request
# (hundreds of prefill chunks across re-routes) must not grow the
# trace ring's memory per entry without bound.  Dropped spans are
# counted on the trace ("spans_dropped").
MAX_TRACE_SPANS = 192

# Event codes that drain a replica (plugin/health.py taxonomy 1-6 plus
# the DEVICE_REMOVED synthetic) — same default set as the demo
# server's whole-process health watch; the fleet applies it per
# replica instead.
DEFAULT_CRITICAL = frozenset({1, 2, 3, 4, 5, 1000})
ERROR_CLEARED = 0


# state-machine: replica field: state states: up,draining,dead terminal: dead
class FleetReplica:
    """One engine + its supervisor + (optionally) its health watch.
    State transitions are owned by the FleetManager under its lock;
    everything here is plumbing, not policy (the `replica` lifecycle
    machine)."""

    __slots__ = (
        "idx", "engine", "supervisor", "state", "health_source",
        "health_thread", "health_stop", "unhealthy",
    )

    def __init__(self, idx: int, engine, supervisor):
        self.idx = idx
        self.engine = engine
        self.supervisor = supervisor
        self.state = UP
        self.health_source = None
        self.health_thread: Optional[threading.Thread] = None
        self.health_stop = threading.Event()
        self.unhealthy: set = set()


class FleetManager:
    """N supervised ContinuousBatchingEngine replicas behind a Router.

    model: a decode=True TransformerLM shared by every replica on its
    device (each engine builds its own cache and only reads the
    weights).  n_replicas x n_slots: the fleet shape.  devices: one
    torch device per replica (None: every replica on model.device); a
    replica on another device serves a copy of the model made there,
    one copy a device.  submeshes: one parallel.mesh.LocalMesh (or None)
    per replica; replica i then runs a dp-mesh engine on submeshes[i],
    homed on its first device, and a None entry is a single-device
    replica placed as `devices` says.
    engine_kw: passed to every engine (paged, page size, prefill chunk,
    max_queue, ... — rng_seed is offset per replica so replicas don't
    sample in lockstep).  affinity=False builds the consistent-hash-only
    control router (an A/B's control arm).
    max_restarts/restart_window_s/restart_backoff_s: each replica's
    supervisor budget.  on_all_dead(err): called once when the LAST
    replica is evicted (the server wires its terminal drain here).
    registry: share the embedder's observe.Registry so fleet series
    render on its /metrics scrape (None builds a private one)."""

    def __init__(
        self,
        model,
        n_replicas: int,
        n_slots: int,
        *,
        engine_kw: Optional[dict] = None,
        devices: Optional[Sequence] = None,
        submeshes: Optional[Sequence] = None,
        affinity: bool = True,
        roles: Optional[Sequence[str]] = None,
        migrate: bool = False,
        migrate_kw: Optional[dict] = None,
        router_kw: Optional[dict] = None,
        health_critical=None,
        max_restarts: int = 3,
        restart_window_s: float = 60.0,
        restart_backoff_s: float = 0.1,
        on_all_dead: Optional[Callable[[BaseException], None]] = None,
        registry=None,
        trace: bool = True,
        trace_capacity: int = 256,
    ):
        if n_replicas < 1:
            raise ValueError(
                f"n_replicas must be >= 1, got {n_replicas}"
            )
        if submeshes is not None and len(submeshes) != n_replicas:
            raise ValueError(
                f"{len(submeshes)} submeshes for {n_replicas} replicas"
            )
        if devices is not None and len(devices) != n_replicas:
            raise ValueError(
                f"{len(devices)} devices for {n_replicas} replicas"
            )
        kw = dict(engine_kw or {})
        base_seed = int(kw.pop("rng_seed", 0))
        self._critical = frozenset(
            health_critical if health_critical is not None
            else DEFAULT_CRITICAL
        )
        self._on_all_dead = on_all_dead
        self.registry = registry or observe_mod.Registry()
        # Disaggregated prefill/decode: roles type each
        # replica "prefill" (chunked-prefills, hands pages off, never
        # decodes a client request) or "decode" (admits requests WITH
        # their pages; placement targets live here).  Roles are
        # SCHEDULING POLICY, not capability — every engine can do both,
        # which is what lets the fleet fall back to any UP replica
        # when a whole role goes dark.  None = the co-located control.
        if roles is not None:
            roles = [str(r) for r in roles]
            if len(roles) != n_replicas:
                raise ValueError(
                    f"{len(roles)} roles for {n_replicas} replicas"
                )
            bad = sorted(set(roles) - {PREFILL, DECODE})
            if bad:
                raise ValueError(
                    f"unknown replica roles {bad}; use "
                    f"{PREFILL!r}/{DECODE!r}"
                )
            if DECODE not in roles:
                raise ValueError(
                    "a disaggregated fleet needs >= 1 decode replica"
                )
        self._roles = roles
        # Cross-replica KV page migration: when on, the router is
        # KV-cache-centric — placement knows which replica OWNS a hot
        # prefix (router ownership tracking) and fetches the pages
        # (export move -> adopt) instead of recomputing them, scored
        # migrate-or-recompute by prefix length vs MEASURED transfer
        # cost.  Roles imply migration (the prefill->decode handoff
        # IS a migration).
        self._migrate = bool(migrate) or roles is not None
        mkw = dict(migrate_kw or {})
        # Minimum matched pages worth fetching at all.
        self._migrate_min_pages = int(mkw.pop("min_pages", 1))
        # Uncovered prompt tokens below which the decode replica just
        # recomputes locally (chunk-resume) instead of paying a
        # prefill-worker round trip; default: two pages.
        page_size = int(kw.get("page_size", 64))
        self._handoff_min_tokens = int(
            mkw.pop("handoff_min_tokens", 2 * page_size)
        )
        self._migrate_timeout_s = float(mkw.pop("timeout_s", 30.0))
        self._handoff_timeout_s = float(
            mkw.pop("handoff_timeout_s", 300.0)
        )
        # Recompute-side rate for the migrate-or-recompute score.  The
        # TRANSFER side is measured live (EMA over completed
        # migrations); the prefill side is a knob because the fleet
        # never observes an isolated per-token prefill cost — the
        # default is the reference's, deliberately conservative.
        self._recompute_tok_s = float(
            mkw.pop("recompute_tok_s", 2000.0)
        )
        if mkw:
            raise ValueError(f"unknown migrate_kw keys {sorted(mkw)}")
        self._migrate_bps: Optional[float] = None  # guarded-by: _lock
        self._migrate_page_bytes: Optional[float] = None  # guarded-by: _lock
        self._migrate_n = 0  # completed migrations  # guarded-by: _lock
        self._migrate_skip_streak = 0  # guarded-by: _lock
        # Hierarchical KV tiers: per-tier promote cost EMA —
        # the owner loading a cold prefix out of host RAM or disk
        # back into its HBM trie before the export/adopt migration.
        # Same measured-cost-vs-recompute score and probe-after-skips
        # discipline as _should_migrate, keyed by the deepest tier
        # the fetch touches ("host" / "disk").
        self._tier_fetch_spp: Dict[str, float] = {}  # s/page EMA  # guarded-by: _lock
        self._tier_fetch_n: Dict[str, int] = {}  # guarded-by: _lock
        self._tier_skip_streak: Dict[str, int] = {}  # guarded-by: _lock
        self._migrate_hist = self.registry.histogram(
            "fleet_kv_migrate_seconds",
            "Wall time of one cross-replica KV page migration "
            "(export + wire + adopt) — the measured transfer cost the "
            "migrate-or-recompute score consumes",
            MIGRATE_SECONDS_BUCKETS,
        )
        self._tier_fetch_hist = self.registry.histogram(
            "fleet_kv_tier_fetch_seconds",
            "Wall time of one router-driven tier promotion on the "
            "owning replica (probe + promote RPC), labelled with the "
            "deepest tier the load touched — the measured fetch cost "
            "the tier fetch-or-recompute score consumes",
            MIGRATE_SECONDS_BUCKETS,
            labelnames=("tier",),
        )
        # Scraper self-observability: the router's per-worker
        # metric scrape was invisible — a slow or failing scrape now
        # shows up on the router's OWN registry, per worker.
        self._scrape_hist = self.registry.histogram(
            "fleet_scrape_seconds",
            "Wall time of one replica metric scrape from the router "
            "(serving/fleet.py _collect; process fleets pay an RPC "
            "round trip here, in-process fleets a registry collect)",
            SCRAPE_SECONDS_BUCKETS,
            labelnames=("engine",),
        )
        self._scrape_failures = self.registry.counter(
            "fleet_scrape_failures_total",
            "Replica metric scrapes that failed (that replica's "
            "families dropped for the scrape)",
            labelnames=("engine",),
        )
        # Fleet-wide distributed tracing: the router owns the
        # ASSEMBLED view — root span + placement/handoff/migrate
        # spans recorded here, worker spans shipped back on terminal
        # frames, sealed (partial traces included) into a bounded
        # ring with a tail-latency digest /tracez serves.  `trace`
        # False is the overhead-control arm;
        # set_tracing() toggles it on a live fleet so the A/B never
        # pays a rebuild between interleaved pairs.
        self._trace_enabled = bool(trace)
        self.traces = otel.TraceRing(capacity=int(trace_capacity))
        self.digest = otel.TailDigest()
        self.router = Router(
            page_size=page_size,
            affinity=affinity,
            track=self._migrate,
            **(router_kw or {}),
        )
        # The placement seam the fault harness wraps (seam "route",
        # serving/faults.py install_fleet_faults).
        self._route = self.router.place
        self._lock = threading.Lock()
        self._replicas: List[FleetReplica] = []
        self._outstanding = {  # guarded-by: _lock
            i: set() for i in range(n_replicas)
        }
        self._stats = {  # guarded-by: _lock
            "submitted": 0,        # fleet.submit calls
            "completed": 0,        # calls returned to the caller
            "rerouted": 0,         # placements retried on a sibling
            "yanked": 0,           # queued tickets pulled off a drain
            "spills": 0,           # QueueFullError -> sibling retries
            "drains": 0,           # replica health-drain transitions
            "recoveries": 0,       # replica drain->up transitions
            "replica_deaths": 0,   # replicas evicted (budget exhausted)
            # Cross-replica KV page migration:
            "kv_migrations": 0,        # completed export->adopt moves
            "kv_pages_migrated": 0,    # pages carried by them
            "kv_migrate_bytes": 0,     # serialized KV bytes moved
            "kv_migrate_failures": 0,  # failed moves (target recomputes)
            "kv_migrate_skipped": 0,   # scored recompute-cheaper
            # Hierarchical KV tiers:
            "kv_tier_fetches": 0,         # owner-side promotions driven
            "kv_tier_pages_fetched": 0,   # pages those promotions raised
            "kv_tier_fetch_failures": 0,  # probe/promote RPCs that failed
            "kv_tier_fetch_skipped": 0,   # scored recompute-cheaper
            "prefill_handoffs": 0,         # prefill-worker handoffs
            "prefill_handoff_failures": 0,  # (decode side recomputed)
            # Network robustness (moved by ProcessFleetManager's
            # net-event hook — always-zero for in-process fleets):
            "net_disconnects": 0,   # dirty connection losses observed
            "net_reconnects": 0,    # transient losses healed in budget
            "net_giveups": 0,       # reconnect budgets exhausted
            "net_quarantines": 0,   # flapping replicas fenced off
            "net_rejoins": 0,       # quarantined replicas probed back
        }
        self._closed = False  # guarded-by: _lock
        self._build_replicas(
            model, n_replicas, n_slots, kw, devices, submeshes,
            base_seed, max_restarts, restart_window_s,
            restart_backoff_s,
        )
        for rep in self._replicas:
            self.router.add_replica(rep.idx)
        self.registry.register_collector("fleet", self._collect)

    def _build_replicas(self, model, n_replicas, n_slots, kw, devices,
                        submeshes, base_seed, max_restarts,
                        restart_window_s, restart_backoff_s) -> None:
        """Construct the replica set (engine + supervisor each) —
        the seam ProcessFleetManager overrides to back each replica
        with an engine-worker PROCESS instead of an in-process
        engine.  Everything above this (placement, drains, re-route,
        eviction, metrics relabelling) is replica-backend agnostic:
        it only consumes the engine duck-type."""
        import torch

        from .engine import ContinuousBatchingEngine

        if "device" in kw:
            raise ValueError("a fleet's replicas take devices=, not "
                             "engine_kw['device']")
        models = {model.device: model}
        for i in range(n_replicas):
            mesh = submeshes[i] if submeshes else None
            dev = (mesh.devices[0] if mesh is not None
                   else model.device if devices is None
                   else torch.device(devices[i]))
            if dev not in models:
                models[dev] = _model_on(model, dev)
            eng = ContinuousBatchingEngine(
                models[dev], n_slots,
                mesh=mesh,
                rng_seed=base_seed + i,
                device=dev,
                **kw,
            )
            # Span process label: in-process replicas share one pid,
            # so the replica index is the distinguishing identity.
            obs = getattr(eng, "observability", None)
            if obs is not None:
                obs.process = f"engine{i}"
            sup = self._supervise(
                i, eng, max_restarts, restart_window_s,
                restart_backoff_s,
            )
            self._replicas.append(FleetReplica(i, eng, sup))

    def _supervise(self, i, eng, max_restarts, restart_window_s,
                   restart_backoff_s) -> EngineSupervisor:
        """One supervisor wired into the fleet's membership hooks —
        identical for in-process engines and RemoteEngine workers
        (the supervisor contract is the seam; serving/rpc.py module
        docstring)."""
        return EngineSupervisor(
            eng,
            max_restarts=max_restarts,
            window_s=restart_window_s,
            restart_backoff_s=restart_backoff_s,
            on_restart=(
                lambda n, idx=i: self._requeue_after_restart(idx)
            ),
            on_giveup=(lambda err, idx=i: self._evict(idx, err)),
        ).start()

    # -- introspection ---------------------------------------------------
    @property
    def replicas(self) -> List[FleetReplica]:
        return list(self._replicas)

    @property
    def engines(self) -> list:
        return [r.engine for r in self._replicas]

    def replica_states(self) -> List[str]:
        with self._lock:
            return [r.state for r in self._replicas]

    @property
    def alive_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.state != DEAD)

    def snapshot(self) -> dict:
        """The fleet's /statz surface: per-replica engine snapshots
        (each an atomic engine-side copy), replica states, router
        stats, and the fleet's own counters."""
        with self._lock:
            states = [r.state for r in self._replicas]
            stats = dict(self._stats)
        return {
            "replicas": len(self._replicas),
            "replica_states": states,
            "replica_roles": list(self._roles) if self._roles else None,
            "fleet": stats,
            "router": self.router.stats(),
            "engines": [r.engine.snapshot() for r in self._replicas],
        }

    # -- health (plugin/health.py EventSource per replica) ---------------
    def attach_health_source(self, idx: int, source,
                             critical=None) -> None:
        """Subscribe replica `idx` to a health EventSource (the
        ListAndWatch shape: blocking wait(), recover() on a broken
        watch).  A critical or host-wide event drains the replica; an
        ERROR_CLEARED event that empties its unhealthy set rejoins
        it.  Tests pass a
        faults.ScriptedEventSource; production passes
        plugin/health.make_event_source per device group."""
        rep = self._replicas[idx]
        self._stop_health_watch(rep)
        rep.health_source = source
        rep.health_stop = threading.Event()
        rep.unhealthy = set()
        crit = frozenset(
            critical if critical is not None else self._critical
        )
        rep.health_thread = threading.Thread(
            target=self._health_loop, args=(rep, crit),
            name=f"fleet-health-{idx}", daemon=True,
        )
        rep.health_thread.start()

    def _stop_health_watch(self, rep: FleetReplica) -> None:
        if rep.health_thread is not None:
            rep.health_stop.set()
            rep.health_thread.join(timeout=10)
            rep.health_thread = None

    def _health_loop(self, rep: FleetReplica, critical) -> None:
        # Same contract as TPUHealthChecker._listen_to_events and the
        # server's _HealthWatch: a broken event watch is rebuilt with
        # recover(), never crashes the subscriber.
        while not rep.health_stop.is_set():
            try:
                event = rep.health_source.wait(1000)
            except Exception as e:  # pylint: disable=broad-except
                log.warning(
                    "fleet replica %d health watch error: %r",
                    rep.idx, e,
                )
                rep.health_stop.wait(0.2)
                try:
                    rep.health_source.recover()
                except Exception:  # pylint: disable=broad-except
                    pass
                continue
            if event is None:
                continue
            code = int(event.error_code)
            dev = int(getattr(event, "device_index", -1))
            if code == ERROR_CLEARED:
                if dev < 0:
                    rep.unhealthy.clear()
                else:
                    rep.unhealthy.discard(dev)
                if not rep.unhealthy:
                    self._undrain(rep.idx)
                continue
            if getattr(event, "is_host_event", False):
                rep.unhealthy.add("host")
            elif code in critical:
                rep.unhealthy.add(dev)
            else:
                continue
            self._drain(rep.idx, f"device-health code {code}")

    # -- membership transitions ------------------------------------------
    def _yank_queued(self, idx: int, why: str) -> int:
        """Withdraw the replica's never-admitted tickets so their
        waiters re-route to siblings.  Admitted rows are left alone:
        their prefill/decode work is real and their engine may finish
        it.  cancel_if_queued is atomic against the admit pop — a
        check-then-cancel pair could lose the race to a concurrent
        admission whose lagged commit would then stream a token into
        a request the fleet already re-routed."""
        with self._lock:
            handles = list(self._outstanding[idx])
        yanked = 0
        for h in handles:
            if h.cancel_if_queued(ReplicaUnavailable(idx, why)):
                yanked += 1
        if yanked:
            with self._lock:
                self._stats["yanked"] += yanked
        return yanked

    def _requeue_after_restart(self, idx: int) -> None:
        """Supervisor restart hook: the replica's queue survived the
        crash, but in a FLEET the right home for that queue is
        a healthy sibling — if the fault persists, leaving it would
        burn one ticket batch per crash-revive cycle; if the fault
        cleared, siblings still serve them sooner than a cold
        rebuilt cache."""
        self._yank_queued(idx, "scheduler restarted; re-homing queue")

    def _drain(self, idx: int, why: str) -> None:
        """Health drain: stop placing on the replica and pull its
        QUEUED tickets back for re-routing.  Rows already admitted
        (prefill or decode in flight) finish on the still-running
        engine — the device may be degraded, not gone, and their work
        is real."""
        with self._lock:
            rep = self._replicas[idx]
            if rep.state != UP:
                return
            rep.state = DRAINING  # transition: up -> draining
            self._stats["drains"] += 1
        log.warning("fleet replica %d draining: %s", idx, why)
        self._yank_queued(idx, f"draining: {why}")

    def _undrain(self, idx: int) -> None:
        with self._lock:
            rep = self._replicas[idx]
            if rep.state != DRAINING:
                return
            rep.state = UP  # transition: draining -> up
            self._stats["recoveries"] += 1
        log.warning("fleet replica %d recovered; rejoining", idx)

    def _evict(self, idx: int, err: BaseException) -> None:
        """Terminal: the replica's supervisor exhausted its restart
        budget (the engine is already killed — its queued tickets
        failed with the terminal error and their waiters re-route).
        Drop it from the ring and the affinity index so no future
        placement names it.  Zero collateral by construction: nothing
        here touches a sibling."""
        with self._lock:
            rep = self._replicas[idx]
            if rep.state == DEAD:
                return
            # transition: up|draining -> dead
            rep.state = DEAD
            self._stats["replica_deaths"] += 1
            alive = sum(
                1 for r in self._replicas if r.state != DEAD
            )
        self.router.remove_replica(idx)
        log.error(
            "fleet replica %d evicted (%d alive): %s", idx, alive, err,
        )
        if alive == 0 and self._on_all_dead is not None:
            try:
                self._on_all_dead(err)
            except Exception:  # pylint: disable=broad-except
                log.exception("on_all_dead callback failed")

    def _replica_down(self, idx: int) -> bool:
        """Replica-loss classification for the re-route gate: dead,
        draining, or mid-crash (a ticket failed while its replica's
        scheduler was down IS a replica loss, even though the
        supervisor may yet revive it)."""
        with self._lock:
            state = self._replicas[idx].state
        eng = self._replicas[idx].engine
        return state != UP or eng.crashed or eng.dead is not None

    # -- placement + submission ------------------------------------------
    def _eligible_stats(self, exclude, role: Optional[str] = None) -> dict:
        """Live stats for the replicas the router may use.  A replica
        whose scheduler is mid-crash (supervisor restarting it) takes
        no NEW placements while any healthy sibling exists — routing
        into a crash loop burns each admission at the next crash.
        When EVERY up replica is mid-crash, they stay eligible (the
        queue is preserved across revival; queuing there beats
        failing the request outright).  `role` filters a disaggregated
        fleet to that role's replicas — and falls back to EVERY up
        replica when the whole role is dark (roles are policy, not
        capability: a prefill engine decoding beats a failed
        request)."""
        with self._lock:
            up = [
                r.idx for r in self._replicas
                if r.state == UP and r.idx not in exclude
                and (
                    role is None or self._roles is None
                    or self._roles[r.idx] == role
                )
            ]
        if not up and role is not None:
            return self._eligible_stats(exclude, role=None)
        healthy = [
            i for i in up if not self._replicas[i].engine.crashed
        ]
        stats = {}
        for i in healthy or up:
            eng = self._replicas[i].engine
            snap = eng.snapshot()
            stats[i] = {
                "queue_depth": snap["queue_depth"],
                "active_rows": snap["active_rows"],
                "slots": eng.n_slots,
                "kv_pages_in_use": snap.get("kv_pages_in_use", 0),
                "kv_pages_total": snap.get("kv_pages_total", 0),
            }
        return stats

    # -- cross-replica KV page migration ---------------------------------
    def _replica_usable(self, idx: int) -> bool:
        with self._lock:
            if self._replicas[idx].state != UP:
                return False
        eng = self._replicas[idx].engine
        return not eng.crashed and eng.dead is None

    def _should_migrate(self, n_pages: int) -> bool:
        """Migrate-or-recompute: fetch iff the MEASURED transfer cost
        (EMA bytes/s and bytes/page over completed migrations)
        undercuts recomputing the prefix at the configured prefill
        rate.  The first migration's sample is excluded from the EMA —
        it pays the gather/scatter seams' one-time set-up and would
        poison the estimate against every later fetch — and after 8
        consecutive skips one fetch runs anyway as a PROBE: a stale
        pessimistic estimate must be able to re-measure, or one
        congested transfer turns migration off forever."""
        if n_pages < self._migrate_min_pages:
            return False
        with self._lock:
            bps = self._migrate_bps
            page_bytes = self._migrate_page_bytes
        if bps is None or page_bytes is None:
            return True
        est_transfer_s = n_pages * page_bytes / max(bps, 1.0)
        recompute_s = (
            n_pages * self.router.page / max(self._recompute_tok_s,
                                             1e-6)
        )
        if est_transfer_s >= recompute_s:
            with self._lock:
                self._migrate_skip_streak += 1
                probe = self._migrate_skip_streak >= 8
                if probe:
                    self._migrate_skip_streak = 0
                else:
                    self._stats["kv_migrate_skipped"] += 1
            return probe
        return True

    def _should_tier_fetch(self, tier: str, n_pages: int) -> bool:
        """Tier fetch-or-recompute: drive the owner's
        promotion iff the MEASURED promote cost (seconds-per-page EMA
        over completed fetches, keyed by the deepest tier touched)
        undercuts recomputing at the configured prefill rate.  The
        first fetch per tier is excluded from the EMA (it pays the
        scatter seam's one-time set-up through the owner), and after
        8 consecutive skips one fetch runs anyway as a PROBE — the
        exact _should_migrate discipline, one streak per tier."""
        with self._lock:
            spp = self._tier_fetch_spp.get(tier)
        if spp is None:
            return True
        est_fetch_s = n_pages * spp
        recompute_s = (
            n_pages * self.router.page / max(self._recompute_tok_s,
                                             1e-6)
        )
        if est_fetch_s >= recompute_s:
            with self._lock:
                streak = self._tier_skip_streak.get(tier, 0) + 1
                if streak >= 8:
                    self._tier_skip_streak[tier] = 0
                    return True
                self._tier_skip_streak[tier] = streak
                self._stats["kv_tier_fetch_skipped"] += 1
            return False
        return True

    def _note_tier_fetch(self, tier: str, n_pages: int,
                         dt: float) -> None:
        """Fold one completed tier promotion into the per-tier
        seconds-per-page EMA (first sample per tier excluded — the
        one-time set-up would poison every later score)."""
        with self._lock:
            n = self._tier_fetch_n.get(tier, 0)
            self._tier_fetch_n[tier] = n + 1
            self._tier_skip_streak[tier] = 0
            if n == 0:
                return
            spp = dt / max(n_pages, 1)
            prev = self._tier_fetch_spp.get(tier)
            self._tier_fetch_spp[tier] = (
                spp if prev is None else 0.5 * prev + 0.5 * spp
            )

    # borrows-pages
    def _tier_fetch(self, owner: int, route_row, depth: int,
                    tier: str, trace=None) -> int:
        """The promotion side-job: before migrating a prefix
        off `owner`, raise its tier-resident continuation (host RAM /
        disk spill) back into the owner's HBM trie so the export
        below sees the full chain.  Probes the owner for pages past
        its trie match, refreshes the affinity hint with the deepest
        tier that actually holds pages, and — when the per-tier cost
        EMA says the load beats recomputing — drives
        promote_prefix_pages on the owner.  Returns the owner's
        (possibly raised) HBM page depth.  Never raises: every
        failure falls back to whatever the trie already holds, and
        the target recomputes the rest."""
        page = self.router.page
        # Always probe — even when the hint claims the owner is
        # HBM-resident at full depth.  Hints go stale in exactly one
        # direction (the owner demoted behind the router's back), and
        # the probe is a trie match plus three dict lookups; trusting
        # the hint here would skip the tier fetch precisely when it
        # pays.
        del tier  # hint only routes us to the owner
        eng = self._replicas[owner].engine
        try:
            probe = eng.tier_probe(route_row)
        except Exception as e:  # pylint: disable=broad-except
            with self._lock:
                self._stats["kv_tier_fetch_failures"] += 1
            log.warning("tier probe on replica %d failed: %r",
                        owner, e)
            return depth
        hbm = int(probe.get("hbm_pages", 0))
        host = int(probe.get("host_pages", 0))
        disk = int(probe.get("disk_pages", 0))
        n_tiered = host + disk
        if n_tiered == 0:
            return max(depth, hbm)
        deepest = "disk" if disk else "host"
        # Refresh the affinity hint: the owner holds this prefix, but
        # (partly) in a cold tier — future placements score the fetch
        # accordingly even when this one skips.
        self.router.record(
            route_row[: (hbm + n_tiered) * page], owner, tier=deepest
        )
        if not self._should_tier_fetch(deepest, n_tiered):
            return max(depth, hbm)
        t0 = time.monotonic()
        try:
            promoted = int(eng.promote_prefix_pages(
                route_row, timeout_s=self._migrate_timeout_s,
            ))
        except Exception as e:  # pylint: disable=broad-except
            with self._lock:
                self._stats["kv_tier_fetch_failures"] += 1
            if trace is not None:
                trace.span(
                    "tier_fetch", t0, time.monotonic(),
                    {"replica": owner, "tier": deepest,
                     "failed": True, "error": type(e).__name__},
                )
            log.warning(
                "tier fetch on replica %d failed (the migration uses "
                "whatever HBM already holds): %r", owner, e,
            )
            return max(depth, hbm)
        dt = max(time.monotonic() - t0, 1e-9)
        if promoted <= 0:
            # The owner's own cost EMA said recompute, or the load
            # failed cleanly (corrupt blob already counted there).
            return max(depth, hbm)
        self._tier_fetch_hist.observe(dt, deepest)
        self._note_tier_fetch(deepest, promoted, dt)
        with self._lock:
            self._stats["kv_tier_fetches"] += 1
            self._stats["kv_tier_pages_fetched"] += promoted
        self.router.record(
            route_row[: (hbm + promoted) * page], owner, tier="hbm"
        )
        if trace is not None:
            trace.span(
                "tier_fetch", t0, t0 + dt,
                {"replica": owner, "tier": deepest,
                 "pages": promoted},
            )
        return hbm + promoted

    # transfers-pages-to: adopt_prefix_pages
    def _migrate_prefix(self, src: int, dst: int, tokens,
                        trace=None) -> int:
        """MOVE one prefix's pages src -> dst (export move=True,
        adopt, affinity re-points at the next record()).  Never
        raises: migration is a cache optimization — any failure logs,
        counts, and leaves the target to recompute.  Returns pages
        moved.  `trace` gains a "migrate" span (export + wire +
        adopt, with the failure recorded on the span when one
        happens)."""
        t0 = time.monotonic()
        try:
            out = self._replicas[src].engine.export_prefix_pages(
                tokens, move=True,
                timeout_s=self._migrate_timeout_s,
            )
            if out is None:
                return 0
            meta, blob = out
            self._replicas[dst].engine.adopt_prefix_pages(
                tokens[: int(meta["tokens_covered"])], meta, blob,
                timeout_s=self._migrate_timeout_s,
            )
        except Exception as e:  # pylint: disable=broad-except
            with self._lock:
                self._stats["kv_migrate_failures"] += 1
            if trace is not None:
                trace.span(
                    "migrate", t0, time.monotonic(),
                    {"src": src, "dst": dst, "failed": True,
                     "error": type(e).__name__},
                )
            log.warning(
                "kv page migration %d->%d failed (the target "
                "recomputes; the moved prefix re-inserts at its next "
                "admission): %r", src, dst, e,
            )
            return 0
        dt = max(time.monotonic() - t0, 1e-9)
        n = int(meta["n_pages"])
        self._migrate_hist.observe(dt)
        if trace is not None:
            trace.span(
                "migrate", t0, t0 + dt,
                {"src": src, "dst": dst, "pages": n,
                 "bytes": len(blob)},
            )
        with self._lock:
            self._stats["kv_migrations"] += 1
            self._stats["kv_pages_migrated"] += n
            self._stats["kv_migrate_bytes"] += len(blob)
            self._migrate_skip_streak = 0
            self._migrate_n += 1
            self._migrate_page_bytes = len(blob) / max(n, 1)
            if self._migrate_n > 1:
                # The first sample carries the gather/scatter seams'
                # one-time set-up; steady-state transfer cost starts
                # at the second measurement.
                bps = len(blob) / dt
                self._migrate_bps = (
                    bps if self._migrate_bps is None
                    else 0.5 * self._migrate_bps + 0.5 * bps
                )
        log.info(
            "kv pages migrated %d->%d: %d pages, %d bytes, %.1f ms",
            src, dst, n, len(blob), dt * 1e3,
        )
        return n

    def _pick_prefill(self) -> Optional[int]:
        """Least-loaded UP prefill replica (the router's one load
        score), or None when the prefill role is dark."""
        if not self._roles:
            return None
        stats = {
            i: s
            for i, s in self._eligible_stats(set(), role=PREFILL).items()
            if self._roles[i] == PREFILL
        }
        if not stats:
            return None
        return min(
            stats, key=lambda r: (self.router.load_score(stats[r]), r)
        )

    # borrows-pages
    def _stage_prefix(self, route_row, target: int, staged: dict,
                      trace=None, ctx=None) -> None:
        """KV-cache-centric placement, the page-moving half: before a
        request lands on `target`, (a) FETCH the prefix from the
        replica that owns it when that beats recomputing
        (migrate-or-recompute), and (b) in a disaggregated fleet, run
        chunked prefill for a still-uncovered long prompt on a PREFILL
        replica and migrate the finished pages over — the decode
        replica then admits with a local prefix hit and resumes at the
        final sliver (the any-offset chunk-resume seam).  Pure
        optimization: every failure path falls through to the target
        recomputing, and greedy outputs are bit-identical either way
        (the parity gate's contract).  Tracing: the handoff submit
        carries `ctx`, so the PREFILL worker's queue/prefill spans
        join the same trace_id as the decode worker's — the
        cross-process trace the disaggregated path exists to need —
        and the router adds "prefill_handoff" / "migrate" spans."""
        page = self.router.page
        n_full = len(route_row) // page
        if n_full == 0:
            return
        owner, depth, tier = self.router.owner_tier_of(route_row)
        covered = depth if owner == target else 0
        if (
            owner is not None and owner != target
            and self._replica_usable(owner)
        ):
            # The owner may hold (part of) this prefix demoted
            # to host RAM or disk — raise it into the owner's HBM
            # trie first, so the export/adopt migration below carries
            # the full chain.
            depth = self._tier_fetch(owner, route_row, depth, tier,
                                     trace=trace)
        if (
            owner is not None and owner != target and depth > 0
            and self._replica_usable(owner)
            and self._should_migrate(depth)
        ):
            if self._migrate_prefix(
                owner, target, route_row[: depth * page], trace=trace
            ):
                covered = depth
        if (
            self._roles
            and not staged.get("handoff_done")
            and (n_full - covered) * page >= self._handoff_min_tokens
        ):
            # One handoff attempt per fleet.submit call: a re-routed
            # request does not pay (or re-fail) a second prefill.
            staged["handoff_done"] = True
            pidx = self._pick_prefill()
            if pidx is None or pidx == target:
                return
            t0 = time.monotonic()
            try:
                handle = self._replicas[pidx].engine.submit_nowait(
                    np.asarray(route_row, np.int32)[None], 1, 0.0,
                    trace_ctx=ctx,
                )
                handle.wait(timeout=self._handoff_timeout_s)
                if trace is not None:
                    trace.span(
                        "prefill_handoff", t0, time.monotonic(),
                        {"replica": pidx},
                    )
                    self._adopt_worker_spans(
                        pidx, handle, trace, ctx,
                        keep=("queue_wait", "prefill_chunk"),
                    )
                with self._lock:
                    self._stats["prefill_handoffs"] += 1
                self._migrate_prefix(
                    pidx, target, route_row[: n_full * page],
                    trace=trace,
                )
            except Exception as e:  # pylint: disable=broad-except
                # A dying prefill worker (kill -9 mid-handoff included:
                # the submit fails with WorkerLost) must never fail the
                # CLIENT's request — the decode replica recomputes.
                with self._lock:
                    self._stats["prefill_handoff_failures"] += 1
                if trace is not None:
                    trace.span(
                        "prefill_handoff", t0, time.monotonic(),
                        {"replica": pidx, "failed": True,
                         "error": type(e).__name__},
                    )
                log.warning(
                    "prefill handoff via replica %d failed (decode "
                    "replica %d recomputes): %r", pidx, target, e,
                )

    # -- fleet-wide distributed tracing -----------------------------------
    def set_tracing(self, enabled: bool) -> None:
        """Toggle trace assembly on a live fleet (interleaved on/off
        overhead pairs; a plain bool store —
        requests mid-flight finish under whichever mode they
        started)."""
        self._trace_enabled = bool(enabled)

    @property
    def tracing(self) -> bool:
        return self._trace_enabled

    def _adopt_worker_spans(self, rid: int, handle, trace, ctx,
                            keep=None) -> None:
        """Fold a resolved submit's engine-side spans into the
        assembled trace.  Process replicas shipped them on the
        terminal frame (handle.spans); in-process replicas are read
        straight from the engine's trace ring.  Best-effort and
        bounded: a worker that died resolves span-less (the caller
        stitches), and spans past MAX_TRACE_SPANS are counted, not
        kept.  `keep` restricts grafting to those span names — the
        prefill HANDOFF uses it to drop the prefill worker's 1-token
        "decode" span, an artifact of the max_new=1 handoff submit
        that would otherwise pollute decode-stage attribution AND
        defeat the partial-trace decode stitch (whose guard is "no
        decode span yet")."""
        spans = list(getattr(handle, "spans", None) or [])
        if not spans and ctx is not None:
            obs = getattr(self._replicas[rid].engine,
                          "observability", None)
            if obs is not None:
                try:
                    spans = obs.spans_for(ctx.trace_id)
                except Exception:  # pylint: disable=broad-except
                    spans = []
        dropped = 0
        for d in spans:
            if keep is not None and (
                not isinstance(d, dict) or d.get("name") not in keep
            ):
                continue
            if len(trace.spans) >= MAX_TRACE_SPANS:
                dropped += 1
                continue
            if trace.graft(d) is None:
                dropped += 1
        if dropped:
            trace.attrs["spans_dropped"] = (
                int(trace.attrs.get("spans_dropped", 0)) + dropped
            )

    def _seal_trace(self, trace, root, outcome, err=None,
                    streamed=None, rid=None) -> None:
        """Close the root span and seal the assembled trace into the
        bounded ring + tail digest.  A request whose worker died
        mid-flight seals a PARTIAL trace: no worker spans arrived, so
        the decode interval is STITCHED from the last streamed state
        (first/last token observed router-side) and marked as such —
        the trace ring must tell the disaggregated failure story,
        not just the happy path."""
        if trace is None:
            return
        now = time.monotonic()
        root.end = now
        trace.attrs["outcome"] = outcome
        if err is not None:
            trace.attrs["error"] = type(err).__name__
        if (
            streamed is not None and streamed["n"] > 0
            and not any(s.name == "decode" for s in trace.spans)
        ):
            trace.span(
                "decode", streamed["t_first"], streamed["t_last"],
                {"stitched": True, "delivered": streamed["n"],
                 "replica": rid if rid is not None else -1},
            )
        self.traces.append(trace)
        self.digest.add(trace)

    def tracez(self, limit: int = 32) -> dict:
        """The /tracez payload: recent assembled-trace summaries,
        per-stage p50/p95 attribution, and the slowest-decile full
        span trees (otel.tracez_payload)."""
        payload = otel.tracez_payload(
            self.traces.traces(), digest=self.digest, limit=limit,
        )
        payload["total"] = self.traces.total
        payload["enabled"] = self._trace_enabled
        return payload

    def _register(self, idx: int, handle) -> None:
        with self._lock:
            self._outstanding[idx].add(handle)

    def _unregister(self, idx: int, handle) -> None:
        with self._lock:
            self._outstanding[idx].discard(handle)

    # Every raise this surface can reach must be a type exc_to_wire
    # round-trips by kind.
    def submit(
        self,
        prompt,
        max_new: int,
        temperature: float = 0.0,
        top_k=None,
        top_p=None,
        stop_token: Optional[int] = None,
        timeout: Optional[float] = None,
        on_token: Optional[Callable[[int, int], None]] = None,
        trace_ctx=None,
    ) -> List[list]:
        """Blocking fleet submit: route, place, wait — re-routing on
        replica loss per the module-docstring contract.  Same request
        surface as engine.submit (the server's gen() seam swaps in
        unchanged).  Raises QueueFullError only when EVERY eligible
        replica sheds the request (fleet-wide saturation -> one 429);
        per-request failures propagate from the replica that owns
        them.

        Tracing: the ROOT span opens here, under the caller's
        `trace_ctx` (the server mints one per /generate and returns
        its trace_id) or a fleet-minted one; placement, staging, and
        re-route decisions become child spans, the chosen replica's
        engine spans ship back and are adopted, and the assembled
        trace — partial on a mid-flight worker death — seals into
        `self.traces` + the tail digest that /tracez serves."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        route_row = prompt[0] if prompt.size else prompt.reshape(-1)
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        # Streamed-state staging for the partial-trace stitch: token
        # count plus first/last commit stamps observed router-side.
        streamed = {"n": 0, "t_first": 0.0, "t_last": 0.0}

        def counting_on_token(row, tok):
            now = time.monotonic()
            if streamed["n"] == 0:
                streamed["t_first"] = now
            streamed["n"] += 1
            streamed["t_last"] = now
            if on_token is not None:
                on_token(row, tok)

        with self._lock:
            if self._closed:
                # A declared wire type: a closed fleet is
                # permanent unavailability, not an opaque runtime
                # error — remote callers keep their classification.
                raise ReplicaUnavailable(-1, "fleet is closed")
            self._stats["submitted"] += 1
        trace = root = ctx = None
        if self._trace_enabled:
            trace = otel.Trace(
                trace_id=(
                    trace_ctx.trace_id if trace_ctx is not None
                    else None
                ),
                attrs={"rows": int(prompt.shape[0]),
                       "plen": int(prompt.shape[1]),
                       "max_new": int(max_new)},
                process="router",
                parent_span_id=(
                    trace_ctx.parent_span_id
                    if trace_ctx is not None else ""
                ),
            )
            root = trace.span("request", time.monotonic())
            ctx = otel.TraceContext(trace.trace_id, root.span_id)
        tried: set = set()
        last_shed = None
        staged: dict = {}
        # Disaggregated fleet: client requests PLACE on decode
        # replicas (prefill replicas receive only handoff work);
        # _eligible_stats falls back fleet-wide when the decode role
        # is dark.
        place_role = DECODE if self._roles else None
        while True:
            try:
                rid, _reason = self._route(
                    route_row, self._eligible_stats(tried, place_role),
                    trace=trace,
                )
            except NoReplicasError as e:
                if last_shed is not None:
                    self._seal_trace(trace, root, "failed",
                                     err=last_shed)
                    raise last_shed
                if tried and (
                    deadline is None or time.monotonic() < deadline
                ):
                    # Every remaining replica was just tried — e.g.
                    # the ONLY replica's queue was re-homed around a
                    # supervisor restart.  Forget the exclusions and
                    # retry: landing back on the revived replica (or
                    # a recovered sibling) beats failing a request a
                    # plain single-engine supervisor would have
                    # preserved.  If no replica is up at all, the
                    # next iteration raises with `tried` empty.
                    tried.clear()
                    time.sleep(0.05)
                    continue
                self._seal_trace(trace, root, "failed", err=e)
                raise
            rep = self._replicas[rid]
            if self._migrate:
                # Move the prompt's KV pages to the chosen replica
                # BEFORE it admits (fetch-or-handoff; contained — a
                # staging failure just means local recompute).
                try:
                    self._stage_prefix(route_row, rid, staged,
                                       trace=trace, ctx=ctx)
                except Exception:  # pylint: disable=broad-except
                    log.exception(
                        "page staging for replica %d failed; it "
                        "recomputes", rid,
                    )
            try:
                handle = rep.engine.submit_nowait(
                    prompt, max_new, temperature, top_k=top_k,
                    top_p=top_p, stop_token=stop_token,
                    on_token=counting_on_token,
                    trace_ctx=ctx,
                )
            except QueueFullError as e:
                # This replica is saturated; spill to a sibling.  Only
                # when every eligible replica shed does the caller see
                # the 429 — fleet backpressure is the UNION of queues.
                tried.add(rid)
                last_shed = e
                with self._lock:
                    self._stats["spills"] += 1
                continue
            except RuntimeError as e:
                # The replica died/closed between placement and
                # submit: treat exactly like a terminal wait failure.
                if self._replica_down(rid):
                    tried.add(rid)
                    with self._lock:
                        self._stats["rerouted"] += 1
                    if trace is not None:
                        now = time.monotonic()
                        trace.span(
                            "reroute", now, now,
                            {"replica": rid, "at": "submit"},
                        )
                    continue
                self._seal_trace(trace, root, "failed", err=e)
                raise
            self._register(rid, handle)
            # Close the placement/drain race: a drain (or eviction)
            # that snapshotted _outstanding before this _register
            # could not see the handle to yank it — re-check the
            # state now that the handle is visible and withdraw if
            # the replica stopped taking placements meanwhile (the
            # waiter re-routes on the ReplicaUnavailable).  A row the
            # engine already admitted stays: in-flight work finishes.
            with self._lock:
                still_up = self._replicas[rid].state == UP
            if not still_up:
                handle.cancel_if_queued(
                    ReplicaUnavailable(rid, "drained during placement")
                )
            # Warm the affinity index at placement (not completion):
            # a follower sharing the prefix should chase this replica
            # while the first request is still prefilling — that is
            # when the shared pages are being built.
            self.router.record(route_row, rid)
            try:
                remaining = (
                    None if deadline is None
                    else max(0.0, deadline - time.monotonic())
                )
                results = handle.wait(timeout=remaining)
            except Exception as e:  # pylint: disable=broad-except
                ticket_failed = handle.error is e
                reroutable = (
                    on_token is None or streamed["n"] == 0
                )
                # A StepFailure ticket error IS a replica loss by
                # construction (the only path that fails tickets with
                # it also crashes the scheduler) — checking it
                # directly closes the race where the waiter wakes
                # from _fail_active_rows BEFORE the crashing thread
                # publishes _crashed.
                replica_loss = isinstance(e, ReplicaUnavailable) or (
                    ticket_failed and (
                        isinstance(e, StepFailure)
                        or self._replica_down(rid)
                    )
                )
                if (
                    replica_loss
                    and reroutable
                    and (deadline is None
                         or time.monotonic() < deadline)
                ):
                    tried.add(rid)
                    with self._lock:
                        self._stats["rerouted"] += 1
                    if trace is not None:
                        now = time.monotonic()
                        trace.span(
                            "reroute", now, now,
                            {"replica": rid, "at": "wait",
                             "error": type(e).__name__},
                        )
                    continue
                # Terminal failure: seal what the router knows.  A
                # replica loss that streamed tokens seals a PARTIAL
                # trace — the victim's spans died with it, so the
                # decode interval is stitched from the last streamed
                # state (_seal_trace).
                if trace is not None:
                    self._adopt_worker_spans(rid, handle, trace, ctx)
                    self._seal_trace(
                        trace, root,
                        "partial" if (
                            replica_loss and streamed["n"] > 0
                        ) else "failed",
                        err=e, streamed=streamed, rid=rid,
                    )
                raise
            finally:
                self._unregister(rid, handle)
            with self._lock:
                self._stats["completed"] += 1
            if trace is not None:
                self._adopt_worker_spans(rid, handle, trace, ctx)
                trace.attrs["tokens"] = sum(
                    len(r or []) for r in results
                )
                self._seal_trace(trace, root, "ok", rid=rid)
            return results

    # -- metrics ----------------------------------------------------------
    def _collect(self):
        """Collect-time callback on the fleet registry: fleet/router
        counters, replica-state gauges, and every replica's OWN
        registry relabelled with engine="<i>" — per-replica
        containment (one broken replica loses only its families for
        the scrape, same rule as plugin/metrics.py)."""
        with self._lock:
            states = [r.state for r in self._replicas]
            stats = dict(self._stats)
        yield observe_mod.MetricSnapshot(
            "fleet_replica_state", "gauge",
            "Replica lifecycle (1 on the current state)",
            [
                ({"engine": str(i), "state": s},
                 1.0 if states[i] == s else 0.0)
                for i in range(len(states))
                for s in (UP, DRAINING, DEAD)
            ],
        )
        yield observe_mod.MetricSnapshot(
            "fleet_replicas_up", "gauge",
            "Replicas currently accepting placements",
            [({}, float(sum(1 for s in states if s == UP)))],
        )
        for key, val in sorted(stats.items()):
            yield observe_mod.MetricSnapshot(
                f"fleet_{key}_total", "counter",
                f"Fleet counter {key} (serving/fleet.py)",
                [({}, float(val))],
            )
        for key, val in sorted(self.router.stats().items()):
            kind = (
                "gauge" if key in ("index_pages", "ring_members")
                else "counter"
            )
            name = (
                f"fleet_router_{key}" if kind == "gauge"
                else f"fleet_router_{key}_total"
            )
            yield observe_mod.MetricSnapshot(
                name, kind,
                f"Router {key} (serving/router.py)",
                [({}, float(val))],
            )
        per_engine = []
        for rep in self._replicas:
            # Scraper self-observability: time + count every replica
            # scrape on the router's own registry.  The samples land
            # on the NEXT scrape (this collect already snapshotted
            # the live metrics) — an acceptable one-scrape lag for a
            # signal that is about trends, not point reads.
            t0 = time.monotonic()
            try:
                per_engine.extend(observe_mod.relabel_snapshots(
                    self._replica_metric_snapshots(rep),
                    engine=rep.idx,
                ))
                self._scrape_hist.observe(
                    time.monotonic() - t0, str(rep.idx)
                )
            except Exception as e:  # pylint: disable=broad-except
                self._scrape_hist.observe(
                    time.monotonic() - t0, str(rep.idx)
                )
                self._scrape_failures.inc(1.0, str(rep.idx))
                log.warning(
                    "fleet metrics: replica %d collect failed (its "
                    "families drop this scrape): %r", rep.idx, e,
                )
        for snap in observe_mod.merge_snapshots(per_engine):
            yield snap

    def _replica_metric_snapshots(self, rep):
        """One replica's raw (unlabelled) metric families — its
        private registry, or the numeric snapshot() fields as gauges
        for an uninstrumented engine.  ProcessFleetManager overrides
        this with the worker SCRAPE (rpc metrics op): the router
        relabels either way, the paper's kubelet-scrapes-plugin
        shape."""
        obs = rep.engine.observability
        if getattr(obs, "enabled", False):
            return obs.registry.collect()
        return observe_mod.snapshot_gauges(rep.engine.snapshot())

    def gauge_provider(self) -> Callable[[], dict]:
        """Flat per-replica gauges for plugin/metrics.py
        register_external_provider (full families ride
        attach_external_registry on `self.registry` instead)."""

        def provide() -> dict:
            out = {}
            with self._lock:
                states = [r.state for r in self._replicas]
            out["fleet_replicas_up"] = float(
                sum(1 for s in states if s == UP)
            )
            for rep in self._replicas:
                snap = rep.engine.snapshot()
                i = rep.idx
                out[f"fleet_engine{i}_queue_depth"] = float(
                    snap["queue_depth"]
                )
                out[f"fleet_engine{i}_active_rows"] = float(
                    snap["active_rows"]
                )
                if "kv_pages_in_use" in snap:
                    out[f"fleet_engine{i}_kv_pages_in_use"] = float(
                        snap["kv_pages_in_use"]
                    )
            return out

        return provide

    # -- teardown ---------------------------------------------------------
    def close(self) -> None:
        """Stop health watches, supervisors, and engines (embedders:
        tests, chip_smoke.py; an IN-PROCESS serving process never
        calls it —
        but a PROCESS fleet must, or the workers outlive the router:
        the server's SIGTERM drain closes a ProcessFleetManager)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for rep in self._replicas:
            self._stop_health_watch(rep)
        for rep in self._replicas:
            try:
                rep.supervisor.stop()
            except Exception:  # pylint: disable=broad-except
                log.exception(
                    "supervisor stop failed (replica %d)", rep.idx
                )
        for rep in self._replicas:
            try:
                rep.engine.close()
            except Exception:  # pylint: disable=broad-except
                log.exception(
                    "engine close failed (replica %d)", rep.idx
                )


class ProcessFleetManager(FleetManager):
    """The process-isolated fleet: same router, same drain/evict/re-route machinery, same
    relabelled one-scrape metrics as FleetManager — but each replica
    is an engine-worker PROCESS (serving/worker.py) behind the
    serving/rpc.py socket seam instead of an in-process engine.

    What that buys (the source paper's device-plugin/broker split,
    applied to serving):

      - N interpreters, N GILs: the scheduler threads stop
        contending on one interpreter lock (on a card, each worker
        also has its own CUDA context);
      - a REAL blast radius boundary: kill -9 a worker and the router,
        the siblings, and their in-flight work are untouched — the
        supervisor respawns the process (spawn + handshake + readiness
        gate) under the same restart budget that revives a crashed
        scheduler thread, and the victim's queued tickets re-home
        through the unchanged fleet re-route path;
      - workers keep PRIVATE /metrics-shaped registries the router
        SCRAPES over the rpc seam and relabels with engine="<i>"
        (observe.relabel_snapshots) — kubelet-scrapes-plugin, end to
        end.

    The model is named by a FACTORY SPEC + kwargs (worker.py module
    docstring) so each worker rebuilds weights itself, on the device
    the factory's kwargs name (`submeshes` raises ValueError: each
    worker owns its own device view).  The
    in-process FleetManager stays the default-off parity control:
    everything above `_build_replicas` is shared code."""

    def __init__(
        self,
        factory: str,
        factory_kw: Optional[dict],
        n_replicas: int,
        n_slots: int,
        *,
        engine_kw: Optional[dict] = None,
        affinity: bool = True,
        roles: Optional[Sequence[str]] = None,
        migrate: bool = False,
        migrate_kw: Optional[dict] = None,
        router_kw: Optional[dict] = None,
        health_critical=None,
        max_restarts: int = 3,
        restart_window_s: float = 60.0,
        restart_backoff_s: float = 0.2,
        on_all_dead: Optional[Callable[[BaseException], None]] = None,
        registry=None,
        trace: bool = True,
        trace_capacity: int = 256,
        spawn_timeout_s: float = 300.0,
        drain_timeout_s: float = 15.0,
        worker_max_restarts: int = 3,
        stats_ttl_s: float = 0.05,
        socket_dir: Optional[str] = None,
        worker_env: Optional[dict] = None,
        transport: str = "unix",
        tcp_host: str = "127.0.0.1",
        connect_via: Optional[Callable[[int, str], str]] = None,
        heartbeat_s: float = 5.0,
        heartbeat_timeout_s: float = 15.0,
        io_timeout_s: float = 30.0,
        reconnect_budget_s: float = 10.0,
        reconnect_backoff_s: float = 0.1,
        reconnect_backoff_cap_s: float = 2.0,
        flap_threshold: int = 3,
        flap_window_s: float = 30.0,
        quarantine_probe_s: float = 0.5,
        quarantine_rejoin_probes: int = 3,
        submeshes: Optional[Sequence] = None,
    ):
        if submeshes is not None:
            raise ValueError(
                "submeshes do not apply to a process fleet: each "
                "worker owns its own runtime's device view"
            )
        # Worker spawn config must exist before super().__init__
        # reaches _build_replicas.
        if transport not in ("unix", "tcp"):
            raise ValueError(
                f"transport must be 'unix' or 'tcp', got {transport!r}"
            )
        self._factory = factory
        self._factory_kw = dict(factory_kw or {})
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._worker_max_restarts = int(worker_max_restarts)
        self._stats_ttl_s = float(stats_ttl_s)
        self._worker_env = dict(worker_env or {})
        # Transport: "unix" (default parity control) binds one UDS
        # per worker under the socket dir; "tcp" binds 127.0.0.1
        # ephemeral ports (cross-host fleets pass explicit specs).
        # `connect_via` maps (idx, bind_spec) -> the spec the ROUTER
        # dials — the seam a fault proxy (faults.NetemProxy) or a
        # real load balancer plugs into.
        self._transport = transport
        self._tcp_host = tcp_host
        self._connect_via = connect_via
        self._net_kw = dict(
            heartbeat_s=float(heartbeat_s),
            heartbeat_timeout_s=float(heartbeat_timeout_s),
            io_timeout_s=float(io_timeout_s),
            reconnect_budget_s=float(reconnect_budget_s),
            reconnect_backoff_s=float(reconnect_backoff_s),
            reconnect_backoff_cap_s=float(reconnect_backoff_cap_s),
        )
        # Flap quarantine: a replica whose connection drops
        # flap_threshold times within flap_window_s is DRAINED (no
        # placements) and only rejoins after quarantine_rejoin_probes
        # consecutive successful pings — the existing health-drain
        # machinery is the membership path, the probe loop is the
        # gate.  flap_threshold 0 disables.
        self._flap_threshold = int(flap_threshold)
        self._flap_window_s = float(flap_window_s)
        self._quarantine_probe_s = float(quarantine_probe_s)
        self._quarantine_rejoin_probes = int(quarantine_rejoin_probes)
        self._flaps: Dict[int, collections.deque] = {}  # guarded-by: _lock
        self._quarantined: set = set()  # guarded-by: _lock
        self._quarantine_stop = threading.Event()
        self._quarantine_thread: Optional[threading.Thread] = None
        self._own_sock_dir = socket_dir is None
        self._sock_dir = socket_dir or tempfile.mkdtemp(
            prefix="cb-fleet-"
        )
        try:
            super().__init__(
                None, n_replicas, n_slots,
                engine_kw=engine_kw, affinity=affinity,
                roles=roles, migrate=migrate, migrate_kw=migrate_kw,
                router_kw=router_kw, health_critical=health_critical,
                max_restarts=max_restarts,
                restart_window_s=restart_window_s,
                restart_backoff_s=restart_backoff_s,
                on_all_dead=on_all_dead, registry=registry,
                trace=trace, trace_capacity=trace_capacity,
            )
        except BaseException:
            # Failed boot (handshake timeout, exploding factory):
            # close() is never reached on a half-built object, so the
            # mkdtemp'd socket dir must be reclaimed here.
            if self._own_sock_dir:
                shutil.rmtree(self._sock_dir, ignore_errors=True)
            raise
        if self._flap_threshold > 0:
            self._quarantine_thread = threading.Thread(
                target=self._quarantine_loop,
                name="fleet-quarantine", daemon=True,
            )
            self._quarantine_thread.start()

    def _build_replicas(self, model, n_replicas, n_slots, kw, devices,
                        submeshes, base_seed, max_restarts,
                        restart_window_s, restart_backoff_s) -> None:
        del model, devices, submeshes  # workers rebuild from the spec
        if "device" in kw:
            # --engine-json is JSON: a torch.device travels as its name.
            kw = dict(kw, device=str(kw["device"]))
        # Router-side frame-size histogram (the worker keeps its own
        # "rpc_frame_bytes" on the scraped private registry; this one
        # prices the router's half of every connection, page streams
        # included).
        frame_hist = self.registry.histogram(
            "fleet_rpc_frame_bytes",
            "Wire frame sizes on the router side of every worker "
            "connection (serving/rpc.py; streamed blobs count per "
            "chunk frame)",
            rpc_mod.FRAME_SIZE_BUCKETS,
        )
        engines: List[rpc_mod.RemoteEngine] = []
        try:
            # Two-phase boot: launch EVERY worker first so their torch
            # imports, model builds and kernel loads overlap, then gate readiness
            # one by one — N x spawn cost collapses toward 1 x.
            for i in range(n_replicas):
                if self._transport == "tcp":
                    bind = "%s:%d" % (
                        self._tcp_host,
                        rpc_mod.free_tcp_port(self._tcp_host),
                    )
                else:
                    bind = os.path.join(
                        self._sock_dir, f"worker-{i}.sock"
                    )
                connect = bind
                if self._connect_via is not None:
                    connect = str(self._connect_via(i, bind))
                eng = rpc_mod.RemoteEngine(
                    self._factory, self._factory_kw, n_slots,
                    engine_kw=dict(kw, rng_seed=base_seed + i),
                    socket_path=bind,
                    connect_to=connect,
                    idx=i,
                    worker_max_restarts=self._worker_max_restarts,
                    spawn_timeout_s=self._spawn_timeout_s,
                    drain_timeout_s=self._drain_timeout_s,
                    stats_ttl_s=self._stats_ttl_s,
                    env=self._worker_env,
                    on_frame=frame_hist.observe,
                    on_net=lambda ev, why, idx=i: self._net_event(
                        idx, ev, why
                    ),
                    **self._net_kw,
                )
                eng.launch()
                engines.append(eng)
            for eng in engines:
                eng.handshake()
        except BaseException:
            # Boot fails fast AND clean: every already-launched worker
            # is torn down and reaped before the error propagates.
            for eng in engines:
                try:
                    eng.close()
                except Exception:  # pylint: disable=broad-except
                    pass
            raise
        for i, eng in enumerate(engines):
            sup = self._supervise(
                i, eng, max_restarts, restart_window_s,
                restart_backoff_s,
            )
            self._replicas.append(FleetReplica(i, eng, sup))

    def _net_event(self, idx: int, event: str, why: str) -> None:
        """RemoteEngine network-event hook (reconnect machinery).

        Counts disconnect/reconnected/gave_up into the fleet stats
        and applies the flap rule: too many disconnects inside the
        window quarantines the replica through the health-drain path.
        """
        quarantine = False
        with self._lock:
            if self._closed:
                return
            if event == "disconnect":
                self._stats["net_disconnects"] += 1
                if self._flap_threshold > 0:
                    dq = self._flaps.setdefault(
                        idx, collections.deque()
                    )
                    now = time.monotonic()
                    dq.append(now)
                    while dq and now - dq[0] > self._flap_window_s:
                        dq.popleft()
                    if (len(dq) >= self._flap_threshold
                            and idx not in self._quarantined):
                        self._quarantined.add(idx)
                        self._stats["net_quarantines"] += 1
                        quarantine = True
            elif event == "reconnected":
                self._stats["net_reconnects"] += 1
            elif event == "gave_up":
                self._stats["net_giveups"] += 1
        if quarantine:
            log.warning(
                "fleet: replica %d flapping (%d disconnects in "
                "%.0fs); quarantined pending stable probes",
                idx, self._flap_threshold, self._flap_window_s,
            )
            # _drain takes _lock itself — must be called outside it.
            self._drain(idx, "flapping connection; quarantined")

    def _quarantine_loop(self) -> None:
        """Probe quarantined replicas; rejoin after a streak of
        clean pings (via the health-drain machinery, so an unrelated
        concurrent health drain still blocks placements)."""
        streaks: Dict[int, int] = {}
        while not self._quarantine_stop.wait(self._quarantine_probe_s):
            with self._lock:
                if self._closed:
                    return
                targets = sorted(self._quarantined)
            for i in targets:
                rep = self._replicas[i]
                if rep.state == DEAD:
                    with self._lock:
                        self._quarantined.discard(i)
                    streaks.pop(i, None)
                    continue
                ok = rep.engine.ping(timeout=2.0)
                if not ok:
                    streaks[i] = 0
                    continue
                streaks[i] = streaks.get(i, 0) + 1
                if streaks[i] < self._quarantine_rejoin_probes:
                    continue
                streaks.pop(i, None)
                with self._lock:
                    self._quarantined.discard(i)
                    self._stats["net_rejoins"] += 1
                    self._flaps.pop(i, None)
                    blocked = bool(rep.unhealthy)
                log.info(
                    "fleet: replica %d stable for %d probes; "
                    "rejoining%s", i, self._quarantine_rejoin_probes,
                    " (still health-drained)" if blocked else "",
                )
                if not blocked:
                    self._undrain(i)

    def _replica_metric_snapshots(self, rep):
        """The worker SCRAPE: its private registry over the rpc
        metrics op (reconstructed MetricSnapshots; the base class
        relabels with engine="<i>" and merges families)."""
        return rep.engine.metrics_snapshots()

    def worker_pids(self) -> List[Optional[int]]:
        """Live worker pids (None for a replica mid-respawn) — the
        chaos tests' kill -9 target list."""
        return [r.engine.pid for r in self._replicas]

    def close(self) -> None:
        self._quarantine_stop.set()
        super().close()
        if self._quarantine_thread is not None:
            self._quarantine_thread.join(timeout=5.0)
        if self._own_sock_dir:
            shutil.rmtree(self._sock_dir, ignore_errors=True)
