"""Fleet router: load-aware, prefix-affine, health-gated placement.

The port's own copy of container_engine_accelerators_tpu/serving/
router.py (numpy and the stdlib only, same behaviour): `_token_key`
hashes the same int64 bytes, so both packages place the same request
on the same replica.

This is the serving-side analog of the source paper's cluster
scheduler consuming the node broker's streams: below, each replica
(serving/fleet.py) runs its own iteration-level scheduler
(ContinuousBatchingEngine); above, this router decides WHICH replica
each admission goes to, from three signals:

  1. LOAD — live per-engine stats (queue depth, active rows, KV pool
     occupancy) read from each engine's own snapshot() at placement
     time.  No second set of books: the router never counts what the
     engines already count.
  2. PREFIX AFFINITY — a router-side radix index over prompt prefixes
     (page-granular, mirroring serving/prefix_cache.py's edge width)
     remembers which replica served each prefix, so shared-prefix
     requests land on the replica whose radix prefix cache already
     holds the pages.  Spraying a shared prefix across N replicas
     costs N cold prefills and N retained copies; steering it to one
     replica pays a single prefill and every follower hits.  The
     index is a HINT, bounded and LRU-evicted — correctness never
     depends on it.
  3. CONSISTENT HASH — cold prefixes fall back to a consistent-hash
     ring (virtual nodes) keyed on the prompt's first page, so
     placement is deterministic, balanced across replicas, and stable
     under membership change: evicting a replica moves ONLY the keys
     it owned (its arc redistributes among survivors), never a global
     reshuffle that would cold every replica's prefix cache at once.

A load gate sits above both steering signals: a target whose queue
depth crosses `spill_queue_depth` while a strictly less-loaded
eligible replica exists is overridden to the least-loaded candidate
(counted as a load spill) — affinity must not pile a hot prefix onto
a replica that is drowning while siblings idle.

Membership is HEALTH-GATED by the fleet: the router only ever sees
the currently-eligible replica set per placement (draining and dead
replicas are excluded by the caller); `remove()` drops an evicted
replica from the ring and prunes its affinity entries so no future
placement can name it.

Threading: placements come from many fleet submit threads, membership
changes from health-watch and supervisor threads — all shared state
rides the router's own lock (the same discipline as the engine).  place() is deterministic given
(prompt, stats, membership): no RNG, ties break by replica id.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from .errors import ReplicaUnavailable

__all__ = [
    "ConsistentHashRing",
    "NoReplicasError",
    "PrefixAffinityIndex",
    "Router",
]


class NoReplicasError(ReplicaUnavailable):
    """place() had no eligible replica (all draining/dead/excluded) —
    the fleet surfaces this as unavailability, not a request bug.
    Subclassing ReplicaUnavailable makes that literal: the
    type crosses the RPC wire as kind="replica_unavailable"
    (replica=-1, "no specific replica") instead of degrading to an
    opaque runtime error that the router cannot re-route on."""

    def __init__(self, why: str = "no eligible replica"):
        super().__init__(-1, why)


def _hash64(data: bytes) -> int:
    # sha1 over raw bytes: stable across processes and runs (unlike
    # hash(), which PYTHONHASHSEED salts) — placement must be
    # reproducible for A/B runs and the determinism tests.
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


def _token_key(tokens) -> bytes:
    """Deterministic hash key over the WHOLE prompt.  Hashing the full
    token row (not a prefix) is what makes the ring a true control
    for the affinity index: requests sharing a system prompt but
    differing in their tails spread across the ring like any other
    distinct requests — prefix locality is exactly the signal only
    the affinity index is allowed to exploit."""
    return np.asarray(tokens, np.int64).tobytes()


class ConsistentHashRing:
    """Consistent hashing with virtual nodes over integer replica ids.

    Each member owns `vnodes` points on a 64-bit ring; lookup(key)
    walks clockwise from the key's hash to the first point whose
    replica is in the caller's eligible set.  Removing a member
    redistributes only its arcs — the property that keeps surviving
    replicas' prefix caches warm through an eviction."""

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self._vnodes = int(vnodes)
        self._lock = threading.Lock()
        self._points: List[Tuple[int, int]] = []  # guarded-by: _lock
        self._members: set = set()  # guarded-by: _lock

    def add(self, replica_id: int) -> None:
        rid = int(replica_id)
        with self._lock:
            if rid in self._members:
                return
            self._members.add(rid)
            for v in range(self._vnodes):
                h = _hash64(f"replica-{rid}:vnode-{v}".encode())
                bisect.insort(self._points, (h, rid))

    def remove(self, replica_id: int) -> None:
        rid = int(replica_id)
        with self._lock:
            if rid not in self._members:
                return
            self._members.discard(rid)
            self._points = [p for p in self._points if p[1] != rid]

    def members(self) -> List[int]:
        with self._lock:
            return sorted(self._members)

    def lookup(self, key: bytes,
               eligible: Optional[Iterable[int]] = None) -> Optional[int]:
        """First ring point clockwise of hash(key) whose replica is in
        `eligible` (default: every member).  None when nothing is
        eligible."""
        want = (
            None if eligible is None else {int(r) for r in eligible}
        )
        h = _hash64(key)
        with self._lock:
            points = self._points
            if not points:
                return None
            start = bisect.bisect_right(points, (h, -1))
            n = len(points)
            for i in range(n):
                rid = points[(start + i) % n][1]
                if want is None or rid in want:
                    return rid
        return None


class _IxNode:
    __slots__ = (
        "key", "replica", "tier", "children", "parent", "last_use",
    )

    def __init__(self, key, replica, parent):
        self.key = key          # page-width token tuple (edge label)
        self.replica = replica  # replica id that served this prefix
        self.tier = "hbm"       # where the owner holds it:
                                # "hbm" (radix trie), "host", "disk"
        self.children: Dict[tuple, "_IxNode"] = {}
        self.parent = parent
        self.last_use = 0


class PrefixAffinityIndex:
    """Page-granular radix index: prompt prefix -> replica id.

    Same trie shape as serving/prefix_cache.py (one full page of
    tokens per edge) so a router hit predicts an engine-cache hit:
    the replica recorded here retained exactly these pages in its
    radix prefix cache when it served the prompt.  Bounded at
    `max_pages` nodes with LRU leaf eviction — this is a steering
    hint, not a cache; dropping an entry costs one consistent-hash
    fallback, never correctness."""

    def __init__(self, page_size: int, max_pages: int = 4096):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {max_pages}")
        self.page = int(page_size)
        self.max_pages = int(max_pages)
        self._lock = threading.Lock()
        self._root = _IxNode(None, -1, None)  # guarded-by: _lock
        self._n = 0  # guarded-by: _lock
        self._tick = 0  # guarded-by: _lock

    def match(self, tokens) -> Tuple[Optional[int], int]:
        """Walk the trie over `tokens`' full pages; returns (replica
        id of the DEEPEST matched node, pages matched) or (None, 0).
        The deepest node wins: the most specific prefix owner is the
        replica whose cache holds the most of this prompt."""
        toks = [int(t) for t in tokens]
        with self._lock:
            self._tick += 1
            node = self._root
            depth = 0
            best = None
            off = 0
            while off + self.page <= len(toks):
                child = node.children.get(
                    tuple(toks[off:off + self.page])
                )
                if child is None:
                    break
                child.last_use = self._tick
                best = child.replica
                node = child
                depth += 1
                off += self.page
            return best, depth

    def match_tier(self, tokens) -> Tuple[Optional[int], int, str]:
        """match() extended with the tier hint: (replica id, pages
        matched, tier of the DEEPEST matched node) — "which replica
        *and tier* holds it".  ("hbm" when nothing is recorded: an
        absent hint must read as the cheap case, never steer a fetch
        toward a tier that does not exist.)"""
        toks = [int(t) for t in tokens]
        with self._lock:
            self._tick += 1
            node = self._root
            depth = 0
            best = None
            tier = "hbm"
            off = 0
            while off + self.page <= len(toks):
                child = node.children.get(
                    tuple(toks[off:off + self.page])
                )
                if child is None:
                    break
                child.last_use = self._tick
                best = child.replica
                tier = child.tier
                node = child
                depth += 1
                off += self.page
            return best, depth, tier

    def record(self, tokens, replica_id: int,
               tier: str = "hbm") -> int:
        """Remember that `replica_id` served this prompt: create or
        re-own the node path over the prompt's full pages.  `tier`
        records WHERE the owner holds the prefix right now —
        "hbm" on a fresh serve, "host"/"disk" when a probe found it
        demoted — so the fetch-vs-recompute choice can price the
        load.  Returns nodes touched.  Over `max_pages`, LRU leaves
        off the current path are evicted first."""
        toks = [int(t) for t in tokens]
        rid = int(replica_id)
        n_full = len(toks) // self.page
        if n_full == 0:
            return 0
        with self._lock:
            self._tick += 1
            node = self._root
            path = set()
            for i in range(n_full):
                key = tuple(toks[i * self.page:(i + 1) * self.page])
                child = node.children.get(key)
                if child is None:
                    child = _IxNode(key, rid, node)
                    node.children[key] = child
                    self._n += 1
                else:
                    # Re-owning on every record keeps the hint fresh:
                    # after an eviction re-routes a prefix, followers
                    # chase the NEW owner, not the ghost.
                    child.replica = rid
                child.tier = str(tier)
                child.last_use = self._tick
                path.add(id(child))
                node = child
            while self._n > self.max_pages:
                if not self._evict_lru_leaves(
                    path, self._n - self.max_pages
                ):
                    break
        return n_full

    # holds-lock: _lock
    def _evict_lru_leaves(self, keep: set, deficit: int) -> int:
        """Collect leaves in ONE traversal and evict up to `deficit`
        of them LRU-first (skipping the just-recorded path) — not one
        full-trie DFS per page, which would stall every placement
        against a large index (the same batching prefix_cache.py's
        evict_until uses).  A later round picks up parents the batch
        turned into leaves."""
        leaves = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif id(n) not in keep:
                leaves.append(n)
        leaves.sort(key=lambda n: n.last_use)
        evicted = 0
        for victim in leaves[:deficit]:
            del victim.parent.children[victim.key]
            self._n -= 1
            evicted += 1
        return evicted

    def drop_replica(self, replica_id: int) -> int:
        """Prune every subtree owned by `replica_id` (an evicted
        replica's cache is gone; steering anything toward it — or
        toward descendants recorded under it — would be a guaranteed
        cold miss on whoever inherits).  Returns nodes dropped."""
        rid = int(replica_id)
        dropped = 0
        with self._lock:
            stack = [self._root]
            while stack:
                node = stack.pop()
                for key in [
                    k for k, c in node.children.items()
                    if c.replica == rid
                ]:
                    dropped += self._drop_subtree(node.children.pop(key))
                stack.extend(node.children.values())
        return dropped

    def _drop_subtree(self, node) -> int:  # holds-lock: _lock
        n = 1
        stack = list(node.children.values())
        while stack:
            child = stack.pop()
            n += 1
            stack.extend(child.children.values())
        self._n -= n
        return n

    def page_count(self) -> int:
        with self._lock:
            return self._n


class Router:
    """Placement policy over live replica stats (module docstring).

    place() inputs per call: the prompt's token row, and a mapping
    {replica id: stats dict} for the replicas eligible RIGHT NOW
    (the fleet passes only UP replicas, minus the caller's excludes).
    Stats keys consumed: "queue_depth", "active_rows", "slots", and —
    paged engines — "kv_pages_in_use"/"kv_pages_total".  Returns
    (replica id, reason) with reason in {"affinity", "hash", "load"}.

    affinity=False disables the prefix index entirely (every cold and
    warm placement goes through the hash ring) — the control arm an
    affinity A/B measures against.

    spill_queue_depth: the load gate — an affinity/hash target with
    this many queued rows spills to the least-loaded candidate when
    one is strictly less loaded (None: 2x the replica's slot count,
    read from its stats)."""

    def __init__(
        self,
        page_size: int = 64,
        *,
        affinity: bool = True,
        track: bool = False,
        vnodes: int = 64,
        max_index_pages: int = 4096,
        spill_queue_depth: Optional[int] = None,
        kv_weight: float = 4.0,
    ):
        self.page = int(page_size)
        self.affinity_enabled = bool(affinity)
        # track=True keeps the affinity index RECORDING (and
        # owner_of() answering) even when affinity STEERING is off —
        # the KV-cache-centric fleet needs to know which replica owns
        # a prefix in order to FETCH it (page migration), whether or
        # not placement is allowed to chase it.  The hash-control arm
        # with migration on is exactly this combination.
        self.track_enabled = bool(track)
        self.ring = ConsistentHashRing(vnodes=vnodes)
        self.index = PrefixAffinityIndex(
            self.page, max_pages=max_index_pages
        )
        self._spill = spill_queue_depth
        self._kv_weight = float(kv_weight)
        self._lock = threading.Lock()
        self._stats = {  # guarded-by: _lock
            "placements": 0,
            "affinity_hits": 0,     # placed by the prefix index
            "hash_places": 0,       # placed by the consistent ring
            "load_spills": 0,       # steering overridden by the gate
            "evictions": 0,         # replicas removed from the ring
        }

    # -- membership ------------------------------------------------------
    def add_replica(self, replica_id: int) -> None:
        self.ring.add(replica_id)

    def remove_replica(self, replica_id: int) -> None:
        """Evict: drop the ring arcs and prune the affinity entries so
        no later placement can name this replica."""
        self.ring.remove(replica_id)
        self.index.drop_replica(replica_id)
        with self._lock:
            self._stats["evictions"] += 1

    # -- scoring ---------------------------------------------------------
    def _score(self, s: Mapping) -> float:
        """Lower is better.  Queue depth dominates (queued rows are
        whole requests waiting), active rows next, then KV pool
        pressure (a nearly-full pool means admissions will evict
        retained prefixes or requeue)."""
        score = 2.0 * float(s.get("queue_depth", 0))
        score += float(s.get("active_rows", 0))
        total = float(s.get("kv_pages_total", 0) or 0)
        if total > 0:
            score += self._kv_weight * (
                float(s.get("kv_pages_in_use", 0)) / total
            )
        return score

    def _spill_depth(self, s: Mapping) -> int:
        if self._spill is not None:
            return int(self._spill)
        return 2 * max(1, int(s.get("slots", 1)))

    # -- placement -------------------------------------------------------
    def place(
        self,
        prompt,
        stats: Mapping[int, Mapping],
        trace=None,
    ) -> Tuple[int, str]:
        """One placement decision (module docstring) over exactly the
        replicas in `stats` — the caller passes the currently-eligible
        set (the fleet filters drained/dead/already-tried replicas
        out; one exclusion mechanism, not two).  Deterministic: no
        RNG, ties break by replica id.  `trace` (otel.Trace), when
        given, gains a "placement" child span recording the decision
        and its reason — the router owns the decision, so it owns the
        span (fleet threads call place() on the submit path, never
        the engine dispatch hot path)."""
        t0 = time.monotonic() if trace is not None else 0.0
        eligible = sorted(int(r) for r in stats)
        if not eligible:
            raise NoReplicasError(
                "no eligible replica (all draining, dead, or excluded)"
            )
        least = min(
            eligible, key=lambda r: (self._score(stats[r]), r)
        )
        target = None
        reason = "hash"
        if self.affinity_enabled:
            owner, depth = self.index.match(prompt)
            if owner is not None and depth > 0 and owner in eligible:
                target, reason = owner, "affinity"
        if target is None:
            target = self.ring.lookup(_token_key(prompt), eligible)
            if target is None:
                target = least  # ring empty (membership never added)
        if (
            target != least
            and int(stats[target].get("queue_depth", 0))
            >= self._spill_depth(stats[target])
            and self._score(stats[least]) < self._score(stats[target])
        ):
            target, reason = least, "load"
        with self._lock:
            self._stats["placements"] += 1
            key = {
                "affinity": "affinity_hits",
                "hash": "hash_places",
                "load": "load_spills",
            }[reason]
            self._stats[key] += 1
        if trace is not None:
            trace.span(
                "placement", t0, time.monotonic(),
                {"replica": target, "reason": reason,
                 "eligible": len(eligible)},
            )
        return target, reason

    def record(self, prompt, replica_id: int,
               tier: str = "hbm") -> None:
        """Remember the placement for affinity/ownership (no-op when
        neither affinity steering nor ownership tracking is on, or
        the prompt is shorter than one page).  `tier` stamps where
        the owner holds the prefix (see
        PrefixAffinityIndex.record)."""
        if self.affinity_enabled or self.track_enabled:
            self.index.record(prompt, replica_id, tier=tier)

    def owner_of(self, prompt) -> Tuple[Optional[int], int]:
        """(replica id owning this prompt's deepest recorded prefix,
        full pages matched) — the fleet's migrate-or-recompute input.
        (None, 0) when nothing is recorded or tracking is off."""
        if not (self.affinity_enabled or self.track_enabled):
            return None, 0
        return self.index.match(prompt)

    def owner_tier_of(self, prompt) -> Tuple[Optional[int], int, str]:
        """owner_of() extended with the recorded tier hint: (replica
        id, full pages matched, "hbm"/"host"/"disk") — the fleet's
        fetch-from-peer vs load-from-tier vs recompute input.
        (None, 0, "hbm") when nothing is recorded or tracking is
        off."""
        if not (self.affinity_enabled or self.track_enabled):
            return None, 0, "hbm"
        return self.index.match_tier(prompt)

    def load_score(self, stats: Mapping) -> float:
        """Public read of the placement load score (lower is better)
        — the fleet's prefill-replica picker reuses the one scoring
        function instead of keeping a second opinion."""
        return self._score(stats)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
        out["index_pages"] = self.index.page_count()
        out["ring_members"] = len(self.ring.members())
        return out
