"""The port's fleet router (serving/router.py) against the reference's:
both packages' Routers, fed the same seeded prompts, stats, records
and evictions, make the same placements and report the same owners,
tiers and counters; and the reference's router unit cases
(tests/test_fleet.py TestRouterPlacement) on the port's copy.
"""

import numpy as np
import pytest

from container_engine_accelerators_tpu.serving import router as ref_router
from container_engine_accelerators_tpu_torch.serving import router as R

PAGE = 8
TIERS = ("hbm", "host", "disk")


def _stats(queue=0, active=0, slots=4, kv=(0, 0)):
    return {
        "queue_depth": queue, "active_rows": active, "slots": slots,
        "kv_pages_in_use": kv[0], "kv_pages_total": kv[1],
    }


def _script(seed, n_replicas, steps=160):
    """A seeded operation script: placements over random eligible sets
    and stats, records with tiers, owner queries and one eviction."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 64, (PAGE * int(rng.integers(1, 4)),))
                for _ in range(6)]
    ops = []
    evict_at = int(rng.integers(steps // 3, 2 * steps // 3))
    for i in range(steps):
        if i == evict_at:
            ops.append(("remove", int(rng.integers(n_replicas))))
            continue
        tail = rng.integers(0, 64, (int(rng.integers(0, 2 * PAGE)),))
        if rng.random() < 0.7:
            prompt = np.concatenate([prefixes[rng.integers(6)], tail])
        else:
            prompt = rng.integers(0, 64, (int(rng.integers(1, 4 * PAGE)),))
        kind = rng.random()
        if kind < 0.5:
            eligible = [r for r in range(n_replicas) if rng.random() < 0.85]
            stats = {r: _stats(queue=int(rng.integers(0, 12)),
                               active=int(rng.integers(0, 4)),
                               kv=(int(rng.integers(0, 40)), 40))
                     for r in eligible}
            ops.append(("place", prompt, stats))
        elif kind < 0.8:
            ops.append(("record", prompt, int(rng.integers(n_replicas)),
                        TIERS[int(rng.integers(3))]))
        else:
            ops.append(("owner", prompt))
    return ops


def _run(mod, ops, n_replicas, **kw):
    r = mod.Router(page_size=PAGE, **kw)
    for i in range(n_replicas):
        r.add_replica(i)
    out = []
    for op in ops:
        if op[0] == "place":
            try:
                out.append(r.place(op[1], op[2]))
            except mod.NoReplicasError as e:
                out.append(("none", e.replica))
        elif op[0] == "record":
            r.record(op[1], op[2], tier=op[3])
        elif op[0] == "remove":
            r.remove_replica(op[1])
        else:
            out.append((r.owner_of(op[1]), r.owner_tier_of(op[1]),
                        r.index.match_tier(op[1])))
    out.append((r.stats(), r.ring.members()))
    return out


@pytest.mark.parametrize("seed,n_replicas,kw", [
    (0, 2, {}),
    (1, 3, {}),
    (2, 4, {"spill_queue_depth": 4}),
    (3, 3, {"affinity": False}),
    (4, 3, {"affinity": False, "track": True}),
    (5, 2, {"max_index_pages": 6, "vnodes": 8}),
    (6, 4, {"kv_weight": 16.0, "spill_queue_depth": 2}),
])
def test_both_routers_place_identically(seed, n_replicas, kw):
    ops = _script(seed, n_replicas)
    want = _run(ref_router, ops, n_replicas, **kw)
    got = _run(R, ops, n_replicas, **kw)
    assert got == want
    # The script exercised every decision kind it could.
    reasons = {x[1] for x in want if isinstance(x, tuple) and len(x) == 2
               and x[1] in ("affinity", "hash", "load")}
    assert "hash" in reasons
    if kw.get("affinity", True):
        assert "affinity" in reasons


@pytest.mark.parametrize("tokens", [
    [1, 2, 3], list(range(40)), np.arange(17, dtype=np.int32),
    np.array([2 ** 31 - 1, 0, 5], np.int64),
])
def test_token_key_and_ring_are_the_references(tokens):
    assert R._token_key(tokens) == ref_router._token_key(tokens)
    assert R._hash64(b"replica-3:vnode-7") == ref_router._hash64(
        b"replica-3:vnode-7")
    ring, ref = R.ConsistentHashRing(vnodes=16), \
        ref_router.ConsistentHashRing(vnodes=16)
    for i in range(5):
        ring.add(i)
        ref.add(i)
    key = R._token_key(tokens)
    assert ring.lookup(key) == ref.lookup(key)
    assert ring.lookup(key, eligible=[1, 3]) == ref.lookup(key,
                                                          eligible=[1, 3])


def test_no_replicas_error_is_a_replica_unavailable():
    from container_engine_accelerators_tpu_torch.serving.errors import (
        ReplicaUnavailable,
    )

    e = R.NoReplicasError()
    assert isinstance(e, ReplicaUnavailable) and e.replica == -1


# -- the reference's router unit cases, on the port's copy -------------------
class TestRouterPlacement:
    def test_deterministic_under_fixed_stats(self):
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 64, (24,)) for _ in range(30)]
        stats = {0: _stats(1), 1: _stats(), 2: _stats(2)}

        def run():
            r = R.Router(page_size=PAGE)
            for i in stats:
                r.add_replica(i)
            return [r.place(p, stats) for p in prompts]

        first = run()
        assert first == run()
        r = R.Router(page_size=PAGE)
        for i in stats:
            r.add_replica(i)
        for p, want in zip(prompts, first):
            for _ in range(3):
                assert r.place(p, stats) == want

    def test_hash_sticks_and_spreads(self):
        r = R.Router(page_size=PAGE, affinity=False)
        for i in range(3):
            r.add_replica(i)
        stats = {i: _stats() for i in range(3)}
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 64, (16,)) for _ in range(60)]
        placed = [r.place(p, stats) for p in prompts]
        assert all(reason == "hash" for _, reason in placed)
        for p, want in zip(prompts[:10], placed[:10]):
            assert r.place(p, stats) == want
        assert len({rid for rid, _ in placed}) == 3

    def test_shared_prefix_spreads_without_affinity(self):
        r = R.Router(page_size=PAGE, affinity=False)
        for i in range(3):
            r.add_replica(i)
        stats = {i: _stats() for i in range(3)}
        prefix = list(range(PAGE * 2))
        placed = {
            r.place(prefix + [50, i % 7, (3 * i) % 11, 1], stats)[0]
            for i in range(24)
        }
        assert len(placed) >= 2

    def test_affinity_steers_to_recorded_replica(self):
        r = R.Router(page_size=PAGE)
        for i in range(3):
            r.add_replica(i)
        stats = {i: _stats() for i in range(3)}
        prefix = list(range(PAGE * 2))
        r.record(prefix + [9, 9], 2)
        assert r.place(prefix + [1, 2, 3], stats) == (2, "affinity")
        c = R.Router(page_size=PAGE, affinity=False)
        for i in range(3):
            c.add_replica(i)
        c.record(prefix + [9, 9], 2)
        assert c.place(prefix + [1, 2, 3], stats)[1] == "hash"

    def test_load_gate_spills_overloaded_target(self):
        r = R.Router(page_size=PAGE, spill_queue_depth=4)
        for i in range(2):
            r.add_replica(i)
        prefix = list(range(PAGE))
        r.record(prefix, 0)
        hot = {0: _stats(queue=8, active=4), 1: _stats()}
        assert r.place(prefix + [1], hot) == (1, "load")
        warm = {0: _stats(queue=2, active=2), 1: _stats()}
        assert r.place(prefix + [1], warm) == (0, "affinity")

    def test_eviction_converges_to_survivors(self):
        r = R.Router(page_size=PAGE)
        for i in range(3):
            r.add_replica(i)
        stats3 = {i: _stats() for i in range(3)}
        prefix = list(range(PAGE))
        r.record(prefix + [5], 1)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, 64, (12,)) for _ in range(50)]
        before = {tuple(map(int, p)): r.place(p, stats3)[0]
                  for p in prompts}
        r.remove_replica(1)
        stats2 = {0: _stats(), 2: _stats()}
        for p in prompts:
            rid, _ = r.place(p, stats2)
            assert rid in (0, 2)
            if before[tuple(map(int, p))] != 1:
                assert rid == before[tuple(map(int, p))]
        assert r.index.match(prefix + [5]) == (None, 0)
        assert r.ring.members() == [0, 2]
        assert r.stats()["evictions"] == 1

    def test_no_eligible_replicas_raises(self):
        r = R.Router(page_size=PAGE)
        r.add_replica(0)
        with pytest.raises(R.NoReplicasError):
            r.place([1, 2, 3], {})

    def test_affinity_index_is_bounded_lru(self):
        ix = R.PrefixAffinityIndex(PAGE, max_pages=8)
        rng = np.random.default_rng(3)
        for i in range(40):
            ix.record(rng.integers(0, 64, (PAGE * 2,)), i % 3)
        assert ix.page_count() <= 8

    def test_ring_membership_is_idempotent(self):
        ring = R.ConsistentHashRing(vnodes=8)
        ring.add(0)
        ring.add(0)
        ring.remove(1)
        assert ring.members() == [0]
        assert ring.lookup(b"key") == 0
        assert ring.lookup(b"key", eligible=[]) is None

    def test_tier_hint_tracks_the_deepest_record(self):
        r = R.Router(page_size=PAGE, affinity=False, track=True)
        r.add_replica(0)
        prompt = list(range(3 * PAGE))
        r.record(prompt, 0, tier="disk")
        assert r.owner_tier_of(prompt) == (0, 3, "disk")
        r.record(prompt[:PAGE], 0)  # re-owned at hbm, deeper keeps disk
        assert r.owner_tier_of(prompt) == (0, 3, "disk")
        assert r.owner_tier_of(prompt[:PAGE]) == (0, 1, "hbm")
        off = R.Router(page_size=PAGE, affinity=False)
        off.record(prompt, 0, tier="host")
        assert off.owner_tier_of(prompt) == (None, 0, "hbm")
