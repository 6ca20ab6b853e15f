"""KV page export / adopt in the port against the reference: the pool's
export pins and the trie's ownership transfer (adopt, release_exported,
lru_leaves, drop_leaf), each case run on both packages' pool and trie
and the two held equal on the same token paths; then the engines (f32,
CPU): the same prefix exported by both packages agrees page by page, a
port engine that adopts a prefix gives the reference engine's greedy
tokens (bf16 and int8, one-token, fused and speculative), and every
failure (a layout of the other kind or the other backend, a truncated
blob, a full pool, a failed scatter) raises and holds no page.  The
twin of the pool, trie and engine cases of tests/test_kv_migration.py."""

import time

import numpy as np
import pytest

from _torch_port import (
    PAGE, draw_params, jax_decoder, jax_params, port_model, rand_prompt,
)
from container_engine_accelerators_tpu.serving import kvpool as ref_kvpool
from container_engine_accelerators_tpu.serving import (
    prefix_cache as ref_prefix,
)
from container_engine_accelerators_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
)
from container_engine_accelerators_tpu_torch.serving import kvpool
from container_engine_accelerators_tpu_torch.serving import prefix_cache

ENGINE_KW = dict(prompt_grid=4, prefill_chunk=PAGE, page_size=PAGE,
                 retry_backoff_s=0.01, retry_backoff_cap_s=0.02)
QUANT = pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
MODES = pytest.mark.parametrize("mode", [
    {}, {"decode_steps": 4}, {"spec_k": 2},
], ids=["one_token", "fused", "spec"])


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    """(kvpool, prefix_cache) of the reference or of the port."""
    if request.param == "jax":
        return ref_kvpool, ref_prefix
    return kvpool, prefix_cache


def _toks(n_pages, base=0):
    return list(range(base, base + n_pages * PAGE))


# -- pool export pins ------------------------------------------------------
class TestPoolExportPins:
    def test_export_pins_release_unpins_round_trip(self, pkg):
        kp, _ = pkg
        pool = kp.PagePool(8)
        pages = pool.alloc(3)
        pool.export_pages(pages)
        assert [pool.refcount(p) for p in pages] == [2, 2, 2]
        pool.ref(pages[0])
        assert pool.release_pages(pages) == 0
        assert [pool.refcount(p) for p in pages] == [2, 1, 1]
        assert pool.in_use == 3

    def test_double_export_two_pins_release_once_still_resident(self, pkg):
        kp, _ = pkg
        pool = kp.PagePool(4)
        pages = pool.alloc(2)
        pool.export_pages(pages)
        pool.export_pages(pages)
        assert [pool.refcount(p) for p in pages] == [3, 3]
        pool.release_pages(pages)
        assert pool.in_use == 2
        pool.release_pages(pages)
        assert pool.release_pages(pages) == 2
        assert pool.in_use == 0

    def test_export_is_all_or_nothing_on_a_bad_page(self, pkg):
        kp, _ = pkg
        pool = kp.PagePool(8)
        pages = pool.alloc(2)
        with pytest.raises(ValueError):
            pool.export_pages(pages + [7])
        assert [pool.refcount(p) for p in pages] == [1, 1]
        with pytest.raises(kp.PoolExhausted):
            pool.alloc(7)
        assert pool.in_use == 2

    def test_migration_ticket_lifecycle(self, pkg):
        kp, _ = pkg
        t = kp.MigrationTicket([3, 4])
        assert (t.state, t.pages) == ("exported", [3, 4])
        t.mark_streaming()
        t.mark_adopted()
        t.mark_released()
        assert t.state == "released"
        assert kp.MigrationTicket([1], initial="streaming").state == (
            "streaming")
        with pytest.raises(ValueError):
            kp.MigrationTicket([1], initial="adopted")


# -- trie ownership transfer -----------------------------------------------
class TestTrieAdoptRelease:
    def test_adopt_transfers_ownership_and_dedups(self, pkg):
        kp, pc = pkg
        pool, trie = kp.PagePool(16), pc.RadixPrefixCache(PAGE)
        toks = _toks(3)
        pages = pool.alloc(3)
        assert trie.adopt(toks, pages, pool) == (3, [])
        assert [pool.refcount(p) for p in pages] == [1, 1, 1]
        dup = pool.alloc(3)
        assert trie.adopt(toks, dup, pool) == (0, dup)
        assert pool.release_pages(dup) == 3
        assert pool.in_use == 3

    def test_release_exported_drops_chain_and_subtree(self, pkg):
        kp, pc = pkg
        pool, trie = kp.PagePool(16), pc.RadixPrefixCache(PAGE)
        toks = _toks(2)
        trie.adopt(toks, pool.alloc(2), pool)
        deep_pages = pool.alloc(3)
        adopted, unused = trie.adopt(toks + _toks(1, base=200), deep_pages,
                                     pool)
        assert (adopted, unused) == (1, deep_pages[:2])
        pool.release_pages(unused)
        assert trie.release_exported(toks, pool) == 3
        assert trie.page_count() == 0 and pool.in_use == 0

    def test_release_exported_stops_at_shared_interior(self, pkg):
        kp, pc = pkg
        pool, trie = kp.PagePool(16), pc.RadixPrefixCache(PAGE)
        a = _toks(1) + _toks(1, base=100)
        b = _toks(1) + _toks(1, base=300)
        trie.adopt(a, pool.alloc(2), pool)
        _, unused = trie.adopt(b, pool.alloc(2), pool)
        pool.release_pages(unused)
        assert trie.release_exported(a, pool) == 1
        assert trie.page_count() == 2
        got, partial = trie.match(b)
        assert len(got) == 2 and partial is None

    def test_release_exported_keeps_pages_active_rows_map(self, pkg):
        kp, pc = pkg
        pool, trie = kp.PagePool(16), pc.RadixPrefixCache(PAGE)
        pages = pool.alloc(2)
        trie.adopt(_toks(2), pages, pool)
        pool.ref(pages[0])
        trie.release_exported(_toks(2), pool)
        assert [pool.refcount(p) for p in pages] == [1, 0]
        assert pool.in_use == 1

    def test_lru_leaves_and_drop_leaf(self, pkg):
        kp, pc = pkg
        pool, trie = kp.PagePool(16), pc.RadixPrefixCache(PAGE)
        a = _toks(2)
        b = _toks(1) + _toks(1, base=500)
        trie.insert(a, pool.alloc(2), pool)
        b_pages = pool.alloc(2)
        trie.insert(b, b_pages, pool)
        leaves = trie.lru_leaves(5)
        assert [path for path, _ in leaves] == [a, b]  # oldest first
        assert leaves[1][1] == b_pages[1]
        trie.match(a)  # a match rejuvenates its path
        assert [path for path, _ in trie.lru_leaves(1)] == [b]
        # Only a leaf drops: an interior node or a vanished path drops 0.
        assert trie.drop_leaf(_toks(1), pool) == 0
        assert trie.drop_leaf(b, pool) == 1
        assert trie.drop_leaf(b, pool) == 0
        assert trie.page_count() == 2
        assert pool.refcount(b_pages[1]) == 1  # the row's own reference


def test_trie_and_pool_agree_with_the_reference_on_random_paths():
    # The same random sequence of inserts, adopts, matches, demotion
    # scans, leaf drops and exports, on both packages' pool and trie:
    # every return value and every refcount agrees.
    rng = np.random.default_rng(0)
    sides = [(ref_kvpool.PagePool(64), ref_prefix.RadixPrefixCache(PAGE)),
             (kvpool.PagePool(64), prefix_cache.RadixPrefixCache(PAGE))]
    stems = [list(rng.integers(0, 4, PAGE)) for _ in range(3)]

    def path():
        n = int(rng.integers(1, 4))
        return [t for _ in range(n) for t in stems[rng.integers(0, 3)]]

    for step in range(120):
        op = rng.integers(0, 5)
        toks = path()
        outs = []
        for pool, trie in sides:
            if op == 0:
                n = len(toks) // PAGE
                got = (trie.insert(toks, pool.alloc(n), pool)
                       if pool.free_count >= n else None)
            elif op == 1:
                n = len(toks) // PAGE
                if pool.free_count >= n:
                    pages = pool.alloc(n)
                    got = trie.adopt(toks, pages, pool)
                    pool.release_pages(got[1])
                else:
                    got = None
            elif op == 2:
                got = trie.match(toks)
            elif op == 3:
                got = [(p, pid) for p, pid in trie.lru_leaves(2)]
                for p, _ in got[:1]:
                    trie.drop_leaf(p, pool)
            else:
                got = trie.release_exported(toks, pool)
            outs.append((got, trie.page_count(), pool.in_use,
                         [pool.refcount(p) for p in range(1, 65)]))
        assert outs[0] == outs[1], (step, op)


# -- the engines -----------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return params, port_model(params)


def _engine(pm, slots=2, **kw):
    return ContinuousBatchingEngine(pm, slots, device="cpu",
                                    **{**ENGINE_KW, **kw})


def _ref_engine(params, slots=2, **kw):
    return JaxEngine(jax_decoder(), jax_params(params), slots,
                     **{**ENGINE_KW, **kw})


def _wait_until(cond, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _retained(eng, n):
    _wait_until(lambda: eng.snapshot()["prefix_cached_pages"] == n,
                what="trie retention")


def _no_orphans(snap):
    return snap["kv_pages_in_use"] == snap["prefix_cached_pages"]


def _leaves(meta, blob):
    """The blob's leaves as numpy arrays (bf16 excluded: both engines
    here run f32 models)."""
    out, off = [], 0
    n = meta["n_pages"]
    for lm in meta["leaves"]:
        dt = np.dtype(lm["dtype"])
        count = n * int(np.prod(lm["shape"]))
        out.append(np.frombuffer(blob, dt, count, off).reshape(
            [n] + lm["shape"]))
        off += count * dt.itemsize
    assert off == len(blob)
    return out


class TestEngineMigration:
    @QUANT
    def test_export_parity_with_the_reference(self, setup, quant):
        # The same prompt through both packages' engines: the exported
        # metas agree (the signature only in its backend entry), and
        # leaf by leaf the pages agree within 1e-5 relative (the int8
        # twin's codes within one step, its scales within 1e-5).
        params, pm = setup
        prompt = rand_prompt(1, 26)
        eng, ref = _engine(pm, quant=quant), _ref_engine(params, quant=quant)
        try:
            for e in (eng, ref):
                e.submit(prompt, 4, 0.0, timeout=300)
                _retained(e, 3)
            meta, blob = eng.export_prefix_pages(prompt[0])
            rmeta, rblob = ref.export_prefix_pages(prompt[0])
        finally:
            eng.close()
            ref.close()
        assert meta["sig"][0] == [PAGE, "torch"] and rmeta["sig"][0] == [PAGE]
        assert meta["sig"][1:] == rmeta["sig"][1:]
        for k in ("n_pages", "tokens_covered", "leaves"):
            assert meta[k] == rmeta[k], k
        assert len(blob) == len(rblob)
        for i, (got, want) in enumerate(zip(_leaves(meta, blob),
                                            _leaves(rmeta, rblob))):
            if got.dtype == np.int8:
                diff = np.abs(got.astype(np.int32) - want)
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01, i
            else:
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err <= 1e-5, (i, err)

    @QUANT
    @MODES
    def test_adopted_prefix_gives_the_reference_tokens(self, setup, quant,
                                                       mode):
        # Engine A exports, a fresh engine B adopts and serves the
        # prompt as a local prefix hit; its greedy tokens are the
        # reference engine's on the same prefix hit, and B's re-export
        # is bitwise A's blob.
        params, pm = setup
        prompt = rand_prompt(2, 26)
        src, dst = _engine(pm, quant=quant), _engine(pm, quant=quant, **mode)
        try:
            src.submit(prompt, 6, 0.0, timeout=300)
            _retained(src, 3)
            meta, blob = src.export_prefix_pages(prompt[0])
            assert (meta["n_pages"], meta["tokens_covered"]) == (3, 24)
            assert dst.adopt_prefix_pages(prompt[0][:24], meta, blob) == 3
            snap = dst.snapshot()
            assert (snap["kv_pages_adopted"], snap["kv_adopt_bytes"]) == (
                3, len(blob))
            got = dst.submit(prompt, 6, 0.0, timeout=300)
            assert dst.snapshot()["prefix_hit_tokens"] >= 24
            again = dst.export_prefix_pages(prompt[0])
        finally:
            src.close()
            dst.close()
        assert again[1] == blob and again[0] == meta
        ref = _ref_engine(params, quant=quant)
        try:
            ref.submit(prompt, 6, 0.0, timeout=300)
            _wait_until(lambda: ref.snapshot()["prefix_cached_pages"] == 3)
            want = ref.submit(prompt, 6, 0.0, timeout=300)  # a hit
        finally:
            ref.close()
        assert got == want

    def test_blobs_of_the_other_backend_are_rejected(self, setup):
        # The layout signature names the backend: a JAX engine rejects
        # a torch blob and a torch engine a JAX blob, with ValueError
        # and no page held on either side.
        params, pm = setup
        prompt = rand_prompt(3, 24)
        eng, ref = _engine(pm), _ref_engine(params)
        try:
            for e in (eng, ref):
                e.submit(prompt, 3, 0.0, timeout=300)
                _retained(e, 3)
            mine = eng.export_prefix_pages(prompt[0])
            theirs = ref.export_prefix_pages(prompt[0])
            fresh, rfresh = _engine(pm), _ref_engine(params)
            try:
                with pytest.raises(ValueError, match="layout"):
                    fresh.adopt_prefix_pages(prompt[0], *theirs)
                with pytest.raises(ValueError, match="layout"):
                    rfresh.adopt_prefix_pages(prompt[0], *mine)
                for e in (fresh, rfresh):
                    snap = e.snapshot()
                    assert snap["kv_adopt_failures"] == 1
                    assert snap["kv_pages_in_use"] == 0
            finally:
                fresh.close()
                rfresh.close()
        finally:
            eng.close()
            ref.close()

    def test_layout_mismatch_truncated_and_long_blobs_fail_clean(self,
                                                                 setup):
        _, pm = setup
        prompt = rand_prompt(4, 24)
        src, quant = _engine(pm), _engine(pm, quant=True)
        try:
            src.submit(prompt, 4, 0.0, timeout=300)
            _retained(src, 3)
            meta, blob = src.export_prefix_pages(prompt[0])
            with pytest.raises(ValueError, match="layout"):
                quant.adopt_prefix_pages(prompt[0], meta, blob)
            with pytest.raises(ValueError, match="truncated"):
                src.adopt_prefix_pages(prompt[0], meta, blob[:-4])
            with pytest.raises(ValueError, match="size mismatch"):
                src.adopt_prefix_pages(prompt[0], meta, blob + b"\0\0")
            with pytest.raises(ValueError, match="tokens"):
                src.adopt_prefix_pages(prompt[0][:16], meta, blob)
            assert quant.snapshot()["kv_pages_in_use"] == 0
            snap = src.snapshot()
            assert snap["kv_adopt_failures"] == 3
            assert _no_orphans(snap) and snap["prefix_cached_pages"] == 3
        finally:
            src.close()
            quant.close()

    def test_move_export_releases_the_source_copy(self, setup):
        _, pm = setup
        prompt = rand_prompt(5, 24)
        src = _engine(pm)
        try:
            src.submit(prompt, 4, 0.0, timeout=300)
            _retained(src, 3)
            out = src.export_prefix_pages(prompt[0], move=True)
            assert out is not None and out[0]["n_pages"] == 3
            assert src.export_prefix_pages(prompt[0]) is None
            _wait_until(lambda: src.snapshot()["kv_pages_in_use"] == 0)
            assert src.snapshot()["kv_pages_exported"] == 3
        finally:
            src.close()

    def test_export_without_match_and_unpaged_engine(self, setup):
        _, pm = setup
        src, contig = _engine(pm), _engine(pm, paged=False)
        try:
            assert src.export_prefix_pages(rand_prompt(6, 16)[0]) is None
            for call in (lambda: contig.export_prefix_pages([1] * 16),
                         lambda: contig.adopt_prefix_pages(
                             [1] * 16, {"n_pages": 1}, b""),
                         lambda: contig.promote_prefix_pages([1] * 16)):
                with pytest.raises(RuntimeError, match="paged"):
                    call()
        finally:
            src.close()
            contig.close()

    def test_adopt_into_full_pool_fails_clean_and_serves_on(self, setup):
        _, pm = setup
        src, tiny = _engine(pm), _engine(pm, slots=1, kv_pages=2)
        try:
            prompt = rand_prompt(7, 24)
            src.submit(prompt, 4, 0.0, timeout=300)
            _retained(src, 3)
            meta, blob = src.export_prefix_pages(prompt[0])
            small = rand_prompt(8, 8)
            want = tiny.submit(small, 4, 0.0, timeout=300)
            _wait_until(lambda: _no_orphans(tiny.snapshot()))
            with pytest.raises(kvpool.PoolExhausted):
                tiny.adopt_prefix_pages(prompt[0], meta, blob)
            snap = tiny.snapshot()
            assert _no_orphans(snap)
            assert (snap["kv_adopt_failures"], snap["kv_pages_adopted"]) == (
                1, 0)
            assert tiny.submit(small, 4, 0.0, timeout=300) == want
        finally:
            src.close()
            tiny.close()

    def test_failed_scatter_holds_no_page(self, setup):
        # A scatter that raises gives its pages back; when the device
        # state is lost with it, the engine fails its active rows,
        # drops its graphs and rebuilds the cache (the queue serves on).
        _, pm = setup
        src, dst = _engine(pm), _engine(pm)
        try:
            prompt = rand_prompt(9, 24)
            want = src.submit(prompt, 4, 0.0, timeout=300)
            _retained(src, 3)
            meta, blob = src.export_prefix_pages(prompt[0])
            real = dst._page_scatter_fn

            def broken(*a, **k):
                raise RuntimeError("injected scatter fault")

            dst._page_scatter_fn = broken
            with pytest.raises(RuntimeError, match="injected"):
                dst.adopt_prefix_pages(prompt[0], meta, blob)
            assert dst.snapshot()["kv_pages_in_use"] == 0
            dst._cache_intact = lambda: False
            with pytest.raises(RuntimeError, match="injected"):
                dst.adopt_prefix_pages(prompt[0], meta, blob)
            kinds = [e for e in dst.observability.recorder.events()
                     if e["kind"] == "cache_lost"]
            assert [e["at"] for e in kinds] == ["page_adopt"]
            del dst._cache_intact
            dst._page_scatter_fn = real
            snap = dst.snapshot()
            assert snap["kv_adopt_failures"] == 2
            assert snap["kv_pages_in_use"] == 0
            assert dst.adopt_prefix_pages(prompt[0], meta, blob) == 3
            assert dst.submit(prompt, 4, 0.0, timeout=300) == want
        finally:
            src.close()
            dst.close()
