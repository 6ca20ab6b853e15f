"""The host / disk KV tiers in the port (serving/kvtier.py and the
engine's demote-on-eviction, promote-on-admission) against the
reference: every TieredPageStore case runs on both packages' stores
(and a spill file written by one is read by the other: the same KVT1
framing), then the engines (f32, CPU, depth 2): a session whose pages
were demoted and promoted back gives the reference engine's greedy
tokens (bf16 and int8; one-token, fused and speculative), refcounts
balance, the disk tier outlives an engine and the host tier a
supervisor rebuild, and a corrupt entry, a failing `_tier_load` or a
failed scatter recomputes without failing the ticket.  The twin of
tests/test_kv_tiering.py's store and engine cases."""

import glob
import time

import numpy as np
import pytest

from _torch_port import (
    PAGE, draw_params, jax_decoder, jax_params, port_model, rand_prompt,
)
from container_engine_accelerators_tpu.serving import kvtier as ref_kvtier
from container_engine_accelerators_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
    EngineSupervisor,
)
from container_engine_accelerators_tpu_torch.serving import kvtier
from container_engine_accelerators_tpu_torch.serving import observe

ENGINE_KW = dict(prompt_grid=4, prefill_chunk=PAGE, page_size=PAGE,
                 retry_backoff_s=0.01, retry_backoff_cap_s=0.02)
QUANT = pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
MODES = pytest.mark.parametrize("mode", [
    {}, {"decode_steps": 4}, {"spec_k": 2},
], ids=["one_token", "fused", "spec"])


@pytest.fixture(params=["jax", "torch"])
def kt(request):
    """The reference's kvtier module or the port's."""
    return ref_kvtier if request.param == "jax" else kvtier


def _toks(seed, n_pages):
    return np.random.default_rng(seed).integers(
        0, 64, n_pages * PAGE).astype(np.int32)


def _entry(nbytes=512):
    return {"n_pages": 1, "tokens_covered": PAGE, "sig": ["s"],
            "leaves": ["k"]}, bytes(range(256)) * (nbytes // 256)


# -- the store ---------------------------------------------------------------
class TestTieredPageStore:
    def test_host_round_trip_and_counters(self, kt):
        st = kt.TieredPageStore(PAGE, host_bytes=1 << 20)
        meta, blob = _entry()
        key = st.key_of(_toks(0, 2)[:PAGE])
        assert st.contains(key) is None and st.get(key) is None
        st.put(key, meta, blob)
        assert st.contains(key) == kt.HOST
        h = st.get(key)
        assert h.tier == kt.HOST and h.blob == blob and h.n_pages == 1
        assert st.check_leaks() == 1
        h.close()
        h.close()
        assert st.check_leaks() == 0
        s = st.stats()
        assert (s["kv_tier_hits"], s["kv_tier_host_entries"],
                s["kv_tier_host_bytes"]) == (1, 1, len(blob))

    def test_host_lru_spills_to_disk_and_get_rejuvenates(self, kt, tmp_path):
        meta, blob = _entry()
        st = kt.TieredPageStore(PAGE, host_bytes=2 * len(blob),
                                disk_dir=str(tmp_path))
        ka, kb, kc = (st.key_of(_toks(s, 1)) for s in (1, 2, 3))
        st.put(ka, meta, blob)
        st.put(kb, meta, blob)
        st.get(ka).close()
        st.put(kc, meta, blob)
        assert [st.contains(k) for k in (ka, kb, kc)] == [
            kt.HOST, kt.DISK, kt.HOST]
        h = st.get(kb)
        assert h.tier == kt.DISK and h.blob == blob
        h.close()
        assert st.stats()["kv_tier_evictions"] == 0

    def test_host_lru_evicts_without_a_disk_tier(self, kt):
        meta, blob = _entry()
        st = kt.TieredPageStore(PAGE, host_bytes=2 * len(blob))
        keys = [st.key_of(_toks(s, 1)) for s in (1, 2, 3)]
        for k in keys:
            st.put(k, meta, blob)
        assert st.contains(keys[0]) is None
        assert st.stats()["kv_tier_evictions"] == 1

    def test_disk_cap_evicts_coldest(self, kt, tmp_path):
        meta, blob = _entry()
        st = kt.TieredPageStore(PAGE, host_bytes=len(blob),
                                disk_dir=str(tmp_path),
                                disk_bytes=len(blob) + len(blob) // 2)
        keys = [st.key_of(_toks(s, 1)) for s in (1, 2, 3)]
        for k in keys:
            st.put(k, meta, blob)
        assert [st.contains(k) for k in keys] == [None, kt.DISK, kt.HOST]
        assert len(glob.glob(str(tmp_path / "*.kvt"))) == 1

    def test_zero_host_cap_is_pure_disk_mode(self, kt, tmp_path):
        meta, blob = _entry()
        st = kt.TieredPageStore(PAGE, host_bytes=0, disk_dir=str(tmp_path))
        k = st.key_of(_toks(4, 1))
        st.put(k, meta, blob)
        assert st.contains(k) == kt.DISK
        with pytest.raises(ValueError, match="host"):
            kt.TieredPageStore(PAGE, host_bytes=0)

    def test_longest_run_is_consecutive(self, kt):
        meta, blob = _entry()
        st = kt.TieredPageStore(PAGE, host_bytes=1 << 20)
        toks = _toks(5, 4)
        for d in (1, 2, 4):
            st.put(st.key_of(toks[: d * PAGE]), meta, blob)
        assert st.longest_run(toks, 0) == [kt.HOST, kt.HOST]
        assert st.longest_run(toks, 2) == []
        assert st.longest_run(toks, 3) == [kt.HOST]

    def test_scan_rebuilds_the_disk_index_across_packages(self, kt,
                                                          tmp_path):
        # A spill file written by this package's store is indexed and
        # read back by a fresh store of EITHER package over the same
        # directory: the KVT1 frame is one format.
        meta, blob = _entry()
        st = kt.TieredPageStore(PAGE, host_bytes=0, disk_dir=str(tmp_path))
        key = st.key_of(_toks(6, 2))
        st.put(key, meta, blob)
        for other in (ref_kvtier, kvtier):
            st2 = other.TieredPageStore(PAGE, host_bytes=0,
                                        disk_dir=str(tmp_path))
            assert st2.contains(key) == other.DISK
            h = st2.get(key)
            assert h.blob == blob and h.meta["sig"] == ["s"]
            h.close()

    def test_corrupt_disk_blob_is_counted_and_deleted(self, kt, tmp_path):
        meta, blob = _entry()
        st = kt.TieredPageStore(PAGE, host_bytes=0, disk_dir=str(tmp_path))
        key = st.key_of(_toks(7, 1))
        st.put(key, meta, blob)
        [path] = glob.glob(str(tmp_path / "*.kvt"))
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        with open(path, "wb") as f:
            f.write(raw)
        with pytest.raises(kt.TierCorrupt):
            st.get(key)
        assert st.stats()["kv_tier_corrupt"] == 1
        assert st.contains(key) is None
        assert glob.glob(str(tmp_path / "*.kvt")) == []

    def test_collect_families(self, kt):
        meta, blob = _entry()
        st = kt.TieredPageStore(PAGE, host_bytes=1 << 20)
        st.put(st.key_of(_toks(8, 1)), meta, blob)
        fams = {f.name: f for f in st.collect()}
        assert fams["kv_tier_pages"].samples == [
            ({"tier": "host"}, 1.0), ({"tier": "disk"}, 0.0)]
        assert fams["kv_tier_demotions_total"].samples == [({}, 1.0)]


# -- the engines -------------------------------------------------------------
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


def _retained(eng, n=3):
    _wait_until(lambda: eng.snapshot()["prefix_cached_pages"] == n,
                what="trie retention")


def _pressure(eng, seeds, p_len=26, max_new=6):
    """Distinct prompts that overflow an 8-page pool: each admission
    demotes the LRU leaves of what came before.  Returns the tokens."""
    return [eng.submit(rand_prompt(s, p_len), max_new, 0.0, timeout=300)
            for s in seeds]


def _demote_chain(eng, toks, seeds):
    """Pressure with one more prompt at a time until every full page of
    `toks` sits in the tier (eviction demotes a generation of leaves at
    a time).  Reads the store, not tier_probe, whose trie match would
    rejuvenate the pages this waits to see demoted."""
    for seed in seeds:
        if len(eng._tier.longest_run(toks, 0)) >= len(toks) // PAGE:
            return
        _pressure(eng, (seed,))
    raise AssertionError("the chain never reached the tier")


def _balanced(snap):
    return (snap["kv_pages_in_use"] == snap["prefix_cached_pages"]
            and snap["kv_tier_open_handles"] == 0)


def _round_trip(eng, prompt):
    """First visit, pressure, the return: (first, pressure, again)."""
    first = eng.submit(prompt, 6, 0.0, timeout=300)
    _retained(eng)
    pressure = _pressure(eng, (2, 3, 4))
    assert eng.snapshot()["kv_tier_demoted_pages"] > 0
    again = eng.submit(prompt, 6, 0.0, timeout=300)
    return first, pressure, again


class TestEngineTiering:
    @QUANT
    @MODES
    def test_demote_promote_round_trip_matches_the_reference(
            self, setup, quant, mode):
        # A returning session past pool pressure is served over
        # PROMOTED pages; every request's tokens are the reference
        # engine's on the same traffic with the same tier.
        params, pm = setup
        prompt = rand_prompt(1, 26)
        tier = dict(kv_pages=8, kv_host_bytes=1 << 20)
        eng = _engine(pm, quant=quant, **tier, **mode)
        try:
            got = _round_trip(eng, prompt)
            _wait_until(lambda: eng.snapshot()["active_rows"] == 0)
            snap = eng.snapshot()
            assert snap["kv_tier_promoted_pages"] > 0
            assert snap["prefix_hit_tokens"] >= 3 * PAGE
            assert _balanced(snap)
            [trace] = eng.observability.traces.traces()[-1:]
            fetch = [s for s in trace.spans if s.name == "tier_fetch"]
            assert fetch and fetch[0].attrs["tier"] == "host"
            parsed = observe.parse_text(eng.observability.registry.render())
            assert parsed["kv_tier_fetch_seconds_count"][
                '{tier="host"}'] >= 1
        finally:
            eng.close()
        assert eng.snapshot()["kv_pages_in_use"] == 0
        ref = _ref_engine(params, quant=quant, **tier)
        try:
            want = _round_trip(ref, prompt)
            rsnap = ref.snapshot()
        finally:
            ref.close()
        assert got == want
        for k in ("kv_tier_demoted_pages", "kv_tier_promoted_pages",
                  "prefix_hit_tokens"):
            assert snap[k] == rsnap[k], k

    def test_disk_tier_promotes_and_outlives_the_engine(self, setup,
                                                        tmp_path):
        # Pure disk mode: the chain spills to disk, a fresh engine over
        # the same directory rebuilds the index (_scan_disk) and its
        # first admission promotes from disk, bit-exactly.
        _, pm = setup
        prompt = rand_prompt(31, 26)
        tier = dict(kv_pages=8, kv_host_bytes=0, kv_disk_dir=str(tmp_path))
        eng = _engine(pm, **tier)
        try:
            want = eng.submit(prompt, 6, 0.0, timeout=300)
            _retained(eng)
            _demote_chain(eng, prompt[0], range(32, 64))
        finally:
            eng.close()
        eng2 = _engine(pm, **tier)
        try:
            assert eng2.tier_probe(prompt[0])["disk_pages"] == 3
            assert eng2.submit(prompt, 6, 0.0, timeout=300) == want
            snap = eng2.snapshot()
            assert snap["kv_tier_promoted_pages"] == 3
            assert snap["prefix_hit_tokens"] >= 3 * PAGE
            parsed = observe.parse_text(eng2.observability.registry.render())
            assert parsed["kv_tier_fetch_seconds_count"]['{tier="disk"}'] == 1
        finally:
            eng2.close()

    def test_host_tier_survives_a_supervisor_rebuild(self, setup):
        # A kill of the scheduler (a decode step failing past its
        # retries) rebuilds cache, pool and trie; the host tier rides
        # the engine across the revival and the returning session
        # promotes instead of recomputing.
        _, pm = setup
        eng = _engine(pm, kv_pages=8, kv_host_bytes=1 << 20, step_retries=1)
        sup = EngineSupervisor(eng, max_restarts=3,
                               restart_backoff_s=0.01).start()
        try:
            prompt = rand_prompt(41, 26)
            want = eng.submit(prompt, 6, 0.0, timeout=300)
            _retained(eng)
            # The revival clears the trie, so a promotion must start at
            # depth 1: the whole chain must sit in the tier.
            _demote_chain(eng, prompt[0], range(42, 74))
            host_entries = eng.snapshot()["kv_tier_host_entries"]
            real, calls = eng._decode_fn, [0]

            def flaky(*a, **k):
                calls[0] += 1
                if calls[0] <= 2:
                    raise RuntimeError("injected decode fault")
                return real(*a, **k)

            eng._decode_fn = flaky
            with pytest.raises(Exception):
                eng.submit(rand_prompt(45, 12), 4, 0.0, timeout=300)
            _wait_until(lambda: eng.snapshot()["restarts"] >= 1,
                        what="supervisor restart")
            snap = eng.snapshot()
            assert snap["kv_pages_in_use"] == 0
            assert snap["kv_tier_host_entries"] >= host_entries
            assert eng.submit(prompt, 6, 0.0, timeout=300) == want
            assert eng.snapshot()["kv_tier_promoted_pages"] > 0
        finally:
            sup.stop()
            eng.close()

    def test_corrupt_disk_blob_falls_back_to_recompute(self, setup,
                                                       tmp_path):
        _, pm = setup
        eng = _engine(pm, kv_pages=8, kv_host_bytes=0,
                      kv_disk_dir=str(tmp_path))
        try:
            prompt = rand_prompt(51, 26)
            want = eng.submit(prompt, 6, 0.0, timeout=300)
            _retained(eng)
            _pressure(eng, (52, 53, 54))
            files = glob.glob(str(tmp_path / "*.kvt"))
            assert files
            for path in files:
                raw = bytearray(open(path, "rb").read())
                raw[-1] ^= 0xFF
                with open(path, "wb") as f:
                    f.write(raw)
            assert eng.submit(prompt, 6, 0.0, timeout=300) == want
            snap = eng.snapshot()
            assert snap["kv_tier_corrupt"] >= 1
            assert snap["kv_tier_promoted_pages"] == 0
            assert snap["kv_tier_open_handles"] == 0
        finally:
            eng.close()

    def test_failing_tier_load_recomputes_without_failing_the_ticket(
            self, setup, tmp_path):
        # `_tier_load` made to fail (the store's fault seam): the entry
        # counts corrupt and is deleted, the request recomputes with
        # the same tokens, no handle stays open and no page leaks.
        _, pm = setup
        eng = _engine(pm, kv_pages=8, kv_host_bytes=0,
                      kv_disk_dir=str(tmp_path))
        try:
            prompt = rand_prompt(61, 26)
            want = eng.submit(prompt, 6, 0.0, timeout=300)
            _retained(eng)
            _pressure(eng, (62, 63, 64))
            assert eng.snapshot()["kv_tier_disk_entries"] > 0

            def broken(path):
                raise OSError("injected tier_load fault")

            eng._tier._tier_load = broken
            assert eng.submit(prompt, 6, 0.0, timeout=300) == want
            _wait_until(lambda: eng.snapshot()["active_rows"] == 0)
            snap = eng.snapshot()
            assert snap["kv_tier_corrupt"] >= 1
            assert snap["kv_tier_load_failures"] >= 1
            assert _balanced(snap)
        finally:
            eng.close()

    def test_failed_promotion_scatter_releases_everything(self, setup):
        # The scatter dies with fresh pages and open handles in flight:
        # every reference unwinds, the request recomputes bit-exactly,
        # and the tier still holds the entries for the next return.
        _, pm = setup
        eng = _engine(pm, kv_pages=8, kv_host_bytes=1 << 20)
        try:
            prompt = rand_prompt(81, 26)
            want = eng.submit(prompt, 6, 0.0, timeout=300)
            _retained(eng)
            _pressure(eng, (82, 83, 84))
            real, fails = eng._page_scatter_fn, [0]

            def once(*a, **k):
                if not fails[0]:
                    fails[0] += 1
                    raise RuntimeError("injected scatter fault")
                return real(*a, **k)

            eng._page_scatter_fn = once
            before = eng.snapshot()["kv_tier_load_failures"]
            assert eng.submit(prompt, 6, 0.0, timeout=300) == want
            _wait_until(lambda: eng.snapshot()["active_rows"] == 0)
            snap = eng.snapshot()
            assert snap["kv_tier_load_failures"] == before + 1
            assert _balanced(snap)
            _pressure(eng, (85, 86, 87))
            assert eng.submit(prompt, 6, 0.0, timeout=300) == want
            assert eng.snapshot()["kv_tier_promoted_pages"] > 0
        finally:
            eng.close()

    def test_refcount_balance_and_explicit_promotion(self, setup):
        _, pm = setup
        eng = _engine(pm, kv_pages=8, kv_host_bytes=1 << 20)
        try:
            _pressure(eng, (21, 22, 23, 24))
            _wait_until(lambda: eng.snapshot()["active_rows"] == 0)
            snap = eng.snapshot()
            assert snap["kv_tier_demoted_pages"] > 0 and _balanced(snap)
            toks = rand_prompt(21, 26)[0]
            probe = eng.tier_probe(toks)
            assert probe["page_size"] == PAGE
            resident = probe["hbm_pages"] + probe["host_pages"]
            assert resident == 3 and probe["host_pages"] >= 1
            assert eng.promote_prefix_pages(toks) == probe["host_pages"]
            assert eng.tier_probe(toks)["hbm_pages"] == 3
            assert _balanced(eng.snapshot())
        finally:
            eng.close()
        assert eng.snapshot()["kv_pages_in_use"] == 0

    def test_tier_load_cost_ema_and_probe(self, setup):
        _, pm = setup
        eng = _engine(pm, kv_pages=8, kv_host_bytes=1 << 20)
        try:
            assert eng._should_tier_load(kvtier.HOST, 2)
            with eng._cv:
                eng._tier_bps[kvtier.HOST] = 1.0
                eng._tier_n[kvtier.HOST] = 2
                eng._tier_page_bytes = 1e6
            skips = [eng._should_tier_load(kvtier.HOST, 2) for _ in range(8)]
            assert skips == [False] * 7 + [True]
            assert eng.snapshot()["kv_tier_load_skipped"] == 7
            assert eng._should_tier_load(kvtier.DISK, 2)
            eng._note_tier_load(kvtier.DISK, 4096, 0.001)
            with eng._cv:
                assert kvtier.DISK not in eng._tier_bps
            eng._note_tier_load(kvtier.DISK, 4096, 0.001)
            with eng._cv:
                assert eng._tier_bps[kvtier.DISK] > 0
        finally:
            eng.close()

    def test_no_tier_without_the_prefix_cache(self, setup, tmp_path):
        _, pm = setup
        for kw in (dict(paged=False), dict(prefix_cache=False)):
            eng = _engine(pm, kv_host_bytes=1 << 20, **kw)
            try:
                assert eng._tier is None
                assert "kv_tier_host_entries" not in eng.snapshot()
            finally:
                eng.close()
