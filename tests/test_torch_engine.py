"""The port's continuous-batching engine (container_engine_accelerators_
tpu_torch/serving/engine.py) on its default paged path, bf16 and int8,
against the reference engine and the solo oracles on the same
numpy-drawn weights: greedy parity through retire and refill, page and
chunk boundaries, prefix hits, copy-on-write isolation, stop / cancel /
max_new, the admission bound, the lag window against synchronous
commits, and supervised revival leaving no page allocated.  The twin of
the core cases of tests/test_paged_engine.py and
tests/test_continuous_engine.py."""

import threading
import time

import pytest
import torch

from _torch_port import (
    CFG, PAGE, draw_params, jax_decoder, jax_params, port_model,
    rand_prompt,
)
from container_engine_accelerators_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine,
)
from container_engine_accelerators_tpu_torch.models import (
    generate as TG,
)
from container_engine_accelerators_tpu_torch.models import (
    quant_generate as TQG,
)
from container_engine_accelerators_tpu_torch.parallel.mesh import LocalMesh
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
    EngineSupervisor,
    QueueFullError,
)

QUANT = pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])


@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return params, port_model(params)


def _engine(pm, slots, **kw):
    kw.setdefault("prompt_grid", 4)
    kw.setdefault("prefill_chunk", PAGE)
    kw.setdefault("page_size", PAGE)
    return ContinuousBatchingEngine(pm, slots, device="cpu", **kw)


def _solo(pm, prompt, n, quant=False):
    fn = TQG.generate_prefill_quant if quant else TG.generate_prefill
    return fn(pm, prompt, prompt.shape[1], n, 0.0,
              torch.Generator())[0].tolist()


SHAPES = [(11, 3, 6), (12, 7, 3), (13, 17, 8), (14, 9, 2), (15, 25, 5),
          (16, 6, 4)]


def _fire_staggered(eng, shapes):
    outs = {}

    def fire(seed, p_len, n):
        outs[seed] = eng.submit(rand_prompt(seed, p_len), n, 0.0,
                                timeout=300)

    threads = [threading.Thread(target=fire, args=s) for s in shapes]
    for t in threads:
        t.start()
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return outs


class TestParity:
    @QUANT
    def test_greedy_parity_with_retire_and_refill(self, setup, quant):
        # 6 staggered mixed-length requests through 2 slots (prefix
        # cache on): each output equals the port's solo oracle AND the
        # reference engine on the same weights.
        params, pm = setup
        eng = _engine(pm, 2, quant=quant)
        try:
            outs = _fire_staggered(eng, SHAPES)
            snap = eng.snapshot()
        finally:
            eng.close()
        jeng = JaxEngine(
            jax_decoder(), jax_params(params), 2, quant=quant,
            prompt_grid=4, prefill_chunk=PAGE, page_size=PAGE,
            observe=False,
        )
        try:
            tokens = set()
            for seed, p_len, n in SHAPES:
                p = rand_prompt(seed, p_len)
                want = _solo(pm, p, n, quant)
                tokens.update(want)
                assert outs[seed] == [want], (seed, outs[seed], want)
                assert jeng.submit(p, n, 0.0, timeout=300) == [want]
            assert len(tokens) > 3, tokens
        finally:
            jeng.close()
        assert snap["admitted"] == snap["retired"] == 6
        assert snap["max_active"] <= 2
        assert snap["kv_pages_in_use"] == snap["prefix_cached_pages"]

    @QUANT
    def test_page_and_chunk_boundaries(self, setup, quant):
        # Prompt lengths straddling page/chunk edges (page == chunk ==
        # 8), prefix cache off: exact, and the pool drains to zero.
        _, pm = setup
        eng = _engine(pm, 2, quant=quant, prefix_cache=False)
        try:
            for seed, p_len, n in [(21, 7, 4), (22, 8, 4), (23, 9, 4),
                                   (24, 16, 3), (25, 17, 3)]:
                p = rand_prompt(seed, p_len)
                assert eng.submit(p, n, 0.0, timeout=300) == [
                    _solo(pm, p, n, quant)
                ], (seed, p_len)
            snap = eng.snapshot()
            assert snap["kv_pages_in_use"] == 0
            assert snap["prefix_hits"] == 0
        finally:
            eng.close()

    def test_int8_weights_with_float_kv(self, setup):
        # quant_kv=False: int8 weights, KV pool in the model's dtype —
        # held to the int8 oracle with the same KV layout.
        _, pm = setup
        eng = _engine(pm, 2, quant=True, quant_kv=False)
        try:
            for seed, p_len, n in [(26, 9, 5), (27, 17, 4)]:
                p = rand_prompt(seed, p_len)
                want = TQG.generate_prefill_quant(
                    pm, p, p_len, n, 0.0, torch.Generator(), quant_kv=False
                )[0].tolist()
                assert eng.submit(p, n, 0.0, timeout=300) == [want]
        finally:
            eng.close()

    @QUANT
    def test_lag_window_matches_synchronous_commits(self, setup, quant):
        _, pm = setup
        outs = []
        for pipeline in (True, False):
            eng = _engine(pm, 2, quant=quant, pipeline=pipeline)
            try:
                outs.append(_fire_staggered(eng, SHAPES[:4]))
            finally:
                eng.close()
        assert outs[0] == outs[1]


class TestPrefixCache:
    def test_prefix_hit_skips_prefill_and_stays_exact(self, setup):
        _, pm = setup
        eng = _engine(pm, 2)
        try:
            p = rand_prompt(41, 24)  # 3 full pages
            cold = eng.submit(p, 5, 0.0, timeout=300)
            chunks_cold = eng.snapshot()["prefill_chunks"]
            warm = eng.submit(p, 5, 0.0, timeout=300)
            snap = eng.snapshot()
            chunks_warm = snap["prefill_chunks"] - chunks_cold
            assert warm == cold == [_solo(pm, p, 5)]
            assert chunks_warm < chunks_cold - chunks_warm
            assert snap["prefix_hits"] == 1
            assert snap["prefix_hit_tokens"] >= 16
        finally:
            eng.close()

    def test_admission_wiring_fault_returns_its_page_references(self, setup):
        # A raise while the admission wires its block table (after it
        # referenced the matched prefix pages and took private ones)
        # gives every reference back before it propagates, as the
        # reference engine's guard does: the pool's free count returns
        # to its value before the admission.
        _, pm = setup
        eng = _engine(pm, 2)
        try:
            p = rand_prompt(43, 24)
            eng.submit(p, 2, 0.0, timeout=300)  # seeds the trie
            free = eng._pool.free_count

            def boom(*a, **k):
                raise RuntimeError("injected wiring fault")

            eng._plan_chunks = boom
            with pytest.raises(RuntimeError, match="wiring fault"):
                eng.submit(p, 4, 0.0, timeout=60)
            assert eng._pool.free_count == free
            snap = eng.snapshot()
            assert snap["kv_pages_in_use"] == snap["prefix_cached_pages"]
        finally:
            eng.close()

    def test_int8_prefix_hit_matches_reference_engine(self, setup):
        # A warm int8 admission re-attends over DEQUANTIZED prefix
        # pages (tolerance-bounded against the cold run in both
        # packages), so it is held to the reference engine's warm run.
        params, pm = setup
        p = rand_prompt(42, 24)
        eng = _engine(pm, 2, quant=True)
        try:
            got = [eng.submit(p, 6, 0.0, timeout=300) for _ in range(2)]
            assert eng.snapshot()["prefix_hits"] == 1
        finally:
            eng.close()
        jeng = JaxEngine(
            jax_decoder(), jax_params(params), 2, quant=True,
            prompt_grid=4, prefill_chunk=PAGE, page_size=PAGE,
            observe=False,
        )
        try:
            want = [jeng.submit(p, 6, 0.0, timeout=300) for _ in range(2)]
        finally:
            jeng.close()
        assert got == want

    def test_cow_divergence_never_mutates_shared_pages(self, setup):
        _, pm = setup
        eng = _engine(pm, 2)
        try:
            a = rand_prompt(51, 32)
            out_a = eng.submit(a, 5, 0.0, timeout=300)
            assert out_a == [_solo(pm, a, 5)]
            b = a.copy()
            b[0, 29:] = (b[0, 29:] + 7) % CFG["vocab"]
            assert eng.submit(b, 5, 0.0, timeout=300) == [_solo(pm, b, 5)]
            assert eng.snapshot()["cow_copies"] == 1
            assert eng.submit(a, 5, 0.0, timeout=300) == out_a
        finally:
            eng.close()


class TestRequestControl:
    @QUANT
    def test_stop_token_retires_early(self, setup, quant):
        _, pm = setup
        eng = _engine(pm, 2, quant=quant)
        try:
            p = rand_prompt(61, 9)
            base = eng.submit(p, 10, 0.0, timeout=300)[0]
            k = next(i for i in range(1, 10) if base[i] not in base[:i])
            early = eng.submit(p, 10, 0.0, stop_token=base[k],
                               timeout=300)[0]
            assert early == base[:k + 1]
        finally:
            eng.close()

    def test_cancel_and_max_new(self, setup):
        _, pm = setup
        eng = _engine(pm, 1)
        try:
            seen = []
            h = eng.submit_nowait(
                rand_prompt(62, 9), 40, 0.0,
                on_token=lambda r, t: (seen.append(t), time.sleep(0.01)),
            )
            deadline = time.monotonic() + 60
            while len(seen) < 3 and time.monotonic() < deadline:
                time.sleep(0.005)
            h.cancel()
            with pytest.raises(RuntimeError, match="cancelled"):
                h.wait(timeout=60)
            p = rand_prompt(63, 5)
            out = eng.submit(p, 7, 0.0, timeout=300)
            assert out == [_solo(pm, p, 7)] and len(out[0]) == 7
            snap = eng.snapshot()
            assert len(seen) < 40
            assert snap["kv_pages_in_use"] == snap["prefix_cached_pages"]
        finally:
            eng.close()

    def test_queue_full_error(self, setup):
        _, pm = setup
        eng = _engine(pm, 1, max_queue=1)
        try:
            blocker = eng.submit_nowait(
                rand_prompt(64, 5), 30, 0.0,
                on_token=lambda r, t: time.sleep(0.01),
            )
            deadline = time.monotonic() + 60
            while not blocker.admitted and time.monotonic() < deadline:
                time.sleep(0.005)
            queued = eng.submit_nowait(rand_prompt(65, 5), 2, 0.0)
            with pytest.raises(QueueFullError):
                eng.submit_nowait(rand_prompt(66, 5), 2, 0.0)
            assert eng.snapshot()["queue_rejected"] == 1
            blocker.wait(timeout=300)
            queued.wait(timeout=300)
        finally:
            eng.close()


class TestFailures:
    @QUANT
    def test_crash_then_revive_leaves_no_pages(self, setup, quant):
        # A persistent decode failure kills the scheduler mid-request
        # (pages allocated, prefixes retained); the supervisor's revival
        # leaves zero pages in use, and the revived engine serves exact.
        _, pm = setup
        eng = _engine(pm, 2, quant=quant, step_retries=0,
                      retry_backoff_s=0.01)
        sup = EngineSupervisor(eng, max_restarts=3).start()
        real, calls = eng._decode_fn, []

        def flaky(*a, **k):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected decode fault")
            return real(*a, **k)

        eng._decode_fn = flaky
        try:
            p = rand_prompt(95, 20)
            eng.submit(p, 2, 0.0, timeout=300)  # seeds the trie
            with pytest.raises(RuntimeError):
                eng.submit(p, 12, 0.0, timeout=300)
            deadline = time.monotonic() + 30
            while (time.monotonic() < deadline
                   and eng.snapshot()["restarts"] < 1):
                time.sleep(0.02)
            snap = eng.snapshot()
            assert snap["restarts"] >= 1, snap
            assert snap["kv_pages_in_use"] == 0, snap
            assert snap["prefix_cached_pages"] == 0, snap
            q = rand_prompt(96, 12)
            assert eng.submit(q, 4, 0.0, timeout=300) == [
                _solo(pm, q, 4, quant)
            ]
        finally:
            sup.stop()
            eng.close()

    def test_kill_fails_everything_and_releases_pages(self, setup):
        _, pm = setup
        eng = _engine(pm, 1)
        try:
            h = eng.submit_nowait(
                rand_prompt(97, 9), 30, 0.0,
                on_token=lambda r, t: time.sleep(0.01),
            )
            deadline = time.monotonic() + 60
            while not h.admitted and time.monotonic() < deadline:
                time.sleep(0.005)
            eng.kill(RuntimeError("budget exhausted"))
            with pytest.raises(RuntimeError, match="budget"):
                h.wait(timeout=60)
            with pytest.raises(RuntimeError, match="permanently"):
                eng.submit(rand_prompt(98, 4), 2, 0.0)
        finally:
            eng.close()
        assert eng.snapshot()["kv_pages_in_use"] == 0


class TestEntryPoints:
    def test_misuse_fails_fast(self, setup):
        params, pm = setup
        with pytest.raises(ValueError, match="decode=True"):
            ContinuousBatchingEngine(
                port_model(params, decode=False), 2, device="cpu"
            )
        eng = _engine(pm, 2)
        try:
            with pytest.raises(ValueError, match="max_seq"):
                eng.submit(rand_prompt(1, 60), 10, 0.0)
            with pytest.raises(ValueError, match="max_new"):
                eng.submit(rand_prompt(1, 4), 0, 0.0)
        finally:
            eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(rand_prompt(1, 4), 2, 0.0)

    @pytest.mark.parametrize("option,item", [
        (dict(spec_k=2), "A5e"), (dict(observe=True), "A5g"),
        (dict(kv_host_bytes=1 << 20), "A5f"), (dict(mesh=object()), "A10"),
    ])
    def test_later_slices_raise_not_implemented(self, setup, option, item):
        # Every option of these items is ported now, each builds an
        # engine: speculative decoding (A5e; a negative spec_k raises),
        # the KV tiers (A5f), observability (A5g) and a dp mesh (A10,
        # a parallel.mesh.LocalMesh; slots that do not divide raise).
        _, pm = setup
        if item == "A10":
            mesh = LocalMesh(["cpu", "cpu"])
            eng = _engine(pm, 2, mesh=mesh)
            try:
                assert eng._mesh is mesh and len(eng._cache) == 2
            finally:
                eng.close()
            with pytest.raises(ValueError, match="divide"):
                _engine(pm, 3, mesh=mesh)
            return
        if item == "A5e":
            _engine(pm, 2, **option).close()
            with pytest.raises(ValueError, match="spec_k"):
                _engine(pm, 2, spec_k=-1)
            return
        if item in ("A5f", "A5g"):
            eng = _engine(pm, 2, **option)
            try:
                assert eng.observability.enabled
                assert (eng._tier is not None) == (item == "A5f")
            finally:
                eng.close()
            return
        raise AssertionError(f"no case for {item}")

    def test_negative_decode_steps_raises(self, setup):
        _, pm = setup
        with pytest.raises(ValueError, match="decode_steps"):
            _engine(pm, 2, decode_steps=-1)

    def test_default_device_is_the_card(self, setup):
        # This box has no CUDA device: every entry point that defaults
        # to the card raises instead of running on the CPU.
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        _, pm = setup
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousBatchingEngine(pm, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TG.make_decoder(**CFG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TG.init_paged_cache(pm, 4, PAGE)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TQG.init_quant_paged_cache(pm, 4, PAGE)
