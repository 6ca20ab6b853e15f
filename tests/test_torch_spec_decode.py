"""Speculative decoding in the port's engine (spec_k > 0) against the
reference on the same numpy-drawn weights (f32): the twin of the
reference's tests/test_spec_decode.py and of its
`test_gate_falls_through_when_spec_is_active`
(tests/test_paged_attention.py), with tokens held to the reference's
solo oracles (bit-exact in f32, as the reference engine is), and one run
of the same traffic through both packages' speculative engines, whose
tokens and draft counters must agree.

On the CPU the draft chain and the verify window are the seams called
directly; their CUDA-graph replays (serving/decode_graph.py) run only on
the card (chip_smoke.py).  The spec counters and the depth gauge are
read from the engine's snapshot and, as the reference's metrics test
reads them, from its observability registry."""

import logging
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import (
    CFG, PAGE, draw_params, jax_decoder, jax_params, port_model,
    rand_prompt,
)
from container_engine_accelerators_tpu.models import generate as G
from container_engine_accelerators_tpu.models import quant_generate as QG
from container_engine_accelerators_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine,
)
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
    EngineSupervisor,
)

SPEC_K = 4


@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return params, port_model(params)


@pytest.fixture(scope="module")
def solo(setup):
    """The reference's greedy solo oracle (generate_prefill, or
    generate_prefill_quant for the int8 target), memoized."""
    params = setup[0]
    dec, jp = jax_decoder(), jax_params(params)
    memo = {}

    def tokens(seed, p_len, n, quant=False):
        key = (seed, p_len, n, quant)
        if key not in memo:
            fn = QG.generate_prefill_quant if quant else G.generate_prefill
            out = fn(dec, jp, jnp.asarray(rand_prompt(seed, p_len)), p_len,
                     n, 0.0, jax.random.PRNGKey(0))
            memo[key] = [int(t) for t in np.asarray(out)[0]]
        return memo[key]

    return tokens


def _spec_engine(pm, slots, **kw):
    kw.setdefault("prompt_grid", 4)
    kw.setdefault("prefill_chunk", PAGE)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("spec_k", SPEC_K)
    return ContinuousBatchingEngine(pm, slots, device="cpu", **kw)


def _break_drafter(eng, offset=1):
    """Make the drafter ALWAYS wrong: every chain's proposals shift by
    `offset` mod vocab.  Verify must reject every draft."""
    inner = eng._draft_fn

    def bad(qp, cache, inputs, n):
        cache, cols = inner(qp, cache, inputs, n)
        return cache, (cols + offset) % CFG["vocab"]

    eng._draft_fn = bad


# -- parity -----------------------------------------------------------------
def test_greedy_parity_contiguous_with_retire_and_refill(setup, solo):
    # 6 staggered mixed-length requests through 2 contiguous slots: slots
    # recycle mid-run and every output equals the oracle.
    pm = setup[1]
    eng = _spec_engine(pm, 2, paged=False)
    shapes = [(11, 3, 6), (12, 7, 3), (13, 17, 8), (14, 9, 2), (15, 25, 5),
              (16, 6, 4)]
    outs = {}

    def fire(seed, p_len, n):
        outs[seed] = eng.submit(rand_prompt(seed, p_len), n, 0.0,
                                timeout=300)

    try:
        threads = [threading.Thread(target=fire, args=s) for s in shapes]
        for t in threads:
            t.start()
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=300)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert len(outs) == 6
    for seed, p_len, n in shapes:
        assert outs[seed] == [solo(seed, p_len, n)], seed
    assert snap["admitted"] == snap["retired"] == 6
    assert snap["spec_drafted_tokens"] > 0
    assert snap["spec_accepted_tokens"] > 0


@pytest.mark.parametrize("pipeline", [True, False], ids=["lag", "sync"])
def test_greedy_parity_paged_with_prefix_hits(setup, solo, pipeline):
    # The paged engine with the radix prefix cache: a repeated prompt
    # admits through a prefix hit, then speculates; a divergent
    # continuation still matches (speculative writes never touch a
    # shared page).  With pipeline=False each window commits at once.
    pm = setup[1]
    eng = _spec_engine(pm, 2, pipeline=pipeline)
    try:
        p = rand_prompt(41, 24)  # 3 full pages
        cold = eng.submit(p, 6, 0.0, timeout=300)
        warm = eng.submit(p, 6, 0.0, timeout=300)
        want = solo(41, 24, 6)
        assert cold == warm == [want]
        assert eng.snapshot()["prefix_hits"] == 1
        b = p.copy()
        b[0, 20:] = (b[0, 20:] + 7) % CFG["vocab"]
        got_b = eng.submit(b, 6, 0.0, timeout=300)
        assert eng.submit(p, 6, 0.0, timeout=300) == [want]
        snap = eng.snapshot()
    finally:
        eng.close()
    dec, jp = jax_decoder(), jax_params(setup[0])
    want_b = G.generate_prefill(dec, jp, jnp.asarray(b), 24, 6, 0.0,
                                jax.random.PRNGKey(0))
    assert got_b == [[int(t) for t in np.asarray(want_b)[0]]]
    assert snap["spec_drafted_tokens"] > 0
    assert snap["kv_pages_in_use"] == snap["prefix_cached_pages"]


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_quant_target_parity(setup, solo, paged):
    # The int8 target: drafter and target share the quantized tree, and
    # outputs equal the reference's int8 oracle.
    pm = setup[1]
    eng = _spec_engine(pm, 2, quant=True, paged=paged, prefix_cache=False)
    try:
        for seed, p_len, n in [(31, 5, 6), (32, 17, 4)]:
            assert eng.submit(rand_prompt(seed, p_len), n, 0.0,
                              timeout=300) == [solo(seed, p_len, n, True)]
        assert eng.snapshot()["spec_drafted_tokens"] > 0
    finally:
        eng.close()


def test_always_wrong_drafter_stays_exact(setup, solo):
    # Every draft corrupted: every window commits only its bonus token,
    # and the outputs still equal the oracle.  Prompt length 7 puts the
    # first window across the page-8 boundary.
    pm = setup[1]
    eng = _spec_engine(pm, 1, spec_adaptive=False)
    _break_drafter(eng)
    try:
        assert eng.submit(rand_prompt(51, 7), 12, 0.0, timeout=300) == [
            solo(51, 7, 12)]
        snap = eng.snapshot()
    finally:
        eng.close()
    assert snap["spec_drafted_tokens"] > 0
    assert snap["spec_accepted_tokens"] == 0, snap
    assert snap["spec_rejected_tokens"] == snap["spec_drafted_tokens"]


def test_spec_off_is_the_identical_control(setup):
    # spec_k=0 and spec_k > 0 give the same greedy tokens.
    pm = setup[1]
    ctrl = _spec_engine(pm, 2, spec_k=0)
    spec = _spec_engine(pm, 2)
    try:
        for seed, p_len, n in [(61, 9, 8), (62, 20, 6)]:
            p = rand_prompt(seed, p_len)
            assert spec.submit(p, n, 0.0, timeout=300) == ctrl.submit(
                p, n, 0.0, timeout=300), seed
        assert "spec_drafted_tokens" in ctrl.snapshot()
        assert ctrl.snapshot()["spec_drafted_tokens"] == 0
        assert "spec_draft_depth" not in ctrl.snapshot()
        assert spec.snapshot()["spec_drafted_tokens"] > 0
    finally:
        ctrl.close()
        spec.close()


def test_stop_token_inside_window_retires_early(setup, solo):
    # A stop token committed mid-window retires the row at that token and
    # the window's tail is never committed; drafts past the stop are not
    # counted as accepted.
    pm = setup[1]
    want_full = solo(71, 5, 12)
    stop = want_full[3]
    want = want_full[: want_full.index(stop) + 1]
    eng = _spec_engine(pm, 1, paged=False)
    try:
        got = eng.submit(rand_prompt(71, 5), 12, 0.0, stop_token=stop,
                         timeout=300)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert got == [want]
    assert snap["spec_accepted_tokens"] <= len(want) - 1, snap


def test_spec_k1_is_the_one_token_engine(setup, solo):
    # spec_k=1: no draftable depth; every turn is a one-token turn (the
    # probe may not lift a row past spec_k), outputs exact, no drafts.
    pm = setup[1]
    eng = _spec_engine(pm, 1, paged=False, spec_k=1)
    try:
        assert eng.submit(rand_prompt(72, 5), 24, 0.0, timeout=300) == [
            solo(72, 5, 24)]
        snap = eng.snapshot()
    finally:
        eng.close()
    assert snap["spec_drafted_tokens"] == 0, snap
    assert snap["spec_verify_passes"] == 0, snap
    assert snap["restarts"] == 0, snap


def test_mixed_greedy_and_sampled_rows_alternate_turns(setup, solo):
    # A greedy and a sampled row at once: windows carry the sampled row at
    # width 1; the greedy row stays exact and both complete.
    pm = setup[1]
    eng = _spec_engine(pm, 2)
    outs = {}

    def greedy():
        outs["g"] = eng.submit(rand_prompt(73, 9), 16, 0.0, timeout=300)

    def sampled():
        outs["s"] = eng.submit(rand_prompt(74, 7), 16, 0.9, timeout=300)

    try:
        ths = [threading.Thread(target=greedy),
               threading.Thread(target=sampled)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
    finally:
        eng.close()
    assert outs["g"] == [solo(73, 9, 16)]
    assert len(outs["s"][0]) == 16


# -- adaptive depth ---------------------------------------------------------
def test_mispredicting_rows_throttle_toward_one(setup, solo):
    # An always-wrong drafter: the accept EMA collapses and the row's
    # depth halves to 1 (a probe may lift the gauge to 2); outputs exact
    # and far fewer drafts than a window of 4 every step would make.
    pm = setup[1]
    eng = _spec_engine(pm, 1, paged=False)
    _break_drafter(eng)
    try:
        assert eng.submit(rand_prompt(81, 5), 24, 0.0, timeout=300) == [
            solo(81, 5, 24)]
        snap = eng.snapshot()
    finally:
        eng.close()
    assert snap["spec_draft_depth"] <= 2, snap
    assert snap["spec_accepted_tokens"] == 0
    assert snap["spec_drafted_tokens"] < snap["steps"], snap


def test_accurate_drafter_keeps_full_depth(setup, solo):
    pm = setup[1]
    eng = _spec_engine(pm, 1, paged=False)
    try:
        assert eng.submit(rand_prompt(82, 5), 24, 0.0, timeout=300) == [
            solo(82, 5, 24)]
        snap = eng.snapshot()
    finally:
        eng.close()
    drafted = snap["spec_drafted_tokens"]
    assert drafted > 0
    assert snap["spec_accepted_tokens"] / drafted >= 0.6, snap
    assert snap["steps"] < 24, snap  # fewer target passes than tokens


def test_sampled_rows_never_speculate(setup):
    pm = setup[1]
    eng = _spec_engine(pm, 1, paged=False)
    try:
        out = eng.submit(rand_prompt(83, 5), 8, 0.9, timeout=300)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert len(out[0]) == 8
    assert snap["spec_drafted_tokens"] == 0


# -- metrics ----------------------------------------------------------------
def test_counters_and_depth_gauge(setup):
    # The spec counters and the draft-depth gauge in the engine snapshot:
    # rejected = drafted - accepted, each window one verify pass, each
    # chain as many drafter passes as its width, the gauge the last
    # dispatched width.  The counters, the accept-rate histogram and the
    # gauge ride the engine's registry onto /metrics, and the gauge
    # provider carries the depth.
    pm = setup[1]
    eng = _spec_engine(pm, 2)
    try:
        eng.submit(rand_prompt(91, 9), 8, 0.0, timeout=300)
        snap = eng.snapshot()
        text = eng.observability.registry.render()
        gauges = eng.observability.gauge_provider(eng)()
    finally:
        eng.close()
    for series in ("serve_engine_spec_drafted_tokens_total",
                   "serve_engine_spec_accepted_tokens_total",
                   "serve_engine_spec_rejected_tokens_total",
                   "serve_spec_accept_ratio_bucket",
                   "serve_engine_spec_draft_depth"):
        assert series in text, series
    assert gauges["serve_engine_spec_draft_depth"] == snap["spec_draft_depth"]
    assert snap["spec_drafted_tokens"] > 0
    assert (snap["spec_rejected_tokens"]
            == snap["spec_drafted_tokens"] - snap["spec_accepted_tokens"])
    assert snap["spec_draft_depth"] in eng._spec_buckets
    assert 0 < snap["spec_verify_passes"] <= snap["steps"]
    assert snap["spec_draft_chains"] <= snap["spec_verify_passes"]
    assert (2 * snap["spec_draft_chains"] <= snap["spec_draft_passes"]
            <= SPEC_K * snap["spec_draft_chains"])


# -- chaos ------------------------------------------------------------------
@pytest.mark.chaos
def test_kill_mid_verify_drains_block_and_rebuilds_clean(setup, solo):
    # A persistent verify failure: the window drains uncommitted (no
    # token reaches the stream after the failure), the rows fail alone,
    # the supervisor's rebuild holds no page and a zeroed drafter cache,
    # and the revived engine serves exact again.
    pm = setup[1]
    eng = _spec_engine(pm, 2, step_retries=0, retry_backoff_s=0.01)
    sup = EngineSupervisor(eng, max_restarts=3).start()
    real, calls = eng._verify_fn, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected verify fault")
        return real(*a, **k)

    eng._verify_fn = flaky
    seen = []
    try:
        with pytest.raises(RuntimeError):
            eng.submit(rand_prompt(95, 12), 16, 0.0, timeout=300,
                       on_token=lambda r, t: seen.append(t))
        failed_at = len(seen)
        deadline = time.monotonic() + 30
        while (time.monotonic() < deadline
               and eng.snapshot()["restarts"] < 1):
            time.sleep(0.02)
        time.sleep(0.1)  # a late commit would land here
        assert len(seen) == failed_at < 16
        snap = eng.snapshot()
        assert snap["restarts"] >= 1 and snap["step_failures"] == 1, snap
        assert snap["kv_pages_in_use"] == 0, snap
        assert not any(buf.any() for blk in eng._draft_cache
                       for buf in blk.values())
        drafted = snap["spec_drafted_tokens"]
        assert eng.submit(rand_prompt(96, 9), 6, 0.0, timeout=300) == [
            solo(96, 9, 6)]
        assert eng.snapshot()["spec_drafted_tokens"] > drafted
    finally:
        sup.stop()
        eng.close()


@pytest.mark.chaos
def test_draft_fault_degrades_without_failing_requests(setup, solo,
                                                       caplog):
    # A drafter fault is absorbed: that window drops to width 1, the
    # drafter cache is zeroed and refilled, and the request completes
    # exact: no ticket fails, no restart.  16 tokens take more than four
    # chains, so both planted faults fire.
    pm = setup[1]
    eng = _spec_engine(pm, 1, paged=False)
    real, calls = eng._draft_fn, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) in (1, 4):
            raise RuntimeError("injected draft fault")
        return real(*a, **k)

    eng._draft_fn = flaky
    try:
        with caplog.at_level(logging.WARNING):
            assert eng.submit(rand_prompt(97, 7), 16, 0.0, timeout=300) == [
                solo(97, 7, 16)]
        snap = eng.snapshot()
    finally:
        eng.close()
    assert snap["restarts"] == 0 and snap["rows_failed"] == 0
    assert len(calls) > 4
    assert sum("draft chain failed" in r.getMessage()
               for r in caplog.records) == 2


# -- against the reference's engine ----------------------------------------
def test_gate_falls_through_when_spec_is_active(setup, solo):
    # With decode_steps and spec_k both set, speculative windows own the
    # multi-token turns: drafts flow, no fused block dispatches.
    pm = setup[1]
    eng = _spec_engine(pm, 2, decode_steps=4)
    try:
        assert eng.submit(rand_prompt(47, 8), 12, 0.0, timeout=300) == [
            solo(47, 8, 12)]
        snap = eng.snapshot()
    finally:
        eng.close()
    assert snap["spec_drafted_tokens"] > 0
    assert snap["fused_blocks"] == 0 and snap["fused_tokens"] == 0


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_same_traffic_same_tokens_and_drafts_as_reference(setup, quant):
    # The same requests, one after another, through both packages'
    # paged speculative engines: equal tokens, and equal drafted and
    # accepted counts (the same windows were dispatched and accepted).
    params, pm = setup
    shapes = [(101, 5, 9), (102, 19, 7), (103, 11, 13)]
    kw = dict(quant=quant, prompt_grid=4, prefill_chunk=PAGE,
              page_size=PAGE, spec_k=SPEC_K)
    ref = JaxEngine(jax_decoder(), jax_params(params), 2, observe=False,
                    **kw)
    port = ContinuousBatchingEngine(pm, 2, device="cpu", **kw)
    try:
        for seed, p_len, n in shapes:
            p = rand_prompt(seed, p_len)
            assert port.submit(p, n, 0.0, timeout=300) == ref.submit(
                p, n, 0.0, timeout=300), seed
        snaps = ref.snapshot(), port.snapshot()
    finally:
        ref.close()
        port.close()
    for key in ("spec_drafted_tokens", "spec_accepted_tokens", "steps"):
        assert snaps[1][key] == snaps[0][key], key
    assert snaps[1]["spec_drafted_tokens"] > 0
