"""Fused multi-step decode in the port (decode_steps > 1) against the
reference on the same numpy-drawn weights.

Seams: models/generate.py `paged_decode_steps` and models/quant_generate
.py `quant_paged_engine_decode_steps` at n_steps 1, 2 and 4 against the
reference's (tokens equal, written pool slots within tolerance), and
equal to n_steps calls of the port's one-step seam.

Engine: the twin of the reference's TestFusedDecode and TestFusedChaos
(tests/test_paged_attention.py) at decode_steps 2 and 4, held to the
reference engine at the same setting: greedy parity through staggered
arrivals and slot recycling (bf16 and int8), fewer commits than tokens
with max_new landing inside a block, a stop token mid-block, cancel at a
block commit, sampled rows falling through to one-token turns, paged=
False forcing fused decode off, and a fault mid-block that drains the
block and rebuilds clean.  On the CPU a block is the seam called
directly; the CUDA-graph replay of serving/decode_graph.py runs only on
the card (chip_smoke.py)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    CFG, PAGE, draw_params, jax_decoder, jax_params, port_model,
    rand_prompt,
)
from container_engine_accelerators_tpu.models import generate as G
from container_engine_accelerators_tpu.models import quant_generate as QG
from container_engine_accelerators_tpu.serving import (
    ContinuousBatchingEngine as JaxEngine,
)
from container_engine_accelerators_tpu_torch.models import (
    generate as TG,
)
from container_engine_accelerators_tpu_torch.models import (
    quant_generate as TQG,
)
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
    EngineSupervisor,
)

ATOL = 1e-4
# Int8 pools, in int8 steps of each slot's own scale (max|k| / 127):
# the first block's bf16 activations match the reference's, but the
# second block's differ by a bf16 ulp (the int8 matmuls sum in another
# order), which can move a value's rounding by up to two steps.
POOL_STEPS = 2
QUANT = pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
SHAPES = [(21, 3, 6), (22, 7, 3), (23, 17, 8), (24, 9, 2), (25, 25, 5),
          (26, 6, 12)]


@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return params, jax_decoder(), jax_params(params), port_model(params)


@pytest.fixture(scope="module")
def reference():
    """Greedy tokens of the reference's engine: one engine per option set
    for the whole module, each request run once (alone, so batching
    cannot matter: the reference engine is bit-exact to its oracle)."""
    params = draw_params(0)
    engines, memo = {}, {}

    def tokens(seed, p_len, n, stop_token=None, **opts):
        key = (seed, p_len, n, stop_token, tuple(sorted(opts.items())))
        if key not in memo:
            ek = tuple(sorted(opts.items()))
            if ek not in engines:
                opts.setdefault("prompt_grid", 4)
                opts.setdefault("prefill_chunk", PAGE)
                if opts.get("paged", True):
                    opts.setdefault("page_size", PAGE)
                engines[ek] = JaxEngine(
                    jax_decoder(), jax_params(params), 2, observe=False,
                    **opts,
                )
            memo[key] = engines[ek].submit(
                rand_prompt(seed, p_len), n, 0.0, stop_token=stop_token,
                timeout=300,
            )
        return memo[key]

    yield tokens
    for eng in engines.values():
        eng.close()


def _gen():
    return torch.Generator()


# -- seams ------------------------------------------------------------------
N_PAGES = 13


@pytest.fixture(scope="module")
def admitted(setup):
    """Three rows admitted into a paged pool through the final-chunk
    seam in both packages, bf16 path and int8: (jax cache, port cache,
    reference weights, port weights, tokens, positions, block tables)."""
    _, dec, jp, pm = setup
    per_row = CFG["max_seq"] // PAGE
    bt = np.zeros((3, per_row), np.int32)
    bt[0, :4] = [1, 2, 3, 4]
    bt[1, :4] = [5, 6, 7, 8]
    bt[2, :4] = [9, 10, 11, 12]
    out = {}
    for quant in (False, True):
        if quant:
            qp_j = QG.quantize_decode_params(jp)
            deq_j = QG.dequantize_decode_params(qp_j, jp)
            qp_t = TQG.quantize_decode_params(pm)
            deq_t = TQG.dequantize_decode_params(qp_t, pm)
            jcache = QG.init_quant_paged_cache(dec, N_PAGES, PAGE)
            tcache = TQG.init_quant_paged_cache(pm, N_PAGES, PAGE,
                                                device="cpu")
        else:
            qp_j, qp_t = jp, pm
            jcache = G.init_paged_cache(dec, N_PAGES, PAGE)
            tcache = TG.init_paged_cache(pm, N_PAGES, PAGE, device="cpu")
        toks, plens = [], []
        for row, (seed, p_len) in enumerate([(1, 11), (2, 7), (3, 14)]):
            chunk = np.zeros((1, 16), np.int32)
            chunk[0, :p_len] = rand_prompt(seed, p_len)[0]
            args = (jnp.int32(0), jnp.int32(0), jnp.int32(p_len),
                    jnp.float32(0.0), jax.random.PRNGKey(0))
            if quant:
                jcache, jt = QG.quant_paged_prefill_finish(
                    dec, deq_j, qp_j, jcache, G.init_decode_cache(dec, 1),
                    jnp.asarray(chunk), jnp.asarray(bt[row]), *args,
                )
                tcache, tt = TQG.quant_paged_prefill_finish(
                    deq_t, qp_t, tcache,
                    TG.init_decode_cache(deq_t, 1, device="cpu"), chunk,
                    bt[row], 0, 0, p_len, 0.0, _gen(),
                )
            else:
                jcache, jt = G.paged_prefill_finish(
                    dec, jp, jcache, G.init_decode_cache(dec, 1),
                    jnp.asarray(chunk), jnp.asarray(bt[row]), *args,
                )
                tcache, tt = TG.paged_prefill_finish(
                    pm, tcache, TG.init_decode_cache(pm, 1, device="cpu"),
                    chunk, bt[row], 0, 0, p_len, 0.0, _gen(),
                )
            assert int(tt[0]) == int(jt[0])
            toks.append(int(tt[0]))
            plens.append(p_len)
        out[quant] = (jcache, tcache, qp_j, qp_t,
                      np.array(toks, np.int32), np.array(plens, np.int32),
                      bt)
    return out


def _clone(cache):
    return [{k: v.clone() for k, v in blk.items()} for blk in cache]


def _pools(jcache, quant, name):
    """[(pool, scale)] of every reference block: the (n_pages, page, h,
    d) f32 pool `name` (dequantized for int8) and its (n_pages, page, h,
    1) int8 step (None for the float pool)."""
    if quant:
        return [(np.asarray(c[name], np.float32) * np.asarray(
            c[f"{name}_scale"])[..., None],
                 np.asarray(c[f"{name}_scale"])[..., None]) for c in jcache]
    key = {"k": "cached_key", "v": "cached_value"}[name]
    return [(np.asarray(jcache[f"block_{i}"][key]), None)
            for i in range(CFG["depth"])]


def _port_pools(tcache, quant, name):
    if quant:
        return [(c[name].float().numpy() * c[f"{name}_scale"].numpy()[
            ..., None], c[f"{name}_scale"].numpy()[..., None])
            for c in tcache]
    return [(c[name].numpy(), None) for c in tcache]


def _assert_pool_close(got, want, where=(...,)):
    """Within ATOL (float pools), or within POOL_STEPS int8 steps of the
    larger of the two slots' scales (int8 pools)."""
    (g, gs), (w, ws) = got, want
    if gs is None:
        np.testing.assert_allclose(g[where], w[where], atol=ATOL)
        return
    tol = POOL_STEPS * np.maximum(gs, ws)[where] * (1 + 1e-6)
    bad = np.abs(g[where] - w[where]) > tol
    assert not bad.any(), (np.abs(g[where] - w[where]) / tol).max()


@QUANT
@pytest.mark.parametrize("n_steps", [1, 2, 4])
def test_steps_seam_matches_reference(setup, admitted, quant, n_steps):
    # Rows 0 and 2 advance n_steps chained steps, row 1 stays inactive:
    # the (B, n_steps) tokens equal the reference's, and every pool
    # slot the chain wrote matches.
    dec = setup[1]
    jcache, tcache, qp_j, qp_t, tok, pos, bt = admitted[quant]
    tcache = _clone(tcache)
    active = np.array([True, False, True])
    temps = np.zeros(3, np.float32)
    if quant:
        jc, jt = QG.quant_paged_engine_decode_steps(
            qp_j, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(bt), jnp.asarray(temps),
            jax.random.PRNGKey(0), CFG["heads"], n_steps,
        )
        tc, tt = TQG.quant_paged_engine_decode_steps(
            qp_t, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(bt),
            torch.from_numpy(temps), _gen(), CFG["heads"], n_steps,
        )
    else:
        jc, jt = G.paged_decode_steps(
            dec, qp_j, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(bt), jnp.asarray(temps),
            jax.random.PRNGKey(0), n_steps,
        )
        tc, tt = TG.paged_decode_steps(
            qp_t, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(bt),
            torch.from_numpy(temps), _gen(), n_steps,
        )
    jt = np.asarray(jt)
    assert tt.shape == (3, n_steps) and tt.dtype == torch.int32
    assert np.array_equal(tt.numpy()[active], jt[active])
    for name in ("k", "v"):
        for got, want in zip(_port_pools(tc, quant, name),
                             _pools(jc, quant, name)):
            for row in np.flatnonzero(active):
                for j in range(n_steps):
                    p = pos[row] + j
                    _assert_pool_close(
                        got, want, (bt[row, p // PAGE], p % PAGE))
            _assert_pool_close(got, want)


@QUANT
def test_steps_seam_equals_chained_single_steps(admitted, quant, setup):
    # The 4-step chain is exactly 4 calls of the one-step seam, each fed
    # the last token and pos + 1: tokens and pools bitwise equal.
    pm = setup[3]
    _, tcache, _, qp_t, tok, pos, bt = admitted[quant]
    active = torch.tensor([True, True, False])
    temps = torch.zeros(3)
    ca, cb = _clone(tcache), _clone(tcache)
    args = (torch.from_numpy(tok), torch.from_numpy(pos), active,
            torch.from_numpy(bt), temps, _gen())
    if quant:
        ca, toks = TQG.quant_paged_engine_decode_steps(
            qp_t, ca, *args, CFG["heads"], 4)
    else:
        ca, toks = TG.paged_decode_steps(pm, ca, *args, 4)
    t, p = torch.from_numpy(tok), torch.from_numpy(pos)
    cols = []
    for _ in range(4):
        if quant:
            cb, t = TQG.quant_paged_engine_decode_step(
                qp_t, cb, t, p, active, torch.from_numpy(bt), temps, _gen(),
                CFG["heads"])
        else:
            cb, t = TG.paged_decode_step(
                pm, cb, t, p, active, torch.from_numpy(bt), temps, _gen())
        cols.append(t)
        p = p + 1
    assert torch.equal(toks, torch.stack(cols, dim=1))
    assert len(set(toks[:2].flatten().tolist())) > 1
    for a, b in zip(ca, cb):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_steps_seam_rejects_zero_steps(setup, admitted):
    _, tcache, _, pm, tok, pos, bt = admitted[False]
    with pytest.raises(ValueError, match="n_steps"):
        TG.paged_decode_steps(
            pm, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.ones(3, dtype=torch.bool), torch.from_numpy(bt),
            torch.zeros(3), _gen(), 0,
        )


# -- engine -----------------------------------------------------------------
def _engine(pm, slots, k=4, **kw):
    kw.setdefault("prompt_grid", 4)
    kw.setdefault("prefill_chunk", PAGE)
    kw.setdefault("page_size", PAGE)
    return ContinuousBatchingEngine(pm, slots, decode_steps=k,
                                    device="cpu", **kw)


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


@pytest.mark.parametrize("k", [2, 4])
@QUANT
def test_greedy_parity_staggered_with_slot_recycling(setup, reference,
                                                     quant, k):
    # 6 staggered requests through 2 slots: quiet stretches fuse,
    # admissions and tails fall through to one-token turns, slots
    # recycle; every row equals the reference engine at the same
    # decode_steps.
    pm = setup[3]
    eng = _engine(pm, 2, k=k, quant=quant)
    try:
        outs = _fire_staggered(eng, SHAPES)
        snap = eng.snapshot()
    finally:
        eng.close()
    for seed, p_len, n in SHAPES:
        want = reference(seed, p_len, n, quant=quant, decode_steps=k)
        assert outs[seed] == want, (seed, outs[seed], want)
    assert snap["fused_blocks"] > 0 and snap["fused_tokens"] > 0, snap
    assert snap["fused_steps"] >= 2 * snap["fused_blocks"]
    assert snap["kv_pages_in_use"] == snap["prefix_cached_pages"]


@pytest.mark.parametrize("pipeline", [True, False], ids=["lag", "sync"])
def test_round_trip_reduction_and_max_new_at_block_commit(
        setup, reference, pipeline):
    # A lone request on a quiet 4-slot engine: commits (host round
    # trips) drop well below the token count, and max_new lands inside
    # a block: the commit stops exactly at the budget.
    pm = setup[3]
    eng = _engine(pm, 4, pipeline=pipeline)
    try:
        out = eng.submit(rand_prompt(31, 8), 14, 0.0, timeout=300)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert out == reference(31, 8, 14, decode_steps=4)
    assert len(out[0]) == 14
    assert snap["fused_blocks"] >= 2
    # 14 tokens: 1 from the prefill, 13 decoded.
    assert snap["steps"] <= 13 - snap["fused_tokens"] + snap["fused_blocks"]
    assert snap["steps"] < 13


def test_stop_token_mid_block(setup, reference):
    # The solo run's blocks cover tokens 1-4, 5-8 and 9-12; a stop token
    # first seen at token 10 or 11 ends the row inside the third block,
    # and the block's tail is discarded.
    pm = setup[3]
    p = rand_prompt(52, 6)
    want = reference(52, 6, 14, decode_steps=4)[0]
    cut = next(j for j in (10, 11) if want[j] not in want[:j])
    eng = _engine(pm, 2)
    try:
        out = eng.submit(p, 14, 0.0, stop_token=want[cut], timeout=300)
        assert eng.snapshot()["fused_blocks"] >= 3
    finally:
        eng.close()
    assert out == [want[:cut + 1]]
    assert out == reference(52, 6, 14, stop_token=want[cut], decode_steps=4)


def test_cancel_applies_at_block_commit(setup, reference):
    # Cancel while blocks are in flight: the row retires at a commit
    # (never resurrected by its block), its pages return, and the next
    # request is exact.
    pm = setup[3]
    eng = _engine(pm, 2, prefix_cache=False)
    seen = []

    def slow_observer(r, t):
        seen.append(t)
        time.sleep(0.01)

    try:
        h = eng.submit_nowait(rand_prompt(44, 5), 40, 0.0,
                              on_token=slow_observer)
        deadline = time.monotonic() + 60
        while len(seen) < 4 and time.monotonic() < deadline:
            time.sleep(0.002)
        h.cancel()
        with pytest.raises(RuntimeError, match="cancelled"):
            h.wait(timeout=60)
        deadline = time.monotonic() + 60
        while eng.active_rows and time.monotonic() < deadline:
            time.sleep(0.005)
        n_seen = len(seen)
        snap = eng.snapshot()
        assert snap["kv_pages_in_use"] == 0, snap
        assert snap["fused_blocks"] > 0, snap
        assert eng.submit(rand_prompt(45, 7), 6, 0.0, timeout=300) == (
            reference(45, 7, 6, decode_steps=4)
        )
    finally:
        eng.close()
    assert 4 <= n_seen < 40


def test_sampled_rows_fall_through_to_one_token_turns(setup):
    pm = setup[3]
    eng = _engine(pm, 2)
    try:
        out = eng.submit(rand_prompt(46, 6), 10, 0.9, timeout=300)
        greedy_topk = eng.submit(rand_prompt(47, 6), 6, 0.0, top_k=3,
                                 timeout=300)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert len(out[0]) == 10 and len(greedy_topk[0]) == 6
    assert snap["fused_blocks"] == snap["fused_tokens"] == 0
    assert snap["steps"] > 0


def test_non_paged_engine_forces_fused_off(setup, reference):
    pm = setup[3]
    eng = ContinuousBatchingEngine(
        pm, 2, paged=False, prompt_grid=4, prefill_chunk=PAGE,
        decode_steps=4, device="cpu",
    )
    try:
        assert eng._decode_steps == 0
        assert eng._fused_fn is None
        out = eng.submit(rand_prompt(48, 5), 6, 0.0, timeout=300)
        assert eng.snapshot()["fused_blocks"] == 0
    finally:
        eng.close()
    assert out == reference(48, 5, 6, paged=False, decode_steps=4)


@QUANT
def test_fault_mid_block_drains_block_and_rebuilds_clean(setup, reference,
                                                         quant):
    # A persistent failure of the second fused block: the block drains
    # uncommitted (no token reaches the stream after it), the row fails
    # alone, the revived engine holds no page, fuses again and serves
    # the reference engine's tokens.
    pm = setup[3]
    eng = _engine(pm, 2, quant=quant, step_retries=0, retry_backoff_s=0.01)
    sup = EngineSupervisor(eng, max_restarts=3).start()
    real, calls = eng._fused_fn, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected fused-decode fault")
        return real(*a, **k)

    eng._fused_fn = flaky
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
        time.sleep(0.1)  # a late block commit would land here
        assert len(seen) == failed_at < 16
        snap = eng.snapshot()
        assert snap["restarts"] >= 1 and snap["step_failures"] == 1, snap
        assert snap["kv_pages_in_use"] == 0, snap
        blocks = snap["fused_blocks"]
        assert eng.submit(rand_prompt(96, 9), 8, 0.0, timeout=300) == (
            reference(96, 9, 8, quant=quant, decode_steps=4)
        )
        assert eng.snapshot()["fused_blocks"] > blocks
    finally:
        sup.stop()
        eng.close()
    assert eng.snapshot()["kv_pages_in_use"] == 0


@QUANT
def test_block_tail_past_max_seq_is_dead(setup, reference, quant):
    # prompt + max_new == max_seq: the last block is dispatched on a
    # stale budget and runs past the last position (the gate reads the
    # budget before the outstanding block commits, as the reference's
    # does); its tail reads the clamped positional row and writes the
    # null page, and only the budget's tokens are committed.
    # Budget 23: blocks commit tokens 1-4, ..., 17-20, and the block
    # dispatched after the commit of token 20 (on the budget read at
    # token 16) covers positions p + 20 .. p + 23 = max_seq.
    pm = setup[3]
    n = 23
    p_len = CFG["max_seq"] - n
    eng = _engine(pm, 2, quant=quant, prefix_cache=False)
    try:
        out = eng.submit(rand_prompt(71, p_len), n, 0.0, timeout=300)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert snap["fused_steps"] + snap["steps"] - snap["fused_blocks"] > n - 1
    assert out == reference(71, p_len, n, quant=quant, decode_steps=4)
    assert snap["kv_pages_in_use"] == 0
