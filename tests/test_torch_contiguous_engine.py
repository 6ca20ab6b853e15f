"""The port's contiguous-slot serving path (paged=False) against the
reference on the same numpy-drawn weights: the per-row `write_pos`
decode forward of TransformerLM (one token and a window of three), the
contiguous admission and decode seams of models/generate.py and their
int8 twins in models/quant_generate.py (tokens every step, cache rows
within tolerance), and the paged=False engine's greedy tokens against
the reference engine's, bf16 and int8, with the lag window on and off,
and after a crash and a supervised revival."""

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
# Int8 caches: a k/v value within ATOL of the reference's may still
# round to the neighbouring int8 step, one scale (max|k| / 127) away.
STEP_ATOL = 3e-2
QUANT = pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
SHAPES = [(11, 3, 6), (12, 7, 3), (13, 17, 8), (14, 9, 2), (15, 25, 5),
          (16, 6, 4)]


@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return params, jax_decoder(), jax_params(params), port_model(params)


@pytest.fixture(scope="module")
def reference():
    """Greedy tokens of the reference's contiguous engine, one engine per
    (quant) for the whole module, each prompt run once."""
    params = draw_params(0)
    engines, memo = {}, {}

    def tokens(quant, seed, p_len, n):
        key = (quant, seed, p_len, n)
        if key not in memo:
            if quant not in engines:
                engines[quant] = JaxEngine(
                    jax_decoder(), jax_params(params), 2, quant=quant,
                    paged=False, prompt_grid=4, prefill_chunk=PAGE,
                    observe=False,
                )
            memo[key] = engines[quant].submit(
                rand_prompt(seed, p_len), n, 0.0, timeout=300
            )
        return memo[key]

    yield tokens
    for eng in engines.values():
        eng.close()


def _gen():
    return torch.Generator()


def _jax_rows(cache):
    return [cache[f"block_{i}"] for i in range(CFG["depth"])]


@pytest.mark.parametrize("s", [1, 3], ids=["token", "window"])
def test_per_row_write_pos_forward_matches(setup, s):
    # Three rows of a contiguous cache already holding 10 slots each,
    # written at their own positions (row 2 at the last slot for the
    # single token); logits and every cache row match.
    _, dec, jp, pm = setup
    b, L = 3, CFG["max_seq"]
    rng = np.random.default_rng(3)
    ck = (0.5 * rng.standard_normal(
        (CFG["depth"], b, L, CFG["heads"], CFG["dim"] // CFG["heads"])
    )).astype(np.float32)
    cv = (0.5 * rng.standard_normal(ck.shape)).astype(np.float32)
    wp = np.array([10, 4, L - 1 if s == 1 else 20], np.int32)
    toks = rng.integers(0, CFG["vocab"], (b, s)).astype(np.int32)
    pos = wp[:, None] + np.arange(s, dtype=np.int32)
    slots = np.arange(L)
    if s == 1:
        mask = slots[None, :] <= wp[:, None]
    else:
        mask = slots[None, None, :] <= pos[:, :, None]
    jcache = G.init_decode_cache(dec, b)
    jcache = {
        f"block_{i}": {**jcache[f"block_{i}"],
                       "cached_key": jnp.asarray(ck[i]),
                       "cached_value": jnp.asarray(cv[i])}
        for i in range(CFG["depth"])
    }
    jl, upd = dec.apply(
        {"params": jp, "cache": jcache}, jnp.asarray(toks),
        positions=jnp.asarray(pos), kv_mask=jnp.asarray(mask),
        write_pos=jnp.asarray(wp), mutable=["cache"],
    )
    tcache = [{"k": torch.from_numpy(ck[i].copy()),
               "v": torch.from_numpy(cv[i].copy())}
              for i in range(CFG["depth"])]
    tl = pm(torch.from_numpy(toks), positions=torch.from_numpy(pos),
            cache=tcache, kv_mask=torch.from_numpy(mask),
            write_pos=torch.from_numpy(wp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    for jrow, trow in zip(_jax_rows(upd["cache"]), tcache):
        np.testing.assert_allclose(trow["k"].numpy(),
                                   np.asarray(jrow["cached_key"]), atol=ATOL)
        np.testing.assert_allclose(trow["v"].numpy(),
                                   np.asarray(jrow["cached_value"]),
                                   atol=ATOL)


def test_per_row_write_pos_needs_a_per_row_mask(setup):
    *_, pm = setup
    cache = TG.init_decode_cache(pm, 2, device="cpu")
    with pytest.raises(ValueError, match="per-row"):
        pm(torch.zeros((2, 1), dtype=torch.long),
           positions=torch.zeros((2, 1), dtype=torch.long), cache=cache,
           write_pos=torch.zeros(2, dtype=torch.int32))


def _admit_both(setup, quant):
    """Two admissions into rows 1 and 0 of a 3-row contiguous cache
    through the final-chunk seam (row 1 in two chunks: a prefill_chunk
    first), in both packages.  Returns (jax cache, port cache, the
    reference's head, the port's, tokens, positions)."""
    _, dec, jp, pm = setup
    if quant:
        qp_j = QG.quantize_decode_params(jp)
        deq_j = QG.dequantize_decode_params(qp_j, jp)
        qp_t = TQG.quantize_decode_params(pm)
        deq_t = TQG.dequantize_decode_params(qp_t, pm)
        jcache = QG.init_quant_decode_cache(dec, 3)
        tcache = TQG.init_quant_decode_cache(pm, 3, device="cpu")
    else:
        qp_j, deq_j, qp_t, deq_t = None, jp, None, pm
        jcache = G.init_decode_cache(dec, 3)
        tcache = TG.init_decode_cache(pm, 3, device="cpu")
    toks, plens = [0, 0, 0], [1, 1, 1]
    for row, seed, p_len in ((1, 31, 13), (0, 32, 6)):
        prompt = rand_prompt(seed, p_len)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :p_len] = prompt[0]
        jscr = G.init_decode_cache(dec, 1)
        tscr = TG.init_decode_cache(deq_t, 1, device="cpu")
        start = 0
        if p_len > 8:  # two chunks: the first through prefill_chunk
            jscr = G.prefill_chunk(dec, deq_j, jscr,
                                   jnp.asarray(padded[:, :8]), jnp.int32(0))
            tscr = TG.prefill_chunk(deq_t, tscr, padded[:, :8], 0)
            start = 8
        chunk = padded[:, start:start + 8]
        if quant:
            jcache, jt = QG.quant_prefill_finish_into_slot(
                dec, deq_j, qp_j, jcache, jscr, jnp.asarray(chunk),
                jnp.int32(row), jnp.int32(start), jnp.int32(p_len),
                jnp.float32(0.0), jax.random.PRNGKey(0),
            )
            tcache, tt = TQG.quant_prefill_finish_into_slot(
                deq_t, qp_t, tcache, tscr, chunk, row, start, p_len, 0.0,
                _gen(),
            )
        else:
            jcache, jt = G.prefill_finish_into_slot(
                dec, jp, jcache, jscr, jnp.asarray(chunk), jnp.int32(row),
                jnp.int32(start), jnp.int32(p_len), jnp.float32(0.0),
                jax.random.PRNGKey(0),
            )
            tcache, tt = TG.prefill_finish_into_slot(
                pm, tcache, tscr, chunk, row, start, p_len, 0.0, _gen(),
            )
        assert int(tt[0]) == int(jt[0]), row
        toks[row], plens[row] = int(tt[0]), p_len
    return jcache, tcache, qp_j, qp_t, toks, plens


def _assert_caches_close(jcache, tcache, quant):
    for i in range(CFG["depth"]):
        if quant:
            jk = np.asarray(jcache[i]["k"], np.float32) * np.asarray(
                jcache[i]["k_scale"])[..., None]
            tk = tcache[i]["k"].float().numpy() * tcache[i][
                "k_scale"].numpy()[..., None]
            np.testing.assert_allclose(tk, jk, atol=STEP_ATOL)
        else:
            np.testing.assert_allclose(
                tcache[i]["k"].numpy(),
                np.asarray(jcache[f"block_{i}"]["cached_key"]), atol=ATOL,
            )
            np.testing.assert_allclose(
                tcache[i]["v"].numpy(),
                np.asarray(jcache[f"block_{i}"]["cached_value"]), atol=ATOL,
            )


@QUANT
def test_contiguous_seams_match(setup, quant):
    # The final-chunk seam writes whole rows; decode steps advance rows
    # 0 and 1 (row 1 going inactive after three steps) with row 2 idle:
    # tokens every step and the cache rows match.
    _, dec, jp, pm = setup
    jcache, tcache, qp_j, qp_t, toks, plens = _admit_both(setup, quant)
    _assert_caches_close(jcache, tcache, quant)
    tok = np.array(toks, np.int32)
    pos = np.array(plens, np.int32)
    seen = []
    for step in range(6):
        active = np.array([True, step < 3, False])
        args_t = (torch.from_numpy(tok), torch.from_numpy(pos),
                  torch.from_numpy(active), torch.zeros(3), _gen())
        args_j = (jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(active),
                  jnp.zeros(3), jax.random.PRNGKey(0))
        if quant:
            jcache, jn = QG.quant_engine_decode_step(
                qp_j, jcache, *args_j, CFG["heads"])
            tcache, tn = TQG.quant_engine_decode_step(
                qp_t, tcache, *args_t, CFG["heads"])
        else:
            jcache, jn = G.decode_step(dec, jp, jcache, *args_j)
            tcache, tn = TG.decode_step(pm, tcache, *args_t)
        jn = np.asarray(jn)
        assert np.array_equal(tn.numpy()[active], jn[active]), step
        seen.extend(jn[active].tolist())
        tok = np.where(active, jn, tok).astype(np.int32)
        pos = np.where(active, pos + 1, pos).astype(np.int32)
    assert len(set(seen)) > 1, seen
    _assert_caches_close(jcache, tcache, quant)


def _engine(pm, slots, **kw):
    kw.setdefault("prompt_grid", 4)
    kw.setdefault("prefill_chunk", PAGE)
    return ContinuousBatchingEngine(pm, slots, paged=False, device="cpu",
                                    **kw)


def _fire(eng, shapes):
    handles = {}
    for seed, p_len, n in shapes:
        handles[seed] = eng.submit_nowait(rand_prompt(seed, p_len), n, 0.0)
        time.sleep(0.02)
    return {seed: h.wait(timeout=300) for seed, h in handles.items()}


@QUANT
@pytest.mark.parametrize("pipeline", [True, False], ids=["lag", "sync"])
def test_engine_matches_reference_engine(setup, reference, quant,
                                         pipeline):
    # 6 staggered requests through 2 slots (retire and refill, chunked
    # admissions): every row equals the reference contiguous engine's.
    *_, pm = setup
    eng = _engine(pm, 2, quant=quant, pipeline=pipeline)
    try:
        outs = _fire(eng, SHAPES)
        snap = eng.snapshot()
    finally:
        eng.close()
    tokens = set()
    for seed, p_len, n in SHAPES:
        want = reference(quant, seed, p_len, n)
        tokens.update(want[0])
        assert outs[seed] == want, (seed, outs[seed], want)
    assert len(tokens) > 3, tokens
    assert snap["admitted"] == snap["retired"] == len(SHAPES)
    assert "kv_pages_in_use" not in snap  # no page pool
    assert snap["prefix_hits"] == 0


def test_engine_has_no_prefix_reuse(setup, reference):
    # The same prompt twice: both admissions prefill in full (no trie
    # without pages) and give the same tokens.
    *_, pm = setup
    eng = _engine(pm, 2)
    try:
        p = rand_prompt(41, 24)
        first = eng.submit(p, 5, 0.0, timeout=300)
        chunks = eng.snapshot()["prefill_chunks"]
        second = eng.submit(p, 5, 0.0, timeout=300)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert first == second == reference(False, 41, 24, 5)
    assert snap["prefill_chunks"] == 2 * chunks
    assert snap["prefix_hits"] == snap["prefix_misses"] == 0


@QUANT
def test_crash_then_revive_serves_exact(setup, reference, quant):
    # A persistent decode failure fails the active request and crashes
    # the scheduler; the supervisor revives it with fresh slot rows, and
    # the revived engine serves the reference engine's tokens.
    *_, pm = setup
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
        with pytest.raises(RuntimeError):
            eng.submit(rand_prompt(95, 20), 12, 0.0, timeout=300)
        deadline = time.monotonic() + 30
        while (time.monotonic() < deadline
               and eng.snapshot()["restarts"] < 1):
            time.sleep(0.02)
        assert eng.snapshot()["restarts"] >= 1
        assert eng.submit(rand_prompt(96, 12), 4, 0.0, timeout=300) == (
            reference(quant, 96, 12, 4)
        )
    finally:
        sup.stop()
        eng.close()
