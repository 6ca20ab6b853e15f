"""The port's speculative-decoding seams against the reference on the
same numpy-drawn weights (f32): the paged verify window of
TransformerLM (s > 1, per-query kv_mask), models/generate.py
`verify_step` and `paged_verify_step` (greedy on and off), and
models/quant_generate.py `quant_verify_step` (contiguous and paged, int8
KV on and off), `draft_chain` (proposals and the drafter cache) and
`draft_fill_row` from each of the four target layouts, including windows
whose tail runs past max_seq."""

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
from container_engine_accelerators_tpu_torch.models import (
    generate as TG,
)
from container_engine_accelerators_tpu_torch.models import (
    quant_generate as TQG,
)

ATOL = 1e-4
# Int8 caches: a value within ATOL of the reference's may round to the
# neighbouring int8 step, and the int8 matmuls sum in another order, so
# a written slot may sit up to two steps of its own scale away.
POOL_STEPS = 2
N_PAGES = 13
PROMPTS = [(1, 11), (2, 7), (3, 14)]  # (seed, prompt length) per row
HEADS = CFG["heads"]
LAYOUTS = ["bf16_contig", "bf16_paged", "int8_contig", "int8_paged",
           "int8kv_contig", "int8kv_paged"]


def _gen():
    return torch.Generator()


@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    dec, jp, pm = jax_decoder(), jax_params(params), port_model(params)
    qp_j = QG.quantize_decode_params(jp)
    qp_t = TQG.quantize_decode_params(pm)
    return dict(dec=dec, jp=jp, pm=pm, qp_j=qp_j, qp_t=qp_t,
                deq_j=QG.dequantize_decode_params(qp_j, jp),
                deq_t=TQG.dequantize_decode_params(qp_t, pm))


def _tables():
    per_row = CFG["max_seq"] // PAGE
    bt = np.zeros((3, per_row), np.int32)
    bt[0, :4] = [1, 2, 3, 4]
    bt[1, :4] = [5, 6, 7, 8]
    bt[2, :4] = [9, 10, 11, 12]
    return bt


@pytest.fixture(scope="module")
def admitted(setup):
    """Per layout, three rows admitted through the final-chunk seam in
    both packages: {layout: (jax cache, port cache, tok0 (3,), prompt
    lengths (3,), block tables or None)}.  "int8" layouts run the int8
    weight engine's seams with float KV, "int8kv" with int8 KV."""
    S = setup
    dec, bt = S["dec"], _tables()
    out = {}
    for layout in LAYOUTS:
        kind, where = layout.split("_")
        paged = where == "paged"
        quant, quant_kv = kind != "bf16", kind == "int8kv"
        if quant:
            jcache = (QG.init_quant_paged_cache(dec, N_PAGES, PAGE,
                                                quant_kv=quant_kv)
                      if paged else
                      QG.init_quant_decode_cache(dec, 3, quant_kv=quant_kv))
            tcache = (TQG.init_quant_paged_cache(
                S["pm"], N_PAGES, PAGE, quant_kv=quant_kv, device="cpu")
                if paged else TQG.init_quant_decode_cache(
                    S["pm"], 3, quant_kv=quant_kv, device="cpu"))
        else:
            jcache = (G.init_paged_cache(dec, N_PAGES, PAGE) if paged
                      else G.init_decode_cache(dec, 3))
            tcache = (TG.init_paged_cache(S["pm"], N_PAGES, PAGE,
                                          device="cpu") if paged
                      else TG.init_decode_cache(S["pm"], 3, device="cpu"))
        toks, plens = [], []
        for row, (seed, p_len) in enumerate(PROMPTS):
            chunk = np.zeros((1, 16), np.int32)
            chunk[0, :p_len] = rand_prompt(seed, p_len)[0]
            tail = (jnp.int32(0), jnp.int32(p_len), jnp.float32(0.0),
                    jax.random.PRNGKey(0))
            jscr = G.init_decode_cache(dec, 1)
            run_t = S["deq_t"] if quant else S["pm"]
            tscr = TG.init_decode_cache(run_t, 1, device="cpu")
            where_j = jnp.asarray(bt[row]) if paged else jnp.int32(row)
            where_t = bt[row] if paged else row
            if paged:
                tail = (jnp.int32(0),) + tail
            if quant and paged:
                jcache, jt = QG.quant_paged_prefill_finish(
                    dec, S["deq_j"], S["qp_j"], jcache, jscr,
                    jnp.asarray(chunk), where_j, *tail)
                tcache, tt = TQG.quant_paged_prefill_finish(
                    S["deq_t"], S["qp_t"], tcache, tscr, chunk, where_t,
                    0, 0, p_len, 0.0, _gen())
            elif quant:
                jcache, jt = QG.quant_prefill_finish_into_slot(
                    dec, S["deq_j"], S["qp_j"], jcache, jscr,
                    jnp.asarray(chunk), where_j, *tail)
                tcache, tt = TQG.quant_prefill_finish_into_slot(
                    S["deq_t"], S["qp_t"], tcache, tscr, chunk, where_t,
                    0, p_len, 0.0, _gen())
            elif paged:
                jcache, jt = G.paged_prefill_finish(
                    dec, S["jp"], jcache, jscr, jnp.asarray(chunk),
                    where_j, *tail)
                tcache, tt = TG.paged_prefill_finish(
                    S["pm"], tcache, tscr, chunk, where_t, 0, 0, p_len,
                    0.0, _gen())
            else:
                jcache, jt = G.prefill_finish_into_slot(
                    dec, S["jp"], jcache, jscr, jnp.asarray(chunk),
                    where_j, *tail)
                tcache, tt = TG.prefill_finish_into_slot(
                    S["pm"], tcache, tscr, chunk, where_t, 0, p_len, 0.0,
                    _gen())
            assert int(tt[0]) == int(jt[0]), (layout, row)
            toks.append(int(tt[0]))
            plens.append(p_len)
        out[layout] = (jcache, tcache, np.array(toks, np.int32),
                       np.array(plens, np.int32), bt if paged else None)
    return out


def _clone(cache):
    return [{k: v.clone() for k, v in blk.items()} for blk in cache]


def _leaves(cache, name):
    """[(values as f32, per-slot step or None)] of every block's leaf
    `name` ("k" or "v"), dequantized for the int8 layout, from either
    package's cache."""
    if isinstance(cache, dict):  # the reference's flax cache
        key = {"k": "cached_key", "v": "cached_value"}[name]
        return [(np.asarray(cache[f"block_{i}"][key]), None)
                for i in range(CFG["depth"])]
    out = []
    for c in cache:
        val = c[name]
        val = val.numpy() if torch.is_tensor(val) else np.asarray(val)
        if f"{name}_scale" not in c:
            out.append((val.astype(np.float32), None))
            continue
        sc = c[f"{name}_scale"]
        sc = (sc.numpy() if torch.is_tensor(sc) else np.asarray(sc))[
            ..., None]
        out.append((val.astype(np.float32) * sc, sc))
    return out


def _assert_cache_close(tcache, jcache):
    """Every leaf within ATOL (float) or POOL_STEPS int8 steps of the
    larger of the two slots' scales (int8)."""
    for name in ("k", "v"):
        for (g, gs), (w, ws) in zip(_leaves(tcache, name),
                                    _leaves(jcache, name)):
            if gs is None:
                np.testing.assert_allclose(g, w, atol=ATOL)
                continue
            tol = POOL_STEPS * np.maximum(gs, ws) * (1 + 1e-6) + 1e-7
            excess = np.abs(g - w) / tol
            assert excess.max() <= 1, (name, excess.max())


def _window(tok0, plens, s, seed=5):
    """(toks (3, s), pos (3,)): column 0 each row's last committed token,
    the rest a seeded guess at the continuation."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG["vocab"], (3, s)).astype(np.int32)
    toks[:, 0] = tok0
    return toks, plens.copy()


# -- the paged window of the transformer ------------------------------------
@pytest.mark.parametrize("s", [2, 4])
def test_paged_window_logits_match(setup, admitted, s):
    # The s > 1 paged window: logits at every window position within
    # ATOL, equal greedy tokens, and equal pools after the up-front
    # scatter.  Row 2's window starts at the last page's edge.
    dec, jp, pm = setup["dec"], setup["jp"], setup["pm"]
    jcache, tcache, tok0, plens, bt = admitted["bf16_paged"]
    tcache = _clone(tcache)
    toks, pos = _window(tok0, plens, s)
    pos[2] = 4 * PAGE - s // 2
    qpos = pos[:, None] + np.arange(s, dtype=np.int32)
    view = bt.shape[1] * PAGE
    mask = np.arange(view)[None, None, :] <= qpos[:, :, None]
    jl, upd = dec.apply(
        {"params": jp, "cache": jcache}, jnp.asarray(toks),
        positions=jnp.asarray(qpos), kv_mask=jnp.asarray(mask),
        write_pos=jnp.asarray(pos), block_tables=jnp.asarray(bt),
        mutable=["cache"],
    )
    tl = pm(torch.from_numpy(toks), positions=torch.from_numpy(qpos),
            cache=tcache, kv_mask=torch.from_numpy(mask),
            write_pos=torch.from_numpy(pos),
            block_tables=torch.from_numpy(bt))
    assert tl.shape == (3, s, CFG["vocab"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    assert np.array_equal(tl.argmax(-1).numpy(),
                          np.asarray(jl).argmax(-1))
    _assert_cache_close(tcache, upd["cache"])


def test_paged_window_needs_a_per_query_mask(setup, admitted):
    pm = setup["pm"]
    _, tcache, tok0, plens, bt = admitted["bf16_paged"]
    toks, pos = _window(tok0, plens, 3)
    mask = np.ones((3, bt.shape[1] * PAGE), bool)  # per-row, not per-query
    with pytest.raises(ValueError, match="per-query"):
        pm(torch.from_numpy(toks),
           positions=torch.from_numpy(pos[:, None] + np.arange(3)),
           cache=_clone(tcache), kv_mask=torch.from_numpy(mask),
           write_pos=torch.from_numpy(pos),
           block_tables=torch.from_numpy(bt))


# -- verify_step / paged_verify_step ----------------------------------------
def _verify(setup, layout, admitted, toks, pos, active, greedy,
            temps=None):
    """Both packages' verify seam for `layout` on copies of its cache:
    (jax tokens, port tokens, jax cache, port cache)."""
    S = setup
    jcache, tcache, _, _, bt = admitted[layout]
    tcache = _clone(tcache)
    temps = np.zeros(3, np.float32) if temps is None else temps
    args_j = (jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(active))
    args_t = (torch.from_numpy(toks), torch.from_numpy(pos),
              torch.from_numpy(active))
    rng = jax.random.PRNGKey(0)
    if layout.startswith("bf16") and bt is not None:
        jc, jo = G.paged_verify_step(
            S["dec"], S["jp"], jcache, *args_j, jnp.asarray(bt),
            jnp.asarray(temps), rng, greedy=greedy)
        tc, to = TG.paged_verify_step(
            S["pm"], tcache, *args_t, torch.from_numpy(bt),
            torch.from_numpy(temps), _gen(), greedy=greedy)
    elif layout.startswith("bf16"):
        jc, jo = G.verify_step(S["dec"], S["jp"], jcache, *args_j,
                               jnp.asarray(temps), rng, greedy=greedy)
        tc, to = TG.verify_step(S["pm"], tcache, *args_t,
                                torch.from_numpy(temps), _gen(),
                                greedy=greedy)
    else:
        jbt = None if bt is None else jnp.asarray(bt)
        tbt = None if bt is None else torch.from_numpy(bt)
        jc, jo = QG.quant_verify_step(
            S["qp_j"], jcache, *args_j, jnp.asarray(temps), rng, HEADS,
            block_tables=jbt, greedy=greedy)
        tc, to = TQG.quant_verify_step(
            S["qp_t"], tcache, *args_t, torch.from_numpy(temps), _gen(),
            HEADS, block_tables=tbt, greedy=greedy)
    assert to.dtype == torch.int32 and to.shape == toks.shape
    return np.asarray(jo), to.numpy(), jc, tc


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "drawn"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_verify_step_matches_reference(setup, admitted, layout, greedy):
    # A window of 4 over rows 0 and 2 (row 1 inactive): every active
    # row's window tokens equal the reference's, with greedy=True (one
    # argmax) and greedy=False (a draw per column at temperature 0), and
    # every cache the window wrote matches.
    _, _, tok0, plens, _ = admitted[layout]
    toks, pos = _window(tok0, plens, 4)
    active = np.array([True, False, True])
    jo, to, jc, tc = _verify(setup, layout, admitted, toks, pos, active,
                             greedy)
    assert np.array_equal(to[active], jo[active]), (to, jo)
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("layout", ["bf16_paged", "int8kv_paged"])
def test_greedy_window_is_the_one_token_chain(setup, admitted, layout):
    # The accept rule's anchor: fed the target's own greedy tokens, the
    # window's column j equals the j-th chained one-token step.
    S = setup
    _, tcache, tok0, plens, bt = admitted[layout]
    active = torch.ones(3, dtype=torch.bool)
    temps, tbt = torch.zeros(3), torch.from_numpy(bt)
    t, p = torch.from_numpy(tok0), torch.from_numpy(plens)
    chain, cc = [t], _clone(tcache)
    for _ in range(3):
        if layout.startswith("bf16"):
            cc, t = TG.paged_decode_step(S["pm"], cc, t, p, active, tbt,
                                         temps, _gen())
        else:
            cc, t = TQG.quant_paged_engine_decode_step(
                S["qp_t"], cc, t, p, active, tbt, temps, _gen(), HEADS)
        chain.append(t)
        p = p + 1
    toks = torch.stack(chain, dim=1)  # (3, 4): inputs t0..t3
    if layout.startswith("bf16"):
        _, out = TG.paged_verify_step(
            S["pm"], _clone(tcache), toks, torch.from_numpy(plens), active,
            tbt, temps, _gen(), greedy=True)
    else:
        _, out = TQG.quant_verify_step(
            S["qp_t"], _clone(tcache), toks, torch.from_numpy(plens),
            active, temps, _gen(), HEADS, block_tables=tbt, greedy=True)
    assert torch.equal(out[:, :3], toks[:, 1:])


def test_sampled_window_draws_once_per_column(setup, admitted):
    # greedy=False at temperature > 0: column j is the j-th of s draws
    # from the engine's generator, as s separate samples would take.
    S = setup
    _, tcache, tok0, plens, bt = admitted["bf16_paged"]
    toks, pos = _window(tok0, plens, 3)
    temps = torch.full((3,), 0.9)
    args = (torch.from_numpy(toks), torch.from_numpy(pos),
            torch.ones(3, dtype=torch.bool), torch.from_numpy(bt), temps)
    _, out = TG.paged_verify_step(S["pm"], _clone(tcache), *args,
                                  torch.Generator().manual_seed(7))
    qpos = torch.from_numpy(pos)[:, None] + torch.arange(3)
    mask = torch.arange(bt.shape[1] * PAGE)[None, None] <= qpos[:, :, None]
    logits = S["pm"](args[0], positions=qpos, cache=_clone(tcache),
                     kv_mask=mask, write_pos=args[1], block_tables=args[3])
    gen = torch.Generator().manual_seed(7)
    want = [TG._sample(logits[:, j], temps, gen) for j in range(3)]
    assert torch.equal(out, torch.stack(want, dim=1))
    gen_greedy = torch.Generator().manual_seed(7)
    state = gen_greedy.get_state()
    TG.paged_verify_step(S["pm"], _clone(tcache), *args, gen_greedy,
                         greedy=True)
    assert torch.equal(gen_greedy.get_state(), state)  # no draw at all


@pytest.mark.parametrize("layout", ["bf16_contig", "bf16_paged",
                                    "int8kv_contig", "int8kv_paged"])
def test_window_tail_past_max_seq(setup, admitted, layout):
    # Row 0's window starts two slots before max_seq, so its last two
    # positions lie past the cache: the positional lookup clamps, the
    # writes clip (contiguous) or land in the null page (paged), and the
    # positions inside the cache match the reference.
    _, _, tok0, plens, _ = admitted[layout]
    toks, pos = _window(tok0, plens, 4)
    pos[0] = CFG["max_seq"] - 2
    active = np.ones(3, bool)
    jo, to, jc, tc = _verify(setup, layout, admitted, toks, pos, active,
                             greedy=True)
    assert np.array_equal(to[0, :2], jo[0, :2])
    assert np.array_equal(to[1:], jo[1:])


# -- the drafter ------------------------------------------------------------
@pytest.mark.parametrize("layout", ["bf16_contig", "bf16_paged",
                                    "int8kv_contig", "int8kv_paged"])
def test_draft_fill_row_matches_reference(setup, admitted, layout):
    # Each row of the drafter's int8 cache filled from the target cache
    # (quantized on the way in from float KV, copied from int8 KV), to
    # its prompt length: values and scales match, and the slots from the
    # prompt length on are zero.
    dec, pm = setup["dec"], setup["pm"]
    jcache, tcache, _, plens, bt = admitted[layout]
    jd = QG.init_quant_decode_cache(dec, 3, quant_kv=True)
    td = TQG.init_quant_decode_cache(pm, 3, quant_kv=True, device="cpu")
    for row in range(3):
        jbt = None if bt is None else jnp.asarray(bt[row])
        tbt = None if bt is None else bt[row]
        jd = QG.draft_fill_row(jd, jcache, jnp.int32(row),
                               jnp.int32(plens[row]), block_table=jbt)
        assert TQG.draft_fill_row(td, tcache, row, int(plens[row]),
                                  block_table=tbt) is td
    _assert_cache_close(td, jd)
    for blk in td:
        for row, p_len in enumerate(plens):
            assert not blk["k"][row, p_len:].any()
            assert not blk["v_scale"][row, p_len:].any()
            assert blk["k_scale"][row, :p_len].all()


@pytest.fixture(scope="module")
def drafter(setup, admitted):
    """The drafter caches of both packages filled from the int8 paged
    target: (jax drafter cache, port drafter cache, tok0, prompt
    lengths)."""
    dec, pm = setup["dec"], setup["pm"]
    jcache, tcache, tok0, plens, bt = admitted["int8kv_paged"]
    jd = QG.init_quant_decode_cache(dec, 3, quant_kv=True)
    td = TQG.init_quant_decode_cache(pm, 3, quant_kv=True, device="cpu")
    for row in range(3):
        jd = QG.draft_fill_row(jd, jcache, jnp.int32(row),
                               jnp.int32(plens[row]),
                               block_table=jnp.asarray(bt[row]))
        TQG.draft_fill_row(td, tcache, row, int(plens[row]),
                           block_table=bt[row])
    return jd, td, tok0, plens


@pytest.mark.parametrize("n_steps", [2, 4])
def test_draft_chain_matches_reference(setup, drafter, n_steps):
    # n_steps drafter passes over rows 0 and 2 (row 1 inactive): the
    # n_steps - 1 proposals equal the reference's, and the drafter
    # cache (including the KV-write-only last pass's slot) matches.
    jd, td, tok0, plens = drafter
    td = _clone(td)
    active = np.array([True, False, True])
    jc, jcols = QG.draft_chain(
        setup["qp_j"], jd, jnp.asarray(tok0), jnp.asarray(plens),
        jnp.asarray(active), HEADS, n_steps)
    tc, tcols = TQG.draft_chain(
        setup["qp_t"], td, torch.from_numpy(tok0), torch.from_numpy(plens),
        torch.from_numpy(active), HEADS, n_steps)
    assert tcols.shape == (3, n_steps - 1) and tcols.dtype == torch.int32
    assert np.array_equal(tcols.numpy()[active], np.asarray(jcols)[active])
    _assert_cache_close(tc, jc)
    last = plens + n_steps - 1  # the KV-write-only pass's slot
    for blk in tc:
        for row in np.flatnonzero(active):
            assert blk["k_scale"][row, last[row]].all()


def test_draft_chain_past_max_seq_writes_nothing_outside(setup, drafter):
    # A chain whose passes run past max_seq (a row's last window): the
    # passes inside the cache match the reference; the ones past it
    # write nothing (the reference's one-hot select), and nothing raises.
    jd, td, tok0, plens = drafter
    td = _clone(td)
    pos = plens.copy()
    pos[0] = CFG["max_seq"] - 2
    active = np.ones(3, bool)
    jc, jcols = QG.draft_chain(
        setup["qp_j"], jd, jnp.asarray(tok0), jnp.asarray(pos),
        jnp.asarray(active), HEADS, 4)
    tc, tcols = TQG.draft_chain(
        setup["qp_t"], td, torch.from_numpy(tok0), torch.from_numpy(pos),
        torch.from_numpy(active), HEADS, 4)
    assert np.array_equal(tcols.numpy()[:, :2], np.asarray(jcols)[:, :2])
    assert np.array_equal(tcols.numpy()[1:], np.asarray(jcols)[1:])
    _assert_cache_close(tc, jc)


def test_quant_decode_step_without_head(setup, drafter):
    # with_head=False: the same KV writes as the full pass, no logits.
    _, td, tok0, plens = drafter
    a, b = _clone(td), _clone(td)
    t, p = torch.from_numpy(tok0), torch.from_numpy(plens)
    _, logits = TQG.quant_decode_step(setup["qp_t"], a, t, p, p, None,
                                      HEADS)
    _, none = TQG.quant_decode_step(setup["qp_t"], b, t, p, p, None, HEADS,
                                    with_head=False)
    assert none is None and logits.shape == (3, CFG["vocab"])
    for x, y in zip(a, b):
        for name in x:
            assert torch.equal(x[name], y[name])


def test_draft_chain_needs_two_passes(setup, drafter):
    _, td, tok0, plens = drafter
    with pytest.raises(ValueError, match="n_steps"):
        TQG.draft_chain(setup["qp_t"], _clone(td), torch.from_numpy(tok0),
                        torch.from_numpy(plens), torch.ones(3, dtype=bool),
                        HEADS, 1)
