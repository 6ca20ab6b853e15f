"""The final prefill chunk as device operands and as a CUDA graph
(container_engine_accelerators_tpu_torch/models/generate.py
`paged_prefill_finish`, models/transformer.py's scalar `write_pos`
path, serving/engine.py's final-chunk seam and persistent scratch,
serving/decode_graph.py `SeamGraphs`).

CPU: the seam with 0-dim tensor operands gives bitwise the tokens, pool
pages and scratch of the call with Python numbers, at chunk widths 16 /
64 / 256, from a fresh start, after a prefix preload and after a
non-final chunk, greedy and sampled; the scalar `write_pos` path gives
the same output for an int and a 0-dim tensor; the engine's persistent
scratch holds nothing of an earlier admission, and no engine counts a
replay off the card.

Card (marker `card`, skipped without CUDA): per width the replay's
tok0 and pages equal the eager first call's and the Python-number
call's, at start 0 and, from a graph captured at start 0, after a
prefix preload and after a non-final chunk; a reset holder recaptures and refuses a cache it did not
capture; an engine warmed as the benchmark warms it holds one graph per
width and serves every later final chunk by a replay; a
revived engine recaptures.  Run them on the card with
`python -m pytest tests/test_torch_prefill_graph.py -m card`.  This file
imports no JAX, so it runs where only the port is installed."""

import time

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu_torch.models import generate as G
from container_engine_accelerators_tpu_torch.parallel.mesh import LocalMesh
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
    EngineSupervisor,
)
from container_engine_accelerators_tpu_torch.serving import (
    engine as engine_mod,
)
from container_engine_accelerators_tpu_torch.serving.decode_graph import (
    SeamGraphs,
)

CFG = dict(vocab=64, dim=32, depth=2, heads=2, max_seq=512)
PAGE = 16
PAGES_PER_ROW = CFG["max_seq"] // PAGE
N_PAGES = 2 * PAGES_PER_ROW + 1
WIDTHS = (16, 64, 256)
SAMPLING = {
    "greedy": dict(temp=0.0),
    "sampled": dict(temp=0.8),
    "top_k_p": dict(temp=0.8, top_k=5, top_p=0.9),
}


def _model(device="cpu"):
    model = G.make_decoder(dtype=torch.bfloat16, device=device, **CFG)
    return model.init_random(torch.Generator().manual_seed(0))


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab"], size=(1, n)).astype(np.int32)


def _pool(model, seed=1):
    """A paged pool filled with noise, so a page the call must not
    write shows any write."""
    pool = G.init_paged_cache(model, N_PAGES, PAGE, device=model.device)
    gen = torch.Generator().manual_seed(seed)
    for leaf in G._pool_leaves(pool):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    return pool


def _clone(cache):
    return [{k: v.clone() for k, v in blk.items()} for blk in cache]


def _equal(a, b, skip_null=False):
    lo = 1 if skip_null else 0
    return all(
        torch.equal(x[name][lo:], y[name][lo:])
        for x, y in zip(a, b) for name in x
    )


def _case(width, case):
    """(start, write_from, prompt_len, shared pages) of a final chunk of
    `width`: at 0 ("fresh"), after `width` preloaded prefix positions of
    which the full pages are shared ("prefix"), or after a non-final
    chunk of `width` ("chunked")."""
    if case == "fresh":
        return 0, 0, width - 3, 0
    if case == "prefix":
        return width, width, 2 * width - 3, width // PAGE
    return width, 0, 2 * width - 3, 0


def _block_table(plen, shared):
    """A row's block table: `shared` prefix pages from the pool's second
    half, then private pages from the first, through the prompt and a
    few decode positions."""
    bt = np.zeros((PAGES_PER_ROW,), np.int32)
    n = min(-(-(plen + 4) // PAGE), PAGES_PER_ROW)
    bt[:shared] = PAGES_PER_ROW + 1 + np.arange(shared)
    bt[shared:n] = 1 + np.arange(n - shared)
    return bt


def _prepare(model, pool, prompt, bt, start, case, held=None):
    """The scratch (a new one, or `held` = (buffer, leaves) zeroed) as
    the admission leaves it before its final chunk."""
    buf, scratch = held or G.init_scratch(model, device=model.device)
    buf.zero_()
    if case == "prefix":
        G.paged_preload_scratch(pool, scratch, bt, start)
    elif case == "chunked":
        G.prefill_chunk(model, scratch, torch.from_numpy(
            prompt[:, :start]).to(model.device), 0)
    return scratch


def _operands(device, bt, start, wfrom, plen, temp, top_k=None,
              top_p=None):
    def t(v, dtype):
        return None if v is None else torch.tensor(v, dtype=dtype,
                                                   device=device)

    return dict(
        block_table=torch.as_tensor(bt, device=device),
        start=t(start, torch.int64), write_from=t(wfrom, torch.int64),
        prompt_len=t(plen, torch.int64), temperature=t(temp, torch.float32),
        top_k=t(top_k, torch.int64), top_p=t(top_p, torch.float32),
    )


@pytest.fixture(scope="module")
def model():
    return _model()


# -- the seam on the CPU ---------------------------------------------------
@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("case", ["fresh", "prefix", "chunked"])
@pytest.mark.parametrize("width", WIDTHS)
def test_operands_give_the_python_number_call(model, width, case, mode):
    start, wfrom, plen, shared = _case(width, case)
    prompt = _prompt(width + len(case), plen + width)
    chunk = torch.from_numpy(prompt[:, start:start + width]).long()
    bt = _block_table(plen, shared)
    kw = dict(SAMPLING[mode])
    temp = kw.pop("temp")
    runs = []
    for as_tensors in (False, True):
        pool = _pool(model)
        before = _clone(pool)
        scratch = _prepare(model, pool, prompt, bt, start, case)
        gen = torch.Generator().manual_seed(7)
        if as_tensors:
            ops = _operands("cpu", bt, start, wfrom, plen, temp, **kw)
            _, tok0 = G.paged_prefill_finish(
                model, pool, scratch, chunk, ops["block_table"],
                ops["start"], ops["write_from"], ops["prompt_len"],
                ops["temperature"], gen, top_k=ops["top_k"],
                top_p=ops["top_p"])
        else:
            _, tok0 = G.paged_prefill_finish(
                model, pool, scratch, chunk, bt, start, wfrom, plen, temp,
                gen, **kw)
        runs.append((tok0, pool, scratch))
        for p in bt[:shared]:  # shared prefix pages stay as they were
            for blk, old in zip(pool, before):
                assert all(torch.equal(blk[n][p], old[n][p]) for n in blk)
    (tok_a, pool_a, scr_a), (tok_b, pool_b, scr_b) = runs
    assert torch.equal(tok_a, tok_b)
    # Page 0 is the null page: every position below write_from or past
    # the row's pages lands on it, and which of them the scatter leaves
    # there is not defined.
    assert _equal(pool_a, pool_b, skip_null=True)
    assert _equal(scr_a, scr_b)


@pytest.mark.parametrize("kv_mask", [None, "slots", "rows"])
@pytest.mark.parametrize("t", [0, 9])
@pytest.mark.parametrize("s", [1, 6])
@pytest.mark.parametrize("b", [1, 2])
def test_scalar_write_pos_int_or_tensor(model, b, s, t, kv_mask):
    toks = torch.from_numpy(_prompt(b * 10 + s + t, b * s).reshape(b, s))
    pos = t + torch.arange(s)
    slots = torch.arange(CFG["max_seq"])
    mask = {None: None, "slots": slots < t + s - 1,
            "rows": (slots[None, :] < t + s).expand(b, -1).clone()}[kv_mask]
    if mask is not None and mask.ndim == 2:
        mask[0, 0] = False
    outs = []
    for wp in (t, torch.tensor(t)):
        cache = G.init_decode_cache(model, b, device="cpu")
        logits = model(toks, positions=pos, cache=cache, kv_mask=mask,
                       write_pos=wp)
        outs.append((logits, cache))
    assert torch.equal(outs[0][0], outs[1][0])
    assert _equal(outs[0][1], outs[1][1])


# -- the engine on the CPU -------------------------------------------------
def _engine(model, kind, **kw):
    opts = dict(prompt_grid=16, prefill_chunk=64, page_size=PAGE,
                device=str(model.device))
    opts.update({
        "paged": dict(prefix_cache=False),
        "fused": dict(prefix_cache=False, decode_steps=4),
        "spec": dict(prefix_cache=False, spec_k=2),
        "contiguous": dict(paged=False),
        "int8": dict(quant=True, prefix_cache=False),
        "mesh": dict(mesh=LocalMesh(["cpu"] * 2)),
    }[kind])
    opts.update(kw)
    return ContinuousBatchingEngine(model, 2, **opts)


@pytest.mark.parametrize("kind", ["paged", "contiguous", "int8"])
def test_scratch_holds_nothing_of_an_earlier_admission(model, kind):
    # A 200-token prompt (four chunks) fills the scratch to 256; the
    # next, 20-token admission finds it zero, and decodes as a fresh
    # engine does.
    eng = _engine(model, kind)
    seen, real = [], eng._prefill_fn

    def spy(cache, scratch, chunk, *a, **k):
        seen.append((scratch, [blk[n].clone() for blk in scratch
                               for n in blk]))
        return real(cache, scratch, chunk, *a, **k)

    eng._prefill_fn = spy
    try:
        eng.submit(_prompt(5, 200), 3, 0.0, timeout=300)
        got = eng.submit(_prompt(6, 20), 5, 0.0, timeout=300)
    finally:
        eng.close()
    (s_long, _), (s_short, leaves) = seen
    assert s_short is s_long  # one scratch, kept
    assert all(not leaf.any() for leaf in leaves)
    fresh = _engine(model, kind)
    try:
        assert got == fresh.submit(_prompt(6, 20), 5, 0.0, timeout=300)
    finally:
        fresh.close()


@pytest.mark.parametrize(
    "kind", ["paged", "fused", "spec", "contiguous", "int8", "mesh"])
def test_no_replay_off_the_card(model, kind):
    # Only the bf16 paged engines hold the final-chunk graphs, and on
    # the CPU their holder calls the seam directly: nothing is replayed
    # and nothing captured.
    eng = _engine(model, kind)
    try:
        for seed, plen in ((1, 20), (2, 70), (3, 9)):
            eng.submit(_prompt(seed, plen), 3, 0.0, timeout=300)
        snap = eng.snapshot()
    finally:
        eng.close()
    assert snap["prefill_replays"] == 0 and snap["admitted"] == 3
    graphs = eng._prefill_graphs
    if kind in ("paged", "fused", "spec"):
        assert isinstance(graphs, SeamGraphs)
        assert graphs.replays == 0 and graphs.captures == []
    else:
        assert graphs is None


# -- on the card -----------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on an NVIDIA card")


def _seam_call(graphs, stage, model, pool, scratch, prompt, width, bt,
               plen):
    inputs = stage.fill(torch.from_numpy(prompt[:, :width]), bt, 0, 0,
                        plen, 0.0, None, None)
    _, tok0 = graphs.run((model, scratch), pool, inputs,
                         (width, False, False))
    return tok0.clone()


@pytest.mark.card
@pytest.mark.parametrize("width", WIDTHS)
def test_card_replay_equals_eager_first_call(width):
    _need_card()
    model = _model("cuda")
    pool = _pool(model)
    initial = _clone(pool)
    buf, scratch = G.init_scratch(model, device="cuda")
    gen = torch.Generator(device="cuda")
    graphs = SeamGraphs(engine_mod._final_chunk_seam, gen, model.device)
    stage = engine_mod._Staging(
        engine_mod._final_chunk_fields(CFG["max_seq"], PAGES_PER_ROW), True)
    plen = width - 3
    prompt = _prompt(width, plen)
    prompt = np.pad(prompt, ((0, 0), (0, width - plen)))
    bt = _block_table(plen, 0)
    results = []
    for _ in range(3):  # the eager first call, then two replays
        for leaf, init in zip(G._pool_leaves(pool), G._pool_leaves(initial)):
            leaf.copy_(init)
        buf.zero_()
        tok0 = _seam_call(graphs, stage, model, pool, scratch, prompt,
                          width, bt, plen)
        torch.cuda.synchronize()
        results.append((tok0, _clone(pool)))
    assert graphs.replays == 2 and len(graphs.captures) == 1
    # The Python-number call, eagerly.
    for leaf, init in zip(G._pool_leaves(pool), G._pool_leaves(initial)):
        leaf.copy_(init)
    buf.zero_()
    _, tok0 = G.paged_prefill_finish(
        model, pool, scratch, torch.from_numpy(prompt).cuda(), bt, 0, 0,
        plen, 0.0, gen)
    results.append((tok0, _clone(pool)))
    tok_ref, pool_ref = results[0]
    for tok, pool_n in results[1:]:
        assert torch.equal(tok, tok_ref)
        # Page 0 is the null page: every unmapped position lands there,
        # in whatever order the scatter takes.
        assert _equal(pool_n, pool_ref, skip_null=True)


@pytest.mark.card
@pytest.mark.parametrize("case", ["prefix", "chunked"])
@pytest.mark.parametrize("width", WIDTHS)
def test_card_replay_at_a_later_start_equals_eager(width, case):
    # Captured on a fresh chunk at start 0, the graph is replayed at
    # start > 0: after a prefix preload (write_from > 0, the shared
    # pages mapped into the row) and after a non-final chunk.  Its tok0,
    # pages and scratch equal the eager Python-number call's, and the
    # shared pages stay as they were.
    _need_card()
    model = _model("cuda")
    pool = _pool(model)
    initial = _clone(pool)
    held = G.init_scratch(model, device="cuda")
    buf, scratch = held
    gen = torch.Generator(device="cuda")
    graphs = SeamGraphs(engine_mod._final_chunk_seam, gen, model.device)
    stage = engine_mod._Staging(
        engine_mod._final_chunk_fields(CFG["max_seq"], PAGES_PER_ROW), True)
    plen0 = width - 3
    fresh = np.pad(_prompt(width, plen0), ((0, 0), (0, 3)))
    _seam_call(graphs, stage, model, pool, scratch, fresh, width,
               _block_table(plen0, 0), plen0)
    assert len(graphs.captures) == 1 and graphs.replays == 0

    start, wfrom, plen, shared = _case(width, case)
    prompt = _prompt(width + len(case), plen + width)
    chunk = torch.from_numpy(prompt[:, start:start + width])
    bt = _block_table(plen, shared)
    results = []
    for replay in (True, False):
        for leaf, init in zip(G._pool_leaves(pool), G._pool_leaves(initial)):
            leaf.copy_(init)
        _prepare(model, pool, prompt, bt, start, case, held)
        if replay:
            inputs = stage.fill(chunk, bt, start, wfrom, plen, 0.0, None,
                                None)
            _, tok0 = graphs.run((model, scratch), pool, inputs,
                                 (width, False, False))
        else:
            _, tok0 = G.paged_prefill_finish(
                model, pool, scratch, chunk.cuda(), bt, start, wfrom, plen,
                0.0, gen)
        torch.cuda.synchronize()
        results.append((tok0.clone(), _clone(pool), _clone(scratch)))
        for p in bt[:shared]:
            for blk, old in zip(pool, initial):
                assert all(torch.equal(blk[n][p], old[n][p]) for n in blk)
    assert graphs.replays == 1 and len(graphs.captures) == 1
    (tok_r, pool_r, scr_r), (tok_e, pool_e, scr_e) = results
    assert torch.equal(tok_r, tok_e)
    assert _equal(pool_r, pool_e, skip_null=True)
    assert _equal(scr_r, scr_e)
    assert not _equal(pool_r, initial, skip_null=True)  # it wrote pages


@pytest.mark.card
def test_card_reset_recaptures_and_refuses_a_foreign_cache():
    _need_card()
    model = _model("cuda")
    buf, scratch = G.init_scratch(model, device="cuda")
    graphs = SeamGraphs(engine_mod._final_chunk_seam,
                        torch.Generator(device="cuda"), model.device)
    stage = engine_mod._Staging(
        engine_mod._final_chunk_fields(CFG["max_seq"], PAGES_PER_ROW), True)
    prompt, bt = _prompt(3, 64), _block_table(61, 0)
    pool = _pool(model)
    tok = _seam_call(graphs, stage, model, pool, scratch, prompt, 64, bt, 61)
    with pytest.raises(RuntimeError, match="another cache"):
        _seam_call(graphs, stage, model, _pool(model), scratch, prompt, 64,
                   bt, 61)
    graphs.reset()
    fresh = _pool(model)
    buf.zero_()
    again = _seam_call(graphs, stage, model, fresh, scratch, prompt, 64, bt,
                       61)
    buf.zero_()
    replay = _seam_call(graphs, stage, model, fresh, scratch, prompt, 64,
                        bt, 61)
    assert len(graphs.captures) == 2 and graphs.replays == 1
    assert torch.equal(tok, again) and torch.equal(again, replay)


def _card_engine(**kw):
    model = _model("cuda")
    return ContinuousBatchingEngine(
        model, 4, prompt_grid=16, prefill_chunk=256, page_size=64,
        prefix_cache=False, decode_steps=8, device="cuda", **kw)


@pytest.mark.card
def test_card_engine_one_capture_per_width_then_replays():
    # The benchmark's warm-up: one request a prompt bucket (16 to
    # 256), each a single final chunk of its bucket's width.
    _need_card()
    eng = _card_engine()
    buckets = [16, 32, 64, 128, 256]
    try:
        first = [eng.submit(_prompt(w, w), 4, 0.0, timeout=600)
                 for w in buckets]
        keys = [c["key"] for c in eng._prefill_graphs.captures]
        snap = eng.snapshot()
        again = [eng.submit(_prompt(w, w), 4, 0.0, timeout=600)
                 for w in buckets]
        later = eng.snapshot()
    finally:
        eng.close()
    assert keys == [(w, False, False) for w in buckets]
    assert snap["prefill_replays"] == 0
    assert later["prefill_replays"] == len(buckets)
    assert later["admitted"] - snap["admitted"] == len(buckets)
    assert again == first


@pytest.mark.card
def test_card_revived_engine_recaptures():
    # A persistent decode fault crashes the scheduler; the revived
    # engine has dropped the final-chunk graphs with the old cache,
    # captures anew on its next admission, then replays, with the same
    # tokens as before the crash.
    _need_card()
    eng = _card_engine(step_retries=0, retry_backoff_s=0.01)
    sup = EngineSupervisor(eng, max_restarts=3).start()
    prompt = _prompt(11, 40)
    try:
        before = eng.submit(prompt, 6, 0.0, timeout=600)
        real, calls = eng._fused_fn, []

        def flaky(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected fused-decode fault")
            return real(*a, **k)

        eng._fused_fn = flaky
        with pytest.raises(RuntimeError):
            eng.submit(prompt, 6, 0.0, timeout=600)
        deadline = time.monotonic() + 60
        while (time.monotonic() < deadline
               and eng.snapshot()["restarts"] < 1):
            time.sleep(0.02)
        assert eng.snapshot()["restarts"] >= 1
        assert eng._prefill_graphs.keys == []
        after = eng.submit(prompt, 6, 0.0, timeout=600)
        replays = eng.snapshot()["prefill_replays"]
        replayed = eng.submit(prompt, 6, 0.0, timeout=600)
        snap = eng.snapshot()
    finally:
        sup.stop()
        eng.close()
    assert before == after == replayed
    assert len(eng._prefill_graphs.captures) == 2
    assert snap["prefill_replays"] == replays + 1
