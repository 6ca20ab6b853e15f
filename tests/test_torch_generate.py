"""The port's decode seams (container_engine_accelerators_tpu_torch/
models/generate.py and quant_generate.py) against the reference's, on
the same numpy-drawn weights: the oracles generate_prefill and
generate_prefill_quant (per-step logits and greedy tokens), the paged
admission and decode seams (tokens and pool contents), and the sampling
rule (the same top-k / top-p keep mask on the same logits — the two
frameworks' random streams differ, so sampled tokens cannot be
compared)."""

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
# Int8 pools: a k/v value within ATOL of the reference's may still
# round to the neighbouring int8 step, one scale (max|k| / 127) away.
POOL_STEP_ATOL = 3e-2


@pytest.fixture(scope="module")
def setup():
    params = draw_params(0)
    return jax_decoder(), jax_params(params), port_model(params)


def _gen():
    return torch.Generator()


def _jax_forced_logits(dec, jp, prompt, toks, quant):
    """Reference per-step logits along `toks` (teacher-forced)."""
    p = jnp.asarray(prompt)
    plen = prompt.shape[1]
    if quant:
        qp = QG.quantize_decode_params(jp)
        deq = QG.dequantize_decode_params(qp, jp)
        cache = G._zero_cache(dec, p)
        (hid, _, _), upd = dec.clone(head_impl="chunked").apply(
            {"params": deq, "cache": cache}, p,
            positions=jnp.arange(plen), mutable=["cache"],
        )
        out = [QG._qmm(hid[:, -1], qp["head"]) + qp["head"]["bias"]]
        qc = QG.quantize_kv_cache([
            {"k": upd["cache"][f"block_{i}"]["cached_key"],
             "v": upd["cache"][f"block_{i}"]["cached_value"]}
            for i in range(CFG["depth"])
        ])
        for j, t in enumerate(toks[:-1]):
            qc, lg = QG.quant_decode_step(
                qp, qc, jnp.asarray([t]), plen + j, plen + j, None,
                CFG["heads"],
            )
            out.append(lg)
        return np.concatenate([np.asarray(o) for o in out])
    cache = G._zero_cache(dec, p)
    lg, upd = dec.apply({"params": jp, "cache": cache}, p,
                        positions=jnp.arange(plen), mutable=["cache"])
    out = [np.asarray(lg[:, -1])]
    cache = upd["cache"]
    for j, t in enumerate(toks[:-1]):
        lg, upd = dec.apply(
            {"params": jp, "cache": cache}, jnp.asarray([[t]]),
            positions=jnp.asarray([plen + j]), mutable=["cache"],
        )
        cache = upd["cache"]
        out.append(np.asarray(lg[:, 0]))
    return np.concatenate(out)


def _port_forced_logits(pm, prompt, toks, quant):
    p = torch.from_numpy(prompt).long()
    plen = prompt.shape[1]
    if quant:
        qp = TQG.quantize_decode_params(pm)
        deq = TQG.dequantize_decode_params(qp, pm)
        cache = TG.init_decode_cache(deq, 1, device="cpu")
        hid, _, _ = deq(p, positions=torch.arange(plen), cache=cache,
                        write_pos=0, head_impl="chunked")
        out = [TQG._qmm(hid[:, -1], qp["head"]) + qp["head"]["bias"]]
        qc = TQG.quantize_kv_cache(cache)
        for j, t in enumerate(toks[:-1]):
            _, lg = TQG.quant_decode_step(
                qp, qc, torch.tensor([t]), plen + j, plen + j, None,
                CFG["heads"],
            )
            out.append(lg)
        return torch.cat(out).numpy()
    cache = TG.init_decode_cache(pm, 1, device="cpu")
    out = [pm(p, positions=torch.arange(plen), cache=cache,
              write_pos=0)[:, -1]]
    for j, t in enumerate(toks[:-1]):
        out.append(pm(torch.tensor([[t]]),
                      positions=torch.tensor([plen + j]), cache=cache,
                      write_pos=plen + j)[:, 0])
    return torch.cat(out).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16path", "int8"])
@pytest.mark.parametrize("seed,p_len,n", [(3, 5, 10), (4, 13, 12)])
def test_oracle_tokens_and_logits_match(setup, quant, seed, p_len, n):
    dec, jp, pm = setup
    prompt = rand_prompt(seed, p_len)
    jfn = QG.generate_prefill_quant if quant else G.generate_prefill
    tfn = TQG.generate_prefill_quant if quant else TG.generate_prefill
    want = np.asarray(jfn(dec, jp, jnp.asarray(prompt), p_len, n, 0.0,
                          jax.random.PRNGKey(0)))[0].tolist()
    assert len(set(want)) > 1, want  # a token comparison must mean something
    got = tfn(pm, prompt, p_len, n, 0.0, _gen())[0].tolist()
    assert got == want
    jl = _jax_forced_logits(dec, jp, prompt, want, quant)
    tl = _port_forced_logits(pm, prompt, want, quant)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)


def test_oracle_per_row_bucketed_prompts(setup):
    # Two rows of one 16-wide bucket with different real lengths: the
    # bucket tail stays invisible and each row decodes from its own end.
    dec, jp, pm = setup
    prompt = np.concatenate([rand_prompt(7, 16), rand_prompt(8, 16)])
    plen = np.array([9, 16], np.int32)
    want = np.asarray(G.generate_prefill(
        dec, jp, jnp.asarray(prompt), jnp.asarray(plen), 8, 0.0,
        jax.random.PRNGKey(0),
    ))
    got = TG.generate_prefill(pm, prompt, plen, 8, 0.0, _gen()).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("p_len,bucket,n",
                         [(5, 8, 10), (13, 16, 12), (16, 16, 8)])
def test_generate_padded_matches_reference_greedy(setup, p_len, bucket, n):
    # The bucket-shaped twin: the real prompt in the first p_len
    # columns of two rows, the tail padding; greedy tokens equal the
    # reference's generate_padded and the port's own generate_prefill.
    dec, jp, pm = setup
    prompt = np.zeros((2, bucket), np.int32)
    prompt[:, :p_len] = np.concatenate(
        [rand_prompt(p_len, p_len), rand_prompt(p_len + 1, p_len)])
    want = np.asarray(G.generate_padded(
        dec, jp, jnp.asarray(prompt), p_len, n, 0.0, jax.random.PRNGKey(0),
    ))
    assert len(set(want[0].tolist())) > 1, want
    got = TG.generate_padded(pm, prompt, p_len, n, 0.0, _gen()).numpy()
    assert np.array_equal(got, want)
    oracle = TG.generate_prefill(pm, prompt, p_len, n, 0.0, _gen()).numpy()
    assert np.array_equal(got, oracle)


def test_generate_prefill_quant_takes_a_prebuilt_twin(setup):
    # deq= (built once by a caller that decodes many batches) gives the
    # tokens of the call that dequantizes for itself.
    _, _, pm = setup
    prompt = rand_prompt(5, 11)
    qp = TQG.quantize_decode_params(pm)
    deq = TQG.dequantize_decode_params(qp, pm)
    a = TQG.generate_prefill_quant(pm, prompt, 11, 9, 0.0, _gen(),
                                   qparams=qp)
    b = TQG.generate_prefill_quant(pm, prompt, 11, 9, 0.0, _gen(),
                                   qparams=qp, deq=deq)
    assert torch.equal(a, b)


def test_paged_seams_match(setup):
    # Two admissions through the paged finish seam (the second resumes
    # after a preloaded 8-token shared prefix page), then decode steps
    # with one row going inactive: tokens and pools match every step.
    dec, jp, pm = setup
    n_pages, per_row = 17, CFG["max_seq"] // PAGE
    jcache = G.init_paged_cache(dec, n_pages, PAGE)
    tcache = TG.init_paged_cache(pm, n_pages, PAGE, device="cpu")
    a = rand_prompt(11, 13)
    b = np.concatenate([a[:, :8], rand_prompt(12, 7)], axis=1)
    bt = np.zeros((2, per_row), np.int32)
    bt[0, :4] = [1, 2, 3, 4]
    bt[1, :4] = [1, 5, 6, 7]  # page 1 shared with row 0
    toks = []
    for row, (prompt, start, wfrom) in enumerate([(a, 0, 0), (b, 8, 8)]):
        chunk = np.zeros((1, 16 if start == 0 else 8), np.int32)
        chunk[0, :prompt.shape[1] - start] = prompt[0, start:]
        jscr = G.paged_preload_scratch(
            jcache, G.init_decode_cache(dec, 1), jnp.asarray(bt[row]),
            jnp.int32(start),
        )
        tscr = TG.paged_preload_scratch(
            tcache, TG.init_decode_cache(pm, 1, device="cpu"), bt[row],
            start,
        )
        jcache, jt = G.paged_prefill_finish(
            dec, jp, jcache, jscr, jnp.asarray(chunk), jnp.asarray(bt[row]),
            jnp.int32(start), jnp.int32(wfrom),
            jnp.int32(prompt.shape[1]), jnp.float32(0.0),
            jax.random.PRNGKey(0),
        )
        tcache, tt = TG.paged_prefill_finish(
            pm, tcache, tscr, chunk, bt[row], start, wfrom,
            prompt.shape[1], 0.0, _gen(),
        )
        assert int(tt[0]) == int(jt[0])
        toks.append(int(tt[0]))
    pos = np.array([13, 15], np.int32)
    tok = np.array(toks, np.int32)
    seen = []
    for step in range(6):
        active = np.array([True, step < 3])
        jcache, jn = G.paged_decode_step(
            dec, jp, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(bt), jnp.zeros(2),
            jax.random.PRNGKey(0),
        )
        tcache, tn = TG.paged_decode_step(
            pm, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(bt),
            torch.zeros(2), _gen(),
        )
        jn = np.asarray(jn)
        assert np.array_equal(tn.numpy()[active], jn[active]), step
        seen.extend(jn[active].tolist())
        tok = np.where(active, jn, tok).astype(np.int32)
        pos = np.where(active, pos + 1, pos).astype(np.int32)
    assert len(set(seen)) > 1, seen
    for i in range(CFG["depth"]):
        np.testing.assert_allclose(
            tcache[i]["k"].numpy(),
            np.asarray(jcache[f"block_{i}"]["cached_key"]), atol=ATOL,
        )


def test_quant_paged_seams_match(setup):
    dec, jp, pm = setup
    n_pages, per_row = 9, CFG["max_seq"] // PAGE
    qp_j = QG.quantize_decode_params(jp)
    deq_j = QG.dequantize_decode_params(qp_j, jp)
    qp_t = TQG.quantize_decode_params(pm)
    deq_t = TQG.dequantize_decode_params(qp_t, pm)
    jcache = QG.init_quant_paged_cache(dec, n_pages, PAGE)
    tcache = TQG.init_quant_paged_cache(pm, n_pages, PAGE, device="cpu")
    bt = np.zeros((2, per_row), np.int32)
    bt[0, :3] = [1, 2, 3]
    bt[1, :3] = [4, 5, 6]
    toks = []
    for row, seed in enumerate((21, 22)):
        prompt = rand_prompt(seed, 11)
        chunk = np.zeros((1, 16), np.int32)
        chunk[0, :11] = prompt[0]
        jcache, jt = QG.quant_paged_prefill_finish(
            dec, deq_j, qp_j, jcache, G.init_decode_cache(dec, 1),
            jnp.asarray(chunk), jnp.asarray(bt[row]), jnp.int32(0),
            jnp.int32(0), jnp.int32(11), jnp.float32(0.0),
            jax.random.PRNGKey(0),
        )
        tcache, tt = TQG.quant_paged_prefill_finish(
            deq_t, qp_t, tcache, TG.init_decode_cache(deq_t, 1, device="cpu"),
            chunk, bt[row], 0, 0, 11, 0.0, _gen(),
        )
        assert int(tt[0]) == int(jt[0])
        toks.append(int(tt[0]))
    tok = np.array(toks, np.int32)
    pos = np.array([11, 11], np.int32)
    active = np.array([True, True])
    seen = []
    for _ in range(5):
        jcache, jn = QG.quant_paged_engine_decode_step(
            qp_j, jcache, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(bt), jnp.zeros(2),
            jax.random.PRNGKey(0), CFG["heads"],
        )
        tcache, tn = TQG.quant_paged_engine_decode_step(
            qp_t, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(active), torch.from_numpy(bt),
            torch.zeros(2), _gen(), CFG["heads"],
        )
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        seen.extend(np.asarray(jn).tolist())
        tok = np.asarray(jn).astype(np.int32)
        pos = pos + 1
    assert len(set(seen)) > 1, seen
    for i in range(CFG["depth"]):
        jk = np.asarray(jcache[i]["k"], np.float32) * np.asarray(
            jcache[i]["k_scale"])[..., None]
        tk = tcache[i]["k"].float().numpy() * tcache[i][
            "k_scale"].numpy()[..., None]
        np.testing.assert_allclose(tk, jk, atol=POOL_STEP_ATOL)


def _jax_keep(scaled, top_k, top_p):
    """The reference's keep rule (generate.py:148-160) in vocab order."""
    b, vocab = scaled.shape
    sorted_logits, sorted_idx = jax.lax.top_k(jnp.asarray(scaled), vocab)
    keep = jnp.ones((b, vocab), bool)
    ranks = jnp.arange(vocab)[None, :]
    keep &= ranks < jnp.maximum(jnp.asarray(top_k)[:, None], 1)
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum_before = jnp.cumsum(probs, axis=-1) - probs
    keep &= cum_before < jnp.clip(jnp.asarray(top_p)[:, None], 1e-6, 1.0)
    out = np.zeros((b, vocab), bool)
    np.put_along_axis(out, np.asarray(sorted_idx), np.asarray(keep), 1)
    return out


def test_sampling_keep_mask_matches_and_bounds_draws():
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((4, 64))).astype(np.float32)
    temp = np.array([0.7, 1.0, 1.3, 0.0], np.float32)
    top_k = np.array([5, 64, 1, 10], np.int32)
    top_p = np.array([1.0, 0.6, 0.9, 0.5], np.float32)
    scaled = logits / np.maximum(temp, 1e-6)[:, None]
    want = _jax_keep(scaled, top_k, top_p)
    _, idx, keep = TG.keep_mask(torch.from_numpy(scaled),
                                torch.from_numpy(top_k),
                                torch.from_numpy(top_p))
    got = np.zeros_like(want)
    np.put_along_axis(got, idx.numpy(), keep.numpy(), 1)
    assert np.array_equal(got, want)
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = TG._sample(torch.from_numpy(logits), torch.from_numpy(temp),
                         gen, torch.from_numpy(top_k),
                         torch.from_numpy(top_p)).numpy()
        assert all(want[r, t] for r, t in enumerate(tok[:3]))
        assert tok[3] == int(np.argmax(logits[3]))  # greedy row
