#!/usr/bin/env python3
"""Drive the PyTorch port's main path — paged LM serving decode — on one
NVIDIA H100, and hold every kernel on that path against its plain
PyTorch version.

    python3 chip_smoke.py

Phases, one JSON line each (stdout):
  1. device   — torch's view of the card; requires compute capability 9.0;
  2. build    — nvcc builds every csrc/*.cu for sm_90a (in parallel);
  3. kernels  — each kernel against its plain version at the main path's
                shapes (paged attention bf16 / f32 / int8 at b 16, 20
                pages of 64, 8 heads of 128; the int8 matmul at every
                projection shape and the f32-x head at rows 16 and 1),
                with bitwise null-page invariance, and the times of the
                kernel, the plain version and one PyTorch yardstick call;
  4. engine   — the bf16 engine, then the int8 engine, at the repo's LM
                width (dim 1024, depth 8, heads 8, vocab 32000, max_seq
                1280, 16 slots, page 64, prefill chunk 256) with seeded
                random weights: 8 greedy requests (two sharing a
                512-token prefix) through the paged prefix-cached
                lag-window engine, launch counters read around each run,
                tokens checked against the port's solo oracle.
Then the card's name and power limit (nvidia-smi), the kernels record,
and last the contract line {"ok": true, "device": {...}}.  Any failed
check raises: the script exits non-zero and prints no result.  Without a
CUDA device, or without the port beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {  # dense, per second (H100 SXM data sheet)
    "bf16": 989e12,
    "f32": 67e12,
}
CFG = dict(vocab=32000, dim=1024, depth=8, heads=8, max_seq=1280)
N_SLOTS, PAGE, CHUNK = 16, 64, 256
SEED = 0
# Oracle comparison: a greedy divergence is allowed only where the
# oracle's top-two logits lie within this many logit units.  bf16 keeps
# 8 significant bits, so one rounding of an activation near 4 moves it
# by 2**-6, and the batched paged engine and the batch-1 contiguous
# oracle round differently at every layer.
TOP2_TOL = 0.125


def emit(obj):
    print(json.dumps(obj), flush=True)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


class Timer:
    """Device time per call with the L2 flushed before each call (the
    main path finds its weights and pools cold): CUDA events around
    `iters` (flush, call) pairs, minus the same loop of flushes alone.
    The flush (a 256 MB memset) gives the host time to enqueue each
    call ahead of the card, so the host's dispatch cost is not counted
    as device time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def _loop(self, fn, iters):
        torch = self.torch
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        for _ in range(iters):
            self.flush.zero_()
            if fn is not None:
                fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    def ms(self, fn, iters=50, warmup=3):
        for _ in range(warmup):
            fn()
        with_fn = self._loop(fn, iters)
        alone = self._loop(None, iters)
        return max(with_fn - alone, 0.0) / iters


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# -- phase 3: kernels ------------------------------------------------------
def paged_case(torch, kv_dtype, q_dtype, full_view, gen):
    """Pools and block tables at the main path's shape: b 16 rows of 20
    pages of 64, 8 heads of 128.  full_view: every row sees its whole
    view; else each row's visibility ends at a random position and its
    unmapped tail points at the null page 0."""
    b, pages, h, d = N_SLOTS, CFG["max_seq"] // PAGE, CFG["heads"], 128
    n_pages = b * pages + 1
    dev = "cuda"
    q = torch.randn((b, h, d), generator=gen).to(dev, q_dtype)
    k = torch.randn((n_pages, PAGE, h, d), generator=gen)
    v = torch.randn((n_pages, PAGE, h, d), generator=gen)
    ks = vs = None
    if kv_dtype == torch.int8:
        ks = (k.abs().amax(-1) / 127.0).clamp_min(1e-8)
        vs = (v.abs().amax(-1) / 127.0).clamp_min(1e-8)
        k = torch.round(k / ks[..., None]).clamp(-127, 127)
        v = torch.round(v / vs[..., None]).clamp(-127, 127)
        ks, vs = ks.to(dev), vs.to(dev)
    k, v = k.to(dev, kv_dtype), v.to(dev, kv_dtype)
    bt = torch.arange(1, n_pages, dtype=torch.int32).view(b, pages)
    view = pages * PAGE
    if full_view:
        pos = torch.full((b,), view - 1)
    else:
        pos = torch.randint(0, view, (b,), generator=gen)
        pos[0], pos[1] = view - 1, 2 * PAGE - 1  # full, page boundary
        for i in range(b):
            bt[i, int(pos[i]) // PAGE + 1:] = 0  # unmapped tail
        bt[2, 0] = bt[0, 0]  # a shared prefix page
    mask = torch.arange(view)[None, :] <= pos[:, None]
    return q, k, v, bt.to(dev), mask.to(dev), ks, vs


def check_paged(torch, PA, timer, name, kv_dtype, q_dtype, gen):
    """Kernel vs plain (varied layout + full view), poison invariance on
    page 0, and times at the full view."""
    rec = {"name": name}
    errs = []
    for full in (False, True):
        q, k, v, bt, mask, ks, vs = paged_case(
            torch, kv_dtype, q_dtype, full, gen
        )
        out = PA._launch(q, k, v, bt, mask, ks, vs)
        ref = PA.paged_attention_plain(
            q, k, v, bt, mask, k_scale=ks, v_scale=vs
        )
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), name
        err = (out.float() - ref.float()).abs().max().item()
        if q_dtype == torch.float32:
            tol = 1e-5
        else:
            tol = bf16_ulp(ref.float().abs().max().item())
        errs.append(err)
        if err > tol:
            raise AssertionError(f"{name}: max_err {err} > tol {tol}")
        if not full:
            # Garbage in the null page must not move one output bit.
            k0, v0 = k[0].clone(), v[0].clone()
            if kv_dtype == torch.int8:
                k[0].fill_(127)
                v[0].fill_(-127)
                ks[0].fill_(1e30)
                vs[0].fill_(1e30)
            else:
                k[0].fill_(float("nan"))
                v[0].fill_(float("inf"))
            poisoned = PA._launch(q, k, v, bt, mask, ks, vs)
            torch.cuda.synchronize()
            if not torch.equal(poisoned, out):
                raise AssertionError(f"{name}: null page 0 leaked")
            k[0].copy_(k0)
            v[0].copy_(v0)
    rec["max_abs_err"] = max(errs)
    rec["tolerance"] = tol
    rec["tolerance_reason"] = (
        "f32 sums over 1280 lanes in another order, online rescale"
        if q_dtype == torch.float32 else
        "both sum in f32 and round once to bf16: one bf16 ulp of max|out|"
    )
    # Times at the full view (every row attends all 20 pages).
    b, pages, h, d = N_SLOTS, CFG["max_seq"] // PAGE, CFG["heads"], 128
    view = pages * PAGE
    rec["ms"] = timer.ms(lambda: PA._launch(q, k, v, bt, mask, ks, vs))
    rec["plain_ms"] = timer.ms(lambda: PA.paged_attention_plain(
        q, k, v, bt, mask, k_scale=ks, v_scale=vs))
    # Yardstick: SDPA over a pre-gathered (and pre-dequantized) dense
    # bf16/f32 view — the gather is not timed.
    g = bt.reshape(-1).long()
    kd = k[g].reshape(b, view, h, d)
    vd = v[g].reshape(b, view, h, d)
    if ks is not None:
        kd = (kd.float() * ks[g].reshape(b, view, h)[..., None]).to(q.dtype)
        vd = (vd.float() * vs[g].reshape(b, view, h)[..., None]).to(q.dtype)
    kd = kd.permute(0, 2, 1, 3).contiguous()
    vd = vd.permute(0, 2, 1, 3).contiguous()
    qd = q[:, :, None, :]
    am = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = timer.ms(lambda: sdpa(qd, kd, vd, attn_mask=am))
    el = k.element_size()
    nbytes = 2 * b * view * h * d * el + 2 * q.numel() * q.element_size()
    nbytes += bt.numel() * 4 + mask.numel()
    if ks is not None:
        nbytes += 2 * b * view * h * 4
    ops = 4.0 * b * h * view * d
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops, "f32")
    return rec


QMM_SHAPES = [  # (name, rows, in, out, x dtype, launches per decode step)
    ("qkv", N_SLOTS, 1024, 3072, "bf16", CFG["depth"]),
    ("proj", N_SLOTS, 1024, 1024, "bf16", CFG["depth"]),
    ("fc0", N_SLOTS, 1024, 4096, "bf16", CFG["depth"]),
    ("fc1", N_SLOTS, 4096, 1024, "bf16", CFG["depth"]),
    ("head", N_SLOTS, 1024, 32000, "f32", 1),
    ("head_prefill", 1, 1024, 32000, "f32", 0),
]


def check_qmm(torch, QM, timer, gen):
    """Every projection shape: kernel vs plain, and times.  The record's
    times are per decode step: the sum over the 33 launches one step
    makes (8 layers x qkv/proj/fc0/fc1 + the head)."""
    per_shape = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    nbytes_step = ops_bf16 = ops_f32 = 0.0
    worst = 0.0
    for name, rows, din, dout, xt, per_step in QMM_SHAPES:
        xdt = torch.bfloat16 if xt == "bf16" else torch.float32
        w = torch.randn((din, dout), generator=gen) / math.sqrt(din)
        w_i8, scale = QM.quantize_weight(w.cuda())
        x = torch.randn((rows, din), generator=gen).to("cuda", xdt)
        out = QM._launch(x, w_i8, scale)
        ref = QM.int8_weight_matmul_plain(x, w_i8, scale)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), name
        err = (out.float() - ref.float()).abs().max().item()
        mag = ref.float().abs().max().item()
        tol = (2.0 ** -7 if xt == "bf16" else 1e-4) * mag
        if err > tol:
            raise AssertionError(
                f"int8 matmul {name}: max_err {err} > tol {tol}"
            )
        worst = max(worst, err / mag)
        w_lib = (w_i8.float() * scale[None, :]).to(xdt)
        t = {
            "ms": timer.ms(lambda: QM._launch(x, w_i8, scale)),
            "plain_ms": timer.ms(
                lambda: QM.int8_weight_matmul_plain(x, w_i8, scale)
            ),
            "library_ms": timer.ms(lambda: torch.matmul(x, w_lib)),
        }
        nbytes = din * dout + dout * 4 + rows * (din + dout) * x.element_size()
        ops = 2.0 * rows * din * dout
        b_ms, b_by = bound_ms(nbytes, ops, xt)
        per_shape.append(dict(
            shape=name, rows=rows, in_dim=din, out_dim=dout, x=xt,
            max_abs_err=err, tolerance=tol, bound_ms=b_ms, bound_by=b_by,
            **t,
        ))
        for key in tot:
            tot[key] += per_step * t[key]
        nbytes_step += per_step * nbytes
        if xt == "bf16":
            ops_bf16 += per_step * ops
        else:
            ops_f32 += per_step * ops
    t_bytes = nbytes_step / HBM_BYTES_PER_S * 1e3
    t_ops = (ops_bf16 / PEAK_OPS["bf16"] + ops_f32 / PEAK_OPS["f32"]) * 1e3
    rec = {
        "name": "int8_weight_matmul",
        "max_abs_err": max(s["max_abs_err"] for s in per_shape),
        "worst_rel_err": worst,
        "tolerance_reason": (
            "bf16 x: 2**-7 x max|out| (the plain version rounds the "
            "dequantized weight to bf16; both round the output to bf16); "
            "f32 x: 1e-4 x max|out| (f32 sums in another order, scale "
            "after the sum vs before)"
        ),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "per_step_weight_bytes": nbytes_step,
        **tot,
    }
    return rec, per_shape


# -- phase 4: the engine ---------------------------------------------------
def requests(gen, torch):
    """8 greedy requests, prompts 64..1024 tokens; #2 and #4 share a
    512-token prefix (#4 is queued after #2, so its admission finds
    #2's pages in the radix cache)."""
    vocab = CFG["vocab"]

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=gen).numpy()

    shared = toks(512)
    return [
        (toks(64), 48),
        (toks(1024), 64),
        (np.concatenate([shared, toks(96)]), 40),
        (toks(300), 32),
        (np.concatenate([shared, toks(200)]), 56),
        (toks(777), 64),
        (toks(128), 32),
        (toks(900), 48),
    ]


def oracle_logits(torch, model, prompt, tokens, quant, qparams, deq):
    """Teacher-forced oracle logits along the ENGINE's token path: the
    solo prefill + contiguous decode of the port's oracle, fed the
    engine's tokens, so every step is compared on the same context."""
    from container_engine_accelerators_tpu_torch.models import generate as G
    from container_engine_accelerators_tpu_torch.models import (
        quant_generate as QG,
    )

    dev = model.device
    p = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    plen = p.shape[1]
    run = deq if quant else model
    cache = G.init_decode_cache(run, 1, device=dev)
    hidden, hk, hb = run(
        p, positions=torch.arange(plen, device=dev), cache=cache,
        write_pos=0, head_impl="chunked",
    )
    row = hidden[:, plen - 1]
    if quant:
        out = [QG._qmm(row, qparams["head"]) + qparams["head"]["bias"]]
        cache = QG.quantize_kv_cache(cache)
    else:
        out = [row @ hk + hb]
    for j, tok in enumerate(tokens[:-1]):
        t = torch.tensor([tok], device=dev)
        if quant:
            _, lg = QG.quant_decode_step(
                qparams, cache, t, plen + j, plen + j, None, model.heads
            )
        else:
            lg = model(t[:, None], positions=torch.tensor(
                [plen + j], device=dev), cache=cache, write_pos=plen + j)[:, 0]
        out.append(lg)
    return torch.cat(out, dim=0)


def profile_window(torch, eng, gen):
    """Device busy share and the top kernels over a decode-dominated
    window (16 rows, 64-token prompts, 32 new tokens) under
    torch.profiler.  Only starting the profiler is guarded: where it
    cannot start, or records no device activity, the share reads "not
    measured".  The requests themselves run unguarded, and each must
    return its 32 tokens."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts = torch.randint(0, CFG["vocab"], (N_SLOTS, 64), generator=gen)
    d0 = eng._dispatch_count
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        prof, why = None, repr(e)[:200]
    t0 = time.monotonic()
    hs = [eng.submit_nowait(p, 32) for p in prompts.numpy()]
    outs = [h.wait(timeout=900)[0] for h in hs]
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    assert all(len(o) == 32 for o in outs), [len(o) for o in outs]
    if prof is None:
        return {"device_busy_share": "not measured", "error": why}
    prof.stop()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = sum(by_name.values())
    if busy == 0:
        return {"device_busy_share": "not measured",
                "error": "no device events recorded"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "window_s": wall_us / 1e6,
        "dispatches": eng._dispatch_count - d0,
        "device_busy_share": busy / wall_us,
        "device_ms": busy / 1e3,
        "top_kernels_ms": [[name[:60], us / 1e3] for name, us in top],
    }


def run_engine(torch, model, quant, gen_reqs):
    from container_engine_accelerators_tpu_torch.models import generate as G
    from container_engine_accelerators_tpu_torch.models import (
        quant_generate as QG,
    )
    from container_engine_accelerators_tpu_torch.ops import (
        paged_attention as PA,
    )
    from container_engine_accelerators_tpu_torch.ops import quant_matmul as QM
    from container_engine_accelerators_tpu_torch.serving import (
        ContinuousBatchingEngine,
    )

    tag = "int8" if quant else "bf16"
    dev = model.device
    eng = ContinuousBatchingEngine(
        model, N_SLOTS, quant=quant, page_size=PAGE, prefill_chunk=CHUNK,
        device=dev,
    )
    try:
        eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 2, timeout=600)  # warm-up
        base = eng.snapshot()
        steps0 = eng._dispatch_count
        reqs = requests(gen_reqs, torch)
        PA.paged_attention.launches = 0
        QM.int8_weight_matmul.launches = 0
        t0 = time.monotonic()
        handles = [eng.submit_nowait(p, n) for p, n in reqs]
        outs = [h.wait(timeout=900)[0] for h in handles]
        wall = time.monotonic() - t0
        launches = {
            "paged_attention": PA.paged_attention.launches,
            "int8_weight_matmul": QM.int8_weight_matmul.launches,
        }
        dispatches = eng._dispatch_count - steps0
        snap = eng.snapshot()
        # Decode-dominated run: all 16 slots busy with short prompts,
        # so the wall time per dispatch approaches the step time.
        d0 = eng._dispatch_count
        t1 = time.monotonic()
        dec = [eng.submit_nowait(toks, 128) for toks in
               torch.randint(0, CFG["vocab"], (N_SLOTS, 64),
                             generator=gen_reqs).numpy()]
        dec_tok = sum(len(h.wait(timeout=900)[0]) for h in dec)
        dec_wall = time.monotonic() - t1
        dec_steps = eng._dispatch_count - d0
        profile = profile_window(torch, eng, gen_reqs)
    finally:
        eng.close()
    closed = eng.snapshot()
    n_tok = sum(len(o) for o in outs)
    assert all(len(o) == n for o, (_, n) in zip(outs, reqs)), tag
    assert snap["prefix_hits"] - base["prefix_hits"] >= 1, snap
    assert snap["kv_pages_in_use"] == snap["prefix_cached_pages"], snap
    assert closed["kv_pages_in_use"] == 0, closed
    depth = CFG["depth"]
    assert launches["paged_attention"] == depth * dispatches, (
        launches, dispatches)
    if quant:
        assert launches["int8_weight_matmul"] >= (4 * depth + 1) * dispatches
    else:
        assert launches["int8_weight_matmul"] == 0, launches

    qparams = eng._qparams if quant else None
    deq = eng._deq if quant else None
    first_div, margins, distinct = [], [], []
    oracle_fn = QG.generate_prefill_quant if quant else G.generate_prefill
    for (prompt, n), got in zip(reqs, outs):
        kw = {"qparams": qparams} if quant else {}
        solo = oracle_fn(
            model, prompt[None], len(prompt), n, 0.0,
            torch.Generator(device=dev), **kw,
        )[0].tolist()
        div = next((j for j, (a, b) in enumerate(zip(got, solo)) if a != b),
                   None)
        first_div.append(div)
        distinct.append(len(set(got)))
        lg = oracle_logits(torch, model, prompt, got, quant, qparams, deq)
        top = lg.float().max(dim=-1).values
        mine = lg.float().gather(
            1, torch.tensor(got, device=lg.device)[:, None])[:, 0]
        gap = (top - mine).max().item()
        margins.append(gap)
        if gap > TOP2_TOL:
            raise AssertionError(
                f"{tag} engine: token off the oracle's argmax by {gap} "
                f"logits (> {TOP2_TOL}) in request {len(margins) - 1}"
            )
    return {
        "phase": f"engine_{tag}",
        "requests": len(reqs),
        "tokens": n_tok,
        "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "decode_dispatches": dispatches,
        "wall_per_dispatch_ms": wall / max(dispatches, 1) * 1e3,
        "decode_run": {
            "rows": N_SLOTS, "prompt": 64, "new": 128,
            "tokens_per_s": dec_tok / dec_wall,
            "step_ms": dec_wall / max(dec_steps, 1) * 1e3,
        },
        "profile": profile,
        "launches": launches,
        "prefix_hits": snap["prefix_hits"] - base["prefix_hits"],
        "prefix_hit_tokens": snap["prefix_hit_tokens"]
        - base["prefix_hit_tokens"],
        "kv_pages_in_use_after_close": closed["kv_pages_in_use"],
        "first_divergence_vs_oracle": first_div,
        "max_gap_to_oracle_argmax": max(margins),
        "top2_tolerance": TOP2_TOL,
        "distinct_tokens": distinct,
    }, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from container_engine_accelerators_tpu_torch.models import (
            generate as G,
        )
        from container_engine_accelerators_tpu_torch.ops import (
            _build,
            paged_attention as PA,
            quant_matmul as QM,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    props = torch.cuda.get_device_properties(0)
    smi = nvidia_smi_line()
    emit({
        "phase": "device", "name": props.name,
        "capability": [props.major, props.minor],
        "sm_count": props.multi_processor_count,
        "memory_gb": props.total_memory / 1e9, "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    if (props.major, props.minor) != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0, got {props}")

    emit({"phase": "build", "seconds": _build.build_all(),
          "flags": list(_build.NVCC_FLAGS)})

    gen = torch.Generator().manual_seed(SEED)
    timer = Timer(torch)
    with torch.no_grad():
        k_bf16 = check_paged(torch, PA, timer, "paged_attention_bf16",
                             torch.bfloat16, torch.bfloat16, gen)
        k_f32 = check_paged(torch, PA, timer, "paged_attention_f32",
                            torch.float32, torch.float32, gen)
        k_int8 = check_paged(torch, PA, timer, "paged_attention_int8",
                             torch.int8, torch.bfloat16, gen)
        k_qmm, qmm_shapes = check_qmm(torch, QM, timer, gen)
    emit({"phase": "kernels", "paged_attention": [k_bf16, k_f32, k_int8],
          "int8_weight_matmul": k_qmm, "int8_matmul_shapes": qmm_shapes,
          "card": smi})

    model = G.make_decoder(device="cuda", **CFG)
    model.init_random(torch.Generator().manual_seed(SEED))
    engine_bf16, l_bf16 = run_engine(
        torch, model, False, torch.Generator().manual_seed(SEED + 1)
    )
    emit({**engine_bf16, "card": smi})
    engine_int8, l_int8 = run_engine(
        torch, model, True, torch.Generator().manual_seed(SEED + 1)
    )
    emit({**engine_int8, "card": smi})

    src = "container_engine_accelerators_tpu_torch/csrc/"
    ref = "container_engine_accelerators_tpu/ops/"
    kernels = []
    for rec, launches, source, replaces in (
        (k_bf16, l_bf16["paged_attention"], "paged_attention.cu",
         "paged_attention.py:93"),
        (k_int8, l_int8["paged_attention"], "paged_attention.cu",
         "paged_attention.py:93"),
        (k_qmm, l_int8["int8_weight_matmul"], "quant_matmul.cu",
         "quant_matmul.py:31"),
    ):
        if launches < 1:
            raise AssertionError(f"{rec['name']} never ran on the main path")
        kernels.append({
            "name": rec["name"], "route": "cuda", "source": src + source,
            "replaces": ref + replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
