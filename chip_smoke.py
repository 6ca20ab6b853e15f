#!/usr/bin/env python3
"""Drive the PyTorch port's main paths — LM serving decode (paged,
fused, contiguous and speculative), the HTTP server over it and the
replica fleet,
single-card LM training (lm_main's
width at every head dim, and lm_large with the chunked vocab head),
single-card ResNet-50 and Inception-v3 training, and checkpoints — on
one NVIDIA H100, and hold every kernel on those paths against its plain
PyTorch version.

    python3 chip_smoke.py
    python3 chip_smoke.py --only mesh_serve   # phase 4e alone, over
                                              # every visible card
    python3 chip_smoke.py --only device_plugin  # phase 4f alone
    python3 chip_smoke.py --only mesh_modes   # phase 11 alone
    python3 chip_smoke.py --only flash_mla    # phase 5's (192, 128) flash
                                              # check alone

Phases, one JSON line each (stdout):
  1. device   — torch's view of the card; requires compute capability 9.0;
  2. build    — nvcc builds every csrc/*.cu for sm_90a (in parallel);
  3. kernels  — each kernel against its plain version at the main path's
                shapes (paged attention bf16 / f32 / int8 at b 16, 20
                pages of 64, 8 heads of 128, and a ragged batch of 3
                rows of 11 pages; the int8 matmul at every projection
                shape, the f32-x head at rows 16 and 1, every projection
                and the head again at rows 32 and 64 (the int8 engine's
                verify windows of width 2 and 4 over 16 slots), and
                ragged shapes), with bitwise null-page invariance, two launches
                bitwise equal, a planted 1% fault that must fail the
                check, one device launch and one allocation a call, and
                the times of the kernel, the plain version and one
                PyTorch yardstick call (the int8 matmul also with
                clusters of 8);
  4. engine   — the bf16 engines, then the int8 engines, at the repo's
                LM width (dim 1024, depth 8, heads 8, vocab 32000,
                max_seq 1280, 16 slots, page 64, prefill chunk 256) with
                seeded random weights, each in four configurations: the
                paged prefix-cached lag-window engine (engine_bf16,
                engine_int8), the same with fused blocks of up to 4
                decode steps, one CUDA graph a width (engine_*_fused),
                the contiguous-slot engine (paged=False,
                engine_*_contig), and speculative decoding with windows
                of up to 4 (spec_k=4, engine_*_spec: the int8 twin
                drafts, one batched pass verifies; one CUDA graph per
                draft width and per verify key).  Each runs 8 greedy
                requests (two sharing a 512-token prefix) with the
                launch counters read around them (exactly depth paged
                calls a one-token or fused decode step, none in a
                verify window; >= 33 int8 matmul calls a decode step,
                and on the speculative engines exactly 33 a drafter pass
                less one a chain, plus 33 a step or window and one an
                admission in int8; replays counted call by call),
                tokens held to the port's solo oracle; every engine
                then runs 16 rows x (64 + 128) and a profiled window of
                16 x (64 + 32) whose device events must equal the
                wrappers' calls (with the host's op times); the fused and speculative engines also
                fail one block (window) until the retries are spent, and
                the supervisor's revival must recapture the graphs
                against the fresh caches, give the same tokens and leave
                no page in use.  A speculative engine fails if its
                drafter degraded in any run, drafted nothing, or never
                dispatched a window of width 4.  The fused, contiguous
                and speculative records carry their figures over the
                one-token engine's of the same run (`vs_one_token`) and
                each request's first divergence from its tokens (these
                engines run with observe=False);
  4b. engine_tiers, engine_migrate, engine_observe — at the same width:
                engine_tiers_bf16 / _int8 run 32 sessions of distinct
                1024-token prompts (+ 32 tokens) through the default
                320-page pool with a host tier of 128 pages and a 1 GiB
                disk tier, then the first session cut where its
                host-resident pages end (a host-only promotion) and the
                first 8 sessions whole (promotions reading disk and
                host) return: pages demoted, promotions under both
                labels of kv_tier_fetch_seconds, the prefix hit, tokens
                within the oracle rule, the first 8 sessions' exports
                bitwise the same before the pressure and after the
                return, no open tier handle, no page in use after close,
                depth paged-attention calls a returning decode step (and
                the int8 matmul's in int8); it prints promotion ms a
                page by label (gross and net of the demotion that makes
                room), store loads by tier, each return's TTFT beside the
                same prompts recomputed on an engine with no tier, and
                the phase's seconds.  engine_migrate_bf16 / _int8: engine
                A serves the 8 requests and exports their shared 512-token
                prefix, a fresh B adopts it (the int8 B first refuses the
                bf16 blob, and a fresh bf16 engine the int8 blob, holding
                no page) and serves the two sharing requests as prefix
                hits with A's tokens, and re-exports A's blob bitwise;
                export / adopt ms and bytes/s.
                engine_observe_bf16_fused: the 8 requests through fused
                engines with observe on and off in turns (off, on, on,
                off), equal tokens, the TTFT count equal to the rows and
                the ITL count to the tokens less the rows, /metrics
                rendered and parsed back, each trace's queue-wait,
                prefill-chunk and decode spans, a revival whose recorder
                holds the retries, the failure and the restart, and a
                kill whose snapshot carries the recorder; tokens/s
                observed over unobserved and TTFT / ITL p50 and p99;
  4c. server  — the HTTP server (server.py), booted in-process as a
                user's command line builds it (parse_args, load_model,
                random weights from seed 0) at the same width:
                server_int8 (--quant auto: int8 at 16 slots) and
                server_bf16 (--quant off) over the continuous engine,
                server_wave (--engine wave --quant auto): /healthz 503
                "loading" before the load and 200 after, requests()' 8
                requests POSTed at once (server_wave adds 8 short ones
                of one bucket key, which must coalesce), every token
                within the oracle rule, a prefix hit, /metrics parsed
                back (8 answers of 200, 8 TTFT samples), /tracez holding
                every response's trace id, a malformed request's 400,
                then the drain: drain_for_shutdown with two requests in
                flight, both answered in full, a new /generate 503 with
                a Retry-After, /healthz "draining: shutdown", /metrics
                200, the server stopped within the drain timeout and no
                page in use after close; the serving kernels' launches
                over the phase agree with the engine's steps.  Each
                prints HTTP tokens/s and its ratio to the one-token
                engine's on the same requests (`vs_engine`), request
                latency and TTFT p50 / p99, boot and drain seconds.
                server_predict (ResNet-50, 224 x 224, --batch 8): 8
                single-image requests at once and a batch of 8, labels
                the served model's own eval argmax; images/s over HTTP;
  4d. fleet   — two replicas of 16 slots on the one card (serving/fleet.py),
                the server's engine kwargs (server.py engine_kw), traffic
                requests() then 4 groups of 4 requests sharing a 512-token
                prefix (128-token tails, 64 new), each request placed
                after the one before: fleet_inproc_int8 (FleetManager,
                int8 one-token paged) holds every token to the oracle,
                each group's followers on its leader's replica by
                affinity with a prefix hit, both replicas serving, the
                launches against the steps, a profiled window whose device
                events equal the wrappers' calls over both scheduler
                threads, then install_fleet_faults with engine_death:1
                persistent over 4 waves until replica 1 is evicted with
                every request completed and no failure on replica 0;
                fleet_inproc_bf16_fused (--quant off --decode-steps 4,
                migrate on) the same traffic with CUDA graphs captured by
                both replicas in one process, a group's prefix fetched off
                its owner (export, adopt) serving the owner's tokens
                bitwise, then a prefill:1,decode:1 fleet with at least one
                prefill handoff; fleet_procs_int8 (ProcessFleetManager
                over demo_lm_factory, 2 worker processes on the card over
                Unix sockets) the int8 fleet's tokens, each worker
                holding the card, a SIGKILLed worker respawned with its
                request re-routed, engine="0" / "1" on the relabelled
                /metrics; server_fleet the server from --fleet 2 and from
                --fleet-procs 2: requests() over HTTP with the int8
                fleet's tokens, both engine labels on /metrics, the
                assembled traces on /tracez, the drain (SIGTERM's path)
                finishing two in-flight requests, the workers exiting 0.
                Each prints tokens/s beside the one-token engine's
                (`vs_engine`), placements, hits, reroutes and spills,
                eviction and respawn s, migrate ms a page, boot and spawn
                s;
  4e. mesh and health — mesh_serve: the contiguous bf16 engine (16
                slots) on a parallel.mesh.LocalMesh of every visible card,
                or of the one card named twice (two shards of 8 rows),
                against the unsharded contiguous engine on requests():
                equal greedy tokens or the oracle rule where a row parts,
                each shard's cache on its device, the serving kernels and
                flash counted (0 on this path); generate_sharded against
                generate_prefill on the 8 prompts; the server with --mesh
                dp answering two requests within the oracle rule; tokens/s
                against the unsharded engine.  health_nvml: native/nvml.py
                against torch (device count, UUID unless the NVIDIA driver
                redacts it, total less its reservation, used
                bytes up by a 1 GiB allocation), an Xid event set whose
                wait(500) times out within 0.45-1.5 s, the nvml-fields
                layer active with no event on the healthy card, and the
                server with --health-source auto ready and answering
                (where NVML refuses event registration, the refusal is
                held instead and that server must fail to load);
  4f. device_plugin — the device-plugin daemon (device_plugin.py, as its
                entry point starts it) over the machine's /dev and NVML,
                its sockets under a short directory, with a fake kubelet
                and a fake pod-resources service giving one pod the card:
                discovery exactly NVML's cards by minor number, the
                registration, ListAndWatch all Healthy, Allocate the
                card's node with nvidiactl and nvidia-uvm, a synthetic
                Unhealthy on the manager's health queue reaching the
                stream, and /metrics scraped over HTTP while a bf16
                matmul loop runs: duty cycle above 0 on the node and the
                container gauge, used memory up by a 1 GiB allocation;
                registration, Allocate round trip, health-to-stream and
                scrape times.  Every kernel wrapper's count is 0 over the
                phase (the kernels record's launches_device_plugin);
  5. train_kernels — flash attention forward and backward at (8, 2048,
                h, 1024 / h) bf16 for h 8, 16, 32 and 4 (head dims 128,
                64, 32 on the d-64 instance, 256) and at the ragged
                (8, 1024, 8, 96) on the d-128 instance, q / k / v the
                strided views of one qkv projection, each timed beside
                the plain version and SDPA with its bound (bytes,
                products or exponentials) and ptxas's registers and
                spills, and held (not timed) at seq 128, 192 (half a
                128-row tile) and 8192, and at d 256, 160 and 40 on
                seq 192; latent attention's (192, 128) instance at
                moonlight.train8k's (8, 8192, 16), v the strided
                kv[..., 128:], against the plain version a (batch, 4
                heads) slice at a time, timed beside it and SDPA with its
                bound at the true widths, its launches those of one
                MLAttention layer's forward and backward (one each); and
                the fused
                cross-entropy forward and backward at 16384 x 32000 f32
                (and at 64 rows in f32 and bf16, C 1000 and 32000, timed
                beside F.cross_entropy); each against its plain version
                (and its autograd), flash per 16-row tile with a planted
                fault that must fail the check, and every flash backward
                run twice and held bitwise equal;
  6. train    — lm_main's full default width (vocab 32000, dim 1024,
                depth 8, heads 8, seq 2048, batch 8, lr 3e-4), seeded
                weights: one step of the kernel path against the plain
                path (the loss and every gradient), then 20 steps on one
                batch (the loss finite and falling, launch counters read
                around them: 8 + 8 flash and 1 + 1 xent per step), step
                time, tokens/s, the model-FLOPs share of peak, a 3-step
                profile and the f32 head's share of the step; then the
                command-line trainer (lm_main) at its defaults for a
                warm-up step and 3 logged steps, and again with --heads
                16, 32 and 4 (head dims 64, 32 and 256: 8 + 8 flash
                launches a step, the logged loss falling);
  6b. lm_large_train — bench.py's lm_large (dim 2048 x 16 layers, seq
                2048, batch 2, vocab 32000, ~0.94B parameters, the
                chunked head in 8192-column chunks), not cut: one step
                against the dense head's trainer from the same weights
                (loss within 2**-9), the head + loss's own peak memory
                below the dense head's, 10 steps (the loss falling, 16
                + 16 flash launches a step), step time, tokens/s, the
                model-FLOPs share and a 2-step profile;
  7. vision_kernels — the fused-matmul kernel (matmul_stats and
                affine_relu_matmul_stats) at its 12 ResNet-50 shapes, and
                the 3x3 conv kernel at ResNet-50's 4 stride-1 shapes,
                forward with and without the prologue and the backward
                through autograd, each against its plain version (y and
                the data gradient per 16-row tile of one column, with a
                planted 1% fault on a column that must fail the check),
                timed beside the plain version, torch.matmul / cuDNN;
  8. vision_train — ResNet-50 at the fused-block configuration (s2d
                stem, block_impl fused_pallas, batch 256, 224 x 224, SGD
                lr 0.1), seeded weights with nonzero bn3 scales: one step
                of the kernel path against the plain path (the loss,
                every gradient, the running statistics), 20 steps on one
                batch (the loss falling, exactly 16 + 16 fused-matmul
                launches a step), step time, images/s, the model-FLOPs
                share of the bf16 peak, a 3-step profile; then
                resnet_main at its defaults for a warm-up step and 3
                logged steps;
  8b. inception_train — Inception v3 at the reference's demo job (299 x
                299, batch 128): 8 steps on one batch (the loss
                falling), step time, images/s, a 2-step profile, then
                resnet_main --model inception_v3 for a warm-up step and
                3 logged steps;
  9. checkpoint — lm_main with --model-dir at depth 2 trains and saves,
                a second run resumes from its checkpoint and saves past
                it; a saved and restored trainer's tensors are bitwise
                the saved ones; resnet_main --model-dir writes
                checkpoint_<n>;
  10. moe_train — the MoE LM (models/moe_lm.py) at lm_main's full width
                (vocab 32000, dim 1024, depth 8, heads 8, seq 2048, batch
                8, 8 experts, top-2 every 2nd block, capacity 1.25, 2
                reroute rounds, aux weight 0.01, AdamW 3e-4) on a
                one-rank NCCL group (the script needs one card): the
                backend nccl and every parameter and the batch on the
                card; one step of the flash path against the dense
                attention path from the same weights, the dense path
                replaying the flash path's routing (the loss within
                2**-9, every gradient within 2**-5; the tokens whose own
                routing would differ are counted), 8 + 8 flash
                launches a step; 10 steps (aux, drop fraction, step
                time, tokens/s, peak bytes, the model-FLOPs share:
                bench.py's dense formula plus its moe_extra at 989
                TFLOP/s) and a 2-step profile by kind;
  11. mesh_modes — on the same one-rank NCCL group, at lm_main's widths
                cut to depth 2: dp, sp (contiguous and zigzag ring), tp
                and pp (one stage, n_virtual 2, 8 microbatches), each
                one step from the seed's weights with its first loss
                within 2**-9 of build_lm_training's without a mesh and
                its flash and xent launches counted; a ResNet-50 dp step
                at batch 32 against its no-mesh step (2**-9); then, at
                full width with cuDNN's deterministic algorithms, each
                vision configuration the reference trains under a mesh
                one step over the mesh against its no-mesh step from
                the same weights and batch, the loss, every gradient and
                every running statistic within 2**-9 and the launches
                equal: ResNet-50 with the s2d stem, the fused block (B6:
                16 + 16 launches a step) and the fused loss (B4) at
                batch 128, ResNet-50 with flax's BatchNorm at batch 128,
                Inception v3 at 299 x 299, batch 64, then 3 more steps
                of each timed (`mesh_over_plain`) and one profiled;
                lm_main --mode ep
                on the one card exits 2 naming ">1 chip"; then
                resnet_main's spawned job path: `rank_main` through
                launch.spawn_ranks on one rank (a process of its own,
                NCCL, the mesh) with --model inception_v3 at 299, batch
                64, a warm-up step and 2 logged steps and a checkpoint
                from rank 0, its log lines read back.
Then the card's name and power limit (nvidia-smi), the kernels record,
and last the contract line {"ok": true, "device": {...}}.  Each JSON line
is also written to smoke_out/chip_smoke.jsonl beside this script.  Any failed
check raises: the script exits non-zero and prints no result.  Without a
CUDA device, or without the port beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

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


# Every JSON line printed is also written here (gitignored): the
# phases' lines outgrow what a caller may keep of the end of the output.
LOG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")
LOG_PATH = os.path.join(LOG_DIR, "chip_smoke.jsonl")


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LOG_PATH, "a") as f:
        f.write(line + "\n")


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


class Timer:
    """Device time per call with the L2 flushed before each call (the
    main path finds its weights and pools cold): CUDA events around
    `iters` (flush, call) pairs, minus the same loop of flushes alone;
    the median of three such differences, taken in turn, as one pair
    of loops can be off by far more than a small call lasts (one read
    the 32.8 MB head below its bytes bound; PERF.md).  The flush
    (a 256 MB memset) gives the host time to enqueue each call ahead of
    the card, so the host's dispatch cost is not counted as device
    time."""

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
        diffs = sorted(self._loop(fn, iters) - self._loop(None, iters)
                       for _ in range(3))
        return max(diffs[1], 0.0) / iters


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
def paged_case(torch, kv_dtype, q_dtype, full_view, gen, b=N_SLOTS,
               pages=CFG["max_seq"] // PAGE, d=128):
    """Pools and block tables at the main path's shape: b 16 rows of 20
    pages of 64, 8 heads of d 128.  full_view: every row sees its whole
    view; else each row's visibility ends at a random position (row 0:
    the whole view, row 1: a page boundary, row 2: mid-page) and its
    unmapped tail points at the null page 0."""
    h = CFG["heads"]
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
        pos[2] = (pages // 2) * PAGE + 17  # mid-page
        for i in range(b):
            bt[i, int(pos[i]) // PAGE + 1:] = 0  # unmapped tail
        bt[2, 0] = bt[0, 0]  # a shared prefix page
    mask = torch.arange(view)[None, :] <= pos[:, None]
    return q, k, v, bt.to(dev), mask.to(dev), ks, vs


def device_kernels(prof):
    """The profiler's device kernel events: the device events less the
    step annotations that a profiler schedule puts on the device's
    timeline (ProfilerStep#N), which span the whole step."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


# The profiler keeps a device event only where its timestamp, mapped onto
# the host's clock, falls inside the active step, and on the H100 that
# mapping errs by milliseconds, either way, within one engine window
# (`launch_lags_ms` reads it; PERF.md): enough to drop the last
# layer's kernels of a window that ends right after them, or to pull a
# warm-up kernel in.  So the device idles this long between a step's
# work and each of the active step's ends.
PROFILE_PAD_S = 0.25


def launch_lags_ms(prof):
    """(least, median) of each device kernel's start less its launch's
    host start, in ms, as the profiler's two clocks place them: a value
    below zero is the mapping's error, which PROFILE_PAD_S must
    exceed."""
    launch, lags = {}, []
    events = prof.profiler.kineto_results.events()
    for e in events:
        if "LaunchKernel" in e.name():
            launch[e.correlation_id()] = e.start_ns()
    for e in events:
        if ("CUDA" in str(e.device_type()) and "LaunchKernel" not in e.name()
                and e.correlation_id() in launch):
            lags.append((e.start_ns() - launch[e.correlation_id()]) / 1e6)
    if not lags:
        return None
    lags.sort()
    return [lags[0], lags[len(lags) // 2]]


def traced_kernels(torch, fn):
    """The names of the device kernels that fn() launches, from the
    profiler's active step after a warm-up step of the same fn(), the
    work of each step kept PROFILE_PAD_S from the active step's ends."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for active in (False, True):
            if active:
                time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
    return [e.name for e in device_kernels(prof)]


def one_launch(torch, fn, kernel, calls=10):
    """(device kernels a call, tensors allocated a call) of fn.  Kernels:
    the device events of `calls` calls (traced_kernels), all of which
    must be named `kernel`, over the calls; a kernel of another name
    reads as its name.  Allocations: the caching allocator's count over
    one call (the output is one)."""
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    fn()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0) - n0

    def run():
        for _ in range(calls):
            fn()

    names = traced_kernels(torch, run)
    other = sorted({n[:80] for n in names if kernel not in n})
    return (other or len(names) / calls), allocs


def _launch_faults(what, kernels, allocs):
    """Exactly one device kernel and one allocation a call; a count the
    profiler did not record fails too."""
    if kernels != 1 or allocs != 1:
        return [f"{what}: {kernels} device kernels and {allocs} "
                "allocations a call (want 1 and 1)"]
    return []


PAGED_PLANTED = 1.01  # the planted fault: the row holding max|out|
RAGGED_PAGED = dict(b=3, pages=11)  # 11 pages: not a multiple of a split
# Head dims without an instance of their own, on the ragged batch: d 96
# (rows of whole 16-byte pieces) and d 98 (not, for any type: copied
# element by element).
OTHER_HEAD_DIMS = (96, 98)


def _paged_err(torch, got, want, q_dtype):
    """(max_abs_err, tolerance) of one paged output against its plain
    version: 1e-5 for f32 q, else one bf16 ulp of max|out|."""
    err = (got.float() - want.float()).abs().max().item()
    if q_dtype == torch.float32:
        return err, 1e-5
    return err, bf16_ulp(want.float().abs().max().item())


def check_paged(torch, PA, timer, name, kv_dtype, q_dtype, gen):
    """Kernel vs plain (varied layout + full view, and a ragged batch),
    poison invariance on page 0, two launches bitwise equal, a planted
    fault that must fail, one device launch and one allocation a call,
    and times at the full view."""
    rec = {"name": name}
    errs, faults = [], []
    cases = [(False, {}), (True, {}), (False, RAGGED_PAGED)] + [
        (False, dict(RAGGED_PAGED, d=d)) for d in OTHER_HEAD_DIMS
    ]
    for full, shape in cases:
        q, k, v, bt, mask, ks, vs = paged_case(
            torch, kv_dtype, q_dtype, full, gen, **shape
        )

        def launch():
            return PA._launch(q, k, v, bt, mask, ks, vs)

        out = launch()
        ref = PA.paged_attention_plain(
            q, k, v, bt, mask, k_scale=ks, v_scale=vs
        )
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), name
        err, tol = _paged_err(torch, out, ref, q_dtype)
        errs.append(err)
        if err > tol:
            raise AssertionError(f"{name} {shape}: max_err {err} > tol {tol}")
        if not _bitwise(torch, (out,), (launch(),)):
            faults.append(f"{name} {shape}: two launches differ")
        bad = out.float().clone()
        i = int(ref.float().abs().flatten(1).amax(1).argmax())
        bad[i] *= PAGED_PLANTED
        if _paged_err(torch, bad, ref, q_dtype)[0] <= tol:
            faults.append(f"{name}: a {PAGED_PLANTED}x fault on a row passes")
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
            poisoned = launch()
            torch.cuda.synchronize()
            if not torch.equal(poisoned, out):
                raise AssertionError(f"{name} {shape}: null page 0 leaked")
            k[0].copy_(k0)
            v[0].copy_(v0)
    if faults:
        raise AssertionError(f"paged attention: {faults}")
    rec["max_abs_err"] = max(errs)
    rec["tolerance"] = tol
    rec["tolerance_reason"] = (
        "f32 sums over 1280 lanes in another order, online rescale"
        if q_dtype == torch.float32 else
        "both sum in f32 and round once to bf16: one bf16 ulp of max|out|"
    )
    rec["ragged"] = RAGGED_PAGED
    rec["other_head_dims"] = list(OTHER_HEAD_DIMS)
    rec["bitwise_equal"] = True
    rec["planted_fault_fails"] = True
    # The full view (the last case but one) for the launch count and
    # the times: every row attends all 20 pages.
    q, k, v, bt, mask, ks, vs = paged_case(
        torch, kv_dtype, q_dtype, True, gen
    )
    kernels, allocs = one_launch(
        torch, lambda: PA._launch(q, k, v, bt, mask, ks, vs),
        "paged_attention_kernel",
    )
    rec["device_kernels_per_call"] = kernels
    rec["allocations_per_call"] = allocs
    faults = _launch_faults(name, kernels, allocs)
    if faults:
        raise AssertionError(faults)
    b, pages, h, d = N_SLOTS, CFG["max_seq"] // PAGE, CFG["heads"], 128
    view = pages * PAGE
    rec["ms"] = timer.ms(lambda: PA._launch(q, k, v, bt, mask, ks, vs))
    # The run-time-d instance at the same full view, for its cost.
    rec["ms_other_head_dims"] = {}
    for d_o in OTHER_HEAD_DIMS:
        qo, ko, vo, bto, masko, kso, vso = paged_case(
            torch, kv_dtype, q_dtype, True, gen, d=d_o
        )
        rec["ms_other_head_dims"][d_o] = timer.ms(
            lambda: PA._launch(qo, ko, vo, bto, masko, kso, vso))
        del qo, ko, vo
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


PASS_SHAPES = [  # (name, in, out, x dtype, launches per decoder pass)
    ("qkv", 1024, 3072, "bf16", CFG["depth"]),
    ("proj", 1024, 1024, "bf16", CFG["depth"]),
    ("fc0", 1024, 4096, "bf16", CFG["depth"]),
    ("fc1", 4096, 1024, "bf16", CFG["depth"]),
    ("head", 1024, 32000, "f32", 1),
]
# Verify windows of the int8 speculative engine: 16 slots x width W rows
# go through each matmul of one pass.
VERIFY_WIDTHS = (2, 4)
QMM_SHAPES = [  # (name, rows, in, out, x dtype, launches per decode step)
    *[(name, N_SLOTS, din, dout, xt, n) for name, din, dout, xt, n
      in PASS_SHAPES],
    ("head_prefill", 1, 1024, 32000, "f32", 0),
    *[(f"{name}_w{w}", N_SLOTS * w, din, dout, xt, 0)
      for w in VERIFY_WIDTHS for name, din, dout, xt, _ in PASS_SHAPES],
]
# Ragged shapes, held, not timed: rows 1, 3, 17 and 40 (several m16
# tiles), out 1000 (8-byte weight copies) and 8, in 40 and 4104 (a
# partial last stage; 4104 splits over 8 blocks of 576 rows), and in 37
# (x rows not 16-byte aligned: x staged by plain loads).
QMM_EDGE_SHAPES = [  # (rows, in, out, x dtype)
    (1, 40, 1000, "bf16"), (3, 4104, 8, "bf16"), (17, 4104, 1000, "bf16"),
    (40, 40, 8, "bf16"), (17, 40, 1000, "f32"), (40, 4104, 1000, "f32"),
    (3, 37, 64, "bf16"), (1, 4104, 8, "f32"),
]
QMM_PLANTED = 1.01  # the planted fault: 1% on the column of max|out|


def _qmm_case(torch, QM, gen, rows, din, dout, xt):
    """Operands of one int8-matmul shape and the kernel's launch, held
    against the plain version, a second launch (bitwise) and a planted
    fault: (x, w_i8, scale, readings, faults)."""
    xdt = torch.bfloat16 if xt == "bf16" else torch.float32
    w = torch.randn((din, dout), generator=gen) / math.sqrt(din)
    w_i8, scale = QM.quantize_weight(w.cuda())
    x = torch.randn((rows, din), generator=gen).to("cuda", xdt)
    out = QM._launch(x, w_i8, scale)
    ref = QM.int8_weight_matmul_plain(x, w_i8, scale)
    torch.cuda.synchronize()
    what = f"int8 matmul {rows}x{din}x{dout} {xt}"
    assert torch.isfinite(out.float()).all(), what
    mag = ref.float().abs().max().item()
    tol = (2.0 ** -7 if xt == "bf16" else 1e-4) * mag
    err = (out.float() - ref.float()).abs().max().item()
    faults = []
    if err > tol:
        faults.append(f"{what}: max_err {err} > tol {tol}")
    # The planted fault moves the column holding max|out| by 1% of its
    # values, away from the plain version: a 1.01x scaling that moved an
    # element toward it could cancel the kernel's own bf16 rounding (up
    # to ~0.5% of max|out| at in 40) and be no fault at all.
    c = int(ref.float().abs().amax(0).argmax())
    bad = out.float().clone()
    away = torch.where(bad[:, c] >= ref.float()[:, c], 1.0, -1.0)
    bad[:, c] += (QMM_PLANTED - 1) * bad[:, c].abs() * away
    if (bad - ref.float()).abs().max().item() <= tol:
        faults.append(f"{what}: a {QMM_PLANTED}x fault on a column passes")
    bitwise = _bitwise(torch, (out,), (QM._launch(x, w_i8, scale),))
    if not bitwise:
        faults.append(f"{what}: two launches differ")
    return x, w_i8, scale, dict(
        max_abs_err=err, tolerance=tol, rel_err=err / mag,
        plan=list(QM.qmm_plan(rows, din, dout, SMS, xdt)),
        bitwise_equal=bitwise,
    ), faults


SMS = 132  # set from the card in main()


def check_qmm(torch, QM, timer, gen):
    """Every projection shape and the ragged ones: kernel vs plain, a
    second launch and a planted fault; one device launch and one
    allocation a call; times at the projection shapes.  The record's
    times are per decode step: the
    sum over the 33 launches one step makes (8 layers x qkv/proj/fc0/fc1
    + the head); `per_verify_pass` sums the same 33 at each verify
    window's rows."""
    per_shape, edges, faults = [], [], []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    nbytes_step = ops_step = 0.0
    verify = {N_SLOTS * w: dict.fromkeys(
        ("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
        for w in VERIFY_WIDTHS}
    launches_per_pass = {n: k for n, _, _, _, k in PASS_SHAPES}
    for name, rows, din, dout, xt, per_step in QMM_SHAPES:
        x, w_i8, scale, r, f = _qmm_case(torch, QM, gen, rows, din, dout,
                                         xt)
        faults += f
        kernels, allocs = one_launch(
            torch, lambda: QM._launch(x, w_i8, scale), "qmm_kernel"
        )
        faults += _launch_faults(f"int8 matmul {name}", kernels, allocs)
        w_lib = (w_i8.float() * scale[None, :]).to(x.dtype)
        t = {
            "ms": timer.ms(lambda: QM._launch(x, w_i8, scale)),
            "plain_ms": timer.ms(
                lambda: QM.int8_weight_matmul_plain(x, w_i8, scale)
            ),
            "library_ms": timer.ms(lambda: torch.matmul(x, w_lib)),
        }
        nbytes = din * dout + dout * 4 + rows * (din + dout) * x.element_size()
        # The kernel runs the product on the bf16 tensor cores, f32 x as
        # three bf16 parts: bound by bytes at every shape.
        ops = 2.0 * rows * din * dout * (3 if xt == "f32" else 1)
        b_ms, b_by = bound_ms(nbytes, ops, "bf16")
        per_shape.append(dict(
            shape=name, rows=rows, in_dim=din, out_dim=dout, x=xt,
            bound_ms=b_ms, bound_by=b_by,
            device_kernels_per_call=kernels, allocations_per_call=allocs,
            **r, **t,
        ))
        for key in tot:
            tot[key] += per_step * t[key]
        nbytes_step += per_step * nbytes
        ops_step += per_step * ops
        base = name.split("_w")[0]
        if rows in verify and base in launches_per_pass:
            k = launches_per_pass[base]
            for key in tot:
                verify[rows][key] += k * t[key]
            verify[rows]["bound_ms"] += k * b_ms
    for rows, din, dout, xt in QMM_EDGE_SHAPES:
        r, f = _qmm_case(torch, QM, gen, rows, din, dout, xt)[3:]
        faults += f
        edges.append(dict(rows=rows, in_dim=din, out_dim=dout, x=xt, **r))
    if faults:
        raise AssertionError(f"int8 matmul: {faults}")
    b_ms, b_by = bound_ms(nbytes_step, ops_step, "bf16")
    rec = {
        "name": "int8_weight_matmul",
        "max_abs_err": max(s["max_abs_err"] for s in per_shape + edges),
        "worst_rel_err": max(s["rel_err"] for s in per_shape + edges),
        "tolerance_reason": (
            "bf16 x: 2**-7 x max|out| (the plain version rounds the "
            "dequantized weight to bf16; both round the output to bf16); "
            "f32 x: 1e-4 x max|out| (f32 sums in another order, scale "
            "after the sum vs before, x as three bf16 parts)"
        ),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "per_step_weight_bytes": nbytes_step,
        "edge_shapes": edges,
        "per_verify_pass": {f"rows_{r}": v for r, v in verify.items()},
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


def oracle_gap(torch, model, prompt, tokens, quant, qparams, deq):
    """The largest gap, in logits, between the oracle's argmax and the
    engine's token along the engine's token path (TOP2_TOL bounds it)."""
    lg = oracle_logits(torch, model, prompt, tokens, quant, qparams, deq)
    top = lg.float().max(dim=-1).values
    mine = lg.float().gather(
        1, torch.tensor(tokens, device=lg.device)[:, None])[:, 0]
    return (top - mine).max().item()


# The port's own kernels, by the names their sources give them.
PORT_KERNELS = ("paged_attention", "qmm_", "flash_", "xent_", "gemm_stats",
                "reduce_partials")


def kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name: the port's kernels, library
    GEMMs and convolutions (cuBLAS, cuDNN, CUTLASS), casts and copies,
    torch's elementwise and reduction kernels, or other."""
    low = name.lower()
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if "nccl" in low:
        return "collectives"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "conv", "cudnn",
                              "fprop", "dgrad", "wgrad", "cublas", "nvjet")):
        return "library gemm / conv"
    if "copy" in low or "memset" in low or "memcpy" in low:
        return "copies and casts"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def launch_records(prof):
    """(runtime kernel launches, of them those with no device record) in
    the profile's active step, matched by correlation id.  A launch
    whose kernel record is missing was dropped by the tracer (its
    activity buffer) or placed outside the step by the clock mapping
    (`launch_to_start_ms` below zero); a graph replay is one launch of
    many kernels, so it counts once."""
    launches, device = set(), set()
    for e in prof.profiler.kineto_results.events():
        if "LaunchKernel" in e.name():
            launches.add(e.correlation_id())
        elif "CUDA" in str(e.device_type()):
            device.add(e.correlation_id())
    return len(launches), len(launches - device)


def window_line(tag, rec):
    """One line on stderr for a profiled window: its length, the device
    events and their rate, the runtime launches the tracer lost, and per
    kernel the wrappers' calls beside the port's device events."""
    print(f"profile window {tag}: {rec.get('window_s', 0):.3f} s, "
          f"{rec.get('device_kernel_events')} device events "
          f"({rec.get('launch_rate_per_s', 0):.0f}/s), runtime launches "
          f"{rec.get('runtime_launches')} of which without a device record "
          f"{rec.get('launches_without_device_event')}; wrapper calls "
          f"{rec.get('wrapper_calls')}; port kernel events "
          f"{rec.get('port_kernel_calls')}", file=sys.stderr, flush=True)


def device_profile(torch, fn, top=6, counts=None, tag=""):
    """Run fn() under torch.profiler and return the device busy share
    (device kernel time over the window's wall time) and the top
    kernels.  fn runs in the profiler's active step, after a warm-up
    step of one small kernel, and PROFILE_PAD_S from the step's ends;
    the window's wall time is fn's alone.  Only starting the profiler
    is guarded: where it cannot start, or records no device activity,
    the share reads "not measured".  fn itself runs unguarded.  Every
    window also reports its device events and their rate, the runtime
    launches left without a device record (`launch_records`), and with
    `counts` (the wrappers' launch counts) the wrappers' calls over fn,
    beside the port's device events by kernel (`window_line`)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    try:
        prof.start()
    except RuntimeError as e:
        prof, why = None, repr(e)[:200]
    if prof is not None:
        torch.empty(1, device="cuda").fill_(0.0)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        prof.step()
        time.sleep(PROFILE_PAD_S)
    c0 = counts() if counts else None
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    wrapper_calls = None
    if counts:
        c1 = counts()
        wrapper_calls = {k: c1[k] - c0[k] for k in c0}
    if prof is None:
        return {"device_busy_share": "not measured", "error": why,
                "wrapper_calls": wrapper_calls}
    time.sleep(PROFILE_PAD_S)
    prof.step()
    prof.stop()
    by_name, calls, spans = {}, {}, []
    for e in device_kernels(prof):
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        calls[e.name] = calls.get(e.name, 0) + 1
        spans.append((e.time_range.start, e.time_range.end))
    # Busy time is the union of the device spans, so that overlapping
    # records are not counted twice.
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    if busy == 0:
        return {"device_busy_share": "not measured",
                "error": "no device events recorded",
                "wrapper_calls": wrapper_calls}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # The host's side of the window: torch ops by their own CPU time
    # (every thread's, the engine's scheduler included).
    cpu_ops = sorted(
        ((e.key, e.self_cpu_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.self_cpu_time_total > 0),
        key=lambda kv: -kv[1])
    by_kind, port, port_calls = {}, {}, {}
    for name, us in by_name.items():
        kind = kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        if kind == "port kernels":  # each by its function's name
            short = name.split("(anonymous namespace)::")[-1].split("(")[0]
            port[short] = port.get(short, 0.0) + us / 1e3
            port_calls[short] = port_calls.get(short, 0) + calls[name]
    runtime, lost = launch_records(prof)
    rec = {
        "window_s": wall_us / 1e6,
        "device_kernel_events": len(spans),
        "launch_rate_per_s": len(spans) / (wall_us / 1e6),
        "runtime_launches": runtime,
        "launches_without_device_event": lost,
        "wrapper_calls": wrapper_calls,
        "device_busy_share": busy / wall_us,
        "device_ms": busy / 1e3,
        "top_kernels_ms": [[name[:100], us / 1e3] for name, us in ranked],
        "top_cpu_ops_ms": [[k[:60], ms, n] for k, ms, n in cpu_ops[:2 * top]],
        "cpu_ops_ms": sum(ms for _, ms, _ in cpu_ops),
        "kernel_ms_by_kind": by_kind,
        "port_kernels_ms": port,
        "port_kernel_calls": port_calls,
        "launch_to_start_ms": launch_lags_ms(prof),
    }
    window_line(tag, rec)
    return rec


def wait_idle(eng, timeout=60.0):
    """Until the engine's thread has nothing queued, no row active and no
    step in flight: it launches nothing more until the next submit.  (A
    request returns when its last token is committed, and the pipelined
    engine has dispatched its next step before that commit.)"""
    t0 = time.monotonic()
    while True:
        with eng._cv:
            if (eng.queue_depth == 0 and eng.active_rows == 0
                    and eng._pending is None):
                return
        assert time.monotonic() - t0 < timeout, "the engine never idled"
        time.sleep(0.001)


def profile_window(torch, eng, gen, counts):
    """The profile over a decode-dominated window (16 rows, 64-token
    prompts, 32 new tokens); each request must return its 32 tokens.
    The window runs from an idle engine to an idle engine, and `counts()`
    (the wrappers' launch counts) is read at both ends: the launches of
    the window are exactly those the profiler saw."""
    prompts = torch.randint(0, CFG["vocab"], (N_SLOTS, 64), generator=gen)
    outs, ends = [], []

    def window():
        wait_idle(eng)
        ends.append(eng._dispatch_count)
        hs = [eng.submit_nowait(p, 32) for p in prompts.numpy()]
        outs.extend(h.wait(timeout=900)[0] for h in hs)
        wait_idle(eng)
        ends.append(eng._dispatch_count)

    wait_idle(eng)  # no step of the last run lands in the profile
    # The engine idles at fn's ends, so the counts read around fn are
    # the window's.
    rec = device_profile(torch, window, counts=counts, tag="engine")
    assert all(len(o) == 32 for o in outs), [len(o) for o in outs]
    rec["dispatches"] = ends[1] - ends[0]
    return rec


# The engine configurations each engine phase runs, by phase suffix:
# the one-token paged engine, fused blocks up to FUSED_STEPS wide
# (ladder 2, 4; one CUDA graph a width), the contiguous-slot engine, and
# speculative windows up to SPEC_K wide (bench.py's serving_spec
# default).
FUSED_STEPS = 4
SPEC_K = 4
ENGINE_MODES = {
    "": {},
    "_fused": {"decode_steps": FUSED_STEPS},
    "_contig": {"paged": False},
    "_spec": {"spec_k": SPEC_K},
}
# What the engine logs when its drafter degrades a window to width 1.
DRAFT_DEGRADE = ("draft chain failed", "drafter-cache fill failed",
                 "drafter-cache refill failed")


def delta(snap0, snap1, key):
    return snap1[key] - snap0[key]


def steps_run(snap0, snap1, dispatches):
    """Decode steps that ran the one-token decoder between two snapshots
    (each a depth of paged-attention calls): one per one-token dispatch
    and k per fused block of width k; a verify window runs none.  The
    first call of a CUDA graph's key is the call itself, run eagerly,
    and a capture launches nothing."""
    return (dispatches - delta(snap0, snap1, "fused_blocks")
            + delta(snap0, snap1, "fused_steps")
            - delta(snap0, snap1, "spec_verify_passes"))


def qmm_per_pass():
    """Int8 matmul calls of one decoder pass: 4 projections a layer and
    the head (33 at depth 8)."""
    return 4 * CFG["depth"] + 1


def draft_qmm_calls(snap0, snap1):
    """Int8 matmul calls of the drafter between two snapshots: a pass's
    calls a pass, less the head of each chain's KV-write-only last
    pass."""
    return (qmm_per_pass() * delta(snap0, snap1, "spec_draft_passes")
            - delta(snap0, snap1, "spec_draft_chains"))


def spec_figures(snap0, snap1, tokens):
    """A speculative engine's figures between two snapshots, over the
    `tokens` it committed there."""
    drafted = delta(snap0, snap1, "spec_drafted_tokens")
    passes = delta(snap0, snap1, "spec_verify_passes")
    return {
        "drafted": drafted,
        "accepted": delta(snap0, snap1, "spec_accepted_tokens"),
        "accept_rate": (delta(snap0, snap1, "spec_accepted_tokens")
                        / drafted if drafted else None),
        "verify_passes": passes,
        "draft_passes": delta(snap0, snap1, "spec_draft_passes"),
        "draft_chains": delta(snap0, snap1, "spec_draft_chains"),
        "tokens_per_verify_pass": (delta(snap0, snap1, "spec_window_tokens")
                                   / passes if passes else None),
        "tokens_per_row_window": (
            delta(snap0, snap1, "spec_window_tokens")
            / max(delta(snap0, snap1, "spec_window_rows"), 1)),
        "verify_passes_per_token": passes / tokens,
        "draft_passes_per_token":
            delta(snap0, snap1, "spec_draft_passes") / tokens,
    }


class _Records(logging.Handler):
    """Keeps the messages of the records it sees."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def first_divergence(got, want):
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                None if len(got) == len(want) else min(len(got), len(want)))


def sampled_windows(torch, eng, gen, windows):
    """A speculative engine's windows that carry sampled rows: a greedy
    request beside one sampled at temperature 0.9 with top_k 40 and top_p
    0.9 (it rides each window at width 1 and draws from the engine's
    generator inside the verify graph).  Both must return their tokens,
    and a verify window with the top-k / top-p operands must have run."""
    prompts = torch.randint(0, CFG["vocab"], (2, 96), generator=gen).numpy()
    before = dict(windows)
    hs = [eng.submit_nowait(prompts[0], 48),
          eng.submit_nowait(prompts[1], 48, temperature=0.9, top_k=40,
                            top_p=0.9)]
    outs = [h.wait(timeout=900)[0] for h in hs]
    wait_idle(eng)
    keys = [c["key"] for c in eng._spec_graphs[1].captures]
    assert all(len(o) == 48 for o in outs), [len(o) for o in outs]
    ran = {w: n - before.get(w, 0) for w, n in windows.items()}
    sampled = [k for k in keys if not k[1] and k[2]]
    if eng.device.type == "cuda":
        assert sampled, keys
    return {"windows_by_width": ran, "sampled_verify_keys": sampled,
            "distinct_sampled_tokens": len(set(outs[1]))}


def graph_revival(torch, eng, gen):
    """A graphed engine's revival: greedy requests run once; then one
    fused block (a fused engine) or one verify window (a speculative
    engine) fails on every attempt until the engine's retries are spent
    (the rows of that run fail, the scheduler crashes); the supervisor
    revives the engine with a fresh cache and a zeroed drafter cache;
    every graph must be captured again against those caches, the same
    requests must give the same tokens as before the fault, and no page
    may stay in use."""
    from container_engine_accelerators_tpu_torch.serving import (
        EngineSupervisor,
    )

    vocab = CFG["vocab"]
    check = [(torch.randint(0, vocab, (n,), generator=gen).numpy(), 64)
             for n in (64, 200, 333, 96)]
    victims = [torch.randint(0, vocab, (80,), generator=gen).numpy()
               for _ in range(2)]
    sup = EngineSupervisor(eng, max_restarts=2).start()
    try:
        before = [eng.submit(p, n, timeout=900)[0] for p, n in check]
        wait_idle(eng)
        seam = "_verify_fn" if eng._spec_k else "_fused_fn"
        holders = {"fused": (eng._fused, lambda: eng._cache)}
        if eng._spec_k:
            holders = {"draft": (eng._spec_graphs[0],
                                 lambda: eng._draft_cache),
                       "verify": (eng._spec_graphs[1], lambda: eng._cache)}
        real, calls, fails = getattr(eng, seam), [0], [0]
        limit = eng._step_retries + 1  # every attempt of one call

        def flaky(*a, **k):
            calls[0] += 1
            if calls[0] >= 3 and fails[0] < limit:
                fails[0] += 1
                raise RuntimeError(f"injected {seam} fault")
            return real(*a, **k)

        setattr(eng, seam, flaky)
        caps0 = {n: len(h.captures) for n, (h, _) in holders.items()}
        restarts0 = eng.snapshot()["restarts"]
        failed = 0
        for h in [eng.submit_nowait(p, 64) for p in victims]:
            try:
                h.wait(timeout=900)
            except RuntimeError:
                failed += 1
        t0 = time.monotonic()
        while eng.snapshot()["restarts"] <= restarts0:
            assert time.monotonic() - t0 < 60, "the engine never revived"
            time.sleep(0.01)
        assert fails[0] == limit and failed == len(victims), (fails, failed)
        revived = eng.snapshot()
        assert revived["kv_pages_in_use"] == 0, revived
        for name, (h, _) in holders.items():
            assert not h.keys, (name, h.keys)
        drafter_zero = None
        if eng._spec_k:  # nothing runs between the revival and here
            drafter_zero = not any(buf.any() for blk in eng._draft_cache
                                   for buf in blk.values())
            assert drafter_zero, "the drafter cache survived the revival"
        after = [eng.submit(p, n, timeout=900)[0] for p, n in check]
        wait_idle(eng)
        recaptured = {}
        for name, (h, cache) in holders.items():
            keys = sorted(c["key"] for c in h.captures[caps0[name]:])
            assert keys == h.keys, (name, keys, h.keys)
            if eng.device.type == "cuda":  # graphs exist only on the card
                assert keys and h._bound[1] is cache(), (name, keys)
            recaptured[name] = keys
        assert after == before, [first_divergence(a, b)
                                 for a, b in zip(after, before)]
    finally:
        sup.stop()
    return {
        "injected_seam": seam,
        "injected_failures": fails[0], "rows_failed": failed,
        "restarts": revived["restarts"] - restarts0,
        "kv_pages_in_use_after_revive": revived["kv_pages_in_use"],
        "drafter_cache_zero_after_revive": drafter_zero,
        "recaptured_keys": recaptured,
        "same_tokens_after_revive": after == before,
    }


def run_engine(torch, model, quant, gen_reqs, mode="", base=None):
    """One engine phase (ENGINE_MODES[mode]): a warm-up request, then
    requests() with the launch counters read around it, then a decode
    run (16 rows x (64 + 128)) and a profiled window (profile_window,
    with the host's op times beside the device's); the fused and
    speculative engines add their revival check.
    Every token is held to the oracle's argmax within TOP2_TOL; `base`
    (the one-token engine's record of the same run) gives each request's
    first divergence from its tokens and the ratios of the figures."""
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

    tag = ("int8" if quant else "bf16") + mode
    paged = mode != "_contig"
    dev = model.device

    def counts():
        return {"paged_attention": PA.paged_attention.launches,
                "int8_weight_matmul": QM.int8_weight_matmul.launches}

    eng = ContinuousBatchingEngine(
        model, N_SLOTS, quant=quant, page_size=PAGE, prefill_chunk=CHUNK,
        observe=False, device=dev, **ENGINE_MODES[mode],
    )
    spec = bool(eng._spec_k)
    logged = _Records()
    engine_log = logging.getLogger(ContinuousBatchingEngine.__module__)
    engine_log.addHandler(logged)
    windows = {}  # verify windows dispatched, by width
    if spec:
        verify = eng._verify_fn

        def counted(weights, cache, inputs, key):
            windows[key[0]] = windows.get(key[0], 0) + 1
            return verify(weights, cache, inputs, key)

        eng._verify_fn = counted
    extra = {}
    try:
        eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 2, timeout=600)  # warm-up
        wait_idle(eng)
        base_snap = eng.snapshot()
        steps0 = eng._dispatch_count
        reqs = requests(gen_reqs, torch)
        windows.clear()
        PA.paged_attention.launches = 0
        QM.int8_weight_matmul.launches = 0
        t0 = time.monotonic()
        handles = [eng.submit_nowait(p, n) for p, n in reqs]
        outs = [h.wait(timeout=900)[0] for h in handles]
        wall = time.monotonic() - t0
        wait_idle(eng)
        launches = counts()
        req_windows = dict(windows)
        dispatches = eng._dispatch_count - steps0
        snap = eng.snapshot()
        n_steps = steps_run(base_snap, snap, dispatches)
        # Decode-dominated run: all 16 slots busy with short
        # prompts, so the wall time per dispatch approaches the
        # step (or block) time.
        d0, s0 = eng._dispatch_count, eng.snapshot()
        t1 = time.monotonic()
        dec = [eng.submit_nowait(toks, 128) for toks in
               torch.randint(0, CFG["vocab"], (N_SLOTS, 64),
                             generator=gen_reqs).numpy()]
        # The decode stretch: from the last admission to the end,
        # every decode step with up to 16 rows and no prefill.
        while eng.snapshot()["admitted"] < s0["admitted"] + N_SLOTS:
            time.sleep(0.002)
        t_adm, d_adm, s_adm = (time.monotonic(), eng._dispatch_count,
                               eng.snapshot())
        with eng._cv:  # the run's tokens committed before the stretch
            tok_adm = sum(len(q.tokens) for q in eng._slots if q)
        dec_tok = sum(len(h.wait(timeout=900)[0]) for h in dec)
        t_end = time.monotonic()
        dec_wall = t_end - t1
        dec_disp = eng._dispatch_count - d0
        wait_idle(eng)
        s1 = eng.snapshot()
        stretch = steps_run(s_adm, s1, eng._dispatch_count - d_adm)
        extra["decode_run"] = {
            "rows": N_SLOTS, "prompt": 64, "new": 128,
            "tokens_per_s": dec_tok / dec_wall,
            "wall_per_token_ms": dec_wall / dec_tok * 1e3,
            "step_ms": dec_wall / max(dec_disp, 1) * 1e3,
            "dispatches_per_token": dec_disp / dec_tok,
            "fused_blocks_per_token":
                (s1["fused_blocks"] - s0["fused_blocks"]) / dec_tok,
            "decode_stretch_s": t_end - t_adm,
            "decode_stretch_steps": stretch,
            "decode_stretch_step_ms": ((t_end - t_adm) / stretch * 1e3
                                       if stretch else None),
            "decode_stretch_tokens": dec_tok - tok_adm,
            "decode_stretch_wall_per_token_ms":
                (t_end - t_adm) / (dec_tok - tok_adm) * 1e3,
        }
        if spec:
            extra["decode_run"]["spec"] = spec_figures(s0, s1, dec_tok)
        holders = [h for h in (eng._fused, *eng._spec_graphs) if h]
        caps = sum(len(h.captures) for h in holders)
        s0 = eng.snapshot()
        profile = profile_window(torch, eng, gen_reqs, counts)
        s1 = eng.snapshot()
        profile["graph_captures_in_window"] = sum(
            len(h.captures) for h in holders) - caps
        n_tok = N_SLOTS * 32
        profile["tokens"] = n_tok
        profile["dispatches_per_token"] = profile["dispatches"] / n_tok
        profile["fused_blocks_per_token"] = (
            s1["fused_blocks"] - s0["fused_blocks"]) / n_tok
        profile["wall_per_token_ms"] = profile["window_s"] / n_tok * 1e3
        paged_steps = (profile["wrapper_calls"]["paged_attention"]
                       / CFG["depth"])
        if "device_ms" in profile:  # prefill's device time included
            profile["device_ms_per_token"] = profile["device_ms"] / n_tok
            if paged_steps:  # a verify window runs no paged call
                profile["device_ms_per_step"] = (profile["device_ms"]
                                                 / paged_steps)
        # One device launch a call: the only kernels of the port in
        # the window are the two ops' single kernels (no split
        # merge, no second pass), and their device events number
        # exactly the wrappers' calls, replays of a CUDA graph
        # included.  A window the profiler did not record fails.
        profile["device_events"] = port_events(profile, tag)
        assert profile["device_events"] == profile["wrapper_calls"], profile
        if spec:
            profile["spec"] = spec_figures(s0, s1, n_tok)
        extra["profile"] = profile
        if eng._fused is not None:
            extra["graph_captures"] = list(eng._fused.captures)
        if spec:
            extra["graph_captures"] = {
                "draft": list(eng._spec_graphs[0].captures),
                "verify": list(eng._spec_graphs[1].captures)}
        if spec:
            extra["sampled_windows"] = sampled_windows(torch, eng, gen_reqs,
                                                       windows)
        if eng._fused is not None or spec:
            extra["revival"] = graph_revival(torch, eng, gen_reqs)
    finally:
        engine_log.removeHandler(logged)
        eng.close()
    closed = eng.snapshot()
    n_tok = sum(len(o) for o in outs)
    assert all(len(o) == n for o, (_, n) in zip(outs, reqs)), tag
    depth = CFG["depth"]
    if paged:
        assert snap["prefix_hits"] - base_snap["prefix_hits"] >= 1, snap
        assert snap["kv_pages_in_use"] == snap["prefix_cached_pages"], snap
        assert closed["kv_pages_in_use"] == 0, closed
        assert launches["paged_attention"] == depth * n_steps, (
            launches, n_steps)
    else:
        assert launches["paged_attention"] == 0, launches
    draft = draft_qmm_calls(base_snap, snap)
    if spec:
        # Exact: the drafter's calls, and in int8 a pass's calls a
        # one-token step or verify window and the quant head once an
        # admission.
        want = draft + (qmm_per_pass() * dispatches
                        + delta(base_snap, snap, "admitted") if quant else 0)
        assert launches["int8_weight_matmul"] == want, (launches, want)
    elif quant:
        assert launches["int8_weight_matmul"] >= qmm_per_pass() * n_steps
    else:
        assert launches["int8_weight_matmul"] == 0, launches
    if mode == "_fused":
        assert snap["fused_blocks"] > base_snap["fused_blocks"], snap
    degraded = [m for m in logged.messages
                if any(d in m for d in DRAFT_DEGRADE)]
    if spec:
        # No hidden degrade: no run of this phase injects a drafter fault.
        assert not degraded, degraded
        assert delta(base_snap, snap, "spec_drafted_tokens") > 0, snap
        assert req_windows.get(SPEC_K, 0) > 0, req_windows

    qparams = eng._qparams if quant else None
    deq = eng._deq if quant else None
    first_div, margins, distinct = [], [], []
    oracle_fn = QG.generate_prefill_quant if quant else G.generate_prefill
    for (prompt, n), got in zip(reqs, outs):
        if base is None:
            kw = {"qparams": qparams} if quant else {}
            solo = oracle_fn(
                model, prompt[None], len(prompt), n, 0.0,
                torch.Generator(device=dev), **kw,
            )[0].tolist()
            first_div.append(first_divergence(got, solo))
        distinct.append(len(set(got)))
        gap = oracle_gap(torch, model, prompt, got, quant, qparams, deq)
        margins.append(gap)
        if gap > TOP2_TOL:
            raise AssertionError(
                f"{tag} engine: token off the oracle's argmax by {gap} "
                f"logits (> {TOP2_TOL}) in request {len(margins) - 1}"
            )
    rec = {
        "phase": f"engine_{tag}",
        "engine_options": ENGINE_MODES[mode],
        "requests": len(reqs),
        "tokens": n_tok,
        "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "wall_per_token_ms": wall / n_tok * 1e3,
        "decode_dispatches": dispatches,
        "decode_steps_run": n_steps,
        "fused_blocks": snap["fused_blocks"] - base_snap["fused_blocks"],
        "dispatches_per_token": dispatches / n_tok,
        "wall_per_dispatch_ms": wall / max(dispatches, 1) * 1e3,
        **extra,
        "launches": launches,
        "kv_pages_in_use_after_close": closed.get("kv_pages_in_use"),
        "max_gap_to_oracle_argmax": max(margins),
        "top2_tolerance": TOP2_TOL,
        "distinct_tokens": distinct,
        "outs": outs,
    }
    if spec:
        rec["spec"] = {**spec_figures(base_snap, snap, n_tok),
                       "windows_by_width": req_windows,
                       "drafter_int8_matmul_calls": draft,
                       "drafter_degrade_logs": len(degraded)}
    if paged:
        rec["prefix_hits"] = snap["prefix_hits"] - base_snap["prefix_hits"]
        rec["prefix_hit_tokens"] = (snap["prefix_hit_tokens"]
                                    - base_snap["prefix_hit_tokens"])
    if base is None:
        rec["first_divergence_vs_oracle"] = first_div
    else:
        rec["first_divergence_vs_one_token"] = [
            first_divergence(a, b) for a, b in zip(outs, base["outs"])]
        rec["vs_one_token"] = ratios(rec, base)
    return rec, launches


def port_events(profile, tag):
    """The serving kernels' device events in a profile, by wrapper (the
    only port kernels a serving window may hold); a window the profiler
    did not record fails."""
    calls = profile.get("port_kernel_calls")
    assert calls is not None, f"{tag}: no device events: {profile}"
    events = {"paged_attention": 0, "int8_weight_matmul": 0}
    for k, n in calls.items():
        op = ("paged_attention" if k.startswith("paged_attention_kernel")
              else "int8_weight_matmul" if k.startswith("qmm_kernel")
              else None)
        assert op is not None, f"unexpected port kernel {k}"
        events[op] += n
    return events


def ratios(rec, base):
    """This engine's figures over the one-token engine's of the same run
    (the host moves absolute tokens/s between runs)."""
    out = {}
    for path in (("tokens_per_s",), ("wall_per_token_ms",),
                 ("dispatches_per_token",),
                 ("decode_run", "tokens_per_s"),
                 ("decode_run", "wall_per_token_ms"),
                 ("decode_run", "dispatches_per_token"),
                 ("decode_run", "decode_stretch_step_ms"),
                 ("decode_run", "decode_stretch_wall_per_token_ms"),
                 ("profile", "device_busy_share"),
                 ("profile", "device_ms"),
                 ("profile", "window_s"),
                 ("profile", "dispatches_per_token")):
        a, b = rec, base
        for key in path:
            a = a.get(key) if isinstance(a, dict) else None
            b = b.get(key) if isinstance(b, dict) else None
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) and b:
            out[".".join(path)] = a / b
    return out


# -- phase 4b: KV tiers, page migration and observability ----------------
# engine_tiers: TIER_SESSIONS distinct TIER_PROMPT-token prompts (+
# TIER_NEW greedy tokens) through the default 320-page pool need 512
# trie pages, so about 200 are demoted: the host tier keeps the newest
# TIER_HOST_PAGES of them and the older spill to disk.  Then the first
# TIER_RETURNS sessions return (run_engine_tiers says which tiers they
# read).
TIER_SESSIONS, TIER_RETURNS = 32, 8
TIER_PROMPT, TIER_NEW = 1024, 32
TIER_HOST_PAGES = 128
TIER_DISK_BYTES = 1 << 30
TIER_GRID = 16  # the engine's prompt grid: a resumed prefill's sliver
# engine_migrate: the shared prefix of requests() #2 and #4.
MIGRATE_SHARED = 512


def page_bytes(quant):
    """Serialized bytes of one pool page over every layer: K and V of
    (PAGE, heads, d) in bf16, or in int8 with their f32 scales."""
    dim, depth, heads = CFG["dim"], CFG["depth"], CFG["heads"]
    if quant:
        return depth * 2 * (PAGE * dim + PAGE * heads * 4)
    return depth * 2 * PAGE * dim * 2


def timed_submit(eng, prompt, n):
    """(tokens, seconds from submit to the first token)."""
    stamps = []
    t0 = time.monotonic()
    out = eng.submit(prompt, n, timeout=900,
                     on_token=lambda _r, _t: stamps.append(time.monotonic()))
    return out[0], stamps[0] - t0


def serving_counts(PA, QM, reset=False):
    if reset:
        PA.paged_attention.launches = 0
        QM.int8_weight_matmul.launches = 0
    return {"paged_attention": PA.paged_attention.launches,
            "int8_weight_matmul": QM.int8_weight_matmul.launches}


def hold_launches(tag, quant, launches, steps):
    """The returning rows' decode steps ran the serving kernels: depth
    paged-attention calls a one-token step, and in int8 at least a
    pass's int8 matmul calls a step."""
    depth = CFG["depth"]
    assert steps > 0 and launches["paged_attention"] == depth * steps, (
        tag, launches, steps)
    if quant:
        assert launches["int8_weight_matmul"] >= qmm_per_pass() * steps, (
            tag, launches, steps)
    else:
        assert launches["int8_weight_matmul"] == 0, (tag, launches)


def tier_layout(eng, toks):
    """Where a prompt's full pages sit: {"hbm_pages", "host_pages",
    "disk_pages"}.  Reads only the store (contains / longest_run are
    LRU-neutral); the engine's tier_probe would walk the trie, whose
    match rejuvenates the very pages the next demotions would take."""
    st, n = eng._tier, len(toks) // PAGE
    hbm = next((k for k in range(n)
                if st.contains(st.key_of(toks[:(k + 1) * PAGE]))), n)
    run = st.longest_run(toks, hbm)
    return {"hbm_pages": hbm, "host_pages": run.count("host"),
            "disk_pages": run.count("disk")}


def run_engine_tiers(torch, model, quant, gen):
    """engine_tiers_<tag>: demotion under pool pressure into the host and
    disk tiers, promotion when sessions return, against recompute on an
    engine with no tier.  Eviction strips the oldest chains a level at a
    time (each of ~16 chains loses its deepest page per admission), and
    the host tier spills its oldest entries, so each of the first
    sessions keeps its deepest demoted pages on disk and the shallower
    ones in the host tier: a whole-prompt return reads both tiers
    (labelled disk, the deepest touched).  So the first return is the
    first session's prompt cut where its host-resident pages end, a
    host-only promotion; then the first TIER_RETURNS sessions return
    whole."""
    from container_engine_accelerators_tpu_torch.ops import (
        paged_attention as PA,
    )
    from container_engine_accelerators_tpu_torch.ops import quant_matmul as QM
    from container_engine_accelerators_tpu_torch.serving import (
        ContinuousBatchingEngine,
    )
    from container_engine_accelerators_tpu_torch.serving import observe

    tag = "int8" if quant else "bf16"
    t_phase = time.monotonic()
    dev = model.device
    pb = page_bytes(quant)
    n_full = TIER_PROMPT // PAGE
    disk_dir = os.path.join(LOG_DIR, f"kv_tier_{tag}")
    shutil.rmtree(disk_dir, ignore_errors=True)
    prompts = torch.randint(0, CFG["vocab"], (TIER_SESSIONS, TIER_PROMPT),
                            generator=gen).numpy()
    kw = dict(quant=quant, page_size=PAGE, prefill_chunk=CHUNK, device=dev)
    eng = ContinuousBatchingEngine(
        model, N_SLOTS, kv_host_bytes=TIER_HOST_PAGES * pb,
        kv_disk_dir=disk_dir, kv_disk_bytes=TIER_DISK_BYTES, **kw)
    plain = ContinuousBatchingEngine(model, N_SLOTS, observe=False, **kw)
    # Instrumentation: each promotion's pages, label, bytes and wall, the
    # demotions it ran to make room, each store load by tier, and the
    # seconds in blob decoding and in page scatters.
    promotions, demotions, loads, inside = [], [], [], [False]
    core, demote, get = (eng._tier_promote_core, eng._demote_batch,
                         eng._tier.get)
    spent = {"deserialize_s": 0.0, "scatter_s": 0.0}

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.monotonic()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.monotonic() - t0
        return call

    def timed_core(toks):
        inside[0] = True
        t0 = time.monotonic()
        try:
            m, tier, nbytes = core(toks)
        finally:
            inside[0] = False
        if m:
            nested = [d for d in demotions if d.pop("in", False)]
            promotions.append({"pages": m, "tier": tier, "bytes": nbytes,
                               "s": time.monotonic() - t0,
                               "demote_s": sum(d["s"] for d in nested)})
        return m, tier, nbytes

    def timed_demote(victims):
        t0 = time.monotonic()
        demote(victims)
        demotions.append({"pages": len(victims), "in": inside[0],
                          "s": time.monotonic() - t0})

    def timed_get(key):
        t0 = time.monotonic()
        h = get(key)
        if h is not None:
            loads.append((h.tier, time.monotonic() - t0, len(h.blob)))
        return h

    eng._tier_promote_core = timed_core
    eng._demote_batch = timed_demote
    eng._tier.get = timed_get
    eng._deserialize_pages = timed(eng._deserialize_pages, "deserialize_s")
    eng._page_scatter_fn = timed(eng._page_scatter_fn, "scatter_s")
    try:
        warm = np.arange(1, 41)  # shorter than a page: no trie entry
        for e in (eng, plain):
            e.submit(warm, 2, timeout=600)
        first = [h.wait(timeout=900)[0] for h in
                 [eng.submit_nowait(p, TIER_NEW)
                  for p in prompts[:TIER_RETURNS]]]
        wait_idle(eng)
        before = [eng.export_prefix_pages(p) for p in prompts[:TIER_RETURNS]]
        assert all(b is not None and b[0]["n_pages"] == n_full
                   for b in before), [b and b[0]["n_pages"] for b in before]
        t_press = time.monotonic()
        rest = [h.wait(timeout=900)[0] for h in
                [eng.submit_nowait(p, TIER_NEW)
                 for p in prompts[TIER_RETURNS:]]]
        press_s = time.monotonic() - t_press
        wait_idle(eng)
        s1 = eng.snapshot()
        assert s1["kv_tier_demoted_pages"] > 0, s1
        layout = [tier_layout(eng, p) for p in prompts[:TIER_RETURNS]]
        cut = (layout[0]["hbm_pages"] + layout[0]["host_pages"]) * PAGE
        assert layout[0]["host_pages"] and cut < TIER_PROMPT, layout
        returning = [prompts[0][:cut]] + list(prompts[:TIER_RETURNS])
        # The scatter's first launch loads its kernels: take it here, on
        # the null page's own bytes, so no promotion below pays it.
        from container_engine_accelerators_tpu_torch.models import (
            generate as G,
        )
        G.scatter_kv_pages(eng._cache, [0], G.gather_kv_pages(eng._cache, [0]))
        demotions.clear()
        loads.clear()
        spent.update(deserialize_s=0.0, scatter_s=0.0)
        d0 = eng._dispatch_count
        serving_counts(PA, QM, reset=True)
        back = [timed_submit(eng, p, TIER_NEW) for p in returning]
        wait_idle(eng)
        launches = serving_counts(PA, QM)
        steps = eng._dispatch_count - d0
        s2 = eng.snapshot()
        after = [eng.export_prefix_pages(p) for p in prompts[:TIER_RETURNS]]
        parsed = observe.parse_text(eng.observability.registry.render())
        with eng._cv:
            tier_bps = dict(eng._tier_bps)
        recomputed = [timed_submit(plain, p, TIER_NEW)
                      for p in returning[:2]]
    finally:
        eng.close()
        plain.close()
    closed = eng.snapshot()
    shutil.rmtree(disk_dir, ignore_errors=True)
    assert closed["kv_pages_in_use"] == 0, closed
    assert s2["kv_tier_open_handles"] == 0, s2
    fetch = parsed.get("kv_tier_fetch_seconds_count", {})
    by_label = {t: fetch.get(f'{{tier="{t}"}}', 0.0)
                for t in ("host", "disk")}
    assert by_label["host"] >= 1 and by_label["disk"] >= 1, (
        by_label, layout)
    assert len(promotions) == len(returning), promotions
    hit = s2["prefix_hit_tokens"] - s1["prefix_hit_tokens"]
    want_hit = sum(len(p) for p in returning) - len(returning) * TIER_GRID
    assert hit >= want_hit, (hit, want_hit, s2)
    # The promoted pages (read from both tiers) are bitwise the bytes
    # they were demoted with.
    same = [a is not None and a[0] == b[0] and a[1] == b[1]
            for a, b in zip(after, before)]
    assert all(same), same
    hold_launches(f"engine_tiers_{tag}", quant, launches, steps)
    qparams = deq = None
    if quant:
        from container_engine_accelerators_tpu_torch.models import (
            quant_generate as QG,
        )
        qparams = QG.quantize_decode_params(model)
        deq = QG.dequantize_decode_params(qparams, model)
    gaps = [oracle_gap(torch, model, p, out, quant, qparams, deq)
            for p, (out, _) in zip(returning, back)]
    assert max(gaps) <= TOP2_TOL, (tag, gaps)
    by_promotion = {}
    for label in ("host", "disk"):
        ps = [p for p in promotions if p["tier"] == label]
        pages = sum(p["pages"] for p in ps)
        wall = sum(p["s"] for p in ps)
        net = wall - sum(p["demote_s"] for p in ps)
        by_promotion[label] = {
            "promotions": len(ps), "pages": pages,
            "ms_per_page": wall / pages * 1e3,
            "ms_per_page_net_of_demotion": net / pages * 1e3,
            "bytes_per_s": sum(p["bytes"] for p in ps) / wall,
        }
    load_ms = {}
    for t in ("host", "disk"):
        ls = [(s, n) for tier, s, n in loads if tier == t]
        load_ms[t] = {
            "entries": len(ls),
            "ms_per_page": sum(s for s, _ in ls) / max(len(ls), 1) * 1e3,
            "bytes_per_s": (sum(n for _, n in ls) / sum(s for s, _ in ls)
                            if ls else None)}
    dem_pages = sum(d["pages"] for d in demotions)
    return {
        "phase": f"engine_tiers_{tag}",
        "sessions": TIER_SESSIONS, "prompt": TIER_PROMPT, "new": TIER_NEW,
        "returning_prompt_tokens": [len(p) for p in returning],
        "page_bytes": pb,
        "kv_host_bytes": TIER_HOST_PAGES * pb,
        "kv_disk_bytes": TIER_DISK_BYTES,
        "kv_pages_total": s2["kv_pages_total"],
        "demoted_pages": s1["kv_tier_demoted_pages"],
        "layout_before_return": layout,
        "promoted_pages": (s2["kv_tier_promoted_pages"]
                           - s1["kv_tier_promoted_pages"]),
        "promotions_by_label": by_label,
        "promotion": by_promotion,
        "store_loads": load_ms,
        # Over every promotion of the return: blob decoding (in place)
        # and the scatters (host-to-device copy and index_copy_).
        "promotion_ms_per_page_in": {
            k[:-2]: v / max(sum(p["pages"] for p in promotions), 1) * 1e3
            for k, v in spent.items()},
        "demotion_during_return": {
            "pages": dem_pages,
            "ms_per_page": (sum(d["s"] for d in demotions) / dem_pages * 1e3
                            if dem_pages else None)},
        "engine_tier_bytes_per_s_ema": tier_bps,
        "return_ttft_s": [{"prompt": len(q), "label": p["tier"],
                           "pages": p["pages"], "s": s}
                          for q, p, (_, s) in zip(returning, promotions,
                                                  back)],
        # The same two prompts (the host-only cut, the first session
        # whole) recomputed on an engine with no tier.
        "recompute_ttft_s": [{"prompt": len(q), "s": s} for q, (_, s) in
                             zip(returning, recomputed)],
        "recompute_ms_per_page": [s / (len(q) // PAGE) * 1e3 for q, (_, s)
                                  in zip(returning, recomputed)],
        "prefix_hit_tokens": hit,
        "pressure_s": press_s,
        "returning_rows_launches": launches, "returning_rows_steps": steps,
        "bitwise_after_round_trip": all(same),
        "tier_stats": {k: v for k, v in s2.items()
                       if k.startswith("kv_tier")},
        "max_gap_to_oracle_argmax": max(gaps), "top2_tolerance": TOP2_TOL,
        "distinct_tokens_first_visit": [len(set(o)) for o in first],
        "distinct_tokens_pressure": min(len(set(o)) for o in rest),
        "kv_pages_in_use_after_close": closed["kv_pages_in_use"],
        "seconds": time.monotonic() - t_phase,
    }


def refuse_foreign(eng, tokens, foreign):
    """`eng` must refuse `foreign` (a (meta, blob) of the other layout)
    with the reference's ValueError and hold no page for it: returns the
    refusal's message."""
    in_use = eng.snapshot()["kv_pages_in_use"]
    try:
        eng.adopt_prefix_pages(tokens, *foreign)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a blob of the other layout adopted")
    assert eng.snapshot()["kv_pages_in_use"] == in_use
    return refused


def refuse_foreign_fresh(model, quant, tokens, foreign):
    """refuse_foreign on a fresh engine of layout `quant`: the bf16
    migrate phase runs first, so it is held against the int8 phase's
    blob afterwards."""
    from container_engine_accelerators_tpu_torch.serving import (
        ContinuousBatchingEngine,
    )

    eng = ContinuousBatchingEngine(model, N_SLOTS, quant=quant,
                                   page_size=PAGE, prefill_chunk=CHUNK,
                                   observe=False, device=model.device)
    try:
        return refuse_foreign(eng, tokens, foreign)
    finally:
        eng.close()


def run_engine_migrate(torch, model, quant, gen_reqs, foreign=None):
    """engine_migrate_<tag>: engine A serves requests() and exports the
    512-token prefix its requests #2 and #4 share; a fresh engine B
    adopts it and serves those two.  `foreign` (a blob of the other
    layout) must be refused by B with no page held.  Returns the record,
    A's (meta, blob) and the shared prefix."""
    from container_engine_accelerators_tpu_torch.serving import (
        ContinuousBatchingEngine,
    )

    tag = "int8" if quant else "bf16"
    t_phase = time.monotonic()
    dev = model.device
    reqs = requests(gen_reqs, torch)
    shared = reqs[2][0][:MIGRATE_SHARED]
    assert (reqs[4][0][:MIGRATE_SHARED] == shared).all()
    kw = dict(quant=quant, page_size=PAGE, prefill_chunk=CHUNK,
              observe=False, device=dev)
    a = ContinuousBatchingEngine(model, N_SLOTS, **kw)
    b = ContinuousBatchingEngine(model, N_SLOTS, **kw)
    try:
        outs_a = [h.wait(timeout=900)[0] for h in
                  [a.submit_nowait(p, n) for p, n in reqs]]
        wait_idle(a)
        a.export_prefix_pages(shared)  # the first call's one-time set-up
        b.submit(np.arange(1, 41), 2, timeout=600)  # warm-up
        t0 = time.monotonic()
        meta, blob = a.export_prefix_pages(shared)
        export_s = time.monotonic() - t0
        assert meta["n_pages"] == MIGRATE_SHARED // PAGE, meta
        refused = (refuse_foreign(b, shared, foreign)
                   if foreign is not None else None)
        t0 = time.monotonic()
        adopted = b.adopt_prefix_pages(shared, meta, blob)
        adopt_s = time.monotonic() - t0
        assert adopted == meta["n_pages"], adopted
        s0 = b.snapshot()
        outs_b = [h.wait(timeout=900)[0] for h in
                  [b.submit_nowait(reqs[i][0], reqs[i][1]) for i in (2, 4)]]
        wait_idle(b)
        s1 = b.snapshot()
        again = b.export_prefix_pages(shared)
    finally:
        a.close()
        b.close()
    hit = s1["prefix_hit_tokens"] - s0["prefix_hit_tokens"]
    assert hit >= 2 * MIGRATE_SHARED, (hit, s1)
    assert again[0] == meta and again[1] == blob, "B's re-export differs"
    # B serves both over adopted pages.  A served #4 over its own pages
    # of the prefix (a hit) and #2 without a hit: in bf16 that prefill
    # wrote exactly the bytes B preloads, so both match bitwise; the
    # int8 pages are quantized, so B's #2 is held to the oracle there.
    qparams = deq = None
    if quant:
        from container_engine_accelerators_tpu_torch.models import (
            quant_generate as QG,
        )
        qparams = QG.quantize_decode_params(model)
        deq = QG.dequantize_decode_params(qparams, model)
    assert outs_b[1] == outs_a[4], first_divergence(outs_b[1], outs_a[4])
    gap = oracle_gap(torch, model, reqs[2][0], outs_b[0], quant, qparams,
                     deq)
    if not quant:
        assert outs_b[0] == outs_a[2], first_divergence(outs_b[0], outs_a[2])
    assert gap <= TOP2_TOL, gap
    rec = {
        "phase": f"engine_migrate_{tag}", "pages": meta["n_pages"],
        "blob_bytes": len(blob),
        "export_ms": export_s * 1e3, "adopt_ms": adopt_s * 1e3,
        "export_bytes_per_s": len(blob) / export_s,
        "adopt_bytes_per_s": len(blob) / adopt_s,
        "prefix_hit_tokens": hit,
        "tokens_equal_a": [outs_b[0] == outs_a[2], outs_b[1] == outs_a[4]],
        "max_gap_to_oracle_argmax": gap,
        "reexport_bitwise": True,
        "foreign_blob_refused": refused,
        "seconds": time.monotonic() - t_phase,
    }
    return rec, (meta, blob), shared


def run_engine_observe(torch, model, gen_reqs):
    """engine_observe_bf16_fused: requests() through a fused engine with
    observe=True and one with observe=False, in turns (off, on, on,
    off); then the observed engine's revival and kill."""
    from container_engine_accelerators_tpu_torch.serving import (
        ContinuousBatchingEngine,
        EngineSupervisor,
    )
    from container_engine_accelerators_tpu_torch.serving import observe

    t_phase = time.monotonic()
    reqs = requests(gen_reqs, torch)
    rows = len(reqs)
    mk = dict(page_size=PAGE, prefill_chunk=CHUNK, decode_steps=FUSED_STEPS,
              device=model.device)
    off = ContinuousBatchingEngine(model, N_SLOTS, observe=False, **mk)
    on = ContinuousBatchingEngine(model, N_SLOTS, observe=True, **mk)
    obs = on.observability
    sup = None
    try:
        for e in (off, on):  # captures the block widths 4 and 2
            e.submit(np.arange(1, 41), 2 * FUSED_STEPS, timeout=600)
            wait_idle(e)
        # Each engine's first run prefills every prompt and its second
        # hits its own prefix cache (bf16 rounds the two paths
        # differently), so the runs pair as (first, first), (second,
        # second).
        runs, tokens = {True: [], False: []}, {True: [], False: []}
        h0 = {n: getattr(obs, n).state() for n in ("ttft", "itl")}
        traces0 = obs.traces.total
        for observed in (False, True, True, False):
            e = on if observed else off
            t0 = time.monotonic()
            outs = [h.wait(timeout=900)[0] for h in
                    [e.submit_nowait(p, n) for p, n in reqs]]
            wall = time.monotonic() - t0
            wait_idle(e)
            runs[observed].append(sum(len(o) for o in outs) / wall)
            tokens[observed].append(outs)
        for k in (0, 1):
            assert tokens[True][k] == tokens[False][k], [
                first_divergence(a, b)
                for a, b in zip(tokens[True][k], tokens[False][k])]
        h1 = {n: getattr(obs, n).state() for n in ("ttft", "itl")}
        window = {n: [x - y for x, y in zip(h1[n][0], h0[n][0])]
                  for n in h1}
        n_tok = sum(len(o) for outs in tokens[True] for o in outs)
        ttft_n, itl_n = sum(window["ttft"]), sum(window["itl"])
        assert ttft_n == 2 * rows, (ttft_n, rows)
        assert itl_n == n_tok - 2 * rows, (itl_n, n_tok)
        text = obs.registry.render()
        parsed = observe.parse_text(text)
        snap = on.snapshot()
        assert parsed["serve_ttft_seconds_count"][""] == obs.ttft.state()[2]
        assert parsed["serve_engine_retired_total"][""] == snap["retired"]
        assert observe.parse_text(obs.registry.render(openmetrics=True))[
            "serve_itl_seconds_count"][""] == obs.itl.state()[2]
        traces = obs.traces.traces()[-rows:]
        assert obs.traces.total - traces0 == 2 * rows
        stages = [{s.name for s in t.spans} for t in traces]
        assert all({"queue_wait", "prefill_chunk", "decode"} <= st
                   for st in stages), stages
        # Revival: one block fails on every attempt until the retries
        # are spent; the supervisor revives, the recorder holds the
        # story and the restart's dump.
        sup = EngineSupervisor(on, max_restarts=2).start()
        real, fails = on._fused_fn, [0]

        def flaky(*a, **k):
            if fails[0] <= on._step_retries:
                fails[0] += 1
                raise RuntimeError("injected fused-block fault")
            return real(*a, **k)

        on._fused_fn = flaky
        try:
            on.submit(reqs[0][0], 16, timeout=900)
        except RuntimeError:
            pass
        # The revival counts its restart before it records the event
        # (engine.py `revive`), so wait for the event itself.
        t0 = time.monotonic()
        while "restart" not in [e["kind"] for e in obs.recorder.events()]:
            assert time.monotonic() - t0 < 60, "the engine never revived"
            time.sleep(0.01)
        assert on.snapshot()["restarts"] >= 1
        kinds = [e["kind"] for e in obs.recorder.events()]
        for k in ("step_retry", "step_fail", "crash", "restart"):
            assert k in kinds, (k, kinds[-12:])
        assert on.submit(reqs[0][0], 16, timeout=900)
        sup.stop()
        sup = None
        on.kill(RuntimeError("chip_smoke kill"))
        recorder = on.snapshot().get("flight_recorder") or []
        assert recorder and recorder[-1]["kind"] == "kill", recorder[-3:]
    finally:
        if sup is not None:
            sup.stop()
        on.close()
        off.close()

    def q(name, p):
        h = getattr(obs, name)
        return observe.quantile_from_counts(h.bounds, window[name], p)

    on_tps = sum(runs[True]) / len(runs[True])
    off_tps = sum(runs[False]) / len(runs[False])
    return {
        "phase": "engine_observe_bf16_fused",
        "engine_options": {"decode_steps": FUSED_STEPS},
        "requests": rows, "tokens_per_run": n_tok // 2,
        "tokens_per_s_observed": runs[True],
        "tokens_per_s_unobserved": runs[False],
        "observed_over_unobserved": on_tps / off_tps,
        "ttft_s": {"p50": q("ttft", 0.5), "p99": q("ttft", 0.99),
                   "count": ttft_n},
        "itl_s": {"p50": q("itl", 0.5), "p99": q("itl", 0.99),
                  "count": itl_n},
        "metrics_series": len(parsed),
        "trace_stages": sorted(stages[0]),
        "flight_recorder_events_at_kill": len(recorder),
        "recorder_kinds": sorted(set(kinds)),
        "seconds": time.monotonic() - t_phase,
    }


# -- phase 4c: the HTTP server ---------------------------------------------


def server_flags():
    """The serving width of the engine phases as the server's flags
    (server.py parses them as a user's command line would)."""
    return [
        "--model", "transformer_lm", "--vocab", str(CFG["vocab"]),
        "--dim", str(CFG["dim"]), "--depth", str(CFG["depth"]),
        "--heads", str(CFG["heads"]), "--max-seq", str(CFG["max_seq"]),
        "--slots", str(N_SLOTS), "--page-size", str(PAGE),
        "--prefill-chunk", str(CHUNK), "--device", "cuda",
        "--port", "0",
    ]


# The drain check's two in-flight requests: 64-token prompts decoding
# this many tokens (~1-3 s), far longer than the checks made meanwhile.
DRAIN_NEW = 256
# server_wave's second volley: 8 prompts of 40-63 tokens, 16 new each,
# one (p_bucket, n_bucket) = (64, 16) key.
WAVE_SHORT = (40, 16)
# http_overhead: the gap between two client threads' starts, far above
# a request's HTTP cost (~1 ms), so both sides queue them in one order.
OVERHEAD_GAP_S = 0.005


def http(port, path, body=None, headers=None, timeout=900):
    """(code, body bytes, headers, seconds) of one request to the server
    on 127.0.0.1:port; a POST when `body` is given (a dict as JSON)."""
    data = body if body is None or isinstance(body, bytes) else (
        json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers, (
                time.monotonic() - t0)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers, time.monotonic() - t0


def volley(port, bodies, path="/generate"):
    """Each body POSTed at once on a client thread of its own:
    ([(code, body, headers, seconds)] in order, wall seconds)."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = http(port, path, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return out, time.monotonic() - t0


def staggered(calls):
    """Each call on a client thread of its own, started OVERHEAD_GAP_S
    after the one before: ([result] in order, wall seconds)."""
    out = [None] * len(calls)

    def one(i):
        out[i] = calls[i]()

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(calls))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
        time.sleep(OVERHEAD_GAP_S)
    for t in threads:
        t.join(timeout=900)
    return out, time.monotonic() - t0


def http_overhead(app, port, reqs):
    """What HTTP costs on one booted app: the same requests through the
    app's generate call (the handler's own, with a minted trace context
    where the engine records spans) and POSTed to /generate, in one
    staggered order, volleys alternating submit, HTTP, HTTP, submit."""
    from container_engine_accelerators_tpu_torch.serving import otel

    def direct(p, n):
        def call():
            ctx = otel.TraceContext.new() if app.engine is not None else None
            return app._generate(np.asarray(p, np.int32)[None], n, 0.0,
                                 trace_ctx=ctx)[0]
        return call

    def posted(p, n):
        def call():
            code, body, _, _ = http(port, "/generate",
                                    {"prompt": [p.tolist()], "max_new": n})
            assert code == 200, (code, body[:300])
            return json.loads(body)["tokens"][0]
        return call

    n_tok = sum(n for _, n in reqs)
    tps = {"submit": [], "http": []}
    for side in ("submit", "http", "http", "submit"):
        make = direct if side == "submit" else posted
        outs, wall = staggered([make(p, n) for p, n in reqs])
        assert [len(t) for t in outs] == [n for _, n in reqs], side
        tps[side].append(n_tok / wall)
    return {"http_tokens_per_s": tps["http"],
            "submit_tokens_per_s": tps["submit"],
            "http_over_submit": float(np.mean(tps["http"])
                                      / np.mean(tps["submit"]))}


def boot_server(flags):
    """A ServingApp as a user's command line builds it (parse_args), its
    Server on 127.0.0.1:<free port>: /healthz must answer 503 "loading"
    before load_model (random weights from seed 0, the warm-up) and 200
    after.  Returns (app, httpd, serve thread, port, boot seconds)."""
    from container_engine_accelerators_tpu_torch import server as SV

    app = SV.ServingApp(SV.parse_args(flags))
    httpd = app.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    code, body, _, _ = http(port, "/healthz")
    assert (code, body) == (503, b"loading"), (code, body)
    t0 = time.monotonic()
    app.load_model()
    boot_s = time.monotonic() - t0
    code, body, _, _ = http(port, "/healthz")
    assert (code, body) == (200, b"ok"), (code, body)
    return app, httpd, thread, port, boot_s


def scrape(port):
    from container_engine_accelerators_tpu_torch.serving import observe

    code, body, headers, _ = http(port, "/metrics")
    assert code == 200 and headers["Content-Type"].startswith(
        "text/plain"), code
    return observe.parse_text(body.decode())


def quantiles(values):
    if not values:
        return {"p50": None, "p99": None}
    return {"p50": float(np.percentile(values, 50)),
            "p99": float(np.percentile(values, 99))}


def torch_randint(gen, shape):
    import torch

    return torch.randint(0, CFG["vocab"], shape, generator=gen).numpy()


def drain_check(app, httpd, thread, port, gen):
    """drain_for_shutdown while two requests are in flight: both finish
    with 200 and all their tokens, a new /generate gets 503 with a
    Retry-After, /healthz 503 "draining: shutdown", /metrics 200, and
    the server stops within the drain timeout.  Returns the record."""
    prompts = torch_randint(gen, (2, 64))
    inflight = {}

    def one(i):
        inflight[i] = http(port, "/generate", {
            "prompt": [prompts[i].tolist()], "max_new": DRAIN_NEW})

    clients = [threading.Thread(target=one, args=(i,)) for i in (0, 1)]
    for t in clients:
        t.start()

    def started():
        with app._state_lock:
            if app._inflight < 2:
                return False
        if app.engine is not None:
            return app.engine.snapshot()["active_rows"] == 2
        if app.fleet is not None:
            return sum(e["active_rows"]
                       for e in app.fleet.snapshot()["engines"]) == 2
        return app.batcher.busy()

    t0 = time.monotonic()
    while not started():
        assert time.monotonic() - t0 < 120, "the drain's requests never ran"
        time.sleep(0.002)
    done = {}

    def drain():
        t = time.monotonic()
        done["idle"] = app.drain_for_shutdown(httpd)
        done["s"] = time.monotonic() - t

    drainer = threading.Thread(target=drain)
    drainer.start()
    while "shutdown" not in app.draining():
        time.sleep(0.001)
    code, body, headers, _ = http(port, "/generate", {
        "prompt": [[1, 2, 3]], "max_new": 4})
    assert code == 503 and int(headers["Retry-After"]) >= 1, (code, body)
    code, body, headers, _ = http(port, "/healthz")
    assert (code, body) == (503, b"draining: shutdown"), (code, body)
    assert int(headers["Retry-After"]) >= 1
    assert http(port, "/metrics")[0] == 200
    with app._state_lock:
        still = app._inflight
    assert still == 2, f"the drain's requests ended before its checks ({still})"
    for t in clients:
        t.join(timeout=600)
    drainer.join(timeout=app.cfg.drain_timeout_s + 60)
    thread.join(timeout=30)
    for i in (0, 1):
        code, body, _, _ = inflight[i]
        assert code == 200, (code, body[:200])
        assert len(json.loads(body)["tokens"][0]) == DRAIN_NEW
    assert done.get("idle") is True, done
    assert done["s"] < app.cfg.drain_timeout_s, done
    assert not thread.is_alive(), "the server did not stop"
    return {"drain_s": done["s"], "in_flight_at_drain": 2,
            "in_flight_finished": 2, "new_request_code": 503,
            "healthz_while_draining": "draining: shutdown"}


def run_server(torch, quant, engine_tps, gen_reqs, wave=False):
    """server_int8 / server_bf16 / server_wave: the server booted over
    the continuous engine (--quant auto, int8 at 16 slots; or --quant
    off) or the wave batcher (--engine wave --quant auto), then
    requests()' 8 requests POSTed at once (server_wave adds 8 short ones
    of one bucket key while the first volley decodes), a malformed
    request, /metrics, /tracez and the drain check, with the serving
    kernels' launch counters set to 0 before the traffic and read after
    the drain."""
    from container_engine_accelerators_tpu_torch.ops import (
        paged_attention as PA,
    )
    from container_engine_accelerators_tpu_torch.ops import quant_matmul as QM
    from container_engine_accelerators_tpu_torch.serving import observe

    tag = "wave" if wave else ("int8" if quant else "bf16")
    t_phase = time.monotonic()
    flags = server_flags() + (["--engine", "wave", "--quant", "auto"] if wave
                              else ["--quant", "auto" if quant else "off"])
    app, httpd, thread, port, boot_s = boot_server(flags)
    eng = app.engine
    reqs = requests(gen_reqs, torch)
    bodies = [{"prompt": [p.tolist()], "max_new": n} for p, n in reqs]
    try:
        assert (eng.quant if eng is not None else app.qparams is not None) \
            == quant, tag
        m0 = scrape(port)
        if eng is not None:
            obs, snap0, d0 = eng.observability, eng.snapshot(), \
                eng._dispatch_count
            h0 = obs.ttft.state()
        else:
            stats0 = dict(app.batcher.stats)
        serving_counts(PA, QM, reset=True)
        if wave:
            short = [{"prompt": torch_randint(
                gen_reqs, (1, WAVE_SHORT[0] + 3 * i)).tolist(),
                "max_new": WAVE_SHORT[1]} for i in range(8)]
            box = {}
            runner = threading.Thread(
                target=lambda: box.update(out=volley(port, bodies)))
            runner.start()
            # The short volley queues behind the long groups' decode,
            # so its requests coalesce when their key comes up.
            t0 = time.monotonic()
            while not app.batcher.busy():
                assert time.monotonic() - t0 < 120
                time.sleep(0.001)
            short_out, short_wall = volley(port, short)
            runner.join(timeout=900)
            outs, wall = box["out"]
        else:
            outs, wall = volley(port, bodies)
            short_out, short = [], []
        for code, body, _, _ in outs + short_out:
            assert code == 200, (tag, code, body[:300])
        got = [json.loads(b)["tokens"][0] for _, b, _, _ in outs]
        got_short = [json.loads(b)["tokens"][0] for _, b, _, _ in short_out]
        assert [len(t) for t in got] == [n for _, n in reqs], tag
        assert all(len(t) == WAVE_SHORT[1] for t in got_short), tag
        m1 = scrape(port)
        route = '{route="generate",code="200"}'
        assert (m1["serve_http_requests_total"][route]
                - m0["serve_http_requests_total"].get(route, 0.0)) == len(
                    outs) + len(short_out), tag
        rec = {"phase": f"server_{tag}", "server_flags": flags,
               "boot_s": boot_s}
        if eng is not None:
            h1 = obs.ttft.state()
            window = [x - y for x, y in zip(h1[0], h0[0])]
            ttft_n = (m1["serve_ttft_seconds_count"][""]
                      - m0["serve_ttft_seconds_count"][""])
            assert ttft_n == len(reqs) == sum(window), (ttft_n, window)
            rec["ttft_s"] = {
                "p50": observe.quantile_from_counts(obs.ttft.bounds,
                                                    window, 0.5),
                "p99": observe.quantile_from_counts(obs.ttft.bounds,
                                                    window, 0.99),
                "count": ttft_n}
            snap = eng.snapshot()
            assert snap["prefix_hits"] - snap0["prefix_hits"] >= 1, snap
            rec["prefix_hits"] = snap["prefix_hits"] - snap0["prefix_hits"]
            code, body, _, _ = http(port, "/tracez")
            tz = json.loads(body)
            ids = {r["trace_id"] for r in tz["recent"]}
            want_ids = [json.loads(b)["trace_id"] for _, b, _, _ in outs]
            assert code == 200 and set(want_ids) <= ids, (want_ids, ids)
            rec["tracez_stages"] = sorted(k for k in tz["stages"]
                                          if k != "requests")
        else:
            rec["ttft_s"] = "not measured (the wave path records no spans)"
        code, body, _, _ = http(port, "/generate", b"not json")
        assert code == 400, (code, body)
        # The serving kernels' oracle rule on every served token.
        if eng is not None:
            qparams, deq = (eng._qparams, eng._deq) if quant else (None, None)
        else:
            qparams, deq = app.qparams, app.deq
        gaps = [oracle_gap(torch, app.model, np.asarray(p), t, quant,
                           qparams, deq)
                for p, t in zip([p for p, _ in reqs]
                                + [b["prompt"][0] for b in short],
                                got + got_short)]
        if max(gaps) > TOP2_TOL:
            raise AssertionError(
                f"server_{tag}: token off the oracle's argmax by "
                f"{max(gaps)} logits (> {TOP2_TOL})")
        n_tok = sum(len(t) for t in got)
        lat = [s for _, _, _, s in outs]
        rec.update({
            "requests": len(outs), "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "vs_engine": n_tok / wall / engine_tps,
            "engine_tokens_per_s": engine_tps,
            "request_latency_s": quantiles(lat),
            "max_gap_to_oracle_argmax": max(gaps),
            "malformed_request_code": 400,
        })
        if wave:
            stats = dict(app.batcher.stats)
            served = len(outs) + len(short_out)
            groups = stats["groups"] - stats0["groups"]
            assert stats["requests"] - stats0["requests"] == served, stats
            assert groups < served, (groups, served)
            rec["wave"] = {"groups": groups, "requests": served,
                           "max_group_rows": stats["max_group_rows"],
                           "short_volley_s": short_wall,
                           "short_request_latency_s": quantiles(
                               [s for _, _, _, s in short_out])}
        rec["http_overhead"] = http_overhead(app, port, reqs)
        rec.update(drain_check(app, httpd, thread, port, gen_reqs))
        if eng is not None:
            wait_idle(eng)
        launches = serving_counts(PA, QM)
        if eng is not None:
            snap1 = eng.snapshot()
            steps = steps_run(snap0, snap1, eng._dispatch_count - d0)
            hold_launches(f"server_{tag}", quant, launches, steps)
            rec["decode_steps_run"] = steps
        else:
            assert launches["paged_attention"] == 0, launches
            assert launches["int8_weight_matmul"] > 0, launches
        rec["launches"] = launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
    if eng is not None:
        closed = eng.snapshot()
        assert closed["kv_pages_in_use"] == 0, closed
        rec["kv_pages_in_use_after_close"] = 0
    rec["seconds"] = time.monotonic() - t_phase
    return rec, launches


# -- phase 4d: the replica fleet ---------------------------------------------
# FLEET_REPLICAS replicas of N_SLOTS slots each, all on the one card.  The
# traffic: requests() (alone, timed against the single engine's tokens/s),
# then FLEET_GROUPS groups of FLEET_GROUP_SIZE greedy requests, each group
# a FLEET_PREFIX-token prefix with FLEET_TAIL-token tails and FLEET_NEW new
# tokens; a group's first request goes first and the others once it is
# placed, so they must follow it by prefix affinity.
FLEET_REPLICAS = 2
FLEET_GROUPS, FLEET_GROUP_SIZE = 4, 4
FLEET_PREFIX, FLEET_TAIL, FLEET_NEW = 512, 128, 64
# The fault runs: FLEET_WAVES waves of one request the hash ring places on
# each replica (96-token prompts, FLEET_FAULT_NEW new tokens).  In-process,
# replica 1's decode seam fails persistently from its FLEET_FAULT_AFTER-th
# call, so each wave's request there crashes it: the 4th crash spends the
# supervisor's 3 restarts and evicts it.  In the process fleet, worker 1 is
# killed while its first wave decodes.
FLEET_WAVES, FLEET_FAULT_NEW, FLEET_FAULT_AFTER = 4, 48, 4
# The migration check's tail, under one page: the owner serves the prompt
# itself first and keeps exactly the group's prefix pages in its trie.
MIGRATE_TAIL = 40


def fleet_traffic(gen, torch):
    """(requests(), the groups: FLEET_GROUPS lists of FLEET_GROUP_SIZE
    (prompt, new tokens))."""
    reqs = requests(gen, torch)
    groups = []
    for _ in range(FLEET_GROUPS):
        prefix = torch_randint(gen, (FLEET_PREFIX,))
        groups.append([
            (np.concatenate([prefix, torch_randint(gen, (FLEET_TAIL,))]),
             FLEET_NEW) for _ in range(FLEET_GROUP_SIZE)])
    return reqs, groups


def fleet_engine_kw(extra=()):
    """The engine kwargs the server builds from server_flags() and
    `extra` (its one engine_kw, shared by the single engine and both
    fleet modes)."""
    from container_engine_accelerators_tpu_torch import server as SV

    return SV.ServingApp(SV.parse_args(server_flags() + list(extra))
                         ).engine_kw()


def record_placements(fleet):
    """Wrap the fleet's routing seam (the one install_fleet_faults wraps):
    {prompt bytes: [(replica, reason), ...]} of every placement."""
    placed, lock, inner = {}, threading.Lock(), fleet._route

    def traced(route_row, stats, trace=None):
        out = inner(route_row, stats, trace=trace)
        with lock:
            placed.setdefault(np.asarray(route_row, np.int32).tobytes(),
                              []).append(out)
        return out

    fleet._route = traced
    return placed


def pkey(prompt):
    return np.asarray(prompt, np.int32).tobytes()


def in_order(calls, keys=None, placed=None):
    """Each call on a client thread of its own, all in flight together;
    with `placed` (record_placements), each starts once the request
    before it is placed, so two requests sharing a prefix meet the
    router (and an int8 replica's prefix cache) in one order every run:
    ([result] in order, wall seconds).  A call that raises fails."""
    out, errors = [None] * len(calls), []

    def one(i):
        try:
            out[i] = calls[i]()
        except Exception as e:  # pylint: disable=broad-except
            errors.append((i, repr(e)[:300]))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(calls))]
    t0 = time.monotonic()
    for i, t in enumerate(threads):
        if placed is not None and i:
            wait_for(lambda k=keys[i - 1]: k in placed or errors,
                     "the previous request's placement", timeout=120)
        t.start()
    for t in threads:
        t.join(timeout=900)
    assert not errors, errors
    return out, time.monotonic() - t0


def fleet_run(fleet, items, placed=None):
    """Each (prompt, new tokens) through fleet.submit (in_order): (tokens
    in order, wall seconds)."""
    def call(p, n):
        return lambda: fleet.submit(np.asarray(p, np.int32)[None], n, 0.0,
                                    timeout=900)[0]

    out, wall = in_order([call(p, n) for p, n in items],
                         [pkey(p) for p, _ in items], placed)
    assert [len(t) for t in out] == [n for _, n in items], "short tokens"
    return out, wall


def fleet_groups(fleet, groups, placed):
    """Every group's leader, then the followers, each placed after the
    one before: (tokens by group, wall seconds)."""
    followers = [r for g in groups for r in g[1:]]
    out, wall = fleet_run(fleet, [g[0] for g in groups] + followers, placed)
    k = FLEET_GROUP_SIZE - 1
    return [[out[g]] + out[len(groups) + g * k:len(groups) + (g + 1) * k]
            for g in range(len(groups))], wall


def hold_affinity(groups, placed):
    """Each group's followers went where its leader went, by affinity."""
    homes = []
    for g in groups:
        (home, _), = placed[pkey(g[0][0])]
        for p, _ in g[1:]:
            assert placed[pkey(p)] == [(home, "affinity")], (
                home, placed[pkey(p)])
        homes.append(home)
    return homes


def idle_fleet(fleet):
    """wait_idle on every in-process replica; a worker process's replica
    until its snapshot holds no queued or active row."""
    for eng in fleet.engines:
        if hasattr(eng, "_pending"):
            wait_idle(eng)
        else:
            wait_for(lambda e=eng: not any(
                e.snapshot(max_age_s=0)[k]
                for k in ("queue_depth", "active_rows")), "an idle worker")


def engine_deltas(snaps0, snaps1, keys):
    return {k: [s1[k] - s0[k] for s0, s1 in zip(snaps0, snaps1)]
            for k in keys}


def fleet_gap(torch, model, quant, items, outs):
    """The largest oracle gap over the requests (TOP2_TOL bounds it)."""
    qparams = deq = None
    if quant:
        from container_engine_accelerators_tpu_torch.models import (
            quant_generate as QG,
        )
        qparams = QG.quantize_decode_params(model)
        deq = QG.dequantize_decode_params(qparams, model)
    gap = max(oracle_gap(torch, model, np.asarray(p), t, quant, qparams, deq)
              for (p, _), t in zip(items, outs))
    assert gap <= TOP2_TOL, f"a fleet token off the oracle's argmax by {gap}"
    return gap


def fleet_serve(torch, fleet, engine_tps, gen):
    """The fleet traffic through `fleet`: requests() alone, then the
    groups.  Checks the groups' affinity and prefix hits and that every
    replica served.  Returns (record, requests() tokens, the groups'
    tokens, the traffic)."""
    reqs, groups = fleet_traffic(gen, torch)
    placed = record_placements(fleet)
    s0 = [e.snapshot() for e in fleet.engines]
    f0 = fleet.snapshot()
    outs, wall = fleet_run(fleet, reqs, placed)
    g_outs, g_wall = fleet_groups(fleet, groups, placed)
    idle_fleet(fleet)
    s1 = [e.snapshot() for e in fleet.engines]
    f1 = fleet.snapshot()
    homes = hold_affinity(groups, placed)
    per = [0] * FLEET_REPLICAS
    for decisions in placed.values():
        for rid, _ in decisions:
            per[rid] += 1
    assert all(per), f"a replica served nothing: {per}"
    d = engine_deltas(s0, s1, ("prefix_hits", "prefix_hit_tokens",
                               "admitted"))
    followers = FLEET_GROUPS * (FLEET_GROUP_SIZE - 1)
    assert sum(d["prefix_hits"]) >= followers, d
    assert sum(d["prefix_hit_tokens"]) >= followers * FLEET_PREFIX, d
    n_tok = sum(len(t) for t in outs)
    g_tok = sum(len(t) for g in g_outs for t in g)
    rec = {
        "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "engine_tokens_per_s": engine_tps,
        "vs_engine": n_tok / wall / engine_tps,
        "group_requests": FLEET_GROUPS * FLEET_GROUP_SIZE,
        "group_tokens": g_tok,
        "group_wall_s": g_wall, "group_tokens_per_s": g_tok / g_wall,
        "placements_per_replica": per, "group_homes": homes,
        "prefix_hits_per_replica": d["prefix_hits"],
        "prefix_hit_tokens_per_replica": d["prefix_hit_tokens"],
        "admitted_per_replica": d["admitted"],
        "router": {k: f1["router"][k] - f0["router"].get(k, 0)
                   for k in ("placements", "affinity_hits", "hash_places",
                             "load_spills")},
        "reroutes": f1["fleet"]["rerouted"] - f0["fleet"]["rerouted"],
        "spills": f1["fleet"]["spills"] - f0["fleet"]["spills"],
    }
    return rec, outs, g_outs, (reqs, groups)


def wave_prompts(fleet, gen):
    """FLEET_WAVES pairs of 96-token prompts, the hash ring placing the
    first of each pair on replica 0 and the second on replica 1."""
    from container_engine_accelerators_tpu_torch.serving import router

    pairs, want = [], {0: [], 1: []}
    while min(len(v) for v in want.values()) < FLEET_WAVES:
        p = torch_randint(gen, (96,))
        rid = fleet.router.ring.lookup(router._token_key(p.astype(np.int32)))
        if len(want[rid]) < FLEET_WAVES:
            want[rid].append(p)
    for a, b in zip(want[0], want[1]):
        pairs.append([(a, FLEET_FAULT_NEW), (b, FLEET_FAULT_NEW)])
    return pairs


def wait_for(cond, what, timeout=300):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.005)
    return time.monotonic() - t0


def fleet_engine_death(fleet, gen):
    """install_fleet_faults, then engine_death:1 persistent from replica
    1's FLEET_FAULT_AFTER-th decode call over FLEET_WAVES waves (each
    wave once replica 1 is back up): replica 1 is evicted, every request
    completes, replica 0 fails nothing."""
    from container_engine_accelerators_tpu_torch.serving import faults as F

    pairs = wave_prompts(fleet, gen)
    inj = F.FaultInjector(seed=SEED)
    F.install_fleet_faults(fleet, inj)
    stamps = []

    def fault(seam, i):
        stamps.append(time.monotonic())
        return F.InjectedFault(seam, i)

    s0 = fleet.snapshot()
    inj.plan("engine_death:1", fail_after=FLEET_FAULT_AFTER, fail_n=10 ** 9,
             error=fault)
    waves = 0
    t_dead = None
    for pair in pairs:
        if fleet.replica_states()[1] == "dead":
            break
        wait_for(lambda: not fleet.engines[1].crashed,
                 "replica 1 back up for the next wave")
        fleet_run(fleet, pair)
        waves += 1
    wait_for(lambda: fleet.replica_states()[1] == "dead", "the eviction")
    t_dead = time.monotonic()
    s1 = fleet.snapshot()
    e0 = s1["engines"][0]
    for k in ("restarts", "admit_failures", "step_failures", "rows_failed"):
        assert e0[k] == s0["engines"][0][k], (k, e0)
    assert s1["replica_states"] == ["up", "dead"], s1["replica_states"]
    assert s1["fleet"]["replica_deaths"] - s0["fleet"]["replica_deaths"] == 1
    rerouted = s1["fleet"]["rerouted"] - s0["fleet"]["rerouted"]
    assert rerouted >= waves, (rerouted, waves)
    return {
        "waves": waves, "requests": 2 * waves, "requests_completed":
            2 * waves, "injected_faults": len(stamps),
        "replica1_restarts": s1["engines"][1]["restarts"],
        "first_fault_to_eviction_s": t_dead - stamps[0],
        "reroutes": rerouted, "replica_states": s1["replica_states"],
        "replica0_failures": 0,
        "fault_seams": inj.stats(),
    }


def fleet_window(torch, fleet, gen, counts):
    """The profile over a window of 16 x (64 + 32) through the fleet, from
    idle replicas to idle replicas: the port's device events must equal
    the wrappers' calls over both replicas' threads."""
    prompts = torch_randint(gen, (N_SLOTS, 64))

    def window():
        idle_fleet(fleet)
        fleet_run(fleet, [(p, 32) for p in prompts])
        idle_fleet(fleet)

    idle_fleet(fleet)
    rec = device_profile(torch, window, counts=counts, tag="fleet")
    rec["device_events"] = port_events(rec, "fleet")
    assert rec["device_events"] == rec["wrapper_calls"], rec
    return rec


def run_fleet_inproc(torch, model, quant, engine_tps, gen):
    """fleet_inproc_int8 (the server's default engine kwargs: int8 at 16
    slots, one-token paged, prefix cache on) or fleet_inproc_bf16_fused
    (--quant off --decode-steps 4, migrate on; then a prefill:1,decode:1
    fleet); both then time fleet_controls.  Returns (record, the serving kernels' launches over the
    traffic, requests() tokens)."""
    from container_engine_accelerators_tpu_torch.ops import (
        paged_attention as PA,
    )
    from container_engine_accelerators_tpu_torch.ops import quant_matmul as QM
    from container_engine_accelerators_tpu_torch.serving.fleet import (
        FleetManager,
    )

    tag = "int8" if quant else "bf16_fused"
    t_phase = time.monotonic()
    extra = [] if quant else ["--quant", "off", "--decode-steps",
                              str(FUSED_STEPS)]
    kw = fleet_engine_kw(extra)
    assert kw["quant"] == quant, kw
    t0 = time.monotonic()
    fleet = FleetManager(model, FLEET_REPLICAS, N_SLOTS, engine_kw=kw,
                         migrate=not quant)
    rec = {"phase": f"fleet_inproc_{tag}", "engine_kw": {
        k: v for k, v in kw.items() if k != "rng_seed"},
        "replicas": FLEET_REPLICAS, "slots": N_SLOTS,
        "boot_s": time.monotonic() - t0}
    try:
        for eng in fleet.engines:  # warm-up, each replica
            eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 2, timeout=600)
        idle_fleet(fleet)
        d0 = [e._dispatch_count for e in fleet.engines]
        s0 = [e.snapshot() for e in fleet.engines]
        serving_counts(PA, QM, reset=True)
        served, outs, g_outs, (reqs, groups) = fleet_serve(
            torch, fleet, engine_tps, gen)
        launches = serving_counts(PA, QM)
        s1 = [e.snapshot() for e in fleet.engines]
        steps = sum(steps_run(a, b, e._dispatch_count - d)
                    for a, b, e, d in zip(s0, s1, fleet.engines, d0))
        hold_launches(rec["phase"], quant, launches, steps)
        rec.update(served)
        t0 = time.monotonic()  # the oracle launches the kernels too
        rec["max_gap_to_oracle_argmax"] = fleet_gap(
            torch, model, quant, reqs + [r for g in groups for r in g],
            outs + [t for g in g_outs for t in g])
        rec["top2_tolerance"] = TOP2_TOL
        rec["oracle_s"] = time.monotonic() - t0
        rec["decode_steps_run"] = steps
        rec["launches"] = launches
        if quant:
            rec["replica_bytes"], rec["replica_bytes_parts"] = (
                replica_bytes(torch, fleet.engines[0]))
            rec["profile"] = fleet_window(torch, fleet, gen, lambda: {
                "paged_attention": PA.paged_attention.launches,
                "int8_weight_matmul": QM.int8_weight_matmul.launches})
            rec["engine_death"] = fleet_engine_death(fleet, gen)
        else:
            caps = [e._fused.captures for e in fleet.engines]
            assert all(caps), "a replica captured no graph"
            rec["graph_captures"] = [
                [{k: c[k] for k in ("key", "first_call_s", "capture_s")}
                 for c in cap] for cap in caps]
            rec["migrate"] = fleet_migrate(torch, fleet, groups, g_outs)
    finally:
        fleet.close()
    rec["controls"] = fleet_controls(torch, model, kw, reqs, engine_tps)
    if not quant:
        rec["roles"] = fleet_roles(torch, model, kw, reqs, outs)
    rec["seconds"] = time.monotonic() - t_phase
    return rec, launches, outs + [t for g in g_outs for t in g]


def fleet_controls(torch, model, kw, reqs, engine_tps):
    """requests() again, paced as before, through fresh fleets of the
    same engine kwargs, each replica warmed: one replica (the fleet
    layer and the pacing without a second scheduler thread), and two
    at a 0.5 ms interpreter switch interval (5 ms by default: a thread
    that lets the lock go for a device sync may wait an interval to take
    it back while the other thread runs Python).  tokens/s and
    vs_engine of each."""
    import sys

    from container_engine_accelerators_tpu_torch.serving.fleet import (
        FleetManager,
    )

    out = {}
    interval = sys.getswitchinterval()
    for name, n, switch in (("one_replica", 1, interval),
                            ("two_replicas_switch_0.5ms", 2, 5e-4)):
        fleet = FleetManager(model, n, N_SLOTS, engine_kw=kw)
        try:
            for eng in fleet.engines:
                eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 2, timeout=600)
            idle_fleet(fleet)
            sys.setswitchinterval(switch)
            got, wall = fleet_run(fleet, reqs, record_placements(fleet))
        finally:
            sys.setswitchinterval(interval)
            fleet.close()
        n_tok = sum(len(t) for t in got)
        out[name] = {"replicas": n, "switch_interval_s": switch,
                     "tokens_per_s": n_tok / wall,
                     "vs_engine": n_tok / wall / engine_tps}
    return out


def fleet_migrate(torch, fleet, groups, g_outs):
    """A group's prefix moved off its owner: the owner serves prompt P
    (the group's prefix + a MIGRATE_TAIL tail) itself, as a prefix hit;
    then P goes through the fleet with affinity steering off and lands on
    the other replica (a tail the ring puts there), which fetches the
    prefix's pages from the owner (export, adopt) and must serve P's
    tokens bitwise equal to the owner's."""
    from container_engine_accelerators_tpu_torch.serving import router

    gen = torch.Generator().manual_seed(SEED + 6)
    prefix = np.asarray(groups[0][0][0][:FLEET_PREFIX])
    owner, depth = fleet.router.owner_of(prefix)
    assert owner is not None and depth == FLEET_PREFIX // PAGE, (owner, depth)
    while True:
        p = np.concatenate([prefix, torch_randint(gen, (MIGRATE_TAIL,))])
        if fleet.router.ring.lookup(
                router._token_key(p.astype(np.int32))) != owner:
            break
    idle_fleet(fleet)
    want = fleet.engines[owner].submit(p, FLEET_NEW, timeout=900)[0]
    s0 = fleet.snapshot()
    h0 = fleet._migrate_hist.state()
    fleet.router.affinity_enabled = False
    try:
        got = fleet.submit(p.astype(np.int32)[None], FLEET_NEW, 0.0,
                           timeout=900)[0]
    finally:
        fleet.router.affinity_enabled = True
    s1 = fleet.snapshot()
    moved = s1["fleet"]["kv_pages_migrated"] - s0["fleet"]["kv_pages_migrated"]
    assert s1["fleet"]["kv_migrations"] - s0["fleet"]["kv_migrations"] == 1
    assert moved == FLEET_PREFIX // PAGE, moved
    target = 1 - owner
    hit = (s1["engines"][target]["prefix_hit_tokens"]
           - s0["engines"][target]["prefix_hit_tokens"])
    assert hit >= FLEET_PREFIX, hit
    assert got == want, first_divergence(got, want)
    h1 = fleet._migrate_hist.state()
    return {"owner": owner, "target": target, "pages": moved,
            "bytes": (s1["fleet"]["kv_migrate_bytes"]
                      - s0["fleet"]["kv_migrate_bytes"]),
            "migrate_ms": (h1[1] - h0[1]) * 1e3,
            "migrate_ms_per_page": (h1[1] - h0[1]) / moved * 1e3,
            "target_prefix_hit_tokens": hit, "tokens_equal_owner": True}


def fleet_roles(torch, model, kw, reqs, outs):
    """requests() through a prefill:1,decode:1 fleet of the same engines:
    at least one prefill handoff (the prefill replica runs a long
    prompt's prefill and its pages move to the decode replica), tokens
    within the oracle rule."""
    from container_engine_accelerators_tpu_torch.serving.fleet import (
        FleetManager,
    )

    t0 = time.monotonic()
    fleet = FleetManager(model, FLEET_REPLICAS, N_SLOTS, engine_kw=kw,
                         roles=["prefill", "decode"])
    try:
        boot = time.monotonic() - t0
        got, wall = fleet_run(fleet, reqs)
        snap = fleet.snapshot()
    finally:
        fleet.close()
    f = snap["fleet"]
    assert f["prefill_handoffs"] >= 1 and f["kv_migrations"] >= 1, f
    assert f["prefill_handoff_failures"] == 0, f
    gap = fleet_gap(torch, model, False, reqs, got)
    return {"roles": ["prefill", "decode"], "boot_s": boot,
            "prefill_handoffs": f["prefill_handoffs"],
            "kv_migrations": f["kv_migrations"],
            "kv_pages_migrated": f["kv_pages_migrated"],
            "tokens_per_s": sum(len(t) for t in got) / wall,
            "tokens_equal_migrate_fleet": [a == b for a, b in zip(got, outs)],
            "max_gap_to_oracle_argmax": gap}


def compute_app_pids():
    """The pids nvidia-smi lists as compute applications on the card, with
    their memory."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return {int(line.split(",")[0]): line.split(",")[1].strip()
            for line in out.splitlines() if line.strip()}


def replica_bytes(torch, eng):
    """The bytes one in-process replica holds on the card, each storage
    once: its model's weights and buffers, the engine's int8 tree and
    dequantized prefill model where quantized, and its KV pool."""
    from torch.utils._pytree import tree_leaves

    held = {}

    def add(tensors, part):
        n = 0
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                st = t.untyped_storage()
                if st.data_ptr() not in held:
                    held[st.data_ptr()] = st.nbytes()
                    n += st.nbytes()
        parts[part] = n

    parts = {}
    for part, obj in (("model", eng._model),
                      ("dequantized", getattr(eng, "_deq", None))):
        if obj is not None:
            add([*obj.parameters(), *obj.buffers()], part)
    add(tree_leaves(getattr(eng, "_qparams", None)), "int8_tree")
    add(tree_leaves(eng._cache), "kv_pool")
    assert parts["kv_pool"] > 0 and parts["model"] > 0, parts
    return sum(held.values()), parts


def hold_workers_on_card(fleet, need):
    """Each worker's engine lives on the card and its process holds there
    at least what one in-process replica of the same kwargs holds
    (`need`: weights, int8 tree, KV pool), as each worker's handshake
    reports (RemoteEngine.device_report).  nvidia-smi must list each
    worker's pid where it maps this PID namespace (where it does not, it
    lists none of this process's own pids, this script's included)."""
    pids = fleet.worker_pids()
    reports = [e.device_report for e in fleet.engines]
    for r in reports:
        assert (r.get("device", "").startswith("cuda")
                and r["device_bytes"] >= need), (reports, need)
    apps = compute_app_pids()
    rec = {"worker_pids": pids, "worker_device_reports": reports,
           "replica_bytes": need, "compute_apps": apps}
    if os.getpid() in apps:
        assert all(p in apps for p in pids), (pids, apps)
        rec["worker_memory"] = [apps[p] for p in pids]
    else:
        rec["pids_unmapped"] = True
    return rec


def run_fleet_procs(torch, engine_tps, want_outs, gen, need):
    """fleet_procs_int8: a ProcessFleetManager over the port's
    demo_lm_factory (the server's model from seed 0 at CFG's width), 2
    worker processes on the card over Unix sockets, the int8 phase's
    engine kwargs.  Its tokens must equal fleet_inproc_int8's, each
    worker must hold the card (hold_workers_on_card, `need` the bytes
    an in-process int8 replica holds), worker 1 is SIGKILLed while its
    wave decodes: respawned within the supervisor's budget, its
    request re-routed, none failed; the relabelled /metrics carries
    engine="0" and "1"."""
    import signal

    from container_engine_accelerators_tpu_torch import server as SV
    from container_engine_accelerators_tpu_torch.serving.fleet import (
        ProcessFleetManager,
    )

    t_phase = time.monotonic()
    kw = fleet_engine_kw()
    t0 = time.monotonic()
    fleet = ProcessFleetManager(
        SV.WORKER_FACTORY, dict(CFG, device="cuda"), FLEET_REPLICAS,
        N_SLOTS, engine_kw=kw)
    spawn_s = time.monotonic() - t0
    rec = {"phase": "fleet_procs_int8", "transport": "unix",
           "spawn_s": spawn_s}
    try:
        for eng in fleet.engines:
            eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 2, timeout=600)
        rec.update(hold_workers_on_card(fleet, need))
        served, outs, g_outs, _ = fleet_serve(torch, fleet, engine_tps, gen)
        flat = outs + [t for g in g_outs for t in g]
        assert flat == want_outs, [first_divergence(a, b) for a, b in
                                   zip(flat, want_outs)]
        rec.update(served)
        rec["tokens_equal_inproc"] = True
        text = fleet.registry.render()
        assert 'engine="0"' in text and 'engine="1"' in text
        rec["metrics_engine_labels"] = ["0", "1"]
        # SIGKILL worker 1 while its wave's request decodes.
        pairs = wave_prompts(fleet, gen)
        s0 = fleet.snapshot()
        box = {}
        runner = threading.Thread(
            target=lambda: box.update(out=fleet_run(fleet, pairs[0])))
        runner.start()
        wait_for(lambda: fleet.engines[1].snapshot()["active_rows"] > 0,
                 "worker 1 decoding")
        victim = fleet.engines[1].pid
        os.kill(victim, signal.SIGKILL)
        t_kill = time.monotonic()
        runner.join(timeout=900)
        assert "out" in box, "a request failed across the kill"
        wait_for(lambda: (fleet.engines[1].pid not in (None, victim)
                          and not fleet.engines[1].crashed
                          and fleet.replica_states()[1] == "up"),
                 "worker 1 respawned", timeout=600)
        respawn_s = time.monotonic() - t_kill
        fleet_run(fleet, pairs[1])  # both replicas serve again
        s1 = fleet.snapshot()
        assert s1["replica_states"] == ["up", "up"], s1["replica_states"]
        assert s1["engines"][1]["proc_restarts"] == 1, s1["engines"][1]
        rerouted = s1["fleet"]["rerouted"] - s0["fleet"]["rerouted"]
        assert rerouted >= 1, rerouted
        rec["kill"] = {"victim_pid": victim,
                       "respawned_pid": fleet.engines[1].pid,
                       "respawn_s": respawn_s, "reroutes": rerouted,
                       "requests_completed": 4, "failed": 0}
    finally:
        fleet.close()
    rec["seconds"] = time.monotonic() - t_phase
    return rec


def run_server_fleet(torch, engine_tps, want_outs, gen):
    """server_fleet: the server booted from --fleet 2, then from
    --fleet-procs 2 (server_flags(), int8 at 16 slots): requests()
    POSTed at once give fleet_inproc_int8's tokens, /metrics carries
    engine="0" and "1", /tracez holds every response's trace with its
    router and replica spans, and the drain (the SIGTERM path) finishes
    two in-flight requests; the process fleet's workers exit 0."""
    t_phase = time.monotonic()
    reqs = requests(gen, torch)
    bodies = [{"prompt": [p.tolist()], "max_new": n} for p, n in reqs]
    rec = {"phase": "server_fleet"}
    for mode, flag in (("inproc", "--fleet"), ("procs", "--fleet-procs")):
        flags = server_flags() + [flag, str(FLEET_REPLICAS)]
        app, httpd, thread, port, boot_s = boot_server(flags)
        try:
            assert app.fleet is not None and app.engine is None
            placed = record_placements(app.fleet)
            outs, wall = in_order(
                [lambda b=b: http(port, "/generate", b) for b in bodies],
                [pkey(p) for p, _ in reqs], placed)
            for code, body, _, _ in outs:
                assert code == 200, (mode, code, body[:300])
            got = [json.loads(b)["tokens"][0] for _, b, _, _ in outs]
            assert got == want_outs, [first_divergence(a, b)
                                      for a, b in zip(got, want_outs)]
            m = scrape(port)
            labels = {lab for fam in m.values() for lab in fam}
            for i in range(FLEET_REPLICAS):
                assert any(f'engine="{i}"' in lab for lab in labels), i
            code, body, _, _ = http(port, "/tracez")
            tz = json.loads(body)
            ids = {r["trace_id"] for r in tz["recent"]}
            want_ids = [json.loads(b)["trace_id"] for _, b, _, _ in outs]
            assert code == 200 and set(want_ids) <= ids, (want_ids, ids)
            stages = sorted(k for k in tz["stages"] if k != "requests")
            assert "placement" in stages and "decode" in stages, stages
            pids = (app.fleet.worker_pids() if mode == "procs" else None)
            n_tok = sum(len(t) for t in got)
            sub = {"server_flags": flags, "boot_s": boot_s,
                   "tokens": n_tok, "wall_s": wall,
                   "tokens_per_s": n_tok / wall,
                   "vs_engine": n_tok / wall / engine_tps,
                   "request_latency_s": quantiles([s for *_, s in outs]),
                   "tokens_equal_fleet_inproc_int8": True,
                   "metrics_engine_labels": [str(i) for i in
                                             range(FLEET_REPLICAS)],
                   "tracez_stages": stages, "worker_pids": pids}
            sub.update(drain_check(app, httpd, thread, port, gen))
            if mode == "procs":
                codes = [r.engine._proc.returncode
                         for r in app.fleet.replicas]
                assert codes == [0] * FLEET_REPLICAS, codes
                sub["worker_exit_codes"] = codes
        finally:
            httpd.shutdown()
            httpd.server_close()
            app.close()
        rec[mode] = sub
    rec["seconds"] = time.monotonic() - t_phase
    return rec


def forward_ms_median(torch, fn, n=3):
    """The median of n timed calls of fn after one untimed, each fenced
    by a synchronize on the card (host wall, ms)."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return sorted(times)[n // 2]


def predict_images(torch, model, gen, size):
    """8 images (8, size, size, 3) that the served model labels in at
    least two ways, so that a server that reorders or mixes the images
    of a batch gives other labels.  With random weights the pooled ReLU
    features of every image share a large common part, and the head
    gives nearly every image one label (483 for all 24 at 224 on the
    card); so the head's bias is first centred on this pool's mean
    logits, in place in the served model, leaving each image's own part
    to choose its label.  The pool: noise with per-image scales and
    offsets, plain colours and smooth images.  One image of each label
    comes first.  Returns (images, distinct labels in the pool)."""
    import torch.nn.functional as F

    noise = (torch.randn((8, size, size, 3), generator=gen)
             * (1.0 + torch.arange(8.0)[:, None, None, None])
             + 2.0 * torch.randn((8, 1, 1, 3), generator=gen))
    colours = torch.randn((8, 1, 1, 3), generator=gen).expand(
        8, size, size, 3)
    smooth = F.interpolate(torch.randn((8, 3, 2, 2), generator=gen),
                           size=(size, size), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
    pool = torch.cat([colours, smooth, noise]).contiguous()
    with torch.inference_mode():
        x = pool.cuda()
        model.head_bias.sub_(model(x, train=False).mean(0))
        labels = model(x, train=False).argmax(-1).tolist()
    first = {}
    for i, label in enumerate(labels):
        first.setdefault(label, i)
    lead = sorted(first.values())
    pick = (lead + [i for i in range(len(labels)) if i not in lead])[:8]
    assert len(first) >= 2, (
        f"the model labels all {len(labels)} images {labels[0]}")
    return pool[pick].numpy(), len(first)


def run_server_predict(torch, gen):
    """server_predict: ResNet-50 at 224 behind /predict (--batch 8): 8
    single-image requests at once (twice: the first volley takes batch
    1's first use) and one batch of the 8, the labels, at least two
    distinct (the head centred on predict_images' pool), equal to the
    argmax of the served model's own eval forward on the same images at
    the same batch; that forward's time and the server's predict
    call's (no HTTP) are read beside the HTTP figures."""
    t_phase = time.monotonic()
    size = 224
    flags = ["--model", "resnet50", "--image-size", str(size), "--batch",
             "8", "--device", "cuda", "--port", "0"]
    app, httpd, thread, port, boot_s = boot_server(flags)
    try:
        images, pool_labels = predict_images(torch, app.model, gen, size)
        bodies = [images[i:i + 1].tobytes() for i in range(8)]
        _, wall_first = volley(port, bodies, "/predict")
        singles, wall_1 = volley(port, bodies, "/predict")
        code, body, _, batch_s = http(port, "/predict", images.tobytes())
        assert code == 200, (code, body)
        assert all(c == 200 for c, _, _, _ in singles), singles
        assert http(port, "/generate", {"prompt": [[1]]})[0] == 503
        model = app.model
        with torch.inference_mode():
            x = torch.from_numpy(images).cuda()
            want_batch = model(x, train=False).argmax(-1).tolist()
            want_single = [model(x[i:i + 1], train=False).argmax(-1).item()
                           for i in range(8)]
            forward_ms = {n: forward_ms_median(torch, lambda: model(
                x[:n], train=False)) for n in (1, 8)}
        # The server's predict call without HTTP (host conversion, the
        # copy to the card, the forward on the app's predict thread).
        call_ms = {n: forward_ms_median(torch, lambda: app._predict(
            images[:n])) for n in (1, 8)}
        got_single = [json.loads(b)["labels"][0] for _, b, _, _ in singles]
        got_batch = json.loads(body)["labels"]
        assert got_single == want_single, (got_single, want_single)
        assert got_batch == want_batch, (got_batch, want_batch)
        assert len(set(want_single)) >= 2 and len(set(want_batch)) >= 2, (
            want_single, want_batch)
        code = http(port, "/metrics")[0]
        assert code == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
    return {
        "phase": "server_predict", "server_flags": flags, "boot_s": boot_s,
        "images_per_s_single_requests": 8 / wall_1,
        "images_per_s_single_requests_first": 8 / wall_first,
        "images_per_s_batch_request": 8 / batch_s,
        "model_forward_ms": forward_ms,
        "predict_call_ms": call_ms,
        "request_latency_s": quantiles([s for _, _, _, s in singles]),
        "batch_request_s": batch_s,
        "labels": got_batch, "distinct_labels": len(set(got_batch)),
        "distinct_labels_in_pool": pool_labels,
        "seconds": time.monotonic() - t_phase,
    }


# -- phase 4e: dp-mesh serving and the NVML health layer -------------------
# mesh_serve: the contiguous bf16 engine sharded over a LocalMesh
# (mesh_devices), against the unsharded contiguous engine on
# requests().  GEN_SHARDED_NEW: the new tokens of the generate_sharded
# check over requests()' 8 prompts.
GEN_SHARDED_NEW = 32


def mesh_devices(torch):
    """mesh_serve's shards: every visible card, or the one card named
    twice (two shards on one card exercise the shard logic)."""
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n > 1 else ["cuda:0"] * 2


def mesh_counts(PA, QM, FA, reset=False):
    """The serving kernels' and flash's launch counters (the contiguous
    bf16 engine runs neither serving kernel; its prefill runs flash only
    where the model's attention resolves to it)."""
    fns = {"paged_attention": PA.paged_attention,
           "int8_weight_matmul": QM.int8_weight_matmul,
           "flash_attention_fwd": FA.flash_attention_fwd}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


def contiguous_run(torch, model, reqs, mesh, counts):
    """requests() through a bf16 contiguous engine (under `mesh`, or
    unsharded), after a warm-up request, with the launch counters set
    to 0 just before and read just after: (outs, wall s, launches, the
    per-shard device and cache bytes)."""
    from container_engine_accelerators_tpu_torch.serving import (
        ContinuousBatchingEngine,
    )

    eng = ContinuousBatchingEngine(
        model, N_SLOTS, paged=False, prefill_chunk=CHUNK, observe=False,
        device=model.device, mesh=mesh)
    try:
        eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 2, timeout=600)  # warm-up
        wait_idle(eng)
        counts(reset=True)
        t0 = time.monotonic()
        handles = [eng.submit_nowait(p, n) for p, n in reqs]
        outs = [h.wait(timeout=900)[0] for h in handles]
        wall = time.monotonic() - t0
        wait_idle(eng)
        launches = counts()
        shards = []
        for sh, cache in zip(eng._shards, eng._cache if mesh else []):
            shards.append({
                "device": str(sh.device), "rows": sh.hi - sh.lo,
                "cache_bytes": sum(t.numel() * t.element_size()
                                   for blk in cache for t in blk.values()),
                "on_device": all(t.device == sh.device
                                 for blk in cache for t in blk.values())})
    finally:
        eng.close()
    return outs, wall, launches, shards


def held_to_oracle(torch, model, prompts, got, want, what):
    """Greedy tokens equal `want`, or, where a row parts from it, off
    the oracle's argmax by at most TOP2_TOL along its own path.  Returns
    (first divergences, the largest gap)."""
    firsts, gaps = [], [0.0]
    for p, g, w in zip(prompts, got, want):
        firsts.append(first_divergence(g, w))
        if g != w:
            gaps.append(oracle_gap(torch, model, p, g, False, None, None))
    if max(gaps) > TOP2_TOL:
        raise AssertionError(f"{what}: token off the oracle's argmax by "
                             f"{max(gaps)} logits (> {TOP2_TOL})")
    return firsts, max(gaps)


def run_mesh_serve(torch, model, gen_reqs):
    """mesh_serve: the dp-mesh engine on LocalMesh(mesh_devices) with
    16 slots against the unsharded contiguous engine on requests()
    (equal greedy tokens, or the oracle rule where they part);
    generate_sharded over the same 8 prompts against generate_prefill;
    the server booted with --mesh dp (every visible card: a one-card
    mesh) answering /generate within the oracle rule.  Prints tokens/s
    against the unsharded engine, each shard's device and cache bytes,
    and the kernels launched (set to 0 before each run, read after)."""
    from container_engine_accelerators_tpu_torch.models import generate as G
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as FA,
    )
    from container_engine_accelerators_tpu_torch.ops import (
        paged_attention as PA,
    )
    from container_engine_accelerators_tpu_torch.ops import quant_matmul as QM
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        LocalMesh,
    )

    t_phase = time.monotonic()
    reqs = requests(gen_reqs, torch)
    prompts = [p for p, _ in reqs]
    n_tok = sum(n for _, n in reqs)

    def counts(reset=False):
        return mesh_counts(PA, QM, FA, reset)

    mesh = LocalMesh(mesh_devices(torch))
    base_outs, base_wall, base_l, _ = contiguous_run(
        torch, model, reqs, None, counts)
    outs, wall, launches, shards = contiguous_run(
        torch, model, reqs, mesh, counts)
    assert len(shards) == mesh.size and all(s["on_device"]
                                            for s in shards), shards
    assert [s["rows"] for s in shards] == [N_SLOTS // mesh.size] * mesh.size
    assert launches["paged_attention"] == launches[
        "int8_weight_matmul"] == 0, launches
    assert launches == base_l, (launches, base_l)
    firsts, gap = held_to_oracle(torch, model, prompts, outs, base_outs,
                                 "mesh_serve engine")

    # generate_sharded against generate_prefill on the same batch.
    b = len(reqs)
    p_max = max(len(p) for p in prompts)
    padded = np.zeros((b, p_max), np.int64)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    plens = np.array([len(p) for p in prompts], np.int64)
    counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want = G.generate_prefill(model, padded, plens, GEN_SHARDED_NEW, 0.0,
                              torch.Generator(device="cuda")).cpu()
    prefill_s = time.monotonic() - t0
    gen_l = {"generate_prefill": counts()}
    counts(reset=True)
    models = G.models_on(model, mesh.devices)
    t0 = time.monotonic()
    got = G.generate_sharded(model, padded, GEN_SHARDED_NEW, mesh,
                             prompt_len=plens, models=models).cpu()
    sharded_s = time.monotonic() - t0
    gen_l["generate_sharded"] = counts()
    assert got.shape == want.shape == (b, GEN_SHARDED_NEW), got.shape
    g_firsts, g_gap = held_to_oracle(
        torch, model, prompts, got.tolist(), want.tolist(),
        "generate_sharded")

    # The server with --mesh dp: a mesh of every visible card.
    app, httpd, thread, port, boot_s = boot_server(
        server_flags() + ["--mesh", "dp"])
    try:
        assert app.mesh is not None and app.engine._mesh is app.mesh
        assert app.mesh.size == torch.cuda.device_count(), app.mesh
        assert not app.engine.quant and not app.engine._paged
        counts(reset=True)
        served, s_wall = volley(port, [{"prompt": [p.tolist()],
                                        "max_new": n} for p, n in reqs[:2]])
        wait_idle(app.engine)
        server_l = counts()
        toks = []
        for code, body, _, _ in served:
            assert code == 200, (code, body[:300])
            toks.append(json.loads(body)["tokens"][0])
        s_firsts, s_gap = held_to_oracle(
            torch, app.model, prompts[:2], toks, [
                G.generate_prefill(app.model, p[None], len(p), n, 0.0,
                                   torch.Generator(device="cuda"))[0]
                .tolist() for p, n in reqs[:2]], "server --mesh dp")
        server = {"boot_s": boot_s, "mesh_devices": app.mesh.size,
                  "slots": app.engine.n_slots, "requests": 2,
                  "wall_s": s_wall, "first_divergence_vs_oracle": s_firsts,
                  "max_gap_to_oracle_argmax": s_gap, "launches": server_l}
    finally:
        app.drain_for_shutdown(httpd, timeout=60)
        httpd.server_close()
        app.close()
    return {
        "phase": "mesh_serve", "shards": shards,
        "requests": b, "tokens": n_tok,
        "tokens_per_s": n_tok / wall, "unsharded_tokens_per_s":
            n_tok / base_wall,
        "vs_unsharded": base_wall / wall,
        "first_divergence_vs_unsharded": firsts,
        "max_gap_to_oracle_argmax": gap, "top2_tolerance": TOP2_TOL,
        "launches": launches, "unsharded_launches": base_l,
        "generate_sharded": {
            "rows": b, "new": GEN_SHARDED_NEW, "sharded_s": sharded_s,
            "prefill_s": prefill_s,
            "first_divergence_vs_prefill": g_firsts,
            "max_gap_to_oracle_argmax": g_gap, "launches": gen_l},
        "server": server,
        "allocated_bytes": torch.cuda.memory_allocated(),
        "seconds": time.monotonic() - t_phase,
    }


def run_health_nvml(torch):
    """health_nvml: the NVML seam held against torch on the card (device
    count, UUID, total memory, used memory rising by a 1 GiB allocation),
    an Xid event set whose wait(500) times out on a healthy card within
    its bound, the nvml-fields vendor layer's reads and state, and the
    server booted with --health-source auto staying ready and answering.
    Where NVML refuses event registration the phase holds that refusal
    instead: the source raises naming it, and the server with
    --health-source auto fails to load."""
    from container_engine_accelerators_tpu_torch import server as SV
    from container_engine_accelerators_tpu_torch.native import nvml as N
    from container_engine_accelerators_tpu_torch.plugin import health as H

    t_phase = time.monotonic()
    nv = N.Nvml()
    n = nv.device_count
    assert n == torch.cuda.device_count(), (n, torch.cuda.device_count())
    uuids = [nv.uuid(i) for i in range(n)]
    mine = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    # The NVIDIA driver may redact every UUID it reports.
    redacted = set(uuids) == {"GPU-REDACTED"}
    assert mine in uuids or redacted, (mine, uuids)
    idx = uuids.index(mine) if mine in uuids else 0
    total = nv.memory_total_bytes(idx)
    reserved = nv.memory_reserved_bytes(idx)
    assert total - reserved == torch.cuda.mem_get_info(0)[1], (total,
                                                               reserved)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0 = nv.memory_used_bytes(idx)
    block = torch.ones(1 << 30, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    used1 = nv.memory_used_bytes(idx)
    del block
    torch.cuda.empty_cache()
    assert used1 - used0 >= 1 << 30, (used0, used1)
    rec = {"phase": "health_nvml", "devices": n,
           "names": nv.device_names(), "uuid_matches_torch": mine in uuids,
           "uuid_redacted_by_driver": redacted, "total_bytes": total,
           "reserved_bytes": reserved,
           "used_rise_bytes": used1 - used0,
           "duty_cycle_pct": nv.average_duty_cycle(idx),
           "clocks_event_reasons": nv.clocks_event_reasons(idx),
           "nvlink_states": nv.nvlink_states(idx)}
    es = nv.event_set_create()
    try:
        nv.register_event(es, idx)
        refusal = None
    except N.NvmlError as e:
        if e.code != N.NVML_ERROR_NOT_SUPPORTED:
            raise
        refusal = str(e)
    if refusal is None:
        t0 = time.monotonic()
        ev = nv.wait_for_event(es, 500)
        waited = time.monotonic() - t0
        assert ev is None, ev  # a healthy card
        assert 0.45 <= waited <= 1.5, waited
        rec["event_wait_500_s"] = waited
    nv.event_set_free(es)
    rec["event_registration"] = refusal or "accepted"
    flags = server_flags() + ["--health-source", "auto"]
    if refusal is not None:
        with_refusal = None
        try:
            H.make_event_source(nv, "auto")
        except N.NvmlError as e:
            with_refusal = str(e)
        assert with_refusal and "refused" in with_refusal, with_refusal
        app = SV.ServingApp(SV.parse_args(flags))
        try:
            try:
                app.load_model()
                loaded = True
            except N.NvmlError:
                loaded = False
            assert not loaded and not app.ready.is_set()
        finally:
            app.close()
        rec["server_refused_to_load"] = True
        rec["seconds"] = time.monotonic() - t_phase
        return rec
    src = H.make_event_source(nv, "nvml-fields")
    src.POLL_INTERVAL_S = 0.0
    try:
        events = [src.wait(100) for _ in range(3)]
        assert events == [None] * 3, events  # a healthy card
        assert src.sdk_state() == "active", src._metric_state
        rec["vendor_state"] = {"aggregate": src.sdk_state(),
                               **src._metric_state}
    finally:
        src.close()
    app, httpd, thread, port, boot_s = boot_server(flags)
    try:
        watch = app._health_watch
        assert watch is not None and isinstance(
            app._health_source, H.NvmlFieldsEventSource)
        time.sleep(2.5)  # two of the watch's 1 s waits and polls
        assert app.draining() == "" and not watch.unhealthy
        code, body, _, _ = http(port, "/healthz")
        assert (code, body) == (200, b"ok"), (code, body)
        code, body, _, secs = http(port, "/generate", {
            "prompt": [[1, 2, 3, 4, 5, 6, 7, 8]], "max_new": 8})
        assert code == 200, (code, body[:300])
        assert len(json.loads(body)["tokens"][0]) == 8
        rec["server"] = {"boot_s": boot_s, "generate_s": secs,
                         "source": type(app._health_source).__name__,
                         "vendor_state": app._health_source.sdk_state()}
    finally:
        app.drain_for_shutdown(httpd, timeout=60)
        httpd.server_close()
        app.close()
    nv.shutdown()
    rec["seconds"] = time.monotonic() - t_phase
    return rec


# -- phase 4f: the device-plugin daemon --------------------------------------
DP_ALLOCATES = 20  # Allocate round trips timed
DP_SCRAPES = 10    # /metrics GETs timed
DP_INTERVAL_MS = 250  # the metrics server's collection interval
DP_WAIT_S = 30.0


def kernel_wrappers(PA, QM, FA, FX, FL, FC):
    """Every kernel wrapper, by the prefix of its kernels-record names."""
    return {"paged_attention": PA.paged_attention,
            "int8_weight_matmul": QM.int8_weight_matmul,
            "flash_attention_fwd": FA.flash_attention_fwd,
            "flash_attention_bwd": FA.flash_attention_bwd,
            "fused_xent_fwd": FX.xent_fwd, "fused_xent_bwd": FX.xent_bwd,
            "fused_matmul_stats": FL.fused_matmul,
            "affine_relu_matmul_stats": FL.fused_affine_matmul,
            "conv3x3": FC.conv3x3}


def short_socket_root():
    """A fresh directory for unix sockets whose paths stay well inside
    the 107 bytes a socket path may hold: under the temporary directory
    where that is short enough, else under /tmp."""
    import tempfile

    base = tempfile.gettempdir()
    if len(base) > 40:
        base = "/tmp"
    return tempfile.mkdtemp(prefix="dp", dir=base)


def gauge(samples, name, **labels):
    """The value of `name` whose labels include `labels`, or None."""
    for rendered, value in samples.get(name, {}).items():
        if all(f'{k}="{v}"' in rendered for k, v in labels.items()):
            return value
    return None


def run_device_plugin(torch, wrappers):
    """device_plugin: the port's daemon (device_plugin.start, what `python
    -m ...device_plugin` runs) over the machine's real /dev and NVML, on
    sockets under a short directory, with a fake kubelet and a fake
    pod-resources service that gives one pod the card: discovery finds
    exactly NVML's cards by minor number, the daemon registers, the
    first ListAndWatch lists them Healthy, Allocate returns the card's
    node with nvidiactl and nvidia-uvm, a synthetic Unhealthy event put
    on the manager's health queue reaches the stream, and /metrics,
    scraped while a bf16 matmul loop runs on the card, shows a duty cycle
    above 0 (node and container gauges) and used memory up by a 1 GiB
    allocation.  Times registration, the Allocate round trip, health to
    stream and a scrape.  Every kernel wrapper's count is set to 0 before
    and read after: the daemon launches none."""
    from concurrent import futures

    import grpc

    from container_engine_accelerators_tpu_torch import device_plugin as DP
    from container_engine_accelerators_tpu_torch.native import nvml as N
    from container_engine_accelerators_tpu_torch.plugin import health as H
    from container_engine_accelerators_tpu_torch.plugin import manager as M
    from container_engine_accelerators_tpu_torch.plugin.api import (
        HEALTHY, UNHEALTHY, deviceplugin_pb2 as dp_pb2, grpc_api,
        podresources_pb2 as pr_pb2,
    )
    from container_engine_accelerators_tpu_torch.serving import observe

    t_phase = time.monotonic()
    saved = {k: w.launches for k, w in wrappers.items()}
    for w in wrappers.values():
        w.launches = 0
    nv = N.Nvml()
    names = nv.device_names()
    uuids = [nv.uuid(i) for i in range(nv.device_count)]
    mine = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    card = names[uuids.index(mine)] if mine in uuids else names[0]
    es = nv.event_set_create()
    try:
        nv.register_event(es, names.index(card))
        health_on = True
    except N.NvmlError as e:
        if e.code != N.NVML_ERROR_NOT_SUPPORTED:
            raise
        health_on = False
    nv.event_set_free(es)
    dev = DP.DEV_DIRECTORY
    M.GPUManager(dev, nvml=nv).check_device_paths()  # raises, never waits
    root = short_socket_root()
    kubelet_sock = os.path.join(root, "kubelet.sock")
    pr_sock = os.path.join(root, "pr.sock")
    registered = []

    class Kubelet(grpc_api.RegistrationServicer):
        def Register(self, request, context):
            registered.append((time.monotonic(), request))
            return dp_pb2.Empty()

    class Pods(grpc_api.PodResourcesListerServicer):
        def List(self, request, context):
            return pr_pb2.ListPodResourcesResponse(pod_resources=[
                pr_pb2.PodResources(name="smoke-0", namespace="default",
                                    containers=[pr_pb2.ContainerResources(
                                        name="main", devices=[
                                            pr_pb2.ContainerDevices(
                                                resource_name=M.RESOURCE_NAME,
                                                device_ids=[card])])])])

    fakes = []
    for add, servicer, sock in (
            (grpc_api.add_registration_servicer, Kubelet(), kubelet_sock),
            (grpc_api.add_pod_resources_servicer, Pods(), pr_sock)):
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        add(server, servicer)
        server.add_insecure_port(f"unix:{sock}")
        server.start()
        fakes.append(server)
    flags = ["--plugin-directory", root,
             "--gpu-config", os.path.join(root, "gpu_config.json"),
             "--enable-container-gpu-metrics", "--gpu-metrics-port", "0",
             "--gpu-metrics-collection-interval", str(DP_INTERVAL_MS),
             "--pod-resources-socket", pr_sock]
    if health_on:
        flags.append("--enable-health-monitoring")
    stop_loop = threading.Event()
    daemon = serve = loop = None
    try:
        t0 = time.monotonic()
        daemon = DP.start(DP.parse_args(flags), nv)
        start_s = time.monotonic() - t0
        ngm = daemon.manager
        assert sorted(ngm.devices) == sorted(names), (ngm.devices, names)
        assert all(os.path.exists(os.path.join(dev, n)) for n in names)
        t0 = time.monotonic()
        serve = threading.Thread(target=daemon.serve, daemon=True)
        serve.start()
        wait_for(lambda: registered, "the daemon's registration", DP_WAIT_S)
        registration_ms = (registered[0][0] - t0) * 1e3
        request = registered[0][1]
        assert (request.resource_name, request.version) == (
            "nvidia.com/gpu", grpc_api.DEVICE_PLUGIN_VERSION), request
        assert len(ngm.socket) < 108 and request.endpoint == os.path.basename(
            ngm.socket), (ngm.socket, request.endpoint)
        with grpc.insecure_channel(f"unix:{ngm.socket}") as ch:
            stub = grpc_api.DevicePluginStub(ch)
            stream = stub.ListAndWatch(dp_pb2.Empty())
            first = {d.ID: d.health for d in next(stream).devices}
            assert first == {n: HEALTHY for n in names}, first
            req = dp_pb2.AllocateRequest(container_requests=[
                dp_pb2.ContainerAllocateRequest(devicesIDs=[card])])
            alloc_ms = []
            for _ in range(DP_ALLOCATES):
                t0 = time.monotonic()
                resp = stub.Allocate(req)
                alloc_ms.append((time.monotonic() - t0) * 1e3)
            paths = [d.host_path for d in resp.container_responses[0].devices]
            assert paths[0] == os.path.join(dev, card), paths
            assert {os.path.join(dev, n) for n in ("nvidiactl", "nvidia-uvm")
                    } <= set(paths), paths
            envs = dict(resp.container_responses[0].envs)
            assert envs["TPU_CHIPS_PER_PROCESS_BOUNDS"] == "1,1,1", envs
            t0 = time.monotonic()
            ngm.health.put(dp_pb2.Device(ID=card, health=UNHEALTHY))
            second = {d.ID: d.health for d in next(stream).devices}
            health_ms = (time.monotonic() - t0) * 1e3
            assert second[card] == UNHEALTHY, second
            stream.cancel()
        url_port = daemon.metrics.port

        def scraped():
            code, body, _, secs = http(url_port, "/metrics", timeout=30)
            assert code == 200, code
            return observe.parse_text(body.decode()), secs

        node = dict(make="nvidia", accelerator_id=card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)

        def matmuls():
            while not stop_loop.is_set():
                for _ in range(8):
                    a @ a
                torch.cuda.synchronize()

        loop = threading.Thread(target=matmuls, daemon=True)
        loop.start()
        # The loop's own memory is taken before the baseline read.
        time.sleep(4 * DP_INTERVAL_MS / 1e3)
        used0 = gauge(scraped()[0], "memory_used_node_gpu", **node)
        block = torch.ones(1 << 30, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        deadline = time.monotonic() + DP_WAIT_S
        while True:
            samples, _ = scraped()
            duty = gauge(samples, "duty_cycle_node_gpu", **node)
            used1 = gauge(samples, "memory_used_node_gpu", **node)
            pod_duty = gauge(samples, "duty_cycle", pod="smoke-0", **node)
            if (duty and pod_duty and used1 is not None
                    and used1 - used0 >= 1 << 30):
                break
            assert time.monotonic() < deadline, (duty, pod_duty, used0, used1)
            time.sleep(DP_INTERVAL_MS / 1e3)
        scrape_ms = [scraped()[1] * 1e3 for _ in range(DP_SCRAPES)]
        # The checker's vendor layer first polls after its first wait.
        deadline = time.monotonic() + 2 * H.WAIT_TIMEOUT_MS / 1e3
        while (daemon.health is not None and time.monotonic() < deadline
               and daemon.health.sdk_state() == "absent"):
            time.sleep(0.1)
        time.sleep(2 * DP_INTERVAL_MS / 1e3)  # a collection pass after it
        samples, _ = scraped()
        stop_loop.set()
        loop.join(timeout=30)
        del block, a
        torch.cuda.empty_cache()
        states = {layer: state for layer in ("metrics", "health")
                  for state in ("active", "unparseable", "empty", "absent")
                  if gauge(samples, "gpu_sdk_source_state", layer=layer,
                           state=state) == 1.0}
    finally:
        stop_loop.set()
        if loop is not None:
            loop.join(timeout=30)
        if daemon is not None:
            daemon.stop()
        if serve is not None:
            serve.join(timeout=10)
        for server in fakes:
            server.stop(grace=0)
        shutil.rmtree(root, ignore_errors=True)
    assert serve is not None and not serve.is_alive()
    launches = {k: w.launches for k, w in wrappers.items()}
    for k, w in wrappers.items():
        w.launches = saved[k]
    assert not any(launches.values()), launches
    nv.shutdown()
    return {
        "phase": "device_plugin", "cards": names, "device": card,
        "dev_nodes": sorted(n for n in os.listdir(dev)
                            if n.startswith("nvidia")),
        "health_monitoring": health_on, "start_s": start_s,
        "registration_ms": registration_ms,
        "allocate_ms_p50": quantiles(alloc_ms)["p50"],
        "allocate_ms_max": max(alloc_ms),
        "health_to_stream_ms": health_ms,
        "scrape_ms_p50": quantiles(scrape_ms)["p50"],
        "scrape_ms_max": max(scrape_ms),
        "duty_cycle_pct": duty, "container_duty_cycle_pct": pod_duty,
        "memory_used_rise_bytes": used1 - used0,
        "sdk_source_state": states, "allocate_paths": paths,
        "launches": launches, "seconds": time.monotonic() - t_phase,
    }


# -- phases 5-6: LM training -----------------------------------------------
TRAIN = dict(vocab=32000, dim=1024, depth=8, heads=8, seq_len=2048,
             batch=8, learning_rate=3e-4)
TRAIN_STEPS = 20
# Kernel vs plain tolerances.  Flash: the largest relative error of one
# tile of FLASH_TILE rows (queries of O and dQ, keys of dK and dV; one
# warp's rows in the kernels) over (rows, head dim), ||got - want|| /
# ||want||, so that late rows, whose values are ~10x smaller than the
# first rows', are held as tightly as early ones.  A tile and not a row:
# single rows can be ill-conditioned (dQ of query 0 is 0 exactly, and
# of query 1 a difference of two near-equal terms; dK of a late key can
# be ~1e-5 of the mean), where the kernel's D from the bf16 O, as FA2
# takes it, differs from the plain version's f32 sum by far more than
# the row itself.  Each side rounds its result to bf16 once (~2**-9
# relative) and the kernel also rounds P (and dS) to bf16 as MMA
# operands.  The limit, under 1%, makes a 1% error on the late rows
# fail, which the check shows on the kernel's own output.
FLASH_TILE = 16
FLASH_TILE_REL = 2.0 ** -7
FLASH_PLANTED = 1.01  # the planted fault: rows past 512 scaled by this
# Fused xent: the loss relative to max|loss| (f32 sums over C classes in
# another order); the gradient element by element relative to itself
# (softmax terms span many decades): f32 exp(x - lse) against the
# autograd of logsumexp, or one bf16 rounding on each side.
XENT_REL = 1e-5
XENT_GRAD_REL = {"f32": 1e-4, "bf16": 2.0 ** -7}
# One step of the kernel path (flash, fused loss) against the plain path
# (dense attention, log_softmax loss) from one set of weights: the two
# round bf16 activations at other points through 8 layers, so each
# relative error may reach a few bf16 roundings (2**-8 each); a wrong
# term in a kernel moves a gradient by O(1).
TRAIN_LOSS_REL = 2.0 ** -9  # half a bf16 ulp of the mean loss
TRAIN_GRAD_REL = 2.0 ** -5  # per parameter: |g - g_plain| / |g_plain|


def finite(t) -> bool:
    return bool(t.float().isfinite().all())


def _tile_rel(got, want):
    """Relative errors of (b, s, h, d) tensors per tile of FLASH_TILE
    rows of one (batch, head), as a (b, s / FLASH_TILE, h) tensor."""
    b, s, h, d = want.shape
    sq = ((got.float() - want.float()).square(), want.float().square())
    err, norm = (x.view(b, s // FLASH_TILE, FLASH_TILE, h, d).sum((2, 4))
                 for x in sq)
    return (err / norm).sqrt()


def _flash_err(got, want, what):
    """Readings of one flash output: max abs error, the largest per-tile
    relative error and the first row of its tile, and the smallest and
    largest per-tile relative error of a planted fault (the kernel's own
    output with the rows past row 512, or past the middle of a shorter
    seq, scaled by FLASH_PLANTED); with the reasons the check fails, if
    any: past FLASH_TILE_REL, or blind to the planted fault."""
    assert finite(got), f"non-finite {what}"
    tiles = _tile_rel(got, want)
    worst = int(tiles.flatten().argmax().item())
    first = min(512, got.shape[1] // 2)
    planted = got.clone()
    planted[:, first:] *= FLASH_PLANTED
    caught = _tile_rel(planted, want)[:, first // FLASH_TILE:]
    r = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
         "tile_rel_err": tiles.max().item(),
         "worst_tile_row": worst // tiles.shape[2] % tiles.shape[1]
         * FLASH_TILE,
         "planted_tile_rel": [caught.min().item(), caught.max().item()]}
    faults = []
    if r["tile_rel_err"] > FLASH_TILE_REL:
        faults.append(f"{what}: tile rel err {r['tile_rel_err']}")
    if r["planted_tile_rel"][1] <= FLASH_TILE_REL:
        faults.append(f"{what}: a {FLASH_PLANTED}x fault past row {first} "
                      "passes")
    return r, faults


def _plain_by_slices(torch, FA, q, k, v, dout):
    """The plain version and its autograd a (batch, FLASH_SLICE_HEADS
    heads) slice at a time: (out, (dq, dk, dv)) in q's dtype, as the
    kernels give them.  Each head's attention is independent of the others'."""
    b, s, h, _ = q.shape
    out = torch.empty((b, s, h, v.shape[-1]), dtype=q.dtype, device=q.device)
    grads = [torch.empty(x.shape, dtype=x.dtype, device=q.device)
             for x in (q, k, v)]
    for i in range(b):
        for j in range(0, h, FLASH_SLICE_HEADS):
            at = (slice(i, i + 1), slice(None), slice(j, j + FLASH_SLICE_HEADS))
            leaves = [x[at].detach().clone().requires_grad_(True)
                      for x in (q, k, v)]
            ref = FA.causal_attention_plain(*leaves)
            out[at] = ref.detach()
            for g, got in zip(grads, torch.autograd.grad(ref, leaves,
                                                         dout[at])):
                g[at] = got
            del leaves, ref
    return out, grads


def flash_case(torch, FA, gen, b, s, h, d, dv=None):
    """The kernels at one shape against the plain version and its
    autograd, q / k / v the strided views of one fused qkv projection as
    the main path gives them; the backward run twice and held bitwise
    equal.  dv: v's head dim where it is narrower than d (latent
    attention): q and k drawn apart and v the strided second half of a
    (b, s, h, 2 dv) [k_nope | v] projection, as MLAttention passes it.
    Where the plain version's f32 scores would pass FLASH_DENSE_BYTES it
    runs a slice at a time.  Returns the tensors (for the timings; `ref`
    and `leaves` None when sliced) and the readings; raises on a fault."""
    bf16 = torch.bfloat16
    if dv is None:
        qkv = torch.randn((b, s, 3, h, d), device="cuda", generator=gen).to(
            bf16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k = (torch.randn((b, s, h, d), device="cuda", generator=gen).to(
            bf16) for _ in range(2))
        v = torch.randn((b, s, h, 2 * dv), device="cuda",
                        generator=gen).to(bf16)[..., dv:]
    dout = torch.randn((b, s, h, v.shape[-1]), device="cuda",
                       generator=gen).to(bf16)
    out, lse = FA.flash_attention_fwd(q, k, v)
    grads = FA.flash_attention_bwd(q, k, v, out, lse, dout)
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout)
    if b * h * s * s * 4 > FLASH_DENSE_BYTES:
        ref, ref_grads = _plain_by_slices(torch, FA, q, k, v, dout)
        leaves = None
    else:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        ref = FA.causal_attention_plain(*leaves)
        ref_grads = torch.autograd.grad(ref, leaves, dout, retain_graph=True)
    torch.cuda.synchronize()
    fwd, faults = _flash_err(out, ref, "out")
    bwd = {}
    for got, want, what in zip(grads, ref_grads, ("dq", "dk", "dv")):
        bwd[what], f = _flash_err(got, want, what)
        faults += f
    if not all(torch.equal(a, c) for a, c in zip(grads, again)):
        faults.append("two backward runs differ bitwise")
    if faults:
        shape = (b, s, h, d) if dv is None else (b, s, h, d, dv)
        raise AssertionError(
            f"flash at {shape}: {faults} (limit {FLASH_TILE_REL}); "
            f"readings {fwd} {bwd}")
    tensors = dict(q=q, k=k, v=v, dout=dout, out=out, lse=lse,
                   ref=None if leaves is None else ref, leaves=leaves)
    return tensors, fwd, bwd


FLASH_EXTRA_SHAPES = [  # (b, s, h, d): held, not timed
    (2, 128, 8, 128),   # the smallest length: one 128-row tile
    (2, 192, 8, 128),   # ragged for the 128-row tile: a half last tile
    (1, 8192, 8, 128),  # inside the reference's splash window
    (2, 192, 2, 256),   # d 256, s ragged: a last key stage wholly past s
    (2, 192, 4, 160),   # the d-256 instance at d 160: a tile atom past d
    (2, 192, 8, 40),    # the d-64 instance at d 40
]
# The timed shapes at lm_main's (b 8, s 2048, dim 1024): heads 8 (head
# dim 128, the 20-step run), 16, 32 and 4 (lm_main --heads: d 64, 32 on
# the d-64 instance, 256); and the d-128 instance at a ragged d 96.
FLASH_HEADS = (8, 16, 32, 4)
FLASH_RAGGED = (8, 1024, 8, 96)
# Latent attention's flash instance at moonlight.train8k's shape: b 8,
# s 8192, Moonlight-16B-A3B's 16 heads, q . k over 128 + 64 = 192
# columns and v over 128 (port_bench/configs/moonlight-16b-a3b.json);
# MLA_LAYER is the attention's part of that configuration.
FLASH_MLA = (8, 8192, 16, 192, 128)
MLA_LAYER = {"hidden_size": 2048, "num_attention_heads": 16,
             "kv_lora_rank": 512, "qk_nope_head_dim": 128,
             "qk_rope_head_dim": 64, "v_head_dim": 128,
             "rms_norm_eps": 1e-5, "rope_theta": 50000}
# The plain version's f32 scores (b, h, s, s) past this many bytes run a
# (batch, FLASH_SLICE_HEADS heads) slice at a time (FLASH_MLA's would
# take 34 GB, and softmax and autograd as much again).
FLASH_DENSE_BYTES = 8e9
FLASH_SLICE_HEADS = 4
# H100 SXM: 16 MUFU results (ex2) an SM a clock at the 1.83 GHz of the
# data sheet's tensor peak: the third bound of the flash kernels, which
# at d 32 outweighs the products (PERF.md).
EXP2_PER_S = 16 * 132 * 1.83e9


def flash_bound(b, s, h, d, backward, dv=None):
    """(bound ms, what bounds it) of the forward or backward at one shape,
    q and k of head dim d and v of dv (d if None): bytes (q / k / v / o
    in, o / lse out; or q / k / v / o / dO and lse in, dq / dk / dv out),
    bf16 tensor-core operations over the pairs the mask keeps (the
    forward's Q K^T at d and P V at dv; the backward's Q K^T, dQ and dK
    at d and dO V^T and dV at dv), or the exponentials (one a kept pair:
    P in the forward, P recomputed once in the backward)."""
    dv = d if dv is None else dv
    rows = b * s * h
    pairs = b * h * s * (s + 1) / 2
    if backward:
        ops = 2.0 * pairs * (3 * d + 2 * dv)
        nbytes = 2 * rows * (4 * d + 4 * dv) + b * h * s * 4
    else:
        ops = 2.0 * pairs * (d + dv)
        nbytes = 2 * rows * (2 * d + 2 * dv) + b * h * s * 4
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "bf16 products": ops / PEAK_OPS["bf16"] * 1e3,
             "exponentials": pairs / EXP2_PER_S * 1e3}
    term = max(times, key=times.get)
    return (times[term], "bytes" if term == "bytes" else "operations",
            {"bound_term": term, "bound_terms_ms": times})


def check_flash(torch, FA, timer, gen):
    """Flash forward and backward against the plain version and its
    autograd: at the LM's shapes (b 8, s 2048, bf16) at every head count
    of FLASH_HEADS and at FLASH_RAGGED, each with the times of the
    kernels, the plain version and SDPA; and at FLASH_EXTRA_SHAPES.
    Every backward is run twice and held bitwise equal, and ptxas's
    registers and spills of each instance ride on the records."""
    from container_engine_accelerators_tpu_torch.ops import _build

    b, s, dim = TRAIN["batch"], TRAIN["seq_len"], TRAIN["dim"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ptxas = _build.PTXAS.get("flash_attention", {}).get("kernels", {})
    records = []
    shapes = [(b, s, h, dim // h) for h in FLASH_HEADS] + [FLASH_RAGGED]
    for shape in shapes:
        b_, s_, h, d = shape
        t, fwd, bwd = flash_case(torch, FA, gen, *shape)
        q, k, v, dout, out, lse = (t[x] for x in (
            "q", "k", "v", "dout", "out", "lse"))
        ref, leaves = t["ref"], t["leaves"]
        lq, lk, lv = (x.detach().transpose(1, 2).contiguous().requires_grad_(
            True) for x in (q, k, v))
        ldo = dout.transpose(1, 2).contiguous()
        lib_out = sdpa(lq, lk, lv, is_causal=True)
        with torch.no_grad():
            fwd_t = {
                "ms": timer.ms(lambda: FA.flash_attention_fwd(q, k, v)),
                "plain_ms": timer.ms(
                    lambda: FA.causal_attention_plain(q, k, v), iters=10),
                "library_ms": timer.ms(
                    lambda: sdpa(lq, lk, lv, is_causal=True)),
            }
        bwd_t = {
            "ms": timer.ms(
                lambda: FA.flash_attention_bwd(q, k, v, out, lse, dout)),
            "plain_ms": timer.ms(lambda: torch.autograd.grad(
                ref, leaves, dout, retain_graph=True), iters=10),
            "library_ms": timer.ms(lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), ldo, retain_graph=True)),
        }
        lib_fwd_bwd = timer.ms(lambda: torch.autograd.grad(
            sdpa(lq, lk, lv, is_causal=True), (lq, lk, lv), ldo), iters=20)
        fwd_b, fwd_by, fwd_terms = flash_bound(b_, s_, h, d, False)
        bwd_b, bwd_by, bwd_terms = flash_bound(b_, s_, h, d, True)
        inst = FA.head_dim_instance(d)
        common = {"shape_bshd": list(shape), "instance_d": inst,
                  "qkv": "strided views of (b, s, 3, h, d)",
                  "planted_fault": f"x{FLASH_PLANTED} on rows past 512: "
                  "the check fails",
                  "ptxas_regs_spill_stores_loads": {
                      name: r for name, r in ptxas.items()
                      if f"ILi{inst}E" in name}}
        suffix = "" if shape[2:] == (TRAIN["heads"], dim // TRAIN[
            "heads"]) and shape[:2] == (b, s) else f"_d{d}"
        if suffix and shape[:2] == (b, s):  # the 20-step run is at 8 heads
            common["launches_from"] = (
                f"lm_main --heads {h}: a warm-up step and 3 logged steps")
        records += [
            {"name": "flash_attention_fwd" + suffix, **fwd,
             "tolerance_tile_rel": FLASH_TILE_REL, "tile_rows": FLASH_TILE,
             "tolerance_reason": "the kernel rounds P to bf16 for P V, the "
             "plain version keeps f32; both round O once",
             "bound_ms": fwd_b, "bound_by": fwd_by, **fwd_terms, **fwd_t,
             **common},
            {"name": "flash_attention_bwd" + suffix,
             "max_abs_err": max(r["max_abs_err"] for r in bwd.values()),
             "grads": bwd, "two_runs_bitwise_equal": True,
             "tolerance_tile_rel": FLASH_TILE_REL, "tile_rows": FLASH_TILE,
             "tolerance_reason": "the kernel rounds P and dS to bf16 as MMA "
             "operands and takes D from the bf16 O; the plain autograd keeps "
             "f32 and rounds each gradient once",
             "bound_ms": bwd_b, "bound_by": bwd_by, **bwd_terms, **bwd_t,
             "library_fwd_bwd_ms": lib_fwd_bwd, **common},
        ]
        del t, q, k, v, dout, out, lse, ref, leaves, lq, lk, lv, ldo, lib_out
        torch.cuda.empty_cache()
    extra = []
    for shape in FLASH_EXTRA_SHAPES:
        t, fwd, bwd = flash_case(torch, FA, gen, *shape)
        del t
        torch.cuda.empty_cache()
        extra.append({
            "shape_bshd": list(shape), "out_tile_rel": fwd["tile_rel_err"],
            "grads_tile_rel": {n: r["tile_rel_err"] for n, r in bwd.items()},
            "planted_tile_rel_max": max(
                r["planted_tile_rel"][1] for r in (fwd, *bwd.values())),
            "two_runs_bitwise_equal": True})
    records[0]["other_shapes"] = extra
    return records


def check_flash_mla(torch, FA, timer, gen):
    """The (192, 128) instance at FLASH_MLA, v the strided kv[..., 128:]
    of a 256-wide kv: held as flash_case holds every shape (per 16-row
    tile, the planted fault, two backward runs bitwise equal), timed
    beside the plain version (one slice's time times the slices) and
    SDPA (any backend but the dense math one), its bound at the true
    widths.  Launches: one MLAttention layer (models/mla_moe_lm.py, the
    cell's call site) forward and backward at the same shape, the
    instance's counters reset to 0 just before; exactly one of each.
    Returns the forward's and the backward's records."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from container_engine_accelerators_tpu_torch.models import (
        mla_moe_lm as M,
    )
    from container_engine_accelerators_tpu_torch.ops import _build

    b, s, h, d, dv = FLASH_MLA
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t, fwd, bwd = flash_case(torch, FA, gen, b, s, h, d, dv)
    q, k, v, dout, out, lse = (t[x] for x in (
        "q", "k", "v", "dout", "out", "lse"))
    del t
    torch.cuda.empty_cache()
    slices = b * h // FLASH_SLICE_HEADS
    at = (slice(0, 1), slice(None), slice(0, FLASH_SLICE_HEADS))
    sl = [x[at].detach().clone().requires_grad_(True) for x in (q, k, v)]
    sdo = dout[at].contiguous()
    sref = FA.causal_attention_plain(*sl)
    with torch.no_grad():
        fwd_t = {"ms": timer.ms(lambda: FA.flash_attention_fwd(q, k, v)),
                 "plain_ms": slices * timer.ms(
                     lambda: FA.causal_attention_plain(*sl), iters=10)}
    bwd_t = {"ms": timer.ms(
                 lambda: FA.flash_attention_bwd(q, k, v, out, lse, dout)),
             "plain_ms": slices * timer.ms(lambda: torch.autograd.grad(
                 sref, sl, sdo, retain_graph=True), iters=10)}
    del sl, sdo, sref
    lq, lk, lv = (x.detach().transpose(1, 2).contiguous().requires_grad_(
        True) for x in (q, k, v))
    ldo = dout.transpose(1, 2).contiguous()
    library = {}
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            lib_out = sdpa(lq, lk, lv, is_causal=True)
            with torch.no_grad():
                fwd_t["library_ms"] = timer.ms(
                    lambda: sdpa(lq, lk, lv, is_causal=True))
            bwd_t["library_ms"] = timer.ms(lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), ldo, retain_graph=True))
            library["library_fwd_bwd_ms"] = timer.ms(
                lambda: torch.autograd.grad(
                    sdpa(lq, lk, lv, is_causal=True), (lq, lk, lv), ldo),
                iters=20)
            del lib_out
    except RuntimeError as e:  # no fused SDPA backend takes the pair
        fwd_t["library_ms"] = bwd_t["library_ms"] = None
        library["library_refused"] = str(e)[:300]
    del lq, lk, lv, ldo, q, k, v, dout, out, lse
    torch.cuda.empty_cache()

    layer = M.MLAttention(MLA_LAYER, torch.bfloat16, "cuda", torch.float32,
                          FA.flash_causal_attention)
    with torch.no_grad():
        for p in layer.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn((b, s, MLA_LAYER["hidden_size"]), device="cuda",
                    generator=gen).to(torch.bfloat16).requires_grad_(True)
    counters = (FA.flash_attention_fwd.by_instance,
                FA.flash_attention_bwd.by_instance)
    for c in counters:
        c[FA.WIDE_PAIR] = 0
    y = layer(x)
    y.backward(torch.randn(y.shape, device="cuda", generator=gen).to(
        y.dtype))
    torch.cuda.synchronize()
    launches = [c[FA.WIDE_PAIR] for c in counters]
    if launches != [1, 1]:
        raise AssertionError(
            f"one MLAttention forward and backward at {FLASH_MLA} launched "
            f"the (192, 128) instance {launches} times, not once each")
    del layer, x, y
    torch.cuda.empty_cache()

    fwd_b, fwd_by, fwd_terms = flash_bound(b, s, h, d, False, dv)
    bwd_b, bwd_by, bwd_terms = flash_bound(b, s, h, d, True, dv)
    ptxas = _build.PTXAS.get("flash_attention", {}).get("kernels", {})
    common = {
        "shape_bshd": [b, s, h, d], "v_head_dim": dv,
        "instance": list(FA.flash_instance(d, dv)),
        "qkv": "q and k (b, s, h, 192) apart, v the strided "
        "kv[..., 128:] of a (b, s, h, 256) kv",
        "planted_fault": f"x{FLASH_PLANTED} on rows past 512: the check "
        "fails",
        "plain_ms_from": f"one (batch, {FLASH_SLICE_HEADS}-head) slice x "
        f"{slices}",
        "launches_from": "one MLAttention layer forward and backward at "
        "the same shape, by_instance[(192, 128)]",
        "ptxas_regs_spill_stores_loads": {
            name: r for name, r in ptxas.items()
            if "wide_qk" in name or "flash_bwd_deltaILi128E" in name}}
    return [
        {"name": "flash_attention_fwd_mla", **fwd,
         "tolerance_tile_rel": FLASH_TILE_REL, "tile_rows": FLASH_TILE,
         "tolerance_reason": "the kernel rounds P to bf16 for P V, the "
         "plain version keeps f32; both round O once",
         "bound_ms": fwd_b, "bound_by": fwd_by, **fwd_terms, **fwd_t,
         "launches": launches[0], **common},
        {"name": "flash_attention_bwd_mla",
         "max_abs_err": max(r["max_abs_err"] for r in bwd.values()),
         "grads": bwd, "two_runs_bitwise_equal": True,
         "tolerance_tile_rel": FLASH_TILE_REL, "tile_rows": FLASH_TILE,
         "tolerance_reason": "the kernel rounds P and dS to bf16 as MMA "
         "operands and takes D from the bf16 O; the plain autograd keeps "
         "f32 and rounds each gradient once",
         "bound_ms": bwd_b, "bound_by": bwd_by, **bwd_terms, **bwd_t,
         **library, "launches": launches[1], **common},
    ]


# The MLA flash records' source and the JAX kernel they replace.
FLASH_MLA_SRC = ("flash_attention.cu", "flash_attention.py:112")


def kernel_line(rec, launches, source, replaces):
    """One entry of the `kernels` record: a kernel's check record, its
    launches on the main path (at least one), its CUDA source and the JAX
    kernel it replaces (files under the two packages' csrc/ and ops/)."""
    if launches < 1:
        raise AssertionError(f"{rec['name']} never ran on the main path")
    line = {
        "name": rec["name"], "route": "cuda",
        "source": "container_engine_accelerators_tpu_torch/csrc/" + source,
        "replaces": "container_engine_accelerators_tpu/ops/" + replaces,
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
    }
    if "launches_from" in rec:
        line["launches_from"] = rec["launches_from"]
    return line


def check_xent(torch, FX, timer, gen):
    """Fused xent forward and backward at the LM head's shape (16384 x
    32000 f32 logits, the mean's gradient 1 / rows per row) against the
    plain version and its autograd; times of the kernels, the plain
    version and F.cross_entropy."""
    def draw(rows, c, dtype):
        logits = torch.randn((rows, c), device="cuda", generator=gen)
        labels = torch.randint(0, c, (rows,), device="cuda", generator=gen,
                               dtype=torch.int32)
        g = torch.full((rows,), 1.0 / rows, device="cuda")
        return logits.mul_(3.0).to(dtype), labels, g

    def errs(logits, labels, g, what):
        """[(abs, rel) of the loss, (abs, rel) of the gradient]."""
        loss, lse = FX.xent_fwd(logits, labels)
        grad = FX.xent_bwd(logits, labels, lse, g)
        x = logits.detach().requires_grad_(True)
        ref = FX.softmax_xent_plain(x, labels)
        (ref_grad,) = torch.autograd.grad(ref, x, g)
        assert finite(loss) and finite(grad), what
        e_loss = (loss - ref).abs()
        e_grad = (grad.float() - ref_grad.float()).abs()
        out = [(e_loss.max().item(),
                e_loss.max().item() / ref.abs().max().item()),
               (e_grad.max().item(), (e_grad / ref_grad.float().abs()
                                      .clamp_min(1e-30)).max().item())]
        grad_rel = XENT_GRAD_REL["bf16" if logits.dtype == torch.bfloat16
                                 else "f32"]
        if out[0][1] > XENT_REL or out[1][1] > grad_rel:
            raise AssertionError(
                f"xent {what}: loss rel {out[0][1]} (limit {XENT_REL}), "
                f"grad rel {out[1][1]} (limit {grad_rel})")
        return out

    # The variants the path does not take (bf16 logits; C % 4 != 0, read
    # one element at a time), at a small row count.
    variants = {}
    for c in (1000, TRAIN["vocab"]):
        for dtype in (torch.float32, torch.bfloat16):
            what = f"{str(dtype)[6:]} C={c}"
            variants[what] = errs(*draw(64, c, dtype), what)
    rows, c = TRAIN["batch"] * TRAIN["seq_len"], TRAIN["vocab"]
    logits, labels, g = draw(rows, c, torch.float32)
    main = errs(logits, labels, g, "f32 at the LM head")
    _, lse = FX.xent_fwd(logits, labels)
    x = logits.detach().requires_grad_(True)
    ref = FX.softmax_xent_plain(x, labels)
    ce = torch.nn.functional.cross_entropy
    lab64 = labels.long()
    with torch.no_grad():
        fwd_t = {
            "ms": timer.ms(lambda: FX.xent_fwd(logits, labels)),
            "plain_ms": timer.ms(
                lambda: FX.softmax_xent_plain(logits, labels), iters=20),
            "library_ms": timer.ms(
                lambda: ce(logits, lab64, reduction="none")),
        }
    lib_out = ce(x, lab64, reduction="none")
    bwd_t = {
        "ms": timer.ms(lambda: FX.xent_bwd(logits, labels, lse, g)),
        "plain_ms": timer.ms(lambda: torch.autograd.grad(
            ref, x, g, retain_graph=True), iters=20),
        "library_ms": timer.ms(lambda: torch.autograd.grad(
            lib_out, x, g, retain_graph=True)),
    }
    lib_fwd_bwd = timer.ms(lambda: torch.autograd.grad(
        ce(x, lab64, reduction="none"), x, g), iters=20)
    n = rows * c
    fwd_b, fwd_by = bound_ms(n * 4 + rows * 4 * 3, 3.0 * n, "f32")
    bwd_b, bwd_by = bound_ms(2 * n * 4 + rows * 4 * 3, 3.0 * n, "f32")
    common = {"shape": [rows, c], "logits": "f32"}
    return [
        {"name": "fused_xent_fwd", "max_abs_err": main[0][0],
         "rel_err": main[0][1], "tolerance_rel": XENT_REL,
         "tolerance_reason": "f32 sums over C classes in another order; "
         "relative to max|loss|",
         "variants_rel_err": {k: v[0][1] for k, v in variants.items()},
         "bound_ms": fwd_b, "bound_by": fwd_by, **fwd_t, **common},
        {"name": "fused_xent_bwd", "max_abs_err": main[1][0],
         "rel_err": main[1][1], "tolerance_rel": XENT_GRAD_REL,
         "tolerance_reason": "element by element: f32 exp(x - lse) vs the "
         "autograd of logsumexp, or one bf16 rounding on each side",
         "variants_rel_err": {k: v[1][1] for k, v in variants.items()},
         "bound_ms": bwd_b, "bound_by": bwd_by, **bwd_t,
         "library_fwd_bwd_ms": lib_fwd_bwd, **common},
    ]


# -- phases 7-8: ResNet-50 training ----------------------------------------
# The fused-matmul kernel's shapes at batch 256 (M, K, N), each with its
# launches per training step; the 3x3 conv's stride-1 shapes (N, H, W, C).
MATMUL_STATS_SHAPES = [
    ((802816, 64, 64), 1), ((802816, 256, 64), 2), ((802816, 256, 128), 1),
    ((200704, 512, 128), 3), ((200704, 512, 256), 1),
    ((50176, 1024, 256), 5), ((50176, 1024, 512), 1),
    ((12544, 2048, 512), 2),
]
AFFINE_SHAPES = [
    ((802816, 64, 256), 3), ((200704, 128, 512), 4),
    ((50176, 256, 1024), 6), ((12544, 512, 2048), 3),
]
CONV3_SHAPES = [(256, 56, 56, 64), (256, 28, 28, 128), (256, 14, 14, 256),
                (256, 7, 7, 512)]
# Ragged shapes, held but not timed: M not a multiple of the 128-row tile,
# K and N not multiples of the 64-channel k-step or the column tile; for
# the conv, tiles of whole images (7 x 7) and of rows that do not fill
# the tile (9 x 11), a partial 64-channel chunk (C 24) and column tile
# (C4 40), with relu(shift) > 0 so that a halo pixel fed through the
# prologue would show.
MATMUL_EDGE_SHAPES = [(1000, 72, 200), (1000, 64, 64), (130, 2048, 8)]
CONV3_EDGE_SHAPES = [((2, 7, 7, 24), 40), ((3, 9, 11, 24), 40)]
# Kernel vs plain: y and the data gradient (the kernels' own outputs) per
# tile of VISION_TILE rows of one column, ||got - want|| / ||want|| within
# 2**-7 (each side rounds an f32 sum taken in its own order to bf16 once,
# so an element may differ by one bf16 ulp, 2**-8 to 2**-7 of itself; a
# 1% error on a column fails); the statistics and the weight gradient,
# f32 sums in another order, by the norm of the difference over the norm
# within 1e-4; the autograd's dx, dscale and dshift within 2**-7 the same
# way (the ReLU mask and a second bf16 rounding of dx follow the kernel,
# and after the mask a tile of 16 rows can hold a single ill-conditioned
# element, so these are held as whole tensors).
VISION_TILE = 16
VISION_TILE_REL = 2.0 ** -7
VISION_SUM_REL = 1e-4
VISION_DAFFINE_REL = 2.0 ** -7
VISION_PLANTED = 1.01  # the planted fault: one output column scaled


def _col_tile_rel(got, want):
    """Relative errors of (rows, cols) tensors per tile of VISION_TILE
    rows of one column, as a (rows / VISION_TILE, cols) tensor."""
    cols = want.shape[-1]
    pad = -want.shape[0] % VISION_TILE  # a ragged last tile: zero rows
    sq = ((got.float() - want.float()).square(), want.float().square())
    err, norm = (_pad_rows(x, pad).reshape(-1, VISION_TILE, cols)
                 .sum(1) for x in sq)
    return (err / norm.clamp_min(1e-30)).sqrt()


def _pad_rows(x, pad):
    """x (rows, cols) with `pad` zero rows appended."""
    if pad == 0:
        return x
    out = x.new_zeros((x.shape[0] + pad, x.shape[1]))
    out[:x.shape[0]] = x
    return out


def _vision_err(got, want, what):
    """(readings, faults) of one tile-checked output: the largest
    per-tile relative error, and for the planted fault (column 1 of the
    kernel's output scaled in f32) the largest per-tile relative error,
    which must fail the check, and the share of that column's tiles
    that fail it."""
    assert finite(got), f"non-finite {what}"
    got2 = got.reshape(-1, got.shape[-1])
    want2 = want.reshape(-1, want.shape[-1])
    tiles = _col_tile_rel(got2, want2)
    planted = got2.float()
    planted[:, 1] *= VISION_PLANTED
    caught = _col_tile_rel(planted, want2)[:, 1]
    r = {"max_abs_err": (got2.float() - want2.float()).abs().max().item(),
         "tile_rel_err": tiles.max().item(),
         "planted_tile_rel_max": caught.max().item(),
         "planted_tiles_failing": (caught > VISION_TILE_REL).float().mean()
         .item()}
    faults = []
    if r["tile_rel_err"] > VISION_TILE_REL:
        faults.append(f"{what}: tile rel err {r['tile_rel_err']}")
    if r["planted_tile_rel_max"] <= VISION_TILE_REL:
        faults.append(f"{what}: a {VISION_PLANTED}x fault on a column "
                      "passes")
    return r, faults


def _norm_rel(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def _bitwise(torch, first, second):
    """Whether two launches' outputs (tuples of tensors) agree bit for
    bit: each compared as the integers of its bytes."""
    as_int = {2: torch.int16, 4: torch.int32}
    return all(x.shape == y.shape and torch.equal(
        x.contiguous().view(as_int[x.element_size()]),
        y.contiguous().view(as_int[y.element_size()]))
        for x, y in zip(first, second))


def _matmul_case(torch, FL, gen, m, k, n, affine, name):
    """Operands of one fused-matmul shape and the kernel's launch, held
    against the plain version and against a second launch bit for bit:
    (a, b, sc, sh, launch, readings, faults)."""
    a = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
    b = (torch.randn((k, n), device="cuda", generator=gen)
         / math.sqrt(k)).to(torch.bfloat16)
    sc = sh = None
    if affine:
        sc = torch.rand((k,), device="cuda", generator=gen) + 0.5
        sh = torch.randn((k,), device="cuda", generator=gen) * 0.5
    if affine:
        def launch():
            return FL.fused_affine_matmul(a, sc, sh, b)
    else:
        def launch():
            return FL.fused_matmul(a, b)
    y, s, ss = launch()
    ry, rs, rss = FL.fused_matmul_plain(a, b, sc, sh)
    torch.cuda.synchronize()
    r, faults = _vision_err(y, ry, f"{name} {m}x{k}x{n} y")
    r["s_rel"], r["ss_rel"] = _norm_rel(s, rs), _norm_rel(ss, rss)
    for key in ("s_rel", "ss_rel"):
        if not (r[key] <= VISION_SUM_REL):
            faults.append(f"{name} {m}x{k}x{n}: {key} {r[key]}")
    r["bitwise_equal"] = _bitwise(torch, (y, s, ss), launch())
    if not r["bitwise_equal"]:
        faults.append(f"{name} {m}x{k}x{n}: two launches differ")
    return a, b, sc, sh, launch, r, faults


def check_fused_matmul(torch, FL, timer, gen):
    """The fused-matmul kernel at every ResNet-50 shape of both variants
    against its plain version and against a second launch (bitwise), and
    at ragged shapes (MATMUL_EDGE_SHAPES, held, not timed); times per
    training step (each shape's time times its launches a step) of the
    kernel, the plain version and torch.matmul on the same bf16 operands
    (y alone)."""
    recs = []
    faults = []
    for name, shapes, affine in (
        ("fused_matmul_stats", MATMUL_STATS_SHAPES, False),
        ("affine_relu_matmul_stats", AFFINE_SHAPES, True),
    ):
        per_shape = []
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        work = [0.0, 0.0]  # bytes and operations of one step's launches
        for (m, k, n), per_step in shapes:
            a, b, sc, sh, launch, r, f = _matmul_case(
                torch, FL, gen, m, k, n, affine, name)
            faults += f
            # Each input byte read once, each output byte written once.
            nbytes = 2 * (m * k + k * n + m * n) + 8 * n + (8 * k if affine
                                                            else 0)
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 2.0 * m * n * k,
                                                    "bf16")
            work[0] += per_step * nbytes
            work[1] += per_step * 2.0 * m * n * k
            r["ms"] = timer.ms(launch, iters=20)
            r["plain_ms"] = timer.ms(
                lambda: FL.fused_matmul_plain(a, b, sc, sh), iters=5)
            r["library_ms"] = timer.ms(lambda: torch.matmul(a, b),
                                       iters=20)
            for key in tot:
                tot[key] += per_step * r[key]
            per_shape.append({"mkn": [m, k, n], "per_step": per_step, **r})
            del a, b
        edges = []
        for m, k, n in MATMUL_EDGE_SHAPES:
            r, f = _matmul_case(torch, FL, gen, m, k, n, affine, name)[5:]
            faults += f
            edges.append({"mkn": [m, k, n], **r})
        worst = max(per_shape + edges, key=lambda x: x["tile_rel_err"])
        b_ms, b_by = bound_ms(*work, "bf16")
        recs.append({
            "bound_ms": b_ms, "bound_by": b_by,
            "name": name, "shapes": per_shape, "edge_shapes": edges,
            "max_abs_err": max(x["max_abs_err"] for x in per_shape + edges),
            "tile_rel_err": worst["tile_rel_err"],
            "tolerance_tile_rel": VISION_TILE_REL,
            "tolerance_stats_rel": VISION_SUM_REL,
            "tolerance_reason": "y: each side rounds its f32 sum to bf16 "
            "once (one ulp is 2**-8 of an element); stats: f32 sums in "
            "another order",
            "times": "per training step: the sum over its launches; the "
            "bound that of one step's launches together",
            **tot,
        })
    return recs, faults


def _conv_case(torch, FC, x, w9, args, what, stats=True):
    """One conv launch held against the plain version and against a
    second launch bit for bit: (readings, faults)."""
    def launch():
        return FC.conv3x3(x, w9, *args, stats=stats)

    y, s, ss = launch()
    ry, rs, rss = FC.conv3x3_plain(x, w9, *args)
    torch.cuda.synchronize()
    r, faults = _vision_err(y, ry, f"conv3x3 {what} y")
    outs = (y, s, ss) if stats else (y,)
    if stats:
        r["s_rel"], r["ss_rel"] = _norm_rel(s, rs), _norm_rel(ss, rss)
        for key in ("s_rel", "ss_rel"):
            if not (r[key] <= VISION_SUM_REL):
                faults.append(f"conv3x3 {what}: {key} {r[key]}")
    r["bitwise_equal"] = _bitwise(torch, outs, launch())
    if not r["bitwise_equal"]:
        faults.append(f"conv3x3 {what}: two launches differ")
    return r, faults


def check_conv3x3_edges(torch, FC, gen):
    """The conv kernel at CONV3_EDGE_SHAPES (held, not timed): forward
    without and with the prologue (shift drawn so relu(shift) > 0), and
    the data gradient.  (readings, faults)."""
    recs, faults = [], []
    for (n, h, w, c), c4 in CONV3_EDGE_SHAPES:
        tag = f"{n}x{h}x{w}x{c}->{c4}"
        x = torch.randn((n, h, w, c), device="cuda", generator=gen).to(
            torch.bfloat16)
        w9 = (torch.randn((9, c, c4), device="cuda", generator=gen)
              / (3 * math.sqrt(c))).to(torch.bfloat16)
        sc = torch.rand((c,), device="cuda", generator=gen) + 0.5
        sh = torch.rand((c,), device="cuda", generator=gen) * 0.5 + 0.25
        g = torch.randn((n, h, w, c4), device="cuda", generator=gen).to(
            torch.bfloat16)
        rec = {"nhwc": [n, h, w, c], "c4": c4}
        for pro, xx, ww, args, stats in (
            ("plain_x", x, w9, (None, None), True),
            ("prologue", x, w9, (sc, sh), True),
            ("data_gradient", g, FC.rot180_t(w9), (None, None), False),
        ):
            rec[pro], f = _conv_case(torch, FC, xx, ww, args,
                                     f"{tag} {pro}", stats)
            faults += f
        recs.append(rec)
    return recs, faults


def check_conv3x3(torch, FC, timer, gen):
    """The 3x3 conv kernel at ResNet-50's four stride-1 shapes (and the
    ragged CONV3_EDGE_SHAPES, untimed): forward without and with the
    prologue against the plain version and a second launch, and the
    backward through autograd (dx, dscale, dshift, dw) against the same
    autograd Function on the plain version; times of the forward and the
    data gradient beside the plain version and cuDNN (channels_last
    F.conv2d, y alone)."""
    conv2d = torch.nn.functional.conv2d
    fwd_shapes, bwd_shapes, faults = [], [], []
    op_launches = [0, 0]  # through conv3x3_bn_stats: forward, backward
    for n, h, w, c in CONV3_SHAPES:
        tag = f"{n}x{h}x{w}x{c}"
        m = n * h * w
        x = torch.randn((n, h, w, c), device="cuda", generator=gen).to(
            torch.bfloat16)
        wt = torch.randn((3, 3, c, c), device="cuda", generator=gen) / (
            3 * math.sqrt(c))
        w9 = wt.reshape(9, c, c).to(torch.bfloat16)
        sc = torch.rand((c,), device="cuda", generator=gen) + 0.5
        sh = torch.randn((c,), device="cuda", generator=gen) * 0.5
        rec = {"nhwc": [n, h, w, c]}
        for pro, args in (("plain_x", (None, None)), ("prologue", (sc, sh))):
            rec[pro], f = _conv_case(torch, FC, x, w9, args, f"{tag} {pro}")
            faults += f
        # Backward: random cotangents for y and, at the model's 1 / rows
        # scale, for the statistics.
        g = torch.randn((n, h, w, c), device="cuda", generator=gen).to(
            torch.bfloat16)
        ds = torch.randn((c,), device="cuda", generator=gen) / m
        dss = torch.randn((c,), device="cuda", generator=gen) / m

        def grads():
            """Gradients through the op's entry point, and the kernel
            launches of its forward and of its backward."""
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (x, sc, sh, wt)]
            c0 = FC.conv3x3.launches
            out = FC.conv3x3_bn_stats(*leaves)
            c1 = FC.conv3x3.launches
            got = torch.autograd.grad(out, leaves, (g, ds, dss))
            return got, (c1 - c0, FC.conv3x3.launches - c1)

        # The data-gradient kernel's own output, tile by tile.
        w_rot = FC.rot180_t(w9)
        bw, f = _conv_case(torch, FC, g, w_rot, (None, None),
                           f"{tag} data gradient", stats=False)
        faults += f
        got, n_got = grads()
        with plain_vision_kernels(None, FC):
            want, n_want = grads()
        torch.cuda.synchronize()
        if n_got != (1, 1) or n_want != (0, 0):
            faults.append(f"conv3x3 {tag}: launches {n_got} (kernel path), "
                          f"{n_want} (plain path)")
        op_launches[0] += n_got[0]
        op_launches[1] += n_got[1]
        for i, key in enumerate(("dx_rel", "dscale_rel", "dshift_rel",
                                 "dw_rel")):
            bw[key] = _norm_rel(got[i], want[i])
            lim = VISION_SUM_REL if key == "dw_rel" else VISION_DAFFINE_REL
            if not (bw[key] <= lim):
                faults.append(f"conv3x3 {tag}: {key} {bw[key]}")
        del got, want
        flops = 2.0 * m * 9 * c * c
        nbytes = 2 * (2 * m * c + 9 * c * c)
        rec["bytes_ops"] = [nbytes + 16 * c, flops]
        bw["bytes_ops"] = [nbytes, flops]
        for r in (rec, bw):
            r["bound_ms"], r["bound_by"] = bound_ms(*r["bytes_ops"], "bf16")
        g_cl = g.permute(0, 3, 1, 2)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = w9.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        wr_cl = w_rot.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        rec["ms"] = timer.ms(lambda: FC.conv3x3(x, w9, sc, sh), iters=20)
        rec["ms_no_prologue"] = timer.ms(lambda: FC.conv3x3(x, w9),
                                         iters=20)
        rec["plain_ms"] = timer.ms(
            lambda: FC.conv3x3_plain(x, w9, sc, sh), iters=5)
        rec["library_ms"] = timer.ms(
            lambda: conv2d(x_cl, w_cl, padding=1), iters=20)
        bw["ms"] = timer.ms(
            lambda: FC.conv3x3(g, w_rot, stats=False), iters=20)
        bw["plain_ms"] = timer.ms(
            lambda: FC.conv3x3_plain(g, w_rot), iters=5)
        bw["library_ms"] = timer.ms(
            lambda: conv2d(g_cl, wr_cl, padding=1), iters=20)
        fwd_shapes.append(rec)
        bwd_shapes.append({"nhwc": [n, h, w, c], **bw})
        del x, g
    edges, f = check_conv3x3_edges(torch, FC, gen)
    faults += f
    recs = []
    for name, shapes, what, launches, edge_errs in (
        ("conv3x3_bn_stats_fwd", fwd_shapes, "forward with the prologue",
         op_launches[0], [e[k] for e in edges
                          for k in ("plain_x", "prologue")]),
        ("conv3x3_bn_stats_dgrad", bwd_shapes, "data gradient",
         op_launches[1], [e["data_gradient"] for e in edges]),
    ):
        errs = [s.get("prologue", s) for s in shapes] + edge_errs
        rec = {"name": name, "shapes": shapes, "what": what,
               "edge_shapes": edges,
               "launches": launches,
               "launches_from": "this op phase: conv3x3_bn_stats forward "
               "and backward once at each shape (no model path of the "
               "reference or the port runs this kernel)",
               "max_abs_err": max(e["max_abs_err"] for e in errs),
               "tile_rel_err": max(e["tile_rel_err"] for e in errs),
               "tolerance_tile_rel": VISION_TILE_REL,
               "times": "the sum over the four shapes, one call each; the "
               "bound that of the four calls together"}
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            sum(s["bytes_ops"][0] for s in shapes),
            sum(s["bytes_ops"][1] for s in shapes), "bf16")
        for key in ("ms", "plain_ms", "library_ms"):
            rec[key] = sum(s[key] for s in shapes)
        recs.append(rec)
    return recs, faults


class plain_vision_kernels:
    """Within the block, the vision kernels' autograd Functions run their
    plain versions on the card (the plain path of the parity checks); FL
    or FC may be None to leave that module alone."""

    def __init__(self, FL, FC):
        self.FL, self.FC = FL, FC

    def __enter__(self):
        if self.FL is not None:
            self.saved_fl = self.FL._forward
            self.FL._forward = self.FL.fused_matmul_plain
        if self.FC is not None:
            self.saved_fc = self.FC._conv
            plain = self.FC.conv3x3_plain
            self.FC._conv = lambda x, w9, sc, sh, stats=True: plain(
                x, w9, sc, sh)
        return self

    def __exit__(self, *exc):
        if self.FL is not None:
            self.FL._forward = self.saved_fl
        if self.FC is not None:
            self.FC._conv = self.saved_fc
        return False


VISION = dict(model_name="resnet50", image_size=224, num_classes=1000,
              learning_rate=0.1, loss_impl="xla",
              model_kwargs=dict(stem="s2d", conv1x1="conv", norm_impl="fused",
                                block_impl="fused_pallas", remat="none"))
VISION_BATCH = 256
VISION_STEPS = 20
# One step of the kernel path against the plain path (the same autograd
# Functions with the plain versions in place of the kernels) from one set
# of weights and one batch.  The loss within half a bf16 ulp and the new
# running statistics within 1e-3 (norm of the difference over the norm).
# The whole step's parameter gradients cannot be held to a fixed bound:
# at this depth in bf16 they move by a median of ~50% when one input
# pixel moves by 0.01 (read on the card while writing this check), as the
# kernel's one-ulp roundings move them.  So each fused block is replayed
# alone on the input and output gradient it saw, kernel against plain,
# and every gradient there is held to 2**-5 (norm of the difference over
# the norm); the whole step's median gradient error is held to twice the
# median that moving one pixel (VISION_PIXEL) causes on the plain path.
VISION_LOSS_REL = 2.0 ** -9
VISION_GRAD_REL = 2.0 ** -5
VISION_STATS_REL = 1e-3
VISION_PIXEL = 0.01
# ResNet-50's forward at 224 x 224, as bench.py counts it: 4.09 GFLOP an
# image, a training step 3x the forward.
RESNET50_FWD_FLOP = 4.09e9


def _vision_counts(FL, reset=False):
    fns = {"fused_matmul_stats": FL.fused_matmul,
           "affine_relu_matmul_stats": FL.fused_affine_matmul}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


def _grad_rel(model_a, model_b):
    """Per parameter, ||grad_a - grad_b|| / ||grad_b||."""
    return {name: _norm_rel(pa.grad, pb.grad) for (name, pa), pb in zip(
        model_a.named_parameters(), model_b.parameters())}


def _median(values):
    return sorted(values)[len(values) // 2]


def replay_blocks(torch, FL, model, snapshot, captured):
    """Each fused block of `model`, reset to `snapshot` (the weights the
    kernel-path step started from), run alone on the input and output
    gradient that block saw in that step, once through the kernels and
    once through the plain versions: the relative error of its output,
    its input's gradient and every parameter's gradient."""
    model.load_state_dict(snapshot)
    worst = {}
    for i, (x, g) in sorted(captured.items()):
        blk = model.blocks[i]
        runs = []
        for plain in (False, True):
            for prm in blk.parameters():
                prm.grad = None
            xi = x.detach().clone().requires_grad_(True)
            if plain:
                with plain_vision_kernels(FL, None):
                    out = blk(xi, train=True)
                    out.backward(g)
            else:
                out = blk(xi, train=True)
                out.backward(g)
            runs.append([out.detach(), xi.grad] + [
                prm.grad.clone() for prm in blk.parameters()])
        names = ["out", "dx"] + [n for n, _ in blk.named_parameters()]
        rel = {n: _norm_rel(a, b) for n, a, b in zip(names, *runs)}
        top = max(rel, key=rel.get)
        worst[f"blocks.{i}"] = [top, rel[top]]
    return worst


def run_vision_train(torch, gen):
    """ResNet-50 training at the fused-block configuration (s2d stem,
    block_impl fused_pallas, batch 256, 224 x 224, SGD lr 0.1) with seeded
    weights and every bn3 scale drawn nonzero: one step of the kernel
    path against the plain path from the same weights and batch (the
    loss, the new running statistics, the gradients against the floor
    that moving one pixel sets, and each block replayed alone on what it
    saw), then VISION_STEPS steps on that batch with the launch counters
    read around them, step time and images/s, a 3-step profile, and
    resnet_main itself at its defaults for a warm-up step and 3 logged
    steps."""
    from container_engine_accelerators_tpu_torch import resnet_main
    from container_engine_accelerators_tpu_torch.models import (
        fused_block as FB,
        train as TT,
    )
    from container_engine_accelerators_tpu_torch.ops import (
        fused_linear as FL,
    )

    per_step = {"fused_matmul_stats": 16, "affine_relu_matmul_stats": 16}
    k_step, batch_fn, k_state = TT.build_training(**VISION, seed=SEED,
                                                  device="cuda")
    model = k_state["model"]
    blocks = [b for b in model.blocks
              if isinstance(b, FB.FusedBottleneckBlock)]
    assert len(blocks) == 16, len(blocks)
    with torch.no_grad():
        for blk in blocks:
            blk.bn3_scale.copy_(0.2 + 0.4 * torch.rand(
                blk.bn3_scale.shape, device="cuda", generator=gen))
    snapshot = {k: v.detach().clone() for k, v in model.state_dict().items()}
    images, labels = batch_fn(gen, VISION_BATCH)
    moved = images.clone()
    moved[0, 0, 0, 0] += VISION_PIXEL

    # The kernel path, each block's input and output gradient captured.
    captured, hooks = {}, []
    for i, blk in enumerate(model.blocks):
        def keep(mod, args, out, i=i):
            captured[i] = [args[0].detach(), None]
            out.register_hook(
                lambda g: captured[i].__setitem__(1, g.detach()))
        hooks.append(blk.register_forward_hook(keep))
    _vision_counts(FL, reset=True)
    k_state, k_loss = k_step(k_state, images, labels)
    for h in hooks:
        h.remove()
    one = _vision_counts(FL)
    if one != per_step:
        raise AssertionError(f"one kernel-path step launched {one}")
    # The plain path, and the floor: the plain path with one pixel moved.
    losses, plain_models = {}, {}
    for name, imgs in (("plain", images), ("moved_pixel", moved)):
        step, _, state = TT.build_training(**VISION, seed=SEED,
                                           device="cuda")
        state["model"].load_state_dict(snapshot)
        with plain_vision_kernels(FL, None):
            state, loss = step(state, imgs, labels)
        losses[name], plain_models[name] = float(loss), state["model"]
        del step, state
    if _vision_counts(FL) != one:
        raise AssertionError("the plain path launched a kernel")
    p_model = plain_models["plain"]
    loss_rel = abs(float(k_loss) - losses["plain"]) / abs(losses["plain"])
    for name, prm in model.named_parameters():
        assert finite(prm.grad), name
    grad_rel = _grad_rel(model, p_model)
    floor_rel = _grad_rel(plain_models["moved_pixel"], p_model)
    del plain_models["moved_pixel"]
    stats_rel = {name: _norm_rel(bk, bp) for (name, bk), bp in zip(
        model.named_buffers(), p_model.buffers())}
    worst_s = max(stats_rel, key=stats_rel.get)
    blocks_worst = replay_blocks(torch, FL, p_model, snapshot, captured)
    del captured, p_model, plain_models
    worst_b = max(blocks_worst, key=lambda k: blocks_worst[k][1])
    faults = []
    if not loss_rel <= VISION_LOSS_REL:
        faults.append(f"loss rel {loss_rel}")
    if not stats_rel[worst_s] <= VISION_STATS_REL:
        faults.append(f"{worst_s} stats rel {stats_rel[worst_s]}")
    if not blocks_worst[worst_b][1] <= VISION_GRAD_REL:
        faults.append(f"{worst_b} replayed: {blocks_worst[worst_b]}")
    if not _median(grad_rel.values()) <= 2 * _median(floor_rel.values()):
        faults.append("whole-step gradients: median rel "
                      f"{_median(grad_rel.values())} over twice the floor "
                      f"{_median(floor_rel.values())}")
    if faults:
        raise AssertionError(f"vision parity: {faults}")
    worst = max(grad_rel, key=grad_rel.get)
    parity = {
        "batch": VISION_BATCH,
        "loss_kernel_path": float(k_loss), "loss_plain_path": losses["plain"],
        "loss_plain_moved_pixel": losses["moved_pixel"],
        "loss_rel": loss_rel, "loss_tolerance_rel": VISION_LOSS_REL,
        "stats_rel_worst": [worst_s, stats_rel[worst_s]],
        "stats_tolerance_rel": VISION_STATS_REL,
        "blocks_replayed_worst": blocks_worst,
        "blocks_tolerance_rel": VISION_GRAD_REL,
        "whole_step_grad_rel": {
            "median": _median(grad_rel.values()),
            "worst": [worst, grad_rel[worst]],
            "floor_median": _median(floor_rel.values()),
            "floor_worst": max(floor_rel.values()),
        },
        "leaves": len(grad_rel), "launches_one_step": one,
    }
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _vision_counts(FL, reset=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses, marks = [], []
    for _ in range(VISION_STEPS):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        k_state, loss = k_step(k_state, images, labels)
        losses.append(loss)
    losses = [float(x) for x in losses]  # the fence
    wall = time.monotonic() - t0
    step_each = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    launches = _vision_counts(FL)
    want = {name: n * VISION_STEPS for name, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or not (
        losses[-1] < losses[0]
    ):
        raise AssertionError(f"vision training loss did not fall: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = device_profile(
        torch, lambda: [k_step(k_state, images, labels) for _ in range(3)],
        top=12, counts=lambda: _vision_counts(FL), tag="vision_train")
    del k_step, k_state, model, blocks
    torch.cuda.empty_cache()

    # The command-line job at its defaults (the flax block: no kernel of
    # this phase runs there): a warm-up step and 3 logged steps.
    _vision_counts(FL, reset=True)
    t_cli = time.monotonic()
    rc = resnet_main.main(["--train-steps", "3", "--log-every", "1"])
    cli_s = time.monotonic() - t_cli
    cli = _vision_counts(FL)
    if rc != 0 or any(cli.values()):
        raise AssertionError(f"resnet_main exited {rc}, launched {cli}")

    step_ms = wall / VISION_STEPS * 1e3
    flops = 3 * RESNET50_FWD_FLOP * VISION_BATCH
    return {
        "phase": "vision_train", **VISION, "batch": VISION_BATCH,
        "steps": VISION_STEPS, "parity": parity, "losses": losses,
        "step_ms": step_ms, "step_ms_device_clock": step_each,
        "images_per_s": VISION_BATCH * VISION_STEPS / wall,
        "model_flops_per_step": flops,
        "model_flops_share_of_bf16_peak": flops / PEAK_OPS["bf16"]
        / (step_ms / 1e3),
        "peak_memory_gb": peak_gb, "profile": profile,
        "launches": launches, "resnet_main_launches": cli,
        "resnet_main_seconds": cli_s,
    }, launches


class _LossLines(logging.Handler):
    """Collects the losses of lm_main's `step N loss L ...` log lines."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        found = re.match(r"step \d+ loss ([-0-9.naif]+)",
                         record.getMessage())
        if found:
            self.losses.append(float(found.group(1)))


def _train_counts(FA, FX, reset=False):
    fns = {"flash_attention_fwd": FA.flash_attention_fwd,
           "flash_attention_bwd": FA.flash_attention_bwd,
           "fused_xent_fwd": FX.xent_fwd, "fused_xent_bwd": FX.xent_bwd}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


# lm_main --heads at the default dim 1024: head dims 64, 32 and 256.
LM_MAIN_HEADS = (16, 32, 4)


def run_train(torch, timer, gen):
    """The trainer at lm_main's full default width with seeded weights:
    one step of the kernel path (attn/loss "auto", which resolve to
    flash and the fused loss on the card) against the plain path (dense
    attention with remat, as lm_main resolves it, and the log_softmax
    loss) from the same weights and batch; then TRAIN_STEPS steps on the
    fixed batch with the launch counters read around them; a profiled
    window of 3 steps; the f32 head's matmuls timed alone; and lm_main
    itself for a few steps."""
    from container_engine_accelerators_tpu_torch.models import (
        transformer as T,
    )
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as FA,
        fused_xent as FX,
    )

    def build(attn, loss, remat):
        return T.build_lm_training(
            **TRAIN, seed=SEED, remat=remat, attn_impl=attn, loss_impl=loss,
            device="cuda",
        )

    depth = TRAIN["depth"]
    per_step = {"flash_attention_fwd": depth, "flash_attention_bwd": depth,
                "fused_xent_fwd": 1, "fused_xent_bwd": 1}
    k_step, k_state, batch_fn = build("auto", "auto", False)
    model = k_state["model"]
    assert model.blocks[0].attn_fn is FA.flash_causal_attention
    p_step, p_state, _ = build("dense", "xla", True)
    p_state["model"].load_state_dict(model.state_dict())
    tokens, targets = batch_fn(torch.Generator().manual_seed(SEED))

    _train_counts(FA, FX, reset=True)
    k_state, k_loss = k_step(k_state, tokens, targets)
    one = _train_counts(FA, FX)
    if one != per_step:
        raise AssertionError(f"one kernel-path step launched {one}")
    p_state, p_loss = p_step(p_state, tokens, targets)
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    grad_rel = {}
    for (name, pk), pp in zip(model.named_parameters(),
                              p_state["model"].parameters()):
        gk, gp = pk.grad.float(), pp.grad.float()
        assert finite(gk), name
        grad_rel[name] = ((gk - gp).norm() / gp.norm()).item()
    worst = max(grad_rel, key=grad_rel.get)
    if loss_rel > TRAIN_LOSS_REL:
        raise AssertionError(f"train parity: loss rel {loss_rel}")
    if grad_rel[worst] > TRAIN_GRAD_REL:
        raise AssertionError(
            f"train parity: {worst} grad rel {grad_rel[worst]}")
    parity = {
        "loss_kernel_path": float(k_loss), "loss_plain_path": float(p_loss),
        "loss_rel": loss_rel, "loss_tolerance_rel": TRAIN_LOSS_REL,
        "grad_rel_worst": [worst, grad_rel[worst]],
        "grad_rel_median": sorted(grad_rel.values())[len(grad_rel) // 2],
        "grad_tolerance_rel": TRAIN_GRAD_REL, "leaves": len(grad_rel),
    }
    del p_step, p_state
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _train_counts(FA, FX, reset=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses, marks = [], []
    for _ in range(TRAIN_STEPS):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        k_state, loss = k_step(k_state, tokens, targets)
        losses.append(loss)
    losses = [float(x) for x in losses]  # the fence
    wall = time.monotonic() - t0
    # The card's clock from the start of each step to the next's (the
    # last step is read by the wall only).
    step_each = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    launches = _train_counts(FA, FX)
    want = {name: n * TRAIN_STEPS for name, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or not (
        losses[-1] < losses[0]
    ):
        raise AssertionError(f"training loss did not fall: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    profile = device_profile(
        torch, lambda: [k_step(k_state, tokens, targets) for _ in range(3)],
        top=12, counts=lambda: _train_counts(FA, FX), tag="train")

    # The command-line entry point at its defaults (lm_main's single-card
    # dp path, the same width): a warm-up step and 3 logged steps.
    from container_engine_accelerators_tpu_torch import lm_main

    _train_counts(FA, FX, reset=True)
    rc = lm_main.main(["--train-steps", "3", "--log-every", "1"])
    cli = _train_counts(FA, FX)
    if rc != 0 or cli != {name: 4 * n for name, n in per_step.items()}:
        raise AssertionError(f"lm_main exited {rc}, launched {cli}")

    # The same at 16, 32 and 4 heads: head dims 64, 32 (on the d-64
    # instance) and 256, the kernels' other instances.
    by_heads = {}
    for h in LM_MAIN_HEADS:
        log, seen = logging.getLogger("lm_main"), _LossLines()
        log.addHandler(seen)
        _train_counts(FA, FX, reset=True)
        rc = lm_main.main(["--heads", str(h), "--train-steps", "3",
                           "--log-every", "1"])
        cli_h = _train_counts(FA, FX)
        log.removeHandler(seen)
        if rc != 0 or cli_h != {name: 4 * n for name, n in per_step.items()}:
            raise AssertionError(
                f"lm_main --heads {h} exited {rc}, launched {cli_h}")
        if len(seen.losses) != 3 or not all(
            math.isfinite(x) for x in seen.losses
        ) or not seen.losses[-1] < seen.losses[0]:
            raise AssertionError(
                f"lm_main --heads {h}: the loss did not fall: {seen.losses}")
        d = TRAIN["dim"] // h
        launches.update({f"{name}_d{d}": cli_h[name] for name in (
            "flash_attention_fwd", "flash_attention_bwd")})
        by_heads[f"lm_main_heads_{h}"] = {"head_dim": d, "launches": cli_h,
                                          "losses": seen.losses}

    b, s, dim = TRAIN["batch"], TRAIN["seq_len"], TRAIN["dim"]
    vocab, dh = TRAIN["vocab"], TRAIN["dim"] // TRAIN["heads"]
    tok = b * s
    x = torch.randn((tok, dim), device="cuda", generator=gen)
    dl = torch.randn((tok, vocab), device="cuda", generator=gen)
    w, bias = model.head_kernel.detach(), model.head_bias.detach()
    head = {
        "fwd_ms": timer.ms(lambda: torch.matmul(x, w) + bias, iters=10),
        "bwd_ms": timer.ms(lambda: (x.t() @ dl, dl @ w.t()), iters=10),
    }
    step_ms = wall / TRAIN_STEPS * 1e3
    # Model FLOPs per step: 3x the forward's matmuls (no recompute).
    bf16_flops = 3 * (2 * tok * 12 * dim * dim * depth
                      + 4 * b * TRAIN["heads"] * dh * s * (s + 1) / 2 * depth)
    f32_flops = 3 * 2 * tok * dim * vocab
    ideal_ms = (bf16_flops / PEAK_OPS["bf16"]
                + f32_flops / PEAK_OPS["f32"]) * 1e3
    return {
        "phase": "train", **TRAIN, "steps": TRAIN_STEPS,
        "attn": "flash", "loss": "fused", "parity": parity,
        "losses": losses, "step_ms": step_ms,
        "step_ms_device_clock": step_each,
        "tokens_per_s": tok * TRAIN_STEPS / wall,
        "model_flops_per_step": {"bf16": bf16_flops, "f32_head": f32_flops},
        "ideal_ms_at_peak": ideal_ms,
        "model_flops_share_of_peak": ideal_ms / step_ms,
        "head_f32_ms": head,
        "head_share_of_step": (head["fwd_ms"] + head["bwd_ms"]) / step_ms,
        "peak_memory_gb": peak_gb, "profile": profile,
        "launches": launches, "lm_main_launches": cli, **by_heads,
    }, launches


# bench.py's lm_large point (bench.py:603-613), at full size: about 0.94B
# parameters, the chunked vocab head in 8192-column chunks.
LM_LARGE = dict(vocab=32000, dim=2048, depth=16, heads=16, seq_len=2048,
                batch=2, learning_rate=3e-4, head_impl="chunked",
                head_chunk=8192)
LM_LARGE_STEPS = 10


def _head_loss_peak(torch, loss_fn, hidden, kernel, bias, labels):
    """Device memory the head and loss take beyond what is already held,
    forward and backward, on the hidden rows (a leaf that wants its
    gradient): bytes, and the loss."""
    h = hidden.detach().requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = loss_fn(h, kernel, bias, labels)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    h.grad = kernel.grad = bias.grad = None
    return peak, loss.item()


def run_lm_large(torch, gen):
    """bench.py's lm_large (dim 2048 x 16 layers, seq 2048, batch 2,
    vocab 32000, chunked head of 8192 columns) through build_lm_training
    with seeded weights: one step against the dense head's trainer from
    the same weights and batch (the loss within TRAIN_LOSS_REL), the
    head + loss's own peak memory beside the dense head's (it must stay
    below), LM_LARGE_STEPS steps on one batch (the loss falling, flash
    launched depth times a step each way), step time, tokens/s, the
    model-FLOPs share, and a 2-step profile."""
    from container_engine_accelerators_tpu_torch.models import (
        transformer as T,
    )
    from container_engine_accelerators_tpu_torch.ops import (
        chunked_xent as CX,
        flash_attention as FA,
        fused_xent as FX,
    )

    cfg = LM_LARGE
    step, state, batch_fn = T.build_lm_training(**cfg, seed=SEED,
                                                device="cuda")
    model = state["model"]
    n_params = sum(p.numel() for p in model.parameters())
    tokens, targets = batch_fn(torch.Generator().manual_seed(SEED))
    d_step, d_state, _ = T.build_lm_training(
        **{**cfg, "head_impl": "dense"}, seed=SEED, device="cuda")
    d_state["model"].load_state_dict(model.state_dict())

    # The head and loss alone on this model's hidden rows: the chunked
    # head against the dense f32 head and the loss the dense trainer
    # resolves to (the fused kernels on the card).
    labels = targets.reshape(-1)
    with torch.no_grad():
        hidden, kern, bias = model(tokens, head_impl="chunked")
    hidden = hidden.reshape(-1, cfg["dim"])
    kern.requires_grad_(True)
    bias.requires_grad_(True)
    chunk = cfg["head_chunk"]
    peak_chunked, loss_c = _head_loss_peak(
        torch, lambda h, k, b, y: CX.chunked_softmax_xent(h, k, b, y, chunk),
        hidden, kern, bias, labels)
    peak_dense, loss_d = _head_loss_peak(
        torch, lambda h, k, b, y: FX.fused_cross_entropy_loss(
            torch.matmul(h, k) + b, y), hidden, kern, bias, labels)
    del hidden
    if not peak_chunked < peak_dense:
        raise AssertionError(f"chunked head peak {peak_chunked} >= dense "
                             f"{peak_dense}")

    _train_counts(FA, FX, reset=True)
    state, k_loss = step(state, tokens, targets)
    one = _train_counts(FA, FX)
    d_state, dense_loss = d_step(d_state, tokens, targets)
    loss_rel = abs(float(k_loss) - float(dense_loss)) / abs(float(dense_loss))
    if loss_rel > TRAIN_LOSS_REL:
        raise AssertionError(f"lm_large: chunked loss {float(k_loss)} vs "
                             f"dense {float(dense_loss)}")
    per_step = {"flash_attention_fwd": cfg["depth"],
                "flash_attention_bwd": cfg["depth"],
                "fused_xent_fwd": 0, "fused_xent_bwd": 0}
    if one != per_step:
        raise AssertionError(f"lm_large: one step launched {one}")
    del d_step, d_state
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _train_counts(FA, FX, reset=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses = []
    for _ in range(LM_LARGE_STEPS):
        state, loss = step(state, tokens, targets)
        losses.append(loss)
    losses = [float(x) for x in losses]  # the fence
    wall = time.monotonic() - t0
    counts = _train_counts(FA, FX)
    if counts != {k: v * LM_LARGE_STEPS for k, v in per_step.items()}:
        raise AssertionError(f"lm_large launches {counts}")
    if not all(math.isfinite(x) for x in losses) or not (
        losses[-1] < losses[0]
    ):
        raise AssertionError(f"lm_large: the loss did not fall: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = device_profile(
        torch, lambda: [step(state, tokens, targets) for _ in range(2)],
        top=12, counts=lambda: _train_counts(FA, FX), tag="lm_large")
    b, s_, dim, depth = cfg["batch"], cfg["seq_len"], cfg["dim"], cfg["depth"]
    tok, dh = b * s_, dim // cfg["heads"]
    bf16_flops = 3 * (2 * tok * 12 * dim * dim * depth
                      + 4 * b * cfg["heads"] * dh * s_ * (s_ + 1) / 2 * depth)
    f32_flops = 3 * 2 * tok * dim * cfg["vocab"]
    ideal_ms = (bf16_flops / PEAK_OPS["bf16"]
                + f32_flops / PEAK_OPS["f32"]) * 1e3
    step_ms = wall / LM_LARGE_STEPS * 1e3
    del step, state, model
    torch.cuda.empty_cache()
    return {
        "phase": "lm_large_train", **cfg, "parameters": n_params,
        "steps": LM_LARGE_STEPS, "losses": losses,
        "one_step_loss_chunked": float(k_loss),
        "one_step_loss_dense": float(dense_loss),
        "one_step_loss_rel": loss_rel, "loss_tolerance_rel": TRAIN_LOSS_REL,
        "head_loss_peak_bytes": {"chunked": peak_chunked,
                                 "dense_fused_loss": peak_dense},
        "head_loss_values": {"chunked": loss_c, "dense": loss_d},
        "step_ms": step_ms, "tokens_per_s": tok * LM_LARGE_STEPS / wall,
        "model_flops_per_step": {"bf16": bf16_flops, "f32_head": f32_flops},
        "ideal_ms_at_peak": ideal_ms,
        "model_flops_share_of_peak": ideal_ms / step_ms,
        "peak_memory_gb": peak_gb, "launches": counts, "profile": profile,
    }, counts


# Inception v3 at the reference's demo job (demo/tpu-training/
# inception-v3-tpu.yaml:21-24): 299 x 299 images, batch 128 a chip.
INCEPTION = dict(model_name="inception_v3", image_size=299,
                 num_classes=1000, learning_rate=0.1)
INCEPTION_BATCH = 128
INCEPTION_STEPS = 8
# About 5.7 G multiply-adds an image at 299 x 299 (torchvision's count),
# 2 FLOPs each; a training step 3x the forward.
INCEPTION_FWD_FLOP = 2 * 5.7e9


def run_inception_train(torch, gen):
    """Inception v3 through build_training at 299 x 299, batch 128:
    INCEPTION_STEPS steps on one batch (the loss finite and falling),
    step time, images/s, the model-FLOPs share, a 2-step profile; then
    resnet_main --model inception_v3 at the demo job's flags for a
    warm-up step and 3 logged steps (fresh batches each step)."""
    from container_engine_accelerators_tpu_torch import resnet_main
    from container_engine_accelerators_tpu_torch.models import train as TT
    from container_engine_accelerators_tpu_torch.ops import fused_linear as FL

    step, batch_fn, state = TT.build_training(**INCEPTION, seed=SEED,
                                              device="cuda")
    images, labels = batch_fn(gen, INCEPTION_BATCH)
    state, loss = step(state, images, labels)  # warm-up
    float(loss)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses = []
    for _ in range(INCEPTION_STEPS):
        state, loss = step(state, images, labels)
        losses.append(loss)
    losses = [float(x) for x in losses]
    wall = time.monotonic() - t0
    if not all(math.isfinite(x) for x in losses) or not (
        losses[-1] < losses[0]
    ):
        raise AssertionError(f"inception: the loss did not fall: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = device_profile(
        torch, lambda: [step(state, images, labels) for _ in range(2)],
        top=12, counts=lambda: _vision_counts(FL), tag="inception_train")
    del step, state, images, labels
    torch.cuda.empty_cache()

    log, seen = logging.getLogger("resnet_main"), _LossLines()
    log.addHandler(seen)
    t_cli = time.monotonic()
    rc = resnet_main.main(["--model", "inception_v3", "--image-size", "299",
                           "--batch-per-chip", str(INCEPTION_BATCH),
                           "--train-steps", "3", "--log-every", "1"])
    cli_s = time.monotonic() - t_cli
    log.removeHandler(seen)
    if rc != 0 or len(seen.losses) != 3 or not all(
        math.isfinite(x) for x in seen.losses
    ):
        raise AssertionError(f"resnet_main --model inception_v3 exited {rc}, "
                             f"losses {seen.losses}")
    step_ms = wall / INCEPTION_STEPS * 1e3
    flops = 3 * INCEPTION_FWD_FLOP * INCEPTION_BATCH
    return {
        "phase": "inception_train", **INCEPTION, "batch": INCEPTION_BATCH,
        "steps": INCEPTION_STEPS, "losses": losses, "step_ms": step_ms,
        "images_per_s": INCEPTION_BATCH * INCEPTION_STEPS / wall,
        "model_flops_per_step": flops,
        "model_flops_share_of_bf16_peak": flops / PEAK_OPS["bf16"]
        / (step_ms / 1e3),
        "peak_memory_gb": peak_gb, "profile": profile,
        "resnet_main_losses": seen.losses, "resnet_main_seconds": cli_s,
    }


CKPT_DEPTH = 2  # lm_main's width, cut to 2 layers to save time


def run_checkpoint(torch):
    """Checkpoints on the card: lm_main with --model-dir (depth
    CKPT_DEPTH) trains and saves, then a second run resumes (it logs the
    restored step and saves one past it); a trained state saved and
    restored into a fresh trainer gives bitwise the same tensors, model
    and AdamW moments; resnet_main with --model-dir writes
    checkpoint_<n>."""
    import shutil
    import tempfile

    from container_engine_accelerators_tpu_torch import lm_main, resnet_main
    from container_engine_accelerators_tpu_torch.models import (
        transformer as T,
    )
    from container_engine_accelerators_tpu_torch.utils import (
        checkpoint as CK,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        lm_dir = os.path.join(root, "lm")
        args = ["--depth", str(CKPT_DEPTH), "--train-steps", "3",
                "--log-every", "1", "--model-dir", lm_dir]

        class _Lines(logging.Handler):
            lines = []

            def emit(self, record):
                self.lines.append(record.getMessage())

        seen = _Lines()
        logging.getLogger("lm_main").addHandler(seen)
        try:
            rc1 = lm_main.main(args)
            first = sorted(os.listdir(lm_dir))
            rc2 = lm_main.main(args)
            second = sorted(os.listdir(lm_dir))
        finally:
            logging.getLogger("lm_main").removeHandler(seen)
        resumed = [x for x in seen.lines if x.startswith("resumed from")]
        if (rc1, rc2) != (0, 0) or first != ["checkpoint_4"] or (
            second != ["checkpoint_4", "checkpoint_8"]
        ) or resumed != ["resumed from step 4"]:
            raise AssertionError(f"lm_main --model-dir: rc {rc1} {rc2}, "
                                 f"{first} then {second}, {resumed}")

        cfg = dict(TRAIN, depth=CKPT_DEPTH)
        step, state, batch_fn = T.build_lm_training(**cfg, seed=SEED,
                                                    device="cuda")
        tokens, targets = batch_fn(torch.Generator().manual_seed(SEED))
        for _ in range(2):
            state, _ = step(state, tokens, targets)
        saved_dir = os.path.join(root, "bitwise")
        CK.save_checkpoint(saved_dir, state, state["step"])
        _, fresh, _ = T.build_lm_training(**cfg, seed=SEED + 1,
                                          device="cuda")
        CK.restore_checkpoint(saved_dir, fresh)
        want = [*state["model"].state_dict().values()] + [
            t for st in state["opt"].state.values() for t in st.values()
            if torch.is_tensor(t)]
        got = [*fresh["model"].state_dict().values()] + [
            t for st in fresh["opt"].state.values() for t in st.values()
            if torch.is_tensor(t)]
        if len(got) != len(want) or fresh["step"] != state["step"] or not (
            all(a.device == b.device and torch.equal(a, b)
                for a, b in zip(got, want))
        ):
            raise AssertionError("restored tensors differ from the saved")
        del step, state, fresh
        torch.cuda.empty_cache()

        rn_dir = os.path.join(root, "resnet")
        rc = resnet_main.main(["--train-steps", "1", "--log-every", "1",
                               "--model-dir", rn_dir])
        rn = sorted(os.listdir(rn_dir)) if os.path.isdir(rn_dir) else []
        if rc != 0 or rn != ["checkpoint_2"]:
            raise AssertionError(f"resnet_main --model-dir: rc {rc}, {rn}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "checkpoint", "lm_main_depth": CKPT_DEPTH,
            "lm_main_dirs": [first, second], "lm_main_resumed": resumed,
            "bitwise_tensors": len(want), "resnet_main_dirs": rn}


# The MoE LM at lm_main's width (lm_main.py:22-27) with
# build_moe_lm_training's routing defaults (moe_lm.py:135-151) and 8
# experts, as bench.py's ep arm gives on 8 chips (bench.py:175-205).
MOE = dict(vocab=32000, dim=1024, depth=8, heads=8, seq_len=2048, batch=8,
           n_experts=8, moe_every=2, capacity_factor=1.25, n_reroute=2,
           aux_weight=0.01, learning_rate=3e-4)
MOE_STEPS = 10
MESH_DEPTH = 2  # lm_main's width, cut to 2 layers to save time
RESNET_DP_BATCH = 32
# The vision configurations the reference trains under a mesh, each one
# step over the one-rank mesh against its step without one, at full
# width: (key, model, model kwargs, image size, batch, loss_impl).  The
# batches are the largest that keep the phase within ~1 min: the card
# has room for 4x more.
MESH_VISION_BATCH, MESH_INCEPTION_BATCH = 128, 64
MESH_VISION = (
    ("resnet50_fused_block", "resnet50",
     dict(stem="s2d", block_impl="fused_pallas"), 224, MESH_VISION_BATCH,
     "pallas"),
    ("resnet50_flax_norm", "resnet50", dict(norm_impl="flax"), 224,
     MESH_VISION_BATCH, "xla"),
    ("inception_v3", "inception_v3", None, 299, MESH_INCEPTION_BATCH, "xla"),
)
# Loss, every gradient and every running statistic (each tensor's
# ||difference|| over its norm, as the other gradient checks here), mesh
# against no mesh: half a bf16 ulp.  On one rank the mesh path's
# arithmetic is the no-mesh path's (models/norm.py), so the two agree
# bitwise; a rounding step of its own, such as dividing by a count held
# on the card where the no-mesh path multiplies by a reciprocal, moves
# the bf16 step's early gradients by ~3e-3 and fails the check.
MESH_VISION_REL = 2.0 ** -9
# Steady steps timed after the compared one, mesh and no mesh alike.
MESH_TIMED_STEPS = 3
# The fused block's kernels a ResNet-50 step: one matmul_stats (conv1)
# and one affine_relu_matmul_stats (conv3) a bottleneck block.
RESNET50_BLOCKS = 16
# Tokens of the 16384 a MoE layer whose routing the dense path's own
# router would flip against the flash path's: sound runs read 421 / 791
# / 972 / 933 (NVIDIA H100 80GB HBM3, 700.00 W); a bound at about twice
# the worst holds a kernel that moved many tokens' routes.
MOE_FLIPPED_MAX = 2048


def _nccl_group(torch):
    """A one-rank NCCL process group (parallel/launch.py): the mesh paths
    on this one card.  NCCL or it raises."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import launch

    launch.one_rank_group("cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}, not nccl")
    return dist.get_backend()


def _grads_rel(torch, model_a, model_b):
    rel = {}
    for (name, pa), pb in zip(model_a.named_parameters(),
                              model_b.parameters()):
        ga, gb = pa.grad.float(), pb.grad.float()
        if not finite(ga):
            raise AssertionError(f"{name}: non-finite gradient")
        rel[name] = ((ga - gb).norm() / gb.norm().clamp_min(1e-30)).item()
    return rel


def run_moe_train(torch, gen):
    """The MoE LM at full width on a one-rank NCCL group (phase 10)."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.models import moe_lm
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as FA,
        fused_xent as FX,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as M
    from container_engine_accelerators_tpu_torch.parallel import moe as MOE_MOD

    backend = _nccl_group(torch)
    t_phase = time.monotonic()
    try:
        mesh = M.mesh_1d("ep")
        cfg = dict(MOE)

        def build(attn):
            return moe_lm.build_moe_lm_training(
                mesh, "ep", seed=SEED, attn_impl=attn, device="cuda", **cfg)

        k_step, k_state, batch_fn = build("auto")
        p_step, p_state, _ = build("dense")
        p_state["model"].load_state_dict(k_state["model"].state_dict())
        tokens, targets = batch_fn(torch.Generator().manual_seed(SEED))
        model = k_state["model"]
        on_card = all(p.is_cuda for p in model.parameters()) and (
            tokens.is_cuda and targets.is_cuda)
        if not on_card:
            raise AssertionError("a parameter or the batch is off the card")
        n_params = sum(p.numel() for p in model.parameters())
        per_step = {"flash_attention_fwd": cfg["depth"],
                    "flash_attention_bwd": cfg["depth"],
                    "fused_xent_fwd": 0, "fused_xent_bwd": 0}
        # The router is discrete: a rounding-level difference in what
        # reaches it flips near-tie routes and moves the router's and
        # the experts' gradients by O(1) there.  The plain path replays
        # the kernel path's routing (moe.top_candidates patched for its
        # step), so that the check holds the kernel; the routes its own
        # router would have flipped are counted and bounded.
        k_blocks = model.moe_blocks()
        for blk in k_blocks:
            blk.trace = {}
        _train_counts(FA, FX, reset=True)
        k_state, (k_loss, k_aux, k_drop) = k_step(k_state, tokens, targets)
        one = _train_counts(FA, FX)
        if one != per_step:
            raise AssertionError(f"one MoE step launched {one}")
        recorded = [kb.trace["cand_idx"] for kb in k_blocks]
        for blk in k_blocks:
            blk.trace = None
        own_top, flipped = MOE_MOD.top_candidates, []

        def replay(probs, n_cand):
            want = recorded[len(flipped)]
            flipped.append(int((own_top(probs, n_cand) != want).any(-1).sum()))
            return want

        MOE_MOD.top_candidates = replay
        try:
            p_state, (p_loss, _, _) = p_step(p_state, tokens, targets)
        finally:
            MOE_MOD.top_candidates = own_top
        if len(flipped) != len(recorded) or max(flipped) > MOE_FLIPPED_MAX:
            raise AssertionError(
                f"moe routing: {flipped} tokens a layer route apart "
                f"(limit {MOE_FLIPPED_MAX}, {len(recorded)} layers)")
        loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
        grad_rel = _grads_rel(torch, model, p_state["model"])
        worst = max(grad_rel, key=grad_rel.get)
        if loss_rel > TRAIN_LOSS_REL or grad_rel[worst] > TRAIN_GRAD_REL:
            raise AssertionError(
                f"moe parity: loss rel {loss_rel}, {worst} grad rel "
                f"{grad_rel[worst]}")
        parity = {"loss_flash": float(k_loss), "loss_dense": float(p_loss),
                  "routing": "the dense path replays the flash path's",
                  "tokens_own_routing_differs": flipped,
                  "tokens_own_routing_differs_limit": MOE_FLIPPED_MAX,
                  "loss_rel": loss_rel, "loss_tolerance_rel": TRAIN_LOSS_REL,
                  "grad_rel_worst": [worst, grad_rel[worst]],
                  "grad_tolerance_rel": TRAIN_GRAD_REL,
                  "leaves": len(grad_rel)}
        del p_step, p_state
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        _train_counts(FA, FX, reset=True)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = [k_step(k_state, tokens, targets)[1] for _ in range(MOE_STEPS)]
        losses = [float(o[0]) for o in outs]  # the fence
        wall = time.monotonic() - t0
        aux = [float(o[1]) for o in outs]
        drop = [float(o[2]) for o in outs]
        launches = _train_counts(FA, FX)
        want = {k: v * MOE_STEPS for k, v in per_step.items()}
        if launches != want:
            raise AssertionError(f"MoE launches {launches} != {want}")
        if not all(math.isfinite(x) for x in losses) or not (
            losses[-1] < losses[0]
        ):
            raise AssertionError(f"MoE loss did not fall: {losses}")
        peak = torch.cuda.max_memory_allocated()
        profile = device_profile(
            torch, lambda: [k_step(k_state, tokens, targets)
                            for _ in range(2)], top=6,
            counts=lambda: _train_counts(FA, FX), tag="moe_train")
        b, s, dim = cfg["batch"], cfg["seq_len"], cfg["dim"]
        depth, vocab = cfg["depth"], cfg["vocab"]
        tok = b * s
        step_ms = wall / MOE_STEPS * 1e3
        # bench.py :421-424 and :199: model FLOPs a token.
        flops_token = 3 * (depth * (24 * dim * dim + 4 * (s // 2) * dim)
                           + 2 * dim * vocab) + 3 * (depth // 2) * 16 * dim * dim
        ideal_ms = flops_token * tok / PEAK_OPS["bf16"] * 1e3
        return {
            "phase": "moe_train", **cfg, "steps": MOE_STEPS,
            "backend": backend, "world": dist.get_world_size(),
            "params_on_card": on_card, "params": n_params,
            "attn": "flash", "parity": parity,
            "first_aux": float(k_aux), "first_drop": float(k_drop),
            "losses": losses, "aux": aux, "drop_frac": drop,
            "step_ms": step_ms, "tokens_per_s": tok * MOE_STEPS / wall,
            "peak_bytes": peak, "model_flops_per_token": flops_token,
            "ideal_ms_at_bf16_peak": ideal_ms,
            "model_flops_share_of_peak": ideal_ms / step_ms,
            "launches_per_step": one, "launches": launches,
            "profile": profile, "seconds": time.monotonic() - t_phase,
        }, launches
    finally:
        dist.destroy_process_group()


def _max_rel(a, b):
    """max |a - b| over max |b|, in f32 (reported beside _norm_rel)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def mesh_vision_case(torch, FL, FA, FX, name, kw, size, batch, loss_impl):
    """One step of build_training(model_name=name) without a mesh and
    over the one-rank mesh, from the seed's weights and one batch: the
    losses, the worst gradient and running statistic (MESH_VISION_REL),
    and each step's launches of the kernels; then MESH_TIMED_STEPS more
    steps each, timed (host clock, synchronized), and one profiled."""
    from container_engine_accelerators_tpu_torch.models import train as TT
    from container_engine_accelerators_tpu_torch.parallel import mesh as M

    got = {}
    for key, mesh in (("plain", None), ("dp", M.make_mesh())):
        step, bfn, state = TT.build_training(
            mesh=mesh, model_name=name, image_size=size, seed=SEED,
            loss_impl=loss_impl, model_kwargs=kw, device="cuda")
        images, labels = bfn(
            torch.Generator(device="cuda").manual_seed(SEED), batch)
        _vision_counts(FL, reset=True)
        _train_counts(FA, FX, reset=True)
        t0 = time.monotonic()
        state, loss = step(state, images, labels)
        loss = float(loss)
        ms = (time.monotonic() - t0) * 1e3
        model = state["model"]
        got[key] = {
            "loss": loss, "first_step_ms": ms,
            "launches": {**_vision_counts(FL), **_train_counts(FA, FX)},
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "stats": {n: b.detach().clone()
                      for n, b in model.named_buffers()},
        }
        t0 = time.monotonic()
        for _ in range(MESH_TIMED_STEPS):
            state, loss = step(state, images, labels)
        float(loss)
        torch.cuda.synchronize()
        got[key]["step_ms"] = (time.monotonic() - t0) * 1e3 / MESH_TIMED_STEPS
        got[key]["profile"] = device_profile(
            torch, lambda: step(state, images, labels),
            counts=lambda: {**_vision_counts(FL), **_train_counts(FA, FX)},
            tag=f"mesh_{name}_{key}")
        del step, state, model, images, labels
        torch.cuda.empty_cache()
    plain, dp = got["plain"], got["dp"]
    grad_rel = {n: _norm_rel(dp["grads"][n], g)
                for n, g in plain["grads"].items()}
    grad_max_rel = {n: _max_rel(dp["grads"][n], g)
                    for n, g in plain["grads"].items()}
    stats_rel = {n: _norm_rel(dp["stats"][n], b)
                 for n, b in plain["stats"].items()}
    if not all(math.isfinite(v) for v in grad_rel.values()):
        raise AssertionError(f"mesh {name} {kw}: a non-finite gradient")
    worst_grad = max(grad_rel.items(), key=lambda kv: kv[1])
    worst_stat = max(stats_rel.items(), key=lambda kv: kv[1])
    loss_rel = abs(dp["loss"] - plain["loss"]) / abs(plain["loss"])
    rec = {"model": name, "model_kwargs": kw, "image_size": size,
           "batch": batch, "loss_impl": loss_impl,
           "loss": {"plain": plain["loss"], "dp": dp["loss"]},
           "loss_rel": loss_rel, "worst_grad_rel": list(worst_grad),
           "worst_grad_max_rel": list(max(grad_max_rel.items(),
                                          key=lambda kv: kv[1])),
           "worst_stats_rel": list(worst_stat),
           "grads_bitwise": sum(v == 0 for v in grad_rel.values()),
           "grads": len(grad_rel),
           "first_step_ms": {"plain": plain["first_step_ms"],
                             "dp": dp["first_step_ms"]},
           "step_ms": {"plain": plain["step_ms"], "dp": dp["step_ms"]},
           "mesh_over_plain": dp["step_ms"] / plain["step_ms"],
           "profile": {"plain": plain["profile"], "dp": dp["profile"]},
           "launches": {"plain": plain["launches"], "dp": dp["launches"]},
           "tolerance_rel": MESH_VISION_REL}
    if not math.isfinite(dp["loss"]) or max(
        loss_rel, worst_grad[1], worst_stat[1]
    ) > MESH_VISION_REL:
        raise AssertionError(f"mesh {name} {kw}: {rec}")
    if dp["launches"] != plain["launches"]:
        raise AssertionError(f"mesh {name} {kw}: launches {rec['launches']}")
    return rec, dp["launches"]


def run_resnet_main_ranks(torch):
    """resnet_main's spawned job path on the card: `rank_main` through
    launch.spawn_ranks on one rank (its own process, NCCL, the mesh over
    the group) with --model inception_v3 at 299 x 299 for a warm-up step
    and 2 logged steps, saving a checkpoint from rank 0.  The child's
    stderr goes to smoke_out/ and is read back: its reference log lines
    and the checkpoint of step 3."""
    from container_engine_accelerators_tpu_torch.parallel import launch

    model_dir = os.path.join(LOG_DIR, "rank_main_ckpt")
    log_path = os.path.join(LOG_DIR, "rank_main_inception.log")
    shutil.rmtree(model_dir, ignore_errors=True)
    argv = ["--model", "inception_v3", "--image-size", "299",
            "--batch-per-chip", str(MESH_INCEPTION_BATCH), "--train-steps",
            "2", "--log-every", "1", "--model-dir", model_dir]
    sys.stderr.flush()
    saved = os.dup(2)
    t0 = time.monotonic()
    with open(log_path, "w") as f:
        os.dup2(f.fileno(), 2)
        try:
            rc = launch.spawn_ranks(
                "container_engine_accelerators_tpu_torch.resnet_main"
                ":rank_main", 1, (argv, "cuda"), device="cuda")
        finally:
            os.dup2(saved, 2)
            os.close(saved)
    seconds = time.monotonic() - t0
    with open(log_path) as f:
        text = f.read()
    steps = re.findall(r"step (\d+) loss ([0-9.naif]+) images/sec (\d+) "
                       r"\((\d+)/chip\)", text)
    head = re.search(r"training inception_v3 on 1 devices \(([^)]*)\), "
                     r"global batch (\d+)", text)
    saved_ckpt = sorted(os.listdir(model_dir)) if os.path.isdir(
        model_dir) else []
    rec = {"rc": rc, "argv": argv, "seconds": seconds,
           "device": head and head.group(1),
           "global_batch": head and int(head.group(2)),
           "steps": [[int(n), float(v), int(ips)] for n, v, ips, _ in steps],
           "done": "done: 2 steps" in text, "checkpoints": saved_ckpt}
    if rc != 0 or head is None or [r[0] for r in rec["steps"]] != [1, 2] or (
        not all(math.isfinite(r[1]) for r in rec["steps"])
    ) or not rec["done"] or saved_ckpt != ["checkpoint_3"]:
        raise AssertionError(f"resnet_main rank_main: {rec}\n{text[-2000:]}")
    shutil.rmtree(model_dir, ignore_errors=True)
    return rec


def run_mesh_modes(torch):
    """dp, sp (both layouts), tp and pp on a one-rank NCCL group at
    lm_main's widths cut to depth 2, each against the trainer without a
    mesh; a ResNet-50 dp step; lm_main --mode ep refused (phase 11)."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch import lm_main
    from container_engine_accelerators_tpu_torch.models import (
        pipeline_lm as PL,
        train as TT,
        transformer as T,
    )
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as FA,
        fused_linear as FL,
        fused_xent as FX,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as M

    backend = _nccl_group(torch)
    t_phase = time.monotonic()
    try:
        cfg = dict(TRAIN, depth=MESH_DEPTH)
        base_step, base_state, batch_fn = T.build_lm_training(
            **cfg, seed=SEED, device="cuda")
        tokens, targets = batch_fn(torch.Generator().manual_seed(SEED))
        _, base = base_step(base_state, tokens, targets)
        base = float(base)
        del base_step, base_state
        builders = {
            "dp": lambda: T.build_lm_training(
                M.make_mesh(), **cfg, seed=SEED, device="cuda"),
            "sp": lambda: T.build_lm_training(
                M.make_mesh(model_parallel=1), M.MODEL_AXIS, **cfg,
                seed=SEED, device="cuda"),
            "sp_zigzag": lambda: T.build_lm_training(
                M.make_mesh(model_parallel=1), M.MODEL_AXIS, **cfg,
                seed=SEED, seq_layout="zigzag", device="cuda"),
            "tp": lambda: T.build_lm_training_tp(
                M.mesh_1d(M.MODEL_AXIS), M.MODEL_AXIS, **cfg, seed=SEED,
                device="cuda"),
            "pp": lambda: PL.build_lm_training_pp(
                M.mesh_1d("pp"), "pp", 8, **cfg, seed=SEED, n_virtual=2,
                device="cuda")[:3],
        }
        modes, launches = {}, {}
        for name, build in builders.items():
            step, state, bfn = build()
            tok, tgt = bfn(torch.Generator().manual_seed(SEED))
            _train_counts(FA, FX, reset=True)
            t0 = time.monotonic()
            state, loss = step(state, tok, tgt)
            loss = float(loss)
            ms = (time.monotonic() - t0) * 1e3
            launches[name] = _train_counts(FA, FX)
            rel = abs(loss - base) / abs(base)
            if not math.isfinite(loss) or rel > TRAIN_LOSS_REL:
                raise AssertionError(
                    f"mesh {name}: loss {loss} vs {base} (rel {rel})")
            modes[name] = {"loss": loss, "loss_rel": rel,
                           "first_step_ms": ms, "launches": launches[name]}
            del step, state
            torch.cuda.empty_cache()
        if launches["dp"]["flash_attention_fwd"] != MESH_DEPTH or (
            launches["dp"]["fused_xent_fwd"] != 1
        ) or launches["tp"]["flash_attention_fwd"] != MESH_DEPTH or (
            launches["pp"]["flash_attention_fwd"] != 8 * MESH_DEPTH
        ):
            raise AssertionError(f"mesh launches {launches}")

        # ResNet-50 data parallel (global BatchNorm statistics) against
        # the step without a mesh.
        rn = {}
        for key, mesh in (("plain", None), ("dp", M.make_mesh())):
            step, bfn, state = TT.build_training(mesh=mesh, seed=SEED,
                                                 device="cuda")
            g = torch.Generator(device="cuda").manual_seed(SEED)
            images, labels = bfn(g, RESNET_DP_BATCH)
            state, loss = step(state, images, labels)
            rn[key] = float(loss)
            del step, state
            torch.cuda.empty_cache()
        rn_rel = abs(rn["dp"] - rn["plain"]) / abs(rn["plain"])
        if rn_rel > TRAIN_LOSS_REL:
            raise AssertionError(f"resnet dp: {rn} (rel {rn_rel})")

        # Every model and norm the reference trains under a mesh, with
        # cuDNN's deterministic algorithms, so that the two steps differ
        # only by the mesh path's arithmetic.
        vision = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for key, name, kw, size, batch, loss_impl in MESH_VISION:
                vision[key], launches[key] = mesh_vision_case(
                    torch, FL, FA, FX, name, kw, size, batch, loss_impl)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        fused = launches["resnet50_fused_block"]
        if (fused["fused_matmul_stats"], fused["affine_relu_matmul_stats"],
                fused["fused_xent_fwd"], fused["fused_xent_bwd"]) != (
                    RESNET50_BLOCKS, RESNET50_BLOCKS, 1, 1):
            raise AssertionError(f"mesh fused block launches {fused}")
    finally:
        dist.destroy_process_group()
    # resnet_main's spawned job path; its rank joins a group of its own.
    ranks_rec = run_resnet_main_ranks(torch)

    class _Errors(logging.Handler):
        lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    seen = _Errors()
    logging.getLogger("lm_main").addHandler(seen)
    try:
        rc = lm_main.main(["--mode", "ep", "--train-steps", "1"])
    finally:
        logging.getLogger("lm_main").removeHandler(seen)
    if rc != 2 or not any(">1 chip" in x for x in seen.lines):
        raise AssertionError(f"lm_main --mode ep on one card: rc {rc}, "
                             f"{seen.lines}")
    return {"phase": "mesh_modes", "backend": backend, "world": 1,
            **cfg, "loss_no_mesh": base, "loss_tolerance_rel": TRAIN_LOSS_REL,
            "modes": modes, "resnet50_dp_batch": RESNET_DP_BATCH,
            "resnet50_loss": rn, "resnet50_loss_rel": rn_rel,
            "vision": vision, "resnet_main_rank_main": ranks_rec,
            "lm_main_ep_rc": rc, "lm_main_ep_error": seen.lines[-1],
            "seconds": time.monotonic() - t_phase}, launches


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("mesh_serve", "device_plugin",
                                           "mesh_modes", "flash_mla"),
                        help="run this phase alone (the device line first)")
    only = parser.parse_args(argv).only
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
            flash_attention as FA,
            fused_conv3x3 as FC,
            fused_linear as FL,
            fused_xent as FX,
            paged_attention as PA,
            quant_matmul as QM,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(LOG_DIR, exist_ok=True)
    open(LOG_PATH, "w").close()

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
    wrappers = kernel_wrappers(PA, QM, FA, FX, FL, FC)
    if only == "device_plugin":
        emit({**run_device_plugin(torch, wrappers), "card": smi})
        print(smi, flush=True)
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    if only == "mesh_modes":
        emit({**run_mesh_modes(torch)[0], "card": smi})
        print(smi, flush=True)
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    if only == "mesh_serve":
        model = G.make_decoder(device="cuda", **CFG)
        model.init_random(torch.Generator().manual_seed(SEED))
        emit({**run_mesh_serve(torch, model,
                               torch.Generator().manual_seed(SEED + 1)),
              "card": smi})
        print(smi, flush=True)
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    global SMS
    SMS = props.multi_processor_count

    emit({"phase": "build", "seconds": _build.build_all(),
          "flags": list(_build.NVCC_FLAGS), "ptxas": _build.PTXAS})
    serialized = [x for v in _build.PTXAS.values() for x in v["serialized"]]
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    if only == "flash_mla":
        tgen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        k_mla = check_flash_mla(torch, FA, Timer(torch), tgen)
        emit({"phase": "train_kernels", "flash_attention_mla": k_mla,
              "card": smi})
        print(smi, flush=True)
        emit({"kernels": [kernel_line(rec, rec["launches"], *FLASH_MLA_SRC)
                          for rec in k_mla]})
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0

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
        # The Timer's floor: one launch of a one-element fill kernel.
        one = torch.empty(1, device="cuda")
        floor_ms = timer.ms(lambda: one.fill_(1.0))
    emit({"phase": "kernels", "paged_attention": [k_bf16, k_f32, k_int8],
          "int8_weight_matmul": k_qmm, "int8_matmul_shapes": qmm_shapes,
          "timer_floor_ms": floor_ms, "card": smi})

    model = G.make_decoder(device="cuda", **CFG)
    model.init_random(torch.Generator().manual_seed(SEED))
    engine_launches, engine_tps = {}, {}
    for quant in (False, True):
        base = None
        for mode in ENGINE_MODES:
            rec, launches = run_engine(
                torch, model, quant, torch.Generator().manual_seed(SEED + 1),
                mode, base,
            )
            engine_launches[(quant, mode)] = launches
            base = base or rec
            emit({**{k: v for k, v in rec.items() if k != "outs"},
                  "card": smi})
        engine_tps[quant] = base["tokens_per_s"]
    l_bf16, l_int8 = engine_launches[(False, "")], engine_launches[(True, "")]
    for quant in (False, True):
        rec = run_engine_tiers(torch, model, quant,
                               torch.Generator().manual_seed(SEED + 4))
        engine_launches[(quant, "_tiers")] = rec["returning_rows_launches"]
        emit({**rec, "card": smi})
    migrated = {}
    for quant in (False, True):
        migrated[quant] = run_engine_migrate(
            torch, model, quant, torch.Generator().manual_seed(SEED + 1),
            migrated[False][1] if quant else None)
    # Each layout refuses the other's blob: bf16 on a fresh engine, as
    # its phase ran before the int8 blob existed.
    rec, _, shared = migrated[False]
    rec["foreign_blob_refused"] = refuse_foreign_fresh(
        model, False, shared, migrated[True][1])
    for quant in (False, True):
        emit({**migrated[quant][0], "card": smi})
    emit({**run_engine_observe(torch, model,
                               torch.Generator().manual_seed(SEED + 1)),
          "card": smi})
    server_launches = {}
    for key, quant, wave in ((True, True, False), (False, False, False),
                             ("wave", True, True)):
        rec, server_launches[key] = run_server(
            torch, quant, engine_tps[quant],
            torch.Generator().manual_seed(SEED + 1), wave=wave)
        emit({**rec, "card": smi})
    emit({**run_server_predict(torch, torch.Generator().manual_seed(SEED + 5)),
          "card": smi})
    fleet_launches, fleet_outs, fleet_recs = {}, {}, {}
    for quant in (True, False):
        rec, fleet_launches[quant], fleet_outs[quant] = run_fleet_inproc(
            torch, model, quant, engine_tps[quant],
            torch.Generator().manual_seed(SEED + 1))
        fleet_recs[quant] = rec
        emit({**rec, "card": smi})
    # The process fleet and the server's fleets serve the int8 fleet's
    # traffic and must give its tokens.
    emit({**run_fleet_procs(torch, engine_tps[True], fleet_outs[True],
                            torch.Generator().manual_seed(SEED + 1),
                            fleet_recs[True]["replica_bytes"]),
          "card": smi})
    emit({**run_server_fleet(torch, engine_tps[True], fleet_outs[True][:8],
                             torch.Generator().manual_seed(SEED + 1)),
          "card": smi})
    serve_rec = run_mesh_serve(torch, model,
                               torch.Generator().manual_seed(SEED + 1))
    emit({**serve_rec, "card": smi})
    del model
    torch.cuda.empty_cache()
    emit({**run_health_nvml(torch), "card": smi})
    torch.cuda.empty_cache()
    dp_rec = run_device_plugin(torch, wrappers)
    emit({**dp_rec, "card": smi})

    tgen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    k_flash = check_flash(torch, FA, timer, tgen)
    torch.cuda.empty_cache()
    k_mla = check_flash_mla(torch, FA, timer, tgen)
    k_xent = check_xent(torch, FX, timer, tgen)
    emit({"phase": "train_kernels", "flash_attention": k_flash,
          "flash_attention_mla": k_mla, "fused_xent": k_xent, "card": smi})
    torch.cuda.empty_cache()
    train, l_train = run_train(torch, timer, tgen)
    emit({**train, "card": smi})
    torch.cuda.empty_cache()
    large, l_large = run_lm_large(torch, tgen)
    emit({**large, "card": smi})
    torch.cuda.empty_cache()

    vgen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    k_fl, faults = check_fused_matmul(torch, FL, timer, vgen)
    k_fc, more = check_conv3x3(torch, FC, timer, vgen)
    if faults + more:
        raise AssertionError(f"vision kernels: {faults + more}")
    emit({"phase": "vision_kernels", "fused_matmul": k_fl,
          "conv3x3": k_fc, "card": smi})
    torch.cuda.empty_cache()
    vision, l_vision = run_vision_train(torch, vgen)
    emit({**vision, "card": smi})
    torch.cuda.empty_cache()
    emit({**run_inception_train(torch, vgen), "card": smi})
    torch.cuda.empty_cache()
    emit({**run_checkpoint(torch), "card": smi})
    torch.cuda.empty_cache()
    moe, l_moe = run_moe_train(torch, tgen)
    emit({**moe, "card": smi})
    torch.cuda.empty_cache()
    mesh_rec, l_mesh = run_mesh_modes(torch)
    emit({**mesh_rec, "card": smi})

    kernels = []
    for rec, launches, source, replaces in (
        (k_bf16, l_bf16["paged_attention"], "paged_attention.cu",
         "paged_attention.py:93"),
        (k_int8, l_int8["paged_attention"], "paged_attention.cu",
         "paged_attention.py:93"),
        (k_qmm, l_int8["int8_weight_matmul"], "quant_matmul.cu",
         "quant_matmul.py:31"),
        (k_flash[0], l_train["flash_attention_fwd"], "flash_attention.cu",
         "flash_attention.py:112"),
        (k_flash[1], l_train["flash_attention_bwd"], "flash_attention.cu",
         "flash_attention.py:112"),
        (k_flash[2], l_train["flash_attention_fwd_d64"],
         "flash_attention.cu", "flash_attention.py:112"),
        (k_flash[3], l_train["flash_attention_bwd_d64"],
         "flash_attention.cu", "flash_attention.py:112"),
        (k_flash[4], l_train["flash_attention_fwd_d32"],
         "flash_attention.cu", "flash_attention.py:112"),
        (k_flash[5], l_train["flash_attention_bwd_d32"],
         "flash_attention.cu", "flash_attention.py:112"),
        (k_flash[6], l_train["flash_attention_fwd_d256"],
         "flash_attention.cu", "flash_attention.py:112"),
        (k_flash[7], l_train["flash_attention_bwd_d256"],
         "flash_attention.cu", "flash_attention.py:112"),
        (k_xent[0], l_train["fused_xent_fwd"], "fused_xent.cu",
         "fused_xent.py:34"),
        (k_xent[1], l_train["fused_xent_bwd"], "fused_xent.cu",
         "fused_xent.py:46"),
        (k_fl[0], l_vision["fused_matmul_stats"], "fused_linear.cu",
         "fused_linear.py:65"),
        (k_fl[1], l_vision["affine_relu_matmul_stats"], "fused_linear.cu",
         "fused_linear.py:65"),
        (k_fc[0], k_fc[0]["launches"], "fused_conv3x3.cu",
         "fused_conv3x3.py:55"),
        (k_fc[1], k_fc[1]["launches"], "fused_conv3x3.cu",
         "fused_conv3x3.py:55"),
        *((rec, rec["launches"], *FLASH_MLA_SRC) for rec in k_mla),
    ):
        kernels.append(kernel_line(rec, launches, source, replaces))
    # The serving kernels' launches on the fused and speculative engines'
    # requests runs (CUDA-graph replays counted call by call), the tier
    # phase's returning rows and the server phases.
    serving = {"paged_attention_bf16": (False, "paged_attention"),
               "paged_attention_int8": (True, "paged_attention"),
               "int8_weight_matmul": (True, "int8_weight_matmul")}
    for k in kernels:
        if k["name"] in serving:
            quant, op = serving[k["name"]]
            k["launches_fused"] = engine_launches[(quant, "_fused")][op]
            k["launches_spec"] = engine_launches[(quant, "_spec")][op]
            k["launches_tiers"] = engine_launches[(quant, "_tiers")][op]
            k["launches_server"] = server_launches[quant][op]
            k["launches_fleet"] = fleet_launches[quant][op]
            k["launches_mesh_serve"] = serve_rec["launches"][op]
            if op == "int8_weight_matmul":  # the bf16 engine's drafter
                k["launches_spec_bf16"] = engine_launches[(False, "_spec")][
                    op]
                k["launches_server_wave"] = server_launches["wave"][op]
    for k in kernels[3:5]:  # lm_large runs flash at head dim 128 too
        k["launches_lm_large"] = l_large[k["name"]]
    # The dp-mesh engine's prefill (phase 4e) runs flash only where the
    # decode model's attention resolves to it.
    kernels[3]["launches_mesh_serve"] = serve_rec["launches"][
        "flash_attention_fwd"]
    # The mesh paths (phases 10-11) at head dim 128: flash on the MoE LM
    # and dp / tp / pp, the fused loss on dp.
    for k in kernels[3:5] + kernels[11:13]:
        k["launches_moe_train"] = l_moe[k["name"]]
        for mode, counts in l_mesh.items():
            k[f"launches_mesh_{mode}"] = counts[k["name"]]
        if k["name"].startswith("flash") and k["launches_moe_train"] < 1:
            raise AssertionError(f"{k['name']} never ran in moe_train")
    # The fused block under the mesh (phase 11): B6 a step.
    for k in kernels[13:15]:
        for key, *_ in MESH_VISION:
            k[f"launches_mesh_{key}"] = l_mesh[key][k["name"]]
    # The device-plugin daemon (phase 4f) runs no kernel.
    for k in kernels:
        op = next(p for p in wrappers if k["name"].startswith(p))
        k["launches_device_plugin"] = dp_rec["launches"][op]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
