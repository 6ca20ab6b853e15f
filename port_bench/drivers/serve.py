"""Driver of the `serve` configurations: the program's
ContinuousBatchingEngine under a closed or an open loop of requests.

Set-up: the weights drawn on the device from the seed and copied into
the program's decode model; the engine as the configuration's `engine`
settings give it; a warm-up (one request a prompt bucket of the mix,
then one that runs every fused block width, so each CUDA graph is
captured); the mix's shared system prompts admitted once, as a replica
holds them hot; and the mix's own traffic for `warm_s` (closed loop) or
`lead_s` (open loop).

Window: requests go through `submit_nowait(..., on_token=...)`; each
streamed token is stamped on the host's clock as the engine hands it
over.  A closed loop's client sends its next request when the last one
completes; an open loop submits each request at its due time, and its
latency counts from then.  A traced run traces the window's first
`trace_s`.

After the window: the engine is closed and freed, and the plain
reference judges a sample, drawn from the seed, of the finished requests
with the longest among them (reference.gpt2.served_gaps).
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from .. import stats, traffic, weights
from ..reference import compare, gpt2
from ..trace import Tracer
from . import common


class Req:
    __slots__ = ("prompt", "max_new", "shared", "due", "toks", "times",
                 "t_done", "error", "handle")

    def __init__(self, r, due):
        self.prompt, self.max_new, self.shared = r.prompt, r.max_new, r.shared
        self.due = due
        self.toks, self.times = [], []
        self.t_done = self.error = self.handle = None

    def on_token(self, _row, tok):
        self.times.append(time.monotonic())
        self.toks.append(int(tok))

    @property
    def finished(self):
        return (self.t_done is not None and self.error is None
                and len(self.toks) == self.max_new)


def _submit(eng, r, done):
    """Submit `r`; `done(r)` runs on the engine's thread when it resolves
    (or here, at once, if the engine refused it)."""

    def resolved():
        r.t_done = time.monotonic()
        r.error = r.handle.error
        done(r)

    try:
        r.handle = eng.submit_nowait(r.prompt, r.max_new,
                                     on_token=r.on_token)
    except Exception as e:  # pylint: disable=broad-except
        # A refused request (a full queue) counts as failed.
        r.t_done, r.error = time.monotonic(), e
        done(r)
        return
    r.handle.add_done_callback(resolved)


class ClosedLoop:
    """`clients` clients; each sends its next request when its last one
    completes (a feeder thread submits, as a done callback may not call
    back into the engine)."""

    def __init__(self, eng, stream, clients, reqs):
        self.eng, self.stream, self.clients = eng, stream, clients
        self.reqs, self.q, self.stopping = reqs, queue.Queue(), False
        self.thread = threading.Thread(target=self._feed, daemon=True)

    def _next(self):
        r = Req(next(self.stream), time.monotonic())
        self.reqs.append(r)
        _submit(self.eng, r, self.q.put)

    def start(self):
        for _ in range(self.clients):
            self._next()
        self.thread.start()

    def _feed(self):
        while self.q.get() is not None:
            if not self.stopping:
                self._next()

    def stop(self):
        self.stopping = True
        self.q.put(None)
        self.thread.join()


class OpenLoop:
    """Each request submitted at its due time, from one thread."""

    def __init__(self, eng, schedule, t_base, reqs):
        self.eng, self.schedule, self.t_base = eng, schedule, t_base
        self.reqs, self.stopping, self.late_s = reqs, False, 0.0
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()

    def _run(self):
        for off, rq in self.schedule:
            due = self.t_base + off
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            if self.stopping:
                return
            r = Req(rq, due)
            self.late_s = max(self.late_s, time.monotonic() - due)
            self.reqs.append(r)
            _submit(self.eng, r, lambda _r: None)

    def stop(self):
        self.stopping = True
        self.thread.join()


def _wait(cond, timeout):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            return False
        time.sleep(0.01)
    return True


class Serve:
    def __init__(self, cfg, mix, seed, device="cuda", t_start=None):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.dev = torch.device(device)
        self.t_start = time.monotonic() if t_start is None else t_start
        self.reqs = []
        self.eng = self.model = self.loop = None

    # -- set-up --------------------------------------------------------
    def setup(self):
        from container_engine_accelerators_tpu_torch.models import (
            generate as G)
        from container_engine_accelerators_tpu_torch.serving import (
            ContinuousBatchingEngine)

        cfg, e = self.cfg, self.cfg["engine"]
        W = weights.make(cfg, self.seed, self.dev, torch.bfloat16)
        self.model = G.make_decoder(
            vocab=cfg["vocab_size"], dim=cfg["n_embd"],
            depth=cfg["n_layer"], heads=cfg["n_head"],
            max_seq=cfg["n_positions"], dtype=torch.bfloat16,
            device=self.dev)
        common.load_weights(self.model, W)
        del W
        common.free(self.dev)
        common.reset_peak(self.dev)
        common.note(self.t_start, "weights loaded")
        self.eng = ContinuousBatchingEngine(
            self.model, e["slots"], quant=e["quant"],
            prompt_grid=e["prompt_grid"], prefill_chunk=e["prefill_chunk"],
            paged=True, page_size=e["page_size"], kv_pages=e["kv_pages"],
            prefix_cache=e["prefix_cache"], decode_steps=e["decode_steps"],
            spec_k=e["spec_k"], max_queue=e["max_queue"],
            rng_seed=self.seed % (1 << 31), observe=e["observe"],
            device=self.dev)
        self.stream = traffic.Mix(self.mix, cfg["vocab_size"], self.seed)
        self._warm_shapes()
        for head in self.stream.system:
            self.eng.submit(head, 1, timeout=600)
        common.note(self.t_start, "engine warm")

    def _warm_shapes(self):
        """One request a prompt bucket the mix reaches, then one a fused
        block width (2, 4, ..., decode_steps), so each width's CUDA graph
        is captured before the window."""
        e, eng = self.cfg["engine"], self.eng
        rng = np.random.default_rng([self.seed % (1 << 64), 9])
        top = self.mix["prompt_len"]["hi"] + max(
            (len(h) for h in self.stream.system), default=0)
        edge, buckets = e["prompt_grid"], []
        while True:
            buckets.append(min(edge, self.cfg["n_positions"] - 2))
            if edge >= top or edge >= self.cfg["n_positions"]:
                break
            edge *= 2
        for plen in buckets:
            eng.submit(rng.integers(0, self.cfg["vocab_size"], plen), 2,
                       timeout=600)
        # The engine picks a block's width from the committed tokens, so
        # a lone request of 1 + w tokens runs one block of width w.
        widths, w = [], 2
        while w < e["decode_steps"]:
            widths.append(w)
            w *= 2
        if e["decode_steps"] > 1:
            widths.append(e["decode_steps"])
        for w in widths:
            eng.submit(rng.integers(0, self.cfg["vocab_size"], 64), 1 + w,
                       timeout=600)

    # -- the window ----------------------------------------------------
    def window(self, seconds, trace=False):
        mix, eng = self.mix, self.eng
        tracer = Tracer(torch, self.dev) if trace else None
        if mix["loop"] == "closed":
            self.loop = ClosedLoop(eng, self.stream.closed(), mix["clients"],
                                   self.reqs)
            self.loop.start()
            time.sleep(mix.get("warm_s", 0))
            t0 = time.monotonic()
        else:
            lead = mix.get("lead_s", 0)
            sched = self.stream.open(lead, seconds)
            t_base = time.monotonic()
            self.loop = OpenLoop(eng, sched, t_base, self.reqs)
            self.loop.start()
            t0 = t_base + lead
            time.sleep(max(0.0, t0 - time.monotonic()))
        self.setup_s = t0 - self.t_start
        common.note(self.t_start, "window open")
        t1 = t0 + seconds
        obs = None
        if tracer is not None:
            tracer.start()
            common.note(self.t_start, "trace started")
            a, snap_a = tracer.t0, eng.snapshot()
            time.sleep(max(0.0, min(mix["trace_s"], seconds)
                           - (time.monotonic() - a)))
            tracer.stop()
            b, snap_b = tracer.t1, eng.snapshot()
            common.note(self.t_start, "trace stopped")
            obs = {"a": a, "b": b, "counters": {
                k: snap_b[k] - snap_a[k] for k in snap_a
                if isinstance(snap_a[k], (int, float))}}
        time.sleep(max(0.0, t1 - time.monotonic()))
        t1 = max(t1, time.monotonic())
        due = [r for r in self.reqs if t0 <= r.due < t1]
        if mix["loop"] == "closed":
            self.loop.stop()
        else:
            _wait(lambda: all(r.t_done is not None for r in due),
                  mix.get("drain_s", 60))
            self.loop.stop()
            print(f"open loop: latest submit {self.loop.late_s * 1e3:.3f} ms"
                  " after its due time", file=sys.stderr)
        self.peak = common.peak_bytes(self.dev)
        self.t0, self.t1, self.due = t0, t1, due
        common.note(self.t_start, "window closed")
        if obs is not None:
            obs.update(self._work(obs["a"], obs["b"]))
            obs["trace"] = tracer.trace()
            common.note(self.t_start, f"trace read: {len(obs['trace'].ops)} "
                        "device operations")
        return obs

    def _work(self, a, b):
        """What the requests needed in [a, b): the visible context of each
        generated token after the first (one paged step each), and the
        prompt positions each first token's admission ran (a shared
        prefix is taken as served from the cache)."""
        e, ctx, prefills, out = self.cfg["engine"], [], [], 0
        page, grid = e["page_size"], e["prompt_grid"]
        for r in self.reqs:
            plen = len(r.prompt)
            for k, t in enumerate(r.times):
                if a <= t < b:
                    out += 1
                    if k == 0:
                        start = (min(r.shared // page * page, plen - 1)
                                 // grid * grid) if r.shared else 0
                        prefills.append((start, plen))
                    else:
                        ctx.append(plen + k)
        return {"window_s": b - a, "decode_ctx": ctx, "prefills": prefills,
                "out_tokens": out}

    def metrics(self):
        t0, t1 = self.t0, self.t1
        tokens, gaps = 0, []
        for r in self.reqs:
            for k, t in enumerate(r.times):
                if t0 <= t < t1:
                    tokens += 1
                    if k:
                        gaps.append(t - r.times[k - 1])
        e2e = {"setup_s": self.setup_s,
               "out_tok_s": tokens / (t1 - t0)}
        if gaps:
            e2e["itl_p95_ms"] = stats.percentile(gaps, 95) * 1e3
        if self.mix["loop"] == "open":
            ttft = [r.times[0] - r.due if r.times and r.error is None
                    else float("inf") for r in self.due]
            if ttft:
                e2e["ttft_p95_ms"] = stats.percentile(ttft, 95) * 1e3
            attempted = len(self.due)
            failed = sum(1 for r in self.due if not r.finished)
        else:
            ended = [r for r in self.reqs
                     if r.t_done is not None and t0 <= r.t_done < t1]
            attempted = len(ended)
            failed = sum(1 for r in ended if r.error is not None)
        return e2e, attempted, failed

    def close(self):
        if self.eng is not None:
            self.eng.close()
        self.eng = self.model = None
        common.free(self.dev)

    # -- the check -----------------------------------------------------
    def sample(self):
        """The finished requests the reference judges: the longest, and
        others drawn from the seed."""
        done = [r for r in self.reqs if r.finished]
        if not done:
            return []
        n = min(self.mix["check_requests"], len(done))
        longest = max(range(len(done)),
                      key=lambda i: (len(done[i].toks), len(done[i].prompt)))
        rest = [i for i in range(len(done)) if i != longest]
        rng = np.random.default_rng([self.seed % (1 << 64), 3])
        pick = rng.choice(len(rest), n - 1, replace=False) if n > 1 else []
        return [done[longest]] + [done[rest[i]] for i in sorted(pick)]

    def check(self, control=False):
        """[(name, value, limit)], correct, and the readings."""
        sample = self.sample()
        if not sample:
            return [("gap", float("inf"),
                     self.cfg["check"]["gap"])], False, {}
        gpt2.strict_fp32()
        W = gpt2.as_f32(weights.make(self.cfg, self.seed, self.dev,
                                     torch.bfloat16))
        gaps, cgaps = [], []
        for r in sample:
            g, c = gpt2.served_gaps(W, self.cfg, r.prompt, r.toks,
                                    control=control)
            gaps.append(g)
            cgaps.append(c)
        del W
        common.free(self.dev)
        common.note(self.t_start, "reference done")
        readings = {"gap": max(gaps), "tokens": sum(len(r.toks)
                                                     for r in sample),
                    "requests": len(sample)}
        if control:
            readings["control_gap"] = max(cgaps)
        rows, ok = compare.judged({"gap": max(gaps)},
                                  {"gap": self.cfg["check"]["gap"]})
        return rows, ok, readings


def run(cfg, mix, seed, seconds, trace, device="cuda", t_start=None,
        control=False):
    cell = Serve(cfg, mix, seed, device, t_start)
    try:
        cell.setup()
        obs = cell.window(seconds, trace)
        e2e, attempted, failed = cell.metrics()
    finally:
        cell.close()
    if obs is not None:
        obs["model"] = cfg
    rows, ok, readings = cell.check(control)
    return common.Outcome(
        correct=ok, attempted=attempted, failed=failed, e2e=e2e,
        checks=rows, memory_peak_bytes=cell.peak, obs=obs,
        readings=readings)
