"""Driver of the `train` configurations: the program's
`build_lm_training` step, back to back on fresh batches.

Set-up builds the one training object (model, AdamW state, step_fn) as
the configuration's `trainer` settings give it, copies the weights drawn
on the device from the seed into its f32 masters, and drives it through
its first `check_steps` steps through the window's own call and feed
(batches of token ids drawn on the device from the seed; every row
differs).  Those steps warm every kernel up and give the program's
readings: each step's loss, the first step's gradient a leaf as AdamW
got it (its first moment after one step over 1 - beta1), and each leaf's
change after the steps.  The same object then runs the window.

The window: steps until `--seconds` have passed on the host's clock,
fenced by a synchronise at both ends; `train_step_ms` is the window over
the steps completed.  A traced run traces its first `trace_s`.

After the window the program's state is freed and the plain reference
follows the same first steps from the same weights and batches in
float32 (reference.gpt2.train_readings), in blocks of sequences.
"""

from __future__ import annotations

import time

import torch

from .. import weights
from ..reference import compare, gpt2
from ..trace import Tracer
from . import common


def batches(cfg, mix, seed, device):
    """The endless feed: (tokens, targets) of `batch` x `seq_len`, from a
    generator on the device seeded from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 1) % (1 << 63))
    b, s = mix["batch"], mix["seq_len"]
    while True:
        tok = torch.randint(0, cfg["vocab_size"], (b, s + 1), generator=gen,
                            device=device)
        yield tok[:, :-1], tok[:, 1:]


class Train:
    def __init__(self, cfg, mix, seed, device="cuda", t_start=None):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.dev = torch.device(device)
        self.t_start = time.monotonic() if t_start is None else t_start
        self.state = None

    def setup(self):
        from container_engine_accelerators_tpu_torch.models.transformer \
            import build_lm_training

        cfg, tr, mix = self.cfg, self.cfg["trainer"], self.mix
        self.step_fn, self.state, _ = build_lm_training(
            vocab=cfg["vocab_size"], dim=cfg["n_embd"], depth=cfg["n_layer"],
            heads=cfg["n_head"], seq_len=mix["seq_len"], batch=mix["batch"],
            learning_rate=tr["learning_rate"], attn_impl=tr["attn_impl"],
            loss_impl=tr["loss_impl"], head_impl=tr["head_impl"],
            dtype=torch.bfloat16, device=self.dev)
        model = self.state["model"]
        W = weights.make(cfg, self.seed, self.dev, torch.float32)
        common.load_weights(model, W)
        del W
        common.free(self.dev)
        common.reset_peak(self.dev)
        self.feed = batches(cfg, mix, self.seed, self.dev)
        opt = self.state["opt"]
        beta1 = opt.param_groups[0]["betas"][0]
        losses, grad = [], None
        for _ in range(mix["check_steps"]):
            self.state, loss = self.step_fn(self.state, *next(self.feed))
            losses.append(float(loss))
            if grad is None:
                # A step that left no moment behind got no gradient.
                grad = {}
                for leaf, i, p in common.leaves(model):
                    m = opt.state.get(p, {}).get("exp_avg")
                    grad.update(gpt2.part_norms(
                        leaf, i, torch.zeros_like(p) if m is None
                        else m / (1 - beta1)))
        W0 = weights.make(cfg, self.seed, self.dev, torch.float32)
        change = {}
        for leaf, i, p in common.leaves(model):
            w0 = W0[leaf] if i is None else W0[leaf][i]
            change.update(gpt2.part_norms(leaf, i, p - w0[: p.shape[0]]))
        self.readings = {"loss": losses, "grad": grad, "change": change}
        # The allocator keeps W0's blocks cached (no empty_cache), so the
        # window's first steps call no cudaMalloc.
        del W0
        common.note(self.t_start, f"{len(losses)} steps read: {losses}")

    def window(self, seconds, trace=False):
        tracer = Tracer(torch, self.dev) if trace else None
        common.sync(self.dev)
        t0 = time.monotonic()
        self.setup_s = t0 - self.t_start
        common.note(self.t_start, "window open")
        n, obs = 0, None
        if tracer is not None:
            tracer.start()
        while True:
            self.state, _ = self.step_fn(self.state, *next(self.feed))
            n += 1
            now = time.monotonic()
            if tracer is not None and obs is None and (
                    now - tracer.t0 >= self.mix["trace_s"]
                    or now - t0 >= seconds):
                tracer.stop()
                obs = {"window_s": tracer.t1 - tracer.t0, "steps": n}
            if now - t0 >= seconds:
                break
        common.sync(self.dev)
        self.t1 = time.monotonic()
        self.t0, self.steps = t0, n
        self.peak = common.peak_bytes(self.dev)
        common.note(self.t_start, f"window closed after {n} steps")
        if obs is not None:
            obs["trace"] = tracer.trace()
            common.note(self.t_start, f"trace read: {len(obs['trace'].ops)} "
                        "device operations")
        return obs

    def metrics(self):
        return {"setup_s": self.setup_s,
                "train_step_ms": (self.t1 - self.t0) / self.steps * 1e3}

    def close(self):
        self.state = self.step_fn = self.feed = None
        common.free(self.dev)

    def reference(self, mm=torch.matmul, half_batch=False):
        gpt2.strict_fp32()
        W = weights.make(self.cfg, self.seed, self.dev, torch.float32)
        feed = batches(self.cfg, self.mix, self.seed, self.dev)
        steps = [next(feed) for _ in range(self.mix["check_steps"])]
        tr = self.cfg["trainer"]
        out = gpt2.train_readings(W, self.cfg, steps, tr["adamw"],
                                  tr["reference_micro_batch"], mm=mm,
                                  half_batch=half_batch)
        del W, steps
        common.free(self.dev)
        return out

    def check(self, control=False):
        want = self.reference()
        common.note(self.t_start, "reference done")
        gaps = compare.training_gaps(self.readings, want)
        rows, ok = compare.judged(gaps, self.cfg["check"])
        readings = {"program": gaps}
        if control:
            readings["control"] = compare.training_gaps(
                self.reference(mm=gpt2.fp8_mm), want)
            readings["half_batch"] = compare.training_gaps(
                self.reference(half_batch=True), want)
        return rows, ok, readings


def run(cfg, mix, seed, seconds, trace, device="cuda", t_start=None,
        control=False):
    cell = Train(cfg, mix, seed, device, t_start)
    try:
        cell.setup()
        obs = cell.window(seconds, trace)
        e2e = cell.metrics()
    finally:
        cell.close()
    if obs is not None:
        obs["model"] = cfg
        obs["batch"], obs["seq_len"] = mix["batch"], mix["seq_len"]
    rows, ok, readings = cell.check(control)
    return common.Outcome(
        correct=ok, attempted=cell.steps, failed=0, e2e=e2e, checks=rows,
        memory_peak_bytes=cell.peak, obs=obs, readings=readings)
