"""Driver of the `train_moe` configurations: the program's
`build_mla_moe_training` step (the DeepSeek-V3-style decoder, one
expert-parallel rank's share), back to back on fresh batches.

Set-up draws the weights on the device from the seed
(weights_moonlight.py) and hands them to the one training object
(model, AdamW state, step_fn) as the configuration's `trainer` settings
give it, then drives it through its first `check_steps` steps through
the window's own call and feed (batches of token ids drawn on the device
from the seed over the vocabulary slice; every row differs).  Those
steps warm every kernel up and give the program's readings: each step's
loss and balance loss, the first step's gradient a leaf as AdamW got it
(its first moment after one step over 1 - beta1), each leaf's change and
each MoE layer's correction bias after the steps, and the expert choices
each step's forward made.  The same object then runs the window.

The window: steps until `--seconds` have passed on the host's clock,
fenced by a synchronise at both ends; `train_step_ms` is the window over
the steps completed.  A traced run traces its first `trace_s` and reads
the model's expert counters (`moe_counters`) at the trace's ends.

After the window the program's state is freed and the plain reference
(reference/moonlight.py) follows the same first steps from the same
weights and batches in float32, in blocks of sequences, routing each
token as the program did: the loss, balance, gradient, change and bias
gaps judge the arithmetic, and `route_agree` (the share of the
program's routes the reference's own scores pick too) the routing.
"""

from __future__ import annotations

import time

import torch

from .. import weights_moonlight
from ..reference import compare, moonlight
from ..trace import Tracer
from . import common
from .train import batches


def _model_cfg(cfg):
    return {k: v for k, v in cfg.items() if k not in (
        "name", "kind", "source", "reduced", "source_values", "assumed",
        "deployment", "trainer", "check")}


def _gaps(got, want, gamma, agree):
    """The numbers `correct` compares: compare.training_gaps' loss, grad
    and change, the balance loss's widest relative gap over the steps,
    the correction biases' widest gap in steps of gamma, and the route
    agreement `agree`."""
    gaps = compare.training_gaps(got, want)
    gaps["balance"] = max(abs(a - b) / abs(b) for a, b in zip(
        got["balance"], want["balance"]))
    gaps["bias"] = max(float((got["bias"][i] - b).abs().max()) / gamma
                       for i, b in want["bias"].items())
    gaps["route_agree"] = agree
    return gaps


def judged(gaps, limits):
    """[(name, value, limit)] and whether all hold: each limit an upper
    one but `route_agree_min`, a lower one on `route_agree`."""
    upper = {k: v for k, v in limits.items() if k != "route_agree_min"}
    rows, ok = compare.judged(gaps, upper)
    floor = float(limits["route_agree_min"])
    rows.append(("route_agree", float(gaps["route_agree"]), floor))
    return rows, ok and gaps["route_agree"] >= floor


class TrainMoE:
    def __init__(self, cfg, mix, seed, device="cuda", t_start=None):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.model_cfg = _model_cfg(cfg)
        self.dev = torch.device(device)
        self.t_start = time.monotonic() if t_start is None else t_start
        self.state = None

    def setup(self):
        from container_engine_accelerators_tpu_torch.models.mla_moe_lm \
            import build_mla_moe_training

        cfg, tr, mix = self.cfg, self.cfg["trainer"], self.mix
        W = weights_moonlight.make(cfg, self.seed, self.dev)
        self.step_fn, self.state, _ = build_mla_moe_training(
            self.model_cfg, seq_len=mix["seq_len"], batch=mix["batch"],
            learning_rate=tr["learning_rate"], attn_impl=tr["attn_impl"],
            balance_alpha=tr["balance_alpha"],
            bias_update_speed=tr["bias_update_speed"], dtype=torch.bfloat16,
            device=self.dev, params=W)
        del W
        model = self.model = self.state["model"]
        layers = model.expert_layers()
        common.free(self.dev)
        common.reset_peak(self.dev)
        self.feed = batches(cfg, mix, self.seed, self.dev)
        opt = self.state["opt"]
        beta1 = opt.param_groups[0]["betas"][0]
        for m in layers:
            m.record = []
        losses, balances, grad = [], [], None
        for _ in range(mix["check_steps"]):
            self.state, loss = self.step_fn(self.state, *next(self.feed))
            losses.append(float(loss))
            balances.append(float(model.balance_loss().detach()))
            if grad is None:
                # A step that left no moment behind got no gradient.
                grad = moonlight.leaf_norms({
                    n: torch.zeros_like(p) if opt.state.get(p, {}).get(
                        "exp_avg") is None
                    else opt.state[p]["exp_avg"] / (1 - beta1)
                    for n, p in model.named_parameters()})
        moe = moonlight.moe_layers(cfg)
        routes = [{i: m.record[n] for i, m in zip(moe, layers)}
                  for n in range(mix["check_steps"])]
        for m in layers:
            m.record = None
        W0 = weights_moonlight.make(cfg, self.seed, self.dev)
        change = moonlight.leaf_norms({n: p.detach() - W0[n]
                                       for n, p in model.named_parameters()})
        self.readings = {
            "loss": losses, "balance": balances, "grad": grad,
            "change": change, "routes": routes,
            "bias": {i: m.bias.clone() for i, m in zip(moe, layers)}}
        # The allocator keeps W0's blocks cached (no empty_cache), so the
        # window's first steps call no cudaMalloc.
        del W0
        common.note(self.t_start, f"{len(losses)} steps read: {losses}")

    def window(self, seconds, trace=False):
        tracer = Tracer(torch, self.dev) if trace else None
        before = self.model.moe_counters() if trace else None
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
                after = self.model.moe_counters()
                obs = {"window_s": tracer.t1 - tracer.t0, "steps": n,
                       "counters": {k: after[k] - before[k]
                                    for k in after}}
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
        self.state = self.step_fn = self.feed = self.model = None
        common.free(self.dev)

    def reference(self, mm=torch.matmul):
        moonlight.strict_fp32()
        W = weights_moonlight.make(self.cfg, self.seed, self.dev)
        feed = batches(self.cfg, self.mix, self.seed, self.dev)
        steps = [next(feed) for _ in range(self.mix["check_steps"])]
        out = moonlight.train_readings(W, self.cfg, steps,
                                       self.cfg["trainer"],
                                       self.readings["routes"], mm=mm)
        del W, steps
        common.free(self.dev)
        return out

    def check(self, control=False):
        want = self.reference()
        common.note(self.t_start, "reference done")
        gamma = self.cfg["trainer"]["bias_update_speed"]
        gaps = _gaps(self.readings, want, gamma, want["route_agree"])
        rows, ok = judged(gaps, self.cfg["check"])
        readings = {"program": gaps}
        if control:
            # The fp8 reference in the program's place: its route
            # agreement, the share of the program's routes its own
            # scores pick.
            ctrl = self.reference(mm=moonlight.fp8_mm)
            readings["control"] = _gaps(ctrl, want, gamma,
                                        ctrl["route_agree"])
            readings["control_correct"] = judged(readings["control"],
                                                 self.cfg["check"])[1]
        return rows, ok, readings


def run(cfg, mix, seed, seconds, trace, device="cuda", t_start=None,
        control=False):
    cell = TrainMoE(cfg, mix, seed, device, t_start)
    try:
        cell.setup()
        obs = cell.window(seconds, trace)
        e2e = cell.metrics()
    finally:
        cell.close()
    if obs is not None:
        obs["model"] = cell.model_cfg
        obs["batch"], obs["seq_len"] = mix["batch"], mix["seq_len"]
    rows, ok, readings = cell.check(control)
    return common.Outcome(
        correct=ok, attempted=cell.steps, failed=0, e2e=e2e, checks=rows,
        memory_peak_bytes=cell.peak, obs=obs, readings=readings)
