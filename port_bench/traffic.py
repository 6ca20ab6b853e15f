"""The one traffic generator: it reads a mix's parameters (a file under
port_bench/traffic/) and draws the requests, the arrivals or the
training batches' sizes from the seed.

Every seed gets the same multiset of sizes and gaps, in another order:
a distribution's n values are its quantiles at (k + 0.5) / n, k < n,
permuted by the seed (a closed loop draws them in rounds of one value a
client).  So seeds change which request comes when and the token ids,
never how much work there is.

Mix parameters:
  loop            "closed" (clients that each send their next request
                  when the last completes), "open" (arrivals at
                  `rate_per_s`, exponential gaps) or "steps" (training)
  clients         closed loop: clients, one a slot
  rate_per_s      open loop: the offered rate
  prompt_len      {"dist": "uniform", "lo", "hi"} or {"dist":
  output_len      "lognormal", "median", "sigma", "lo", "hi"}: token counts
  first_output_len  closed loop: the first round's outputs (a staggered
                  start, so completions are spread from the first second)
  system_prompts  {"count", "len", "zipf"}: shared prefixes, one chosen a
                  request with weight 1 / rank^zipf, ahead of the prompt
  lead_s, warm_s  seconds of traffic before the window (set-up)
  trace_s         seconds of the window a traced run traces
  check_requests  served requests the reference judges
  drain_s         seconds past the window's close to wait for the
                  answers due in it
  batch, seq_len, check_steps   training: the batch, and the steps the
                  reference follows
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

_NORMAL = statistics.NormalDist()


def _rng(seed, *tag):
    return np.random.default_rng([int(seed) % (1 << 64), *tag])


def quantiles(dist, n):
    """The distribution's values at (k + 0.5) / n, k < n, ascending."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["lo"], dist["hi"]
        return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)
    if kind == "lognormal":
        z = np.array([_NORMAL.inv_cdf(x) for x in u])
        v = np.rint(np.exp(math.log(dist["median"]) + dist["sigma"] * z))
        return np.clip(v, dist["lo"], dist["hi"]).astype(np.int64)
    if kind == "exponential":
        return -np.log1p(-u) / dist["rate"]
    raise ValueError(f"unknown distribution {kind!r}")


def zipf_counts(count, s, n):
    """How many of n draws go to each of `count` ranks, weights 1/r^s,
    by largest remainder."""
    w = 1.0 / np.arange(1, count + 1) ** s
    exact = w / w.sum() * n
    out = np.floor(exact).astype(np.int64)
    left = n - out.sum()
    out[np.argsort(-(exact - out), kind="stable")[:left]] += 1
    return out


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new: int
    shared: int = 0  # tokens of a shared prefix at the prompt's head


class Mix:
    """A traffic mix's parameters and the requests they give a seed."""

    def __init__(self, spec, vocab, seed):
        self.spec = spec
        self.vocab = int(vocab)
        self.seed = int(seed)
        sp = spec.get("system_prompts")
        rng = _rng(seed, 0)
        self.system = [] if not sp else [
            rng.integers(0, self.vocab, sp["len"], dtype=np.int32)
            for _ in range(sp["count"])]

    def _requests(self, tag, n, out_dist=None):
        """n requests drawn as one stratified block."""
        spec = self.spec
        rng = _rng(self.seed, 1, tag)
        plen = rng.permutation(quantiles(spec["prompt_len"], n))
        out = rng.permutation(quantiles(out_dist or spec["output_len"], n))
        if self.system:
            sp = spec["system_prompts"]
            pick = np.repeat(np.arange(len(self.system)),
                             zipf_counts(len(self.system), sp["zipf"], n))
            pick = rng.permutation(pick)
        reqs = []
        for i in range(n):
            user = rng.integers(0, self.vocab, int(plen[i]), dtype=np.int32)
            shared = 0
            if self.system:
                head = self.system[int(pick[i])]
                user = np.concatenate([head, user])
                shared = len(head)
            reqs.append(Request(user, int(out[i]), shared))
        return reqs

    def closed(self):
        """A closed loop's requests, endless: the first round (one a
        client) with `first_output_len` outputs, then rounds drawn from
        `output_len`."""
        n = self.spec["clients"]
        first = self.spec.get("first_output_len")
        yield from self._requests(0, n, first)
        rnd = 1
        while True:
            yield from self._requests(rnd, n)
            rnd += 1

    def open(self, lead_s, seconds):
        """[(due offset s, Request)] from the lead's start: round(rate x
        lead_s) arrivals spread over the lead, then round(rate x seconds)
        over the window, each block's gaps the exponential quantiles
        scaled to fill it exactly."""
        rate = self.spec["rate_per_s"]
        out, t0 = [], 0.0
        for tag, span in ((0, lead_s), (1, seconds)):
            n = int(round(rate * span))
            if n == 0:
                t0 += span
                continue
            gaps = _rng(self.seed, 2, tag).permutation(
                quantiles({"dist": "exponential", "rate": rate}, n))
            gaps *= span / gaps.sum()
            due = t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
            out += list(zip(due.tolist(), self._requests(10 + tag, n)))
            t0 += span
        return out
