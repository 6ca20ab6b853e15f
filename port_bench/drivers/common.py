"""What both drivers share: handing the benchmark's weights to the
program's modules, reading its leaves back by the benchmark's names,
and the outcome a driver returns to port_bench/run.py."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Optional

import torch

# The program's TransformerLM parameter names -> the benchmark's leaves
# (weights.make): per block `blocks.<i>.<suffix>`, else whole names.
BLOCK = {
    "ln0.scale": "ln0_g", "ln0.bias": "ln0_b",
    "qkv.kernel": "qkv_w", "qkv.bias": "qkv_b",
    "proj.kernel": "proj_w", "proj.bias": "proj_b",
    "ln1.scale": "ln1_g", "ln1.bias": "ln1_b",
    "fc0.kernel": "fc_w", "fc0.bias": "fc_b",
    "fc1.kernel": "out_w", "fc1.bias": "out_b",
}
WHOLE = {
    "embed": "wte", "pos_emb": "wpe", "ln_f.scale": "lnf_g",
    "ln_f.bias": "lnf_b", "head_kernel": "head_w", "head_bias": "head_b",
}


def leaf_of(name):
    """(leaf, layer or None) of a program parameter name."""
    if name in WHOLE:
        return WHOLE[name], None
    _, i, suffix = name.split(".", 2)
    return BLOCK[suffix], int(i)


def load_weights(model, W):
    """Copy the benchmark's weights into the program's model in place."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf, i = leaf_of(name)
            src = W[leaf] if i is None else W[leaf][i]
            p.copy_(src[: p.shape[0]] if leaf == "wpe" else src)


def leaves(model):
    """(leaf, layer or None, parameter) over the program's model."""
    for name, p in model.named_parameters():
        yield leaf_of(name) + (p,)


def note(t_start, msg):
    """A phase's time since the process started, on standard error."""
    print(f"[{time.monotonic() - t_start:9.3f} s] {msg}", file=sys.stderr,
          flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def peak_bytes(dev):
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


@dataclasses.dataclass
class Outcome:
    """What a driver hands run.py: the contract's fields, the numbers
    compared ([(name, value, limit)]), the end-to-end metrics by name,
    and `obs`, what the per-layer readers read (None in an untraced
    run)."""

    correct: bool
    attempted: int
    failed: int
    e2e: dict
    checks: list
    memory_peak_bytes: int
    obs: Optional[dict] = None
    readings: dict = dataclasses.field(default_factory=dict)
