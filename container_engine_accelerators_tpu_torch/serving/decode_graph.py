"""Fused multi-step decode blocks, one CUDA graph per block width: the
port's counterpart of the reference's per-bucket
`jax.jit(..., static_argnums=(8,))` fused seam
(container_engine_accelerators_tpu/serving/engine.py:1023-1045).

The reference compiles one XLA program per width k of the block ladder
(lax.scan over k paged decode steps) and dispatches it with one call.
Here the seam is a Python loop of k steps (models/generate.py
`paged_decode_steps`, models/quant_generate.py
`quant_paged_engine_decode_steps`), hundreds of kernel launches a block.
On the card each width is captured once into a `torch.cuda.CUDAGraph`,
and every later block of that width is one `replay()`: the whole block
launches at once, with no Python between its kernels.  On the CPU the
seam is called directly.

What capture asks of the seam and of this holder:
  - warm-up: one eager block of each width runs on a side stream before
    its capture, with every row inactive (its writes land in the null
    page 0), so the kernels' nvcc build and ctypes binding
    (ops/_build.py), their one-time shared-memory attributes and
    cuBLAS's handle set-up happen outside the capture;
  - static buffers: the block's inputs (tok, pos, active, block tables,
    temperatures) are device buffers owned here and filled with `copy_`
    from the caller's staging before each replay; the (B, k) token
    output is the graph's own buffer, which the next replay of that
    width overwrites (the engine reads a block back before it
    dispatches the next one);
  - the cache and the weights: the graph holds their addresses, so a
    replay checks that they are the objects it captured and raises
    otherwise; `reset()` drops every graph, and the engine calls it
    before it builds a fresh cache (revive);
  - the generator: the engine's torch.Generator is registered with each
    graph, so sampling draws fresh noise on every replay;
  - no host sync inside the seam: the steps take per-row positions only;
  - threads: capture runs on the calling (scheduler) thread with
    capture_error_mode="thread_local", and every width shares one
    memory pool;
  - launch counters: the kernel wrappers count in Python, so they see
    the capture and not the replays; the capture's counts are taken
    back, and each replay adds the calls it replays.

There is no fallback: a failed capture or replay raises to the caller
(the engine's retry / crash path) and never runs the eager loop.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from ..ops.paged_attention import paged_attention
from ..ops.quant_matmul import int8_weight_matmul

# The kernel wrappers whose `launches` counters a replay advances.
COUNTED = (paged_attention, int8_weight_matmul)
INPUTS = ("tok", "pos", "active", "bt", "temps")


class _Block:
    __slots__ = ("graph", "out", "launches")

    def __init__(self, graph, out, launches):
        self.graph = graph
        self.out = out
        self.launches = launches


class FusedDecode:
    """Runs `seam(weights, cache, tok, pos, active, bt, temps, generator,
    n)` -> (cache, toks (B, n)) for block width n: directly on the CPU,
    as a replay of the width's CUDA graph on the card.

    `captures` records each capture: {"width", "warmup_s", "capture_s",
    "pool_bytes"} (pool_bytes: the growth of the allocator's reserved
    memory over the capture, the width's share of the shared pool)."""

    def __init__(self, seam: Callable, generator: torch.Generator,
                 device: torch.device):
        self._seam = seam
        self._gen = generator
        self.device = torch.device(device)
        self._blocks: Dict[int, _Block] = {}
        self._static: Dict[str, torch.Tensor] = {}
        self._pool = None
        self._bound = None  # (weights, cache) the graphs captured
        self.captures: list = []

    @property
    def widths(self):
        return sorted(self._blocks)

    def reset(self) -> None:
        """Drop every graph, its pool and its static buffers (before the
        cache they point at is replaced)."""
        self._blocks.clear()
        self._static.clear()
        self._pool = None
        self._bound = None

    def run(self, weights, cache, inputs: Dict[str, torch.Tensor], n: int):
        """One block of width n from the host `inputs` (INPUTS, pinned on
        the card).  Returns (cache, toks (B, n) int32 on the device)."""
        if self.device.type != "cuda":
            return self._seam(
                weights, cache, *(inputs[k] for k in INPUTS), self._gen, n
            )
        if self._bound is not None and (
            self._bound[0] is not weights or self._bound[1] is not cache
        ):
            raise RuntimeError(
                "fused-decode graphs hold other weights or another cache: "
                "reset() them before either is replaced"
            )
        block = self._blocks.get(n) or self._capture(weights, cache,
                                                     inputs, n)
        for k in INPUTS:
            self._static[k].copy_(inputs[k], non_blocking=True)
        block.graph.replay()
        for fn, n_calls in block.launches:
            fn.launches += n_calls
        return cache, block.out

    def _capture(self, weights, cache, inputs, n):
        if self._bound is None:
            self._bound = (weights, cache)
            self._static = {
                k: torch.empty_like(inputs[k], device=self.device)
                for k in INPUTS
            }
            self._pool = torch.cuda.graph_pool_handle()
        st = self._static
        for k in INPUTS:
            st[k].zero_()  # every row inactive: the warm-up writes page 0
        t0 = time.monotonic()
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._seam(weights, cache, *(st[k] for k in INPUTS),
                       self._gen, n)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        t1 = time.monotonic()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = [fn.launches for fn in COUNTED]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                _, out = self._seam(weights, cache,
                                    *(st[k] for k in INPUTS), self._gen, n)
        finally:
            captured = [fn.launches - b for fn, b in zip(COUNTED, before)]
            for fn, b in zip(COUNTED, before):
                fn.launches = b  # the capture launched nothing
        block = _Block(graph, out, [
            (fn, c) for fn, c in zip(COUNTED, captured) if c
        ])
        self._blocks[n] = block
        self.captures.append({
            "width": n,
            "warmup_s": t1 - t0,
            "capture_s": time.monotonic() - t1,
            "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved,
        })
        return block
