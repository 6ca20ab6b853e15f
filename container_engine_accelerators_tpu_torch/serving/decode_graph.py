"""The engine's multi-token seams as CUDA graphs, one graph per static
key: the port's counterpart of the reference's `jax.jit` seams that
compile one XLA program per static argument
(container_engine_accelerators_tpu/serving/engine.py): the fused block
(:1023-1045, one program per width), the speculative draft chain
(:1087, one per width) and the verify window (:847-990, one per width
and value of the static `greedy`, with or without top-k / top-p
operands).

Each seam is a Python loop of decode passes (models/generate.py,
models/quant_generate.py), hundreds of kernel launches a call.  On the
card each key is captured once into a `torch.cuda.CUDAGraph`, and every
later call with that key is one `replay()`: the whole call launches at
once, with no Python between its kernels.  On the CPU the seam is called
directly.

What capture asks of the seam and of this holder:
  - first call: the first call of a key runs the seam eagerly, on a side
    stream and on the call's real inputs, and its result is the call's
    result; the graph is captured after it.  So the kernels' nvcc build
    and ctypes binding (ops/_build.py), their one-time shared-memory
    attributes and cuBLAS's handle set-up happen outside the capture,
    and nothing but the call's own work is written to the cache (a
    warm-up on dummy inputs would write slots of live rows in a
    contiguous cache);
  - static buffers: each key's inputs are device buffers owned here and
    filled with `copy_` before each replay, from pinned host staging or
    from another graph's output on the device; the output is the
    graph's own buffer, which the next replay of that key overwrites
    (the engine reads a call back before it replays the key again);
  - the cache and the weights: the graph holds their addresses, so a
    replay checks that they are the objects it captured and raises
    otherwise; `reset()` drops every graph, and the engine calls it
    before it builds a fresh cache (revive);
  - the generator: the engine's torch.Generator is registered with each
    graph, so sampling draws fresh noise on every replay;
  - no host sync inside the seam: positions stay per-row tensors;
  - threads: capture runs on the calling (scheduler) thread with
    capture_error_mode="thread_local", and every key shares one memory
    pool.  Engines of one process (an in-process fleet's replicas) each
    capture on their own thread, each into its own pool, while the
    others capture or launch eagerly;
  - launch counters: the kernel wrappers count in Python, so they see
    the first call and the capture, not the replays; the capture's
    counts (the capturing thread's own, `_build.tally`) are taken back,
    and each replay adds the calls it replays.

There is no fallback: a failed capture or replay raises to the caller
(the engine's retry, degrade or crash path) and never runs the eager
loop.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional

import torch

from ..ops import _build
from ..ops.paged_attention import paged_attention
from ..ops.quant_matmul import int8_weight_matmul

# The kernel wrappers whose `launches` counters a replay advances.
COUNTED = (paged_attention, int8_weight_matmul)


class _Graph:
    __slots__ = ("graph", "inputs", "out", "launches")

    def __init__(self, graph, inputs, out, launches):
        self.graph = graph
        self.inputs = inputs
        self.out = out
        self.launches = launches


class SeamGraphs:
    """Runs `seam(weights, cache, inputs, generator, key)` -> (cache,
    out): directly on the CPU, as a replay of the key's CUDA graph on the
    card.  `inputs` maps names to tensors (or None); `key` is hashable
    and names everything static about the call (the block width, the
    verify window's width and flags); `out` is a tensor or a tuple of
    them.

    `captures` records each capture: {"key", "first_call_s",
    "capture_s"} (first_call_s: the eager first call; capture_s: the
    capture, from the eager call's end)."""

    def __init__(self, seam: Callable, generator: Optional[torch.Generator],
                 device: torch.device):
        self._seam = seam
        self._gen = generator
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None
        self._bound = None  # (weights, cache) the graphs captured
        self.captures: list = []

    @property
    def keys(self):
        return sorted(self._graphs)

    def reset(self) -> None:
        """Drop every graph, its pool and its static buffers (before the
        cache they point at is replaced)."""
        self._graphs.clear()
        self._pool = None
        self._bound = None

    def run(self, weights, cache, inputs: Dict[str, Optional[torch.Tensor]],
            key: Hashable):
        """One call with `key` on `inputs` (host tensors pinned on the
        card, or device tensors).  Returns (cache, out) with `out` on the
        device."""
        if self.device.type != "cuda":
            return self._seam(weights, cache, inputs, self._gen, key)
        if self._bound is not None and (
            self._bound[0] is not weights or self._bound[1] is not cache
        ):
            raise RuntimeError(
                "seam graphs hold other weights or another cache: reset() "
                "them before either is replaced"
            )
        g = self._graphs.get(key)
        if g is None:
            return cache, self._first_call(weights, cache, inputs, key)
        for name, buf in g.inputs.items():
            if buf is not None:
                buf.copy_(inputs[name], non_blocking=True)
        g.graph.replay()
        for fn, n_calls in g.launches:
            _build.add_launches(fn, n_calls)
        return cache, g.out

    def _first_call(self, weights, cache, inputs, key):
        """The eager call on the real inputs, then the capture of `key`
        on the same static buffers.  Returns the eager call's output."""
        if self._bound is None:
            self._bound = (weights, cache)
            self._pool = torch.cuda.graph_pool_handle()
        static = {
            name: None if t is None
            else torch.empty_like(t, device=self.device)
            for name, t in inputs.items()
        }
        for name, buf in static.items():
            if buf is not None:
                buf.copy_(inputs[name], non_blocking=True)
        t0 = time.monotonic()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            _, first = self._seam(weights, cache, static, self._gen, key)
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        t1 = time.monotonic()
        graph = torch.cuda.CUDAGraph()
        if self._gen is not None:
            graph.register_generator_state(self._gen)
        try:
            with _build.tally() as captured, torch.cuda.graph(
                    graph, pool=self._pool,
                    capture_error_mode="thread_local"):
                _, out = self._seam(weights, cache, static, self._gen, key)
        finally:
            # The capture launched nothing (taken back outside the tally,
            # which would count the correction too).
            for fn, n in captured.items():
                _build.add_launches(fn, -n)
        self._graphs[key] = _Graph(graph, static, out, [
            (fn, captured.get(fn, 0)) for fn in COUNTED if captured.get(fn)
        ])
        self.captures.append({
            "key": key,
            "first_call_s": t1 - t0,
            "capture_s": time.monotonic() - t1,
        })
        return first
