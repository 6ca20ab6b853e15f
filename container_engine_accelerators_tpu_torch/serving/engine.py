"""Continuous-batching decode engine on PyTorch: the port of
container_engine_accelerators_tpu/serving/engine.py — the paged KV pool
with the radix prefix cache (the default) or the contiguous-slot cache
(paged=False), chunked prefill, single-token decode steps and fused
multi-step decode blocks (decode_steps > 1), for the bf16 engine
(quant=False) and the int8 weight + int8 KV engine (quant=True), and
speculative multi-token decoding (spec_k > 0), with the one-step lag
window (pipeline=True) or synchronous commits (pipeline=False).

One engine owns a persistent decode batch of `n_slots` rows and a
scheduler thread that, every iteration, advances admission by at most
one prefill chunk and runs one pipeline turn: DISPATCH decode step N+1
while step N's sampled tokens are still on the device (the in-flight
device token array feeds straight back in through the `over` merge, so
dispatch never reads anything back), then COMMIT step N at the one
designed readback, `_commit_window`.  Rows retire at commit
(max_new, stop token, cancel) and free their slot and pages at once.
The one-token step, the fused block and the speculative window are
three kinds of one turn (`_step`): one window record, one row-staging
routine and one commit path, each kind keeping only its gate, its
dispatch and (the window) its drafting and accept rule.

The paged pool (serving/kvpool.py) maps each row's logical positions to
physical pages through a per-row block table; the radix prefix cache
(serving/prefix_cache.py) shares matched prompt pages by reference and
adopts a partially matched page copy-on-write, so a divergent
continuation never writes a page another row reads.  Decode attention
walks the block tables in the paged-attention kernel and the int8
engine's projections run through the int8 matmul kernel (ops/).  The
contiguous-slot engine (paged=False) keeps one (max_seq, ...) cache row
per slot, slot == position, and has no prefix reuse; its attention stays
torch ops, as the reference leaves it to XLA.

Every admission's chunks run through one engine-owned batch-1 scratch
(one buffer a device, zeroed once when the admission starts).  On the
card the bf16 paged engine's FINAL chunk (the chunk's forward through
the scratch, tok0's sampling and the scatter into the row's pages) is
one CUDA graph replay per chunk width (serving/decode_graph.py): its
chunk, block table, start, write_from, prompt length and temperature
are device operands filled from pinned staging, so the admission queues
behind the block in flight and reads back only tok0.  Non-final chunks,
the int8, contiguous and mesh engines and every CPU engine call their
seams eagerly.

Fused multi-step decode (decode_steps = k > 1, paged engines only): on a
QUIET turn (nothing queued or prefilling, every live row greedy and
uncancelled with more than one token of headroom) the engine commits
the outstanding window, then dispatches one block of the largest width
on the ladder 2, 4, ..., k that every row's budget allows, and commits
the block's (B, width) tokens at the next turn with the stop / cancel /
max_new truncation applied per row.  Other turns fall through to the
one-token step.  On the card each width is one CUDA graph replay
(serving/decode_graph.py).

Speculative decoding (spec_k = k > 0, paged or not; it owns the
multi-token turns when decode_steps is set too): on a turn where some
live greedy row can draft deeper than one token, the engine commits the
outstanding window first (the accept decision gates the next draft),
then drafts up to k tokens per greedy row with the int8 twin of the same
weights against its own contiguous int8 KV cache, and scores the whole
window in ONE batched target pass (the verify seams).  The commit takes
target tokens while the draft agrees, plus the first disagreeing target
token, so greedy outputs are the one-token engine's; a rejected suffix
is a position rewind (its KV stays invisible and is rewritten), never a
page copy.  Sampled rows ride a window at width 1.  Per-row adaptive
depth halves a mispredicting row's window toward 1, and a probe every
8th turn lets it earn depth back; the dispatched width is the bucketed
max over rows on the ladder 1, 2, 4, ..., k.  The drafter is optional:
a failed draft chain or drafter-cache fill degrades the window to width
1 and zeroes the drafter cache, and no request fails; a failed verify
takes the step-retry / fail-rows path.  On the card each draft width
and each verify key (width, greedy, top-k / top-p operands) is one CUDA
graph replay, and the draft's output feeds the verify on the device.

Differences of idiom from the reference:
  - every device seam updates the cache IN PLACE (the reference donates
    and replaces it), so there is no donated-buffer loss to detect;
  - host staging is double-buffered in pinned memory on the card and
    copied with non_blocking=True: a set is rewritten only after the
    step that read it has been committed, and the commit readback
    waited for that step, copy included;
  - a torch.Generator on the engine's device replaces the rng key; a
    retried step draws fresh noise (greedy rows are unaffected).

KV page migration and tiers (paged engines with the prefix cache):
`export_prefix_pages` serializes a prefix's trie pages into a blob
(leaf metas, a layout signature naming this backend, the bytes) and
`adopt_prefix_pages` scatters a blob into fresh pages and the trie, both
as side jobs on the scheduler thread.  With kv_host_bytes / kv_disk_dir
LRU eviction DEMOTES each victim page's bytes into a host-RAM tier that
spills to disk (serving/kvtier.py), and an admission promotes the
longest tier-resident continuation of its prompt back into the pool
before it recomputes, when the measured load cost beats the recompute
estimate.  Page gathers read back synchronously, and page scatters write
in place, so captured CUDA graphs keep their addresses.

Observability (observe=True, the default): latency histograms, a trace
per request and the flight recorder (serving/observe.py, otel.py),
folded from monotonic stamps staged on the rows and windows at admit,
commit, retire and failure boundaries, never between staging and
dispatch.  Whatever `observe` says, the scheduler thread accounts its
own time phase by phase (_PhaseClock: waiting, side jobs, admission
with its prefix lookup, staging, dispatch, host syncs, commits) and
the time in which it knew the device had nothing queued, as integer
nanosecond counters in `stats` (snapshot() names them), folded at each
commit and before each wait.  While a torch profiler runs, the phases
are also `engine.*` profiler ranges on the profiler's clock.

A dp mesh (mesh=parallel.mesh.LocalMesh, the bf16 contiguous engine
only, as in the reference): the slot rows split into one contiguous
block a shard, each block's cache rows live on its shard's device with
the model placed once a device, an admission prefills on its slot's
shard, and a decode step launches every shard's rows on its own device
and gathers the next tokens onto the first device, so the commit keeps
its one readback.  Paged KV, speculative and fused decode fall away,
and with them export, adopt and the tiers.

Failure semantics are the reference's: a failed admission fails only
its ticket; a failed step retries with capped backoff, then fails the
active rows (queued requests preserved) and crashes the scheduler for
a supervisor (serving/supervisor.py) to revive with a fresh cache;
`max_queue` bounds admission with QueueFullError.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

from .._device import canonical_device, resolve_device
from ..models import generate as G
from ..models import quant_generate as QG
from ..models.transformer import TransformerLM
from . import kvpool
from . import kvtier
from . import observe as observe_mod
from .decode_graph import SeamGraphs
from .errors import QueueFullError, StepFailure
from .prefix_cache import RadixPrefixCache

log = logging.getLogger(__name__)

# The wire names of the pool dtypes (the reference's numpy names).
_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int8": torch.int8,
}


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


# state-machine: ticket field: state states: queued,admitted,streaming,done,failed terminal: done,failed
class _Ticket:
    """One submit() call: `rows` sequences that complete independently
    (each retiring frees its slot) and resolve together.  `state` is
    the lifecycle the fleet's re-route contract reads: queued ->
    admitted -> streaming, with done and failed terminal; written under
    the engine lock."""

    __slots__ = (
        "rows", "results", "done", "error", "cancelled",
        "on_token_logged", "admitted_rows", "done_callbacks", "state",
    )

    def __init__(self, rows: int):
        self.rows = rows
        self.state = "queued"
        self.results: List[Optional[list]] = [None] * rows
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.cancelled = False
        self.on_token_logged = False
        self.admitted_rows = 0
        self.done_callbacks: List[Callable[[], None]] = []

    def resolve_fire(self) -> List[Callable[[], None]]:
        """Detach the callbacks for firing (idempotent)."""
        fired, self.done_callbacks = self.done_callbacks, []
        return fired


class SubmitHandle:
    """The non-blocking half of submit(): wait(), cancel(),
    cancel_if_queued(), `admitted` and add_done_callback(), as in the
    reference."""

    __slots__ = ("_engine", "_ticket")

    def __init__(self, engine: "ContinuousBatchingEngine", ticket):
        self._engine = engine
        self._ticket = ticket

    @property
    def admitted(self) -> bool:
        with self._engine._cv:
            return self._ticket.admitted_rows > 0

    @property
    def rows(self) -> int:
        return self._ticket.rows

    @property
    def error(self) -> Optional[BaseException]:
        return self._ticket.error

    def cancel(self, err: Optional[BaseException] = None) -> None:
        """Withdraw the request (idempotent): queued rows are skipped at
        admit, in-flight rows retire at the next commit boundary, and
        wait() raises `err` (default RuntimeError)."""
        self._engine._fail_ticket(
            self._ticket, err or RuntimeError("request cancelled")
        )

    def cancel_if_queued(
        self, err: Optional[BaseException] = None
    ) -> bool:
        """Withdraw only while no row has reached admission; atomic
        against the admit pop.  Returns whether it cancelled."""
        eng = self._engine
        with eng._cv:
            if self._ticket.admitted_rows:
                return False
            eng._fail_ticket(
                self._ticket, err or RuntimeError("request cancelled")
            )
            return True

    @property
    def results(self) -> List[Optional[list]]:
        return self._ticket.results

    def add_done_callback(self, fn: Callable[[], None]) -> None:
        """Fire fn() exactly once when the ticket resolves; fires on the
        calling thread if it already has.  fn must be cheap and never
        call back into the engine."""
        t = self._ticket
        with self._engine._cv:
            t.done_callbacks.append(fn)
        if t.done.is_set():
            self._engine._fire_done_callbacks(t)

    def wait(self, timeout: Optional[float] = None) -> List[list]:
        """Block until every row retires; one token list per row.  On
        timeout the request is cancelled and RuntimeError raises."""
        t = self._ticket
        if not t.done.wait(timeout=timeout):
            t.cancelled = True
            raise RuntimeError(
                f"generation timed out after {timeout:.0f}s"
            )
        if t.error is not None:
            raise t.error
        return t.results


class _Seq:
    """One prompt row: the unit of slot occupancy."""

    __slots__ = (
        "ticket", "row_i", "prompt", "plen", "max_new", "temp",
        "top_k", "top_p", "stop_token", "on_token", "tokens",
        "next_tok", "pos", "page_refs", "page_wait",
        "spec_depth", "accept_ema", "spec_probe", "draft_upto",
        "t_submit", "t_admit", "t_last_commit", "trace", "trace_ctx",
        "tier_stamp",
    )

    def __init__(self, ticket, row_i, prompt, max_new, temp, top_k,
                 top_p, stop_token, on_token, trace_ctx=None):
        self.ticket = ticket
        self.row_i = row_i
        self.prompt = prompt  # np (plen,) int32
        self.plen = int(prompt.shape[0])
        self.max_new = int(max_new)
        self.temp = float(temp)
        self.top_k = top_k
        self.top_p = top_p
        self.stop_token = stop_token
        self.on_token = on_token
        self.tokens: list = []
        self.next_tok = 0
        self.pos = 0
        # Pool-page references this row holds (shared prefix pages +
        # private pages), released exactly once at retire/failure.
        self.page_refs: list = []
        # Optimistic page need recorded when admission requeued this
        # row for lack of pages (0 = not waiting).
        self.page_wait = 0
        # Speculative decoding: the row's adaptive draft depth (0 = the
        # engine's spec_k), the trailing accept-rate EMA driving it, the
        # probe counter that lets a depth-1 row earn its window back,
        # and the drafter-cache frontier: slots [0, draft_upto) of the
        # row's drafter cache hold its committed history.
        self.spec_depth = 0
        self.accept_ema = 1.0
        self.spec_probe = 0
        self.draft_upto = 0
        # Observability staging: plain monotonic stamps, folded by the
        # observer at admit / commit / retire.  `trace` (otel.Trace)
        # opens at admission, under the submitter's propagated
        # otel.TraceContext when one rode the request; `tier_stamp`
        # (t0, t1, tier, pages) is the admission-time promotion, which
        # runs before the trace opens.
        self.t_submit = time.monotonic()
        self.t_admit = 0.0
        self.t_last_commit = 0.0
        self.trace = None
        self.trace_ctx = trace_ctx
        self.tier_stamp = None


class _Pending:
    """One dispatched-but-uncommitted decode window (the lag window) of
    one turn kind: "step" (the one-token step), "fused" (a fused block)
    or "spec" (a speculative window).  It holds the rows that rode it as
    (slot, seq, base position, width), the still-in-flight device tokens
    `nxt` ((B,) for a step, (B, width) for a block, the (B, W) verify
    outputs for a window) and, for a window only, the (B, W) verify
    inputs `draft` (column 0 each row's last committed token, the rest
    the drafter's proposals).  _commit_window reads it back once;
    _drain_pending waits for `nxt` and drops it uncommitted on every
    failure path."""

    __slots__ = ("kind", "rows", "nxt", "t_dispatch", "draft")

    def __init__(self, kind, rows, nxt, t_dispatch, draft=None):
        self.kind = kind
        self.rows = rows
        self.nxt = nxt
        self.t_dispatch = t_dispatch
        self.draft = draft


# Each window kind's name in the logs and its readback's flight-recorder
# `at`.
_READBACK = {
    "step": ("decode step", "commit_readback"),
    "fused": ("fused decode block", "fused_commit_readback"),
    "spec": ("verify window", "spec_commit_readback"),
}


class _SideJob:
    """One scheduler-thread errand (KV page export or adoption, tier
    promotion), submitted from another thread through _side_call and
    run by the scheduler between turns, so that no second thread reads
    or writes the cache while a turn updates it.  Its failure resolves
    the waiter with the error; the scheduler keeps serving."""

    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


# The scheduler thread's phases (_PhaseClock): indices of its
# accumulators.
_WAIT, _SIDE, _ADMIT, _STAGE, _DISPATCH, _SYNC, _COMMIT = range(7)
_NO_TIME = (0,) * 7
# The profiler range a phase opens; waiting and side jobs open none.
_RANGES = (None, None, "engine.admit", "engine.stage", "engine.dispatch",
           "engine.sync", "engine.commit")


class _PhaseClock:
    """The scheduler thread's time, phase by phase, and the stretches in
    which it knew the device had nothing queued (snapshot() names the
    counters).  Scheduler-thread-private: the thread switches phases
    with `enter` and brackets device work with `launch` / `launched` and
    `enter(_SYNC)` / `synced`; each call stages one time.monotonic_ns()
    stamp into plain integers, and `fold` adds them into the engine's
    `stats` under the lock a commit or a wait already holds.

    Outstanding device work: unknown, so taken as there, until the
    first sync; queued by every device call (`launched`); cleared by a
    sync, which waits for everything queued before it on the engine's
    one stream.  While a torch profiler runs, each phase but waiting and
    side jobs is also a profiler range (`_RANGES`) on the profiler's
    clock, made as torch's own cheap ranges are (`_RecordFunctionFast`,
    about a microsecond against `record_function`'s ten or more, with
    the profiler recording or not); with none, no range is made.  Torch
    tells whether a profiler runs, not whether it records host ranges,
    so a device-only profiler pays for ranges it drops."""

    __slots__ = ("t", "phase", "busy", "launching", "ns", "starved",
                 "launch_idle", "rng")

    def __init__(self):
        self.t = time.monotonic_ns()
        self.phase = _WAIT
        self.busy = True
        self.launching = False
        self.ns = list(_NO_TIME)       # time in each phase
        self.starved = list(_NO_TIME)  # of it, with nothing outstanding
        self.launch_idle = 0  # in device calls entered with nothing queued
        self.rng = None  # the open profiler range

    def _tick(self):
        now = time.monotonic_ns()
        dt = now - self.t
        self.t = now
        self.ns[self.phase] += dt
        if not self.busy:
            if self.launching:
                self.launch_idle += dt
            else:
                self.starved[self.phase] += dt

    def enter(self, phase: int) -> None:
        """Switch to `phase`."""
        self._tick()
        if phase == self.phase:
            return
        self.phase = phase
        if self.rng is not None:
            rng, self.rng = self.rng, None
            rng.__exit__(None, None, None)
        name = _RANGES[phase]
        if name is not None and _autograd_profiler._is_profiler_enabled:
            self.rng = _RecordFunctionFast(name)
            self.rng.__enter__()

    def launch(self, phase: Optional[int] = None) -> None:
        """A device call starts (in `phase`, default the current one)."""
        self.enter(self.phase if phase is None else phase)
        self.launching = True

    def launched(self) -> None:
        """A device call returned: its work is outstanding until a
        sync."""
        self._tick()
        self.launching = False
        self.busy = True

    def synced(self, phase: int) -> None:
        """A sync returned (entered with `enter(_SYNC)`): nothing is
        outstanding.  The thread goes on in `phase`."""
        self.enter(phase)
        self.busy = False

    def restart(self) -> None:
        """A scheduler thread starts: the time before it is nobody's,
        and what the device holds is unknown."""
        self.t = time.monotonic_ns()
        self.busy = True
        self.launching = False

    def fold(self, stats: dict) -> None:
        """Add the time since the last fold into `stats` (the engine's
        lock held)."""
        self._tick()
        ns, st = self.ns, self.starved
        stats["phase_wait_ns"] += ns[_WAIT]
        stats["phase_side_ns"] += ns[_SIDE]
        stats["phase_admit_ns"] += ns[_ADMIT]
        stats["phase_stage_ns"] += ns[_STAGE]
        stats["phase_dispatch_ns"] += ns[_DISPATCH]
        stats["phase_sync_ns"] += ns[_SYNC]
        stats["phase_commit_ns"] += ns[_COMMIT]
        stats["starved_ns"] += sum(st)
        stats["starved_admit_ns"] += st[_ADMIT]
        stats["starved_commit_ns"] += st[_COMMIT]
        stats["launch_idle_ns"] += self.launch_idle
        ns[:] = _NO_TIME
        st[:] = _NO_TIME
        self.launch_idle = 0


class _Prefill:
    """One in-progress chunked admission: the reserved slot, the
    bucket-padded prompt, the (start, width) chunk plan, the batch-1
    scratch cache, and the prefix-cache outcome (block-table row, the
    page references it holds, resume/write boundaries)."""

    __slots__ = ("seq", "slot", "padded", "plan", "pi", "scratch",
                 "bt_row", "bt_pre", "write_from", "resume",
                 "match_end", "donor", "shared_ids", "priv")

    def __init__(self, seq, slot, padded, plan):
        self.seq = seq
        self.slot = slot
        self.padded = padded  # np (1, p_bucket) int32
        self.plan = plan      # [(start, width)] covering the prompt
        self.pi = 0           # next plan index
        self.scratch = None   # the engine's scratch, from the first chunk
        self.bt_row = None    # np (pages_per_row,) int32
        self.bt_pre = None    # preload variant (COW donor mapped in)
        self.write_from = 0   # first position the finish scatter writes
        self.resume = 0       # first position the chunk plan recomputes
        self.match_end = 0    # prefix-cache matched tokens (preloaded)
        self.donor = None     # COW donor page id (transient reference)
        self.shared_ids: list = []  # shared prefix pages (row refs)
        self.priv: list = []  # freshly allocated private pages


class _Staging:
    """One set of host staging buffers for a dispatch, built from a
    table of fields {name: (shape, dtype, fill)}: torch tensors (pinned
    on the card, so the copy can be non_blocking) and numpy views of the
    same memory for the scheduler to fill.  `reset` writes each field's
    fill back; a field whose fill is None starts zeroed and is written
    whole by its user (the block tables, the drafter's row mask, the
    final prefill chunk's operands)."""

    def __init__(self, fields, pin):
        self.t = {
            name: torch.full(shape, 0 if fill is None else fill,
                             dtype=dtype, pin_memory=pin)
            for name, (shape, dtype, fill) in fields.items()
        }
        self.np = {k: v.numpy() for k, v in self.t.items()}
        self._fills = [(self.np[name], fill)
                       for name, (_, _, fill) in fields.items()
                       if fill is not None]

    def reset(self) -> dict:
        """Every field with a fill back to it; returns the numpy views."""
        for view, fill in self._fills:
            view.fill(fill)
        return self.np

    def to(self, device):
        return {
            k: v.to(device, non_blocking=True) for k, v in self.t.items()
        }

    def fill(self, chunk, bt_row, start, write_from, prompt_len, temp,
             top_k, top_p) -> dict:
        """Stage one final prefill chunk (a set of
        `_final_chunk_fields`); returns the seam's inputs (views of the
        staging; top_k / top_p None when not given)."""
        t = self.t
        width = chunk.shape[1]
        t["chunk"][:, :width].copy_(chunk)
        t["bt"].copy_(torch.as_tensor(bt_row))
        inputs = {"chunk": t["chunk"][:, :width], "bt": t["bt"]}
        for name, val in (("start", start), ("write_from", write_from),
                          ("prompt_len", prompt_len), ("temp", temp),
                          ("top_k", top_k), ("top_p", top_p)):
            inputs[name] = None if val is None else t[name].fill_(val)
        return inputs


def _final_chunk_fields(max_seq, pages_per_row) -> dict:
    """The staging table of one final prefill chunk's operands: the
    chunk in the first columns of a (1, max_seq) row, the row's block
    table, and the 0-dim start, write_from, prompt_len, temperature,
    top_k and top_p."""
    return {
        "chunk": ((1, max_seq), torch.int64, None),
        "bt": ((pages_per_row,), torch.int32, None),
        "start": ((), torch.int64, None),
        "write_from": ((), torch.int64, None),
        "prompt_len": ((), torch.int64, None),
        "temp": ((), torch.float32, None),
        "top_k": ((), torch.int64, None),
        "top_p": ((), torch.float32, None),
    }


def _lag_merged(step):
    """The decode seam (cache, prev, tok, use, pos, act, bt, temp, gen,
    **kw) over `step(cache, tok, pos, act, bt, temp, gen, **kw)`: a row
    with `use` set takes its staged `tok`, the others the in-flight
    `prev` (the lag merge)."""

    def decode_fn(cache, prev, tok, use, pos, act, bt, temp, gen, **kw):
        return step(cache, torch.where(use, tok, prev), pos, act, bt, temp,
                    gen, **kw)

    return decode_fn


def _final_chunk_seam(weights, cache, inp, gen, key):
    """The bf16 paged engine's final prefill chunk as a SeamGraphs seam:
    weights (model, scratch), `inp` what _Staging.fill returns; the key
    (width, top_k given, top_p given) is all that is static."""
    del key
    model, scratch = weights
    return G.paged_prefill_finish(
        model, cache, scratch, inp["chunk"], inp["bt"], inp["start"],
        inp["write_from"], inp["prompt_len"], inp["temp"], gen,
        top_k=inp["top_k"], top_p=inp["top_p"],
    )


class _Shard:
    """One shard of a dp-mesh engine: its device, the model placed
    there, its sampling generator and its slot rows [lo, hi)."""

    def __init__(self, i, device, model, gen, lo, hi):
        self.i, self.device, self.model, self.gen = i, device, model, gen
        self.lo, self.hi = lo, hi


class ContinuousBatchingEngine:
    """In-flight batching over a paged KV pool.

    model: a decode=True TransformerLM (make_decoder) on `device`.
    n_slots: resident decode batch size.  quant=True builds the int8
    weight engine (int8 KV too with quant_kv, the default).
    prompt_grid: smallest prompt bucket edge.  prefill_chunk:
    chunked-prefill width (power of two, floored at the grid; 0 = one
    chunk per admission).  pipeline: the one-step lag
    window (False commits each step before the next dispatch — the
    parity control).  paged: the block-table KV pool (the default);
    False keeps one contiguous max_seq cache row per slot.  page_size:
    tokens per page (power of two); kv_pages: pool capacity in pages
    (default n_slots x pages per max_seq row); prefix_cache: radix
    prefix reuse (paged only).  kv_host_bytes / kv_disk_dir /
    kv_disk_bytes: the host-RAM tier's byte cap, the disk tier's
    directory and its byte cap (0: unbounded) under the pool (paged with
    the prefix cache only; no tier when both are off);
    tier_recompute_tok_s: the prefill rate the promote-or-recompute rule
    assumes.  decode_steps: the widest fused block
    (module docstring); 0 or 1 keeps the one-token path, and a
    non-paged engine forces it to 0.  spec_k: the widest speculative
    window (module docstring); 0 keeps the one-token path.
    spec_adaptive: per-row adaptive draft depth; spec_min_accept: the
    trailing accept rate below which a row's depth halves.  max_queue:
    bound on queued prompt rows.  step_retries / retry_backoff_s /
    retry_backoff_cap_s: transient step-failure absorption.  rng_seed
    seeds the engine's sampling generator.  observe: serving
    observability (histograms, traces, flight recorder; False builds the
    uninstrumented engine); registry: an observe.Registry to share with
    the embedder (None builds a private one).  device: where the engine
    runs (default the card; raises without one unless "cpu").  mesh: a
    parallel.mesh.LocalMesh whose first device is `device`; the engine
    then shards its slot rows over the mesh (module docstring); n_slots
    must divide over it, and quant=True raises."""

    def __init__(
        self,
        model: TransformerLM,
        n_slots: int,
        *,
        quant: bool = False,
        quant_kv: bool = True,
        mesh=None,
        prompt_grid: int = 16,
        prefill_chunk: int = 256,
        pipeline: bool = True,
        paged: bool = True,
        page_size: int = 64,
        kv_pages: Optional[int] = None,
        prefix_cache: bool = True,
        kv_host_bytes: int = 0,
        kv_disk_dir: Optional[str] = None,
        kv_disk_bytes: int = 0,
        tier_recompute_tok_s: float = 2000.0,
        spec_k: int = 0,
        spec_adaptive: bool = True,
        spec_min_accept: float = 0.4,
        decode_steps: int = 0,
        rng_seed: int = 0,
        max_queue: Optional[int] = None,
        step_retries: int = 3,
        retry_backoff_s: float = 0.05,
        retry_backoff_cap_s: float = 2.0,
        observe: bool = True,
        registry=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if not model.decode:
            raise ValueError(
                "ContinuousBatchingEngine needs a decode=True model "
                "(make_decoder)"
            )
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}"
            )
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        ds = int(decode_steps)
        if ds < 0:
            raise ValueError(f"decode_steps must be >= 0, got {decode_steps}")
        spec = int(spec_k)
        if spec < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if quant and mesh is not None:
            raise ValueError(
                "the int8 engine is single-chip (its weight matmuls run "
                "on one card); build a bf16 engine for a mesh"
            )
        if paged and mesh is not None:
            log.info(
                "paged KV cache disabled under a mesh: the contiguous "
                "layout batch-partitions, the paged flat scatter does "
                "not"
            )
            paged = False
        if spec > 0 and mesh is not None:
            log.info(
                "speculative decoding disabled under a mesh: the int8 "
                "drafter and the batched verify scatter are single-chip"
            )
            spec = 0
        self._model = model
        self.n_slots = int(n_slots)
        self.quant = bool(quant)
        self._quant_kv = bool(quant_kv)
        self._grid = max(1, int(prompt_grid))
        self._pipeline = bool(pipeline)
        chunk = int(prefill_chunk)
        if chunk > 0:
            # Power of two, floored at the grid: chunk edges tile the
            # bucket ladder exactly.
            edge = self._grid
            while edge < chunk:
                edge *= 2
            chunk = edge
        self._prefill_chunk = chunk
        self._paged = bool(paged)
        self._page = int(page_size)
        self._pages_per_row = 0
        self._pool = self._prefix = None
        if self._paged:
            if self._page < 1 or (self._page & (self._page - 1)):
                raise ValueError(
                    f"page_size must be a power of two >= 1, got "
                    f"{page_size}"
                )
            self._pages_per_row = -(-model.max_seq // self._page)
            total = (
                int(kv_pages) if kv_pages
                else self.n_slots * self._pages_per_row
            )
            if total < 1:
                raise ValueError(f"kv_pages must be >= 1, got {kv_pages}")
            self._pool = kvpool.PagePool(total)
            if prefix_cache:
                self._prefix = RadixPrefixCache(self._page)
        # The tiered page store (serving/kvtier.py): eviction demotes
        # serialized trie pages into it, admission promotes them back.
        # Needs the trie (demotion victims are its leaves).
        self._tier = None
        if (
            self._prefix is not None
            and (int(kv_host_bytes) > 0 or kv_disk_dir)
        ):
            self._tier = kvtier.TieredPageStore(
                self._page, int(kv_host_bytes),
                disk_dir=kv_disk_dir, disk_bytes=int(kv_disk_bytes),
            )
        # The measured promote-or-recompute rule: bytes/s a tier over
        # completed promotions (first sample excluded), a probe after 8
        # consecutive skips.
        self._tier_recompute_tok_s = max(1.0, float(tier_recompute_tok_s))
        self._tier_bps: dict = {}  # guarded-by: _cv
        self._tier_n: dict = {}  # guarded-by: _cv
        self._tier_skip_streak: dict = {}  # guarded-by: _cv
        self._tier_page_bytes = 0.0  # guarded-by: _cv
        if ds > 1 and not self._paged:
            log.info(
                "fused multi-step decode disabled: the chained decode "
                "seam scatters through block tables (paged engines only)"
            )
            ds = 0
        self._decode_steps = ds
        self._spec_k = spec
        self._spec_adaptive = bool(spec_adaptive)
        self._spec_min_accept = float(spec_min_accept)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(rng_seed))
        self._max_queue = max_queue
        self._step_retries = max(0, int(step_retries))
        self._retry_backoff_s = float(retry_backoff_s)
        self._retry_backoff_cap_s = float(retry_backoff_cap_s)
        self._mesh = mesh
        self._shards: List[_Shard] = []
        if mesh is not None:
            self._shards = self._make_shards(mesh, model, int(rng_seed))
        # Every distinct device the engine's state lives on.
        self._devices = list(dict.fromkeys(
            [self.device] + [sh.device for sh in self._shards]))

        # The device seams, as attributes so a fault injector can wrap
        # them: the chunk seam (a non-final prefill chunk into the
        # scratch), the final chunk (sample tok0, then scatter the
        # scratch into the row's pages, or copy it over the row's slot
        # when not paged), the decode step, the prefix preload, and the
        # fused block.  The int8 engine prefills through the model with
        # DEQUANTIZED weights, so both engines run chunks on a float
        # model.  prefill_fn's `where` is the row's block table (paged)
        # or its slot; decode_fn's `bt` is None when not paged.  Each
        # seam is bound to the engine's layout and weight format here,
        # once, and `_weights` is what the fused and verify seams run.
        self._prefill_chunk_fn = G.prefill_chunk
        heads = model.heads
        if self.quant:
            self._qparams = QG.quantize_decode_params(model)
            self._deq = QG.dequantize_decode_params(self._qparams, model)
            qp, deq = self._qparams, self._deq
            self._weights = qp
            if self._paged:
                def prefill_fn(cache, scratch, chunk, where, start, wfrom,
                               plen, temp, gen, **kw):
                    return QG.quant_paged_prefill_finish(
                        deq, qp, cache, scratch, chunk, where, start,
                        wfrom, plen, temp, gen, **kw
                    )

                def step_fn(cache, tok, pos, act, bt, temp, gen, **kw):
                    return QG.quant_paged_engine_decode_step(
                        qp, cache, tok, pos, act, bt, temp, gen, heads,
                        **kw
                    )
            else:
                def prefill_fn(cache, scratch, chunk, where, start, wfrom,
                               plen, temp, gen, **kw):
                    return QG.quant_prefill_finish_into_slot(
                        deq, qp, cache, scratch, chunk, where, start, plen,
                        temp, gen, **kw
                    )

                def step_fn(cache, tok, pos, act, bt, temp, gen, **kw):
                    return QG.quant_engine_decode_step(
                        qp, cache, tok, pos, act, temp, gen, heads, **kw
                    )

            def steps_fn(qp, cache, inp, gen, n):
                return QG.quant_paged_engine_decode_steps(
                    qp, cache, inp["tok"], inp["pos"], inp["active"],
                    inp["bt"], inp["temps"], gen, heads, n
                )

            def verify_fn(qp, cache, toks, inp, gen, greedy, kw):
                return QG.quant_verify_step(
                    qp, cache, toks, inp["pos"], inp["active"],
                    inp["temps"], gen, heads, block_tables=inp["bt"],
                    greedy=greedy, **kw
                )

            self._preload_fn = QG.quant_paged_preload_scratch
        else:
            self._weights = model
            if self._paged:
                def prefill_fn(cache, scratch, chunk, where, start, wfrom,
                               plen, temp, gen, top_k=None, top_p=None):
                    # The final chunk's graph on staged operands.
                    inputs = self._final_stage.fill(
                        chunk, where, start, wfrom, plen, temp, top_k,
                        top_p)
                    key = (chunk.shape[1], top_k is not None,
                           top_p is not None)
                    return self._prefill_graphs.run((model, scratch),
                                                    cache, inputs, key)

                def step_fn(cache, tok, pos, act, bt, temp, gen, **kw):
                    return G.paged_decode_step(
                        model, cache, tok, pos, act, bt, temp, gen, **kw
                    )

                def verify_fn(model, cache, toks, inp, gen, greedy, kw):
                    return G.paged_verify_step(
                        model, cache, toks, inp["pos"], inp["active"],
                        inp["bt"], inp["temps"], gen, greedy=greedy, **kw
                    )
            else:
                def prefill_fn(cache, scratch, chunk, where, start, wfrom,
                               plen, temp, gen, top_k=None, top_p=None):
                    return G.prefill_finish_into_slot(
                        model, cache, scratch, chunk, where, start, plen,
                        temp, gen, top_k, top_p
                    )

                def step_fn(cache, tok, pos, act, bt, temp, gen, **kw):
                    return G.decode_step(
                        model, cache, tok, pos, act, temp, gen, **kw
                    )

                def verify_fn(model, cache, toks, inp, gen, greedy, kw):
                    return G.verify_step(
                        model, cache, toks, inp["pos"], inp["active"],
                        inp["temps"], gen, greedy=greedy, **kw
                    )

            def steps_fn(model, cache, inp, gen, n):
                return G.paged_decode_steps(
                    model, cache, inp["tok"], inp["pos"], inp["active"],
                    inp["bt"], inp["temps"], gen, n
                )

            self._preload_fn = G.paged_preload_scratch
            if self._shards:
                prefill_fn, step_fn = self._mesh_seams()
        # The page seams of export / adopt and the tiers, as attributes
        # a fault injector can wrap: (cache, page ids) -> gathered
        # leaves on the device, and (cache, page ids, parts) -> cache.
        self._page_gather_fn = G.gather_kv_pages
        self._page_scatter_fn = G.scatter_kv_pages
        self._prefill_fn = prefill_fn
        self._decode_fn = _lag_merged(step_fn)
        pin = self.device.type == "cuda"
        # The bf16 paged engine's final prefill chunk (module docstring):
        # one CUDA graph per (width, top_k given, top_p given) on the
        # card, inside `_prefill_fn`.  ONE staging set is enough: the
        # admission reads tok0 back, or on a failure synchronizes
        # (_cache_intact), before the next admission rewrites it.
        self._prefill_graphs = None
        if self._paged and not self.quant:
            self._prefill_graphs = SeamGraphs(_final_chunk_seam, self._gen,
                                              self.device)
            self._final_stage = _Staging(
                _final_chunk_fields(model.max_seq, self._pages_per_row), pin)
        # Fused blocks (decode_steps > 1): widths on the power-of-two
        # ladder from 2, capped at and ending with decode_steps; one
        # CUDA graph per width on the card (serving/decode_graph.py).
        # `_fused_fn(weights, cache, inputs, width)` is the seam a fault
        # injector wraps.
        self._fused = None
        self._fused_fn = None
        self._fused_buckets: List[int] = []
        if self._decode_steps > 1:
            self._fused = SeamGraphs(steps_fn, self._gen, self.device)
            self._fused_fn = self._fused.run
            w = 2
            while w < self._decode_steps:
                self._fused_buckets.append(w)
                w *= 2
            self._fused_buckets.append(self._decode_steps)
        # Speculative decoding (spec_k > 0): the drafter is the int8
        # twin of the same weights (the int8 engine's own tree; the bf16
        # engine quantizes once here), drafting greedily against its own
        # contiguous int8 KV cache, which `_draft_fill_fn(draft_cache,
        # cache, slot, upto, block table row or None)` fills from the
        # engine cache after an admission.  `_draft_fn(qparams,
        # draft_cache, inputs, width)` is the draft chain and
        # `_verify_fn(weights, cache, inputs, (width, greedy, top-k /
        # top-p given))` the verify window: one CUDA graph per width and
        # per key on the card, seams a fault injector can wrap.  Widths
        # are powers of two from 1, capped at and ending with spec_k.
        self._spec_graphs = ()
        self._spec_buckets: List[int] = []
        self._spec_last_width = 0
        if self._spec_k:
            self._draft_qparams = (
                self._qparams if self.quant
                else QG.quantize_decode_params(model)
            )
            self._draft_cache = QG.init_quant_decode_cache(
                model, self.n_slots, quant_kv=True, device=self.device
            )

            def draft_fn(qp, dcache, inp, _gen, n):
                return QG.draft_chain(qp, dcache, inp["tok"], inp["pos"],
                                      inp["active"], heads, n)

            def window_fn(weights, cache, inp, gen, key):
                _width, greedy, adv = key
                toks = torch.cat([inp["tok"][:, None], inp["dcols"]], dim=1)
                kw = {"top_k": inp["top_k"], "top_p": inp["top_p"]} if adv \
                    else {}
                cache, out = verify_fn(weights, cache, toks, inp, gen,
                                       greedy, kw)
                return cache, (out, toks)

            def fill_fn(dcache, cache, slot, upto, bt_row):
                return QG.draft_fill_row(dcache, cache, slot, upto,
                                         block_table=bt_row)

            drafts = SeamGraphs(draft_fn, None, self.device)
            windows = SeamGraphs(window_fn, self._gen, self.device)
            self._spec_graphs = (drafts, windows)
            self._draft_fn = drafts.run
            self._verify_fn = windows.run
            self._draft_fill_fn = fill_fn
            # The proposal columns of a width-1 window: none.
            self._no_dcols = torch.zeros((self.n_slots, 0), dtype=torch.int32,
                                         device=self.device)
            w = 1
            while w < self._spec_k:
                self._spec_buckets.append(w)
                w *= 2
            self._spec_buckets.append(self._spec_k)
        # The float model the chunk seam runs (dequantized for int8).
        self._prefill_params = self._deq if self.quant else model
        self._cache = self._build_cache()
        # The admission scratch, {device: (buffer, leaves)}: one a device
        # an admission prefills on (each shard's under a mesh).
        targets = {sh.device: sh.model for sh in self._shards} or {
            self.device: self._prefill_params}
        self._scratch = {
            dev: G.init_scratch(m, device=dev) for dev, m in targets.items()
        }

        self._cv = threading.Condition()
        self._queue: "collections.deque[_Seq]" = collections.deque()  # guarded-by: _cv
        self._slots: List[Optional[_Seq]] = [None] * self.n_slots  # guarded-by: _cv
        # Canonical per-slot block tables (logical page -> physical
        # page; 0 = the null page).  Written at admission finish,
        # zeroed at retire and on every failure path; copied into the
        # dispatch staging each step.  Zero columns when not paged.
        self._bt_master = np.zeros(  # guarded-by: _cv
            (self.n_slots, self._pages_per_row), np.int32
        )
        self._pending: Optional[_Pending] = None  # guarded-by: _cv
        self._prefilling: Optional[_Prefill] = None  # guarded-by: _cv
        self._side_jobs: "collections.deque[_SideJob]" = (  # guarded-by: _cv
            collections.deque()
        )
        # The decode staging sets, scheduler-thread-private: what every
        # row of a dispatch reads, the sampling operands the one-token
        # step and the window read, and the block tables when paged.
        n, ppr = self.n_slots, self._pages_per_row
        rows = {"tok": ((n,), torch.int32, 0),
                "pos": ((n,), torch.int32, 0),
                "active": ((n,), torch.bool, False),
                "temps": ((n,), torch.float32, 0.0)}
        sampling = {"top_k": ((n,), torch.int32, model.vocab),
                    "top_p": ((n,), torch.float32, 1.0)}
        bt = {"bt": ((n, ppr), torch.int32, None)} if ppr else {}
        # The one-token step's, double-buffered (module docstring): the
        # set an in-flight step's copy reads is never rewritten before
        # that step commits.  `over` is the lag merge's mask.
        self._stages = tuple(
            _Staging({**rows, **sampling,
                      "over": ((n,), torch.bool, True), **bt}, pin)
            for _ in range(2)
        )
        self._stage_i = 0
        # Fused-block staging: ONE set is enough, because a fused turn
        # commits the outstanding window before it rewrites the set, and
        # that readback waited for every copy out of it.
        self._fused_stage = (
            _Staging({**rows, **bt}, pin) if self._fused is not None
            else None
        )
        # Speculative staging: ONE set, for the same reason; `draft` is
        # the drafter's row mask.
        self._spec_stage = (
            _Staging({**rows, **sampling,
                      "draft": ((n,), torch.bool, None), **bt}, pin)
            if self._spec_k else None
        )
        # The `prev` operand when no step is in flight: every row
        # overrides it through the merge mask, only its shape matters.
        self._last_nxt = self._zeros_tok()
        self._closed = False  # guarded-by: _cv
        self._dead: Optional[BaseException] = None  # guarded-by: _cv
        # Crash handshake with serving/supervisor.py.
        self._supervisor = None  # guarded-by: _cv
        self._crashed = threading.Event()
        self._crash_error: Optional[BaseException] = None  # guarded-by: _cv
        self.stats = {  # guarded-by: _cv
            "admitted": 0,
            "retired": 0,
            "prefill_chunks": 0,
            # Final chunks served by a CUDA graph replay (bf16 paged
            # engines on the card).
            "prefill_replays": 0,
            "steps": 0,
            "step_rows": 0,
            "max_active": 0,
            "queue_peak": 0,
            "queue_rejected": 0,
            "admit_failures": 0,
            "step_retries": 0,
            "step_failures": 0,
            "rows_failed": 0,
            "on_token_errors": 0,
            "restarts": 0,
            "prefix_hits": 0,
            "prefix_misses": 0,
            "prefix_hit_tokens": 0,
            "prefix_lookup_tokens": 0,
            "prefix_inserted_pages": 0,
            "prefix_evictions": 0,
            "cow_copies": 0,
            # KV page migration: pages serialized out of / adopted into
            # the pool, their bytes, and adoptions that failed cleanly.
            "kv_pages_exported": 0,
            "kv_pages_adopted": 0,
            "kv_export_bytes": 0,
            "kv_adopt_bytes": 0,
            "kv_adopt_failures": 0,
            # Tiers: pages demoted out of / promoted back into the pool,
            # promotions the cost rule skipped for recompute, and
            # promotions that failed cleanly (the ticket recomputes).
            "kv_tier_demoted_pages": 0,
            "kv_tier_promoted_pages": 0,
            "kv_tier_load_skipped": 0,
            "kv_tier_load_failures": 0,
            # Fused blocks dispatched and the tokens they committed;
            # "steps" counts commits (host round-trips) of every kind.
            "fused_blocks": 0,
            "fused_steps": 0,  # decode steps dispatched inside blocks
            "fused_tokens": 0,
            # Speculative windows: draft tokens dispatched in windows
            # wider than 1, and those committed (accepted) or not; the
            # bonus target token of a window is not a draft.  Also the
            # verify passes, the rows they carried and the tokens those
            # rows committed, and the drafter's passes and chains.
            "spec_drafted_tokens": 0,
            "spec_accepted_tokens": 0,
            "spec_rejected_tokens": 0,
            "spec_verify_passes": 0,
            "spec_window_rows": 0,
            "spec_window_tokens": 0,
            "spec_draft_passes": 0,
            "spec_draft_chains": 0,
            # The scheduler thread's time by phase and its starved time
            # (_PhaseClock; snapshot() says what each counts), in ns.
            "phase_wait_ns": 0,
            "phase_side_ns": 0,
            "phase_admit_ns": 0,
            "phase_stage_ns": 0,
            "phase_dispatch_ns": 0,
            "phase_sync_ns": 0,
            "phase_commit_ns": 0,
            "starved_ns": 0,
            "starved_admit_ns": 0,
            "starved_commit_ns": 0,
            "launch_idle_ns": 0,
        }
        self._clock = _PhaseClock()  # scheduler-thread-private
        # Observability (serving/observe.py), or the inert observer.
        self._obs = (
            observe_mod.engine_observability(registry=registry)
            if observe else observe_mod.NullObservability()
        )
        self._obs.attach_engine(self)
        # Tier series ride the engine registry: occupancy and flow as a
        # collector, promotion wall time as a histogram by tier.
        self._tier_fetch_hist = None
        if self._tier is not None and self._obs.enabled:
            self._obs.registry.register_collector(
                "kv-tier", self._tier.collect
            )
            self._tier_fetch_hist = self._obs.registry.histogram(
                "kv_tier_fetch_seconds",
                "Wall time of one tier promotion (load + scatter + "
                "trie adopt), labelled by the deepest tier touched",
                kvtier.TIER_FETCH_BUCKETS,
                labelnames=("tier",),
            )
        # Dispatched decode steps, fused blocks and speculative windows.
        self._dispatch_count = 0
        self._start_thread()

    @property
    def observability(self):
        """The engine's observer (observe.EngineObservability or the
        null observer): `.registry` renders /metrics, `.recorder` is
        the flight recorder, `.traces` the recent-request trace ring."""
        return self._obs

    def _make_shards(self, mesh, model, rng_seed) -> List[_Shard]:
        """The shards of a dp mesh (n_slots split into contiguous
        blocks), the model placed once a distinct device."""
        devs = [canonical_device(d) for d in mesh.devices]
        if devs[0] != canonical_device(self.device):
            raise ValueError(
                f"the engine runs on {self.device}, its mesh starts at "
                f"{devs[0]}"
            )
        n_dev = len(devs)
        if self.n_slots % n_dev:
            raise ValueError(
                f"n_slots {self.n_slots} must divide over {n_dev} "
                f"devices (axes {tuple(mesh.axis_names)})"
            )
        models = G.models_on(model, devs)
        per = self.n_slots // n_dev
        shards = []
        for i, dev in enumerate(devs):
            gen = self._gen
            if i:
                gen = torch.Generator(device=dev)
                gen.manual_seed(rng_seed + i)
            shards.append(_Shard(i, dev, models[dev], gen, i * per,
                                 (i + 1) * per))
        return shards

    def _mesh_seams(self):
        """The dp mesh's final-chunk seam and decode step (before the
        lag merge, _lag_merged) over the shard caches (`self._cache` is
        then a list of them, one a shard)."""
        shards, home = self._shards, self.device

        def prefill_fn(cache, scratch, chunk, where, start, wfrom, plen,
                       temp, gen, **kw):
            sh = self._shard_of(where)
            cache[sh.i], tok0 = G.prefill_finish_into_slot(
                sh.model, cache[sh.i], scratch, chunk, where - sh.lo, start,
                plen, temp, sh.gen, **kw
            )
            return cache, tok0

        def step_fn(cache, tok, pos, act, bt, temp, gen, **kw):
            outs = []
            for sh in shards:
                def part(x, sh=sh):
                    return x[sh.lo:sh.hi].to(sh.device, non_blocking=True)

                cache[sh.i], nxt = G.decode_step(
                    sh.model, cache[sh.i], part(tok), part(pos), part(act),
                    part(temp), sh.gen,
                    **{k: part(v) for k, v in kw.items()}
                )
                outs.append(nxt.to(home, non_blocking=True))
            return cache, torch.cat(outs)

        return prefill_fn, step_fn

    def _shard_of(self, slot: int) -> _Shard:
        return self._shards[slot // self._shards[0].hi]

    def _admission_target(self, slot: int):
        """(device, float model) an admission into `slot` prefills on:
        its shard's under a mesh."""
        if self._shards:
            sh = self._shard_of(slot)
            return sh.device, sh.model
        return self.device, self._prefill_params

    def _zeros_tok(self):
        return torch.zeros((self.n_slots,), dtype=torch.int32,
                           device=self.device)

    # -- public API ------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new: int,
        temperature: float = 0.0,
        top_k=None,
        top_p=None,
        stop_token: Optional[int] = None,
        timeout: Optional[float] = None,
        on_token: Optional[Callable[[int, int], None]] = None,
        trace_ctx=None,
    ) -> List[list]:
        """Blocking: enqueue one request ((rows, p_len) or (p_len,) int
        prompt) and wait for every row to retire.  Returns one token
        list per row: max_new tokens, or fewer when the row hit
        `stop_token` (included last).  on_token(row, token) streams
        committed tokens (one step behind dispatch under the lag
        window).  On timeout the request is cancelled and RuntimeError
        raises; QueueFullError when max_queue would overflow.
        trace_ctx: see submit_nowait."""
        return self.submit_nowait(
            prompt, max_new, temperature, top_k=top_k, top_p=top_p,
            stop_token=stop_token, on_token=on_token,
            trace_ctx=trace_ctx,
        ).wait(timeout=timeout)

    def submit_nowait(
        self,
        prompt,
        max_new: int,
        temperature: float = 0.0,
        top_k=None,
        top_p=None,
        stop_token: Optional[int] = None,
        on_token: Optional[Callable[[int, int], None]] = None,
        trace_ctx=None,
    ) -> SubmitHandle:
        """Validate and enqueue; return a SubmitHandle.  `trace_ctx`
        (otel.TraceContext) is the propagated trace identity: the trace
        opened at admission takes its trace_id and parents its spans on
        the caller's span (None mints a local id)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        if prompt.ndim != 2 or prompt.shape[0] < 1 or prompt.shape[1] < 1:
            raise ValueError(
                "prompt must be a non-empty (rows, p_len) int batch"
            )
        rows, p_len = prompt.shape
        max_new = int(max_new)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if p_len + max_new > self._model.max_seq:
            raise ValueError(
                f"prompt ({p_len}) + max_new ({max_new}) exceeds the "
                f"model's max_seq ({self._model.max_seq})"
            )
        if self._max_queue is not None and rows > self._max_queue:
            raise ValueError(
                f"batch rows ({rows}) exceed the admission queue bound "
                f"({self._max_queue}); split the request or raise "
                f"max_queue"
            )
        ticket = _Ticket(rows)
        seqs = [
            _Seq(ticket, i, prompt[i], max_new, temperature, top_k,
                 top_p, stop_token, on_token, trace_ctx=trace_ctx)
            for i in range(rows)
        ]
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._dead is not None:
                raise RuntimeError(
                    f"engine failed permanently: {self._dead}"
                )
            if self._max_queue is not None:
                queued = sum(
                    1 for s in self._queue if not s.ticket.cancelled
                )
                if queued + rows > self._max_queue:
                    self.stats["queue_rejected"] += 1
                    raise QueueFullError(
                        f"admission queue is full ({queued} queued "
                        f"rows, bound {self._max_queue})"
                    )
            self._queue.extend(seqs)
            self.stats["queue_peak"] = max(
                self.stats["queue_peak"], len(self._queue)
            )
            self._cv.notify_all()
        return SubmitHandle(self, ticket)

    def snapshot(self) -> dict:
        """Atomic copy of the counters plus queue/slot occupancy, the
        pool gauges and the tiers' occupancy and flow.  On a dead or
        crashed engine it also carries the flight recorder's retained
        events ("flight_recorder").

        The scheduler thread's phase counters, cumulative ns, which
        partition its time: `phase_wait_ns` (the condition wait with
        nothing to do), `phase_side_ns` (side jobs), `phase_admit_ns`
        (the admission turn: the prefix lookup, page allocation, the
        prefill seam calls), `phase_stage_ns` (the turn's gate and the
        step's staging buffers and their copy), `phase_dispatch_ns`
        (decode seam calls, fused block replays and speculative
        windows), `phase_sync_ns` (the host blocked on the device:
        every readback, the first token's read and an eager chunk's
        copy from pageable memory, which waits for the stream) and
        `phase_commit_ns` (everything after a readback: per-token
        commits, `on_token` callbacks, retires, the observer's folds).
        `prefill_replays` counts the final chunks served by a CUDA
        graph replay, beside `prefill_chunks` and `admitted`.  An eager final
        prefill seam (every engine but the bf16 paged one on the card)
        copies its block table and temperature from host memory itself;
        those copies wait for the chunk's forward inside the call, so
        that wait counts in the admission, not in sync.

        Device work is outstanding from each device call until a sync
        returns.  `starved_ns`: time from a sync that left nothing
        outstanding until the next device call is entered, split into
        `starved_admit_ns` and `starved_commit_ns` by the phase the host
        was in (the rest is staging, side jobs and waiting).  It is a
        lower bound on the device's idle time: the engine cannot see a
        device that finishes its work while the host is still busy, nor
        the launch latency after a call is entered (the staging copies
        of a few kilobytes are the one device work it does not mark).
        `launch_idle_ns`: time inside device calls entered with nothing
        outstanding: the device waits on the launch until its first
        kernels arrive, and then runs them while the call launches more.
        The counters hold the time up to the scheduler thread's last
        commit, admission or wait."""
        with self._cv:
            snap = dict(self.stats)
            snap["active_rows"] = sum(
                1 for s in self._slots if s is not None
            )
            snap["queue_depth"] = len(self._queue)
            dead = self._dead is not None or self._crashed.is_set()
        if self._paged:
            snap["kv_pages_total"] = self._pool.total
            snap["kv_pages_in_use"] = self._pool.in_use
            snap["prefix_cached_pages"] = (
                self._prefix.page_count() if self._prefix else 0
            )
            if self._tier is not None:
                snap.update(self._tier.stats())
        if self._spec_k:
            # The last dispatched window's width (the bucketed max of
            # the rows' adaptive depths): the draft-depth gauge.
            snap["spec_draft_depth"] = self._spec_last_width
        if dead and self._obs.enabled:
            snap["flight_recorder"] = self._obs.recorder.events()
        return snap

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    @property
    def dead(self) -> Optional[BaseException]:
        with self._cv:
            return self._dead

    @property
    def crashed(self) -> bool:
        return self._crashed.is_set()

    def close(self):
        """Stop the scheduler: queued and in-flight requests fail with
        RuntimeError; later submits raise."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=60)
        if self._crashed.is_set() or not self._thread.is_alive():
            self._fail_all(RuntimeError("engine closed"))
            self._release_retained_prefixes()
            self._reset_graphs()  # the graphs' pool goes back

    @property
    def active_rows(self) -> int:
        with self._cv:
            return sum(1 for s in self._slots if s is not None)

    # -- supervision (serving/supervisor.py) -----------------------------
    def attach_supervisor(self, supervisor) -> None:
        with self._cv:
            self._supervisor = supervisor

    def revive(self) -> bool:
        """Restart a crashed scheduler: active rows fail, the KV cache
        is rebuilt, queued requests are preserved.  False when the
        engine is closed or dead."""
        with self._cv:
            if self._closed or self._dead is not None:
                return False
            err = self._crash_error or RuntimeError(
                "engine scheduler crashed"
            )
        self._fail_active_rows(err)
        self._reset_graphs()  # they point at the old caches
        self._cache = self._build_cache()
        self._reset_paged_state()
        self._reset_draft_state()
        with self._cv:
            self._crashed.clear()
            self._crash_error = None
            self.stats["restarts"] += 1
            restarts = self.stats["restarts"]
        log.warning(
            "engine scheduler restarted (fresh cache, %d queued rows "
            "preserved): %s", self.queue_depth, err,
        )
        # Every supervisor restart leaves the pre-restart scheduler tail
        # in stderr before the event stream continues.
        self._obs.event("restart", n=restarts, err=repr(err)[:120])
        self._obs.dump(f"supervisor restart #{restarts}")
        self._start_thread()
        return True

    def kill(self, err: BaseException) -> None:
        """Mark the engine permanently failed: everything queued or in
        flight fails and later submits raise.  The flight recorder
        dumps, to stderr and into snapshot()."""
        with self._cv:
            self._dead = err
        self._obs.event("kill", err=repr(err)[:120])
        self._fail_all(err)
        self._obs.dump(f"engine death: {err!r}"[:200])

    # -- scheduler -------------------------------------------------------
    def _build_cache(self):
        """A fresh page pool (+ the reserved null page 0), or fresh
        contiguous slot rows when not paged."""
        if self._shards:
            return [G.init_decode_cache(sh.model, sh.hi - sh.lo,
                                        device=sh.device)
                    for sh in self._shards]
        if not self._paged:
            if self.quant:
                return QG.init_quant_decode_cache(
                    self._model, self.n_slots, quant_kv=self._quant_kv,
                    device=self.device,
                )
            return G.init_decode_cache(
                self._model, self.n_slots, device=self.device
            )
        n_phys = self._pool.total + 1
        if self.quant:
            return QG.init_quant_paged_cache(
                self._model, n_phys, self._page, quant_kv=self._quant_kv,
                device=self.device,
            )
        return G.init_paged_cache(
            self._model, n_phys, self._page, device=self.device
        )

    def _reset_graphs(self):
        """Drop every CUDA graph of the engine's seams (before a cache
        they point at is replaced, and at close)."""
        for graphs in (self._fused, self._prefill_graphs,
                       *self._spec_graphs):
            if graphs is not None:
                graphs.reset()

    def _reset_draft_state(self):
        """Zero the drafter cache in place (its draft graphs keep their
        address) and mark every live row's drafter frontier stale, so the
        next window refills it from the engine cache.  Paired with every
        engine-cache rebuild and with a failed draft or fill: drafter
        rows that describe dead state only draft garbage, which verify
        rejects, at the cost of window width."""
        if not self._spec_k:
            return
        for blk in self._draft_cache:
            for buf in blk.values():
                buf.zero_()
        with self._cv:
            for s in self._slots:
                if s is not None:
                    s.draft_upto = 0

    def _start_thread(self):
        self._thread = threading.Thread(
            target=self._loop, name="cb-engine", daemon=True
        )
        self._thread.start()

    def _bucket(self, p_len: int) -> int:
        """Powers of two from the grid, capped at max_seq."""
        edge = self._grid
        while edge < p_len:
            edge *= 2
        return min(edge, self._model.max_seq)

    # -- paged-pool bookkeeping ------------------------------------------
    # owns-pages
    def _reset_paged_state(self):
        """Host bookkeeping reset paired with every cache rebuild: after
        it kv_pages_in_use == 0."""
        if not self._paged:
            return
        self._pool.reset()
        if self._prefix is not None:
            self._prefix.clear()
        with self._cv:
            self._bt_master[:] = 0

    # owns-pages
    def _release_retained_prefixes(self):
        """Give the trie's references back to the pool at close."""
        if self._prefix is not None:
            self._prefix.release_all(self._pool)

    # owns-pages
    def _release_seq_pages(self, seq):
        """Drop a row's page references exactly once."""
        if not self._paged:
            return
        with self._cv:
            pages, seq.page_refs = seq.page_refs, []
        for pid in pages:
            self._pool.unref(pid)

    # owns-pages
    def _release_prefill(self, pf):
        """Drop every page reference an in-progress admission holds."""
        if pf.bt_row is None:
            return
        with self._cv:
            shared, pf.shared_ids = pf.shared_ids, []
            donor, pf.donor = pf.donor, None
            priv, pf.priv = pf.priv, []
        for pid in shared:
            self._pool.unref(pid)
        if donor is not None:
            self._pool.unref(donor)
        for pid in priv:
            self._pool.unref(pid)

    def _cache_intact(self) -> bool:
        """False when a failed device call left the cache's state
        unknowable.  The port updates the cache in place and donates
        nothing, so that happens only when the card itself faulted: a
        CUDA error is sticky and surfaces at the next synchronize.  A
        CPU cache is always intact."""
        if self.device.type != "cuda":
            return True
        try:
            for dev in self._devices:
                torch.cuda.synchronize(dev)
        except Exception:  # pylint: disable=broad-except
            return False
        return True

    # owns-pages
    def _lose_cache(self, err, at: str) -> int:
        """The lost-device-state path of a failed admission finish, page
        adoption or tier promotion: every active row fails with `err`,
        the graphs are dropped and the cache is rebuilt (the queue is
        preserved).  Returns the rows failed."""
        self._obs.event("cache_lost", at=at)
        n = self._fail_active_rows(err)
        log.error(
            "%s failed with the device state lost: %d active row(s) "
            "failed with it; rebuilding", at, n,
        )
        self._reset_graphs()
        self._cache = self._build_cache()
        self._reset_paged_state()
        self._reset_draft_state()
        return n

    # owns-pages
    def _alloc_private_pages(self, n):
        """Allocate `n` pages, evicting LRU prefix pages under pressure
        (only the trie's references drop: pages active rows still map
        free when those rows retire).  With a tiered store, eviction
        DEMOTES each victim's bytes first (_demote_until).  None on
        exhaustion."""
        if self._pool.free_count < n and self._prefix is not None:
            if self._tier is not None:
                released = self._demote_until(n)
            else:
                released = self._prefix.evict_until(self._pool, n)
            if released:
                with self._cv:
                    self.stats["prefix_evictions"] += released
        try:
            return self._pool.alloc(n)
        except kvpool.PoolExhausted:
            return None

    # -- tiered page store -----------------------------------------------
    # owns-pages, transfers-pages-to: drop_leaf
    def _demote_until(self, n_free_needed: int) -> int:
        """The tier-aware evict_until: serialize the LRU leaves' pages
        into the store, a generation at a time (so the store holds the
        per-depth chain the promoter walks), then drop the leaves.
        Returns trie pages released; a failed serialization evicts that
        batch without spilling (memory pressure must resolve even when
        the tier is sick)."""
        released = 0
        while self._pool.free_count < n_free_needed:
            deficit = n_free_needed - self._pool.free_count
            victims = self._prefix.lru_leaves(deficit)
            if not victims:
                break
            try:
                self._demote_batch(victims)
            except Exception:  # pylint: disable=broad-except
                log.warning(
                    "tier demotion failed; evicting %d page(s) "
                    "without spilling", len(victims), exc_info=True,
                )
            dropped = 0
            for path, _ in victims:
                dropped += self._prefix.drop_leaf(path, self._pool)
            released += dropped
            if not dropped:
                break
        return released

    # borrows-pages
    def _demote_batch(self, victims) -> None:
        """Serialize one victim generation, [(token path, page id)] from
        lru_leaves, into the store: pin, ONE gather over the victim
        pages read back synchronously, then a one-page entry a victim
        keyed by its root-to-leaf token path.  Entries the store holds
        already are skipped (prefix KV is deterministic)."""
        todo = [
            (path, pid) for path, pid in victims
            if self._tier.contains(self._tier.key_of(path)) is None
        ]
        if not todo:
            return
        pages = [pid for _, pid in todo]
        self._pool.export_pages(pages)  # pin under the gather
        try:
            parts = self._page_gather_fn(self._cache, pages)
            self._clock.launched()
            gathered = [t.cpu() for t in parts]
            sig = self._page_layout_sig()
            total = 0
            for j, (path, _) in enumerate(todo):
                leaves, blob = self._serialize_pages(
                    [a[j:j + 1] for a in gathered], 1
                )
                meta = {
                    "n_pages": 1,
                    "tokens_covered": len(path),
                    "sig": sig,
                    "leaves": leaves,
                }
                self._tier.put(self._tier.key_of(path), meta, blob)
                total += len(blob)
        finally:
            self._pool.release_pages(pages)
        with self._cv:
            self.stats["kv_tier_demoted_pages"] += len(todo)
            # The measured serialized page size feeds the load-cost
            # estimate (the first measurement seeds it).
            pb = total / len(todo)
            self._tier_page_bytes = (
                pb if self._tier_page_bytes <= 0
                else 0.8 * self._tier_page_bytes + 0.2 * pb
            )

    def _should_tier_load(self, tier: str, n_pages: int) -> bool:
        """Promote or recompute: the estimated load wall (serialized
        bytes over the tier's measured bytes/s) against the estimated
        recompute wall at tier_recompute_tok_s.  An unmeasured tier
        loads (the first promotion is the measurement), and the 8th
        consecutive skip loads anyway, so a stale estimate cannot shut
        a tier off for good."""
        with self._cv:
            bps = self._tier_bps.get(tier, 0.0)
            page_bytes = self._tier_page_bytes
            if bps <= 0 or page_bytes <= 0:
                self._tier_skip_streak[tier] = 0
                return True
            est_load = n_pages * page_bytes / bps
            est_recompute = (
                n_pages * self._page / self._tier_recompute_tok_s
            )
            if est_load <= est_recompute:
                self._tier_skip_streak[tier] = 0
                return True
            streak = self._tier_skip_streak.get(tier, 0) + 1
            if streak >= 8:
                self._tier_skip_streak[tier] = 0
                return True  # probe: re-measure a tier we keep skipping
            self._tier_skip_streak[tier] = streak
            self.stats["kv_tier_load_skipped"] += 1
            return False

    def _note_tier_load(self, tier: str, nbytes: int,
                        dt: float) -> None:
        """Fold one measured promotion into the tier's bytes/s EMA.  The
        first sample is excluded: it carries one-time set-up (the first
        launches of the gather and scatter ops)."""
        with self._cv:
            n = self._tier_n.get(tier, 0)
            self._tier_n[tier] = n + 1
            if n == 0:
                return
            bps = nbytes / max(dt, 1e-9)
            prev = self._tier_bps.get(tier, 0.0)
            self._tier_bps[tier] = (
                bps if prev <= 0 else 0.8 * prev + 0.2 * bps
            )

    # owns-pages, transfers-pages-to: adopt
    def _tier_promote_core(self, toks) -> tuple:
        """Promote the longest consecutive tier-resident continuation
        of `toks` past the trie's match back into the pool: probe,
        cost-gate (_should_tier_load), load, then alloc -> one scatter
        of exactly the run's pages -> trie adopt.  Returns (pages
        promoted, deepest tier touched, serialized bytes loaded), or
        (0, None, 0) when nothing usable was found or the rule said
        recompute.  Scheduler thread only.  Every failure is clean: a
        corrupt entry truncates the run (the store counted and deleted
        it), and exhaustion or a failed scatter gives every reference
        back, so the ticket recomputes and never fails."""
        page = self._page
        n_full = toks.size // page
        full_ids, _ = self._prefix.match(toks)
        base = len(full_ids)
        if base >= n_full:
            return 0, None, 0
        run = self._tier.longest_run(toks, base)
        if not run:
            self._tier.note_miss()
            return 0, None, 0
        deepest = kvtier.DISK if kvtier.DISK in run else kvtier.HOST
        if not self._should_tier_load(deepest, len(run)):
            return 0, None, 0
        t0 = time.monotonic()
        sig = self._page_layout_sig()
        handles = []
        try:
            for j in range(len(run)):
                key = self._tier.key_of(toks[: (base + 1 + j) * page])
                try:
                    h = self._tier.get(key)
                except kvtier.TierCorrupt:
                    break  # counted and deleted; keep the run so far
                if h is None:
                    break
                if h.meta.get("sig") != sig or h.n_pages != 1:
                    h.close()
                    self._tier.mark_corrupt(key)
                    break
                handles.append(h)
            if not handles:
                with self._cv:
                    self.stats["kv_tier_load_failures"] += 1
                return 0, None, 0
            m = len(handles)
            deepest = (
                kvtier.DISK
                if any(h.tier == kvtier.DISK for h in handles)
                else kvtier.HOST
            )
            nbytes = sum(len(h.blob) for h in handles)
            # One scatter for the run: per pool leaf, the entries'
            # pages concatenated.
            per_entry = [
                self._deserialize_pages(h.meta, h.blob, 1) for h in handles
            ]
            parts = [
                torch.cat([pe[i] for pe in per_entry])
                for i in range(len(per_entry[0]))
            ]
            # Reference the matched chain BEFORE allocating: the alloc
            # may demote or evict those very nodes, and adopt() takes
            # page_ids entries the caller owns.
            for pid in full_ids:
                self._pool.ref(pid)
            priv = self._alloc_private_pages(m)
            if priv is None:
                for pid in full_ids:
                    self._pool.unref(pid)
                with self._cv:
                    self.stats["kv_tier_load_failures"] += 1
                return 0, None, 0
            page_ids = list(full_ids) + list(priv)
            ticket = None
            try:
                ticket = kvpool.MigrationTicket(priv, initial="streaming")
                self._cache = self._page_scatter_fn(self._cache, priv, parts)
                self._clock.launched()
            except BaseException as e:
                for pid in priv:
                    self._pool.unref(pid)
                for pid in full_ids:
                    self._pool.unref(pid)
                if ticket is not None:
                    ticket.mark_released()
                with self._cv:
                    self.stats["kv_tier_load_failures"] += 1
                if not self._cache_intact():
                    self._lose_cache(e, "tier_promote")
                    return 0, None, 0
                log.warning(
                    "tier promotion scatter failed; recomputing: %r", e
                )
                return 0, None, 0
            try:
                _adopted, unused = self._prefix.adopt(
                    toks[: (base + m) * page], page_ids, self._pool
                )
            except Exception:  # pylint: disable=broad-except
                # adopt() is stage-and-commit: an exception means no
                # reference moved, and every page_ids entry is ours.
                for pid in priv:
                    self._pool.unref(pid)
                for pid in full_ids:
                    self._pool.unref(pid)
                ticket.mark_released()
                with self._cv:
                    self.stats["kv_tier_load_failures"] += 1
                return 0, None, 0
            ticket.mark_adopted()
            # Entries whose node existed already (normally the matched
            # chain itself) give their reference back.
            for pid in unused:
                self._pool.unref(pid)
        finally:
            for h in handles:
                h.close()
        dt = time.monotonic() - t0
        self._note_tier_load(deepest, nbytes, dt)
        self._tier.note_promoted(m)
        if self._tier_fetch_hist is not None:
            self._tier_fetch_hist.observe(dt, deepest)
        with self._cv:
            self.stats["kv_tier_promoted_pages"] += m
        return m, deepest, nbytes

    def tier_probe(self, tokens) -> dict:
        """Where `tokens`' prefix lives on this engine: {"page_size",
        "hbm_pages" (the trie's full-page match), "host_pages" /
        "disk_pages" (the consecutive tier continuation past it)}.
        Index walks only, so any thread may call it."""
        out = {
            "page_size": self._page,
            "hbm_pages": 0, "host_pages": 0, "disk_pages": 0,
        }
        if self._prefix is None:
            return out
        toks = np.asarray(tokens, np.int32).reshape(-1)
        full_ids, _ = self._prefix.match(toks)
        out["hbm_pages"] = len(full_ids)
        if self._tier is not None:
            for tier in self._tier.longest_run(toks, len(full_ids)):
                out[f"{tier}_pages"] += 1
        return out

    def promote_prefix_pages(self, tokens,
                             timeout_s: float = 30.0) -> int:
        """Promote `tokens`' tier-resident continuation into the pool
        and the trie, between scheduler turns.  Returns pages promoted
        (0: nothing tier-resident, the cost rule said recompute, or a
        clean load failure)."""
        if self._prefix is None:
            raise RuntimeError(
                "tier promotion needs the paged engine with the radix "
                "prefix cache enabled"
            )
        if self._tier is None:
            return 0
        toks = np.asarray(tokens, np.int32).reshape(-1)

        # owns-pages, transfers-pages-to: _tier_promote_core
        def job():
            promoted, _, _ = self._tier_promote_core(toks)
            return promoted

        return self._side_call(job, timeout_s)

    # -- KV page migration -----------------------------------------------
    def _page_layout_sig(self) -> list:
        """Wire signature of this engine's pool layout: the page size and
        the backend, then per leaf (dtype name, per-page shape).  bf16
        and the int8 twin differ, and so do the two packages (the
        reference's signature names no backend), so an adopter rejects
        a blob of another layout instead of scattering garbage KV."""
        return [[self._page, "torch"]] + [
            [_dtype_name(leaf.dtype), [int(d) for d in leaf.shape[1:]]]
            for leaf in G._pool_leaves(self._cache)
        ]

    @staticmethod
    def _serialize_pages(gathered, n: int):
        """(leaf metas, blob) for the first `n` pages of each gathered
        leaf, leaf after leaf in one byte string.  Each leaf is copied
        into one host buffer through a uint8 view of it (numpy has no
        bfloat16), synchronously, so no byte is read before it lands;
        the buffer's bytes are the blob."""
        leaves = [t[:n] for t in gathered]
        sizes = [t.numel() * t.element_size() for t in leaves]
        host = torch.empty((sum(sizes),), dtype=torch.uint8)
        metas, off = [], 0
        for t, nb in zip(leaves, sizes):
            host[off:off + nb].view(t.dtype).view(t.shape).copy_(t)
            metas.append({"dtype": _dtype_name(t.dtype),
                          "shape": [int(d) for d in t.shape[1:]]})
            off += nb
        return metas, host.numpy().tobytes()

    @staticmethod
    def _deserialize_pages(meta, blob: bytes, n: int):
        """The per-leaf (n, ...) host tensors of a blob, read in place
        with torch.frombuffer.  A truncated or over-long blob raises
        ValueError (a blob never half-scatters)."""
        parts = []
        off = 0
        with warnings.catch_warnings():
            # A bytes blob is read-only; its tensors are only read.
            warnings.simplefilter("ignore", UserWarning)
            for lm in meta["leaves"]:
                dt = _DTYPES.get(lm["dtype"])
                if dt is None:
                    raise ValueError(f"unknown leaf dtype {lm['dtype']!r}")
                shape = tuple(int(d) for d in lm["shape"])
                nbytes = n * math.prod(shape) * dt.itemsize
                if off + nbytes > len(blob):
                    raise ValueError(
                        f"migration blob truncated ({len(blob)} bytes, "
                        f"need {off + nbytes})"
                    )
                raw = torch.frombuffer(blob, dtype=torch.uint8,
                                       count=nbytes, offset=off)
                parts.append(raw.view(dt).reshape((n,) + shape))
                off += nbytes
        if off != len(blob):
            raise ValueError(
                f"migration blob size mismatch ({len(blob)} bytes, "
                f"layout consumes {off})"
            )
        return parts

    def export_prefix_pages(self, tokens, move: bool = False,
                            timeout_s: float = 30.0):
        """Serialize the trie's pages for `tokens`' full prompt pages:
        (meta, blob), or None when the trie holds no full page of the
        prefix.  meta carries the leaf layout ("leaves"), the layout
        signature ("sig", which the adopter must match), "n_pages" and
        "tokens_covered".  Runs on the scheduler thread with the pages
        pinned for the gather.  move=True also releases the exported
        chain (and its subtree) from this engine's trie; rows still
        mapping those pages keep them on their own references."""
        if self._prefix is None:
            raise RuntimeError(
                "page export needs the paged engine with the radix "
                "prefix cache enabled"
            )
        toks = np.asarray(tokens, np.int32).reshape(-1)

        # borrows-pages
        def job():
            full_ids, _ = self._prefix.match(toks)
            if not full_ids:
                return None
            n = len(full_ids)
            ticket = kvpool.MigrationTicket(full_ids)
            self._pool.export_pages(full_ids)
            try:
                ticket.mark_streaming()
                gathered = self._page_gather_fn(self._cache, full_ids)
                self._clock.launched()
                leaves, blob = self._serialize_pages(gathered, n)
            finally:
                self._pool.release_pages(full_ids)
                ticket.mark_released()
            if move:
                self._prefix.release_exported(
                    toks[: n * self._page], self._pool
                )
            meta = {
                "n_pages": n,
                "tokens_covered": n * self._page,
                "sig": self._page_layout_sig(),
                "leaves": leaves,
            }
            with self._cv:
                self.stats["kv_pages_exported"] += n
                self.stats["kv_export_bytes"] += len(blob)
            return meta, blob

        return self._side_call(job, timeout_s)

    def adopt_prefix_pages(self, tokens, meta, blob: bytes,
                           timeout_s: float = 30.0) -> int:
        """Adopt a blob's pages into the pool AND the trie, so the next
        admission sharing the prefix hits.  Returns pages adopted (0
        when every page existed already; the duplicates free).  Failure
        is clean: allocation is all-or-nothing (PoolExhausted holding
        nothing), and a bad blob or layout mismatch raises ValueError
        with no page held; a scatter that left the device state lost
        fails the active rows and rebuilds the cache."""
        if self._prefix is None:
            raise RuntimeError(
                "page adoption needs the paged engine with the radix "
                "prefix cache enabled"
            )
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n = int(meta.get("n_pages", 0))
        if n < 1:
            return 0
        if meta.get("sig") != self._page_layout_sig():
            with self._cv:
                self.stats["kv_adopt_failures"] += 1
            raise ValueError(
                "migration blob layout does not match this engine's "
                "KV pool (bf16 vs int8, page size, model shape or "
                "backend)"
            )
        if n * self._page > toks.size:
            with self._cv:
                self.stats["kv_adopt_failures"] += 1
            raise ValueError(
                f"{n} migrated pages need {n * self._page} tokens, "
                f"got {toks.size}"
            )

        # owns-pages, transfers-pages-to: adopt
        def job():
            pages = self._alloc_private_pages(n)
            if pages is None:
                with self._cv:
                    self.stats["kv_adopt_failures"] += 1
                raise kvpool.PoolExhausted(
                    f"cannot adopt {n} pages ({self._pool.free_count} "
                    f"free of {self._pool.total} after eviction)"
                )
            ticket = None
            try:
                ticket = kvpool.MigrationTicket(pages, initial="streaming")
                parts = self._deserialize_pages(meta, blob, n)
                self._cache = self._page_scatter_fn(self._cache, pages,
                                                    parts)
                self._clock.launched()
            except BaseException as e:
                for p in pages:
                    self._pool.unref(p)
                if ticket is not None:
                    ticket.mark_released()
                with self._cv:
                    self.stats["kv_adopt_failures"] += 1
                if not self._cache_intact():
                    self._lose_cache(e, "page_adopt")
                raise
            try:
                adopted, unused = self._prefix.adopt(
                    toks[: n * self._page], pages, self._pool
                )
            except Exception:
                # adopt() is stage-and-commit: no reference moved, and
                # the pages are still ours.  Not BaseException: on an
                # interrupt the commit state is unknowable, and a leak
                # beats a double release.
                for p in pages:
                    self._pool.unref(p)
                ticket.mark_released()
                with self._cv:
                    self.stats["kv_adopt_failures"] += 1
                raise
            ticket.mark_adopted()
            for p in unused:
                self._pool.unref(p)
            with self._cv:
                self.stats["kv_pages_adopted"] += adopted
                self.stats["kv_adopt_bytes"] += len(blob)
            return adopted

        return self._side_call(job, timeout_s)

    def _loop(self):
        torch.set_grad_enabled(False)  # thread-local: inference only
        clk = self._clock
        clk.restart()
        crash = None
        try:
            while True:
                with self._cv:
                    while (
                        not self._queue
                        and self.active_rows == 0
                        and self._pending is None
                        and not self._side_jobs
                    ):
                        if self._closed:
                            return
                        clk.enter(_WAIT)
                        clk.fold(self.stats)
                        self._cv.wait()
                    if self._closed:
                        self._fail_all(RuntimeError("engine closed"))
                        return
                # Side jobs first (an admission about to run may be the
                # one waiting on adopted pages), then one unit of
                # admission work (at most one prefill chunk), then one
                # pipeline turn.
                clk.enter(_SIDE)
                self._run_side_jobs()
                clk.enter(_ADMIT)
                self._admit()
                clk.enter(_STAGE)
                self._step()
        except Exception as e:  # pylint: disable=broad-except
            crash = e
        finally:
            # Close the thread's profiler range before a revival can
            # start the next thread.
            clk.enter(_WAIT)
        if crash is not None:
            self._on_crash(crash)

    def _on_crash(self, err):
        """Unhandled scheduler failure: supervised, preserve the queue
        and signal revive(); unsupervised, fail everything and mark the
        engine dead."""
        log.error("engine scheduler crashed: %r", err)
        self._obs.event("crash", err=repr(err)[:120])
        with self._cv:
            self._crash_error = err
            supervisor = self._supervisor
        self._crashed.set()
        if supervisor is None:
            with self._cv:
                self._dead = err
            self._fail_all(err)
            self._obs.dump("engine death (unsupervised crash)")

    def _fail_ticket(self, ticket, err):
        """Fail ONE request: queued rows are skipped at admit, active
        rows retire at the next step boundary, the submitter wakes."""
        with self._cv:
            if ticket.state not in ("done", "failed"):
                # transition: queued|admitted|streaming -> failed
                ticket.state = "failed"
        ticket.cancelled = True
        if ticket.error is None:
            ticket.error = err
        ticket.done.set()
        self._fire_done_callbacks(ticket)

    def _fire_done_callbacks(self, ticket):
        with self._cv:
            fired = ticket.resolve_fire()
        for cb in fired:
            try:
                cb()
            except Exception:  # pylint: disable=broad-except
                log.exception("submit done-callback failed")

    def _drain_pending(self):
        """Flush the lag window WITHOUT committing (failure paths):
        wait for the in-flight step so nothing outlives a rebuild, and
        reset `prev` so a poisoned output never feeds a later step."""
        with self._cv:
            pending, self._pending = self._pending, None
        self._last_nxt = self._zeros_tok()
        if pending is None:
            return
        try:
            pending.nxt.cpu()
        except Exception:  # pylint: disable=broad-except
            pass  # the step died with the failure being handled

    def _fail_active_rows(self, err) -> int:
        """Retire every active row as failed (device state lost);
        queued requests are untouched.  Drains the lag window first."""
        self._drain_pending()
        with self._cv:
            pf, self._prefilling = self._prefilling, None
            seqs = [s for s in self._slots if s is not None]
            self._slots = [None] * self.n_slots
            self._bt_master[:] = 0
            self.stats["rows_failed"] += len(seqs)
            self._cv.notify_all()
        if pf is not None:
            self._release_prefill(pf)
        now = time.monotonic()
        for s in seqs:
            self._release_seq_pages(s)
            self._obs.retired(s, now, reason="failed")
        for t in {id(s.ticket): s.ticket for s in seqs}.values():
            self._fail_ticket(t, err)
        return len(seqs)

    # -- scheduler-thread side jobs (page export / adopt / promote) -----
    def _run_side_jobs(self):
        """Run every queued errand on the scheduler thread (_SideJob)."""
        while True:
            with self._cv:
                if not self._side_jobs:
                    return
                job = self._side_jobs.popleft()
            try:
                job.result = job.fn()
            except BaseException as e:  # pylint: disable=broad-except
                job.error = e
            job.done.set()

    def _side_call(self, fn, timeout_s: float):
        """Run `fn` on the scheduler thread and wait for its result.  A
        job queued across a revive runs after it, against the rebuilt,
        empty pool."""
        job = _SideJob(fn)
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._dead is not None:
                raise RuntimeError(
                    f"engine failed permanently: {self._dead}"
                )
            self._side_jobs.append(job)
            self._cv.notify_all()
        if not job.done.wait(timeout=timeout_s):
            raise RuntimeError(
                f"engine side job timed out after {timeout_s:.0f}s"
            )
        if job.error is not None:
            raise job.error
        return job.result

    def _fail_side_jobs(self, err):
        with self._cv:
            jobs = list(self._side_jobs)
            self._side_jobs.clear()
        for j in jobs:
            j.error = err
            j.done.set()

    def _fail_all(self, err):
        self._fail_side_jobs(err)
        self._drain_pending()
        with self._cv:
            pf, self._prefilling = self._prefilling, None
            seqs = [s for s in self._slots if s is not None]
            seqs.extend(self._queue)
            self._queue.clear()
            self._slots = [None] * self.n_slots
            self._bt_master[:] = 0
        if pf is not None:
            self._release_prefill(pf)
        for s in seqs:
            self._release_seq_pages(s)
        now = time.monotonic()
        for s in seqs:
            # Active rows have open traces (queued ones never opened
            # one): seal them so the ring records the death's victims.
            if s.trace is not None:
                self._obs.retired(s, now, reason="failed")
        for t in {id(s.ticket): s.ticket for s in seqs}.values():
            self._fail_ticket(t, err)

    def _plan_chunks(self, p_bucket: int, p_len: int,
                     resume: int = 0) -> List[tuple]:
        """(start, width) chunk plan covering [resume, >= p_len): the
        last chunk contains the sampling row, the bucket tail past it is
        skipped, and widths follow the buddy rule (largest power of two
        dividing the start, capped at prefill_chunk)."""
        c = self._prefill_chunk
        if c <= 0:
            return [(0, p_bucket)]
        pos = resume
        out = []
        while pos < p_len:
            if pos == 0:
                w = min(c, p_bucket)
            else:
                w = min(pos & -pos, c, p_bucket - pos)
            out.append((pos, w))
            pos += w
        return out

    def _match_prefix(self, seq):
        """Prefix-cache lookup: (shared_ids, donor, match_end, resume,
        write_from) — see the reference's _match_prefix."""
        page = self._page
        if (
            self._prefix is None
            or self._prefill_chunk <= 0
            or seq.plen < page
        ):
            return [], None, 0, 0, 0
        full_ids, partial = self._prefix.match(seq.prompt[: seq.plen])
        match_end = len(full_ids) * page + (partial[1] if partial else 0)
        donor = None
        shared_full = match_end // page
        if match_end % page:
            resume_cand = (
                min(match_end, seq.plen - 1) // self._grid
            ) * self._grid
            if partial is not None and resume_cand > shared_full * page:
                # Worth adopting copy-on-write: the copy skips real
                # prefill compute.
                donor = partial[0]
            else:
                match_end = shared_full * page  # drop the partial
        shared_full = match_end // page
        resume = 0
        if match_end:
            resume = (
                min(match_end, seq.plen - 1) // self._grid
            ) * self._grid
        return (
            full_ids[:shared_full], donor, match_end, resume,
            shared_full * page,
        )

    # owns-pages
    def _start_admission(self, seq, free) -> Optional[_Prefill]:
        """Build the _Prefill for a newly popped request: bucketing,
        prefix match, page allocation (evicting under pressure),
        block-table construction.  None when the request cannot get
        pages YET (requeued at the front) or EVER (ticket failed)."""
        p_bucket = self._bucket(seq.plen)
        padded = np.zeros((1, p_bucket), np.int32)
        padded[0, : seq.plen] = seq.prompt
        if not self._paged:
            return _Prefill(
                seq, free, padded, self._plan_chunks(p_bucket, seq.plen)
            )
        page = self._page
        last_page = min(
            (seq.plen + seq.max_new - 1) // page,
            self._pages_per_row - 1,
        )
        trie_pages = (
            self._prefix.page_count() if self._prefix is not None else 0
        )
        if (
            seq.page_wait
            and self._pool.free_count + trie_pages < seq.page_wait
        ):
            # A page-starved requeued head whose need nothing has moved
            # yet: skip the re-match while something can still free.
            with self._cv:
                others = any(
                    s is not None and s is not seq for s in self._slots
                )
                can_wait = others or self._pending is not None
                if can_wait:
                    self._queue.appendleft(seq)
                    if self._slots[free] is seq:
                        self._slots[free] = None
                    self._cv.notify_all()
            if can_wait:
                return None
        shared_ids, donor, match_end, resume, write_from = (
            self._match_prefix(seq)
        )
        if (
            self._tier is not None
            and self._prefill_chunk > 0
            and seq.plen >= page
        ):
            # Consult the tiers before recomputing: promote the longest
            # tier-resident continuation of the prompt (a direct call:
            # this is the scheduler thread), then match again, so the
            # admission shares the promoted pages like any trie hit.
            t0p = time.monotonic()
            promoted, ptier, _ = self._tier_promote_core(
                np.asarray(seq.prompt[: seq.plen], np.int32)
            )
            if promoted:
                seq.tier_stamp = (t0p, time.monotonic(), ptier, promoted)
                shared_ids, donor, match_end, resume, write_from = (
                    self._match_prefix(seq)
                )
        priv = None
        for attempt in (0, 1):
            if attempt == 1:
                # Retry unshared before judging the request unadmittable:
                # our own references may pin the pages we need.
                if not shared_ids and donor is None:
                    break
                shared_ids, donor = [], None
                match_end = resume = write_from = 0
            # Reference the matched pages BEFORE any eviction can run.
            for pid in shared_ids:
                self._pool.ref(pid)
            if donor is not None:
                self._pool.ref(donor)
            n_priv = last_page + 1 - len(shared_ids)
            priv = self._alloc_private_pages(n_priv)
            if priv is not None:
                break
            for pid in shared_ids:
                self._pool.unref(pid)
            if donor is not None:
                self._pool.unref(donor)
        shared_full = len(shared_ids)
        if priv is None:
            with self._cv:
                others = sum(
                    1 for s in self._slots
                    if s is not None and s is not seq
                )
                waiting = others > 0 or self._pending is not None
                if waiting:
                    seq.page_wait = max(1, n_priv)
                    self._queue.appendleft(seq)
                if self._slots[free] is seq:
                    self._slots[free] = None
                self._cv.notify_all()
            if not waiting:
                err = RuntimeError(
                    f"request needs {last_page + 1} KV pages but the "
                    f"pool holds {self._pool.total} (free "
                    f"{self._pool.free_count}); raise kv_pages or "
                    f"shorten the request"
                )
                log.error("admission failed: %s", err)
                self._fail_ticket(seq.ticket, err)
            return None
        seq.page_wait = 0
        try:
            bt = np.zeros((self._pages_per_row,), np.int32)
            bt[:shared_full] = shared_ids
            bt[shared_full:last_page + 1] = priv
            pf = _Prefill(
                seq, free, padded,
                self._plan_chunks(p_bucket, seq.plen, resume=resume),
            )
            pf.bt_row = bt
            # Preload reads THROUGH the donor; the finish scatter writes
            # the fresh private page at the same logical index.
            pf.bt_pre = bt
            if donor is not None:
                pf.bt_pre = bt.copy()
                pf.bt_pre[shared_full] = donor
            pf.write_from = write_from
            pf.resume = resume
            pf.match_end = match_end
            pf.donor = donor
            pf.shared_ids = list(shared_ids)
            pf.priv = list(priv)
        except BaseException:
            # A raise while wiring the block table would strand every
            # reference this admission took (its ticket fails upstream
            # and nothing else releases them): give them back first.
            for pid in shared_ids:
                self._pool.unref(pid)
            if donor is not None:
                self._pool.unref(donor)
            for pid in priv:
                self._pool.unref(pid)
            raise
        with self._cv:
            if self._prefix is not None:
                self.stats["prefix_lookup_tokens"] += seq.plen
                self.stats["prefix_hit_tokens"] += match_end
                if match_end:
                    self.stats["prefix_hits"] += 1
                else:
                    self.stats["prefix_misses"] += 1
                if donor is not None:
                    self.stats["cow_copies"] += 1
        return pf

    # owns-pages
    def _admit(self):
        """Advance admission by ONE unit of prefill work (at most one
        chunk).  Non-final chunks touch only the scratch; the final
        chunk samples tok0 and scatters into the row's pages.  A failed
        prefill fails only its ticket."""
        with self._cv:
            pf = self._prefilling
            seq = free = None
            if pf is None:
                free = next(
                    (i for i, s in enumerate(self._slots) if s is None),
                    None,
                )
                if free is not None:
                    while self._queue:
                        cand = self._queue.popleft()
                        if cand.ticket.cancelled:
                            continue
                        seq = cand
                        self._slots[free] = seq  # reserve before device work
                        seq.ticket.admitted_rows += 1
                        if seq.ticket.state == "queued":
                            # transition: queued -> admitted
                            seq.ticket.state = "admitted"
                        break
        if pf is None:
            if seq is None:
                return
            pf = self._start_admission(seq, free)
            if pf is None:
                return
            with self._cv:
                self._prefilling = pf
            seq.t_admit = time.monotonic()
            self._obs.admitted(seq, seq.t_admit)
        seq = pf.seq
        if seq.ticket.cancelled:
            with self._cv:
                self._prefilling = None
                if self._slots[pf.slot] is seq:
                    self._slots[pf.slot] = None
                self._cv.notify_all()
            self._release_prefill(pf)
            self._obs.retired(seq, time.monotonic(), reason="cancelled")
            return
        start, width = pf.plan[pf.pi]
        last = pf.pi == len(pf.plan) - 1
        dev, pmodel = self._admission_target(pf.slot)
        clk = self._clock
        graphs = self._prefill_graphs if last else None
        chunk = torch.from_numpy(pf.padded[:, start: start + width])
        if graphs is None:
            # A copy from pageable memory waits for the stream: a sync.
            # (The final chunk's graph copies from pinned staging.)
            clk.enter(_SYNC)
            chunk = chunk.to(dev)
            clk.synced(_ADMIT)
        t_chunk = time.monotonic()
        replays = graphs.replays if graphs is not None else 0
        try:
            clk.launch()
            if pf.scratch is None:
                buf, pf.scratch = self._scratch[dev]
                buf.zero_()
                if pf.resume > 0:
                    # Prefix preload: the matched pages' KV into the
                    # scratch, so resumed chunks attend over them.
                    pf.scratch = self._preload_fn(
                        self._cache, pf.scratch, pf.bt_pre, pf.match_end
                    )
            if not last:
                pf.scratch = self._prefill_chunk_fn(
                    pmodel, pf.scratch, chunk, start
                )
                clk.launched()
                pf.pi += 1
                with self._cv:
                    self.stats["prefill_chunks"] += 1
                self._obs.chunk_done(
                    seq, t_chunk, time.monotonic(), width, last=False
                )
                return
            kwargs = {}
            if seq.top_k is not None:
                kwargs["top_k"] = int(seq.top_k)
            if seq.top_p is not None:
                kwargs["top_p"] = float(seq.top_p)
            self._cache, tok0 = self._prefill_fn(
                self._cache, pf.scratch, chunk,
                pf.bt_row if self._paged else pf.slot, start,
                pf.write_from, seq.plen, seq.temp, self._gen, **kwargs,
            )
            clk.launched()
            pf.scratch = None
            clk.enter(_SYNC)
            tok0 = int(tok0[0])
            clk.synced(_ADMIT)
        except Exception as e:  # pylint: disable=broad-except
            clk.launched()
            with self._cv:
                self._prefilling = None
                if self._slots[pf.slot] is seq:
                    self._slots[pf.slot] = None
                self.stats["admit_failures"] += 1
                self._cv.notify_all()
            self._release_prefill(pf)
            self._obs.event(
                "admit_fail",
                trace=seq.trace.trace_id if seq.trace else "?",
                chunk=f"{pf.pi + 1}/{len(pf.plan)}",
                err=repr(e)[:120],
            )
            log.error(
                "admit failed for request row %d at prefill chunk "
                "%d/%d (only its ticket fails; %d rows in flight "
                "continue): %s",
                seq.row_i, pf.pi + 1, len(pf.plan), self.active_rows, e,
            )
            self._obs.retired(seq, time.monotonic(), reason="admit_failed")
            self._fail_ticket(seq.ticket, e)
            if last and not self._cache_intact():
                # Only the final chunk writes the engine cache; a device
                # fault there takes every in-flight row's KV with it.
                self._lose_cache(e, "prefill_finish")
            return
        donor = None
        with self._cv:
            self._prefilling = None
            self.stats["admitted"] += 1
            self.stats["prefill_chunks"] += 1
            if graphs is not None:
                self.stats["prefill_replays"] += graphs.replays - replays
            self.stats["max_active"] = max(
                self.stats["max_active"], self.active_rows
            )
            clk.fold(self.stats)
            alive = self._slots[pf.slot] is seq
            if alive:
                # The row owns its page references now; publishing the
                # block table makes it dispatchable.
                seq.page_refs = pf.shared_ids + pf.priv
                pf.shared_ids, pf.priv = [], []
                donor, pf.donor = pf.donor, None
                if self._paged:
                    self._bt_master[pf.slot] = pf.bt_row
        if donor is not None:
            self._pool.unref(donor)
        if not alive:
            self._release_prefill(pf)
        elif self._prefix is not None:
            # Retain the prompt's full pages for later admissions.
            n_full = seq.plen // self._page
            if n_full:
                adopted = self._prefix.insert(
                    seq.prompt[: n_full * self._page],
                    [int(p) for p in pf.bt_row[:n_full]],
                    self._pool,
                )
                if adopted:
                    with self._cv:
                        self.stats["prefix_inserted_pages"] += adopted
        if alive and self._spec_k:
            # The drafter's row gets the prompt's KV from the engine
            # cache, without a second prefill.  A failure costs only
            # draft quality, so it zeroes the drafter cache instead of
            # failing the admitted ticket.
            try:
                clk.launch()
                self._draft_fill_fn(
                    self._draft_cache, self._cache, pf.slot, seq.plen,
                    pf.bt_row if self._paged else None,
                )
                clk.launched()
                seq.draft_upto = seq.plen
            except Exception as e:  # pylint: disable=broad-except
                clk.launched()
                log.warning(
                    "drafter-cache fill failed (draft quality degrades, "
                    "outputs unaffected): %r", e,
                )
                self._reset_draft_state()
        self._obs.chunk_done(seq, t_chunk, time.monotonic(), width,
                             last=True)
        if alive:
            clk.enter(_COMMIT)
            self._commit(pf.slot, seq, tok0, first=True)

    def _commit(self, slot: int, seq: _Seq, token: int, first=False,
                now: Optional[float] = None) -> bool:
        """Append one generated token to a row; retire when done (cancel,
        stop token, max_new).  Returns whether it retired the row."""
        if now is None:
            now = time.monotonic()
        seq.tokens.append(token)
        if first:
            seq.pos = seq.plen
            with self._cv:
                if seq.ticket.state == "admitted":
                    # transition: admitted -> streaming
                    seq.ticket.state = "streaming"
            self._obs.first_token(seq, now)
        else:
            seq.pos += 1
            self._obs.token_committed(seq, now)
        seq.t_last_commit = now
        seq.next_tok = token
        if seq.on_token is not None:
            try:
                seq.on_token(seq.row_i, token)
            except Exception as e:  # pylint: disable=broad-except
                with self._cv:
                    self.stats["on_token_errors"] += 1
                if not seq.ticket.on_token_logged:
                    seq.ticket.on_token_logged = True
                    log.warning(
                        "on_token observer raised for row %d (logged "
                        "once per request; generation continues): %r",
                        seq.row_i, e,
                    )
        if seq.ticket.cancelled:
            reason = "cancelled"
        elif seq.stop_token is not None and token == seq.stop_token:
            reason = "stop"
        elif len(seq.tokens) >= seq.max_new:
            reason = "done"
        else:
            return False
        self._retire(slot, seq, reason=reason)
        return True

    def _retire(self, slot: int, seq: _Seq, reason: str = "done"):
        t = seq.ticket
        with self._cv:
            self._slots[slot] = None
            # A stale block table would route the inactive row's
            # clamped write into someone else's page.
            self._bt_master[slot] = 0
            self.stats["retired"] += 1
            t.results[seq.row_i] = seq.tokens
            done = all(r is not None for r in t.results)
            if done and t.state in ("admitted", "streaming"):
                # transition: admitted|streaming -> done
                t.state = "done"
            self._cv.notify_all()
        self._release_seq_pages(seq)
        self._obs.retired(seq, time.monotonic(), reason=reason)
        if done:
            t.done.set()
            self._fire_done_callbacks(t)

    def _step(self):  # hot-path
        """One pipeline turn of one kind: a speculative window when some
        greedy row can draft deeper than one token (spec_k > 0), else a
        fused block on a quiet turn (decode_steps > 1), else the
        one-token step.  The turn DISPATCHES its window while the
        previous one is still in flight, then COMMITS the previous one.
        Only a one-token step rides the next step's merge (its rows take
        their input from the in-flight device array, fresh rows override
        it through the merge mask); any other outstanding window commits
        before a turn stages, as does any window before a multi-token
        turn, which starts from the last committed token (the accept
        decision gates the next draft).  A failed dispatch retries with
        capped backoff; exhausted retries drain the window, fail only
        the active rows and crash the scheduler for a supervised
        revival."""
        kind, k = "step", 1
        if self._spec_k and self._spec_turn_wants_window():
            kind = "spec"
        elif self._fused is not None:
            k = self._fused_turn_wants_block()
            if k:
                kind = "fused"
        with self._cv:
            lag = self._pending
            if lag is not None and kind == lag.kind == "step":
                first = None
            else:
                first, lag, self._pending = lag, None, None
        if first is not None:
            self._commit_window(first)
        if kind == "spec":
            new = self._dispatch_spec()
        elif kind == "fused":
            new = self._dispatch_fused(k)
        else:
            new = self._dispatch_step(lag)
        with self._cv:
            self._pending = new
        if lag is not None:
            self._commit_window(lag)
        if new is not None and not self._pipeline:
            # Synchronous mode (the parity control).
            with self._cv:
                self._pending = None
            self._commit_window(new)

    def _stage_rows(self, st, width, flying):  # hot-path
        """Stage every live row into the set `st` for one dispatch: reset
        the set, copy the block tables and walk the slots.  A cancelled
        row retires here unless it rides the step in flight (its commit
        retires it); a row mid-prefill or finished is skipped.
        `width(seq)` is a row's width in the window.  `flying` maps a
        slot to (seq, position) of the one-token step in flight: a row
        riding it continues from the in-flight token through the lag
        merge (`over` False, the next position), and is finished when
        that token is its last.  Returns the live rows as (slot, seq,
        base position, width) and whether any carries top-k / top-p."""
        self._clock.enter(_STAGE)
        s = st.reset()
        with self._cv:
            occupants = list(enumerate(self._slots))
            if self._paged:
                np.copyto(s["bt"], self._bt_master)
        live = []
        adv = False
        for i, seq in occupants:
            if seq is None:
                continue
            fly = flying.get(i)
            ahead = 1 if fly is not None and fly[0] is seq else 0
            if seq.ticket.cancelled:
                if not ahead:
                    self._retire(i, seq, reason="cancelled")
                continue
            if not seq.tokens or len(seq.tokens) + ahead >= seq.max_new:
                # Mid-prefill, finished not retired, or its in-flight
                # token is its last.
                continue
            if ahead:
                p = fly[1] + 1
                s["over"][i] = False
            else:
                p = seq.pos
                s["tok"][i] = seq.next_tok
            s["pos"][i] = p
            s["active"][i] = True
            s["temps"][i] = seq.temp
            if seq.top_k is not None:
                s["top_k"][i] = seq.top_k
                adv = True
            if seq.top_p is not None:
                s["top_p"][i] = seq.top_p
                adv = True
            live.append((i, seq, p, width(seq)))
        return live, adv

    def _dispatch_step(self, lag):  # hot-path
        """Stage the live rows into the next step set and dispatch one
        decode step; `lag` is the step in flight whose tokens its rows
        take through the merge.  Returns the window, or None when no row
        is live."""
        self._stage_i ^= 1
        st = self._stages[self._stage_i]
        flying = {} if lag is None else {i: (q, p) for i, q, p, _ in lag.rows}
        live, adv = self._stage_rows(st, lambda seq: 1, flying)
        if not live:
            return None
        d = st.to(self.device)
        kwargs = {"top_k": d["top_k"], "top_p": d["top_p"]} if adv else {}
        prev = lag.nxt if lag is not None else self._last_nxt
        nxt = self._with_retries(
            "decode_step",
            lambda: self._decode_fn(
                self._cache, prev, d["tok"], d["over"], d["pos"],
                d["active"], d.get("bt"), d["temps"], self._gen, **kwargs,
            ),
        )
        self._last_nxt = nxt
        return _Pending("step", live, nxt, time.monotonic())

    def _with_retries(self, what, dispatch, at=None):  # hot-path
        """Run `dispatch()` -> (cache, tokens) under the step-retry
        contract: a failure retries with capped backoff (a retried step
        draws fresh noise; greedy rows are unaffected); exhausted
        retries, or a device fault that left the cache's state unknown,
        drain the window, fail the active rows and raise StepFailure,
        which crashes the scheduler for revival.  Returns the tokens and
        keeps the cache.  `at` names the dispatch kind in the flight
        recorder's events (None: the one-token step).  Counts the
        dispatch once, whatever its retries."""
        self._dispatch_count += 1
        where = {} if at is None else {"at": at}
        delay = self._retry_backoff_s
        attempt = 0
        clk = self._clock
        while True:
            try:
                clk.launch(_DISPATCH)
                self._cache, toks = dispatch()
                clk.launched()
                return toks
            except Exception as e:  # pylint: disable=broad-except
                clk.launched()
                attempt += 1
                cache_lost = not self._cache_intact()
                if cache_lost:
                    log.error(
                        "%s failure left the device state lost; skipping "
                        "retries: %r", what, e,
                    )
                if attempt > self._step_retries or cache_lost:
                    failure = StepFailure(
                        f"{what} failed after {attempt - 1} retries: {e}"
                    )
                    failure.__cause__ = e
                    with self._cv:
                        self.stats["step_failures"] += 1
                    # analysis: disable=hot-path-instrumentation -- terminal failure path: the step is already lost, the recorder event IS the post-mortem
                    self._obs.event(
                        "step_fail", **where, attempts=attempt,
                        cache_lost=cache_lost, err=repr(e)[:120],
                    )
                    n = self._fail_active_rows(failure)
                    log.error(
                        "persistent %s failure: %d active row(s) failed, "
                        "%d queued row(s) preserved: %s",
                        what, n, self.queue_depth, e,
                    )
                    raise failure
                with self._cv:
                    self.stats["step_retries"] += 1
                # analysis: disable=hot-path-instrumentation -- retry path: the step failed and a backoff sleep follows; recording is not the bottleneck
                self._obs.event(
                    "step_retry", **where, attempt=attempt,
                    err=repr(e)[:120],
                )
                log.warning(
                    "%s failed (attempt %d/%d), retrying in %.3fs: %r",
                    what, attempt, self._step_retries, delay, e,
                )
                time.sleep(delay)
                delay = min(delay * 2.0, self._retry_backoff_cap_s)

    def _readback(self, pending, what, at):  # hot-path
        """A window's one readback (host numpy).  A failure here is a
        device-side failure of the dispatched work: the active rows
        fail and StepFailure raises (`at` names it in the flight
        recorder).  The thread goes on in the commit phase."""
        self._clock.enter(_SYNC)
        try:
            out = pending.nxt.cpu().numpy()
            self._clock.synced(_COMMIT)
            return out
        except Exception as e:  # pylint: disable=broad-except
            failure = StepFailure(
                f"{what} failed in flight (commit-side readback): {e}"
            )
            failure.__cause__ = e
            with self._cv:
                self.stats["step_failures"] += 1
            # analysis: disable=hot-path-instrumentation -- readback failure path: active rows are about to fail, the recorder event IS the post-mortem
            self._obs.event("step_fail", at=at, err=repr(e)[:120])
            n = self._fail_active_rows(failure)
            log.error(
                "in-flight %s failed at commit: %d active row(s) failed, "
                "%d queued row(s) preserved: %s",
                what, n, self.queue_depth, e,
            )
            raise failure

    def _commit_window(self, pending):  # hot-path
        """Commit one window of any kind at its one readback (a
        speculative window's verify inputs with it).  Each surviving row
        takes m tokens through _commit, and stops at the token that
        retires it (cancel, stop token, max_new): m is 1 for a one-token
        step, the width for a fused block, and for a speculative window
        the accept-longest-greedy-prefix rule's: target tokens while the
        draft agrees, plus the first disagreeing target token, capped at
        the row's width.  The rest of a block or window is dead: the
        row's position never passes its last committed token, so the
        tail's KV stays invisible and the next dispatch rewrites it."""
        what, at = _READBACK[pending.kind]
        out = self._readback(pending, what, at)
        if out.ndim == 1:
            out = out[:, None]
        drafts = None if pending.draft is None else pending.draft.cpu().numpy()
        now = time.monotonic()
        with self._cv:
            self.stats["steps"] += 1
            self.stats["step_rows"] += len(pending.rows)
            self._clock.fold(self.stats)
            # A row failed or retired-and-refilled inside the window
            # must not receive its tokens.
            survivors = [
                (i, seq, w) for i, seq, _, w in pending.rows
                if self._slots[i] is seq
            ]
        self._obs.step_committed(
            len(pending.rows), now - pending.t_dispatch
        )
        drafted = accepted = committed = 0
        for i, seq, w in survivors:
            m = w
            if drafts is not None:
                m = 1
                while m < w and drafts[i, m] == out[i, m - 1]:
                    m += 1
                if w > 1:
                    # Depth and the accept-rate histogram follow the
                    # drafter's accuracy (the whole agreeing prefix),
                    # whatever truncated the commit.
                    self._obs.spec_window(w - 1, m - 1)
                    self._update_depth(seq, w, m)
            c = 0
            for j in range(m):
                c += 1
                # analysis: disable=host-sync -- out is already host-side (the window readback above)
                if self._commit(i, seq, int(out[i, j]), now=now):
                    break
            committed += c
            if drafts is not None and w > 1:
                # The counters track delivery: a draft token counts as
                # accepted only when it was committed.
                drafted += w - 1
                accepted += min(c, m - 1)
        if pending.kind == "spec":
            with self._cv:
                self.stats["spec_window_rows"] += len(survivors)
                self.stats["spec_window_tokens"] += committed
                self.stats["spec_drafted_tokens"] += drafted
                self.stats["spec_accepted_tokens"] += accepted
                self.stats["spec_rejected_tokens"] += drafted - accepted
        elif pending.kind == "fused" and committed:
            with self._cv:
                self.stats["fused_tokens"] += committed

    # -- fused multi-step decode (decode_steps > 1) ----------------------
    def _fused_turn_wants_block(self) -> int:  # hot-path
        """The quiet-turn gate: the block width k >= 2 for this turn, or
        0 to fall through to the one-token step.  Speculative windows own
        the multi-token turns when spec_k is set, so the gate then always
        declines.  Quiet means nothing queued or prefilling (admission
        work is what the one-token pipeline overlaps) and every live row
        greedy (temperature 0, no
        top_k / top_p: a sampled row's noise would be drawn in another
        order than k one-token steps draw it), uncancelled, with more
        than one token of headroom.  The width is the largest bucket at
        most every row's remaining budget."""
        if self._spec_k:
            return 0
        width = None
        with self._cv:
            if self._queue or self._prefilling is not None:
                return 0
            for seq in self._slots:
                if seq is None:
                    continue
                if seq.ticket.cancelled:
                    return 0  # the one-token turn retires it at once
                if not seq.tokens or len(seq.tokens) >= seq.max_new:
                    return 0  # mid-prefill, or finished not retired
                if (seq.temp > 0.0 or seq.top_k is not None
                        or seq.top_p is not None):
                    return 0
                rem = seq.max_new - len(seq.tokens)
                if rem <= 1:
                    return 0
                width = rem if width is None else min(width, rem)
        if width is None:
            return 0
        k = 0
        for b in self._fused_buckets:
            if b <= width:
                k = b
        return k

    def _dispatch_fused(self, k: int):  # hot-path
        """Stage every live row and dispatch one block of k steps.  Rows
        cancelled since the gate retire at staging (nothing is in
        flight), and the staged temperatures are 0 (the gate passed only
        greedy rows).  A failure retries and crashes as a one-token step
        does."""
        st = self._fused_stage
        live, _ = self._stage_rows(st, lambda seq: k, {})
        if not live:
            return None
        toks = self._with_retries(
            "fused decode block",
            lambda: self._fused_fn(self._weights, self._cache, st.t, k),
            at="decode_fused",
        )
        with self._cv:
            self.stats["fused_blocks"] += 1
            self.stats["fused_steps"] += k
        return _Pending("fused", live, toks, time.monotonic())

    # -- speculative decoding (spec_k > 0) -------------------------------
    def _spec_turn_wants_window(self) -> bool:  # hot-path
        """The turn-type gate: True when some live greedy row could draft
        deeper than one token this turn; otherwise the turn falls through
        to the one-token pipelined step, which keeps its overlap.  Owns
        the adaptive-depth probe: a throttled row's 8th gated turn lifts
        its depth to min(2, spec_k), and one mispredicted window halves
        it straight back."""
        with self._cv:
            for seq in self._slots:
                if seq is None or seq.ticket.cancelled:
                    continue
                if not seq.tokens or len(seq.tokens) >= seq.max_new:
                    continue
                if seq.temp > 0.0:
                    continue
                if seq.max_new - len(seq.tokens) <= 1:
                    continue
                d = seq.spec_depth if seq.spec_depth > 0 else self._spec_k
                if d == 1 and self._spec_adaptive:
                    seq.spec_probe += 1
                    if seq.spec_probe >= 8:
                        seq.spec_probe = 0
                        seq.spec_depth = min(2, self._spec_k)
                        d = seq.spec_depth
                if d > 1:
                    return True
        return False

    def _spec_width(self, seq) -> int:
        """A row's width in a speculative window: its adaptive depth
        capped at its budget."""
        if seq.temp > 0.0:
            return 1  # the greedy accept rule cannot cover a draw
        d = seq.spec_depth if seq.spec_depth > 0 else self._spec_k
        return min(d, seq.max_new - len(seq.tokens))

    def _dispatch_spec(self):  # hot-path
        """Draft up to W tokens per greedy row with the int8 twin and
        dispatch ONE batched verify pass over the window.  The draft's
        output feeds the verify on the device and nothing is read back
        until _commit_window.  W is the bucketed max of the rows' widths
        (a greedy row's adaptive depth capped at its budget; sampled rows
        ride at width 1).  A failed drafter fill or draft chain degrades
        the window to width 1 and zeroes the drafter cache; a failed
        verify retries, then fails the active rows and crashes, as a
        one-token step does."""
        st = self._spec_stage
        live, adv = self._stage_rows(st, self._spec_width, {})
        if not live:
            return None
        w_max = max(w for _, _, _, w in live)
        W = next(b for b in self._spec_buckets if b >= w_max)
        self._spec_last_width = W
        dcols = self._no_dcols
        if W > 1:
            dcols = self._draft(st, live, W)
            if dcols is None:
                W = 1
                self._spec_last_width = 1
                dcols = self._no_dcols
                live = [(i, q, p, 1) for i, q, p, _w in live]
        greedy = not adv and not bool((st.np["temps"] > 0.0).any())
        t = st.t
        inputs = {
            "tok": t["tok"], "dcols": dcols, "pos": t["pos"],
            "active": t["active"], "bt": t.get("bt"), "temps": t["temps"],
            "top_k": t["top_k"] if adv else None,
            "top_p": t["top_p"] if adv else None,
        }
        outs, toks = self._with_retries(
            "verify window",
            lambda: self._verify_fn(self._weights, self._cache, inputs,
                                    (W, greedy, adv)),
            at="spec_verify",
        )
        with self._cv:
            self.stats["spec_verify_passes"] += 1
        return _Pending("spec", live, outs, time.monotonic(), toks)

    def _draft(self, st, live, W):  # hot-path
        """The draft phase of a window of width W > 1: refill the drafter
        rows whose frontier lags their base position (a throttled
        stretch, or a zeroed drafter cache) from the engine cache, then
        run the W-pass chain over every greedy row.  Every greedy rider
        drafts the full W, past its own width too: the extra passes write
        its real continuation into slots its next window rewrites.
        Returns the (B, W - 1) proposals on the device, or None when the
        drafter failed (logged; the drafter cache is zeroed).  The fills
        and the chain count as one dispatch."""
        s = st.np
        self._clock.launch(_DISPATCH)
        for i, seq, p, _w in live:
            if seq.temp > 0.0 or seq.draft_upto >= p:
                continue
            try:
                self._draft_fill_fn(
                    self._draft_cache, self._cache, i, p,
                    s["bt"][i] if self._paged else None,
                )
                seq.draft_upto = p
            except Exception as e:  # pylint: disable=broad-except
                log.warning(
                    "drafter-cache refill failed (draft quality degrades, "
                    "outputs unaffected): %r", e,
                )
                self._reset_draft_state()
                break
        np.logical_and(s["active"], s["temps"] == 0.0, out=s["draft"])
        t = st.t
        try:
            self._draft_cache, dcols = self._draft_fn(
                self._draft_qparams, self._draft_cache,
                {"tok": t["tok"], "pos": t["pos"], "active": t["draft"]}, W,
            )
        except Exception as e:  # pylint: disable=broad-except
            self._clock.launched()
            log.warning(
                "draft chain failed (window drops to 1, outputs "
                "unaffected): %r", e,
            )
            # analysis: disable=hot-path-instrumentation -- drafter failure path: a device fault just cost milliseconds, the recorder event is the cheap part
            self._obs.event("spec_draft_fail", err=repr(e)[:120])
            self._reset_draft_state()
            return None
        self._clock.launched()
        # The chain wrote slots [base, base + W) of every coherent
        # greedy rider.
        for i, seq, p, _w in live:
            if seq.temp == 0.0 and seq.draft_upto >= p:
                seq.draft_upto = p + W
        with self._cv:
            self.stats["spec_draft_chains"] += 1
            self.stats["spec_draft_passes"] += W
        return dcols

    def _update_depth(self, seq, w: int, m: int):
        """Per-row adaptive depth: fold this window's accept fraction into
        the row's trailing EMA; below spec_min_accept the depth halves
        toward 1, and a fully accepted window with the EMA above 0.75
        doubles it back toward spec_k."""
        if not self._spec_adaptive:
            return
        frac = (m - 1) / (w - 1)
        seq.accept_ema = 0.5 * seq.accept_ema + 0.5 * frac
        cur = seq.spec_depth if seq.spec_depth > 0 else self._spec_k
        if seq.accept_ema < self._spec_min_accept:
            seq.spec_depth = max(1, cur // 2)
        elif frac >= 1.0 and seq.accept_ema > 0.75:
            seq.spec_depth = min(self._spec_k, max(2, cur * 2))
