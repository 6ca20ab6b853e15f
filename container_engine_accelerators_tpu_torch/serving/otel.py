"""Thin span model for per-request serving traces: the port's own copy
of container_engine_accelerators_tpu/serving/otel.py (same names, same
wire dicts, pure Python).

The shape (trace -> spans with monotonic start/end and flat string
attributes) follows the OpenTelemetry data model closely enough that an
exporter could translate a `Trace` 1:1 into an OTLP request, but this
module deliberately carries NO exporter, no context propagation, and no
SDK dependency: the serving engine needs a place to FOLD staged
monotonic timestamps into a structured record at commit/retire time
(serving/observe.py), and a heavyweight tracing SDK on the decode
scheduler thread would defeat the instrumentation-overhead contract
(PERF.md "Observability").

Timestamps are `time.monotonic()` seconds.  They are comparable only
within one process lifetime — the point of a span here is the
DURATION and the relative ordering against sibling spans, not an
absolute wall-clock (the one place wall time matters, the Prometheus
exposition, stamps its own exemplar timestamps).

Nothing here is called on the dispatch hot path: spans are constructed
from timestamps the engine staged in plain attribute slots
(`# hot-path` code records via preallocated staging only).

CROSS-PROCESS PROPAGATION: `TraceContext` is the W3C
traceparent analog — (trace_id, parent_span_id) — with a compact wire
codec (`to_wire`/`from_wire`) the worker RPC seam carries on submit
frames, so one request's spans from the router, a prefill worker, and
a decode worker all land under ONE trace_id.  `Span` carries a
`process` attribute naming which process recorded it, and the
`TailDigest` is the router-side assembly sink: bounded per-stage
latency attribution over every sealed trace, full span trees retained
only for the slowest-decile requests so memory stays bounded
(`tracez_payload` renders it).
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Dict, Iterator, List, Optional

# Process-wide trace-id mint: hex of a monotonically increasing int.
# itertools.count().__next__ is a single C call — effectively atomic
# under the GIL, so minting an id needs no lock.  Span ids draw from
# the same mint, so every id in one process is unique.  Cross-process
# trace ids are minted by whoever opens the ROOT span (the router);
# workers mint local ids only for context-less submits (warm-ups),
# documented in CONTRIBUTING.md "The cross-process trace contract".
_TRACE_IDS = itertools.count(1)


def new_trace_id() -> str:
    """Short process-unique trace id (hex).  Used as the Prometheus
    exemplar `trace_id` label, so /metrics histograms link back to the
    trace ring's entries."""
    return f"{next(_TRACE_IDS):08x}"


def new_span_id() -> str:
    """Span id from the same process-unique mint."""
    return f"{next(_TRACE_IDS):08x}"


class TraceContext:
    """The propagated half of a trace: which trace a remote span
    belongs to (`trace_id`) and which span is its parent
    (`parent_span_id`).  The wire form is W3C-traceparent-shaped —
    `00-<trace_id>-<parent_span_id>-01` — one flat string, so the RPC
    frame header carries it as a single JSON field and a foreign or
    corrupt value fails parsing loudly instead of silently grafting
    spans onto the wrong trace."""

    __slots__ = ("trace_id", "parent_span_id")

    _VERSION = "00"
    _FLAGS = "01"  # always sampled: the ring/digest bound memory

    def __init__(self, trace_id: str, parent_span_id: str = ""):
        self.trace_id = str(trace_id)
        self.parent_span_id = str(parent_span_id)

    @classmethod
    def new(cls) -> "TraceContext":
        """Fresh root context (no parent span yet): what the demo
        server mints per /generate request."""
        return cls(new_trace_id(), "")

    def child(self, parent_span_id: str) -> "TraceContext":
        """Same trace, new parent — what the fleet hands each worker
        submit (the root span is the remote spans' parent)."""
        return TraceContext(self.trace_id, parent_span_id)

    def to_wire(self) -> str:
        return (
            f"{self._VERSION}-{self.trace_id}-"
            f"{self.parent_span_id or '0'}-{self._FLAGS}"
        )

    @classmethod
    def from_wire(cls, wire: str) -> "TraceContext":
        parts = str(wire).split("-")
        if len(parts) != 4 or parts[0] != cls._VERSION:
            raise ValueError(f"malformed trace context {wire!r}")
        version, trace_id, parent, _flags = parts
        del version
        if not trace_id or not all(
            c in "0123456789abcdef" for c in trace_id + parent
        ):
            raise ValueError(f"malformed trace context {wire!r}")
        return cls(trace_id, "" if parent == "0" else parent)

    def __repr__(self) -> str:
        return f"TraceContext({self.to_wire()})"


class Span:
    """One named interval inside a trace.

    `end` is None while the span is open; `duration_s` of an open span
    is None rather than a guess.  Attributes are a flat str->str/num
    dict (the OTel attribute restriction, which also keeps repr/JSON
    cheap).  `span_id`/`parent_id` give the assembled cross-process
    trace its tree shape; `process` names the process that recorded
    the span (router / worker<i>) — the one field that makes a
    disaggregated request's handoffs readable."""

    __slots__ = ("name", "start", "end", "attrs", "span_id",
                 "parent_id", "process")

    def __init__(self, name: str, start: float,
                 end: Optional[float] = None,
                 attrs: Optional[Dict] = None,
                 span_id: Optional[str] = None,
                 parent_id: str = "",
                 process: str = ""):
        self.name = name
        self.start = float(start)
        self.end = None if end is None else float(end)
        self.attrs = attrs or {}
        self.span_id = span_id or new_span_id()
        self.parent_id = parent_id
        self.process = process

    @property
    def duration_s(self) -> Optional[float]:
        if self.end is None:
            return None
        return self.end - self.start

    def to_dict(self) -> Dict:
        d = {"name": self.name, "start": self.start, "end": self.end,
             "span_id": self.span_id}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.process:
            d["process"] = self.process
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __repr__(self) -> str:
        dur = self.duration_s
        dur_txt = "open" if dur is None else f"{dur * 1e3:.2f}ms"
        return f"Span({self.name}, {dur_txt})"


class Trace:
    """One request's spans, in recording order.

    The engine builds one Trace per admitted sequence (row), appends
    spans as their intervals close (queue-wait at admission, one span
    per prefill chunk, decode, per-step commit lag is a histogram not a
    span), and seals it at retire.  Sealed traces go to the
    observability layer's bounded trace ring — recent requests stay
    reconstructable without unbounded memory.

    `process` and `parent` are defaults stamped onto every span this
    trace records (the engine's observer sets them from the submit's
    TraceContext, so remote spans arrive pre-linked to the router's
    root span).  Spans appended from ANOTHER process keep their own
    process label — and their timestamps are that process's monotonic
    clock, so only their DURATIONS are comparable across processes,
    never their absolute order (the per-stage attribution consumes
    durations only)."""

    __slots__ = ("trace_id", "spans", "attrs", "process", "parent")

    def __init__(self, trace_id: Optional[str] = None,
                 attrs: Optional[Dict] = None,
                 process: str = "",
                 parent_span_id: str = ""):
        self.trace_id = trace_id or new_trace_id()
        self.spans: List[Span] = []
        self.attrs = attrs or {}
        self.process = process
        self.parent = parent_span_id

    def span(self, name: str, start: float,
             end: Optional[float] = None,
             attrs: Optional[Dict] = None) -> Span:
        s = Span(name, start, end, attrs,
                 parent_id=self.parent, process=self.process)
        self.spans.append(s)
        return s

    def graft(self, span_dict: Dict) -> Optional[Span]:
        """Append a span that crossed the process boundary as a dict
        (the worker ships sealed spans on the terminal done/fail
        frame).  Best-effort by contract: a malformed dict returns
        None instead of raising — a dropped span payload never fails
        a request.  (Named graft, not adopt: `.adopt()` is the
        refcheck page-ownership verb.)"""
        s = span_from_dict(span_dict)
        if s is not None:
            self.spans.append(s)
        return s

    def to_dict(self) -> Dict:
        return {
            "trace_id": self.trace_id,
            "attrs": dict(self.attrs),
            "spans": [s.to_dict() for s in self.spans],
        }

    def __repr__(self) -> str:
        return f"Trace({self.trace_id}, {len(self.spans)} spans)"


class TraceRing:
    """Bounded ring of the most recent sealed traces.

    Writers are the scheduler thread (retire) plus failure paths on
    other threads, so append takes a small lock — every call site is a
    retire/failure boundary, never the dispatch hot path."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._cap = int(capacity)
        self._buf: List[Optional[Trace]] = [None] * self._cap
        self._n = 0
        self._lock = threading.Lock()

    def append(self, trace: Trace) -> None:
        with self._lock:
            self._buf[self._n % self._cap] = trace
            self._n += 1

    def __len__(self) -> int:
        with self._lock:
            return min(self._n, self._cap)

    @property
    def total(self) -> int:
        """Traces ever appended (including those evicted)."""
        with self._lock:
            return self._n

    def traces(self) -> List[Trace]:
        """Oldest-to-newest snapshot of the retained traces."""
        with self._lock:
            n, cap = self._n, self._cap
            if n <= cap:
                return [t for t in self._buf[:n]]
            start = n % cap
            return self._buf[start:] + self._buf[:start]

    def __iter__(self) -> Iterator[Trace]:
        return iter(self.traces())


def span_from_dict(d: Dict) -> Optional[Span]:
    """Rebuild a Span from its to_dict() form (the wire shape the
    worker ships on terminal frames).  None on anything malformed —
    span shipping is best-effort end to end."""
    try:
        if not isinstance(d, dict):
            return None
        end = d.get("end")
        return Span(
            str(d["name"]), float(d["start"]),
            None if end is None else float(end),
            attrs=dict(d.get("attrs") or {}),
            span_id=str(d.get("span_id") or "") or None,
            parent_id=str(d.get("parent_id") or ""),
            process=str(d.get("process") or ""),
        )
    except (KeyError, TypeError, ValueError):
        return None


# -- per-stage attribution + the tail digest ---------------------------------
# The request pipeline's stage vocabulary, in pipeline order: every
# span name maps onto one stage (or none — "request"/"reroute"/
# "prefill_handoff" are structure, not stage time; the handoff span's
# wall time CONTAINS the prefill worker's queue_wait/prefill_chunk
# spans, so mapping it too would double-count the prefill stage).
# The /tracez per-stage p50/p95 and the client's --server-traces
# summary both read these names.
STAGES = (
    "queue", "placement", "tier_fetch", "prefill", "migrate", "decode",
)
_STAGE_OF = {
    "queue_wait": "queue",
    "placement": "placement",
    # Tiered KV store promotion: host/disk load + scatter +
    # trie adopt at admission — attributed per-request so a promotion
    # stall is visible next to the prefill it replaced.
    "tier_fetch": "tier_fetch",
    "prefill_chunk": "prefill",
    "migrate": "migrate",
    "decode": "decode",
}


def stage_durations(trace: Trace) -> Dict[str, float]:
    """{stage: summed closed-span seconds} for one trace.  Durations
    only (cross-process clocks — Trace docstring)."""
    out: Dict[str, float] = {}
    for s in trace.spans:
        stage = _STAGE_OF.get(s.name)
        dur = s.duration_s
        if stage is None or dur is None:
            continue
        out[stage] = out.get(stage, 0.0) + max(0.0, dur)
    return out


def trace_total_s(trace: Trace) -> float:
    """Wall seconds of the trace's root span ("request"), falling back
    to the widest SAME-PROCESS span envelope (single-engine traces
    have no root span; spans grafted from another process are excluded
    from the envelope because their monotonic clock is not this
    trace's — subtracting across clocks would mint garbage totals)."""
    for s in trace.spans:
        if s.name == "request" and s.duration_s is not None:
            return s.duration_s
    closed = [
        s for s in trace.spans
        if s.end is not None and s.process == trace.process
    ] or [s for s in trace.spans if s.end is not None]
    if not closed:
        return 0.0
    return max(s.end for s in closed) - min(s.start for s in closed)


def trace_summary(trace: Trace) -> Dict:
    """The /tracez "recent" row: identity + outcome + per-stage
    seconds, WITHOUT the span tree (full trees are retained only for
    the slowest decile — the memory bound)."""
    return {
        "trace_id": trace.trace_id,
        "attrs": dict(trace.attrs),
        "total_s": round(trace_total_s(trace), 6),
        "spans": len(trace.spans),
        "stages_s": {
            k: round(v, 6) for k, v in stage_durations(trace).items()
        },
    }


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class TailDigest:
    """Bounded tail-latency digest over sealed traces.

    Two bounded structures, both O(capacity) forever:

      - per-stage duration windows (deque, last `capacity` requests)
        -> the /tracez per-stage p50/p95 attribution;
      - the SLOWEST-DECILE keep: full span trees retained only for
        requests whose total latency clears the rolling p90 of the
        window (always keeping the first few while the window fills),
        capped at `keep` trees with the fastest evicted first — the
        requests an operator actually drills into are exactly the
        slow ones, and keeping every tree would grow without bound.

    add() runs at seal time (retire/failure boundaries, never the
    dispatch hot path) under one small lock."""

    def __init__(self, capacity: int = 512, keep: int = 32):
        if capacity < 1 or keep < 1:
            raise ValueError("capacity and keep must be >= 1")
        self._cap = int(capacity)
        self._keep = int(keep)
        self._lock = threading.Lock()
        self._stage = {  # guarded-by: _lock
            s: deque(maxlen=self._cap) for s in STAGES
        }
        self._totals = deque(maxlen=self._cap)  # guarded-by: _lock
        # Ascending (total_s, trace dict); len <= keep.
        self._slow: List[tuple] = []  # guarded-by: _lock
        self._n = 0  # guarded-by: _lock

    def add(self, trace: Trace) -> None:
        stages = stage_durations(trace)
        total = trace_total_s(trace)
        with self._lock:
            self._n += 1
            for stage, dur in stages.items():
                self._stage[stage].append(dur)
            ordered = sorted(self._totals)
            self._totals.append(total)
            thr = _quantile(ordered, 0.9)
            if thr is None or total >= thr or (
                len(self._slow) < self._keep
            ):
                self._slow.append((total, trace.to_dict()))
                self._slow.sort(key=lambda tv: tv[0])
                if len(self._slow) > self._keep:
                    del self._slow[0]  # evict the fastest kept tree

    def summary(self) -> Dict:
        """{stage: {p50, p95, count}} over the retained window."""
        with self._lock:
            windows = {s: sorted(d) for s, d in self._stage.items()}
            n = self._n
        out = {"requests": n}
        for stage, vals in windows.items():
            if not vals:
                continue
            out[stage] = {
                "p50_s": round(_quantile(vals, 0.5), 6),
                "p95_s": round(_quantile(vals, 0.95), 6),
                "count": len(vals),
            }
        return out

    def slowest(self) -> List[Dict]:
        """Retained full span trees, slowest first."""
        with self._lock:
            return [t for _, t in reversed(self._slow)]


def tracez_payload(traces: List[Trace],
                   digest: Optional[TailDigest] = None,
                   limit: int = 32) -> Dict:
    """The /tracez JSON body: recent trace SUMMARIES (newest first,
    bounded), per-stage attribution, and the slowest-decile full span
    trees.  With no digest (the single-engine server: its ring seals
    at the engine, not through a fleet), both are computed over the
    given retained traces — already bounded by the ring."""
    recent = [trace_summary(t) for t in traces[-int(limit):]][::-1]
    if digest is not None:
        return {
            "recent": recent,
            "stages": digest.summary(),
            "slowest": digest.slowest(),
        }
    per_stage: Dict[str, List[float]] = {}
    totals = []
    for t in traces:
        totals.append((trace_total_s(t), t))
        for stage, dur in stage_durations(t).items():
            per_stage.setdefault(stage, []).append(dur)
    stages: Dict = {"requests": len(traces)}
    for stage, vals in per_stage.items():
        vals.sort()
        stages[stage] = {
            "p50_s": round(_quantile(vals, 0.5), 6),
            "p95_s": round(_quantile(vals, 0.95), 6),
            "count": len(vals),
        }
    totals.sort(key=lambda tv: tv[0])
    n_slow = max(1, len(totals) // 10) if totals else 0
    return {
        "recent": recent,
        "stages": stages,
        "slowest": [
            t.to_dict() for _, t in reversed(totals[-n_slow:])
        ],
    }
