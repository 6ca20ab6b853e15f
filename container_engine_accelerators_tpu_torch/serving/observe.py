"""Serving observability: Prometheus registry, request traces, flight recorder.

The port's own copy of container_engine_accelerators_tpu/serving/
observe.py: the same registry, text format, histogram names and buckets,
flight recorder and engine observer.  Two differences: it has no
profiler hooks (the engine's scheduler phases are torch.profiler ranges
of their own, serving/engine.py), and `engine_observability` reads its
knobs from a mapping the caller passes, never from the process
environment.

The paper's node stack is held together by its observability sidecars —
the metrics exporter and the health checker feeding the cluster
scheduler.  This module is the serving-side analog for the continuous
batching engine, three pieces with one hard constraint:

  1. `Registry` — a dependency-free Prometheus TEXT-FORMAT registry
     (counters / gauges / histograms, with OpenMetrics-style exemplars
     on histogram buckets).  Served by the demo server's `/metrics`
     endpoint and bridged into `plugin/metrics.py`'s prometheus_client
     scrape (`MetricServer.attach_external_registry`) so engine series
     ride next to the device duty-cycle/HBM series, like the paper's
     exporter.  Collect-time callbacks absorb the engine `stats` dict
     and faults.py injection counts without double bookkeeping.
  2. `EngineObservability` — per-request trace spans (queue-wait, each
     prefill chunk, decode) and latency histograms (TTFT, inter-token,
     queue-wait, chunk duration, dispatch->commit lag) folded from
     monotonic timestamps the engine STAGES in plain attribute slots.
  3. `FlightRecorder` — a bounded ring of the last N scheduler events
     (admit / step / retire / fault / restart / kill), dumped to stderr
     and into `engine.snapshot()` on engine death, supervisor restart,
     or SIGQUIT — so a chaos-harness failure is reconstructable from
     its last moments instead of dying silent.

THE HOT-PATH CONTRACT: nothing in the engine's dispatch hot path
(`# hot-path` regions) calls into this module's record primitives,
takes an instrumentation lock, or reads a wall clock.  The engine
stages `time.monotonic()` floats into preallocated slots
(`_Seq`/`_Pending` attributes) and FOLDS them here at the commit
boundary — the decode loop's one designed sync point — or at
admit/retire/failure boundaries, which are off the dispatch path by
construction.  Metric mutation itself takes a per-metric lock, which
is safe exactly because every caller is already off the hot path.  The
engine's scheduler-phase counters follow the same contract: integer
`time.monotonic_ns()` stamps in plain fields, folded into the engine's
`stats` under the lock a commit or a wait already holds, and read here
through `attach_engine`'s collector like every other stats key.
"""

from __future__ import annotations

import bisect
import logging
import math
import os
import re
import sys
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from . import otel

log = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Naming convention (CONTRIBUTING.md "Metrics & spans"): every serving
# series is `serve_<subsystem>_<what>[_unit][_total]`.  Latency
# histograms are seconds (`*_seconds`); counters end in `_total`.
TTFT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
ITL_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0,
)
QUEUE_WAIT_BUCKETS = TTFT_BUCKETS
CHUNK_BUCKETS = ITL_BUCKETS
COMMIT_LAG_BUCKETS = ITL_BUCKETS
# Per-window accepted-draft fraction (speculative decoding): eighths
# resolve every window width the power-of-two ladder can dispatch.
SPEC_ACCEPT_BUCKETS = (
    0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0,
)


def _escape_label(v) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt_labels(labels: Dict[str, object]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def quantile_from_counts(bounds: Sequence[float],
                         counts: Sequence[int],
                         q: float) -> Optional[float]:
    """Estimated q-quantile from per-bucket (non-cumulative) counts by
    linear interpolation inside the holding bucket — the PromQL
    histogram_quantile estimate.  `counts` has len(bounds)+1 entries
    (the +Inf bucket last).  None when empty.  Shared by
    Histogram.quantile and by callers computing quantiles over a
    WINDOW (bench.py diffs two Histogram.state() snapshots so a
    measured phase's percentiles exclude the warm-up's observations)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            lo = bounds[i - 1] if i > 0 else 0.0
            if i >= len(bounds):
                # +Inf bucket: no upper edge to interpolate toward;
                # the last finite bound is the honest floor.
                return bounds[-1]
            hi = bounds[i]
            frac = (rank - prev_cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return bounds[-1]


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _HistSample:
    """One labeled histogram series: cumulative bucket counts at
    render, per-bucket counts internally, sum/count, and at most one
    exemplar per bucket (the LAST observation that landed there — the
    freshest trace id is the most useful one to click through)."""

    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        # bucket index -> (trace_id, value, unix_ts)
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}


class Metric:
    """Base: name/help/type, label schema, per-series state.  Series
    state is guarded by a per-metric lock — every mutation site is off
    the dispatch hot path (module docstring), so the lock costs an
    uncontended acquire at commit/admit/retire cadence, never inside
    dispatch."""

    mtype = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labelvalues: Sequence[object]) -> Tuple[str, ...]:
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values {self.labelnames}, got {len(labelvalues)}"
            )
        return tuple(str(v) for v in labelvalues)

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels dict, series state)] snapshot, stable order."""
        with self._lock:
            items = sorted(self._series.items())
        return [
            (dict(zip(self.labelnames, key)), state)
            for key, state in items
        ]


class Counter(Metric):
    mtype = "counter"

    def inc(self, amount: float = 1.0, *labelvalues) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labelvalues)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, *labelvalues) -> float:
        key = self._key(labelvalues)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Gauge(Metric):
    mtype = "gauge"

    def set(self, value: float, *labelvalues) -> None:
        key = self._key(labelvalues)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, *labelvalues) -> None:
        key = self._key(labelvalues)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, *labelvalues) -> float:
        key = self._key(labelvalues)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Histogram(Metric):
    mtype = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float],
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help_text, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        if any(b != b or b == math.inf for b in bounds):
            raise ValueError(f"{name}: finite bucket bounds only "
                             f"(+Inf is implicit)")
        self.bounds = bounds

    def observe(self, value: float, *labelvalues,
                exemplar: Optional[str] = None) -> None:
        v = float(value)
        key = self._key(labelvalues)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSample(len(self.bounds))
            s.counts[i] += 1
            s.sum += v
            s.count += 1
            if exemplar is not None:
                s.exemplars[i] = (exemplar, v, time.time())

    def samples(self) -> List[Tuple[Dict[str, str], object]]:
        """Histogram samples are COPIED under the lock: render() and
        the prometheus bridge iterate them lock-free, and a scrape
        racing a commit-boundary observe() must never see a torn
        series (counts / sum / count mutually inconsistent — e.g.
        _count above the +Inf cumulative bucket)."""
        with self._lock:
            items = []
            for key, s in sorted(self._series.items()):
                c = _HistSample(len(self.bounds))
                c.counts = list(s.counts)
                c.sum = s.sum
                c.count = s.count
                c.exemplars = dict(s.exemplars)
                items.append((key, c))
        return [
            (dict(zip(self.labelnames, key)), c) for key, c in items
        ]

    def state(self, *labelvalues) -> Tuple[List[int], float, int]:
        """Consistent (per-bucket counts, sum, count) snapshot —
        subtract two states to get a measurement WINDOW's histogram
        (bench.py isolates its measured phase from warm-up this way).
        Zeros when the series has no observations yet."""
        key = self._key(labelvalues)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return [0] * (len(self.bounds) + 1), 0.0, 0
            return list(s.counts), s.sum, s.count

    def quantile(self, q: float, *labelvalues) -> Optional[float]:
        """Estimated q-quantile (0..1) by linear interpolation inside
        the holding bucket — the same estimate PromQL's
        histogram_quantile computes server-side.  None with no
        observations.  Error is bounded by the holding bucket's width:
        callers comparing against exact timings must allow that much
        slack (tests/test_observe.py does)."""
        counts, _, _ = self.state(*labelvalues)
        return quantile_from_counts(self.bounds, counts, q)


class MetricSnapshot:
    """One family as collected: (name, type, help, samples).  Counter /
    gauge samples are (labels, float); histogram samples are (labels,
    _HistSample-shaped state with .counts/.sum/.count/.exemplars)."""

    __slots__ = ("name", "mtype", "help", "samples", "bounds")

    def __init__(self, name, mtype, help_text, samples, bounds=None):
        self.name = name
        self.mtype = mtype
        self.help = help_text
        self.samples = samples
        self.bounds = bounds


class Registry:
    """Get-or-create metric registry with collect-time callbacks.

    Live metrics (`counter`/`gauge`/`histogram`) are mutated by the
    instrumented code; CALLBACK COLLECTORS absorb surfaces that already
    keep their own counters — the engine `stats` dict, faults.py
    injector stats, the server drain state — without a second set of
    books that could drift.  A collector raising loses only its own
    families for that scrape (logged once per collector): the /metrics
    endpoint must never 500, and device series must never vanish,
    because one provider broke — the same per-chip containment rule as
    plugin/metrics.py."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Tuple[str, Callable]] = []
        self._collector_logged: Dict[str, str] = {}

    # -- construction ----------------------------------------------------
    def _get_or_create(self, cls, name, help_text, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or (
                    m.labelnames != tuple(labelnames)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different type/label schema"
                    )
                want = kw.get("buckets")
                if want is not None and (
                    sorted(float(b) for b in want) != m.bounds
                ):
                    # Same rigor as the label-schema check: silently
                    # folding observations into the FIRST caller's
                    # bucket layout would skew every quantile.
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"different histogram buckets"
                    )
                return m
            m = cls(name, help_text, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help_text, labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name, help_text, labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name, help_text, buckets,
                  labelnames=()) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, labelnames, buckets=buckets
        )

    def get(self, name) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def register_collector(self, name: str,
                           fn: Callable[[], Iterable[MetricSnapshot]]):
        """fn() -> iterable of MetricSnapshot, called per collect().
        Contained per-collector (class docstring)."""
        with self._lock:
            self._collectors = [
                (n, f) for n, f in self._collectors if n != name
            ] + [(name, fn)]

    # -- collection ------------------------------------------------------
    def collect(self) -> List[MetricSnapshot]:
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
            collectors = list(self._collectors)
        out = []
        for m in metrics:
            out.append(MetricSnapshot(
                m.name, m.mtype, m.help, m.samples(),
                bounds=getattr(m, "bounds", None),
            ))
        for cname, fn in collectors:
            try:
                snaps = list(fn())
            except Exception as e:  # pylint: disable=broad-except
                msg = repr(e)
                if self._collector_logged.get(cname) != msg:
                    self._collector_logged[cname] = msg
                    log.warning(
                        "metrics collector %r failed (its families are "
                        "dropped this scrape; everything else serves): "
                        "%s", cname, msg,
                    )
                continue
            self._collector_logged.pop(cname, None)
            out.extend(snaps)
        out.sort(key=lambda s: s.name)
        return out

    def render(self, openmetrics: bool = False) -> str:
        """Exposition text.  Default: classic Prometheus text format
        (text/plain; version=0.0.4) — NO exemplars, because the
        classic grammar has no exemplar production: Prometheus's Go
        expfmt parser fails the whole scrape on a `#` after the value,
        and prometheus_client's text parser mis-reads the exemplar
        timestamp as a sample timestamp.  `openmetrics=True` emits the
        OpenMetrics dialect (exemplars on histogram buckets, counter
        families named without the `_total` suffix, `# EOF` trailer)
        for scrapers that negotiate application/openmetrics-text."""
        lines: List[str] = []
        for snap in self.collect():
            fam = snap.name
            if (
                openmetrics
                and snap.mtype == "counter"
                and fam.endswith("_total")
            ):
                # OpenMetrics: the FAMILY drops _total, samples keep it.
                fam = fam[: -len("_total")]
            lines.append(f"# HELP {fam} {snap.help}")
            lines.append(f"# TYPE {fam} {snap.mtype}")
            if snap.mtype in ("counter", "gauge"):
                for labels, value in snap.samples:
                    lines.append(
                        f"{snap.name}{_fmt_labels(labels)} "
                        f"{_fmt_value(value)}"
                    )
                continue
            for labels, s in snap.samples:
                cum = 0
                for i, bound in enumerate(
                    list(snap.bounds) + [math.inf]
                ):
                    cum += s.counts[i]
                    bl = dict(labels)
                    bl["le"] = _fmt_value(bound)
                    line = (
                        f"{snap.name}_bucket{_fmt_labels(bl)} {cum}"
                    )
                    ex = s.exemplars.get(i) if openmetrics else None
                    if ex is not None:
                        tid, v, ts = ex
                        line += (
                            f' # {{trace_id="{_escape_label(tid)}"}} '
                            f"{_fmt_value(v)} {ts:.3f}"
                        )
                    lines.append(line)
                lines.append(
                    f"{snap.name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(s.sum)}"
                )
                lines.append(
                    f"{snap.name}_count{_fmt_labels(labels)} {s.count}"
                )
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


def snapshot_gauges(snap: dict,
                    prefix: str = "serve_engine_") -> List[MetricSnapshot]:
    """The uninstrumented-engine metrics fallback: an engine
    snapshot()'s numeric fields rendered as gauges — ONE definition
    shared by the in-process fleet collector and the worker's scrape
    (serving/worker.py), so the two fleet modes can never drift on
    the fallback shape."""
    return [
        MetricSnapshot(
            f"{prefix}{k}", "gauge",
            f"Engine snapshot {k}", [({}, float(v))],
        )
        for k, v in sorted(snap.items())
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    ]


def relabel_snapshots(snaps: Iterable[MetricSnapshot],
                      **labels) -> List[MetricSnapshot]:
    """Copy metric snapshots with extra labels stamped on every
    sample — how a fleet (serving/fleet.py) folds each replica
    engine's private registry into one scrape as per-engine labelled
    series (serve_engine_*{engine="0"} ...) without the engines
    keeping a second, labelled set of books."""
    extra = {k: str(v) for k, v in labels.items()}
    out = []
    for s in snaps:
        out.append(MetricSnapshot(
            s.name, s.mtype, s.help,
            [({**sample_labels, **extra}, value)
             for sample_labels, value in s.samples],
            bounds=s.bounds,
        ))
    return out


def merge_snapshots(
    snaps: Iterable[MetricSnapshot],
) -> List[MetricSnapshot]:
    """Merge snapshots sharing a family name into one snapshot with
    the concatenated samples (label sets must differ — relabeling per
    replica guarantees that).  A renderer fed two same-named
    snapshots would emit duplicate HELP/TYPE blocks, which strict
    Prometheus parsers reject; collect-time merging keeps the fleet's
    combined scrape one clean family per name."""
    by_name: Dict[str, MetricSnapshot] = {}
    order: List[str] = []
    for s in snaps:
        have = by_name.get(s.name)
        if have is None:
            by_name[s.name] = MetricSnapshot(
                s.name, s.mtype, s.help, list(s.samples),
                bounds=s.bounds,
            )
            order.append(s.name)
        else:
            have.samples.extend(s.samples)
    return [by_name[n] for n in order]


def parse_text(text: str) -> Dict[str, Dict[str, float]]:
    """Minimal Prometheus text-format parser for tests and client-side
    probes: {sample name: {rendered label string: value}} (exemplars
    and comments dropped).  Not a validating parser — it reads what
    Registry.render and prometheus_client emit."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # Strip an exemplar suffix (" # {...} v ts").
        body = line.split(" # ", 1)[0].strip()
        if "}" in body:
            name_labels, _, value = body.rpartition(" ")
            name, _, labels = name_labels.partition("{")
            labels = "{" + labels
        else:
            parts = body.split()
            if len(parts) < 2:
                continue
            name, value = parts[0], parts[1]
            labels = ""
        try:
            v = float(value.replace("+Inf", "inf"))
        except ValueError:
            continue
        out.setdefault(name, {})[labels] = v
    return out


class FlightRecorder:
    """Bounded ring of scheduler events — the engine's black box.

    `record` takes a small lock (writers: the scheduler thread at
    admit/commit/retire boundaries, failure paths and the supervisor
    from other threads — all off the dispatch hot path).  `dump`
    renders the retained window oldest-first with relative timestamps
    and writes it to stderr, so a chaos kill, a supervisor restart, or
    an operator SIGQUIT leaves the last scheduler decisions in the pod
    log; `events()` returns the same window as dicts for
    `engine.snapshot()` and test assertions."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._cap = int(capacity)
        self._buf: List[Optional[tuple]] = [None] * self._cap
        self._n = 0
        self._lock = threading.Lock()

    def record(self, kind: str, **fields) -> None:
        evt = (time.monotonic(), kind, fields)
        with self._lock:
            self._buf[self._n % self._cap] = evt
            self._n += 1

    @property
    def total(self) -> int:
        with self._lock:
            return self._n

    def events(self) -> List[dict]:
        with self._lock:
            n, cap = self._n, self._cap
            if n <= cap:
                window = self._buf[:n]
            else:
                start = n % cap
                window = self._buf[start:] + self._buf[:start]
        return [
            {"t": t, "kind": kind, **fields}
            for t, kind, fields in window
        ]

    def dump(self, reason: str, file=None) -> str:
        events = self.events()
        total = self.total
        lines = [
            f"-- engine flight recorder ({reason}): last "
            f"{len(events)} of {total} events --"
        ]
        t0 = events[0]["t"] if events else 0.0
        for e in events:
            fields = " ".join(
                f"{k}={e[k]}" for k in e if k not in ("t", "kind")
            )
            lines.append(
                f"  +{e['t'] - t0:9.3f}s {e['kind']:<12s} {fields}"
            )
        text = "\n".join(lines)
        print(text, file=file if file is not None else sys.stderr,
              flush=True)
        return text


class NullObservability:
    """Inert observer: every seam entry point is a no-op so
    `ContinuousBatchingEngine(..., observe=False)` measures the
    uninstrumented engine (the overhead control in PERF.md
    "Observability").  The registry/recorder/traces attributes exist
    but stay empty — embedders can treat the two classes uniformly."""

    enabled = False

    def __init__(self):
        self.registry = Registry()
        self.recorder = FlightRecorder(capacity=1)
        self.traces = otel.TraceRing(capacity=1)
        self.process = ""

    def attach_engine(self, engine):
        pass

    def attach_injector(self, injector):
        pass

    def admitted(self, seq, now):
        pass

    def chunk_done(self, seq, t0, t1, width, last):
        pass

    def first_token(self, seq, now):
        pass

    def token_committed(self, seq, now):
        pass

    def spec_window(self, drafted, accepted):
        pass

    def step_committed(self, n_rows, lag_s):
        pass

    def retired(self, seq, now, reason="done"):
        pass

    def event(self, kind, **fields):
        pass

    def spans_for(self, trace_id, limit=64):
        return []

    def dump(self, reason):
        return ""

    def gauge_provider(self, engine):
        return lambda: {}


class EngineObservability:
    """The engine's observer: folds staged monotonic stamps into the
    registry's histograms, seals per-request traces at retire, and
    feeds the flight recorder.  One instance per engine; `registry`
    may be shared with the embedding server (the demo server passes
    its process registry so engine series and server series render
    from one /metrics).

    Seam entry points are called by the engine at admit / commit /
    retire / failure boundaries ONLY — never between staging and
    dispatch (module docstring contract)."""

    enabled = True

    def __init__(
        self,
        registry: Optional[Registry] = None,
        flight_capacity: int = 256,
        trace_capacity: int = 64,
        process: str = "",
    ):
        self.registry = registry or Registry()
        self.recorder = FlightRecorder(capacity=flight_capacity)
        self.traces = otel.TraceRing(capacity=trace_capacity)
        # Span process label: names WHICH process recorded the
        # engine's spans in an assembled cross-process trace.  The
        # worker entry point overwrites it with its replica identity;
        # the default is still distinct per process.
        self.process = process or f"pid{os.getpid()}"
        r = self.registry
        self.ttft = r.histogram(
            "serve_ttft_seconds",
            "Time from submit to first committed token",
            TTFT_BUCKETS,
        )
        self.itl = r.histogram(
            "serve_itl_seconds",
            "Gap between consecutive committed tokens of one row",
            ITL_BUCKETS,
        )
        self.queue_wait = r.histogram(
            "serve_queue_wait_seconds",
            "Time from submit to admission start (slot reserved)",
            QUEUE_WAIT_BUCKETS,
        )
        self.chunk = r.histogram(
            "serve_prefill_chunk_seconds",
            "Wall time of one prefill-chunk seam call (dispatch+compute"
            " on sync backends, dispatch only on async)",
            CHUNK_BUCKETS,
        )
        self.commit_lag = r.histogram(
            "serve_commit_lag_seconds",
            "Dispatch-to-commit lag of one decode step (the pipeline's"
            " overlap window)",
            COMMIT_LAG_BUCKETS,
        )
        self.spec_accept = r.histogram(
            "serve_spec_accept_ratio",
            "Fraction of one speculative window's drafted tokens the"
            " verify pass accepted (spec_k > 0 engines only)",
            SPEC_ACCEPT_BUCKETS,
        )

    # -- wiring ----------------------------------------------------------
    def attach_engine(self, engine) -> None:
        """Absorb the engine's own stats dict as collect-time series:
        one snapshot() per scrape, no second set of books.  Monotonic
        stats keys export as counters, instantaneous ones as gauges."""
        gauge_keys = {
            "max_active", "queue_peak", "active_rows", "queue_depth",
            # Paged KV pool occupancy (instantaneous, not monotonic).
            "kv_pages_total", "kv_pages_in_use", "prefix_cached_pages",
            # Tiered page store occupancy (serving/kvtier.py; the
            # labelled kv_tier_* families ride their own collector —
            # these are the same numbers on the /statz snapshot path).
            "kv_tier_host_entries", "kv_tier_host_pages",
            "kv_tier_host_bytes", "kv_tier_disk_entries",
            "kv_tier_disk_pages", "kv_tier_disk_bytes",
            "kv_tier_open_handles",
            # Speculative decoding: last dispatched draft-window width.
            "spec_draft_depth",
        }

        def collect():
            snap = engine.snapshot()
            for key in sorted(snap):
                val = snap[key]
                if not isinstance(val, (int, float)) or isinstance(
                    val, bool
                ):
                    continue  # e.g. the flight_recorder event list
                if key in gauge_keys:
                    yield MetricSnapshot(
                        f"serve_engine_{key}",
                        "gauge",
                        f"Engine snapshot gauge {key}",
                        [({}, float(val))],
                    )
                else:
                    yield MetricSnapshot(
                        f"serve_engine_{key}_total",
                        "counter",
                        f"Engine counter {key} (see /statz)",
                        [({}, float(val))],
                    )

        self.registry.register_collector("engine-stats", collect)

    def attach_injector(self, injector) -> None:
        """Fault-injection counts (serving/faults.py) as labeled
        counters: a chaos run's injected/absorbed bookkeeping lands on
        the same scrape as the latency histograms it explains."""

        def collect():
            stats = injector.stats()
            for field in ("calls", "injected", "slowed"):
                yield MetricSnapshot(
                    f"serve_fault_{field}_total",
                    "counter",
                    f"Fault-injection seam {field} "
                    "(serving/faults.py)",
                    [
                        ({"seam": seam}, float(s[field]))
                        for seam, s in sorted(stats.items())
                    ],
                )

        self.registry.register_collector("fault-injector", collect)

    def gauge_provider(self, engine) -> Callable[[], Dict[str, float]]:
        """Provider for plugin/metrics.py MetricServer
        `register_external_provider`: instantaneous engine gauges next
        to the device gauges (full engine series ride the
        `attach_external_registry` bridge instead)."""

        def provide() -> Dict[str, float]:
            snap = engine.snapshot()
            out = {
                "serve_engine_queue_depth": float(snap["queue_depth"]),
                "serve_engine_active_rows": float(snap["active_rows"]),
                "serve_engine_restarts": float(snap["restarts"]),
            }
            if "kv_pages_total" in snap:
                out["serve_engine_kv_pages_in_use"] = float(
                    snap["kv_pages_in_use"]
                )
                out["serve_engine_kv_pages_total"] = float(
                    snap["kv_pages_total"]
                )
            if "spec_draft_depth" in snap:
                out["serve_engine_spec_draft_depth"] = float(
                    snap["spec_draft_depth"]
                )
            return out

        return provide

    # -- seam entry points (all off the dispatch hot path) ---------------
    def admitted(self, seq, now: float) -> None:
        """Admission start: slot reserved, prompt about to prefill.
        Folds queue-wait and opens the request's trace — under the
        submitter's PROPAGATED context when one rode the request
        (fleet/RPC submits), so this engine's spans join the caller's
        trace_id and link to its root span; a context-less submit
        (warm-up, direct engine use) mints a local id as before."""
        wait = max(0.0, now - seq.t_submit)
        ctx = getattr(seq, "trace_ctx", None)
        trace = otel.Trace(
            trace_id=ctx.trace_id if ctx is not None else None,
            attrs={
                "row": seq.row_i, "plen": seq.plen,
                "max_new": seq.max_new,
            },
            process=self.process,
            parent_span_id=(
                ctx.parent_span_id if ctx is not None else ""
            ),
        )
        seq.trace = trace
        trace.span("queue_wait", seq.t_submit, now)
        stamp = getattr(seq, "tier_stamp", None)
        if stamp is not None:
            # Admission-time tier promotion: the promote ran
            # BEFORE this trace opened (the scheduler consults the
            # tiers before recomputing), so the engine staged its
            # stamp on the seq and the span is folded here — same
            # staging pattern as t_submit/t_admit.
            t0, t1, tier, pages = stamp
            trace.span(
                "tier_fetch", t0, t1, {"tier": tier, "pages": pages}
            )
        self.queue_wait.observe(wait, exemplar=trace.trace_id)
        self.recorder.record(
            "admit", trace=trace.trace_id, plen=seq.plen,
            queue_wait_ms=round(wait * 1e3, 2),
        )

    def chunk_done(self, seq, t0: float, t1: float, width: int,
                   last: bool) -> None:
        self.chunk.observe(
            t1 - t0,
            exemplar=seq.trace.trace_id if seq.trace else None,
        )
        if seq.trace is not None:
            seq.trace.span(
                "prefill_chunk", t0, t1,
                {"width": width, "final": last},
            )

    def first_token(self, seq, now: float) -> None:
        tid = seq.trace.trace_id if seq.trace else None
        self.ttft.observe(
            max(0.0, now - seq.t_submit), exemplar=tid
        )
        if seq.trace is not None:
            seq.trace.span("decode", now, attrs={})

    def token_committed(self, seq, now: float) -> None:
        """A non-first token commit: fold the inter-token gap against
        the staged previous-commit stamp."""
        if seq.t_last_commit > 0.0:
            self.itl.observe(
                max(0.0, now - seq.t_last_commit),
                exemplar=seq.trace.trace_id if seq.trace else None,
            )

    def spec_window(self, drafted: int, accepted: int) -> None:
        """One row's speculative window committed: fold the accepted
        fraction into the accept-rate histogram (commit boundary —
        off the dispatch hot path, like every other fold)."""
        if drafted > 0:
            self.spec_accept.observe(accepted / drafted)

    def step_committed(self, n_rows: int, lag_s: float) -> None:
        """One whole-batch decode step committed: dispatch->commit lag
        (staged on the pending step at dispatch) plus a recorder event
        — the per-step heartbeat that makes the recorder's tail a
        reconstruction of the scheduler's last moments."""
        self.commit_lag.observe(max(0.0, lag_s))
        self.recorder.record(
            "step", rows=n_rows, lag_ms=round(lag_s * 1e3, 2)
        )

    def retired(self, seq, now: float, reason: str = "done") -> None:
        trace = seq.trace
        if trace is not None:
            for s in trace.spans:
                if s.name == "decode" and s.end is None:
                    s.end = now
            trace.attrs["tokens"] = len(seq.tokens)
            trace.attrs["outcome"] = reason
            self.traces.append(trace)
        self.recorder.record(
            "retire",
            trace=trace.trace_id if trace else "?",
            tokens=len(seq.tokens), outcome=reason,
        )

    def event(self, kind: str, **fields) -> None:
        """Free-form scheduler event (fault / retry / restart / kill /
        drain) into the flight recorder."""
        self.recorder.record(kind, **fields)

    def spans_for(self, trace_id: str, limit: int = 64) -> List[Dict]:
        """Sealed span dicts for `trace_id` from the trace ring,
        bounded at `limit` — what the worker ships back on a
        terminal done/fail frame (and what the in-process fleet reads
        directly).  Best-effort BY DESIGN: a trace evicted from the
        ring (or a request sealed after the caller resolved) returns
        [] — a dropped span payload never fails a request."""
        out: List[Dict] = []
        for trace in self.traces.traces():
            if trace.trace_id != trace_id:
                continue
            for s in trace.spans:
                out.append(s.to_dict())
                if len(out) >= limit:
                    return out
        return out

    def dump(self, reason: str) -> str:
        return self.recorder.dump(reason)


def engine_observability(env=None, registry=None,
                         **kw) -> EngineObservability:
    """Factory reading the serving knobs from the mapping `env` (None
    is an empty mapping: the port reads no process environment):
    SERVE_LM_FLIGHT_EVENTS (flight-recorder capacity, 256)."""
    env = {} if env is None else env
    kw.setdefault("flight_capacity",
                  int(env.get("SERVE_LM_FLIGHT_EVENTS", "256")))
    return EngineObservability(registry=registry, **kw)
