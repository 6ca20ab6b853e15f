"""HTTP inference server over one engine or a fleet of engine replicas:
the port of demo/serving/server.py.

    python -m container_engine_accelerators_tpu_torch.server [flags]

Routes (the reference's contract):
  GET  /healthz   200 "ok" while serving; 503 "loading", or 503 with a
                  Retry-After and "draining: <reasons>"
  GET  /metrics   the app's registry (engine histograms and counters,
                  HTTP outcomes, the drain state), in every state;
                  OpenMetrics to a scraper that asks for it
  GET  /tracez    the engine's recent traces and per-stage latency
                  attribution (continuous engine only; a fleet serves
                  the router's assembled traces)
  GET  /statz     DEPRECATED: the same counters as JSON (a fleet: its
                  snapshot, every replica's engine snapshot included)
  POST /predict   raw float32 NHWC images -> {"labels": [...]}
  POST /generate  {"prompt": [[int, ...]], "max_new": N, "temperature":
                  T, "top_k": K, "top_p": P, "stop_token": S} ->
                  {"tokens": [[int, ...]], "trace_id": ...}; 400 on a
                  malformed request, 429 with a Retry-After when the
                  admission queue is full, 503 while draining, 500 on
                  any other failure

Flags take the place of the reference's environment knobs (the port
reads none); defaults and derived rules are the reference's:
  --model SERVE_MODEL, --image-size IMAGE_SIZE, --batch SERVE_BATCH,
  --classes SERVE_CLASSES, --port PORT (0 binds a free port and prints
  it on stderr), --dim / --depth / --vocab / --max-seq / --heads
  SERVE_LM_DIM / _DEPTH / _VOCAB / _MAX_SEQ / _HEADS (0: dim // 128),
  --warm-prompt / --warm-new SERVE_LM_WARM_PROMPT / _WARM_NEW,
  --max-gen-batch SERVE_LM_MAX_BATCH, --bucket-min SERVE_LM_BUCKET_MIN,
  --quant SERVE_LM_QUANT (auto|on|off), --quant-max-batch
  SERVE_LM_QUANT_MAX_BATCH, --request-timeout-s
  SERVE_LM_REQUEST_TIMEOUT_S, --batch-window-ms SERVE_LM_BATCH_WINDOW_MS,
  --engine SERVE_LM_ENGINE (continuous|wave), --slots SERVE_LM_SLOTS
  (0: min(max-gen-batch, 16)), --max-queue SERVE_LM_MAX_QUEUE (0:
  8 x slots, never below max-gen-batch), --prefill-chunk
  SERVE_LM_PREFILL_CHUNK, --no-pipeline SERVE_LM_PIPELINE=0,
  --no-paged SERVE_LM_PAGED=0, --page-size SERVE_LM_PAGE_SIZE,
  --kv-pages SERVE_LM_KV_PAGES, --no-prefix-cache
  SERVE_LM_PREFIX_CACHE=0, --kv-host-mb / --kv-disk-dir / --kv-disk-mb
  SERVE_LM_KV_HOST_MB / _KV_DISK_DIR / _KV_DISK_MB, --spec-k
  SERVE_LM_SPEC_K, --no-spec-adapt SERVE_LM_SPEC_ADAPT=0,
  --spec-min-accept SERVE_LM_SPEC_MIN_ACCEPT, --decode-steps
  SERVE_LM_DECODE_STEPS, --step-retries SERVE_LM_STEP_RETRIES,
  --retry-backoff-ms SERVE_LM_RETRY_BACKOFF_MS, --max-restarts
  SERVE_LM_MAX_RESTARTS, --retry-after-s SERVE_RETRY_AFTER_S,
  --drain-timeout-s SERVE_DRAIN_TIMEOUT_S, --no-observe
  SERVE_LM_OBSERVE=0, --checkpoint SERVE_LM_CHECKPOINT, and --device
  (default cuda; without a card and without --device cpu the server
  exits 2).
The fleet (continuous engine only): --fleet N SERVE_LM_FLEET (N >= 2
  in-process replicas of --slots slots each, all on --device, sharing
  the model), --fleet-procs N SERVE_LM_FLEET_PROCS (N >= 2 engine-worker
  processes, each rebuilding the model from the same flags; exclusive
  with --fleet), --fleet-affinity 0|1 SERVE_LM_FLEET_AFFINITY,
  --fleet-roles SERVE_LM_FLEET_ROLES ("prefill:1,decode:1"),
  --fleet-migrate 0|1 SERVE_LM_FLEET_MIGRATE, --fleet-spawn-timeout-s
  SERVE_LM_FLEET_SPAWN_TIMEOUT_S, --fleet-tcp 0|1 SERVE_LM_FLEET_TCP,
  --fleet-hb-s / --fleet-hb-timeout-s / --fleet-reconnect-s
  SERVE_LM_FLEET_HB_S / _HB_TIMEOUT_S / _RECONNECT_S.  Both fleet modes
  build their engines from the same kwargs as the single engine
  (`engine_kw`), warm every replica before readiness, and drain on the
  last replica's eviction; SIGTERM closes a process fleet's workers.
Accepted but not ported yet, each exits 2 naming its ROADMAP item:
--mesh dp (SERVE_LM_MESH: A10); --health-source (SERVE_HEALTH_SOURCE:
A12).  SERVE_HEALTH_CRITICAL's default is `HEALTH_CRITICAL`, the codes
`attach_health_source` drains on; its flag comes with --health-source
(A12).

Differences of idiom from the reference: its module globals live in one
`ServingApp`, so several servers can share a process (`main` alone
installs signal handlers); the wave batcher keeps the reference's
finite bucket ladder although nothing is compiled (it is the HTTP
contract, a tight-fit wave request answers 400, and it bounds the
shapes the caching allocator sees); the int8 wave path quantizes and
dequantizes the model once at load.  The engine's scheduler thread and
the wave batcher's thread run all the LM's device work; handler threads
touch numpy and `submit` only; the classifier's forwards run on one
thread of their own.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .serving import otel
from .serving.errors import QueueFullError
from .serving.observe import MetricSnapshot, Registry

# The fixed drain-reason vocabulary (bounded label cardinality).
DRAIN_REASONS = ("device-health", "shutdown", "engine-failed")
# The chip event codes that begin the "device-health" drain (the
# reference's SERVE_HEALTH_CRITICAL default).
HEALTH_CRITICAL = frozenset({1, 2, 3, 4, 5, 1000})
# The factory a process fleet's workers build their model with.
WORKER_FACTORY = ("container_engine_accelerators_tpu_torch.serving.worker"
                  ":demo_lm_factory")


@dataclasses.dataclass
class ServeConfig:
    """Every knob of the server (parse_args maps the flags; the module
    docstring names each one's reference knob).  __post_init__ applies
    the reference's derived rules to heads, slots, max_queue and
    retry_after_s, and sets `grid`."""

    model: str = "resnet50"
    image_size: int = 224
    batch: int = 8
    classes: int = 1000
    port: int = 8500
    dim: int = 512
    depth: int = 4
    vocab: int = 32000
    max_seq: int = 1024
    heads: int = 0
    warm_prompt: int = 16
    warm_new: int = 16
    max_gen_batch: int = 64
    bucket_min: int = 16
    quant: str = "auto"
    quant_max_batch: int = 16
    request_timeout_s: float = 600.0
    batch_window_ms: float = 4.0
    engine: str = "continuous"
    slots: int = 0
    max_queue: int = 0
    prefill_chunk: int = 256
    pipeline: bool = True
    paged: bool = True
    page_size: int = 64
    kv_pages: int = 0
    prefix_cache: bool = True
    kv_host_mb: int = 0
    kv_disk_dir: str = ""
    kv_disk_mb: int = 0
    spec_k: int = 0
    spec_adapt: bool = True
    spec_min_accept: float = 0.4
    decode_steps: int = 0
    step_retries: int = 3
    retry_backoff_ms: float = 50.0
    max_restarts: int = 3
    retry_after_s: float = 1.0
    drain_timeout_s: float = 30.0
    observe: bool = True
    checkpoint: str = ""
    device: str = "cuda"
    fleet: int = 0
    fleet_affinity: bool = True
    fleet_roles: str = ""
    fleet_migrate: bool = False
    fleet_procs: int = 0
    fleet_spawn_timeout_s: float = 600.0
    fleet_tcp: bool = False
    fleet_hb_s: float = 5.0
    fleet_hb_timeout_s: float = 15.0
    fleet_reconnect_s: float = 10.0
    # Not ported yet (main exits 2): A10, A12.
    mesh: Optional[str] = None
    health_source: Optional[str] = None
    grid: int = dataclasses.field(init=False)

    def __post_init__(self):
        self.heads = self.heads or max(1, self.dim // 128)
        self.slots = self.slots or min(self.max_gen_batch, 16)
        # Clamped so two grid-rounded sides always fit a small max_seq.
        self.grid = max(1, min(self.bucket_min, self.max_seq // 2))
        # At least max_gen_batch: every batch that passes validation is
        # admittable on an idle engine.
        self.max_queue = max(self.max_queue or 8 * self.slots,
                             self.max_gen_batch)
        self.retry_after_s = max(1, int(float(self.retry_after_s)))

    def unported(self) -> Optional[str]:
        """Why this configuration cannot run yet, naming the ROADMAP
        item, or None."""
        if self.mesh is not None:
            return ("a device mesh (--mesh) is not ported yet (ROADMAP "
                    "A10)")
        if self.health_source is not None:
            return ("--health-source needs plugin/health.py's event "
                    "sources, not ported yet (ROADMAP A12)")
        return None


def parse_args(argv=None) -> ServeConfig:
    d = ServeConfig()
    p = argparse.ArgumentParser(
        description="HTTP inference server over one engine (the module "
        "docstring maps each flag to the reference's knob)")

    def opt(flag, kind, **kw):
        p.add_argument(flag, type=kind, **kw)

    opt("--model", str, default=d.model)
    opt("--image-size", int, default=d.image_size)
    opt("--batch", int, default=d.batch)
    opt("--classes", int, default=d.classes)
    opt("--port", int, default=d.port)
    opt("--dim", int, default=d.dim)
    opt("--depth", int, default=d.depth)
    opt("--vocab", int, default=d.vocab)
    opt("--max-seq", int, default=d.max_seq)
    opt("--heads", int, default=0, help="0: dim // 128")
    opt("--warm-prompt", int, default=d.warm_prompt)
    opt("--warm-new", int, default=d.warm_new)
    opt("--max-gen-batch", int, default=d.max_gen_batch)
    opt("--bucket-min", int, default=d.bucket_min)
    opt("--quant", str, default=d.quant, choices=("auto", "on", "off"))
    opt("--quant-max-batch", int, default=d.quant_max_batch)
    opt("--request-timeout-s", float, default=d.request_timeout_s)
    opt("--batch-window-ms", float, default=d.batch_window_ms)
    opt("--engine", str, default=d.engine, choices=("continuous", "wave"))
    opt("--slots", int, default=0, help="0: min(max-gen-batch, 16)")
    opt("--max-queue", int, default=0, help="0: 8 x slots")
    opt("--prefill-chunk", int, default=d.prefill_chunk)
    p.add_argument("--no-pipeline", dest="pipeline", action="store_false")
    p.add_argument("--no-paged", dest="paged", action="store_false")
    opt("--page-size", int, default=d.page_size)
    opt("--kv-pages", int, default=d.kv_pages)
    p.add_argument("--no-prefix-cache", dest="prefix_cache",
                   action="store_false")
    opt("--kv-host-mb", int, default=d.kv_host_mb)
    opt("--kv-disk-dir", str, default=d.kv_disk_dir)
    opt("--kv-disk-mb", int, default=d.kv_disk_mb)
    opt("--spec-k", int, default=d.spec_k)
    p.add_argument("--no-spec-adapt", dest="spec_adapt",
                   action="store_false")
    opt("--spec-min-accept", float, default=d.spec_min_accept)
    opt("--decode-steps", int, default=d.decode_steps)
    opt("--step-retries", int, default=d.step_retries)
    opt("--retry-backoff-ms", float, default=d.retry_backoff_ms)
    opt("--max-restarts", int, default=d.max_restarts)
    opt("--retry-after-s", float, default=d.retry_after_s)
    opt("--drain-timeout-s", float, default=d.drain_timeout_s)
    p.add_argument("--no-observe", dest="observe", action="store_false")
    opt("--checkpoint", str, default=d.checkpoint)
    opt("--device", str, default=d.device)
    opt("--fleet", int, default=d.fleet, help="in-process replicas")
    opt("--fleet-procs", int, default=d.fleet_procs,
        help="engine-worker processes")
    for flag, default in (("--fleet-affinity", d.fleet_affinity),
                          ("--fleet-migrate", d.fleet_migrate),
                          ("--fleet-tcp", d.fleet_tcp)):
        p.add_argument(flag, choices=("0", "1"), default=str(int(default)))
    opt("--fleet-roles", str, default=d.fleet_roles)
    opt("--fleet-spawn-timeout-s", float, default=d.fleet_spawn_timeout_s)
    opt("--fleet-hb-s", float, default=d.fleet_hb_s)
    opt("--fleet-hb-timeout-s", float, default=d.fleet_hb_timeout_s)
    opt("--fleet-reconnect-s", float, default=d.fleet_reconnect_s)
    opt("--mesh", str, default=None, help="ROADMAP A10")
    opt("--health-source", str, default=None, help="ROADMAP A12")
    args = vars(p.parse_args(argv))
    for key in ("fleet_affinity", "fleet_migrate", "fleet_tcp"):
        args[key] = args[key] == "1"
    return ServeConfig(**args)


def _parse_fleet_roles(spec: str, n: int):
    """"prefill:1,decode:2" -> ["prefill", "decode", "decode"] (replica
    index order, as written); None for an empty spec."""
    if not spec:
        return None
    roles = []
    for part in spec.split(","):
        name, sep, count = part.strip().partition(":")
        if not sep:
            raise ValueError(
                f"--fleet-roles entry {part!r} must be role:count"
            )
        roles.extend([name.strip()] * int(count))
    if len(roles) != n:
        raise ValueError(
            f"--fleet-roles names {len(roles)} replicas, the fleet has {n}"
        )
    return roles


def _check_fleet_migration_knobs(cfg: ServeConfig, roles) -> None:
    """Roles and migration need the paged engine with the radix prefix
    cache (page export serializes trie pages): a misconfigured fleet
    fails at boot, never as per-request export failures."""
    if (roles or cfg.fleet_migrate) and not (cfg.paged and cfg.prefix_cache):
        raise ValueError(
            "--fleet-roles / --fleet-migrate need the paged engine with "
            "the prefix cache (page migration moves radix-trie pool "
            "pages)"
        )


# -- the bucket ladder and the quant policy ----------------------------------
def pick_quant(b_bucket: int, mode: str, max_batch: int) -> bool:
    """The decode path for one batch: int8 while decode is bound by the
    weight stream, bf16 once the batch amortizes it; "auto" picks per
    batch (int8 at b_bucket <= max_batch), "on" / "off" force it."""
    if mode == "auto":
        return b_bucket <= max_batch
    return mode == "on"


def _bucket(n: int, lo: int) -> int:
    edge = max(lo, 1)
    while edge < n:
        edge *= 2
    return edge


def _grid(n: int, grid: int) -> int:
    return -(-n // grid) * grid


def pick_buckets(p_len: int, max_new: int, grid: int, max_seq: int):
    """(p_bucket, n_bucket) with p_bucket >= p_len, n_bucket >= max_new
    and their sum <= max_seq, from a FINITE ladder: powers of two from
    the grid, then grid multiples, then max_seq-minus-grid pairs.  A
    request that fills max_seq too tightly for any pair raises
    ValueError (answered as 400)."""
    p_b, n_b = _bucket(p_len, grid), _bucket(max_new, grid)
    if p_b + n_b <= max_seq:
        return p_b, n_b
    p_b, n_b = _grid(p_len, grid), _grid(max_new, grid)
    if p_b + n_b <= max_seq:
        return p_b, n_b
    if max_seq - p_b >= max_new:
        return p_b, max_seq - p_b
    if max_seq - n_b >= p_len:
        return max_seq - n_b, n_b
    raise ValueError(
        f"prompt ({p_len}) + max_new ({max_new}) leaves no room for "
        f"serving-bucket rounding (grid {grid}, max_seq "
        f"{max_seq}); shorten the request by "
        f"{_grid(p_len, grid) + _grid(max_new, grid) - max_seq} tokens"
    )


# -- the wave engine ----------------------------------------------------------
class _Batcher:
    """Cross-request dynamic batching for /generate: a worker thread
    groups queued requests that share a (p_bucket, n_bucket, top-k/top-p
    given) key, pads the group to one power-of-two batch and runs ONE
    decode for it (`run_group`); requests of other keys run as separate
    groups in queue order.  `stats` counts groups, requests, rows and
    the largest group."""

    def __init__(self, run_group, buckets, max_rows, window_s, timeout_s):
        self._run_group = run_group
        self._buckets = buckets
        self._max_rows = max_rows
        self.window_s = window_s
        self.timeout_s = timeout_s
        self._cv = threading.Condition()
        self._queue = []  # guarded-by: _cv
        self._inflight = 0  # rows of the group decoding; guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self.stats = {"groups": 0, "requests": 0, "rows": 0,
                      "max_group_rows": 0}
        self._thread = threading.Thread(target=self._loop,
                                        name="gen-batcher", daemon=True)
        self._thread.start()

    def submit(self, prompt, max_new, temperature, top_k=None, top_p=None,
               timeout="default"):
        """Blocking: enqueue one request ((rows, p_len) int32 prompt)
        and wait for its slice of the group's decode: (rows, max_new)
        tokens.  timeout "default" is `timeout_s`; None waits forever
        (the readiness warm-up).  A request still queued at its deadline
        is withdrawn and raises RuntimeError."""
        p_bucket, n_bucket = self._buckets(prompt.shape[1], max_new)
        req = {
            "prompt": prompt, "max_new": max_new,
            "temp": float(temperature), "top_k": top_k, "top_p": top_p,
            "key": (p_bucket, n_bucket,
                    top_k is not None or top_p is not None),
            "rows": prompt.shape[0], "done": threading.Event(),
        }
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(req)
            self._cv.notify()
        deadline = self.timeout_s if timeout == "default" else timeout
        if not req["done"].wait(timeout=deadline):
            with self._cv:  # by identity: requests hold arrays
                self._queue = [r for r in self._queue if r is not req]
            raise RuntimeError(
                f"generation timed out after {deadline:.0f}s "
                "(--request-timeout-s)"
            )
        if "error" in req:
            raise req["error"]
        return req["result"]

    def busy(self) -> bool:
        """True while a request is queued or a group decodes (a group
        leaves the queue before it decodes)."""
        with self._cv:
            return bool(self._queue or self._inflight)

    def close(self):
        """Stop the worker: groups in flight finish; new submits raise."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=60)

    def _lead_is_full(self):
        """True when the head key's queued rows already fill max_rows:
        waiting for companions would be dead time."""
        with self._cv:
            if not self._queue:
                return True
            lead_key, rows = self._queue[0]["key"], 0
            for r in self._queue:
                if r["key"] == lead_key:
                    rows += r["rows"]
                    if rows >= self._max_rows:
                        return True
            return False

    def _loop(self):
        # Grad mode is thread-local: this thread decodes without it.
        with torch.inference_mode():
            while True:
                with self._cv:
                    while not self._queue:
                        if self._closed:
                            return
                        self._cv.wait()
                if self.window_s > 0 and not self._lead_is_full():
                    time.sleep(self.window_s)  # let companions arrive
                with self._cv:
                    if not self._queue:
                        continue  # every queued request withdrew
                    # The lead always runs; companions join while they
                    # fit.
                    lead = self._queue[0]
                    group, kept, rows = [lead], [], lead["rows"]
                    for r in self._queue[1:]:
                        if (r["key"] == lead["key"]
                                and rows + r["rows"] <= self._max_rows):
                            group.append(r)
                            rows += r["rows"]
                        else:
                            kept.append(r)
                    self._queue = kept
                    self._inflight = rows
                try:
                    self._run_group(group)
                    self.stats["groups"] += 1
                    self.stats["requests"] += len(group)
                    self.stats["rows"] += rows
                    self.stats["max_group_rows"] = max(
                        self.stats["max_group_rows"], rows)
                except Exception as e:  # pylint: disable=broad-except
                    for r in group:
                        r["error"] = e
                finally:
                    with self._cv:
                        self._inflight = 0
                    for r in group:
                        r["done"].set()


class _HealthWatch:
    """Subscribes the app to a health event source (any object with
    `wait(ms)` -> event or None, and `recover()`): a critical chip event
    or a host-wide event begins the "device-health" drain; an
    ERROR_CLEARED event (code 0) for the last bad chip ends it.  A
    failing wait recovers the source and carries on."""

    def __init__(self, app, source, critical):
        self._app = app
        self._source = source
        self._critical = set(critical)
        self._stop = threading.Event()
        self.unhealthy = set()  # chip indices, or "host"
        self._thread = threading.Thread(target=self._loop,
                                        name="health-watch", daemon=True)
        self._thread.start()

    def stop(self):
        """Stop watching and release the drain this watch owns: nothing
        else could ever observe the recovery that clears it."""
        self._stop.set()
        self._thread.join(timeout=10)
        self.unhealthy.clear()
        self._app.end_drain("device-health")

    def _loop(self):
        while not self._stop.is_set():
            try:
                event = self._source.wait(1000)
            except Exception as e:  # pylint: disable=broad-except
                print(f"serving: health watch wait error: {e}",
                      file=sys.stderr)
                self._stop.wait(0.2)
                try:
                    self._source.recover()
                except Exception:  # pylint: disable=broad-except
                    pass
                continue
            if event is not None:
                self._apply(event)

    def _apply(self, event):
        code = int(event.error_code)
        idx = int(getattr(event, "device_index", -1))
        if code == 0:  # ERROR_CLEARED
            if idx < 0:
                self.unhealthy.clear()
            else:
                self.unhealthy.discard(idx)
            if not self.unhealthy:
                self._app.end_drain("device-health")
            return
        if getattr(event, "is_host_event", False):
            self.unhealthy.add("host")
        elif code in self._critical:
            self.unhealthy.add(idx)
        else:
            return
        self._app.begin_drain("device-health")


class ServingApp:
    """One server's state: the registry (with serve_http_requests_total
    and the server-state collector), the drain state machine, the health
    watch, and the model path `load_model` builds (the continuous engine
    under its supervisor, the wave batcher, or the classifier).  The
    server is SERVING once ready and while no drain reason is held;
    reasons compose, and service resumes when every one has cleared."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        self.ready = threading.Event()
        self.registry = Registry()
        self._http = self.registry.counter(
            "serve_http_requests_total",
            "HTTP requests answered, by route and status code",
            labelnames=("route", "code"),
        )
        self.registry.register_collector("server-state", self._collect)
        self._state_lock = threading.Lock()
        self._drain_reasons = set()  # guarded-by: _state_lock
        # Inference handlers in flight, counted before the drain gate and
        # released after the response is written: a drain waits for the
        # whole request path.
        self._inflight = 0  # guarded-by: _state_lock
        self.model = None
        self.engine = None
        self.supervisor = None
        self.fleet = None  # FleetManager or ProcessFleetManager
        self.batcher = None
        self.qparams = self.deq = None  # the wave path's int8 twin
        self._generate = None
        self._predict = None
        self._predict_pool = None  # the classifier's one device thread
        self._health_watch = None

    # -- the drain state machine ----------------------------------------
    def count_http(self, route: str, code: int) -> None:
        self._http.inc(1.0, route, str(code))

    def inflight_enter(self):
        with self._state_lock:
            self._inflight += 1

    def inflight_exit(self):
        with self._state_lock:
            self._inflight -= 1

    def begin_drain(self, reason: str) -> None:
        with self._state_lock:
            new = reason not in self._drain_reasons
            self._drain_reasons.add(reason)
        if new:
            print(f"serving: DRAINING ({reason})", file=sys.stderr)

    def end_drain(self, reason: str) -> None:
        with self._state_lock:
            cleared = reason in self._drain_reasons
            self._drain_reasons.discard(reason)
            empty = not self._drain_reasons
        if cleared and empty:
            print(f"serving: drain cleared ({reason}); serving restored",
                  file=sys.stderr)

    def draining(self) -> str:
        """The held drain reasons, comma-joined ("" when none)."""
        with self._state_lock:
            return ", ".join(sorted(self._drain_reasons))

    def server_state(self) -> str:
        """"loading" | "serving" | "draining: <reasons>"."""
        if not self.ready.is_set():
            return "loading"
        reasons = self.draining()
        return f"draining: {reasons}" if reasons else "serving"

    def _collect(self):
        """The server-state collector: the drain state machine, the drain
        reasons, the in-flight handlers and the wave batcher's counters,
        read at scrape time."""
        coarse = self.server_state().split(":")[0].strip()
        yield MetricSnapshot(
            "serve_server_state", "gauge",
            "Server drain-state machine (1 on the current state)",
            [({"state": s}, 1.0 if s == coarse else 0.0)
             for s in ("loading", "serving", "draining")],
        )
        with self._state_lock:
            reasons = set(self._drain_reasons)
            inflight = self._inflight
        yield MetricSnapshot(
            "serve_drain_reason", "gauge",
            "Active drain reasons (1 while held)",
            [({"reason": r}, 1.0 if r in reasons else 0.0)
             for r in DRAIN_REASONS],
        )
        yield MetricSnapshot(
            "serve_inflight_requests", "gauge",
            "Inference HTTP handlers currently in flight",
            [({}, float(inflight))],
        )
        if self.batcher is not None:
            stats = dict(self.batcher.stats)
            for key in ("groups", "requests", "rows"):
                yield MetricSnapshot(
                    f"serve_wave_{key}_total", "counter",
                    f"Wave batcher {key} (see /statz)",
                    [({}, float(stats[key]))],
                )
            yield MetricSnapshot(
                "serve_wave_max_group_rows", "gauge",
                "Largest coalesced wave group so far",
                [({}, float(stats["max_group_rows"]))],
            )

    def idle(self) -> bool:
        """True when no request is queued, decoding or in a handler."""
        with self._state_lock:
            if self._inflight:
                return False
        snaps = ([self.engine.snapshot()] if self.engine is not None
                 else self.fleet.snapshot()["engines"]
                 if self.fleet is not None else [])
        if any(s["active_rows"] or s["queue_depth"] for s in snaps):
            return False
        return self.batcher is None or not self.batcher.busy()

    def drain_for_shutdown(self, httpd=None, timeout=None) -> bool:
        """The SIGTERM / preStop path: begin the "shutdown" drain
        (/healthz 503s, new /generate requests answer 503), wait for the
        work in flight to finish, at most `timeout` (default
        --drain-timeout-s), then stop `httpd`.  True when the work
        finished."""
        self.begin_drain("shutdown")
        deadline = time.monotonic() + (
            self.cfg.drain_timeout_s if timeout is None else timeout)
        while not self.idle() and time.monotonic() < deadline:
            time.sleep(0.1)
        idle = self.idle()
        if self.fleet is not None and hasattr(self.fleet, "worker_pids"):
            # A process fleet's workers drain too (SIGTERM each, reap):
            # no worker outlives its router.  Before httpd.shutdown(),
            # which lets main return and the process exit.
            print("serving: draining worker processes", file=sys.stderr)
            self.fleet.close()
        if httpd is not None:
            httpd.shutdown()
        return idle

    def attach_health_source(self, source, critical=None):
        """Install (or replace) the health subscription; returns it."""
        if self._health_watch is not None:
            self._health_watch.stop()
        self._health_watch = _HealthWatch(
            self, source, HEALTH_CRITICAL if critical is None else critical)
        return self._health_watch

    def dump_flight_recorder(self, reason: str) -> None:
        """Dump the engine's flight recorder to stderr, every replica's
        in a fleet (a process fleet's recorders live in its workers; a
        no-op note without an observed engine)."""
        engines = ([r.engine for r in self.fleet.replicas]
                   if self.fleet is not None else [self.engine])
        dumped = False
        for i, eng in enumerate(engines):
            obs = getattr(eng, "observability", None)
            if getattr(obs, "enabled", False):
                obs.dump(f"{reason} [engine {i}]")
                dumped = True
        if not dumped:
            print(f"serving: no flight recorder to dump ({reason})",
                  file=sys.stderr)

    def pick_quant(self, b_bucket: int) -> bool:
        return pick_quant(b_bucket, self.cfg.quant, self.cfg.quant_max_batch)

    def pick_buckets(self, p_len: int, max_new: int):
        return pick_buckets(p_len, max_new, self.cfg.grid, self.cfg.max_seq)

    # -- the model paths ------------------------------------------------
    def load_model(self, model=None) -> None:
        """Build the configured path and mark the app ready after a
        warm-up: the continuous engine, a fleet of them (--fleet or
        --fleet-procs), the wave batcher (--model transformer_lm) or the
        classifier.  `model`: a prebuilt model on the configured device
        (a decode=True TransformerLM, or a vision model), in place of
        random weights from seed 0 or --checkpoint; a process fleet's
        workers build their own."""
        cfg = self.cfg
        dev = resolve_device(cfg.device)
        lm_fleet = cfg.model == "transformer_lm" and cfg.engine == "continuous"
        if lm_fleet and cfg.fleet_procs >= 2:
            if model is not None:
                raise ValueError("a process fleet's workers build their "
                                 "own model; load_model(model=) needs "
                                 "--fleet")
            self._load_fleet_procs(dev)
        elif cfg.model != "transformer_lm":
            self._load_classifier(dev, model)
        else:
            if model is None:
                model = self._build_lm(dev)
            self.model = model
            if lm_fleet and cfg.fleet >= 2:
                self._load_fleet(model)
            elif cfg.engine == "continuous":
                self._load_continuous(model)
            else:
                self._load_wave(model)
        self.ready.set()

    def _build_lm(self, dev):
        from .models import generate as G

        cfg = self.cfg
        model = G.make_decoder(vocab=cfg.vocab, dim=cfg.dim, depth=cfg.depth,
                               heads=cfg.heads, max_seq=cfg.max_seq,
                               device=dev)
        if not cfg.checkpoint:
            return model.init_random(torch.Generator().manual_seed(0))
        from .utils.checkpoint import restore_params

        if restore_params(cfg.checkpoint, model) is None:
            raise RuntimeError(
                f"--checkpoint {cfg.checkpoint} contains no checkpoint "
                "(train with lm_main.py --model-dir)"
            )
        return model

    def _warm_shape(self):
        cfg = self.cfg
        warm_p = min(cfg.warm_prompt, cfg.max_seq - 1)
        return warm_p, max(1, min(cfg.warm_new, cfg.max_seq - warm_p))

    def engine_kw(self) -> dict:
        """The ONE set of engine kwargs the single engine and both fleet
        modes build from (the fleets' replicas each get --slots slots),
        so a knob cannot reach one mode and miss another."""
        cfg = self.cfg
        return dict(
            quant=self.pick_quant(cfg.slots), prompt_grid=cfg.grid,
            prefill_chunk=cfg.prefill_chunk, pipeline=cfg.pipeline,
            paged=cfg.paged, page_size=cfg.page_size,
            kv_pages=cfg.kv_pages or None, prefix_cache=cfg.prefix_cache,
            kv_host_bytes=cfg.kv_host_mb << 20,
            kv_disk_dir=cfg.kv_disk_dir or None,
            kv_disk_bytes=cfg.kv_disk_mb << 20,
            spec_k=cfg.spec_k, spec_adaptive=cfg.spec_adapt,
            spec_min_accept=cfg.spec_min_accept,
            decode_steps=cfg.decode_steps,
            rng_seed=int.from_bytes(os.urandom(4), "big"),
            max_queue=cfg.max_queue, step_retries=cfg.step_retries,
            retry_backoff_s=cfg.retry_backoff_ms / 1e3,
            observe=cfg.observe,
        )

    def _load_continuous(self, model):
        from .serving import ContinuousBatchingEngine, EngineSupervisor

        cfg = self.cfg
        kw = self.engine_kw()
        quant = kw["quant"]
        engine = ContinuousBatchingEngine(
            model, cfg.slots, registry=self.registry, device=model.device,
            **kw,
        )
        self.engine = engine
        # Past the restart budget the engine is dead and the server
        # drains for good (orchestration restarts the pod).
        self.supervisor = EngineSupervisor(
            engine, max_restarts=cfg.max_restarts,
            on_giveup=lambda err: self.begin_drain("engine-failed"),
        ).start()
        snap = engine.snapshot()
        print(
            f"serving: continuous engine, {cfg.slots} slots, "
            f"{'int8 weight+kv' if quant else 'bf16'} decode, "
            f"prefill_chunk {cfg.prefill_chunk}, pipeline "
            f"{'on' if cfg.pipeline else 'off'}, "
            + (f"paged page{cfg.page_size} pool"
               f"{snap.get('kv_pages_total', 0)} prefix_cache "
               f"{'on' if cfg.prefix_cache else 'off'}, "
               if cfg.paged else "contiguous cache, ")
            + (f"spec_k {cfg.spec_k}, " if cfg.spec_k else "")
            + f"max_queue {cfg.max_queue}, {cfg.step_retries} step retries",
            file=sys.stderr,
        )

        def gen(prompt, max_new, temperature, top_k=None, top_p=None,
                stop_token=None, trace_ctx=None):
            return engine.submit(
                prompt, max_new, temperature, top_k=top_k, top_p=top_p,
                stop_token=stop_token, timeout=cfg.request_timeout_s,
                trace_ctx=trace_ctx,
            )

        warm_p, warm_n = self._warm_shape()
        # No deadline: a first call may legitimately outlast any request
        # deadline.
        engine.submit(np.zeros((1, warm_p), np.int32), warm_n, 0.0,
                      timeout=None)
        self._generate = gen

    def _load_fleet(self, model):
        """--fleet N: N in-process replicas on the model's device behind
        the router; each keeps a private registry that the fleet
        relabels engine="<i>" onto this app's /metrics."""
        from .serving.fleet import FleetManager

        cfg = self.cfg
        roles = _parse_fleet_roles(cfg.fleet_roles, cfg.fleet)
        _check_fleet_migration_knobs(cfg, roles)
        self.fleet = FleetManager(
            model, cfg.fleet, cfg.slots, engine_kw=self.engine_kw(),
            affinity=cfg.fleet_affinity, roles=roles,
            migrate=cfg.fleet_migrate, max_restarts=cfg.max_restarts,
            # The last replica evicted: nothing is left to serve.  One
            # replica dying never drains the fleet.
            on_all_dead=lambda err: self.begin_drain("engine-failed"),
            registry=self.registry,
        )
        print(f"serving: fleet of {cfg.fleet} x {cfg.slots}-slot engines "
              f"on {model.device}, affinity "
              f"{'on' if cfg.fleet_affinity else 'off'}"
              + (f", roles {cfg.fleet_roles}" if roles else
                 ", kv migration on" if cfg.fleet_migrate else "")
              + f", max_queue {cfg.max_queue} per replica", file=sys.stderr)
        self._serve_fleet()

    def _load_fleet_procs(self, dev):
        """--fleet-procs N: N engine-worker processes behind the router;
        each builds the model from these flags (WORKER_FACTORY) on
        --device, so this process holds no model."""
        from .serving.fleet import ProcessFleetManager

        cfg = self.cfg
        if cfg.fleet >= 2:
            raise ValueError("--fleet and --fleet-procs are mutually "
                             "exclusive")
        roles = _parse_fleet_roles(cfg.fleet_roles, cfg.fleet_procs)
        _check_fleet_migration_knobs(cfg, roles)
        self.fleet = ProcessFleetManager(
            WORKER_FACTORY,
            dict(vocab=cfg.vocab, dim=cfg.dim, depth=cfg.depth,
                 heads=cfg.heads, max_seq=cfg.max_seq,
                 checkpoint=cfg.checkpoint, device=str(dev)),
            cfg.fleet_procs, cfg.slots, engine_kw=self.engine_kw(),
            affinity=cfg.fleet_affinity, roles=roles,
            migrate=cfg.fleet_migrate, max_restarts=cfg.max_restarts,
            spawn_timeout_s=cfg.fleet_spawn_timeout_s,
            transport="tcp" if cfg.fleet_tcp else "unix",
            heartbeat_s=cfg.fleet_hb_s,
            heartbeat_timeout_s=cfg.fleet_hb_timeout_s,
            reconnect_budget_s=cfg.fleet_reconnect_s,
            on_all_dead=lambda err: self.begin_drain("engine-failed"),
            registry=self.registry,
        )
        print(f"serving: process fleet of {cfg.fleet_procs} x "
              f"{cfg.slots}-slot {'TCP' if cfg.fleet_tcp else 'UDS'} engine "
              f"workers on {dev} (pids {self.fleet.worker_pids()}), "
              f"affinity {'on' if cfg.fleet_affinity else 'off'}"
              + (f", roles {cfg.fleet_roles}" if roles else
                 ", kv migration on" if cfg.fleet_migrate else "")
              + f", max_queue {cfg.max_queue} per worker", file=sys.stderr)
        self._serve_fleet()

    def _serve_fleet(self):
        """Both fleet modes' tail: the generate seam over fleet.submit,
        and every replica warmed before readiness (the router would warm
        only the replica it picked)."""
        cfg, fleet = self.cfg, self.fleet

        def gen(prompt, max_new, temperature, top_k=None, top_p=None,
                stop_token=None, trace_ctx=None):
            return fleet.submit(
                prompt, max_new, temperature, top_k=top_k, top_p=top_p,
                stop_token=stop_token, timeout=cfg.request_timeout_s,
                trace_ctx=trace_ctx,
            )

        warm_p, warm_n = self._warm_shape()
        for eng in fleet.engines:
            eng.submit(np.zeros((1, warm_p), np.int32), warm_n, 0.0,
                       timeout=None)
        self._generate = gen

    def _load_wave(self, model):
        from .models import generate as G
        from .models import quant_generate as QG

        cfg = self.cfg
        if cfg.quant != "off":
            # Once at load: the int8 tree and its dequantized twin (the
            # prefill model) serve every group.
            self.qparams = QG.quantize_decode_params(model)
            self.deq = QG.dequantize_decode_params(self.qparams, model)

        def run_group(group):
            # One decode for a group sharing (p_bucket, n_bucket); rows
            # carry their own prompt length and sampling.
            p_bucket, n_bucket, adv = group[0]["key"]
            rows = sum(r["rows"] for r in group)
            b_bucket = _bucket(rows, 1)
            padded = np.zeros((b_bucket, p_bucket), np.int32)
            p_lens = np.ones((b_bucket,), np.int64)
            temps = np.zeros((b_bucket,), np.float32)
            # Neutral restrictions for rows that set one of top-k /
            # top-p, and for padding rows.
            tks = np.full((b_bucket,), cfg.vocab, np.int64)
            tps = np.ones((b_bucket,), np.float32)
            at = 0
            for r in group:
                b, p_len = r["prompt"].shape
                padded[at:at + b, :p_len] = r["prompt"]
                p_lens[at:at + b] = p_len
                temps[at:at + b] = r["temp"]
                if r["top_k"] is not None:
                    tks[at:at + b] = r["top_k"]
                if r["top_p"] is not None:
                    tps[at:at + b] = r["top_p"]
                at += b
            if at < b_bucket:
                # Padding rows replay request 0's first row, so every
                # lane decodes in-vocab tokens; sliced away below.
                p0 = group[0]["prompt"]
                padded[at:, :p0.shape[1]] = p0[0]
                p_lens[at:] = p0.shape[1]
            sampling = {"top_k": tks, "top_p": tps} if adv else {}
            gen = torch.Generator(device=model.device)
            gen.manual_seed(int.from_bytes(os.urandom(4), "big"))
            if self.pick_quant(b_bucket):
                toks = QG.generate_prefill_quant(
                    model, padded, p_lens, n_bucket, temps, gen,
                    qparams=self.qparams, deq=self.deq, **sampling)
            else:
                toks = G.generate_prefill(model, padded, p_lens, n_bucket,
                                          temps, gen, **sampling)
            toks = toks.cpu().numpy()  # host lists before a handler wakes
            at = 0
            for r in group:
                r["result"] = toks[at:at + r["rows"], :r["max_new"]]
                at += r["rows"]

        batcher = _Batcher(run_group, self.pick_buckets, cfg.max_gen_batch,
                           cfg.batch_window_ms / 1e3, cfg.request_timeout_s)
        self.batcher = batcher

        def gen(prompt, max_new, temperature, top_k=None, top_p=None,
                stop_token=None, trace_ctx=None):
            # stop_token is presentation only here (the whole bucket
            # decodes); the wave path records no spans.
            del stop_token, trace_ctx
            return batcher.submit(prompt, max_new, temperature,
                                  top_k=top_k, top_p=top_p)

        warm_p, warm_n = self._warm_shape()
        try:
            self.pick_buckets(warm_p, warm_n)
        except ValueError:
            # A warm shape inside the rejection band: warm one that
            # always buckets (2 x grid <= max_seq by construction).
            warm_p = cfg.grid
            warm_n = max(1, min(cfg.grid, cfg.max_seq - warm_p))
        batcher.submit(np.zeros((1, warm_p), np.int32), warm_n, 0.0,
                       timeout=None)
        self._generate = gen

    def _load_classifier(self, dev, model):
        from .models import train as train_mod

        cfg = self.cfg
        if model is None:
            model = train_mod.create_model(cfg.model,
                                           num_classes=cfg.classes,
                                           device=dev)
            model.init_random(torch.Generator().manual_seed(0))
        model.eval()
        self.model = model

        def forward(images):
            # np.array: a writable copy; torch.tensor of the read-only
            # request buffer copies element by element, ~12x slower.
            x = torch.from_numpy(np.array(images, np.float32))
            with torch.inference_mode():
                x = x.to(dev)
                return model(x, train=False).argmax(dim=-1).cpu().numpy()

        # One thread runs every forward, as the engine's scheduler does
        # the LM's: handler threads come and go with their requests.
        self._predict_pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="predict")

        def predict(images):
            return self._predict_pool.submit(forward, images).result()

        predict(np.zeros((cfg.batch, cfg.image_size, cfg.image_size, 3),
                         np.float32))
        self._predict = predict

    def close(self) -> None:
        """Stop the health watch, the supervisor, the engine or the fleet
        (a process fleet's workers exit), the batcher (requests still
        queued fail) and the classifier's thread."""
        if self._health_watch is not None:
            self._health_watch.stop()
            self._health_watch = None
        if self.fleet is not None:
            self.fleet.close()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.engine is not None:
            self.engine.close()
        if self.batcher is not None:
            self.batcher.close()
        if self._predict_pool is not None:
            self._predict_pool.shutdown()

    def make_server(self, host: str = "", port: Optional[int] = None):
        """A Server bound to (host, port; default --port) over this
        app; the caller runs serve_forever."""
        return Server((host, self.cfg.port if port is None else port), self)


class Handler(BaseHTTPRequestHandler):
    """The routes of the module docstring, over `self.server.app`."""

    def _send(self, code, body=b"", ctype=None, headers=()):
        self.send_response(code)
        if ctype:
            self.send_header("Content-Type", ctype)
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        app = self.server.app
        if self.path == "/healthz":
            state = app.server_state()
            if state == "serving":
                self._send(200, b"ok")
                app.count_http("healthz", 200)
            else:
                # Draining reads like loading to a load balancer: take
                # the pod out of rotation; the body says which.
                retry = (() if state == "loading" else
                         (("Retry-After", str(app.cfg.retry_after_s)),))
                self._send(503, state.encode(), headers=retry)
                app.count_http("healthz", 503)
        elif self.path == "/metrics":
            # In every state: the moments around a drain are when an
            # operator needs the numbers.  Exemplars are legal only in
            # OpenMetrics, so only a scraper that asks gets them.
            om = "application/openmetrics-text" in self.headers.get(
                "Accept", "")
            body = app.registry.render(openmetrics=om).encode()
            self._send(200, body, (
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8" if om else
                "text/plain; version=0.0.4; charset=utf-8"))
            app.count_http("metrics", 200)
        elif self.path == "/tracez" and (app.engine is not None
                                         or app.fleet is not None):
            # A fleet serves the router's assembled view: spans from
            # every replica under one trace id, partial traces for a
            # worker lost mid-flight.
            if app.fleet is not None:
                payload = app.fleet.tracez()
            else:
                ring = app.engine.observability.traces
                payload = otel.tracez_payload(ring.traces())
                payload["total"] = ring.total
            self._send(200, json.dumps(payload).encode(), "application/json")
            app.count_http("tracez", 200)
        elif self.path == "/statz" and (app.engine is not None
                                        or app.fleet is not None
                                        or app.batcher is not None):
            # DEPRECATED: the same counters live in /metrics.
            stats = (app.fleet.snapshot() if app.fleet is not None
                     else app.engine.snapshot() if app.engine is not None
                     else dict(app.batcher.stats))
            stats["server_state"] = app.server_state()
            self._send(200, json.dumps(stats).encode(), "application/json",
                       (("Deprecation", "true"),
                        ("Link", '</metrics>; rel="successor-version"')))
            app.count_http("statz", 200)
        else:
            self._send(404)

    def _reject(self, code, message, retry_after=None, route="generate"):
        headers = (() if retry_after is None
                   else (("Retry-After", str(retry_after)),))
        self._send(code, json.dumps({"error": message}).encode(),
                   "application/json", headers)
        self.server.app.count_http(route, code)

    def do_POST(self):
        app = self.server.app
        app.inflight_enter()
        try:
            if self.path == "/generate" and app.ready.is_set() and (
                app._generate is not None
            ):
                self._generate(app)
            else:
                self._predict(app)
        finally:
            app.inflight_exit()

    def _parse_generate(self, cfg, raw):
        """The request's (prompt, max_new, temperature, top_k, top_p,
        stop_token); ValueError (or KeyError, TypeError, OverflowError,
        JSONDecodeError) for a malformed one."""
        req = json.loads(raw)
        prompt = np.asarray(req["prompt"], np.int32)
        max_new = int(req.get("max_new", 16))
        temperature = float(req.get("temperature", 0.0))
        top_k, top_p = req.get("top_k"), req.get("top_p")
        stop_token = req.get("stop_token")
        if top_k is not None:
            top_k = int(top_k)
            if top_k < 1:
                raise ValueError("top_k must be >= 1")
            # >= vocab is the unrestricted sampler; the clamp keeps huge
            # values inside the int row arrays.
            top_k = min(top_k, cfg.vocab)
        if top_p is not None:
            top_p = float(top_p)
            if not 0.0 < top_p <= 1.0:
                raise ValueError("top_p must be in (0, 1]")
        if temperature == 0.0:
            # Greedy ignores the restrictions: dropping them keeps the
            # request in the plain wave group.
            top_k = top_p = None
        if stop_token is not None:
            stop_token = int(stop_token)
            if not 0 <= stop_token < cfg.vocab:
                raise ValueError(f"stop_token must be in [0, {cfg.vocab})")
        if prompt.ndim != 2 or prompt.shape[1] == 0:
            raise ValueError(
                "prompt must be a non-empty rectangular [[int,...]] batch")
        if prompt.shape[0] > cfg.max_gen_batch:
            raise ValueError(
                f"batch {prompt.shape[0]} exceeds the serving cap "
                f"({cfg.max_gen_batch})")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if prompt.shape[1] + max_new > cfg.max_seq:
            raise ValueError(
                f"prompt ({prompt.shape[1]}) + max_new ({max_new}) exceeds "
                f"max_seq ({cfg.max_seq})")
        if cfg.engine == "wave":
            # A tight fit no bucket pair holds; the continuous engine has
            # no pairs (slot == position) and admits it.
            pick_buckets(prompt.shape[1], max_new, cfg.grid, cfg.max_seq)
        if not ((prompt >= 0) & (prompt < cfg.vocab)).all():
            raise ValueError(f"token ids must be in [0, {cfg.vocab})")
        return prompt, max_new, temperature, top_k, top_p, stop_token

    def _generate(self, app):
        length = int(self.headers.get("Content-Length", "0"))
        reasons = app.draining()
        if reasons:
            # Read the body first: a reject with unread data pending can
            # reset the connection before the client sees the 503.
            self.rfile.read(length)
            self._reject(503, f"draining: {reasons}",
                         retry_after=app.cfg.retry_after_s)
            return
        try:
            (prompt, max_new, temperature, top_k, top_p,
             stop_token) = self._parse_generate(app.cfg,
                                                self.rfile.read(length))
        except (ValueError, KeyError, TypeError, OverflowError) as e:
            self._reject(400, str(e))  # JSONDecodeError is a ValueError
            return
        # A server-minted trace id, returned so a client can quote it
        # against /tracez; the wave path records no spans.
        ctx = (otel.TraceContext.new()
               if app.engine is not None or app.fleet is not None else None)
        try:
            rows = app._generate(prompt, max_new, temperature, top_k=top_k,
                                 top_p=top_p, stop_token=stop_token,
                                 trace_ctx=ctx)
            tokens = [[int(t) for t in row] for row in rows]
            if stop_token is not None:
                # Cut each row before its first stop token (the
                # continuous engine already retired the row there).
                tokens = [row[:row.index(stop_token)]
                          if stop_token in row else row for row in tokens]
        except QueueFullError as e:
            # Bounded admission sheds load with a retry hint.
            self._reject(429, str(e)[:500],
                         retry_after=app.cfg.retry_after_s)
            return
        except Exception as e:  # pylint: disable=broad-except
            # An execution failure answers 500, not a dropped connection.
            self._reject(500, str(e)[:500])
            return
        out = {"tokens": tokens}
        if ctx is not None:
            out["trace_id"] = ctx.trace_id
        self._send(200, json.dumps(out).encode(), "application/json")
        app.count_http("generate", 200)

    def _predict(self, app):
        if (self.path != "/predict" or not app.ready.is_set()
                or app._predict is None or app.draining()):
            # Loading and draining are transient: say when to come back.
            self._send(503, headers=(("Retry-After",
                                      str(app.cfg.retry_after_s)),))
            app.count_http({"/predict": "predict",
                            "/generate": "generate"}.get(self.path, "other"),
                           503)
            return
        size = app.cfg.image_size
        raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
        images = np.frombuffer(raw, np.float32).reshape(-1, size, size, 3)
        labels = app._predict(images).tolist()
        self._send(200, json.dumps({"labels": labels}).encode(),
                   "application/json")
        app.count_http("predict", 200)

    def log_message(self, *args):
        pass


class Server(ThreadingHTTPServer):
    """ThreadingHTTPServer over one ServingApp, with a listen backlog
    for bursty load: the stdlib default of 5 resets connections when a
    volley of clients arrives faster than accept() drains it."""

    request_queue_size = 128

    def __init__(self, address, app: ServingApp):
        self.app = app
        super().__init__(address, Handler)


def main(argv=None) -> int:
    import signal

    cfg = parse_args(argv)
    why = cfg.unported()
    if why:
        print(f"serving: {why}", file=sys.stderr)
        return 2
    try:
        resolve_device(cfg.device)
    except RuntimeError as e:
        print(f"serving: {e}", file=sys.stderr)
        return 2
    app = ServingApp(cfg)
    httpd = app.make_server()
    if cfg.port == 0:
        print(f"serving: listening on port {httpd.server_address[1]}",
              file=sys.stderr, flush=True)

    def on_sigterm(signum, frame):
        # Rolling update: drain, finish the work in flight, then stop
        # the accept loop.
        del signum, frame
        print("serving: SIGTERM received, draining", file=sys.stderr)
        threading.Thread(target=app.drain_for_shutdown, args=(httpd,),
                         daemon=True).start()

    def on_sigquit(signum, frame):
        # Post-mortem hook: the flight recorder, serving undisturbed.
        del signum, frame
        print(f"serving: SIGQUIT, state {app.server_state()!r}",
              file=sys.stderr)
        app.dump_flight_recorder("SIGQUIT")

    def load_or_die():
        # A load failure kills the process: a server stuck "loading"
        # looks slow, not broken, to orchestration.
        try:
            app.load_model()
        except BaseException:  # pylint: disable=broad-except
            traceback.print_exc()
            os._exit(1)

    signal.signal(signal.SIGTERM, on_sigterm)
    if hasattr(signal, "SIGQUIT"):
        signal.signal(signal.SIGQUIT, on_sigquit)
    threading.Thread(target=load_or_die, name="load", daemon=True).start()
    httpd.serve_forever()
    httpd.server_close()
    app.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
