"""Worker RPC seam: the SubmitHandle contract over a local socket.

The port's own copy of container_engine_accelerators_tpu/serving/
rpc.py: the same frames, wire codecs, WorkerClient and RemoteEngine.
Three differences: RemoteEngine spawns the port's worker
(`python -m container_engine_accelerators_tpu_torch.serving.worker`),
the codecs map to the port's error classes and observe module, and a
dirty connection loss under reconnect resolves waiters with
ReplicaUnavailable (the reference names an undefined helper there and
falls back to WorkerLost).

The in-process fleet puts N engine replicas behind a router in ONE
Python process: N scheduler threads contend on one interpreter lock,
and one hard crash (OOM, segfault, a wedged runtime — exactly the failures the
source paper's device-plugin/broker split exists to survive) kills
the whole fleet.  This module is the seam that splits them: a
length-prefixed JSON+binary frame protocol carrying the EXISTING
engine submit contract — `submit_nowait` / `wait` / `cancel` /
`cancel_if_queued` / `admitted` map 1:1 onto ops, token streaming
rides the same `on_token` observer seam as framed events — so the
fleet layer (serving/fleet.py) places requests on engine-WORKER
processes (serving/worker.py) exactly the way it places them on
in-process engines.

Layers here (the worker-side server lives in serving/worker.py):

  framing      — `send_frame` / `recv_frame`: u32 JSON length + u32
                 blob length + JSON header + raw bytes.  Partial reads
                 are completed, oversized or malformed frames raise
                 FrameError, and a framing error fails ONE connection,
                 never the worker serving it.
  wire codecs  — exceptions travel as {kind, message} and reconstruct
                 as the SAME types the fleet's re-route contract
                 classifies (QueueFullError, StepFailure,
                 ReplicaUnavailable); metric snapshots travel as JSON
                 and reconstruct as observe.MetricSnapshot so the
                 router relabels them with the unchanged
                 observe.relabel_snapshots (the paper's
                 kubelet-scrapes-plugin shape: each worker keeps a
                 PRIVATE registry; the router's scrape owns labels).
  WorkerClient — one multiplexed connection: request/response ops are
                 sequence-numbered, per-request streams (token / done /
                 fail events) are rid-keyed.  A lost connection fails
                 every outstanding ticket with WorkerLost, AFTER the
                 owner's on_lost hook has published crash state — a
                 waiter that wakes from the failure must already see
                 the replica down (the same ordering discipline as
                 engine._on_crash).
  RemoteEngine — the process-backed replica: spawns the worker
                 (subprocess + handshake + readiness gate), duck-types
                 the slice of ContinuousBatchingEngine the fleet and
                 the supervisor consume (`submit_nowait`, `snapshot`,
                 `crashed`, `dead`, `revive`, `kill`,
                 `attach_supervisor`, `_cv`/`_crashed`/`_closed`/
                 `_crash_error`), so serving/supervisor.py's
                 EngineSupervisor — unchanged — budgets and respawns a
                 dead PROCESS the way it revives a crashed scheduler
                 thread.  One deliberate divergence from
                 engine.revive(): a dead process takes its queue with
                 it, so queued tickets are NOT preserved across
                 respawn — they fail with WorkerLost and re-home
                 through the fleet re-route path instead.

This module stays import-light (stdlib + numpy): the worker binds its
socket and answers the handshake hello before paying the torch-heavy
engine import, and framing tests run without a backend.  Engine/fleet
types resolve lazily inside the codec functions.
"""

from __future__ import annotations

import json
import logging
import os
import random
import select
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .errors import QueueFullError, ReplicaUnavailable, StepFailure

log = logging.getLogger(__name__)

PROTO_VERSION = 1

# Frame ceiling: a router/worker pair moves prompts (KBs) and metric
# scrapes (tens of KB) — anything near this bound is a corrupt or
# hostile length prefix, and rejecting it BEFORE allocating is what
# keeps one garbage connection from OOMing the worker.
MAX_FRAME = 16 << 20

# KV page-migration blobs can exceed one frame: they STREAM as
# a bounded chain of frames (send_frame splits, recv_frame
# reassembles), each individual frame still under MAX_FRAME — the
# reject-before-alloc property holds per frame, and only endpoints
# that opt in (max_stream) accept a reassembled total above it.
BLOB_CHUNK = 4 << 20
MAX_STREAM = 1 << 30

# Above this, a frame's blob is written with its own sendall over a
# memoryview (zero-copy) instead of being concatenated into one
# buffer; below it, one syscall wins (every 1-token frame).
_SMALL_FRAME = 1 << 16

# Shared bucket ladder for the rpc_frame_bytes histograms both
# endpoints may pin (observer hooks below) — powers of four from 64 B
# to the streaming chunk region.
FRAME_SIZE_BUCKETS = [
    64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0,
    262144.0, 1048576.0, 4194304.0, 16777216.0, 67108864.0,
]

_HDR = struct.Struct(">II")


class FrameError(RuntimeError):
    """Malformed traffic on ONE connection (bad length prefix, bad
    JSON, oversized frame, mid-frame EOF).  The connection dies; the
    endpoint serving it does not."""


class ConnectionClosed(RuntimeError):
    """EOF from the peer.  `dirty=False` is a clean hangup (FIN at a
    frame boundary — the peer MEANT to close); `dirty=True` is an
    abortive close (ECONNRESET/EPIPE mid-conversation) — the transport
    failed under the peer, which makes the loss reconnect-eligible
    rather than a deliberate shutdown."""

    def __init__(self, why: str = "peer closed the connection", *,
                 dirty: bool = False):
        super().__init__(why)
        self.dirty = dirty


class IdleTimeout(OSError):
    """No traffic arrived within the socket's poll timeout while
    waiting AT a frame boundary.  Not an error by itself: reader loops
    treat it as the heartbeat tick (send a keepalive, check the
    half-open window); one-shot callers (handshake) treat it as the
    deadline expiring, which the OSError base class gives them for
    free."""


class HandshakeError(RuntimeError):
    """Worker spawn/handshake failed (exited early, boot error, or the
    readiness gate timed out)."""


class WorkerLost(RuntimeError):
    """The worker process (or its connection) went away mid-request —
    the process fleet's replica-loss signal.  Message always carries
    'worker-lost' so chaos tooling can classify collateral honestly."""

    def __init__(self, why: str):
        super().__init__(f"worker-lost: {why}")
        self.why = why


# -- endpoints --------------------------------------------------------------
# A worker endpoint spec is either a filesystem path (Unix socket, the
# default — same-host parity control) or `host:port` (TCP, the
# cross-host transport).  The framing, handshake, and op table are
# identical over both; only socket construction differs.
def parse_endpoint(spec: str):
    """('tcp', (host, port)) for 'host:port', ('unix', path) otherwise.
    A path never parses as TCP: any separator in the spec forces the
    unix reading, and the port must be all digits."""
    host, sep, port = spec.rpartition(":")
    if (sep and host and port.isdigit()
            and "/" not in spec and "\\" not in spec):
        return "tcp", (host, int(port))
    return "unix", spec


def _tune_tcp(sock) -> None:
    # Token frames are tiny and latency-bound: Nagle would batch them
    # behind the previous frame's ACK.  One writev per frame (below)
    # plus TCP_NODELAY is the "small writes, now" discipline.
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def make_client_socket(spec: str, timeout_s: float):
    """A connected socket for `spec` with `timeout_s` already set —
    there is no untimed connect: a SYN-blackholed TCP peer (or a wedged
    UDS listener) fails this call within the timeout instead of
    wedging the caller."""
    kind, addr = parse_endpoint(spec)
    if kind == "tcp":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        sock.settimeout(max(0.1, timeout_s))
        sock.connect(addr)
        if kind == "tcp":
            _tune_tcp(sock)
    except BaseException:
        sock.close()
        raise
    return sock


def make_listener(spec: str, backlog: int = 8, accept_poll_s: float = 1.0):
    """A bound+listening socket for `spec`.  The accept timeout is set
    here so every accept() in the tree is deadline-bounded: accept loops wake at least every
    `accept_poll_s` to notice shutdown."""
    kind, addr = parse_endpoint(spec)
    if kind == "tcp":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        sock.bind(addr)
        sock.listen(backlog)
        sock.settimeout(accept_poll_s)
    except BaseException:
        sock.close()
        raise
    return sock


def free_tcp_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port that was free a moment ago (bind(0) probe).
    Inherently racy against other binders — fine for same-host fleets
    and tests; cross-host deployments pass explicit ports."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.bind((host, 0))
        return sock.getsockname()[1]
    finally:
        sock.close()


# -- framing ----------------------------------------------------------------
def _send_one(sock, payload: bytes, blob, observer=None) -> None:
    """One wire frame.  Large blobs ride a single writev (sendmsg) of
    [header+payload, blob] — the page-migration path never pays a
    concat copy of a multi-MB blob, and the frame leaves in one
    syscall when the kernel buffer has room; small frames keep the
    single-buffer single-syscall path (every 1-token stream frame)."""
    total = _HDR.size + len(payload) + len(blob)
    if total <= _SMALL_FRAME:
        sock.sendall(
            _HDR.pack(len(payload), len(blob)) + payload + bytes(blob)
        )
    else:
        head = _HDR.pack(len(payload), len(blob)) + payload
        mv = memoryview(blob)
        sent = 0
        if hasattr(sock, "sendmsg"):
            sent = sock.sendmsg([head, mv])
        if sent < len(head):
            sock.sendall(head[sent:])
            sock.sendall(mv)
        elif sent < total:
            sock.sendall(mv[sent - len(head):])
    if observer is not None:
        observer(total)


def send_frame(sock, header: dict, blob=b"",
               max_frame: int = MAX_FRAME, observer=None) -> None:
    """One logical frame: 8-byte length prefix (JSON bytes, blob
    bytes), JSON header, raw blob.  Callers serialize sends per socket
    (the client and worker both hold a write lock).  A blob that would
    push the frame past `max_frame` STREAMS instead: the header gains
    xfer_parts/xfer_bytes and the blob travels as a chain of bounded
    chunk frames written back-to-back under the caller's write lock —
    recv_frame reassembles them, and every individual frame stays
    under the bound (large-blob hygiene: no single allocation or
    single write grows with the migration payload).  `observer`, when
    set, sees every wire frame's byte count (the rpc_frame_bytes
    histogram hook)."""
    payload = json.dumps(
        header, separators=(",", ":"), default=str
    ).encode("utf-8")
    if len(payload) + len(blob) <= max_frame:
        _send_one(sock, payload, blob, observer)
        return
    if len(payload) + BLOB_CHUNK > max_frame:
        raise FrameError(
            f"outgoing frame header ({len(payload)} bytes) leaves no "
            f"room for a {BLOB_CHUNK}-byte stream chunk under the "
            f"{max_frame}-byte frame bound"
        )
    mv = memoryview(blob)
    n_parts = -(-len(blob) // BLOB_CHUNK)
    head = dict(header)
    head["xfer_parts"] = n_parts
    head["xfer_bytes"] = len(blob)
    payload = json.dumps(
        head, separators=(",", ":"), default=str
    ).encode("utf-8")
    _send_one(sock, payload, mv[:BLOB_CHUNK], observer)
    for i in range(1, n_parts):
        part = json.dumps(
            {"op": "xfer", "part": i}, separators=(",", ":")
        ).encode("utf-8")
        _send_one(
            sock, part, mv[i * BLOB_CHUNK:(i + 1) * BLOB_CHUNK],
            observer,
        )


def recv_exact(sock, n: int, *, at_boundary: bool = False,
               stall_timeout_s: Optional[float] = None) -> bytes:
    """Read exactly n bytes, absorbing partial reads.

    EOF taxonomy (the fleet's reconnect contract keys off it):
      * empty recv at a frame boundary → ConnectionClosed(dirty=False)
        — the peer finished a frame and hung up on purpose;
      * empty recv mid-frame → FrameError — a protocol violation;
      * ECONNRESET/EPIPE anywhere → ConnectionClosed(dirty=True) — an
        abortive transport failure, NEVER a clean hangup (a reset
        mid-frame used to surface as a raw OSError and could be
        mistaken for graceful close downstream).

    Timeouts: on a socket with a finite timeout, a timeout with zero
    bytes at a boundary raises IdleTimeout (the caller's heartbeat
    tick).  A timeout once bytes have arrived means the peer stalled
    MID-frame — tolerated while `stall_timeout_s` budget remains
    (slow links dribble legitimately), then a FrameError: a slow-loris
    peer costs one connection, bounded."""
    buf = bytearray()
    deadline = (None if stall_timeout_s is None
                else time.monotonic() + stall_timeout_s)
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if at_boundary and not buf:
                raise IdleTimeout(
                    "no traffic within the socket timeout"
                ) from None
            if deadline is not None and time.monotonic() < deadline:
                continue
            raise FrameError(
                f"peer stalled mid-frame ({len(buf)}/{n} bytes)"
            ) from None
        except (ConnectionResetError, BrokenPipeError) as e:
            raise ConnectionClosed(
                f"connection reset by peer ({len(buf)}/{n} bytes): "
                f"{e!r}", dirty=True,
            ) from None
        if not chunk:
            if at_boundary and not buf:
                raise ConnectionClosed("peer closed the connection")
            raise FrameError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf += chunk
    return bytes(buf)


def _recv_one(sock, max_frame: int, observer=None,
              stall_timeout_s: Optional[float] = None):
    jlen, blen = _HDR.unpack(recv_exact(
        sock, _HDR.size, at_boundary=True,
        stall_timeout_s=stall_timeout_s,
    ))
    if jlen + blen > max_frame:
        raise FrameError(
            f"incoming frame ({jlen} + {blen} bytes) exceeds the "
            f"{max_frame}-byte frame bound (garbage length prefix?)"
        )
    payload = recv_exact(sock, jlen, stall_timeout_s=stall_timeout_s)
    blob = (recv_exact(sock, blen, stall_timeout_s=stall_timeout_s)
            if blen else b"")
    try:
        header = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"frame header is not JSON: {e}") from None
    if not isinstance(header, dict) or "op" not in header:
        raise FrameError("frame header must be an object with an 'op'")
    if observer is not None:
        observer(_HDR.size + jlen + blen)
    return header, blob


def recv_frame(sock, max_frame: int = MAX_FRAME, observer=None,
               max_stream: Optional[int] = None,
               stall_timeout_s: Optional[float] = None):
    """(header dict, blob bytes) for the next logical frame.  Raises
    ConnectionClosed on clean EOF, FrameError on garbage — the caller
    closes THIS connection and keeps serving the rest.  A streamed
    blob (send_frame's xfer_parts chain) is reassembled here, bounded
    by `max_stream` — endpoints that do not opt in (max_stream None)
    reject any stream past one frame's bound, so a garbage prefix can
    never claim a reassembly buffer the endpoint did not size for."""
    header, blob = _recv_one(sock, max_frame, observer,
                             stall_timeout_s)
    if "xfer_parts" not in header:
        return header, blob
    try:
        n_parts = int(header.pop("xfer_parts"))
        total = int(header.pop("xfer_bytes"))
    except (KeyError, TypeError, ValueError):
        raise FrameError("malformed stream header") from None
    bound = max_frame if max_stream is None else max_stream
    if not 2 <= n_parts <= 1 << 20 or not 0 < total <= bound:
        raise FrameError(
            f"stream of {n_parts} parts / {total} bytes exceeds this "
            f"endpoint's {bound}-byte stream bound"
        )
    buf = bytearray(blob)
    for i in range(1, n_parts):
        h2, b2 = _recv_one(sock, max_frame, observer, stall_timeout_s)
        if h2.get("op") != "xfer" or int(h2.get("part", -1)) != i:
            raise FrameError(
                f"stream chunk {i}/{n_parts} missing (got "
                f"{h2.get('op')!r})"
            )
        buf += b2
        if len(buf) > total:
            raise FrameError("stream overran its declared size")
    if len(buf) != total:
        raise FrameError(
            f"stream delivered {len(buf)} of {total} declared bytes"
        )
    return header, bytes(buf)


# -- wire codecs ------------------------------------------------------------
# The exception wire-contract: these six types + ValueError are EXACTLY what a raise
# reachable from the public fleet surfaces may resolve to.  Anything
# else degrades to kind="runtime" on the far side — an opaque
# StepFailure-shaped error the router can neither re-route on
# (replica_unavailable / worker_lost) nor shed on (queue_full).
def exc_to_wire(e: BaseException) -> dict:
    """{kind, message, ...} for an exception, preserving the types the
    fleet's re-route/backpressure contract dispatches on."""
    d = {"message": str(e)}
    if isinstance(e, QueueFullError):
        d["kind"] = "queue_full"
    elif isinstance(e, StepFailure):
        d["kind"] = "step_failure"
    elif isinstance(e, WorkerLost):
        d["kind"] = "worker_lost"
        d["message"] = e.why
    elif isinstance(e, ReplicaUnavailable):
        d["kind"] = "replica_unavailable"
        d["replica"] = getattr(e, "replica", -1)
        d["why"] = getattr(e, "why", str(e))
    elif isinstance(e, FrameError):
        d["kind"] = "frame"
    elif isinstance(e, IdleTimeout):
        d["kind"] = "idle_timeout"
    elif isinstance(e, ValueError):
        d["kind"] = "value"
    else:
        d["kind"] = "runtime"
    return d


def exc_from_wire(d: dict) -> BaseException:
    kind = d.get("kind", "runtime")
    msg = str(d.get("message", ""))
    if kind == "queue_full":
        return QueueFullError(msg)
    if kind == "step_failure":
        return StepFailure(msg)
    if kind == "worker_lost":
        return WorkerLost(msg)
    if kind == "replica_unavailable":
        return ReplicaUnavailable(
            int(d.get("replica", -1)), str(d.get("why", msg))
        )
    if kind == "frame":
        return FrameError(msg)
    if kind == "idle_timeout":
        return IdleTimeout(msg)
    if kind == "value":
        return ValueError(msg)
    return RuntimeError(msg)


class _WireHistSample:
    """Histogram sample state reconstructed from the wire: the
    counts/sum/count/exemplars shape observe.Registry.render reads.
    Exemplars CROSS the process boundary: the worker's
    trace ids are the router's trace ids (the submit frame propagates
    the context), so the relabelled fleet /metrics serves OpenMetrics
    exemplars whose trace_id links into the router's assembled
    /tracez."""

    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, counts, total, count, exemplars=None):
        self.counts = counts
        self.sum = total
        self.count = count
        # bucket index -> (trace_id, value, unix_ts), the
        # observe._HistSample shape render() consumes.
        self.exemplars: dict = exemplars or {}


def snapshots_to_wire(snaps) -> list:
    """JSON-able form of observe.MetricSnapshot list (the worker's
    private-registry scrape), exemplars included."""
    out = []
    for s in snaps:
        if s.mtype == "histogram":
            samples = []
            for labels, st in s.samples:
                w = {"counts": [int(c) for c in st.counts],
                     "sum": float(st.sum), "count": int(st.count)}
                ex = getattr(st, "exemplars", None)
                if ex:
                    # JSON object keys are strings; the bucket index
                    # round-trips through str().
                    w["exemplars"] = {
                        str(i): [str(tid), float(v), float(ts)]
                        for i, (tid, v, ts) in ex.items()
                    }
                samples.append([labels, w])
        else:
            samples = [
                [labels, float(v)] for labels, v in s.samples
            ]
        out.append({
            "name": s.name, "type": s.mtype, "help": s.help,
            "bounds": (
                None if s.bounds is None
                else [float(b) for b in s.bounds]
            ),
            "samples": samples,
        })
    return out


def _exemplars_from_wire(w: dict) -> dict:
    try:
        return {
            int(i): (str(tid), float(v), float(ts))
            for i, (tid, v, ts) in (w.get("exemplars") or {}).items()
        }
    except (TypeError, ValueError):
        # Malformed exemplars lose only the links, never the scrape.
        return {}


def snapshots_from_wire(wire) -> list:
    from . import observe as observe_mod  # stdlib-only module

    out = []
    for w in wire:
        if w["type"] == "histogram":
            samples = [
                (labels,
                 _WireHistSample(st["counts"], st["sum"], st["count"],
                                 _exemplars_from_wire(st)))
                for labels, st in w["samples"]
            ]
        else:
            samples = [(labels, v) for labels, v in w["samples"]]
        out.append(observe_mod.MetricSnapshot(
            w["name"], w["type"], w["help"], samples,
            bounds=w.get("bounds"),
        ))
    return out


# -- client -----------------------------------------------------------------
class _Reply:
    __slots__ = ("event", "header", "err", "blob")

    def __init__(self):
        self.event = threading.Event()
        self.header: Optional[dict] = None
        self.err: Optional[dict] = None
        self.blob: bytes = b""


class _RemoteTicket:
    """Client-side mirror of one submitted request: resolved by the
    reader thread (done / fail frame, or connection loss).  delivered
    counts streamed tokens — the admitted-after-resolution fallback
    reads it (a request that streamed was admitted).  spans carries
    the worker's sealed span dicts off the terminal frame:
    best-effort — a worker that died mid-flight resolves with no
    spans, and the router stitches a partial trace instead."""

    __slots__ = (
        "rid", "rows", "on_token", "delivered", "event", "results",
        "error", "spans",
    )

    def __init__(self, rid: int, rows: int, on_token):
        self.rid = rid
        self.rows = rows
        self.on_token = on_token
        self.delivered = 0
        self.event = threading.Event()
        self.results: Optional[List[list]] = None
        self.error: Optional[BaseException] = None
        self.spans: list = []


class RemoteSubmitHandle:
    """engine.SubmitHandle over the wire: same surface
    (wait/cancel/cancel_if_queued/admitted/error/rows), resolution
    driven by the worker's frames.  cancel_if_queued keeps its
    atomicity guarantee because the decision runs WORKER-side under
    the engine lock — this side only transports the verdict — and a
    yank's exact exception (ReplicaUnavailable and all) round-trips
    through the wire codec, so fleet waiters re-route on the same
    types in both fleet modes."""

    __slots__ = ("_client", "_t")

    def __init__(self, client: "WorkerClient", ticket: _RemoteTicket):
        self._client = client
        self._t = ticket

    @property
    def rows(self) -> int:
        return self._t.rows

    @property
    def error(self) -> Optional[BaseException]:
        return self._t.error

    @property
    def spans(self) -> list:
        """Span dicts the worker shipped on the terminal frame
        (empty until resolution, and after a worker loss) — the
        fleet's trace-assembly input."""
        return self._t.spans

    @property
    def admitted(self) -> bool:
        # Engine contract: admitted latches True once any row reaches
        # a slot and STAYS true after completion.  The worker pops its
        # handle at resolution, so a resolved ticket answers locally:
        # completed (or streamed) => it was admitted.
        t = self._t
        if t.event.is_set():
            return t.results is not None or t.delivered > 0
        try:
            return bool(self._client.call(
                "admitted", rid=t.rid, timeout=10.0,
            ).get("admitted", False))
        except Exception:  # pylint: disable=broad-except
            # Worker gone: nothing is in flight there any more; the
            # ticket resolves via the connection-loss path.
            return t.delivered > 0

    def cancel(self, err: Optional[BaseException] = None) -> None:
        err = err or RuntimeError("request cancelled")
        try:
            self._client.call(
                "cancel", rid=self._t.rid, err=exc_to_wire(err),
                timeout=10.0,
            )
        except Exception:  # pylint: disable=broad-except
            # Connection loss resolves the ticket with WorkerLost;
            # a wedged worker resolves it at the client's close.
            pass

    def cancel_if_queued(
        self, err: Optional[BaseException] = None
    ) -> bool:
        if self._t.event.is_set():
            return False
        err = err or RuntimeError("request cancelled")
        try:
            ok = bool(self._client.call(
                "cancel_if_queued", rid=self._t.rid,
                err=exc_to_wire(err), timeout=10.0,
            ).get("ok", False))
        except Exception:  # pylint: disable=broad-except
            return False
        return ok

    def wait(self, timeout: Optional[float] = None) -> List[list]:
        t = self._t
        if not t.event.wait(timeout=timeout):
            self.cancel(RuntimeError("generation timed out"))
            raise RuntimeError(
                f"generation timed out after {timeout:.0f}s"
            )
        if t.error is not None:
            raise t.error
        return t.results


class WorkerClient:
    """One multiplexed connection to a worker (module docstring).

    Threading: sends ride `_wlock` (frame writes are atomic), shared
    maps ride `_lock`, and ONE reader thread owns dispatch.  on_token
    observers run on the reader thread — the engine contract already
    says observers must be cheap and contained, and the worker stamps
    frames in commit order, so a stream's tokens arrive in order."""

    def __init__(self, sock, *, on_lost: Optional[Callable] = None,
                 max_frame: int = MAX_FRAME, label: str = "",
                 on_frame: Optional[Callable[[int], None]] = None,
                 heartbeat_s: float = 5.0,
                 heartbeat_timeout_s: float = 15.0,
                 io_timeout_s: float = 30.0,
                 lost_error: Optional[Callable] = None):
        self._sock = sock
        self._max_frame = max_frame
        self._label = label or "worker"
        self._on_lost = on_lost
        self._on_frame = on_frame
        # Deadline discipline: every socket op on this connection is
        # timed.  io_timeout_s bounds a single send and the mid-frame
        # stall budget; heartbeat_s/heartbeat_timeout_s bound how long
        # a HALF-OPEN connection (peer host died — no FIN ever
        # arrives) can look alive: we send "hb" when idle and declare
        # the connection dirty-lost once nothing has arrived for the
        # heartbeat window.
        self._hb_s = float(heartbeat_s)
        self._hb_timeout_s = float(heartbeat_timeout_s)
        self._io_timeout_s = float(io_timeout_s)
        self._lost_error = lost_error
        sock.settimeout(self._io_timeout_s)
        now = time.monotonic()
        self._last_rx = now   # reader-thread heartbeat bookkeeping
        self._last_tx = now   # benign float race: monotonic stamps
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: Dict[int, _Reply] = {}  # guarded-by: _lock
        self._tickets: Dict[int, _RemoteTicket] = {}  # guarded-by: _lock
        self._next_seq = 0  # guarded-by: _lock
        self._next_rid = 0  # guarded-by: _lock
        self._lost_why: Optional[str] = None  # guarded-by: _lock
        self._lost_dirty = False  # guarded-by: _lock
        self._snap: Optional[dict] = None  # guarded-by: _lock
        self._snap_t = 0.0  # guarded-by: _lock
        self._flight_tail: list = []  # guarded-by: _lock
        self._on_token_logged = False
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"rpc-client-{self._label}", daemon=True,
        )
        self._reader.start()

    # -- plumbing --------------------------------------------------------
    def _send(self, header: dict, blob: bytes = b"") -> None:
        try:
            with self._wlock:
                send_frame(self._sock, header, blob, self._max_frame,
                           observer=self._on_frame)
                self._last_tx = time.monotonic()
        except (OSError, FrameError) as e:
            self._connection_lost(f"send failed: {e!r}", dirty=True)
            raise WorkerLost(f"{self._label} send failed: {e!r}")

    # wire-public
    def call(self, op: str, timeout: float = 60.0,
             _blob: bytes = b"", **fields) -> dict:
        """One request/response op.  Raises the reconstructed worker
        exception, WorkerLost on a dead connection, or RuntimeError on
        timeout (the worker may be wedged; the supervisor layer owns
        that diagnosis)."""
        return self.call_blob(op, timeout=timeout, _blob=_blob,
                              **fields)[0]

    # wire-public
    def call_blob(self, op: str, timeout: float = 60.0,
                  _blob: bytes = b"", **fields):
        """call() that also returns the reply's binary payload —
        the page-migration ops move their KV bytes here."""
        r = _Reply()
        with self._lock:
            if self._lost_why is not None:
                raise WorkerLost(self._lost_why)
            seq = self._next_seq
            self._next_seq += 1
            self._pending[seq] = r
        try:
            self._send({"op": op, "seq": seq, **fields}, _blob)
        except BaseException:
            with self._lock:
                self._pending.pop(seq, None)
            raise
        if not r.event.wait(timeout=timeout):
            with self._lock:
                self._pending.pop(seq, None)
            # A local deadline, never serialized: the supervisor layer
            # owns the wedged-worker diagnosis.
            raise RuntimeError(
                f"worker rpc {op!r} timed out after {timeout:.0f}s"
            )
        if r.err is not None:
            raise exc_from_wire(r.err)
        return r.header or {}, r.blob

    def _read_loop(self) -> None:
        # select() is the idle tick: the socket's own timeout
        # (io_timeout_s) stays long enough for bulk frames, while the
        # poll interval wakes this thread often enough to send
        # heartbeats and to notice a half-open peer within
        # heartbeat_timeout_s.
        poll_s = (min(1.0, self._hb_s / 4.0) if self._hb_s > 0
                  else self._io_timeout_s)
        while True:
            try:
                ready = select.select([self._sock], [], [], poll_s)[0]
            except (OSError, ValueError):
                # Socket closed under us (close()): clean shutdown.
                self._connection_lost("connection closed")
                return
            if not ready:
                now = time.monotonic()
                idle_rx = now - self._last_rx
                if self._hb_s > 0 and idle_rx > self._hb_timeout_s:
                    self._connection_lost(
                        f"heartbeat timeout: no traffic for "
                        f"{idle_rx:.1f}s (half-open connection?)",
                        dirty=True,
                    )
                    return
                if self._hb_s > 0 and now - self._last_tx >= self._hb_s:
                    try:
                        self._send({"op": "hb"})
                    except WorkerLost:
                        return  # _send already published the loss
                continue
            try:
                header, blob = recv_frame(
                    self._sock, self._max_frame,
                    observer=self._on_frame, max_stream=MAX_STREAM,
                    stall_timeout_s=self._io_timeout_s,
                )
            except IdleTimeout:
                continue
            except ConnectionClosed as e:
                if e.dirty:
                    self._connection_lost(str(e), dirty=True)
                else:
                    self._connection_lost(
                        "worker closed the connection"
                    )
                return
            except (OSError, FrameError) as e:
                self._connection_lost(f"read failed: {e!r}",
                                      dirty=True)
                return
            self._last_rx = time.monotonic()
            try:
                self._dispatch(header, blob)
            except Exception:  # pylint: disable=broad-except
                log.exception(
                    "%s: dispatch failed for %r", self._label,
                    header.get("op"),
                )

    def _dispatch(self, header: dict, blob: bytes) -> None:
        op = header.get("op")
        if op == "hb":
            return  # keepalive: receipt alone refreshed the window
        if op == "reply":
            with self._lock:
                r = self._pending.pop(int(header["seq"]), None)
            if r is not None:
                r.err = header.get("err")
                r.header = header
                r.blob = blob
                r.event.set()
            return
        if op == "token":
            with self._lock:
                t = self._tickets.get(int(header["rid"]))
            if t is None:
                return  # resolved/cancelled: late token, drop
            t.delivered += 1
            if t.on_token is not None:
                try:
                    t.on_token(int(header["row"]), int(header["tok"]))
                except Exception:  # pylint: disable=broad-except
                    if not self._on_token_logged:
                        self._on_token_logged = True
                        log.exception(
                            "%s: on_token observer failed "
                            "(logged once)", self._label,
                        )
            return
        if op in ("done", "fail"):
            with self._lock:
                t = self._tickets.pop(int(header["rid"]), None)
            if t is None:
                return
            spans = header.get("spans")
            if isinstance(spans, list):
                t.spans = spans
            if op == "done":
                t.results = [
                    [int(x) for x in row]
                    for row in header.get("results", [])
                ]
            else:
                t.error = exc_from_wire(header.get("err", {}))
            t.event.set()
            return
        log.warning("%s: unknown frame op %r dropped", self._label, op)

    def _connection_lost(self, why: str, dirty: bool = False) -> None:
        with self._lock:
            if self._lost_why is not None:
                return
            self._lost_why = why
            self._lost_dirty = dirty
            pending = list(self._pending.values())
            self._pending.clear()
            tickets = list(self._tickets.values())
            self._tickets.clear()
        # Owner hook FIRST: a fleet waiter woken by the ticket failure
        # below must already observe the replica down (the same
        # publish-before-wake ordering as engine._on_crash).
        if self._on_lost is not None:
            try:
                self._on_lost(why)
            except Exception:  # pylint: disable=broad-except
                log.exception("%s: on_lost hook failed", self._label)
        exc = self._loss_exception(why, dirty)
        err = exc_to_wire(exc)
        for r in pending:
            r.err = err
            r.event.set()
        for t in tickets:
            t.error = exc
            t.event.set()

    def _loss_exception(self, why: str, dirty: bool) -> BaseException:
        # The owner (RemoteEngine) chooses what a lost connection means
        # to waiters: WorkerLost when the worker is gone for good,
        # ReplicaUnavailable while a transient network loss is being
        # reconnected — both re-home through the fleet re-route path,
        # but only the former implies a respawn.
        if self._lost_error is not None:
            try:
                exc = self._lost_error(why, dirty)
                if isinstance(exc, BaseException):
                    return exc
            except Exception:  # pylint: disable=broad-except
                log.exception("%s: lost_error hook failed", self._label)
        return WorkerLost(why)

    def fail_all(self, err: BaseException) -> None:
        """Resolve every outstanding request with `err` (terminal
        kill path: the owner already knows the worker is gone)."""
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
            tickets = list(self._tickets.values())
            self._tickets.clear()
        wire = exc_to_wire(err)
        for r in pending:
            r.err = wire
            r.event.set()
        for t in tickets:
            t.error = err
            t.event.set()

    @property
    def lost(self) -> Optional[str]:
        with self._lock:
            return self._lost_why

    @property
    def lost_dirty(self) -> bool:
        """True when the loss was abortive (reset / heartbeat timeout /
        mid-frame garbage) rather than a deliberate hangup — the
        reconnect-eligibility signal."""
        with self._lock:
            return self._lost_dirty

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    # -- engine-shaped surface -------------------------------------------
    # wire-public
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
    ) -> RemoteSubmitHandle:
        """engine.submit_nowait over the wire: the prompt travels as a
        binary int32 blob, validation/admission errors come back as
        their real types (ValueError / QueueFullError) synchronously,
        and the returned handle resolves off the frame stream.
        `trace_ctx` rides the submit header as one traceparent-style
        string; the worker opens its trace under that identity and
        ships the sealed spans back on the terminal frame."""
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
        if prompt.ndim == 1:
            prompt = prompt[None]
        if prompt.ndim != 2:
            raise ValueError(
                "prompt must be a non-empty (rows, p_len) int batch"
            )
        rows, plen = prompt.shape
        with self._lock:
            if self._lost_why is not None:
                raise WorkerLost(self._lost_why)
            rid = self._next_rid
            self._next_rid += 1
            t = _RemoteTicket(rid, rows, on_token)
            self._tickets[rid] = t
        try:
            self.call(
                "submit", rid=rid, rows=rows, plen=plen,
                max_new=int(max_new), temperature=float(temperature),
                top_k=top_k, top_p=top_p, stop_token=stop_token,
                stream=on_token is not None,
                trace=(
                    trace_ctx.to_wire() if trace_ctx is not None
                    else None
                ),
                _blob=prompt.tobytes(), timeout=60.0,
            )
        except BaseException as e:
            with self._lock:
                self._tickets.pop(rid, None)
            # A TIMED-OUT submit may have reached a wedged worker that
            # admits it later: best-effort withdraw (frames are
            # ordered, so the cancel lands after the submit) so no
            # worker burns slots on a request nobody owns.  seq=-1:
            # any reply is dropped.  Worker-rejected submits
            # (QueueFullError/ValueError) get a harmless no-op cancel.
            if not isinstance(e, WorkerLost):
                try:
                    self._send({
                        "op": "cancel", "seq": -1, "rid": rid,
                        "err": exc_to_wire(RuntimeError(
                            "submit withdrawn (rpc failed client-side)"
                        )),
                    })
                except Exception:  # pylint: disable=broad-except
                    pass
            raise
        return RemoteSubmitHandle(self, t)

    def ping(self, timeout: float = 10.0) -> bool:
        """Liveness round trip (the worker answers off its reader
        thread even while the engine is busy) — the probe surface
        RTT measurements and health checks use.  Returns True when
        the reply arrives and NEVER False: the failure mode is the
        exception (WorkerLost / timeout), like every other op — so
        guard with try/except, not a truthiness check."""
        self.call("ping", timeout=timeout)
        return True

    # wire-public
    def snapshot(self, max_age_s: float = 0.0) -> dict:
        """Worker engine.snapshot() with an optional freshness bound:
        placement scoring tolerates `max_age_s` staleness so the
        router does not pay one RPC round trip per eligible replica
        per placement (the stats are advisory, never correctness).
        The reply piggybacks a bounded flight-recorder tail
        (`last_flight`), refreshed at the placement cadence — the
        cache the router dumps when this worker is declared lost, so
        a kill -9'd worker's final story survives in the ROUTER."""
        now = time.monotonic()
        with self._lock:
            if (
                self._snap is not None
                and max_age_s > 0
                and now - self._snap_t < max_age_s
            ):
                return self._snap
        hdr = self.call("snapshot", timeout=15.0)
        snap = hdr.get("snapshot", {})
        flight = hdr.get("flight")
        with self._lock:
            self._snap = snap
            self._snap_t = time.monotonic()
            if isinstance(flight, list) and flight:
                self._flight_tail = flight
        return snap

    @property
    def last_flight(self) -> list:
        """The last piggybacked flight-recorder tail (possibly
        empty): as fresh as the last snapshot scrape by design."""
        with self._lock:
            return list(self._flight_tail)

    def metrics_snapshots(self) -> list:
        """Scrape the worker's PRIVATE registry (module docstring):
        reconstructed MetricSnapshots, ready for
        observe.relabel_snapshots(engine=<i>) router-side."""
        wire = self.call("metrics", timeout=15.0).get("metrics", [])
        return snapshots_from_wire(wire)

    # -- KV page migration (engine.export/adopt_prefix_pages) ------------
    # wire-public
    def export_prefix_pages(self, tokens, move: bool = False,
                            timeout_s: float = 30.0):
        """engine.export_prefix_pages over the wire: tokens travel as
        an int32 blob, the pages come back as the reply's (possibly
        streamed) blob.  None when the worker's trie holds no full
        page of this prefix."""
        toks = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1)
        )
        hdr, blob = self.call_blob(
            "export_pages", move=bool(move),
            job_timeout_s=float(timeout_s),
            timeout=float(timeout_s) + 15.0, _blob=toks.tobytes(),
        )
        meta = hdr.get("meta")
        if not meta:
            return None
        return meta, blob

    # wire-public
    def adopt_prefix_pages(self, tokens, meta: dict, blob: bytes,
                           timeout_s: float = 30.0) -> int:
        """engine.adopt_prefix_pages over the wire: one packed blob —
        u32 token count + int32 tokens + raw pages."""
        toks = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1)
        )
        packed = (
            struct.pack(">I", toks.size) + toks.tobytes() + blob
        )
        return int(self.call(
            "adopt_pages", meta=meta,
            job_timeout_s=float(timeout_s),
            timeout=float(timeout_s) + 15.0, _blob=packed,
        ).get("adopted", 0))

    def tier_probe(self, tokens) -> dict:
        """engine.tier_probe over the wire: where the worker holds
        this prefix (HBM trie / host-RAM tier / disk spill) — index
        walks only, answered inline on the worker's reader thread."""
        toks = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1)
        )
        return dict(self.call(
            "tier_probe", _blob=toks.tobytes(),
        ).get("probe") or {})

    def promote_prefix_pages(self, tokens,
                             timeout_s: float = 30.0) -> int:
        """engine.promote_prefix_pages over the wire: raise the
        prefix's tier-resident pages into the worker's HBM trie (the
        fleet's pre-migration side-job).  Returns pages promoted."""
        toks = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1)
        )
        return int(self.call(
            "promote_tier", job_timeout_s=float(timeout_s),
            timeout=float(timeout_s) + 15.0, _blob=toks.tobytes(),
        ).get("promoted", 0))


# -- the process-backed replica ---------------------------------------------
def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    ))


def _reap(proc, *, kill: bool = False, timeout: float = 10.0) -> None:
    """Terminate (optionally SIGKILL) and ALWAYS wait() the child:
    every exit path reaps, so a process fleet never leaks zombies."""
    if proc is None:
        return
    if kill and proc.poll() is None:
        try:
            proc.kill()
        except OSError:
            pass
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        try:
            proc.kill()
        except OSError:
            pass
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            log.error("worker pid %s would not die", proc.pid)


# state-machine: connection field: state states: booting,live,reconnecting,crashed,reviving,dead,closed terminal: dead,closed
class RemoteEngine:
    """One engine-worker process behind the engine duck-type (module
    docstring).

    `state` is the declared `connection` lifecycle machine:
    booting -> live at handshake, live <-> reconnecting across
    transient TCP loss, -> crashed when _declare_crash publishes,
    crashed -> reviving -> live across a respawn, with dead (kill)
    and closed (drain) terminal.  It is a REPORTING surface — the
    supervisor protocol's events/flags stay the source of truth —
    but every write is guarded so the terminals are never exited.  The spawn recipe (factory spec + engine kwargs) is
    owned here so revive() can rebuild the worker from scratch:
    spawn -> connect -> hello/ready readiness gate, all bounded by
    `spawn_timeout_s` — a worker whose handshake never completes is
    killed and reported, never waited on forever.

    The supervisor contract is the engine's own (serving/supervisor.py
    drives `_crashed`/`_cv`/`revive`/`kill` identically for both), so
    restart budgets, backoff, and give-up -> fleet eviction all apply
    to process death unchanged."""

    def __init__(
        self,
        factory: str,
        factory_kw: Optional[dict],
        n_slots: int,
        *,
        engine_kw: Optional[dict] = None,
        socket_path: str,
        connect_to: Optional[str] = None,
        idx: int = 0,
        worker_max_restarts: int = 3,
        spawn_timeout_s: float = 180.0,
        drain_timeout_s: float = 10.0,
        stats_ttl_s: float = 0.05,
        python: Optional[str] = None,
        env: Optional[dict] = None,
        max_frame: int = MAX_FRAME,
        on_frame: Optional[Callable[[int], None]] = None,
        heartbeat_s: float = 5.0,
        heartbeat_timeout_s: float = 15.0,
        io_timeout_s: float = 30.0,
        reconnect_budget_s: float = 10.0,
        reconnect_backoff_s: float = 0.1,
        reconnect_backoff_cap_s: float = 2.0,
        on_net: Optional[Callable[[str, str], None]] = None,
    ):
        self.idx = int(idx)
        self.n_slots = int(n_slots)
        self._factory = factory
        self._factory_kw = dict(factory_kw or {})
        self._engine_kw = dict(engine_kw or {})
        # `socket_path` is the worker's BIND endpoint spec (a UDS path
        # or host:port — rpc.parse_endpoint); `connect_to` is where
        # the router dials, defaulting to the bind spec.  They differ
        # when a proxy (faults.NetemProxy, a real load balancer) sits
        # on the path.
        self._socket_path = socket_path
        self._connect_to = connect_to or socket_path
        self._ep_kind = parse_endpoint(socket_path)[0]
        self._worker_max_restarts = int(worker_max_restarts)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._stats_ttl_s = float(stats_ttl_s)
        self._python = python or sys.executable
        self._env_extra = dict(env or {})
        self._max_frame = int(max_frame)
        self._on_frame = on_frame
        self._heartbeat_s = float(heartbeat_s)
        self._heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._io_timeout_s = float(io_timeout_s)
        # Transient-loss policy: a DIRTY connection loss with the
        # process still alive enters a reconnect loop (capped
        # exponential backoff + jitter) bounded by reconnect_budget_s;
        # only when the budget exhausts (or the process actually
        # exits) does the loss become a crash → supervisor respawn.
        # 0 disables: every loss is a crash (the pre-TCP behavior).
        self._reconnect_budget_s = float(reconnect_budget_s)
        self._reconnect_backoff_s = float(reconnect_backoff_s)
        self._reconnect_backoff_cap_s = float(reconnect_backoff_cap_s)
        self._on_net = on_net
        # Supervisor protocol state: same names, same lock shape as
        # ContinuousBatchingEngine (the supervisor reads them under
        # _cv); _cv's default lock is reentrant, like the engine's.
        self._cv = threading.Condition()
        self.state = "booting"  # guarded-by: _cv
        self._crashed = threading.Event()
        self._crash_error: Optional[BaseException] = None  # guarded-by: _cv
        self._closed = False  # guarded-by: _cv
        self._dead: Optional[BaseException] = None  # guarded-by: _cv
        self._supervisor = None  # guarded-by: _cv
        self._client: Optional[WorkerClient] = None  # guarded-by: _cv
        self._proc = None  # guarded-by: _cv
        # The last handshake's {"device", "device_bytes"} (worker.py
        # _device_report): where the worker's engine lives.
        self.device_report: dict = {}
        self._proc_restarts = 0  # guarded-by: _cv
        self._reconnecting = False  # guarded-by: _cv
        self._last_snap: Optional[dict] = None  # guarded-by: _cv
        # The lost worker's cached flight-recorder tail: the client piggybacks a bounded tail on every
        # snapshot scrape; when the worker is declared lost, the last
        # scraped tail is latched here, dumped to the router's log,
        # and served on snapshot() — the victim's final story
        # survives in the ROUTER even though SIGKILL gave the worker
        # no chance to dump its own.
        self._lost_flight: list = []  # guarded-by: _cv

    # -- spawn / handshake ----------------------------------------------
    def _argv(self) -> list:
        return [
            self._python, "-m",
            "container_engine_accelerators_tpu_torch.serving.worker",
            "--socket", self._socket_path,
            "--factory", self._factory,
            "--factory-json", json.dumps(self._factory_kw),
            "--slots", str(self.n_slots),
            "--engine-json", json.dumps(self._engine_kw),
            "--replica", str(self.idx),
            "--max-restarts", str(self._worker_max_restarts),
            # One drain budget, both sides: the worker must not
            # believe it has longer to drain than the parent's
            # _reap() will actually allow before SIGKILL.
            "--drain-timeout-s", str(self._drain_timeout_s),
            # Orphan watchdog: a worker whose ROUTER dies ungracefully
            # (SIGKILL skips close()) drains itself instead of
            # serving a socket nobody owns forever.
            "--parent-pid", str(os.getpid()),
            # One heartbeat/deadline discipline, both sides: the
            # worker must give up on a half-open ROUTER within the
            # same window the router gives up on a half-open worker.
            "--hb-s", str(self._heartbeat_s),
            "--hb-timeout-s", str(self._heartbeat_timeout_s),
            "--io-timeout-s", str(self._io_timeout_s),
        ]

    def launch(self) -> None:
        """Start the worker process (no handshake yet — a fleet
        launches every worker first so their imports and model builds
        overlap, then gates readiness one by one)."""
        if self._ep_kind == "unix":
            try:
                os.unlink(self._socket_path)
            except OSError:
                pass
        env = dict(os.environ)
        pp = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = _repo_root() + (
            os.pathsep + pp if pp else ""
        )
        env.update(self._env_extra)
        proc = subprocess.Popen(self._argv(), env=env)
        with self._cv:
            self._proc = proc
        threading.Thread(
            target=self._monitor, args=(proc,),
            name=f"rpc-monitor-{self.idx}", daemon=True,
        ).start()

    def _monitor(self, proc) -> None:
        # Blocking wait(): the child is reaped the instant it dies —
        # no zombies, no poll loop — then process death is published
        # as a crash unless this generation was already replaced or
        # the exit was commanded (close/kill).
        rc = proc.wait()
        with self._cv:
            if self._proc is not proc or self._closed or (
                self._dead is not None
            ):
                return
        self._declare_crash(
            f"worker process pid {proc.pid} exited rc={rc}"
        )

    def handshake(self) -> None:
        """Connect + hello/ready readiness gate, bounded by
        spawn_timeout_s.  On failure the worker is killed and reaped
        and HandshakeError raises — boot fails fast instead of
        hanging on a worker that will never come up.  The bound
        covers the TCP connect itself: a SYN-blackholed endpoint
        burns its connect timeout and fails here, never wedging
        boot."""
        deadline = time.monotonic() + self._spawn_timeout_s
        try:
            client = self._connect_ready(deadline)
        except HandshakeError:
            with self._cv:
                proc = self._proc
            _reap(proc, kill=True)
            raise
        with self._cv:
            self._client = client
            if self._dead is None and not self._closed:
                # transition: booting|reviving -> live
                self.state = "live"

    def _connect_ready(self, deadline: float) -> WorkerClient:
        """Connect + hello/ready gate against the worker's endpoint,
        every socket op bounded by `deadline`.  Raises HandshakeError;
        never kills the process — boot (handshake) and transient-loss
        reconnect own different failure policies.

        Transport failures (refused connect, reset, truncated frame)
        RETRY until the deadline: when a proxy or load balancer sits
        on the dial path it may accept and drop connections before
        the backend worker has bound, and that is indistinguishable
        from not-up-yet.  Only protocol-level verdicts (boot_failed,
        wrong op, wrong proto) and worker death fail immediately."""
        with self._cv:
            proc = self._proc
        last_err: Optional[BaseException] = None
        while True:
            if proc is not None and proc.poll() is not None:
                raise HandshakeError(
                    f"worker {self.idx} exited rc="
                    f"{proc.returncode} before handshake"
                )
            if time.monotonic() >= deadline:
                raise HandshakeError(
                    f"worker {self.idx} endpoint "
                    f"{self._connect_to} never came up within its "
                    f"deadline (last error: {last_err!r})"
                ) from last_err
            sock = None
            try:
                sock = make_client_socket(
                    self._connect_to,
                    max(0.1, deadline - time.monotonic()),
                )
                send_frame(
                    sock, {"op": "hello", "proto": PROTO_VERSION}
                )
                sock.settimeout(
                    max(0.1, deadline - time.monotonic())
                )
                header, _ = recv_frame(sock, self._max_frame)
                if header.get("op") == "boot_failed":
                    raise HandshakeError(
                        f"worker {self.idx} boot failed: "
                        f"{header.get('message')}"
                    )
                if header.get("op") != "ready":
                    raise HandshakeError(
                        f"worker {self.idx} handshake answered "
                        f"{header.get('op')!r}, not ready"
                    )
                if int(header.get("proto", -1)) != PROTO_VERSION:
                    raise HandshakeError(
                        f"worker {self.idx} speaks protocol "
                        f"{header.get('proto')}, need {PROTO_VERSION}"
                    )
                self.device_report = {
                    k: header[k] for k in ("device", "device_bytes")
                    if k in header
                }
            except (OSError, FrameError, ConnectionClosed,
                    socket.timeout) as e:
                if sock is not None:
                    sock.close()
                last_err = e
                time.sleep(0.05)
                continue
            except HandshakeError:
                if sock is not None:
                    sock.close()
                raise
            break
        return WorkerClient(
            sock, on_lost=self._on_conn_lost,
            max_frame=self._max_frame, label=f"engine{self.idx}",
            on_frame=self._on_frame,
            heartbeat_s=self._heartbeat_s,
            heartbeat_timeout_s=self._heartbeat_timeout_s,
            io_timeout_s=self._io_timeout_s,
            lost_error=self._loss_error_for,
        )

    def spawn(self) -> "RemoteEngine":
        self.launch()
        self.handshake()
        return self

    # -- crash handling (supervisor protocol) ----------------------------
    def _reconnect_eligible(self) -> bool:
        if self._reconnect_budget_s <= 0:
            return False
        with self._cv:
            if self._closed or self._dead is not None:
                return False
            proc = self._proc
        return proc is not None and proc.poll() is None

    def _loss_error_for(self, why: str, dirty: bool) -> BaseException:
        # Waiter-facing meaning of a lost connection: while a DIRTY
        # loss is being reconnected the replica is merely UNAVAILABLE
        # — tickets re-home through the fleet re-route path without
        # implying a respawn.  WorkerLost is reserved for worker
        # death: clean hangups, reconnect disabled, budget exhausted,
        # or the process actually gone.
        if dirty and self._reconnect_eligible():
            return ReplicaUnavailable(
                self.idx, f"connection lost; reconnecting: {why}"
            )
        return WorkerLost(why)

    def _notify_net(self, event: str, why: str) -> None:
        if self._on_net is None:
            return
        try:
            self._on_net(event, why)
        except Exception:  # pylint: disable=broad-except
            log.exception(
                "remote engine %d: on_net hook failed", self.idx
            )

    def _on_conn_lost(self, why: str) -> None:
        with self._cv:
            client = self._client
        dirty = client.lost_dirty if client is not None else False
        if not dirty or not self._reconnect_eligible():
            self._declare_crash(why)
            return
        with self._cv:
            if (self._reconnecting or self._crashed.is_set()
                    or self._closed or self._dead is not None):
                return
            # Published BEFORE this hook returns (and therefore
            # before the client fails any ticket): a fleet waiter
            # woken by the ticket failure already sees crashed=True.
            self._reconnecting = True
            # transition: live -> reconnecting
            self.state = "reconnecting"
        threading.Thread(
            target=self._reconnect_loop, args=(why,),
            name=f"rpc-reconnect-{self.idx}", daemon=True,
        ).start()

    def _reconnect_loop(self, why: str) -> None:
        with self._cv:
            old_client, self._client = self._client, None
            gen = self._proc  # this loop serves ONE process generation
        if old_client is not None:
            old_client.close()
        log.warning(
            "remote engine %d: transient connection loss (%s); "
            "reconnecting for up to %.1fs",
            self.idx, why, self._reconnect_budget_s,
        )
        self._notify_net("disconnect", why)
        deadline = time.monotonic() + self._reconnect_budget_s
        delay = self._reconnect_backoff_s
        attempt = 0
        while True:
            with self._cv:
                stop = (self._closed or self._dead is not None
                        or self._crashed.is_set()
                        or self._proc is not gen)
                proc = self._proc
            if stop:
                with self._cv:
                    self._reconnecting = False
                return
            if proc is None or proc.poll() is not None:
                # Actual worker death mid-reconnect: the monitor
                # thread publishes it too; dedupe makes this safe.
                self._declare_crash(
                    f"worker process died during reconnect: {why}"
                )
                with self._cv:
                    self._reconnecting = False
                return
            now = time.monotonic()
            if now >= deadline:
                self._notify_net("gave_up", why)
                self._declare_crash(
                    f"reconnect budget "
                    f"({self._reconnect_budget_s:.1f}s) exhausted: "
                    f"{why}"
                )
                with self._cv:
                    self._reconnecting = False
                return
            attempt += 1
            try:
                client = self._connect_ready(
                    min(deadline, now + self._reconnect_backoff_cap_s
                        + 1.0)
                )
            except HandshakeError as e:
                log.info(
                    "remote engine %d: reconnect attempt %d failed "
                    "(%s)", self.idx, attempt, e,
                )
                # Capped exponential backoff + jitter, never past
                # the budget deadline.
                hold = delay * (0.5 + random.random())
                delay = min(delay * 2.0,
                            self._reconnect_backoff_cap_s)
                time.sleep(max(0.0, min(
                    hold, deadline - time.monotonic()
                )))
                continue
            with self._cv:
                stale = None
                if (self._closed or self._dead is not None
                        or self._crashed.is_set()
                        or self._proc is not gen):
                    stale = client
                else:
                    self._client = client
                    # transition: reconnecting -> live
                    self.state = "live"
                self._reconnecting = False
            if stale is not None:
                stale.close()
                return
            log.warning(
                "remote engine %d: reconnected after %d attempt(s)",
                self.idx, attempt,
            )
            self._notify_net("reconnected", why)
            return

    def _declare_crash(self, why: str) -> None:
        err = WorkerLost(why)
        with self._cv:
            if self._closed or self._dead is not None:
                return
            if self._crashed.is_set():
                return
            # transition: booting|live|reconnecting -> crashed
            self.state = "crashed"
            self._crash_error = err
            supervisor = self._supervisor
            tail_client = self._client
        # Latch + dump the victim's last-scraped flight-recorder tail
        # BEFORE publishing the crash: whoever reads the crash state
        # must already be able to read the final story.  As fresh as
        # the last snapshot scrape — the honest bound of a SIGKILL.
        tail = tail_client.last_flight if tail_client else []
        if tail:
            with self._cv:
                self._lost_flight = tail
            lines = "\n".join(
                "  " + " ".join(
                    f"{k}={e[k]}" for k in ("kind", "trace", "outcome",
                                            "err", "rows", "n")
                    if k in e
                )
                for e in tail[-12:]
            )
            log.warning(
                "remote engine %d lost; last-scraped flight-recorder "
                "tail (%d events, freshness = last scrape):\n%s",
                self.idx, len(tail), lines,
            )
        # Error before event: the supervisor wakes on _crashed and
        # reads _crash_error under _cv (engine._on_crash ordering).
        self._crashed.set()
        log.warning("remote engine %d crashed: %s", self.idx, why)
        if supervisor is None:
            with self._cv:
                self._dead = err
                client = self._client
            if client is not None:
                client.fail_all(err)

    def attach_supervisor(self, supervisor) -> None:
        with self._cv:
            self._supervisor = supervisor

    def revive(self) -> bool:
        """Respawn the worker process: kill/reap the old generation,
        spawn, handshake (readiness-gated).  Queued tickets were
        failed with WorkerLost at connection loss and re-home through
        the fleet re-route path — a dead process cannot preserve its
        queue the way engine.revive() does.  Raises on spawn/handshake
        failure (the supervisor counts it against the restart budget
        and retries or gives up)."""
        with self._cv:
            if self._closed or self._dead is not None:
                return False
            if self.state != "reviving":
                # transition: crashed -> reviving
                self.state = "reviving"
            old_client, self._client = self._client, None
            old_proc = self._proc
        if old_client is not None:
            old_client.close()
        _reap(old_proc, kill=True)
        self.launch()
        self.handshake()
        with self._cv:
            if self._closed or self._dead is not None:
                # Killed while handshaking: tear the fresh worker
                # back down; report not-revived.
                client, self._client = self._client, None
                proc = self._proc
                if client is not None:
                    client.close()
                _reap(proc, kill=True)
                return False
            self._proc_restarts += 1
            self._crash_error = None
        self._crashed.clear()
        # Close the revive crash window: a death landing between the
        # handshake success and the clear above was swallowed by
        # _declare_crash's dedupe (_crashed was still set from the
        # crash being revived).  Re-check liveness now that the flag
        # is clear — a dead-again worker re-declares and the
        # supervisor's next wait()/budget round owns it, instead of a
        # corpse sitting in the fleet marked healthy forever.
        with self._cv:
            client, proc = self._client, self._proc
        if (
            client is None
            or client.lost is not None
            or proc is None
            or proc.poll() is not None
        ):
            self._declare_crash("worker died during revive")
        else:
            log.warning(
                "remote engine %d respawned (pid %s)",
                self.idx, self.pid,
            )
        return True

    def kill(self, err: BaseException) -> None:
        """Terminal: mark dead, fail every outstanding request with
        `err`, SIGKILL + reap the process."""
        with self._cv:
            first = self._dead is None
            if first:
                self._dead = err
            if first and not self._closed:
                # transition: booting|live|reconnecting|crashed|reviving -> dead
                self.state = "dead"
            client, self._client = self._client, None
            proc = self._proc
        self._crashed.set()
        if client is not None:
            client.fail_all(err)
            client.close()
        _reap(proc, kill=True)

    # -- fleet-facing surface --------------------------------------------
    @property
    def crashed(self) -> bool:
        # A reconnecting replica is down for PLACEMENT purposes
        # (_eligible_stats, _replica_down) without waking the
        # supervisor — the supervisor waits on the raw _crashed event,
        # which stays clear until the reconnect budget exhausts.
        with self._cv:
            return (
                (self._crashed.is_set() or self._reconnecting)
                and self._dead is None
            )

    @property
    def dead(self) -> Optional[BaseException]:
        with self._cv:
            return self._dead

    @property
    def pid(self) -> Optional[int]:
        with self._cv:
            return self._proc.pid if self._proc is not None else None

    def _live_client(self) -> WorkerClient:
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._dead is not None:
                raise RuntimeError(
                    f"engine failed permanently: {self._dead}"
                )
            client = self._client
            reconnecting = self._reconnecting
        if client is None or reconnecting or self._crashed.is_set():
            raise RuntimeError(
                f"worker {self.idx} is down (respawning)"
            )
        return client

    def ping(self, timeout: float = 2.0) -> bool:
        """One round trip to the live worker, False on ANY failure —
        the quarantine probe: a flapping replica must answer this
        repeatedly before the fleet lets placements back in."""
        try:
            return bool(self._live_client().ping(timeout=timeout))
        except Exception:  # pylint: disable=broad-except
            return False

    def submit_nowait(self, prompt, max_new, temperature=0.0,
                      top_k=None, top_p=None, stop_token=None,
                      on_token=None, trace_ctx=None) -> RemoteSubmitHandle:
        return self._live_client().submit_nowait(
            prompt, max_new, temperature, top_k=top_k, top_p=top_p,
            stop_token=stop_token, on_token=on_token,
            trace_ctx=trace_ctx,
        )

    def submit(self, prompt, max_new, temperature=0.0, top_k=None,
               top_p=None, stop_token=None, timeout=None,
               on_token=None, trace_ctx=None) -> List[list]:
        handle = self.submit_nowait(
            prompt, max_new, temperature, top_k=top_k, top_p=top_p,
            stop_token=stop_token, on_token=on_token,
            trace_ctx=trace_ctx,
        )
        return handle.wait(timeout=timeout)

    def snapshot(self, max_age_s: Optional[float] = None) -> dict:
        """Worker snapshot, never raising (placement scoring calls
        this in the submit path): a down worker serves the last good
        snapshot zeroed for load, marked "stale", and every snapshot
        carries the process-level restart count folded into
        "restarts" so restart-budget observers see one monotonic
        series across respawns."""
        ttl = self._stats_ttl_s if max_age_s is None else max_age_s
        snap = None
        try:
            snap = self._live_client().snapshot(max_age_s=ttl)
        except Exception:  # pylint: disable=broad-except
            snap = None
        with self._cv:
            restarts = self._proc_restarts
            lost_flight = self._lost_flight
            if snap is not None:
                self._last_snap = snap
                stale = False
            else:
                stale = True
                snap = dict(self._last_snap or {})
                # A down worker has no queue and no active rows —
                # its device state died with it.
                for k in ("queue_depth", "active_rows"):
                    snap[k] = 0
        out = dict(snap)
        out["proc_restarts"] = restarts
        out["restarts"] = int(out.get("restarts", 0) or 0) + restarts
        if stale:
            out["stale"] = True
        if lost_flight and "flight_recorder" not in out:
            # The LAST LOST generation's cached flight-recorder tail
            # (router-side cache; survives the respawn so a post-run
            # snapshot — a chaos run's record — still tells the
            # victim's final story).  Never OVERWRITES a live
            # generation's own post-mortem: an engine that died
            # in-worker (worker alive) ships its full fresh recorder
            # in the snapshot, and that fresher story wins.
            out["flight_recorder"] = lost_flight
        return out

    def metrics_snapshots(self) -> list:
        return self._live_client().metrics_snapshots()

    def export_prefix_pages(self, tokens, move: bool = False,
                            timeout_s: float = 30.0):
        return self._live_client().export_prefix_pages(
            tokens, move=move, timeout_s=timeout_s,
        )

    def adopt_prefix_pages(self, tokens, meta: dict, blob: bytes,
                           timeout_s: float = 30.0) -> int:
        return self._live_client().adopt_prefix_pages(
            tokens, meta, blob, timeout_s=timeout_s,
        )

    def tier_probe(self, tokens) -> dict:
        return self._live_client().tier_probe(tokens)

    def promote_prefix_pages(self, tokens,
                             timeout_s: float = 30.0) -> int:
        return self._live_client().promote_prefix_pages(
            tokens, timeout_s=timeout_s,
        )

    def close(self) -> None:
        """Graceful drain (the SIGTERM/preStop path): ask the worker
        to shut down, give it drain_timeout_s, then SIGKILL; the
        child is reaped on every path and the socket file removed."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if self._dead is None:
                # transition: booting|live|reconnecting|crashed|reviving -> closed
                self.state = "closed"
            client, self._client = self._client, None
            proc = self._proc
        if client is not None:
            try:
                client.call("shutdown", timeout=2.0)
            except Exception:  # pylint: disable=broad-except
                pass
            client.close()
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()
            except OSError:
                pass
        _reap(proc, timeout=self._drain_timeout_s)
        if self._ep_kind == "unix":
            try:
                os.unlink(self._socket_path)
            except OSError:
                pass
