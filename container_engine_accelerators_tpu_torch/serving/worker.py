"""Engine-worker process: one supervised ContinuousBatchingEngine
behind the serving/rpc.py frame protocol.

The port's own copy of container_engine_accelerators_tpu/serving/
worker.py: the same server, ops and lifecycle over the port's engine.
The factories build torch models on the `device` their kwargs name
(default "cuda"); a worker asked for the card on a host without one
fails its handshake with boot_failed and never comes up on the CPU.
`--engine-json` carries the engine's `device` as a string.

This is the other half of the process-isolated fleet (rpc.py module
docstring): the router process spawns
`python -m container_engine_accelerators_tpu_torch.serving.worker` per
replica, and each worker owns one engine — its own interpreter (its
own GIL and CUDA context), its own KV cache/pool/prefix trie, its own
EngineSupervisor for scheduler crashes, its own PRIVATE observe
registry — and serves the engine submit contract over a Unix socket.
The source paper's shape: the node agent (router) scrapes and
supervises an isolated plugin daemon (worker); a wedged or dying
worker never takes the router down with it.

Boot order is deliberate: the socket binds and the accept loop starts
BEFORE the model and engine build, so the parent's connect succeeds
immediately and its hello waits on the readiness gate — the `ready`
reply is sent only once the engine exists (or `boot_failed` if the
build died), and the parent's spawn timeout bounds the whole wait.

Lifecycle:
  SIGTERM       — fleet-wide drain propagated by the router (or K8s
                  preStop): stop accepting, let in-flight requests
                  finish within the drain budget, close the engine,
                  exit 0.
  engine death  — the in-worker supervisor exhausting its restart
                  budget kills the engine (tickets fail fast, frames
                  carry the terminal error) and the worker exits 1;
                  the router-side supervisor treats process exit as a
                  crash and respawns within ITS budget.
  bad client    — a connection sending garbage frames is closed and
                  its outstanding requests cancelled; every other
                  connection (and the engine) keeps serving.

The model arrives via a FACTORY SPEC (`module:callable` or
`/path/to/file.py:callable`) plus JSON kwargs — the worker rebuilds
the model itself (deterministic init seed or checkpoint load) instead
of shipping hundreds of MB of parameters over a pipe.  A factory
returns a decode=True TransformerLM.  Two factories ship here:
`transformer_lm_factory` (tests' tiny LMs) and `demo_lm_factory` (the
server's model, checkpoint included).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import logging
import os
import queue
import select
import signal
import socket
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np

from . import otel, rpc

log = logging.getLogger(__name__)

# Bounded payload caps for observability piggybacks: the spans a
# terminal done/fail frame may carry, and the flight-recorder tail a
# snapshot reply ships for the router's lost-worker cache.  Both are
# best-effort telemetry — bounded so neither can bloat the frames the
# request path rides on.
MAX_SPANS_PER_FRAME = 64
FLIGHT_TAIL_EVENTS = 32


# -- model factories --------------------------------------------------------
def transformer_lm_factory(vocab=64, dim=32, depth=1, heads=2,
                           max_seq=64, seed=0, dtype="float32",
                           device="cuda"):
    """Tiny-LM factory for tests: the port's decode-mode TransformerLM
    with weights drawn by `init_random` from
    torch.Generator().manual_seed(seed) (drawn on the CPU, so a seed
    gives the same weights on every device), on `device`."""
    import torch

    from ..models import generate as G

    dec = G.make_decoder(
        vocab=int(vocab), dim=int(dim), depth=int(depth),
        heads=int(heads), max_seq=int(max_seq),
        dtype=getattr(torch, dtype), device=device,
    )
    return dec.init_random(torch.Generator().manual_seed(int(seed)))


def demo_lm_factory(vocab=32000, dim=512, depth=4, heads=0,
                    max_seq=1024, checkpoint="", device="cuda"):
    """The server's model, rebuilt worker-side: generate.py
    make_decoder with the server's dims, weights from
    torch.Generator().manual_seed(0) or an lm_main checkpoint — the
    exact construction the port's ServingApp._build_lm performs
    in-process, so an in-process fleet and a process fleet hold the
    same weights."""
    import torch

    from ..models import generate as G

    heads = int(heads) or max(1, int(dim) // 128)
    dec = G.make_decoder(
        vocab=int(vocab), dim=int(dim), depth=int(depth),
        heads=heads, max_seq=int(max_seq), device=device,
    )
    if not checkpoint:
        return dec.init_random(torch.Generator().manual_seed(0))
    from ..utils.checkpoint import restore_params

    if restore_params(checkpoint, dec) is None:
        raise RuntimeError(
            f"checkpoint dir {checkpoint!r} contains no checkpoint"
        )
    return dec


def _device_report(device) -> dict:
    """The hello's account of where the engine lives: its device, and on
    a card the bytes this process's allocator holds there (weights, KV
    pool, graphs)."""
    if device is None:
        return {}
    import torch

    device = torch.device(device)
    held = (int(torch.cuda.memory_allocated(device))
            if device.type == "cuda" else 0)
    return {"device": str(device), "device_bytes": held}


def resolve_factory(spec: str):
    """`module:callable` (import path) or `/path/file.py:callable`
    (loaded by file location — how tests hand the worker helper
    factories without packaging them)."""
    path, sep, name = spec.rpartition(":")
    if not sep or not path or not name:
        raise ValueError(
            f"factory spec {spec!r} must be 'module:callable' or "
            f"'/path/file.py:callable'"
        )
    if path.endswith(".py") or os.sep in path:
        modname = "_worker_factory_" + os.path.basename(path).replace(
            ".py", ""
        )
        found = importlib.util.spec_from_file_location(modname, path)
        if found is None:
            raise ValueError(f"cannot load factory file {path!r}")
        mod = importlib.util.module_from_spec(found)
        sys.modules[modname] = mod
        found.loader.exec_module(mod)
    else:
        mod = importlib.import_module(path)
    fn = getattr(mod, name, None)
    if fn is None:
        raise ValueError(f"factory {name!r} not found in {path!r}")
    return fn


# -- connection handler -----------------------------------------------------
class _Conn:
    """One client connection: a reader thread dispatching ops and a
    writer thread draining the outgoing frame queue — engine threads
    (on_token, done callbacks) enqueue and return, they never touch
    the socket, so a slow or dead client can't stall the scheduler."""

    def __init__(self, server: "WorkerServer", sock, peer: str):
        self.server = server
        self.sock = sock
        self.peer = peer
        # Deadline discipline (mirrors rpc.WorkerClient): the socket
        # timeout bounds every send and the mid-frame stall budget;
        # heartbeats bound how long a half-open ROUTER can hold this
        # connection's slots hostage.
        sock.settimeout(server.io_timeout_s)
        now = time.monotonic()
        self._last_rx = now   # reader-thread heartbeat bookkeeping
        self._last_tx = now   # benign float race: monotonic stamps
        self._lock = threading.Lock()
        self._handles: Dict[int, object] = {}  # guarded-by: _lock
        self._trace_ids: Dict[int, str] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # BOUNDED: a reader that stops draining (slow-loris) fills
        # this and loses ITS connection — engine threads enqueue with
        # put_nowait and never block, so backpressure degrades one
        # connection, never the scheduler.
        self._out: "queue.Queue" = queue.Queue(
            maxsize=server.send_queue_max
        )
        self._writer = threading.Thread(
            target=self._write_loop, name=f"worker-w-{peer}",
            daemon=True,
        )
        self._reader = threading.Thread(
            target=self._read_loop, name=f"worker-r-{peer}",
            daemon=True,
        )

    def start(self) -> None:
        self._writer.start()
        self._reader.start()

    def enqueue(self, header: dict, blob: bytes = b"") -> None:
        try:
            self._out.put_nowait((header, blob))
        except queue.Full:
            log.warning(
                "worker conn %s: send queue overflow (%d frames; "
                "slow reader) — closing this connection only",
                self.peer, self.server.send_queue_max,
            )
            # Close on a detached thread: enqueue() is called from
            # engine callback threads that may hold engine locks, and
            # close() joins the writer and cancels handles.
            threading.Thread(
                target=self.close,
                args=("send queue overflow (slow reader)",),
                name=f"worker-overflow-{self.peer}", daemon=True,
            ).start()

    def reply(self, seq, _blob: bytes = b"", **fields) -> None:
        self.enqueue({"op": "reply", "seq": seq, **fields}, _blob)

    def _write_loop(self) -> None:
        while True:
            item = self._out.get()
            if item is None:
                return
            header, blob = item
            try:
                rpc.send_frame(
                    self.sock, header, blob, self.server.max_frame,
                    observer=self.server.on_frame,
                )
                self._last_tx = time.monotonic()
            except (OSError, rpc.FrameError) as e:
                log.warning(
                    "worker conn %s: send failed (%r); closing",
                    self.peer, e,
                )
                self.close("send failed")
                return

    def _read_loop(self) -> None:
        hb_s = self.server.heartbeat_s
        poll_s = (min(1.0, hb_s / 4.0) if hb_s > 0
                  else self.server.io_timeout_s)
        while True:
            try:
                ready = select.select([self.sock], [], [], poll_s)[0]
            except (OSError, ValueError):
                self.close("socket closed")
                return
            if not ready:
                now = time.monotonic()
                idle_rx = now - self._last_rx
                if (hb_s > 0
                        and idle_rx > self.server.heartbeat_timeout_s):
                    log.warning(
                        "worker conn %s: heartbeat timeout (no "
                        "traffic for %.1fs; half-open router?) — "
                        "closing this connection only",
                        self.peer, idle_rx,
                    )
                    self.close("heartbeat timeout")
                    return
                if hb_s > 0 and now - self._last_tx >= hb_s:
                    self.enqueue({"op": "hb"})
                continue
            try:
                header, blob = rpc.recv_frame(
                    self.sock, self.server.max_frame,
                    observer=self.server.on_frame,
                    max_stream=rpc.MAX_STREAM,
                    stall_timeout_s=self.server.io_timeout_s,
                )
            except rpc.IdleTimeout:
                continue
            except rpc.ConnectionClosed as e:
                self.close("client reset" if e.dirty
                           else "client closed")
                return
            except (OSError, rpc.FrameError) as e:
                # Garbage on THIS connection: close it, cancel its
                # requests — the worker (and every other connection)
                # keeps serving.
                log.warning(
                    "worker conn %s: protocol error (%r); closing "
                    "this connection only", self.peer, e,
                )
                self.close("protocol error")
                return
            self._last_rx = time.monotonic()
            try:
                self._dispatch(header, blob)
            except Exception as e:  # pylint: disable=broad-except
                # A handler bug answers THIS op with an error and
                # keeps the connection — containment per request.
                log.exception(
                    "worker conn %s: op %r failed", self.peer,
                    header.get("op"),
                )
                seq = header.get("seq")
                if seq is not None:
                    self.reply(seq, err=rpc.exc_to_wire(e))

    # -- ops -------------------------------------------------------------
    def _dispatch(self, header: dict, blob: bytes) -> None:
        op = header.get("op")
        seq = header.get("seq")
        if op == "hb":
            return  # keepalive: receipt alone refreshed the window
        if op == "hello":
            self.server.ready_evt.wait()
            boot_error = self.server.boot_error
            if boot_error is not None:
                self.enqueue({
                    "op": "boot_failed", "message": boot_error,
                })
            else:
                engine = self.server.engine
                self.enqueue({
                    "op": "ready", "proto": rpc.PROTO_VERSION,
                    "pid": os.getpid(),
                    "n_slots": engine.n_slots,
                    **_device_report(getattr(engine, "device", None)),
                })
            self.server.hello_answered.set()
            return
        if op == "ping":
            self.reply(seq)
            return
        if op == "shutdown":
            self.reply(seq)
            self.server.request_shutdown(0, "shutdown op")
            return
        engine = self.server.engine
        if engine is None:
            self.reply(seq, err={
                "kind": "runtime", "message": "engine not ready",
            })
            return
        if op == "submit":
            self._op_submit(engine, header, blob, seq)
            return
        if op in ("cancel", "cancel_if_queued"):
            with self._lock:
                handle = self._handles.get(int(header["rid"]))
            if handle is None:
                # Already resolved (or never existed): a cancel of a
                # finished request is a no-op, not an error.
                self.reply(seq, ok=False)
                return
            err = rpc.exc_from_wire(header.get("err", {}))
            if op == "cancel":
                handle.cancel(err)
                self.reply(seq, ok=True)
            else:
                self.reply(seq, ok=handle.cancel_if_queued(err))
            return
        if op == "admitted":
            with self._lock:
                handle = self._handles.get(int(header["rid"]))
            self.reply(
                seq,
                admitted=bool(handle is not None and handle.admitted),
            )
            return
        if op == "snapshot":
            # The bounded flight-recorder tail piggybacks on the
            # placement-cadence scrape: the router caches it so a
            # SIGKILLed worker's final story survives router-side
            # (rpc.RemoteEngine).
            self.reply(
                seq, snapshot=engine.snapshot(),
                flight=self.server.flight_tail(),
            )
            return
        if op == "metrics":
            self.reply(
                seq,
                metrics=rpc.snapshots_to_wire(
                    self.server.metric_snapshots()
                ),
            )
            return
        if op == "tier_probe":
            # Tier placement probe: index walks only (trie +
            # tier-store locks, no device work), so it answers inline
            # on the reader thread — the router calls it on the
            # placement path and must not wait behind a migration.
            try:
                toks = np.frombuffer(blob, np.int32)
                self.reply(seq, probe=engine.tier_probe(toks))
            except Exception as e:  # pylint: disable=broad-except
                self.reply(seq, err=rpc.exc_to_wire(e))
            return
        if op == "promote_tier":
            # Tier promotion blocks on the engine's scheduler
            # (side-job seam) like migration: thread-per-op keeps this
            # connection's reader dispatching meanwhile.
            threading.Thread(
                target=self._op_promote_tier,
                args=(engine, header, blob, seq),
                name=f"worker-promote-{self.peer}", daemon=True,
            ).start()
            return
        if op in ("export_pages", "adopt_pages"):
            # Migration ops block on the engine's scheduler (side-job
            # seam) for up to their job timeout: run them on their own
            # thread so THIS connection's reader keeps dispatching
            # submits/cancels meanwhile.  Rare (once per migrated
            # prefix), so thread-per-op is the simple containment.
            threading.Thread(
                target=self._op_migrate,
                args=(engine, op, header, blob, seq),
                name=f"worker-migrate-{self.peer}", daemon=True,
            ).start()
            return
        self.reply(seq, err={
            "kind": "runtime", "message": f"unknown op {op!r}",
        })

    # borrows-pages
    def _op_migrate(self, engine, op, header, blob, seq) -> None:
        """export_pages / adopt_pages handler (its own thread): the
        same per-op containment as _dispatch — a failure answers THIS
        op with the wire error and the connection lives on."""
        try:
            timeout_s = float(header.get("job_timeout_s", 30.0))
            if op == "export_pages":
                toks = np.frombuffer(blob, np.int32)
                out = engine.export_prefix_pages(
                    toks, move=bool(header.get("move")),
                    timeout_s=timeout_s,
                )
                if out is None:
                    self.reply(seq, meta=None)
                else:
                    meta, pages = out
                    self.reply(seq, meta=meta, _blob=pages)
            else:
                import struct as struct_mod

                ntok = struct_mod.unpack(">I", blob[:4])[0]
                toks = np.frombuffer(blob, np.int32, count=ntok,
                                     offset=4)
                pages = blob[4 + 4 * ntok:]
                adopted = engine.adopt_prefix_pages(
                    toks, header.get("meta") or {}, pages,
                    timeout_s=timeout_s,
                )
                self.reply(seq, adopted=int(adopted))
        except Exception as e:  # pylint: disable=broad-except
            log.warning(
                "worker conn %s: %s failed: %r", self.peer, op, e,
            )
            self.reply(seq, err=rpc.exc_to_wire(e))

    def _op_promote_tier(self, engine, header, blob, seq) -> None:
        """promote_tier handler (its own thread): raise a prefix's
        tier-resident pages into the engine's HBM trie between
        scheduler turns — the same per-op containment as
        _op_migrate."""
        try:
            toks = np.frombuffer(blob, np.int32)
            promoted = engine.promote_prefix_pages(
                toks,
                timeout_s=float(header.get("job_timeout_s", 30.0)),
            )
            self.reply(seq, promoted=int(promoted))
        except Exception as e:  # pylint: disable=broad-except
            log.warning(
                "worker conn %s: promote_tier failed: %r",
                self.peer, e,
            )
            self.reply(seq, err=rpc.exc_to_wire(e))

    def _op_submit(self, engine, header, blob, seq) -> None:
        rid = int(header["rid"])
        try:
            rows = int(header["rows"])
            plen = int(header["plen"])
            prompt = np.frombuffer(blob, np.int32).reshape(rows, plen)
            on_token = None
            if header.get("stream"):
                def on_token(row, tok, _rid=rid):
                    self.enqueue({
                        "op": "token", "rid": _rid,
                        "row": int(row), "tok": int(tok),
                    })

            # Propagated trace context: a malformed context
            # is DROPPED, never a submit failure — tracing is
            # best-effort by contract; the engine then mints a local
            # trace id like any context-less submit.
            trace_ctx = None
            wire_ctx = header.get("trace")
            if wire_ctx:
                try:
                    trace_ctx = otel.TraceContext.from_wire(wire_ctx)
                except ValueError:
                    log.warning(
                        "worker conn %s: dropping malformed trace "
                        "context %r", self.peer, wire_ctx,
                    )
            handle = engine.submit_nowait(
                prompt, int(header["max_new"]),
                float(header.get("temperature", 0.0)),
                top_k=header.get("top_k"),
                top_p=header.get("top_p"),
                stop_token=header.get("stop_token"),
                on_token=on_token,
                trace_ctx=trace_ctx,
            )
        except Exception as e:  # pylint: disable=broad-except
            self.reply(seq, err=rpc.exc_to_wire(e))
            return
        with self._lock:
            closed = self._closed
            if not closed:
                self._handles[rid] = handle
                if trace_ctx is not None:
                    self._trace_ids[rid] = trace_ctx.trace_id
        if closed:
            # Lost the race with close().  Cancel OUTSIDE _lock: the
            # engine's done-callbacks can fire under its own lock and
            # take _lock (in _on_done), so taking the engine lock
            # while holding _lock would be a lock-order inversion.
            handle.cancel(RuntimeError("client disconnected"))
            self.reply(seq, err={
                "kind": "runtime", "message": "connection closing",
            })
            return
        handle.add_done_callback(lambda: self._on_done(rid))
        self.reply(seq, ok=True)

    def _on_done(self, rid: int) -> None:
        # Fires on whichever thread resolves the ticket (scheduler
        # included): read the resolved handle, enqueue the terminal
        # frame, return — no socket I/O, no engine re-entry.  The
        # frame is enqueued BEFORE the handle is popped: the drain
        # loop treats outstanding()==0 as "every result is at least
        # queued", so the pop must never make a request invisible
        # while its terminal frame is still unenqueued.
        with self._lock:
            handle = self._handles.get(rid)
            trace_id = self._trace_ids.get(rid)
        if handle is None:
            return
        # Sealed spans ride the terminal frame: bounded,
        # best-effort — a failure here must never drop the done/fail
        # frame the waiter is blocked on.  Retire seals the trace
        # BEFORE the ticket resolves (engine._retire ordering), so
        # the ring already holds this request's spans; rows the
        # containment paths seal late simply ship fewer spans.
        spans = []
        if trace_id is not None:
            try:
                spans = self.server.spans_for(trace_id)
            except Exception:  # pylint: disable=broad-except
                log.exception("span shipping failed (frame unharmed)")
        err = handle.error
        if err is not None:
            frame = {
                "op": "fail", "rid": rid,
                "err": rpc.exc_to_wire(err),
            }
        else:
            frame = {
                "op": "done", "rid": rid,
                "results": [
                    [int(t) for t in (row or [])]
                    for row in handle.results
                ],
            }
        if spans:
            frame["spans"] = spans
        self.enqueue(frame)
        with self._lock:
            self._handles.pop(rid, None)
            self._trace_ids.pop(rid, None)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._handles)

    def close(self, why: str) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            handles = list(self._handles.values())
            self._handles.clear()
            self._trace_ids.clear()
        # The client is gone: its requests must not keep burning
        # decode steps nobody will read.
        for h in handles:
            try:
                h.cancel(RuntimeError(f"client disconnected ({why})"))
            except Exception:  # pylint: disable=broad-except
                pass
        # Sentinel must land even when the bounded queue is full (the
        # overflow close path): drop queued frames to make room — the
        # connection is dying, nobody reads them.
        while True:
            try:
                self._out.put_nowait(None)
                break
            except queue.Full:
                try:
                    self._out.get_nowait()
                except queue.Empty:
                    pass
        # Flush before shutdown: the writer exits after sending every
        # frame queued ahead of the sentinel, so a graceful close
        # (worker drain) delivers the terminal done/fail frames the
        # drain loop waited for.  Bounded — a dead peer blocking
        # sendall must not wedge the close; shutdown() below forces
        # the writer out then.  (Skipped when the writer itself is
        # closing after a send failure: it cannot join itself, and
        # there is nothing left to flush to a broken socket.)
        if threading.current_thread() is not self._writer:
            self._writer.join(timeout=2.0)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.server.forget(self)


# -- server -----------------------------------------------------------------
class WorkerServer:
    """Accept loop + readiness gate over one engine (module
    docstring).  Tests drive it in-process (a real socket, no
    subprocess) — the protocol seam is identical either way."""

    def __init__(self, socket_path: str,
                 max_frame: int = rpc.MAX_FRAME,
                 heartbeat_s: float = 5.0,
                 heartbeat_timeout_s: float = 15.0,
                 io_timeout_s: float = 30.0,
                 send_queue_max: int = 4096):
        # `socket_path` is an endpoint spec: a UDS path (default) or
        # host:port for TCP (rpc.parse_endpoint) — same frames, same
        # handshake, same op table over both.
        self.socket_path = socket_path
        self.ep_kind = rpc.parse_endpoint(socket_path)[0]
        self.max_frame = int(max_frame)
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.send_queue_max = int(send_queue_max)
        self.engine = None
        self.supervisor = None
        self.boot_error: Optional[str] = None
        # Frame-size observer (rpc_frame_bytes histogram): assigned
        # once the engine's registry exists; read per frame by the
        # connection loops.
        self.on_frame = None
        self.ready_evt = threading.Event()
        # Set once any hello got its answer (ready or boot_failed) —
        # the failed-boot exit path waits on it so the factory error
        # reaches a parent whose two-phase handshake arrives late.
        self.hello_answered = threading.Event()
        self._lock = threading.Lock()
        self._conns: list = []  # guarded-by: _lock
        self._accepting = False  # guarded-by: _lock
        self._shutdown = threading.Event()
        self._exit_code = 0
        self._shutdown_why = ""
        if self.ep_kind == "unix":
            try:
                os.unlink(socket_path)
            except OSError:
                pass
        # make_listener sets the accept timeout: the accept loop is
        # deadline-bounded like every other socket op here.
        self._listener = rpc.make_listener(socket_path, backlog=8)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="worker-accept", daemon=True,
        )

    def start(self) -> "WorkerServer":
        with self._lock:
            self._accepting = True
        self._accept_thread.start()
        return self

    def set_engine(self, engine, supervisor=None) -> None:
        """Readiness gate: hellos block until this (or boot_failed)."""
        self.engine = engine
        self.supervisor = supervisor
        self.ready_evt.set()

    def boot_failed(self, message: str) -> None:
        self.boot_error = message
        self.ready_evt.set()

    def metric_snapshots(self) -> list:
        """The worker's private scrape: the engine registry when
        instrumented, else the numeric snapshot() fields as gauges
        (observe.snapshot_gauges — the ONE fallback definition shared
        with the in-process fleet collector)."""
        from . import observe as observe_mod

        obs = getattr(self.engine, "observability", None)
        if obs is not None and getattr(obs, "enabled", False):
            return obs.registry.collect()
        return observe_mod.snapshot_gauges(self.engine.snapshot())

    def spans_for(self, trace_id: str) -> list:
        """Bounded sealed-span dicts for one propagated trace id —
        the terminal-frame payload (empty for an uninstrumented
        engine or an evicted trace; best-effort by contract)."""
        obs = getattr(self.engine, "observability", None)
        if obs is None:
            return []
        return obs.spans_for(trace_id, limit=MAX_SPANS_PER_FRAME)

    def flight_tail(self) -> list:
        """Bounded flight-recorder tail for the snapshot piggyback
        ([] for an uninstrumented engine)."""
        obs = getattr(self.engine, "observability", None)
        if obs is None or not getattr(obs, "enabled", False):
            return []
        return obs.recorder.events()[-FLIGHT_TAIL_EVENTS:]

    def _accept_loop(self) -> None:
        n = 0
        while True:
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue  # accept poll tick (make_listener's timeout)
            except OSError:
                return  # listener closed: shutting down
            if self.ep_kind == "tcp":
                try:
                    sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                except OSError:
                    pass
            with self._lock:
                if not self._accepting:
                    sock.close()
                    continue
                n += 1
                conn = _Conn(self, sock, f"c{n}")
                self._conns.append(conn)
            conn.start()

    def forget(self, conn) -> None:
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)

    def outstanding(self) -> int:
        with self._lock:
            conns = list(self._conns)
        return sum(c.outstanding() for c in conns)

    def request_shutdown(self, code: int, why: str) -> None:
        if not self._shutdown.is_set():
            self._exit_code = code
            self._shutdown_why = why
            self._shutdown.set()

    def wait_shutdown(self) -> int:
        self._shutdown.wait()
        return self._exit_code

    def drain_and_close(self, timeout_s: float = 30.0) -> None:
        """preStop semantics: stop accepting, let in-flight requests
        finish within the budget, then close every connection."""
        with self._lock:
            self._accepting = False
        try:
            self._listener.close()
        except OSError:
            pass
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and self.outstanding() > 0:
            time.sleep(0.05)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close("worker shutting down")
        if self.ep_kind == "unix":
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass


# -- process entry point ----------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="engine-worker process (serving/rpc.py protocol)"
    )
    p.add_argument("--socket", required=True,
                   help="endpoint to bind: Unix socket path, or "
                        "host:port for TCP")
    p.add_argument("--factory", required=True,
                   help="model factory: module:callable or "
                        "/path/file.py:callable")
    p.add_argument("--factory-json", default="{}",
                   help="JSON kwargs for the factory")
    p.add_argument("--slots", type=int, required=True)
    p.add_argument("--engine-json", default="{}",
                   help="JSON kwargs for ContinuousBatchingEngine")
    p.add_argument("--replica", type=int, default=0,
                   help="replica index (logs/labels only)")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="in-worker scheduler restart budget")
    p.add_argument("--drain-timeout-s", type=float, default=30.0)
    p.add_argument("--max-frame", type=int, default=rpc.MAX_FRAME)
    p.add_argument("--parent-pid", type=int, default=0,
                   help="drain and exit if this process stops being "
                        "our parent (the router died ungracefully — "
                        "SIGKILL skips its close(); a worker must "
                        "not serve an ownerless socket forever)")
    p.add_argument("--hb-s", type=float, default=5.0,
                   help="idle heartbeat interval (0 disables)")
    p.add_argument("--hb-timeout-s", type=float, default=15.0,
                   help="declare a connection half-open after this "
                        "long with no inbound traffic")
    p.add_argument("--io-timeout-s", type=float, default=30.0,
                   help="per-socket-op deadline (send / mid-frame "
                        "stall budget)")
    p.add_argument("--send-queue", type=int, default=4096,
                   help="per-connection outgoing frame bound; a "
                        "reader this far behind loses its connection")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format=(
            f"worker[{args.replica}] "
            "%(levelname)s %(name)s: %(message)s"
        ),
    )
    server = WorkerServer(
        args.socket, max_frame=args.max_frame,
        heartbeat_s=args.hb_s,
        heartbeat_timeout_s=args.hb_timeout_s,
        io_timeout_s=args.io_timeout_s,
        send_queue_max=args.send_queue,
    ).start()

    def on_sigterm(signum, frame):
        del signum, frame
        print(
            f"worker[{args.replica}]: SIGTERM, draining",
            file=sys.stderr,
        )
        server.request_shutdown(0, "SIGTERM")

    signal.signal(signal.SIGTERM, on_sigterm)

    if args.parent_pid:
        def orphan_watch():
            while True:
                time.sleep(1.0)
                if os.getppid() != args.parent_pid:
                    print(
                        f"worker[{args.replica}]: parent "
                        f"{args.parent_pid} died; draining",
                        file=sys.stderr,
                    )
                    server.request_shutdown(0, "parent died")
                    return

        threading.Thread(
            target=orphan_watch, name="orphan-watch", daemon=True,
        ).start()

    try:
        factory = resolve_factory(args.factory)
        model = factory(**json.loads(args.factory_json))
        from .engine import ContinuousBatchingEngine
        from .supervisor import EngineSupervisor

        engine_kw = json.loads(args.engine_json)
        engine_kw.setdefault("device", str(model.device))
        engine = ContinuousBatchingEngine(model, args.slots, **engine_kw)
        supervisor = EngineSupervisor(
            engine,
            max_restarts=args.max_restarts,
            # Scheduler restart budget exhausted: the engine is dead
            # in THIS process; exit 1 so the router-side supervisor
            # respawns a whole fresh worker under its own budget.
            on_giveup=lambda err: server.request_shutdown(
                1, f"engine dead: {err}"
            ),
        ).start()
    except Exception as e:  # pylint: disable=broad-except
        log.exception("worker boot failed")
        server.boot_failed(repr(e))
        # Hold the socket until the parent's hello is ANSWERED (its
        # two-phase boot may handshake this worker minutes after the
        # factory died — exiting on a fixed grace would reduce the
        # error to an opaque 'exited rc=1') — bounded, and cut short
        # if the parent dies (orphan watchdog requests shutdown).
        deadline = time.monotonic() + 600.0
        while (
            time.monotonic() < deadline
            and not server.hello_answered.is_set()
            and not server._shutdown.is_set()
        ):
            time.sleep(0.1)
        time.sleep(0.5)  # let the writer flush the boot_failed frame
        return 1
    obs = getattr(engine, "observability", None)
    if obs is not None and getattr(obs, "enabled", False):
        # Span process label: which worker recorded a span in the
        # router's assembled trace (replica index + pid so a respawn
        # is visibly a different process).
        obs.process = f"worker{args.replica}:pid{os.getpid()}"
        # Frame-size histogram (large-blob hygiene pin): every wire
        # frame this worker sends or receives, on the same private
        # registry the router scrapes and relabels.
        _hist = obs.registry.histogram(
            "rpc_frame_bytes",
            "Wire frame sizes on this worker's RPC socket "
            "(serving/rpc.py; streamed blobs count per chunk frame)",
            rpc.FRAME_SIZE_BUCKETS,
        )
        server.on_frame = _hist.observe
    server.set_engine(engine, supervisor)
    print(
        f"worker[{args.replica}]: ready pid={os.getpid()} "
        f"slots={engine.n_slots} socket={args.socket}",
        file=sys.stderr,
    )
    code = server.wait_shutdown()
    print(
        f"worker[{args.replica}]: shutting down "
        f"({server._shutdown_why}), rc={code}",
        file=sys.stderr,
    )
    server.drain_and_close(timeout_s=args.drain_timeout_s)
    try:
        supervisor.stop()
    except Exception:  # pylint: disable=broad-except
        log.exception("supervisor stop failed")
    try:
        engine.close()
    except Exception:  # pylint: disable=broad-except
        log.exception("engine close failed")
    return code


if __name__ == "__main__":
    sys.exit(main())
