"""Fault-injection harness for the serving stack: the port's own copy of
container_engine_accelerators_tpu/serving/faults.py (host-side, stdlib
only).  Two differences: the speculative drafter's seam is the port's
`_draft_fn`, and `poison_prompt_match` reads torch tensors too.

Deterministic, seed-able injection seams for proving the resilience
contract (engine.py module docstring) under induced failure, instead of
waiting for real hardware to misbehave:

  - `FaultInjector` wraps the engine's prefill/decode seams
    (install_engine_faults) with scripted faults: fail-once,
    fail-N-calls, fail a window of call indices, probabilistic failure
    from a seeded RNG, a predicate match (e.g. "fail the prefill whose
    prompt starts with the poison token"), and slow-step latency
    injection.  Call counting makes a schedule reproducible run-to-run;
    the only randomness is the injector's own seeded Random.
  - `ScriptedEventSource` is a plugin/health.py EventSource whose
    events are produced by the test script (chip_loss /
    recover / host_error), so the server's health-gated drain path runs
    against synthetic chip-loss exactly the way TPUHealthChecker runs
    against native error counters.
  - `NetemProxy` is a fault-injecting TCP proxy (netem-style: added
    latency/jitter, loss-stall, bandwidth cap, byte corruption, hard
    partition, half-open stall) that sits on the REAL socket path
    between router and worker, so network chaos arms drive genuine
    wire failures end to end instead of scripted seam errors.

Used by the fleet and fault tests and chip_smoke.py's fleet phases.
Nothing here imports device code: the harness is host-side and
hermetic.
"""

from __future__ import annotations

import queue
import random
import socket
import struct
import threading
import time
from typing import Callable, List, Optional

# Error-code vocabulary shared with the plugin health layer.  Imported
# lazily-by-value (plain ints) so the serving package does not pull the
# protobuf-backed plugin modules in.
HBM_UNCORRECTABLE_ECC = 1
ICI_LINK_FATAL = 2
ERROR_CLEARED = 0  # recovery: the chip's condition resolved


class InjectedFault(RuntimeError):
    """The error an injection seam raises — distinguishable from real
    failures so chaos tests can assert the failure they caused is the
    failure they observed."""

    def __init__(self, seam: str, call_index: int):
        super().__init__(
            f"injected fault at seam {seam!r} (call {call_index})"
        )
        self.seam = seam
        self.call_index = call_index


class _SeamPlan:
    """Fault schedule for one seam, consulted per call (thread-safe:
    the engine scheduler is the only caller per seam, but counters are
    also read by the harness thread)."""

    def __init__(
        self,
        seam: str,
        *,
        fail_calls: Optional[List[int]] = None,
        fail_after: Optional[int] = None,
        fail_n: int = 0,
        fail_rate: float = 0.0,
        match: Optional[Callable[..., bool]] = None,
        slow_calls: Optional[List[int]] = None,
        slow_s: float = 0.0,
        error: Optional[Callable[[str, int], BaseException]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.seam = seam
        self.fail_calls = set(fail_calls or [])
        self.fail_after = fail_after
        self.fail_n = fail_n
        self.fail_rate = fail_rate
        self.match = match
        self.slow_calls = set(slow_calls or [])
        self.slow_s = slow_s
        self.error = error or InjectedFault
        self._rng = rng or random.Random(0)
        self._lock = threading.Lock()
        self.calls = 0
        self.injected = 0
        self.slowed = 0
        self._failed_so_far = 0

    def consult(self, args, kwargs):
        """One call through the seam: returns seconds to sleep (0 for
        none) or raises the scheduled fault."""
        with self._lock:
            i = self.calls
            self.calls += 1
            sleep_s = (
                self.slow_s if (i in self.slow_calls or
                                (self.slow_s > 0 and not self.slow_calls))
                else 0.0
            )
            fail = False
            if self.match is not None and not self.match(*args, **kwargs):
                pass  # predicate seams only ever fail matching calls
            elif i in self.fail_calls:
                fail = True
            elif (
                self.fail_after is not None
                and i >= self.fail_after
                and self._failed_so_far < self.fail_n
            ):
                fail = True
            elif self.fail_rate > 0 and self._rng.random() < self.fail_rate:
                fail = True
            elif self.match is not None and self.fail_n and (
                self._failed_so_far < self.fail_n
            ):
                # A bare predicate plan (match + fail_n, no window):
                # fail the first fail_n matching calls.
                fail = True
            if fail:
                self.injected += 1
                self._failed_so_far += 1
                err = self.error(self.seam, i)
            else:
                err = None
            if sleep_s:
                self.slowed += 1
        if sleep_s:
            time.sleep(sleep_s)
        if err is not None:
            raise err
        return sleep_s


class FaultInjector:
    """Deterministic fault scripting over named seams.

    plan(...) declares a schedule; wrap(seam, fn) returns fn guarded by
    that schedule (unplanned seams pass through untouched, still
    counted).  One injector instance is one reproducible chaos run:
    the seed fixes the probabilistic schedule, call counting fixes the
    rest."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._plans = {}

    def plan(
        self,
        seam: str,
        *,
        fail_calls: Optional[List[int]] = None,
        fail_after: Optional[int] = None,
        fail_n: int = 0,
        fail_rate: float = 0.0,
        match: Optional[Callable[..., bool]] = None,
        slow_calls: Optional[List[int]] = None,
        slow_s: float = 0.0,
        error: Optional[Callable[[str, int], BaseException]] = None,
    ) -> "_SeamPlan":
        """Schedule faults for one seam.  fail_calls: exact 0-based
        call indices to fail.  fail_after+fail_n: fail the next fail_n
        calls once call index reaches fail_after (fail-once is
        fail_n=1; a persistent outage is a large fail_n).  fail_rate:
        seeded-random failure probability per call.  match: only calls
        where match(*args) is True are eligible (with fail_n bounding
        how many fail).  slow_s (+ optional slow_calls): latency
        injection instead of / in addition to failure."""
        p = _SeamPlan(
            seam,
            fail_calls=fail_calls,
            fail_after=fail_after,
            fail_n=fail_n,
            fail_rate=fail_rate,
            match=match,
            slow_calls=slow_calls,
            slow_s=slow_s,
            error=error,
            # Seeded from the (seed, seam) STRING: str seeding is
            # deterministic across processes, unlike tuple hash()
            # (PYTHONHASHSEED salting would break reproducibility).
            rng=random.Random(f"{self._seed}:{seam}"),
        )
        self._plans[seam] = p
        return p

    def wrap(self, seam: str, fn: Callable) -> Callable:
        if seam not in self._plans:
            self._plans[seam] = _SeamPlan(seam)  # pass-through, counted

        def wrapped(*args, **kwargs):
            # Looked up per call, not captured: a test can re-plan a
            # seam on a LIVE engine (e.g. arm the slow-step schedule,
            # run a phase, then disarm with a fresh empty plan).
            self._plans[seam].consult(args, kwargs)
            return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn
        wrapped.__fault_seam__ = seam
        return wrapped

    def stats(self) -> dict:
        return {
            seam: {
                "calls": p.calls,
                "injected": p.injected,
                "slowed": p.slowed,
            }
            for seam, p in self._plans.items()
        }


def install_engine_faults(engine, injector: FaultInjector):
    """Wrap a ContinuousBatchingEngine's device seams in the
    injector's schedules: seam "prefill" guards _prefill_fn (the
    FINAL prefill chunk — tok0 sampling + engine-cache write, one call
    per admission; for single-chunk prompts this is the whole
    prefill), seam "prefill_chunk" guards _prefill_chunk_fn (the
    non-final scratch-cache chunks of a chunked admission), seam
    "decode_step" guards _decode_fn (one call per whole-batch step —
    under the lagged pipeline, per DISPATCH), and — paged engine only
    — seam "prefix_preload" guards _preload_fn (the prefix-cache
    gather before resumed chunks).  Idempotent-unsafe on purpose:
    install once per engine.  Returns the injector for chaining.

    When the engine carries the observability layer, the injector's
    per-seam calls/injected/slowed counters are registered into its
    registry (serve_fault_*_total{seam=...}) so a chaos run's injection
    bookkeeping lands on the same /metrics scrape as the latency
    histograms and flight-recorder events it explains."""
    engine._prefill_fn = injector.wrap("prefill", engine._prefill_fn)
    engine._prefill_chunk_fn = injector.wrap(
        "prefill_chunk", engine._prefill_chunk_fn
    )
    engine._decode_fn = injector.wrap("decode_step", engine._decode_fn)
    if getattr(engine, "_fused_fn", None) is not None:
        # Fused multi-step engine only (decode_steps > 1): seam
        # "decode_fused" guards the chained k-step block dispatch (one
        # call per block — the quiet-turn analog of "decode_step").
        engine._fused_fn = injector.wrap(
            "decode_fused", engine._fused_fn
        )
    if getattr(engine, "_preload_fn", None) is not None:
        # Paged engine only: the prefix-cache preload gather (one call
        # per prefix-hit admission, before the resumed chunks).
        engine._preload_fn = injector.wrap(
            "prefix_preload", engine._preload_fn
        )
    tier = getattr(engine, "_tier", None)
    if tier is not None:
        # Tiered page store only: seam "tier_load" guards the
        # disk spill-file load (mmap + CRC verify, one call per disk
        # promotion).  An injected fault here exercises the corrupt-
        # blob contract end to end: the store counts `corrupt`,
        # deletes the entry, and the admission recomputes — the
        # ticket must never fail.
        tier._tier_load = injector.wrap("tier_load", tier._tier_load)
    if getattr(engine, "_spec_k", 0):
        # Speculative engine only: seam "spec_verify" guards the
        # batched verify window (one call per drafted block — the spec
        # path's decode_step analog) and "spec_draft" the int8 twin's
        # draft chain (`_draft_fn`, one call per block).
        engine._verify_fn = injector.wrap(
            "spec_verify", engine._verify_fn
        )
        engine._draft_fn = injector.wrap(
            "spec_draft", engine._draft_fn
        )
    obs = getattr(engine, "observability", None)
    if obs is not None and getattr(obs, "enabled", False):
        obs.attach_injector(injector)
    return injector


def install_fleet_faults(fleet, injector: FaultInjector):
    """Fleet-scope injection seams (serving/fleet.py):

      - seam "route" guards the router's placement decision (one
        consult per placement attempt).  An injected fault here
        surfaces as a placement error on exactly one request — the
        chaos suite uses it to prove a routing failure is contained
        to its own caller.
      - seam "engine_death:<i>" guards replica i's decode
        dispatch, exactly like the engine-level "decode_step" seam
        but addressable PER REPLICA — so a chaos script can fail one
        specific replica persistently (crash -> supervisor budget ->
        eviction) at a deterministic call index while its siblings
        run completely untouched.  That is the scripted replica loss
        the fleet chaos acceptance (kill one of N mid-load) runs on.

    Wraps each live replica present at install time; install once per
    fleet.  The injector's per-seam counters are registered into the
    fleet registry (serve_fault_*_total{seam=...}) so the injection
    bookkeeping lands on the same scrape as the per-engine series it
    explains.  Returns the injector for chaining."""
    fleet._route = injector.wrap("route", fleet._route)
    for rep in fleet.replicas:
        rep.engine._decode_fn = injector.wrap(
            f"engine_death:{rep.idx}", rep.engine._decode_fn
        )

    def collect():
        from .observe import MetricSnapshot

        stats = injector.stats()
        for field in ("calls", "injected", "slowed"):
            yield MetricSnapshot(
                f"serve_fault_{field}_total",
                "counter",
                f"Fault-injection seam {field} (serving/faults.py)",
                [
                    ({"seam": seam}, float(s[field]))
                    for seam, s in sorted(stats.items())
                ],
            )

    fleet.registry.register_collector("fleet-fault-injector", collect)
    return injector


def poison_prompt_match(token: int):
    """Predicate for the "prefill" seam: True when the prompt chunk's
    first token equals `token` — the deterministic poison-prompt
    marker of the chaos tests.  The port's prefill seam is
    (cache, scratch, chunk, block-table row or slot, start, ...): the
    cache and scratch are lists of per-layer dicts and the block-table row is
    1-D, so the chunk is the first 2-D integer tensor argument (a
    single-chunk prompt's chunk starts at token 0).  A torch dtype
    prints as "torch.int32", so the prefix is stripped before the
    integer test."""

    def match(*args, **kwargs):
        del kwargs
        for a in args:
            dtype = str(getattr(a, "dtype", ""))
            if (
                getattr(a, "ndim", 0) == 2
                and dtype.replace("torch.", "").startswith("int")
            ):
                return int(a[0, 0]) == token
        return False

    return match


class NetemProxy:
    """Fault-injecting TCP proxy on the real router<->worker socket
    path (netem-style).  Listens on an ephemeral 127.0.0.1 port and
    forwards every accepted connection to `backend` (a `host:port`
    TCP spec or a Unix socket path), applying the configured network
    pathology per forwarded chunk:

      - latency_s + jitter_s: added one-way delay (jitter uniform in
        [0, jitter_s), from the seeded RNG).
      - drop_rate: per-chunk probability of an EXTRA retransmit-like
        stall (drop_stall_s).  A byte stream cannot lose bytes
        without corrupting the framing — what the application sees of
        packet loss under TCP is delay, so that is what we inject.
      - bandwidth_bps: pacing cap (sleep len/bps per chunk).
      - corrupt_rate: per-chunk probability of flipping one byte —
        downstream framing blows up (FrameError), which must kill ONE
        connection, never the worker.
      - partition(): hard partition — RST every live connection and
        refuse new ones until heal().
      - half_open(): stall both pump directions with the sockets held
        open (no FIN ever reaches either side) — the powered-off-host
        case only heartbeat timeouts can detect.

    The wiring seam is ProcessFleetManager(connect_via=...): bind the
    worker directly, hand the router this proxy's `endpoint`.  Fully
    host-side and hermetic, like the rest of this module."""

    _CHUNK = 65536

    def __init__(
        self,
        backend: str,
        *,
        host: str = "127.0.0.1",
        latency_s: float = 0.0,
        jitter_s: float = 0.0,
        drop_rate: float = 0.0,
        drop_stall_s: float = 0.05,
        bandwidth_bps: float = 0.0,
        corrupt_rate: float = 0.0,
        seed: int = 0,
    ):
        self.backend = backend
        self.latency_s = float(latency_s)
        self.jitter_s = float(jitter_s)
        self.drop_rate = float(drop_rate)
        self.drop_stall_s = float(drop_stall_s)
        self.bandwidth_bps = float(bandwidth_bps)
        self.corrupt_rate = float(corrupt_rate)
        self._rng = random.Random(f"netem:{seed}")
        self._lock = threading.Lock()
        self._conns: List[socket.socket] = []  # guarded-by: _lock
        self._partitioned = False
        self._half_open = False
        self._stop = threading.Event()
        self.stats = {
            "accepted": 0, "refused": 0, "bytes": 0,
            "corrupted": 0, "drop_stalls": 0,
        }  # guarded-by: _lock
        self._listener = socket.socket(
            socket.AF_INET, socket.SOCK_STREAM
        )
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._listener.bind((host, 0))
        self._listener.listen(8)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]
        self.endpoint = f"{host}:{self.port}"
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"netem-accept-{self.port}", daemon=True,
        )
        self._accept_thread.start()

    # -- chaos script side -----------------------------------------------
    def partition(self) -> None:
        """Hard partition: RST every live connection (SO_LINGER 0 so
        no graceful FIN) and refuse new ones until heal()."""
        with self._lock:
            self._partitioned = True
            victims = list(self._conns)
            self._conns.clear()
        for s in victims:
            try:
                # SO_LINGER (on, 0s): close() sends RST instead of
                # FIN — the honest wire shape of a hard partition.
                s.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0),
                )
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def half_open(self) -> None:
        """Freeze both pump directions, sockets held open: no data,
        no FIN — only a heartbeat timeout can see this."""
        with self._lock:
            self._half_open = True

    def heal(self) -> None:
        with self._lock:
            self._partitioned = False
            self._half_open = False

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            victims = list(self._conns)
            self._conns.clear()
        for s in victims:
            try:
                s.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5.0)

    # -- data path -------------------------------------------------------
    def _dial_backend(self) -> socket.socket:
        from . import rpc as rpc_mod

        return rpc_mod.make_client_socket(self.backend, 5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                refused = self._partitioned
                if refused:
                    self.stats["refused"] += 1
            if refused:
                try:
                    client.close()
                except OSError:
                    pass
                continue
            try:
                backend = self._dial_backend()
            except OSError:
                try:
                    client.close()
                except OSError:
                    pass
                continue
            with self._lock:
                self.stats["accepted"] += 1
                self._conns.extend((client, backend))
            for src, dst, tag in (
                (client, backend, "up"), (backend, client, "down")
            ):
                threading.Thread(
                    target=self._pump, args=(src, dst),
                    name=f"netem-{tag}-{self.port}", daemon=True,
                ).start()

    def _pump(self, src: socket.socket, dst: socket.socket) -> None:
        try:
            src.settimeout(0.2)
        except OSError:
            return
        while not self._stop.is_set():
            with self._lock:
                frozen = self._half_open
            if frozen:
                # Stalled, not closed: nothing forwarded, nothing
                # read, sockets stay open so no FIN is ever seen.
                time.sleep(0.05)
                continue
            try:
                data = src.recv(self._CHUNK)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            # Re-check after the (blocking) recv: a chunk read
            # concurrently with half_open() arming is "in flight" —
            # hold it until heal(), never deliver during the stall.
            while not self._stop.is_set():
                with self._lock:
                    frozen = self._half_open
                if not frozen:
                    break
                time.sleep(0.05)
            delay = self.latency_s
            if self.jitter_s > 0:
                delay += self._rng.random() * self.jitter_s
            if self.drop_rate > 0 and self._rng.random() < self.drop_rate:
                delay += self.drop_stall_s
                with self._lock:
                    self.stats["drop_stalls"] += 1
            if self.bandwidth_bps > 0:
                delay += len(data) / self.bandwidth_bps
            if delay > 0:
                time.sleep(delay)
            if (self.corrupt_rate > 0
                    and self._rng.random() < self.corrupt_rate):
                buf = bytearray(data)
                buf[self._rng.randrange(len(buf))] ^= 0xFF
                data = bytes(buf)
                with self._lock:
                    self.stats["corrupted"] += 1
            try:
                dst.sendall(data)
            except OSError:
                break
            with self._lock:
                self.stats["bytes"] += len(data)
        # Half of a closed pair: propagate the close to the peer
        # direction (unless we are mid-half-open, where silence is
        # the whole point — but then the loop never exits).
        for s in (src, dst):
            try:
                s.close()
            except OSError:
                pass
        with self._lock:
            for s in (src, dst):
                if s in self._conns:
                    self._conns.remove(s)


class _Event:
    """Shape-compatible with native tpuinfo events (plugin/health.py)."""

    def __init__(self, device_index, error_code, is_host_event=False,
                 device_name=""):
        self.device_index = device_index
        self.error_code = error_code
        self.is_host_event = is_host_event
        self.device_name = device_name
        self.timestamp_us = int(time.time() * 1e6)


class ScriptedEventSource:
    """A plugin/health.py EventSource driven by the test script:
    chip_loss()/recover()/host_error() enqueue events; wait() delivers
    them with real blocking semantics, so consumers (the serving
    health watch, TPUHealthChecker) exercise their production wait
    loop against synthetic faults.  wait_error_next() makes the next
    wait() raise, covering the recover() path too."""

    def __init__(self, names: Optional[List[str]] = None):
        self._names = list(names or ["tpu0", "tpu1", "tpu2", "tpu3"])
        self._q: "queue.Queue[_Event]" = queue.Queue()
        self._wait_errors = 0
        self._lock = threading.Lock()
        self.recover_calls = 0
        self.closed = False

    # -- script side -----------------------------------------------------
    def chip_loss(self, index: int, code: int = ICI_LINK_FATAL):
        self._q.put(_Event(index, code))

    def recover_chip(self, index: int):
        self._q.put(_Event(index, ERROR_CLEARED))

    def host_error(self, code: int = HBM_UNCORRECTABLE_ECC):
        self._q.put(_Event(-1, code, is_host_event=True))

    def wait_error_next(self, n: int = 1):
        with self._lock:
            self._wait_errors += n

    # -- EventSource side ------------------------------------------------
    def device_names(self) -> List[str]:
        return list(self._names)

    def wait(self, timeout_ms: int):
        with self._lock:
            if self._wait_errors > 0:
                self._wait_errors -= 1
                raise RuntimeError("injected event-wait failure")
        try:
            return self._q.get(timeout=timeout_ms / 1000.0)
        except queue.Empty:
            return None

    def recover(self) -> None:
        self.recover_calls += 1

    def refresh_devices(self) -> None:
        pass

    def close(self) -> None:
        self.closed = True

    def sdk_state(self) -> str:
        return "active"
