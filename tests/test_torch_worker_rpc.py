"""The port's worker RPC (serving/rpc.py, serving/worker.py) and process
fleet (ProcessFleetManager) against the reference.

Framing across packages: a frame the port's send_frame writes is
byte-identical to the reference's and decodes in the reference's
recv_frame, and the reverse (streamed blobs included); the wire codecs
map the same kinds onto the port's error classes.  Then the reference's
tests/test_worker_rpc.py and tests/test_net_chaos.py cases on the port:
an in-process WorkerServer over a real socket, and worker processes
built by a factory handed over by file path (tests/test_torch_isolation.py
holds that a worker imports neither jax nor the JAX package), on the CPU, whose tokens
equal the port's in-process fleet's and the reference's; kill -9 and
respawn, boot_failed and hung handshakes, a worker asked for the card
without one, the drain, and a network partition through a fault proxy.
The reference's SYN-blackhole case dials a non-routable outside
address and is not carried over.
"""

import json
import os
import signal
import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    CFG, PAGE, draw_params, jax_decoder, jax_params, port_model, rand_prompt,
)
from conftest import wait_until
from container_engine_accelerators_tpu.models import generate as ref_G
from container_engine_accelerators_tpu.serving import rpc as ref_rpc
from container_engine_accelerators_tpu.serving import errors as ref_errors
from container_engine_accelerators_tpu_torch.models import generate as G
from container_engine_accelerators_tpu_torch.serving import faults, observe
from container_engine_accelerators_tpu_torch.serving import rpc
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine,
)
from container_engine_accelerators_tpu_torch.serving.errors import (
    QueueFullError, ReplicaUnavailable, StepFailure,
)
from container_engine_accelerators_tpu_torch.serving.fleet import (
    FleetManager, ProcessFleetManager,
)
from container_engine_accelerators_tpu_torch.serving.router import (
    NoReplicasError,
)
from container_engine_accelerators_tpu_torch.serving.worker import (
    WorkerServer, resolve_factory,
)
import torch_worker_factories as TWF

HERE = os.path.dirname(os.path.abspath(__file__))
FACTORIES = os.path.join(HERE, "torch_worker_factories.py")
# One intra-op thread a worker: the suite runs beside other workers'
# tests, and a spawned interpreter would otherwise take every core.
WORKER_ENV = {"OMP_NUM_THREADS": "1"}
ENGINE_KW = dict(prompt_grid=4, page_size=PAGE, prefill_chunk=PAGE,
                 retry_backoff_s=0.01, retry_backoff_cap_s=0.02)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = draw_params(0)
    path = str(tmp_path_factory.mktemp("params") / "lm.npz")
    TWF.save_params(path, params)
    return params, port_model(params), path


def _factory_kw(path):
    return {"params": path, "cfg": json.dumps(CFG), "device": "cpu"}


def _solo(pm, prompt, n):
    return G.generate_prefill(pm, prompt, prompt.shape[1], n, 0.0,
                              torch.Generator())[0].tolist()


def _ref_solo(params, prompt, n):
    return np.asarray(ref_G.generate_prefill(
        jax_decoder(), jax_params(params), jnp.asarray(prompt),
        prompt.shape[1], n, 0.0, jax.random.PRNGKey(0)))[0].tolist()


def _proc_fleet(path, n=2, **kw):
    kw.setdefault("restart_backoff_s", 0.05)
    return ProcessFleetManager(
        f"{FACTORIES}:npz_lm_factory", _factory_kw(path), n, 2,
        engine_kw=dict(ENGINE_KW), spawn_timeout_s=120.0,
        drain_timeout_s=20.0, worker_env=WORKER_ENV, **kw)


# -- framing across packages -------------------------------------------------
def _wire_bytes(mod, header, blob, **kw):
    a, b = socket.socketpair()
    out = bytearray()
    done = threading.Event()

    def drain():
        b.settimeout(2.0)
        while True:
            try:
                chunk = b.recv(1 << 20)
            except socket.timeout:
                break
            if not chunk:
                break
            out.extend(chunk)
        done.set()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    mod.send_frame(a, header, blob, **kw)
    a.shutdown(socket.SHUT_WR)
    done.wait(30)
    a.close()
    b.close()
    return bytes(out)


FRAMES = [
    ({"op": "hello", "proto": 1}, b""),
    ({"op": "token", "rid": 3, "row": 0, "tok": 17}, b""),
    ({"op": "submit", "seq": 9, "rid": 2, "rows": 1, "plen": 5,
      "trace": None, "top_k": None}, np.arange(5, dtype=np.int32).tobytes()),
    ({"op": "reply", "seq": 1, "meta": {"n_pages": 2, "sig": [[8, "torch"]]}},
     bytes(range(256)) * 300),
    ({"op": "export_pages", "seq": 4},
     np.random.default_rng(0).bytes((16 << 20) + 12345)),  # streamed
]


@pytest.mark.parametrize("header,blob", FRAMES,
                         ids=[h["op"] + str(len(b)) for h, b in FRAMES])
def test_frames_are_byte_identical_and_cross_decode(header, blob):
    mine = _wire_bytes(rpc, header, blob)
    theirs = _wire_bytes(ref_rpc, header, blob)
    assert mine == theirs
    for send, recv in ((rpc, ref_rpc), (ref_rpc, rpc)):
        a, b = socket.socketpair()
        t = threading.Thread(target=send.send_frame, args=(a, header, blob))
        t.start()
        got = recv.recv_frame(b, max_stream=recv.MAX_STREAM)
        t.join(30)
        a.close()
        b.close()
        assert got == (header, blob)


def test_exception_codec_matches_the_reference():
    pairs = [
        (QueueFullError("full"), ref_errors.QueueFullError("full")),
        (StepFailure("died"), ref_errors.StepFailure("died")),
        (ReplicaUnavailable(2, "draining"),
         ref_errors.ReplicaUnavailable(2, "draining")),
        (rpc.WorkerLost("pid 1"), ref_rpc.WorkerLost("pid 1")),
        (rpc.FrameError("bad"), ref_rpc.FrameError("bad")),
        (rpc.IdleTimeout("idle"), ref_rpc.IdleTimeout("idle")),
        (ValueError("v"), ValueError("v")),
        (RuntimeError("r"), RuntimeError("r")),
        (NoReplicasError(), None),
    ]
    for mine, theirs in pairs:
        wired = json.loads(json.dumps(rpc.exc_to_wire(mine)))
        if theirs is not None:
            assert wired == ref_rpc.exc_to_wire(theirs)
        back = rpc.exc_from_wire(wired)
        want = ReplicaUnavailable if isinstance(mine, NoReplicasError) \
            else type(mine)
        assert type(back) is want, (mine, back)
        ref_back = ref_rpc.exc_from_wire(wired)
        assert type(ref_back).__name__ == want.__name__
    back = rpc.exc_from_wire(rpc.exc_to_wire(ReplicaUnavailable(2, "x")))
    assert back.replica == 2 and back.why == "x"


def test_metric_snapshots_cross_the_wire_both_ways():
    from container_engine_accelerators_tpu.serving import (
        observe as ref_observe,
    )

    for src, dst in ((observe, ref_rpc), (ref_observe, rpc)):
        reg = src.Registry()
        reg.counter("t_total", "help me").inc(3)
        hist = reg.histogram("t_lat", "h", buckets=(0.1, 1.0))
        hist.observe(0.05, exemplar="abc")
        hist.observe(5.0)
        wire = json.loads(json.dumps(
            (rpc if src is observe else ref_rpc).snapshots_to_wire(
                reg.collect())))
        back = dst.snapshots_from_wire(wire)
        labelled = (observe if dst is rpc else ref_observe
                    ).relabel_snapshots(back, engine=7)
        out = (observe if dst is rpc else ref_observe).Registry()
        out.register_collector("x", lambda lab=labelled: lab)
        text = out.render()
        assert 't_total{engine="7"} 3' in text
        assert 't_lat_count{engine="7"} 2' in text


class TestFraming:
    def test_partial_reads_are_completed(self):
        a, b = socket.socketpair()
        payload = json.dumps({"op": "y", "pad": "z" * 300}).encode()
        frame = struct.pack(">II", len(payload), 4) + payload + b"abcd"

        def dribble():
            for i in range(len(frame)):
                a.sendall(frame[i:i + 1])
                time.sleep(0.0002)

        threading.Thread(target=dribble, daemon=True).start()
        header, blob = rpc.recv_frame(b)
        assert header["op"] == "y" and blob == b"abcd"

    def test_oversized_and_garbage_frames_rejected(self):
        a, b = socket.socketpair()
        a.sendall(struct.pack(">II", 1 << 30, 1 << 30))
        with pytest.raises(rpc.FrameError):
            rpc.recv_frame(b)
        a, _ = socket.socketpair()
        with pytest.raises(rpc.FrameError):
            rpc.send_frame(a, {"op": "x"}, b"\x00" * 64, max_frame=32)
        for bad in (b"\x00not json!!", b"[1,2,3]"):
            a, b = socket.socketpair()
            a.sendall(struct.pack(">II", len(bad), 0) + bad)
            with pytest.raises(rpc.FrameError):
                rpc.recv_frame(b)

    def test_clean_eof_vs_mid_frame_eof(self):
        a, b = socket.socketpair()
        a.close()
        with pytest.raises(rpc.ConnectionClosed):
            rpc.recv_frame(b)
        a, b = socket.socketpair()
        a.sendall(b"\x00\x00\x00")
        a.close()
        with pytest.raises(rpc.FrameError):
            rpc.recv_frame(b)

    def test_parse_endpoint_taxonomy(self):
        assert rpc.parse_endpoint("127.0.0.1:9000") == (
            "tcp", ("127.0.0.1", 9000))
        for spec in ("/tmp/w.sock", "/odd:dir/w.sock", "w-0.sock",
                     "host:80x", ":9000", "host:"):
            assert rpc.parse_endpoint(spec)[0] == "unix", spec


def _tcp_pair():
    listener = rpc.make_listener(f"127.0.0.1:{rpc.free_tcp_port()}")
    a = rpc.make_client_socket(
        "127.0.0.1:%d" % listener.getsockname()[1], 5.0)
    b, _ = listener.accept()
    listener.close()
    b.settimeout(5.0)
    return a, b


def test_tcp_reset_is_dirty_and_fin_is_clean():
    a, b = _tcp_pair()
    a.close()
    with pytest.raises(rpc.ConnectionClosed) as ei:
        rpc.recv_frame(b)
    assert ei.value.dirty is False
    b.close()
    a, b = _tcp_pair()
    a.sendall(b"\x00\x00\x00")
    time.sleep(0.05)
    a.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    a.close()
    with pytest.raises(rpc.ConnectionClosed) as ei:
        rpc.recv_frame(b)
    assert ei.value.dirty is True
    b.close()


# -- an in-process WorkerServer over a real socket ---------------------------
def _connect(path):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(path)
    rpc.send_frame(sock, {"op": "hello", "proto": rpc.PROTO_VERSION})
    header, _ = rpc.recv_frame(sock)
    assert header["op"] == "ready", header
    return rpc.WorkerClient(sock, label="test")


@pytest.fixture(scope="module")
def served(setup, tmp_path_factory):
    _, pm, _ = setup
    engine = ContinuousBatchingEngine(pm, 2, device="cpu", **ENGINE_KW)
    path = str(tmp_path_factory.mktemp("rpc") / "worker.sock")
    server = WorkerServer(path).start()
    server.set_engine(engine)
    client = _connect(path)
    yield server, client, engine, path
    client.close()
    server.drain_and_close(timeout_s=2)
    engine.close()


class TestWorkerServerLocal:
    def test_greedy_parity_and_stream_order(self, setup, served):
        params, pm, _ = setup
        _, client, _, _ = served
        for seed, p_len, n in ((0, 12, 6), (1, 9, 5)):
            prompt = rand_prompt(seed, p_len)
            want = _solo(pm, prompt, n)
            assert want == _ref_solo(params, prompt, n)
            streamed = []
            got = client.submit_nowait(
                prompt, n, on_token=lambda r, t: streamed.append(t)
            ).wait(timeout=120)
            assert got[0] == want and streamed == want

    def test_validation_and_queue_full_errors_keep_their_types(
            self, setup, served, tmp_path):
        _, pm, _ = setup
        _, client, _, _ = served
        with pytest.raises(ValueError):
            client.submit_nowait(rand_prompt(0, 8), 0).wait(5)
        with pytest.raises(ValueError):
            client.submit_nowait(rand_prompt(0, CFG["max_seq"]), 8).wait(5)
        engine = ContinuousBatchingEngine(pm, 1, max_queue=1, device="cpu",
                                          **ENGINE_KW)
        path = str(tmp_path / "qf.sock")
        server = WorkerServer(path).start()
        server.set_engine(engine)
        qc = _connect(path)
        try:
            a = qc.submit_nowait(rand_prompt(0, 8), 24)
            wait_until(lambda: a.admitted, what="admission of a")
            b = qc.submit_nowait(rand_prompt(1, 8), 8)
            with pytest.raises(QueueFullError):
                qc.submit_nowait(rand_prompt(2, 8), 8)
            a.wait(timeout=120)
            b.wait(timeout=120)
        finally:
            qc.close()
            server.drain_and_close(timeout_s=2)
            engine.close()

    def test_cancel_if_queued_atomicity_over_the_socket(self, setup,
                                                       tmp_path):
        _, pm, _ = setup
        engine = ContinuousBatchingEngine(pm, 1, device="cpu", **ENGINE_KW)
        path = str(tmp_path / "atom.sock")
        server = WorkerServer(path).start()
        server.set_engine(engine)
        client = _connect(path)
        try:
            yanked = 0
            for i in range(10):
                blocker = client.submit_nowait(rand_prompt(100 + i, 8), 4)
                tokens = []
                target = client.submit_nowait(
                    rand_prompt(200 + i, 8), 4,
                    on_token=lambda r, t: tokens.append(t))
                time.sleep(0.002 * (i % 5))
                ok = target.cancel_if_queued(
                    ReplicaUnavailable(0, "atomicity hammer"))
                blocker.wait(timeout=120)
                if ok:
                    yanked += 1
                    with pytest.raises(ReplicaUnavailable):
                        target.wait(timeout=120)
                    assert tokens == []
                else:
                    assert len(target.wait(timeout=120)[0]) == 4
                    assert len(tokens) == 4
            assert yanked >= 1
        finally:
            client.close()
            server.drain_and_close(timeout_s=2)
            engine.close()

    def test_late_cancel_noop_and_garbage_fails_one_connection(
            self, served):
        _, client, _, path = served
        handle = client.submit_nowait(rand_prompt(3, 8), 4)
        out = handle.wait(timeout=120)
        assert handle.admitted and handle.cancel_if_queued() is False
        handle.cancel(RuntimeError("late"))
        assert handle.wait(timeout=5) == out
        raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        raw.connect(path)
        raw.sendall(b"\xff" * 64)
        raw.settimeout(10)
        try:
            data = raw.recv(1)
        except ConnectionResetError:
            data = b""
        assert data == b""
        raw.close()
        assert client.ping(timeout=10)
        assert len(client.submit_nowait(rand_prompt(4, 8), 3).wait(
            timeout=120)[0]) == 3

    def test_scrape_snapshot_and_tier_ops(self, served):
        _, client, _, _ = served
        snaps = client.metrics_snapshots()
        assert any(s.name.startswith("serve_") for s in snaps)
        assert all(isinstance(s, observe.MetricSnapshot) for s in snaps)
        fresh = client.snapshot(max_age_s=0.0)
        assert client.snapshot(max_age_s=30.0) == fresh
        assert "queue_depth" in fresh and "active_rows" in fresh
        probe = client.tier_probe(np.arange(2 * PAGE) % 64)
        assert probe["host_pages"] == 0 and probe["disk_pages"] == 0
        assert client.promote_prefix_pages(np.arange(2 * PAGE) % 64) == 0

    def test_page_migration_over_the_socket(self, setup, served):
        _, pm, _ = setup
        _, client, engine, _ = served
        prompt = rand_prompt(77, 3 * PAGE + 2)
        client.submit_nowait(prompt, 2).wait(timeout=120)
        meta, blob = client.export_prefix_pages(prompt[0])
        assert meta["n_pages"] == 3
        other = ContinuousBatchingEngine(pm, 2, device="cpu", **ENGINE_KW)
        try:
            toks = prompt[0][: meta["tokens_covered"]]
            assert other.adopt_prefix_pages(toks, meta, blob) == 3
            # And the reverse: pages another engine exports, adopted
            # over the socket, serve the worker's next request as a hit.
            second = rand_prompt(78, 2 * PAGE + 3)
            other.submit(second, 2, timeout=120)
            meta2, blob2 = other.export_prefix_pages(second[0])
            toks2 = second[0][: meta2["tokens_covered"]]
            assert client.adopt_prefix_pages(toks2, meta2, blob2) == 2
            hits = engine.snapshot()["prefix_hit_tokens"]
            want = other.submit(second, 4, timeout=120)
            assert client.submit_nowait(second, 4).wait(120) == want
            assert engine.snapshot()["prefix_hit_tokens"] >= hits + 2 * PAGE
        finally:
            other.close()


# -- worker processes --------------------------------------------------------
@pytest.fixture(scope="module")
def proc_fleet(setup):
    _, _, path = setup
    fleet = _proc_fleet(path, max_restarts=4)
    yield fleet
    fleet.close()


class TestProcessFleet:
    def test_tokens_equal_the_in_process_fleet_and_the_reference(
            self, setup, proc_fleet):
        params, pm, _ = setup
        prompts = [rand_prompt(s, 12) for s in range(4)]
        inproc = FleetManager(pm, 2, 2, engine_kw=dict(ENGINE_KW))
        try:
            want = [inproc.submit(p, 6, 0.0, timeout=300) for p in prompts]
        finally:
            inproc.close()
        got = [proc_fleet.submit(p, 6, 0.0, timeout=300) for p in prompts]
        assert got == want
        assert [w[0] for w in want] == [_ref_solo(params, p, 6)
                                        for p in prompts]

    def test_snapshot_and_relabelled_scrape(self, proc_fleet):
        snap = proc_fleet.snapshot()
        assert snap["replicas"] == 2
        assert snap["replica_states"] == ["up", "up"]
        assert all("queue_depth" in e and "proc_restarts" in e
                   for e in snap["engines"])
        # Each worker's handshake says where its engine lives.
        assert [e.device_report for e in proc_fleet.engines] == [
            {"device": "cpu", "device_bytes": 0}] * 2
        text = proc_fleet.registry.render()
        assert 'engine="0"' in text and 'engine="1"' in text
        assert "fleet_replicas_up 2" in text
        assert "fleet_rpc_frame_bytes_count" in text
        for line in text.splitlines():
            if line.startswith("# TYPE serve_"):
                assert text.count(line) == 1

    def test_kill9_rehomes_and_respawns(self, setup, proc_fleet):
        _, pm, _ = setup
        pids0 = proc_fleet.worker_pids()
        results, errs = {}, []

        def client(i):
            try:
                results[i] = proc_fleet.submit(rand_prompt(300 + i, 12), 8,
                                               0.0, timeout=300)
            except Exception as e:  # pylint: disable=broad-except
                errs.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        wait_until(lambda: proc_fleet.engines[0].snapshot()["active_rows"]
                   or len(results) == 8, timeout=120,
                   what="replica 0 busy")
        os.kill(pids0[0], signal.SIGKILL)
        for th in threads:
            th.join(timeout=300)
        assert not errs, errs[:3]
        for i, got in results.items():
            assert got[0] == _solo(pm, rand_prompt(300 + i, 12), 8)
        wait_until(lambda: (
            not proc_fleet.replicas[0].engine.crashed
            and proc_fleet.worker_pids()[0] not in (None, pids0[0])),
            timeout=120, what="the respawn")
        snap = proc_fleet.snapshot()
        assert snap["replica_states"] == ["up", "up"]
        assert snap["engines"][0]["proc_restarts"] == 1
        prompt = rand_prompt(999, 12)
        assert proc_fleet.replicas[0].engine.submit(
            prompt, 6, 0.0, timeout=300)[0] == _solo(pm, prompt, 6)

    def test_close_drains_workers_and_leaves_no_zombies(self, proc_fleet):
        # Last in the class: it closes the module's fleet.
        pids = proc_fleet.worker_pids()
        engines = proc_fleet.engines
        sock_dir = proc_fleet._sock_dir
        proc_fleet.close()
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
        assert [e._proc.returncode for e in engines] == [0, 0]
        assert not os.path.exists(sock_dir)
        proc_fleet.close()


@pytest.mark.parametrize("factory,kw,match", [
    (f"{FACTORIES}:boom_factory", {}, "boom_factory"),
    ("container_engine_accelerators_tpu_torch.serving.worker"
     ":transformer_lm_factory", {}, "CUDA"),
])
def test_boot_failure_reports_the_factory_error(factory, kw, match):
    # The second case: the factories default to the card, and a worker
    # asked for it on a host without one fails its handshake.
    if match == "CUDA" and torch.cuda.is_available():
        pytest.skip("a card is present: the worker would come up on it")
    with pytest.raises(rpc.HandshakeError, match=match):
        ProcessFleetManager(factory, kw, 1, 2, spawn_timeout_s=120.0,
                            worker_env=WORKER_ENV)


def test_handshake_hang_fails_fast_and_reaps():
    t0 = time.monotonic()
    with pytest.raises(rpc.HandshakeError):
        ProcessFleetManager(f"{FACTORIES}:hang_factory", {}, 1, 2,
                            spawn_timeout_s=3.0, worker_env=WORKER_ENV)
    assert time.monotonic() - t0 < 60


def test_factory_specs_resolve():
    assert callable(resolve_factory(f"{FACTORIES}:npz_lm_factory"))
    assert callable(resolve_factory(
        "container_engine_accelerators_tpu_torch.serving.worker"
        ":demo_lm_factory"))
    with pytest.raises(ValueError):
        resolve_factory("no-colon-here")


def test_worker_factories_build_the_servers_model():
    from container_engine_accelerators_tpu_torch.serving import worker

    got = worker.demo_lm_factory(vocab=64, dim=32, depth=1, heads=2,
                                 max_seq=32, device="cpu")
    want = G.make_decoder(vocab=64, dim=32, depth=1, heads=2, max_seq=32,
                          device="cpu").init_random(
        torch.Generator().manual_seed(0))
    for a, b in zip(got.parameters(), want.parameters()):
        assert torch.equal(a, b)
    tiny = worker.transformer_lm_factory(seed=3, device="cpu")
    assert tiny.decode and tiny.dtype == torch.float32


# -- the network: a partition through the fault proxy ------------------------
def test_partition_rehomes_and_the_victim_reconnects(setup):
    _, pm, path = setup
    proxies = {}

    def via(i, bind):
        proxies[i] = faults.NetemProxy(bind)
        return proxies[i].endpoint

    fleet = _proc_fleet(path, transport="tcp", connect_via=via,
                        heartbeat_s=0.3, heartbeat_timeout_s=1.5,
                        reconnect_budget_s=60.0, flap_threshold=0)
    results, failures = [], []
    stop = threading.Event()

    def pound(w):
        i = 0
        while not stop.is_set():
            i += 1
            try:
                out = fleet.submit(rand_prompt(1000 + w * 101 + i, 10), 4,
                                   0.0, timeout=300)
                results.append(len(out[0]))
            except Exception as e:  # pylint: disable=broad-except
                failures.append(repr(e))

    threads = [threading.Thread(target=pound, args=(w,), daemon=True)
               for w in range(3)]
    try:
        p = rand_prompt(0, 12)
        assert fleet.submit(p, 6, 0.0, timeout=300) == [_solo(pm, p, 6)]
        c0 = fleet.snapshot()["fleet"]
        for t in threads:
            t.start()
        wait_until(lambda: len(results) >= 6, timeout=180,
                   what="load before the partition")
        pre = len(results)
        proxies[0].partition()
        wait_until(lambda: fleet.snapshot()["fleet"]["net_disconnects"]
                   > c0["net_disconnects"], timeout=120,
                   what="the disconnect counted")
        wait_until(lambda: len(results) >= pre + 4, timeout=300,
                   what="progress during the outage")
        proxies[0].heal()
        wait_until(lambda: fleet.snapshot()["replica_states"] == ["up", "up"]
                   and fleet.replicas[0].engine.ping(timeout=2.0),
                   timeout=300, what="the victim back up")
        stop.set()
        for t in threads:
            t.join(timeout=300)
        assert not failures, failures[:3]
        c1 = fleet.snapshot()["fleet"]
        assert c1["rerouted"] + c1["yanked"] > c0["rerouted"] + c0["yanked"]
        p = rand_prompt(5, 10)
        assert fleet.submit(p, 4, 0.0, timeout=300) == [_solo(pm, p, 4)]
    finally:
        stop.set()
        fleet.close()
        for px in proxies.values():
            px.close()
