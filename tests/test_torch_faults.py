"""The port's fault harness (serving/faults.py) against the reference's:
the same plans give the same fault schedules call by call, the scripted
health source delivers the same events, and install_engine_faults wraps
the port's engine seams (the drafter's is `_draft_fn`) with the
reference's containment results: a poison prompt fails only its ticket,
a transient step fault is absorbed by retry, a persistent one fails the
active row and the supervisor restores the engine, slow steps delay
without corrupting, the fused block and tier-load seams fail cleanly,
and the injector's counters ride the engine's /metrics.  Then the
netem proxy on the real socket path: corrupt bytes cost one connection
and a half-open link is detected by heartbeats.
"""

import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import PAGE, draw_params, port_model, rand_prompt
from conftest import wait_until
from container_engine_accelerators_tpu.serving import faults as ref_faults
from container_engine_accelerators_tpu_torch.models import generate as G
from container_engine_accelerators_tpu_torch.serving import (
    ContinuousBatchingEngine, EngineSupervisor,
)
from container_engine_accelerators_tpu_torch.serving import faults as F
from container_engine_accelerators_tpu_torch.serving import observe, rpc
from container_engine_accelerators_tpu_torch.serving.errors import (
    StepFailure,
)
from container_engine_accelerators_tpu_torch.serving.worker import (
    WorkerServer,
)

POISON = 61


def _consults(mod, plan_kw, calls=40):
    inj = mod.FaultInjector(seed=7)
    inj.plan("seam", **plan_kw)
    fn = inj.wrap("seam", lambda *a: "ran")
    out = []
    for i in range(calls):
        arg = np.array([[POISON if i % 3 == 0 else 1, 2]], np.int32)
        try:
            out.append(fn(arg))
        except mod.InjectedFault as e:
            out.append(("fault", e.seam, e.call_index))
    return out, inj.stats()


@pytest.mark.parametrize("plan_kw", [
    {"fail_calls": [0, 3, 17]},
    {"fail_after": 5, "fail_n": 4},
    {"fail_rate": 0.3},
    {"match": "poison", "fail_n": 5},
    {"match": "poison", "fail_calls": [3, 4, 6]},
    {"slow_s": 0.001, "slow_calls": [1, 2]},
], ids=["calls", "window", "rate", "match", "match_calls", "slow"])
def test_schedules_match_the_reference(plan_kw):
    def kw(mod):
        if plan_kw.get("match") == "poison":
            return {**plan_kw, "match": mod.poison_prompt_match(POISON)}
        return plan_kw

    got = _consults(F, kw(F))
    want = _consults(ref_faults, kw(ref_faults))
    assert got == want
    assert got[1]["seam"]["calls"] == 40


def test_scripted_event_source_matches_the_reference():
    def script(mod):
        src = mod.ScriptedEventSource(names=["gpu0", "gpu1"])
        src.chip_loss(1)
        src.host_error()
        src.recover_chip(1)
        src.wait_error_next()
        out = []
        for _ in range(5):
            try:
                e = src.wait(10)
            except RuntimeError as err:
                out.append(str(err))
                continue
            out.append(None if e is None else (
                e.device_index, e.error_code, e.is_host_event))
        src.recover()
        return out, src.device_names(), src.recover_calls, src.sdk_state()

    assert script(F) == script(ref_faults)
    assert (F.HBM_UNCORRECTABLE_ECC, F.ICI_LINK_FATAL, F.ERROR_CLEARED) == (
        1, 2, 0)


# -- the port's engine seams -------------------------------------------------
@pytest.fixture(scope="module")
def pm():
    return port_model(draw_params(0))


def _engine(pm, n_slots, **kw):
    kw.setdefault("prompt_grid", 4)
    kw.setdefault("retry_backoff_s", 0.01)
    kw.setdefault("retry_backoff_cap_s", 0.05)
    return ContinuousBatchingEngine(pm, n_slots, device="cpu", **kw)


def _solo(pm, prompt, n):
    return [G.generate_prefill(pm, prompt, prompt.shape[1], n, 0.0,
                               torch.Generator())[0].tolist()]


def _clean(seed, p_len):
    p = rand_prompt(seed, p_len)
    p[p == POISON] = 0
    return p


def test_poison_fails_only_its_ticket(pm):
    eng = _engine(pm, 2)
    inj = F.FaultInjector(seed=0)
    inj.plan("prefill", match=F.poison_prompt_match(POISON), fail_n=100)
    F.install_engine_faults(eng, inj)
    try:
        poison = _clean(1, 5)
        poison[0, 0] = POISON
        clean = _clean(2, 5)
        outs, errs = {}, {}

        def fire(name, p):
            try:
                outs[name] = eng.submit(p, 6, 0.0, timeout=300)
            except Exception as e:  # pylint: disable=broad-except
                errs[name] = e

        threads = [threading.Thread(target=fire, args=("poison", poison)),
                   threading.Thread(target=fire, args=("clean", clean))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert isinstance(errs.get("poison"), F.InjectedFault)
        assert "clean" not in errs, errs
        assert outs["clean"] == _solo(pm, clean, 6)
        snap = eng.snapshot()
        assert snap["admit_failures"] == 1
        assert snap["restarts"] == 0 and snap["rows_failed"] == 0
        assert inj.stats()["prefill"]["injected"] == 1
        outcomes = [t.attrs.get("outcome")
                    for t in eng.observability.traces]
        assert "admit_failed" in outcomes
    finally:
        eng.close()


def test_transient_step_fault_absorbed_by_retry(pm):
    eng = _engine(pm, 2, step_retries=3)
    inj = F.FaultInjector(seed=0)
    inj.plan("decode_step", fail_calls=[1, 2])
    F.install_engine_faults(eng, inj)
    try:
        p = _clean(11, 5)
        assert eng.submit(p, 6, 0.0, timeout=300) == _solo(pm, p, 6)
        snap = eng.snapshot()
        assert snap["step_retries"] == 2 and snap["step_failures"] == 0
        assert snap["rows_failed"] == 0 and snap["restarts"] == 0
    finally:
        eng.close()


def test_persistent_step_fault_contained_and_restored(pm):
    eng = _engine(pm, 1, step_retries=1)
    sup = EngineSupervisor(eng, max_restarts=3,
                           restart_backoff_s=0.01).start()
    inj = F.FaultInjector(seed=0)
    inj.plan("decode_step", fail_calls=[0, 1])
    F.install_engine_faults(eng, inj)
    res = {}

    def fire(name, p):
        try:
            res[name] = eng.submit(p, 5, 0.0, timeout=300)
        except Exception as e:  # pylint: disable=broad-except
            res[name] = e

    try:
        pa, pb = _clean(21, 4), _clean(22, 4)
        ta = threading.Thread(target=fire, args=("A", pa))
        ta.start()
        # A's failure can follow its admission within a poll's interval,
        # so wait on the admitted counter, not on an active row.
        wait_until(lambda: eng.snapshot()["admitted"] >= 1,
                   what="A admitted")
        tb = threading.Thread(target=fire, args=("B", pb))
        tb.start()
        ta.join(timeout=300)
        tb.join(timeout=300)
        assert isinstance(res["A"], StepFailure), res["A"]
        assert res["B"] == _solo(pm, pb, 5)
        wait_until(lambda: eng.snapshot()["restarts"] >= 1,
                   what="the restart")
        snap = eng.snapshot()
        assert snap["rows_failed"] == 1 and snap["step_failures"] == 1
        pc = _clean(23, 6)
        assert eng.submit(pc, 4, 0.0, timeout=300) == _solo(pm, pc, 4)
    finally:
        sup.stop()
        eng.close()


def test_slow_steps_delay_without_corrupting(pm):
    eng = _engine(pm, 2)
    inj = F.FaultInjector(seed=0)
    inj.plan("decode_step", slow_s=0.05, slow_calls=[0, 1, 2])
    F.install_engine_faults(eng, inj)
    try:
        p = _clean(41, 5)
        t0 = time.perf_counter()
        assert eng.submit(p, 6, 0.0, timeout=300) == _solo(pm, p, 6)
        assert time.perf_counter() - t0 >= 0.15
        assert inj.stats()["decode_step"]["slowed"] == 3
    finally:
        eng.close()


def test_fused_block_fault_absorbed_and_counted_on_metrics(pm):
    eng = _engine(pm, 2, decode_steps=4, step_retries=2)
    inj = F.FaultInjector(seed=0)
    inj.plan("decode_fused", fail_calls=[0])
    F.install_engine_faults(eng, inj)
    try:
        p = _clean(51, 5)
        assert eng.submit(p, 12, 0.0, timeout=300) == _solo(pm, p, 12)
        assert inj.stats()["decode_fused"]["injected"] == 1
        text = eng.observability.registry.render()
        parsed = observe.parse_text(text)
        assert parsed["serve_fault_injected_total"][
            '{seam="decode_fused"}'] == 1.0
        assert parsed["serve_fault_calls_total"]['{seam="prefill"}'] >= 1.0
    finally:
        eng.close()


def test_tier_load_fault_recomputes_the_ticket(pm, tmp_path):
    # A disk promotion whose load fails: the store drops the entry and
    # the admission recomputes; the ticket never fails.
    eng = _engine(pm, 2, page_size=PAGE, prefill_chunk=PAGE, kv_pages=12,
                  kv_disk_dir=str(tmp_path), tier_recompute_tok_s=1e-3)
    inj = F.FaultInjector(seed=0)
    inj.plan("tier_load", fail_after=0, fail_n=10 ** 6)
    F.install_engine_faults(eng, inj)
    try:
        first = _clean(61, 4 * PAGE + 1)
        want = eng.submit(first, 3, 0.0, timeout=300)
        for s in range(4):  # pool pressure demotes the first prompt
            eng.submit(_clean(70 + s, 4 * PAGE + 1), 2, 0.0, timeout=300)
        assert eng.snapshot()["kv_tier_demoted_pages"] > 0
        assert eng.submit(first, 3, 0.0, timeout=300) == want
        assert inj.stats()["tier_load"]["calls"] >= 1
        assert eng.snapshot()["admit_failures"] == 0
    finally:
        eng.close()


# -- the netem proxy on the real socket path ---------------------------------
def _served_tcp(pm):
    eng = _engine(pm, 2, page_size=PAGE, prefill_chunk=PAGE)
    bind = f"127.0.0.1:{rpc.free_tcp_port()}"
    server = WorkerServer(bind).start()
    server.set_engine(eng)
    return eng, server, bind


def _client(endpoint, **kw):
    sock = rpc.make_client_socket(endpoint, 10.0)
    rpc.send_frame(sock, {"op": "hello", "proto": rpc.PROTO_VERSION})
    header, _ = rpc.recv_frame(sock)
    assert header["op"] == "ready", header
    return rpc.WorkerClient(sock, label="netem-test", **kw)


def test_corrupt_bytes_kill_one_connection_not_the_worker(pm):
    eng, server, bind = _served_tcp(pm)
    proxy = F.NetemProxy(bind, corrupt_rate=1.0, seed=3)
    lost = threading.Event()
    try:
        bad = _client(bind)  # handshake on the clean path, then via proxy
        bad.close()
        sock = rpc.make_client_socket(proxy.endpoint, 10.0)
        rpc.send_frame(sock, {"op": "hello", "proto": rpc.PROTO_VERSION})
        sock.settimeout(10)
        try:
            data = sock.recv(1 << 16)
            while data:
                data = sock.recv(1 << 16)
        except (ConnectionResetError, socket.timeout):
            pass
        sock.close()
        assert proxy.stats["corrupted"] >= 1
        good = _client(bind, on_lost=lambda why: lost.set())
        p = _clean(81, 6)
        assert good.submit_nowait(p, 4).wait(120) == _solo(pm, p, 4)
        assert not lost.is_set()
        good.close()
    finally:
        proxy.close()
        server.drain_and_close(timeout_s=2)
        eng.close()


def test_half_open_link_detected_by_heartbeats(pm):
    eng, server, bind = _served_tcp(pm)
    proxy = F.NetemProxy(bind, latency_s=0.001, jitter_s=0.001, seed=1)
    lost, why = threading.Event(), []
    try:
        client = _client(proxy.endpoint, heartbeat_s=0.2,
                         heartbeat_timeout_s=1.0,
                         on_lost=lambda w: (why.append(w), lost.set()))
        assert client.ping(timeout=10)
        p = _clean(82, 6)
        assert client.submit_nowait(p, 3).wait(120) == _solo(pm, p, 3)
        proxy.half_open()
        assert lost.wait(timeout=60), "the half-open link was never seen"
        assert client.lost_dirty and "heartbeat" in why[0]
        client.close()
    finally:
        proxy.close()
        server.drain_and_close(timeout_s=2)
        eng.close()


def test_proxy_partition_refuses_then_heals():
    stop = threading.Event()
    listener = rpc.make_listener(f"127.0.0.1:{rpc.free_tcp_port()}",
                                 accept_poll_s=0.1)
    port = listener.getsockname()[1]

    def echo():
        while not stop.is_set():
            try:
                s, _ = listener.accept()
            except (socket.timeout, OSError):
                continue
            data = s.recv(64)
            s.sendall(data)
            s.close()

    t = threading.Thread(target=echo, daemon=True)
    t.start()
    proxy = F.NetemProxy(f"127.0.0.1:{port}", seed=random.Random(0).randint(
        0, 9))
    try:
        def roundtrip():
            s = rpc.make_client_socket(proxy.endpoint, 5.0)
            try:
                s.sendall(b"ping")
                return s.recv(64)
            except OSError:
                return b""
            finally:
                s.close()

        assert roundtrip() == b"ping"
        proxy.partition()
        assert roundtrip() == b""
        wait_until(lambda: proxy.stats["refused"] >= 1, what="a refusal")
        proxy.heal()
        assert roundtrip() == b"ping"
    finally:
        proxy.close()
        stop.set()
        listener.close()
