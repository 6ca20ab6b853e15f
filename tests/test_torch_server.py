"""The port's HTTP server (container_engine_accelerators_tpu_torch/
server.py) end to end on the CPU at a tiny width (dim 32, depth 1,
vocab 64, max_seq 32): the reference's HTTP contract as its own suites
hold it (tests/test_serving_demo.py, the server cases of
test_tracing.py and test_fault_injection.py) against the port's server,
plus the health watch, the process entry point (--port 0, SIGTERM,
SIGQUIT) and the flags that exit 2.

Saturation, timeouts and drains are held deterministically: a seam
(the engine's decode step, the wave batcher's group runner) waits on an
Event, so the engine stands still while the test reads its state;
nothing here waits on a sleep for an outcome."""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu_torch import server as S
from container_engine_accelerators_tpu_torch.models import generate as G
from container_engine_accelerators_tpu_torch.models import (
    quant_generate as QG,
)
from container_engine_accelerators_tpu_torch.serving.observe import (
    parse_text,
)

# The suite may run under several xdist workers: keep torch's CPU
# thread pool small so they do not oversubscribe the cores.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "transformer_lm", "--dim", "32", "--depth", "1",
        "--vocab", "64", "--max-seq", "32", "--device", "cpu"]
VOCAB = 64


# -- plumbing --------------------------------------------------------------
def _get(port, path, headers=None, timeout=10):
    """(code, headers, body), for any status."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _post(port, body, path="/generate", timeout=120):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _post_error(port, body, path="/generate", timeout=60):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, body, path, timeout)
    return e.value


class Booted:
    """A ServingApp behind a Server on 127.0.0.1:<free port>, loaded
    through load_model, /healthz answering 503 "loading" before it."""

    def __init__(self, *flags, model=None):
        self.app = S.ServingApp(S.parse_args([*TINY, *flags]))
        self.httpd = self.app.make_server("127.0.0.1", 0)
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.port = self.httpd.server_address[1]
        code, _, body = _get(self.port, "/healthz")
        assert (code, body) == (503, b"loading")
        self.app.load_model(model=model)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.app.close()


@pytest.fixture
def booted():
    made = []

    def boot(*flags, model=None):
        made.append(Booted(*flags, model=model))
        return made[-1]

    yield boot
    for b in made:
        b.close()


class Hold:
    """Make `obj.attr` (a device seam) wait on `gate` until release():
    `entered` is set once a call is held."""

    def __init__(self, obj, attr):
        self.gate, self.entered = threading.Event(), threading.Event()
        self._obj, self._attr = obj, attr
        self._real = real = getattr(obj, attr)

        def held(*a, **k):
            if not self.gate.is_set():
                self.entered.set()
                self.gate.wait(120)
            return real(*a, **k)

        setattr(obj, attr, held)

    def release(self):
        self.gate.set()
        setattr(self._obj, self._attr, self._real)


def _wait_for(cond, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


class Fire:
    """POST `body` on a thread: `.out` the JSON answer, or `.err`."""

    def __init__(self, port, body):
        self.out = self.err = None
        self._t = threading.Thread(target=self._run, args=(port, body))
        self._t.start()

    def _run(self, port, body):
        try:
            self.out = _post(port, body)
        except Exception as e:  # pylint: disable=broad-except
            self.err = e

    def join(self, timeout=120):
        self._t.join(timeout)
        assert not self._t.is_alive(), "request never answered"
        return self


# -- the classifier --------------------------------------------------------
@pytest.fixture(scope="module")
def vision_server():
    b = Booted("--model", "resnet18", "--image-size", "32", "--batch", "2",
               "--classes", "10")
    yield b
    b.close()


class TestServingDemo:
    def test_ready_after_load(self, vision_server):
        code, _, body = _get(vision_server.port, "/healthz")
        assert (code, body) == (200, b"ok")

    def test_predict_round_trip(self, vision_server):
        batch = np.random.default_rng(0).random((2, 32, 32, 3)).astype(
            np.float32)
        out = _post(vision_server.port, batch.tobytes(), path="/predict")
        assert len(out["labels"]) == 2
        assert all(0 <= lab < 10 for lab in out["labels"])
        # The labels are the served model's own eval forward.
        model = vision_server.app.model
        with torch.inference_mode():
            want = model(torch.from_numpy(batch), train=False).argmax(-1)
        assert out["labels"] == want.tolist()

    def test_unknown_path_404(self, vision_server):
        assert _get(vision_server.port, "/nope")[0] == 404


# -- the wave batcher ------------------------------------------------------
@pytest.fixture(scope="module")
def wave():
    b = Booted("--engine", "wave")
    yield b
    b.close()


class HeldBatcher:
    """The wave worker held inside a blocker group: requests posted
    meanwhile queue, and coalesce when released."""

    def __init__(self, app):
        self.batcher = app.batcher
        self.hold = Hold(self.batcher, "_run_group")
        self._blocker = threading.Thread(
            target=self.batcher.submit,
            args=(np.ones((1, 2), np.int32), 2, 0.0), kwargs={"timeout": None})
        self._blocker.start()
        assert self.hold.entered.wait(60)

    def queued(self):
        with self.batcher._cv:
            return len(self.batcher._queue)

    def release(self):
        self.hold.release()
        self._blocker.join(60)
        assert not self._blocker.is_alive()


class TestServingDemoLM:
    def test_generate_round_trip(self, wave):
        out = _post(wave.port, {"prompt": [[1, 2, 3]], "max_new": 4})
        assert "trace_id" not in out  # the wave path records no spans
        assert len(out["tokens"]) == 1 and len(out["tokens"][0]) == 4
        assert all(0 <= t < VOCAB for t in out["tokens"][0])

    def test_malformed_generate_requests_get_400(self, wave):
        bad = [
            b"not json",
            json.dumps({"max_new": 4}).encode(),  # no prompt
            json.dumps({"prompt": [[]]}).encode(),  # empty
            json.dumps({"prompt": [[1, 2], [3]]}).encode(),  # ragged
            json.dumps({"prompt": [[1]], "max_new": 99}).encode(),
            json.dumps({"prompt": [[999]], "max_new": 2}).encode(),
            json.dumps({"prompt": [[1]] * 65, "max_new": 2}).encode(),
            json.dumps({"prompt": [[1]], "max_new": 0}).encode(),
            # Fits max_seq (17 + 15 = 32), but no bucket pair does.
            json.dumps({"prompt": [[1] * 17], "max_new": 15}).encode(),
        ]
        for payload in bad:
            e = _post_error(wave.port, payload)
            assert e.code == 400, payload
            assert "error" in json.loads(e.read())

    def test_concurrent_generate_requests(self, wave):
        fires = [
            Fire(wave.port, {"prompt": [[1 + i, 2, 3][: 2 + (i % 2)]],
                             "max_new": 3 + (i % 3),
                             "temperature": 0.0 if i % 2 else 0.7})
            for i in range(8)
        ]
        for i, f in enumerate(fires):
            f.join()
            assert f.err is None, f.err
            assert len(f.out["tokens"][0]) == 3 + (i % 3)
            assert all(0 <= t < VOCAB for t in f.out["tokens"][0])

    def test_concurrent_same_bucket_requests_coalesce(self, wave):
        # 16 requests of one bucket, queued while the worker is held,
        # decode as one group with per-row lengths and temperatures.
        app = wave.app
        held = HeldBatcher(app)
        before = dict(app.batcher.stats)
        try:
            fires = [
                Fire(wave.port, {"prompt": [[1 + i, 2, 3, 4][: 2 + (i % 3)]],
                                 "max_new": 4,
                                 "temperature": 0.0 if i % 2 else 0.9})
                for i in range(16)
            ]
            _wait_for(lambda: held.queued() == 16, "16 queued requests")
        finally:
            held.release()
        for f in fires:
            f.join()
            assert f.err is None, f.err
            assert len(f.out["tokens"][0]) == 4
            assert all(0 <= t < VOCAB for t in f.out["tokens"][0])
        _, _, body = _get(wave.port, "/statz")
        stats = json.loads(body)
        assert stats["requests"] - before["requests"] == 17  # + blocker
        assert stats["groups"] - before["groups"] == 2, stats
        assert stats["max_group_rows"] >= 16, stats

    def test_group_mixes_max_new_and_multirow_requests(self, wave):
        # Different max_new (one n_bucket) and row counts share a group;
        # each answer is sliced to its own rows and token count.
        app = wave.app
        held = HeldBatcher(app)
        before = dict(app.batcher.stats)
        reqs = [{"prompt": [[1, 2]], "max_new": 3},
                {"prompt": [[3, 4], [5, 6]], "max_new": 5},
                {"prompt": [[7]], "max_new": 2}]
        try:
            fires = [Fire(wave.port, r) for r in reqs]
            _wait_for(lambda: held.queued() == 3, "3 queued requests")
        finally:
            held.release()
        outs = [f.join().out for f in fires]
        assert [len(r) for r in outs[1]["tokens"]] == [5, 5]
        assert [len(r) for r in outs[0]["tokens"]] == [3]
        assert [len(r) for r in outs[2]["tokens"]] == [2]
        assert app.batcher.stats["groups"] - before["groups"] == 2
        for out in outs:
            for row in out["tokens"]:
                assert all(0 <= t < VOCAB for t in row)

    def test_request_timeout_answers_500(self, wave):
        # A wedged decode answers 500 at the request deadline, and the
        # timed-out request leaves the queue; a companion of the same
        # shape queued ahead of it stays and is served.
        app = wave.app
        held = HeldBatcher(app)
        companion = {}
        waiter = threading.Thread(target=lambda: companion.update(
            out=app.batcher.submit(np.full((1, 2), 3, np.int32), 2, 0.0,
                                   timeout=None)))
        waiter.start()
        _wait_for(lambda: held.queued() == 1, "the companion queued")
        app.batcher.timeout_s = 0.2
        try:
            e = _post_error(wave.port, {"prompt": [[1, 2]], "max_new": 2})
            assert e.code == 500
            assert b"timed out" in e.read()
            assert held.queued() == 1
        finally:
            app.batcher.timeout_s = app.cfg.request_timeout_s
            held.release()
        waiter.join(60)
        assert not waiter.is_alive() and companion["out"].shape == (1, 2)

    def test_quant_auto_policy_picks_by_batch(self):
        assert S.pick_quant(1, "auto", 16) and S.pick_quant(16, "auto", 16)
        assert not S.pick_quant(32, "auto", 16)
        assert S.pick_quant(64, "on", 16)
        assert not S.pick_quant(1, "off", 16)

    def test_top_k_top_p_and_stop_token(self, wave):
        port = wave.port
        greedy = _post(port, {"prompt": [[1, 2, 3]], "max_new": 5})
        k1 = _post(port, {"prompt": [[1, 2, 3]], "max_new": 5,
                          "temperature": 4.0, "top_k": 1})
        assert k1["tokens"] == greedy["tokens"]  # top_k 1 is greedy
        p = _post(port, {"prompt": [[1, 2, 3]], "max_new": 4,
                         "temperature": 1.0, "top_p": 0.5})
        assert all(0 <= t < VOCAB for t in p["tokens"][0])
        row = greedy["tokens"][0]
        stop = row[2]
        cut = _post(port, {"prompt": [[1, 2, 3]], "max_new": 5,
                           "stop_token": stop})
        assert cut["tokens"][0] == row[: row.index(stop)]
        for bad in ({"top_k": 0}, {"top_p": 0.0}, {"top_p": 1.5},
                    {"stop_token": VOCAB}):
            e = _post_error(port, {"prompt": [[1]], "max_new": 2, **bad})
            assert e.code == 400, bad

    def test_bucket_ladder_is_finite_and_respects_bounds(self, wave):
        shapes = set()
        for p_len in range(1, 32):
            for max_new in range(1, 32 - p_len + 1):
                try:
                    p_b, n_b = wave.app.pick_buckets(p_len, max_new)
                except ValueError as e:
                    assert "leaves no room" in str(e)
                    continue
                assert p_b >= p_len and n_b >= max_new and p_b + n_b <= 32
                shapes.add((p_b, n_b))
        assert len(shapes) <= 8, shapes

    def test_predict_unavailable_in_lm_mode(self, wave):
        e = _post_error(wave.port, b"\0" * 16, path="/predict")
        assert e.code == 503
        assert int(e.headers["Retry-After"]) >= 1

    def test_tracez_absent_on_the_wave_path(self, wave):
        assert _get(wave.port, "/tracez")[0] == 404


# -- the continuous engine -------------------------------------------------
@pytest.fixture(scope="module")
def cb():
    b = Booted("--slots", "4")
    yield b
    b.close()


class TestServingDemoLMContinuous:
    def test_round_trip_and_statz(self, cb):
        assert cb.app.engine is not None and cb.app.batcher is None
        out = _post(cb.port, {"prompt": [[1, 2, 3]], "max_new": 4})
        assert len(out["tokens"]) == 1 and len(out["tokens"][0]) == 4
        assert all(0 <= t < VOCAB for t in out["tokens"][0])
        stats = json.loads(_get(cb.port, "/statz")[2])
        # Admissions and retirements balance: the warm-up and this one.
        assert stats["retired"] == stats["admitted"] >= 2
        assert stats["steps"] >= 1
        assert stats["server_state"] == "serving"

    def test_tight_fit_request_admitted(self, cb):
        # 17 + 15 = 32: the wave ladder answers 400, the continuous
        # engine (slot == position) serves it.
        out = _post(cb.port, {"prompt": [[1] * 17], "max_new": 15})
        assert len(out["tokens"][0]) == 15

    def test_stop_token_trims_and_matches_greedy(self, cb):
        base = _post(cb.port, {"prompt": [[1, 2, 3]], "max_new": 6})[
            "tokens"][0]
        assert len(set(base)) > 1, base  # a cut must mean something
        stop = base[2]
        before = cb.app.engine.snapshot()["steps"]
        cut = _post(cb.port, {"prompt": [[1, 2, 3]], "max_new": 6,
                              "stop_token": stop})["tokens"][0]
        assert cut == base[: base.index(stop)]
        # The row retired early: fewer steps than max_new ran.
        assert cb.app.engine.snapshot()["steps"] - before < 6

    def test_concurrent_mixed_shapes(self, cb):
        fires = [
            Fire(cb.port, {"prompt": [[1 + i, 2, 3][: 2 + (i % 2)]],
                           "max_new": 3 + (i % 3),
                           "temperature": 0.0 if i % 2 else 0.7})
            for i in range(8)
        ]
        for i, f in enumerate(fires):
            f.join()
            assert f.err is None, f.err
            assert len(f.out["tokens"][0]) == 3 + (i % 3)

    def test_greedy_tokens_are_the_oracle(self, cb):
        # The served greedy row is the port's solo oracle on the served
        # model (bf16 on both sides).
        prompt = [[5, 9, 2, 7]]
        out = _post(cb.port, {"prompt": prompt, "max_new": 6})
        want = G.generate_prefill(cb.app.model, np.asarray(prompt), 4, 6,
                                  0.0, torch.Generator())
        assert out["tokens"] == want.tolist()


class TestServingMetricsEndpoint:
    def _scrape(self, port):
        code, headers, body = _get(port, "/metrics")
        assert code == 200
        assert headers["Content-Type"].startswith("text/plain")
        return parse_text(body.decode())

    def _generate(self, port):
        return _post(port, {"prompt": [[1, 2, 3]], "max_new": 4})

    def test_text_format_parses_with_expected_families(self, cb):
        self._generate(cb.port)
        parsed = self._scrape(cb.port)
        for family in (
            "serve_ttft_seconds_bucket", "serve_itl_seconds_bucket",
            "serve_queue_wait_seconds_bucket",
            "serve_prefill_chunk_seconds_bucket",
            "serve_commit_lag_seconds_bucket",
            "serve_engine_admitted_total", "serve_engine_retired_total",
            "serve_engine_queue_depth", "serve_http_requests_total",
            "serve_server_state", "serve_inflight_requests",
        ):
            assert family in parsed, family
        assert parsed["serve_server_state"]['{state="serving"}'] == 1.0
        assert parsed["serve_server_state"]['{state="draining"}'] == 0.0

    def test_openmetrics_on_request(self, cb):
        self._generate(cb.port)
        code, headers, body = _get(
            cb.port, "/metrics",
            headers={"Accept": "application/openmetrics-text"})
        assert code == 200
        assert headers["Content-Type"].startswith(
            "application/openmetrics-text")
        assert body.decode().rstrip().endswith("# EOF")

    def test_counter_monotonicity_across_requests(self, cb):
        before = self._scrape(cb.port)
        self._generate(cb.port)
        self._generate(cb.port)
        after = self._scrape(cb.port)
        route = '{route="generate",code="200"}'
        assert (after["serve_http_requests_total"][route]
                == before["serve_http_requests_total"].get(route, 0.0) + 2)
        assert (after["serve_engine_retired_total"][""]
                == before["serve_engine_retired_total"][""] + 2)
        for name, series in before.items():
            if name.endswith("_total"):
                for labels, v in series.items():
                    assert after[name][labels] >= v, (name, labels)

    def test_histogram_bucket_sums_consistent(self, cb):
        self._generate(cb.port)
        parsed = self._scrape(cb.port)

        def le_of(labels):
            v = labels.split('le="', 1)[1].split('"', 1)[0]
            return float(v.replace("+Inf", "inf"))

        for family in ("serve_ttft_seconds", "serve_itl_seconds"):
            ordered = sorted(parsed[f"{family}_bucket"].items(),
                             key=lambda kv: le_of(kv[0]))
            counts = [v for _, v in ordered]
            assert counts == sorted(counts), family
            assert le_of(ordered[-1][0]) == float("inf")
            assert counts[-1] == parsed[f"{family}_count"][""]
            assert parsed[f"{family}_sum"][""] >= 0.0

    def test_metrics_served_while_draining(self, cb):
        app = cb.app
        app.begin_drain("shutdown")
        try:
            code, headers, body = _get(cb.port, "/healthz")
            assert (code, body) == (503, b"draining: shutdown")
            assert int(headers["Retry-After"]) >= 1
            parsed = self._scrape(cb.port)
            assert parsed["serve_server_state"]['{state="draining"}'] == 1.0
            assert parsed["serve_drain_reason"]['{reason="shutdown"}'] == 1.0
        finally:
            app.end_drain("shutdown")
        assert self._scrape(cb.port)["serve_server_state"][
            '{state="serving"}'] == 1.0

    def test_statz_deprecated_alias_matches_registry(self, cb):
        self._generate(cb.port)
        code, headers, body = _get(cb.port, "/statz")
        assert code == 200 and headers["Deprecation"] == "true"
        assert "/metrics" in headers["Link"]
        stats = json.loads(body)
        parsed = self._scrape(cb.port)
        for key in ("admitted", "retired", "steps"):
            assert parsed[f"serve_engine_{key}_total"][""] >= stats[key], key


class TestServerTracez:
    def test_generate_returns_trace_id_and_tracez_serves_it(self, booted):
        b = booted("--slots", "2")
        out = _post(b.port, {"prompt": [[1, 2, 3, 4, 5, 6, 7, 8]],
                             "max_new": 4})
        assert len(out["tokens"][0]) == 4
        tid = out.get("trace_id")
        assert tid, "no server-assigned trace_id in the response"
        code, _, body = _get(b.port, "/tracez", timeout=30)
        tz = json.loads(body)
        assert code == 200
        assert tid in {r["trace_id"] for r in tz["recent"]}
        assert "queue" in tz["stages"] and "decode" in tz["stages"]
        assert tz["slowest"] and tz["total"] >= 2  # + the warm-up


# -- the int8 wave path ----------------------------------------------------
class TestServingDemoLMQuant:
    def test_generate_round_trip_quant(self, booted, monkeypatch):
        b = booted("--quant", "on", "--engine", "wave")
        app = b.app
        assert app.qparams is not None and app.deq is not None
        # The twin was built at load: no group dequantizes again.
        calls = []
        real = QG.dequantize_decode_params
        monkeypatch.setattr(QG, "dequantize_decode_params",
                            lambda *a: calls.append(1) or real(*a))
        body = {"prompt": [[1, 2, 3]], "max_new": 4}
        outs = [_post(b.port, body)["tokens"] for _ in range(2)]
        assert calls == []
        assert outs[0] == outs[1]  # deterministic greedy
        assert len(outs[0][0]) == 4
        want = QG.generate_prefill_quant(
            app.model, np.asarray(body["prompt"]), 3, 4, 0.0,
            torch.Generator(), qparams=app.qparams, deq=app.deq)
        assert outs[0] == want.tolist()


# -- checkpoints -----------------------------------------------------------
class TestServeFromCheckpoint:
    def test_served_generation_uses_trained_params(self, tmp_path, booted):
        # The port's trainer writes checkpoint_4; the server restores its
        # parameters and serves them.
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
        run = subprocess.run(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.lm_main",
             "--seq-len", "32", "--batch", "2", "--dim", "32", "--depth",
             "1", "--vocab", "64", "--heads", "2", "--train-steps", "3",
             "--log-every", "1", "--device", "cpu", "--model-dir",
             str(tmp_path)],
            capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
        )
        assert run.returncode == 0, run.stderr
        b = booted("--heads", "2", "--checkpoint", str(tmp_path))
        served = _post(b.port, {"prompt": [[1, 2, 3]], "max_new": 4})[
            "tokens"]
        from container_engine_accelerators_tpu_torch.utils import (
            checkpoint as C,
        )

        trained = G.make_decoder(vocab=64, dim=32, depth=1, heads=2,
                                 max_seq=32, device="cpu")
        assert C.restore_params(str(tmp_path), trained) is not None
        fresh = G.make_decoder(vocab=64, dim=32, depth=1, heads=2,
                               max_seq=32, device="cpu")
        fresh.init_random(torch.Generator().manual_seed(0))
        served_params = dict(b.app.model.named_parameters())
        for name, p in trained.named_parameters():
            assert torch.equal(served_params[name], p), name
        assert not torch.equal(b.app.model.head_kernel, fresh.head_kernel)
        want = G.generate_prefill(trained, np.asarray([[1, 2, 3]]), 3, 4,
                                  0.0, torch.Generator())
        assert served == want.tolist()

    def test_missing_checkpoint_fails_load(self, tmp_path):
        app = S.ServingApp(S.parse_args(
            [*TINY, "--checkpoint", str(tmp_path / "empty")]))
        with pytest.raises(RuntimeError, match="contains no checkpoint"):
            app.load_model()
        assert app.server_state() == "loading"


# -- saturation, health and the drain --------------------------------------
@pytest.fixture(scope="module")
def chaos():
    # One slot and a queue bound of one (the bound is clamped up to
    # --max-gen-batch, so that is 1 too).
    b = Booted("--slots", "1", "--max-queue", "1", "--max-gen-batch", "1",
               "--retry-backoff-ms", "5")
    yield b
    b.close()


class TestServerSaturation:
    def test_queue_full_answers_429_with_retry_after(self, chaos):
        app = chaos.app
        eng = app.engine
        before = eng.snapshot()
        hold = Hold(eng, "_decode_fn")
        try:
            a = Fire(chaos.port, {"prompt": [[1, 2, 3]], "max_new": 6})
            assert hold.entered.wait(60)  # A decodes in the one slot
            b = Fire(chaos.port, {"prompt": [[4, 5, 6]], "max_new": 6})
            _wait_for(lambda: eng.queue_depth == 1, "B queued")
            e = _post_error(chaos.port, {"prompt": [[7, 8]], "max_new": 2})
            assert e.code == 429
            assert int(e.headers["Retry-After"]) >= 1
            assert "queue is full" in json.loads(e.read())["error"]
        finally:
            hold.release()
        for f in (a.join(), b.join()):
            assert f.err is None, f.err
            assert len(f.out["tokens"][0]) == 6
        snap = eng.snapshot()
        assert snap["queue_peak"] <= 1  # the bound held
        assert snap["queue_rejected"] - before["queue_rejected"] == 1
        parsed = parse_text(_get(chaos.port, "/metrics")[2].decode())
        assert parsed["serve_http_requests_total"][
            '{route="generate",code="429"}'] >= 1

    def test_statz_reports_server_state_and_resilience_counters(self, chaos):
        stats = json.loads(_get(chaos.port, "/statz")[2])
        assert stats["server_state"] == "serving"
        for key in ("admitted", "retired", "queue_rejected",
                    "admit_failures", "step_retries", "rows_failed",
                    "restarts", "queue_depth", "active_rows"):
            assert key in stats, key


class _Event:
    def __init__(self, code, idx=-1, host=False):
        self.error_code, self.device_index = code, idx
        self.is_host_event = host


class ScriptedSource:
    """A health event source the test drives: push() hands the watch an
    event and returns once the watch has applied it (it is back in
    wait()); fail_next_wait() makes the next wait raise."""

    def __init__(self):
        self._q = queue.Queue()
        self._cv = threading.Condition()
        self.waits = self.pushed = self.delivered = 0
        self.waits_at_delivery = 0
        self.recover_calls = 0
        self._fail = False

    def wait(self, ms):
        with self._cv:
            self.waits += 1
            self._cv.notify_all()
            if self._fail:
                self._fail = False
                raise RuntimeError("scripted wait error")
        try:
            event = self._q.get(timeout=ms / 1e3)
        except queue.Empty:
            return None
        with self._cv:
            self.delivered += 1
            self.waits_at_delivery = self.waits
        return event

    def recover(self):
        with self._cv:
            self.recover_calls += 1
            self._cv.notify_all()

    def push(self, event):
        with self._cv:
            self.pushed += 1
        self._q.put(event)
        with self._cv:
            assert self._cv.wait_for(
                lambda: self.delivered == self.pushed
                and self.waits > self.waits_at_delivery, timeout=60)

    def fail_next_wait(self):
        with self._cv:
            self._fail = True
            calls = self.recover_calls
            assert self._cv.wait_for(
                lambda: self.recover_calls > calls, timeout=60)


class TestHealthGatedDegradation:
    def test_chip_loss_drains_and_recovery_restores(self, chaos):
        app, port = chaos.app, chaos.port
        src = ScriptedSource()
        watch = app.attach_health_source(src)
        try:
            assert _get(port, "/healthz")[0] == 200
            src.push(_Event(1, idx=0))  # critical: a chip lost
            code, headers, body = _get(port, "/healthz")
            assert (code, body) == (503, b"draining: device-health")
            assert int(headers["Retry-After"]) >= 1
            e = _post_error(port, {"prompt": [[1, 2]], "max_new": 2})
            assert e.code == 503 and int(e.headers["Retry-After"]) >= 1
            # A second bad chip holds the drain after the first recovers.
            src.push(_Event(2, idx=1))
            src.push(_Event(0, idx=0))
            assert _get(port, "/healthz")[0] == 503
            src.push(_Event(0, idx=1))
            assert _get(port, "/healthz")[0] == 200
            out = _post(port, {"prompt": [[1, 2, 3]], "max_new": 3})
            assert len(out["tokens"][0]) == 3
            # A code outside the critical set is ignored; a host-wide
            # event drains whatever its code; a clear of every chip
            # (index -1) restores.
            src.push(_Event(7, idx=0))
            assert _get(port, "/healthz")[0] == 200
            src.push(_Event(7, host=True))
            assert _get(port, "/healthz")[0] == 503
            src.push(_Event(0))
            assert _get(port, "/healthz")[0] == 200
            # A failing wait recovers the source and keeps watching.
            src.fail_next_wait()
            src.push(_Event(1000, idx=2))
            assert _get(port, "/healthz")[0] == 503
        finally:
            watch.stop()  # releases the drain it holds
        assert _get(port, "/healthz")[0] == 200
        assert app.server_state() == "serving"


class TestShutdownDrain:
    def test_drain_finishes_in_flight_and_rejects_new(self, chaos):
        app, port = chaos.app, chaos.port
        hold = Hold(app.engine, "_decode_fn")
        done = {}
        drainer = threading.Thread(
            target=lambda: done.setdefault(
                "idle", app.drain_for_shutdown(httpd=None, timeout=60)))
        try:
            a = Fire(port, {"prompt": [[5, 6, 7]], "max_new": 12})
            assert hold.entered.wait(60)  # A is decoding
            drainer.start()
            _wait_for(lambda: "shutdown" in app.draining(), "the drain")
            code, _, body = _get(port, "/healthz")
            assert (code, body) == (503, b"draining: shutdown")
            e = _post_error(port, {"prompt": [[1]], "max_new": 2})
            assert e.code == 503 and int(e.headers["Retry-After"]) >= 1
            assert _get(port, "/metrics")[0] == 200
            assert not app.idle()  # A is still in flight
        finally:
            hold.release()
        try:
            a.join()
            drainer.join(120)
            assert not drainer.is_alive()
            # In-flight work finished normally: a drain never errors it.
            assert a.err is None, a.err
            assert len(a.out["tokens"][0]) == 12
            assert done["idle"] is True
        finally:
            app.end_drain("shutdown")  # restore for sibling tests
        assert _get(port, "/healthz")[0] == 200


def test_supervisor_giveup_drains_engine_failed(booted):
    # Past the restart budget the engine is dead and the server drains
    # for good: /healthz 503 "draining: engine-failed".
    b = booted("--slots", "1", "--max-restarts", "0", "--step-retries",
               "0")
    eng = b.app.engine

    def broken(*a, **k):
        raise RuntimeError("injected decode fault")

    eng._decode_fn = broken
    e = _post_error(b.port, {"prompt": [[1, 2]], "max_new": 3})
    assert e.code == 500
    _wait_for(lambda: "engine-failed" in b.app.draining(), "the giveup")
    code, _, body = _get(b.port, "/healthz")
    assert (code, body) == (503, b"draining: engine-failed")
    parsed = parse_text(_get(b.port, "/metrics")[2].decode())
    assert parsed["serve_drain_reason"]['{reason="engine-failed"}'] == 1.0


def test_flight_recorder_dump(booted, capsys):
    b = booted("--slots", "1")
    _post(b.port, {"prompt": [[1, 2, 3]], "max_new": 2})
    b.app.dump_flight_recorder("test")
    assert "engine flight recorder (test [engine 0])" in capsys.readouterr().err
    quiet = booted("--slots", "1", "--no-observe")
    quiet.app.dump_flight_recorder("test")
    assert "no flight recorder to dump" in capsys.readouterr().err


# -- configuration and the process entry point ---------------------------
def test_config_derives_the_reference_rules():
    cfg = S.parse_args([])
    assert (cfg.model, cfg.port, cfg.device, cfg.engine) == (
        "resnet50", 8500, "cuda", "continuous")
    assert cfg.heads == 4 and cfg.slots == 16 and cfg.grid == 16
    assert cfg.max_queue == 128 and cfg.retry_after_s == 1
    cfg = S.parse_args(["--dim", "1024", "--max-gen-batch", "4",
                        "--max-seq", "24", "--max-queue", "2",
                        "--retry-after-s", "2.7"])
    assert cfg.heads == 8 and cfg.slots == 4 and cfg.grid == 12
    assert cfg.max_queue == 4 and cfg.retry_after_s == 2
    assert S.HEALTH_CRITICAL == {1, 2, 3, 4, 5, 1000}


@pytest.mark.parametrize("flags,item", [
    (["--fleet", "2", "--mesh", "dp"], "A10"),
    (["--fleet-procs", "2", "--health-source", "auto"], "A12"),
    (["--fleet-affinity", "0", "--mesh", "dp"], "A10"),
    (["--fleet-roles", "prefill:1,decode:1", "--health-source", "auto"],
     "A12"),
    (["--mesh", "dp"], "A10"),
    (["--health-source", "auto"], "A12"),
])
def test_unported_flags_exit_2(flags, item, capsys):
    # Both items are ported now: main takes these flags and stops only
    # at the missing card (this box has none), naming no ROADMAP item;
    # an unknown value of either flag still exits 2.
    if torch.cuda.is_available():
        pytest.skip("a card is present: the server would serve on it")
    assert S.main([*TINY, *flags, "--device", "cuda"]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "ROADMAP" not in err
    bad = (["--mesh", "tp"] if item == "A10"
           else ["--health-source", "libtpu-sdk"])
    with pytest.raises(SystemExit) as e:
        S.main([*TINY, *flags, *bad])
    assert e.value.code == 2


def test_no_card_without_device_cpu_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the server would serve on it")
    assert S.main(["--model", "transformer_lm", "--port", "0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_process_serves_drains_on_sigterm_and_dumps_on_sigquit():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "container_engine_accelerators_tpu_torch."
         "server", *TINY, "--port", "0", "--slots", "2"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env,
    )
    lines = []
    reader = threading.Thread(
        target=lambda: lines.extend(iter(proc.stderr.readline, "")),
        daemon=True)
    reader.start()
    try:
        def port():
            for line in list(lines):
                m = re.search(r"listening on port (\d+)", line)
                if m:
                    return int(m.group(1))
            return None

        _wait_for(lambda: port() is not None or proc.poll() is not None,
                  "the port line", timeout=120)
        assert proc.poll() is None, "".join(lines)
        p = port()
        _wait_for(lambda: _get(p, "/healthz")[0] == 200, "readiness",
                  timeout=120)
        out = _post(p, {"prompt": [[1, 2, 3]], "max_new": 4})
        assert len(out["tokens"][0]) == 4 and out["trace_id"]
        proc.send_signal(signal.SIGQUIT)
        _wait_for(lambda: any("engine flight recorder (SIGQUIT" in line
                              for line in list(lines)), "the dump")
        assert proc.poll() is None  # serving undisturbed
        assert _get(p, "/healthz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        reader.join(30)
    text = "".join(lines)
    assert "SIGTERM received, draining" in text
    assert "DRAINING (shutdown)" in text
