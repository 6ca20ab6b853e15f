"""The port's server over a fleet (server.py --fleet / --fleet-procs):
greedy tokens over HTTP from the port's in-process fleet equal the
reference server's fleet (SERVE_LM_FLEET, booted through importlib as
tests/test_torch_server_parity.py boots it) on the same f32 weights; a
process fleet's server gives the in-process fleet's tokens; /statz,
/tracez and /metrics show the replicas; the last replica's eviction
drains the server; the flags' rules; and the process entry point in
both modes, drained by SIGTERM with its workers reaped.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import draw_params, port_model, rand_prompt
from conftest import wait_until
from container_engine_accelerators_tpu.utils import checkpoint as RC
from container_engine_accelerators_tpu_torch import server as S
from container_engine_accelerators_tpu_torch.serving import faults as F
from container_engine_accelerators_tpu_torch.serving import observe
from test_torch_server_parity import (
    CFG, REQUESTS, _post, _serve_reference,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model", "transformer_lm", "--dim", "32", "--depth", "1",
        "--vocab", "64", "--max-seq", "32", "--slots", "2",
        "--device", "cpu"]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _boot(flags, model=None):
    app = S.ServingApp(S.parse_args(flags))
    httpd = app.make_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    app.load_model(model=model)
    return app, httpd


def _stop(app, httpd):
    httpd.shutdown()
    httpd.server_close()
    app.close()


@pytest.mark.parametrize("quant", ["off", "on"])
def test_fleet_tokens_over_http_match_the_reference_fleet(
        quant, tmp_path, monkeypatch):
    params = draw_params(0, CFG)
    RC.save_checkpoint(str(tmp_path), {"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, 1)
    mod, ref_httpd, mp = _serve_reference(
        f"fleet_parity_{quant}",
        {"SERVE_LM_FLEET": "2", "SERVE_LM_QUANT": "1" if quant == "on"
         else "0"}, tmp_path, monkeypatch)
    app = httpd = None
    try:
        assert mod._fleet is not None and len(mod._fleet.replicas) == 2
        served = jax.tree_util.tree_map(
            np.asarray, mod._fleet.replicas[0].engine._params)
        app, httpd = _boot([
            "--model", "transformer_lm", "--dim", "32", "--depth", "1",
            "--vocab", "64", "--max-seq", "32", "--slots", "4",
            "--quant", quant, "--device", "cpu", "--fleet", "2"],
            model=port_model(served, CFG))
        assert app.fleet is not None and app.engine is None
        for body in REQUESTS:
            want = _post(ref_httpd.server_address[1], body)
            assert len({t for row in want for t in row}) > 1, want
            assert _post(httpd.server_address[1], body) == want, body
        ref_snap, snap = mod._fleet.snapshot(), app.fleet.snapshot()
        assert snap["fleet"]["completed"] == ref_snap["fleet"]["completed"]
        assert snap["router"] == ref_snap["router"]
    finally:
        ref_httpd.shutdown()
        mod._fleet.close()
        mp.undo()
        if httpd is not None:
            _stop(app, httpd)


def test_process_fleet_serves_the_in_process_fleets_tokens(monkeypatch):
    # Both build the model from the flags (seed 0, bf16): the workers
    # through demo_lm_factory, the in-process fleet through the app.
    # One intra-op thread a worker (they inherit the environment).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    bodies = [{"prompt": rand_prompt(s, 6 + s, 64).tolist(), "max_new": 5}
              for s in range(4)]
    outs = {}
    for flag in ("--fleet", "--fleet-procs"):
        app, httpd = _boot(TINY + [flag, "2"])
        try:
            outs[flag] = [_post(httpd.server_address[1], b) for b in bodies]
            if flag == "--fleet-procs":
                pids = app.fleet.worker_pids()
                assert len(pids) == 2 and os.getpid() not in pids
        finally:
            _stop(app, httpd)
    assert outs["--fleet"] == outs["--fleet-procs"]


def test_routes_show_the_replicas_and_the_assembled_traces():
    app, httpd = _boot(TINY + ["--fleet", "2"])
    port = httpd.server_address[1]
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": [[1, 2, 3, 4]],
                             "max_new": 4}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert len(out["tokens"][0]) == 4 and out["trace_id"]
        code, body = _get(port, "/statz")
        stats = json.loads(body)
        assert code == 200 and stats["replica_states"] == ["up", "up"]
        assert stats["server_state"] == "serving"
        assert len(stats["engines"]) == 2
        code, body = _get(port, "/tracez")
        tz = json.loads(body)
        assert code == 200 and tz["enabled"]
        assert out["trace_id"] in {r["trace_id"] for r in tz["recent"]}
        assert {"placement", "decode"} <= set(tz["stages"])
        code, body = _get(port, "/metrics")
        parsed = observe.parse_text(body.decode())
        labels = set(parsed["serve_engine_admitted_total"])
        assert any('engine="0"' in lab for lab in labels)
        assert any('engine="1"' in lab for lab in labels)
        assert parsed["fleet_replicas_up"][""] == 2.0
        assert _get(port, "/healthz") == (200, b"ok")
    finally:
        _stop(app, httpd)


def test_last_replica_evicted_drains_the_server(capsys):
    app, httpd = _boot(TINY + ["--fleet", "2", "--max-restarts", "0",
                               "--step-retries", "0"])
    port = httpd.server_address[1]
    inj = F.FaultInjector(seed=0)
    for i in range(2):
        inj.plan(f"engine_death:{i}", fail_after=0, fail_n=10 ** 6)
    F.install_fleet_faults(app.fleet, inj)
    try:
        for s in range(12):
            if app.fleet.alive_count == 0:
                break
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"prompt": rand_prompt(s, 5, 64).tolist(),
                                 "max_new": 3}).encode())
            try:
                urllib.request.urlopen(req, timeout=60).read()
            except urllib.error.HTTPError:
                pass
        wait_until(lambda: app.fleet.replica_states() == ["dead", "dead"],
                   what="both replicas evicted")
        assert _get(port, "/healthz") == (503, b"draining: engine-failed")
        app.dump_flight_recorder("test")
        err = capsys.readouterr().err
        assert "[engine 0]" in err and "[engine 1]" in err
    finally:
        _stop(app, httpd)


def test_fleet_flags_and_their_rules():
    cfg = S.parse_args(TINY + ["--fleet", "2", "--fleet-affinity", "0",
                               "--fleet-roles", "prefill:1,decode:1",
                               "--fleet-migrate", "1", "--fleet-tcp", "1",
                               "--fleet-hb-s", "2.5"])
    assert (cfg.fleet, cfg.fleet_affinity, cfg.fleet_migrate,
            cfg.fleet_tcp, cfg.fleet_hb_s) == (2, False, True, True, 2.5)
    assert cfg.mesh == "" and cfg.health_source == ""
    assert S._parse_fleet_roles(cfg.fleet_roles, 2) == ["prefill",
                                                         "decode"]
    assert S._parse_fleet_roles("", 2) is None
    with pytest.raises(ValueError, match="role:count"):
        S._parse_fleet_roles("prefill", 1)
    with pytest.raises(ValueError, match="names 3 replicas"):
        S._parse_fleet_roles("prefill:1,decode:2", 2)
    with pytest.raises(ValueError, match="prefix cache"):
        S._check_fleet_migration_knobs(
            S.parse_args(TINY + ["--no-prefix-cache"]), ["decode"])
    with pytest.raises(ValueError, match="exclusive"):
        S.ServingApp(S.parse_args(TINY + ["--fleet", "2", "--fleet-procs",
                                          "2"])).load_model()
    with pytest.raises(ValueError, match="own model"):
        S.ServingApp(S.parse_args(TINY + ["--fleet-procs", "2"])
                     ).load_model(model=object())


def test_engine_kw_is_shared_by_every_mode():
    app = S.ServingApp(S.parse_args(TINY + ["--decode-steps", "4",
                                            "--spec-k", "0", "--fleet",
                                            "2"]))
    kw = app.engine_kw()
    assert kw["decode_steps"] == 4 and kw["quant"] is True
    assert kw["max_queue"] == app.cfg.max_queue
    app.load_model()
    try:
        for eng in app.fleet.engines:
            assert eng._decode_steps == 4 and eng.quant
            assert eng.n_slots == 2
    finally:
        app.close()


@pytest.mark.parametrize("mode", ["--fleet", "--fleet-procs"])
def test_process_serves_and_sigterm_drains_the_fleet(mode):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "container_engine_accelerators_tpu_torch."
         "server", *TINY, "--port", "0", mode, "2"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env)
    lines = []
    reader = threading.Thread(
        target=lambda: lines.extend(iter(proc.stderr.readline, "")),
        daemon=True)
    reader.start()

    def find(pattern):
        for line in list(lines):
            m = re.search(pattern, line)
            if m:
                return m
        return None

    try:
        wait_until(lambda: find(r"listening on port (\d+)")
                   or proc.poll() is not None, timeout=120,
                   what="the port line")
        assert proc.poll() is None, "".join(lines)
        port = int(find(r"listening on port (\d+)").group(1))
        wait_until(lambda: _get(port, "/healthz")[0] == 200, timeout=180,
                   what="readiness")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": [[1, 2, 3]], "max_new": 4}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert len(json.loads(resp.read())["tokens"][0]) == 4
        pids = []
        if mode == "--fleet-procs":
            m = find(r"pids \[(\d+), (\d+)\]")
            pids = [int(m.group(1)), int(m.group(2))]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, "".join(lines)
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        reader.join(30)
    text = "".join(lines)
    assert "DRAINING (shutdown)" in text
    if mode == "--fleet-procs":
        assert "draining worker processes" in text
