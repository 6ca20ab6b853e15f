"""The port's server against the reference's (demo/serving/server.py,
booted through importlib with its environment, as its own tests boot
it; nothing in demo/ changes): the bucket ladder and the quant policy
over sweeps at several max_seq, and greedy tokens over HTTP from both
servers holding the same f32 weights, on the wave batcher and on the
continuous engine, bf16-path and int8."""

import importlib.util
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import draw_params, port_model, rand_prompt
from container_engine_accelerators_tpu.models import generate as RG
from container_engine_accelerators_tpu.utils import checkpoint as RC
from container_engine_accelerators_tpu_torch import server as S

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab=64, dim=32, depth=1, heads=1, max_seq=32)


def _reference(name, env):
    """A fresh import of the reference server under `env` (restored by
    the returned MonkeyPatch's undo)."""
    mp = pytest.MonkeyPatch()
    for k in list(os.environ):
        if k.startswith("SERVE_"):
            mp.delenv(k)
    for k, v in env.items():
        mp.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "demo", "serving", "server.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mp


@pytest.mark.parametrize("max_seq,bucket_min", [
    (24, 16), (32, 16), (100, 16), (1280, 16), (64, 8)])
def test_bucket_ladder_matches_reference(max_seq, bucket_min):
    mod, mp = _reference(f"ladder_{max_seq}_{bucket_min}", {
        "SERVE_LM_MAX_SEQ": str(max_seq),
        "SERVE_LM_BUCKET_MIN": str(bucket_min)})
    try:
        cfg = S.parse_args(["--max-seq", str(max_seq), "--bucket-min",
                            str(bucket_min)])
        assert cfg.grid == mod.LM_GRID
        step = 1 if max_seq <= 128 else 7
        checked = 0
        for p_len in range(1, max_seq, step):
            for max_new in range(1, max_seq - p_len + 1, step):
                try:
                    want = mod.pick_buckets(p_len, max_new)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        S.pick_buckets(p_len, max_new, cfg.grid, max_seq)
                    assert str(got.value) == str(e)
                    continue
                assert S.pick_buckets(p_len, max_new, cfg.grid,
                                      max_seq) == want, (p_len, max_new)
                checked += 1
        assert checked > 0
    finally:
        mp.undo()


@pytest.mark.parametrize("env_mode,mode", [
    ("auto", "auto"), ("1", "on"), ("0", "off"), ("true", "on")])
@pytest.mark.parametrize("max_batch", [16, 4])
def test_quant_policy_matches_reference(env_mode, mode, max_batch):
    mod, mp = _reference(f"quant_{env_mode}_{max_batch}", {
        "SERVE_LM_QUANT": env_mode,
        "SERVE_LM_QUANT_MAX_BATCH": str(max_batch)})
    try:
        assert mod.LM_QUANT_MODE == mode
        for b in (1, 2, 3, 4, 8, 16, 17, 32, 64):
            assert S.pick_quant(b, mode, max_batch) == mod.pick_quant(b), b
    finally:
        mp.undo()


def _serve_reference(name, env, ckpt_dir, monkeypatch):
    """The reference server booted in f32 (make_decoder forced to f32 in
    this test only) over a checkpoint of numpy-drawn weights; returns
    (module, httpd, MonkeyPatch)."""
    real = RG.make_decoder
    monkeypatch.setattr(
        RG, "make_decoder", lambda **kw: real(dtype=jnp.float32, **kw))
    mod, mp = _reference(name, {
        "SERVE_MODEL": "transformer_lm", "SERVE_LM_DIM": "32",
        "SERVE_LM_DEPTH": "1", "SERVE_LM_VOCAB": "64",
        "SERVE_LM_MAX_SEQ": "32", "SERVE_LM_SLOTS": "4",
        "SERVE_LM_CHECKPOINT": str(ckpt_dir), **env})
    httpd = mod.Server(("127.0.0.1", 0), mod.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    mod.load_model()
    return mod, httpd, mp


def _served_params(mod):
    """The reference server's live param tree, as
    tests/test_serving_demo.py's _server_params reads it (the wave
    batcher's run_group closure), or the engine's."""
    if mod._engine is not None:
        return mod._engine._params
    fn = mod._batcher._run_group
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
        if name == "params":
            return cell.cell_contents
    raise AssertionError("run_group has no params free variable")


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())["tokens"]


REQUESTS = [
    {"prompt": rand_prompt(1, 5, 64).tolist(), "max_new": 9},
    {"prompt": rand_prompt(2, 13, 64).tolist(), "max_new": 12},
    {"prompt": np.concatenate([rand_prompt(3, 7, 64),
                               rand_prompt(4, 7, 64)]).tolist(),
     "max_new": 6},
]


@pytest.mark.parametrize("quant", ["off", "on"])
@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_greedy_tokens_over_http_match_reference(engine, quant, tmp_path,
                                                 monkeypatch):
    params = draw_params(0, CFG)
    RC.save_checkpoint(str(tmp_path),
                       {"params": jax.tree_util.tree_map(jnp.asarray,
                                                         params)}, 1)
    mod, ref_httpd, mp = _serve_reference(
        f"parity_{engine}_{quant}",
        {"SERVE_LM_ENGINE": engine,
         "SERVE_LM_QUANT": "1" if quant == "on" else "0"},
        tmp_path, monkeypatch)
    app = httpd = None
    try:
        served = jax.tree_util.tree_map(np.asarray, _served_params(mod))
        model = port_model(served, CFG)
        assert model.dtype == torch.float32
        app = S.ServingApp(S.parse_args([
            "--model", "transformer_lm", "--dim", "32", "--depth", "1",
            "--vocab", "64", "--max-seq", "32", "--slots", "4",
            "--engine", engine, "--quant", quant, "--device", "cpu"]))
        app.load_model(model=model)
        httpd = app.make_server("127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        for body in REQUESTS:
            want = _post(ref_httpd.server_address[1], body)
            assert len({t for row in want for t in row}) > 1, want
            assert _post(httpd.server_address[1], body) == want, body
    finally:
        ref_httpd.shutdown()
        if mod._supervisor is not None:
            mod._supervisor.stop()
        if mod._engine is not None:
            mod._engine.close()
        if mod._batcher is not None:
            mod._batcher.close()
        mp.undo()
        if httpd is not None:
            httpd.shutdown()
        if app is not None:
            app.close()


@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_mesh_dp_tokens_over_http_match_reference(engine, tmp_path,
                                                  monkeypatch):
    # --mesh dp on both servers: the reference over its 8 virtual CPU
    # devices (SERVE_LM_MESH=dp), the port over 8 CPU shards; both round
    # the 4 slots up to 8 and turn the int8 path off.
    params = draw_params(0, CFG)
    RC.save_checkpoint(str(tmp_path),
                       {"params": jax.tree_util.tree_map(jnp.asarray,
                                                         params)}, 1)
    mod, ref_httpd, mp = _serve_reference(
        f"mesh_{engine}", {"SERVE_LM_ENGINE": engine, "SERVE_LM_MESH": "dp"},
        tmp_path, monkeypatch)
    app = httpd = None
    try:
        served = jax.tree_util.tree_map(np.asarray, _served_params(mod))
        app = S.ServingApp(S.parse_args([
            "--model", "transformer_lm", "--dim", "32", "--depth", "1",
            "--vocab", "64", "--max-seq", "32", "--slots", "4",
            "--engine", engine, "--device", "cpu", "--mesh", "dp",
            "--cpu-mesh-shards", "8"]))
        app.load_model(model=port_model(served, CFG))
        assert app.cfg.quant == mod.LM_QUANT_MODE == "off"
        assert app.mesh.size == 8
        if engine == "continuous":
            assert app.engine.n_slots == mod._engine.n_slots == 8
            assert len(app.engine._cache) == 8
        httpd = app.make_server("127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        for body in REQUESTS:
            want = _post(ref_httpd.server_address[1], body)
            assert len({t for row in want for t in row}) > 1, want
            assert _post(httpd.server_address[1], body) == want, body
    finally:
        ref_httpd.shutdown()
        if mod._supervisor is not None:
            mod._supervisor.stop()
        if mod._engine is not None:
            mod._engine.close()
        if mod._batcher is not None:
            mod._batcher.close()
        mp.undo()
        if httpd is not None:
            httpd.shutdown()
        if app is not None:
            app.close()
