"""The moonlight cell's files: each new reader over a made-up `obs`
(None where its counter or kernel is missing), and whole runs of the
train_moe driver at a tiny size on the CPU through run.run_cell: a sound
run is correct, a traced one reads the model's counters, and a fault
under the timed path comes out not correct."""

import json
import os

import pytest

from port_bench import run, spec
from port_bench.trace import Trace

from container_engine_accelerators_tpu_torch.ops import grouped_mm as GM
from container_engine_accelerators_tpu_torch.parallel import moe as MOE

CELL = "moonlight.train8k"
METRICS = ("mfu.train8k", "mla_flash_roofline.train8k",
           "expert_gemm_roofline.train8k", "expert_load_max.train8k",
           "idle_share.train8k")
# The configuration's widths at a test's size: 3 layers (one dense), 8 of
# 16 experts held, 6 a token.
SMALL = {"hidden_size": 64, "num_hidden_layers": 3,
         "num_attention_heads": 2, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "intermediate_size": 96, "moe_intermediate_size": 24,
         "n_routed_experts": 8, "experts_total": 16, "vocab_size": 256}
SEED = 2 ** 31 + 91


def _reader(name):
    bench = spec.Bench()
    return bench.reader(next(m for m in bench.doc["per_layer"]
                             if m["name"] == name))


def _cfg():
    bench = spec.Bench()
    return bench.config(bench.cell(CELL))


def _obs(counters=True, ops=()):
    cfg = _cfg()
    obs = {"model": cfg, "batch": 8, "seq_len": 8192, "steps": 10,
           "window_s": 5.0,
           "trace": Trace(list(ops), [], 5.0)}
    if counters:
        obs["counters"] = {"moe_routes": 10 * 6 * 65536 * 6,
                           "moe_held_routes": 60 * 49152,
                           "moe_load_max": 60 * 7373,
                           "moe_layer_steps": 60, "bias_updates": 60}
    return obs


def test_readers_over_made_up_obs():
    ms = 1_000_000
    ops = [("flash_fwd_kernel", 0, 20 * ms),
           ("flash_bwd_dq_kernel", 20 * ms, 70 * ms),
           ("flash_bwd_dkdv_kernel", 70 * ms, 100 * ms),
           ("cutlass::GroupProblemShape<...>", 100 * ms, 110 * ms),
           ("prepare_grouped_gemm_data", 110 * ms, 111 * ms),
           ("nvjet_gemm", 200 * ms, 4000 * ms)]
    obs = _obs(ops=ops)
    got = {m: _reader(m).read(obs) for m in METRICS}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["expert_load_max.train8k"] == pytest.approx(7373 * 8 / 49152)
    assert got["idle_share.train8k"] == pytest.approx(
        100 * (1 - 3.911 / 5.0))
    # The held routes' work over the grouped kernels' 11 ms.
    want = 100 * 3 * 60 * 49152 * 2 * 3 * 2048 * 1408 / 989e12 / 0.011
    assert got["expert_gemm_roofline.train8k"] == pytest.approx(want)
    for m in ("mfu.train8k", "expert_gemm_roofline.train8k",
              "expert_load_max.train8k"):
        assert _reader(m).read(_obs(counters=False, ops=ops)) is None, m
    # No flash or grouped kernel in the trace: nothing to read.
    bare = _obs(ops=[("nvjet_gemm", 0, ms)])
    assert _reader("mla_flash_roofline.train8k").read(bare) is None
    assert _reader("expert_gemm_roofline.train8k").read(bare) is None


def test_flash_roofline_counts_true_widths():
    """The padded v (192) is not counted: p . v at 128."""
    from port_bench.reference import counts_moonlight as C

    cfg = _cfg()
    pairs = 8 * 16 * 8192 * 8193 // 2
    assert C.mla_fwd_flops(cfg, 8, 8192) == 2 * pairs * (192 + 128)
    assert C.mla_bwd_flops(cfg, 8, 8192) == 2 * pairs * (3 * 192 + 2 * 128)
    # ~351 M weights a token meets forward: 6 MoE layers, each with
    # 6 x 8 / 64 = 0.75 routes to a held expert.
    per_token = C.token_flops(cfg) / 2 + 6 * 0.75 * (
        C.expert_route_flops(cfg) / 2)
    assert 345e6 < per_token < 355e6


def _write(root, check=None):
    """A benchmark of the one moonlight cell at SMALL widths under
    `root`; its readers as they are."""
    real = spec.Bench()
    base = os.path.join(root, "port_bench")
    for sub in ("configs", "traffic", "metrics"):
        os.makedirs(os.path.join(base, sub))
    cell = real.cell(CELL)
    cfg = dict(real.config(cell), **SMALL)
    # bf16 on the CPU at this size (64 tokens a step, 64 wide) rounds the
    # loss ~3e-3 apart from the f32 reference: the limits are this size's
    # own.
    cfg["check"] = dict(cfg["check"], loss=1e-2, balance=2e-2, grad=0.2,
                        change=0.2, route_agree_min=0.9, **(check or {}))
    with open(os.path.join(base, "configs", cfg["name"] + ".json"),
              "w") as f:
        json.dump(cfg, f)
    mix = dict(real.traffic(cell), batch=2, seq_len=32, trace_s=0.5)
    with open(os.path.join(base, "traffic", cell["traffic"] + ".json"),
              "w") as f:
        json.dump(mix, f)
    for m in METRICS:
        src = os.path.join(real.base, "metrics", m + ".py")
        with open(src) as f, open(os.path.join(base, "metrics", m + ".py"),
                                  "w") as g:
            g.write(f.read())
    doc = dict(real.doc)
    doc["configs"] = [c for c in doc["configs"] if c["name"] == cfg["name"]]
    doc["workloads"] = [cell]
    doc["end_to_end"] = [dict(m, workloads=[CELL]) if "workloads" in m
                         else m for m in doc["end_to_end"]
                         if m["name"] in ("train_step_ms", "setup_s")]
    doc["per_layer"] = [m for m in doc["per_layer"] if m["name"] in METRICS]
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return spec.Bench(path, base)


@pytest.fixture
def bench(tmp_path):
    return _write(str(tmp_path))


def test_sound_run_is_correct(bench):
    out, line = run.run_cell(bench, CELL, SEED, 1.0, 0, device="cpu")
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    checks = line["checks"]
    assert checks["route_agree"]["value"] >= checks["route_agree"]["limit"]
    assert checks["bias"]["value"] == 0.0
    assert out.attempted > 0


def test_traced_run_reads_the_counters(bench):
    out, line = run.run_cell(bench, CELL, SEED + 1, 1.0, 1, device="cpu")
    assert line["correct"] is True, line["checks"]
    c = out.obs["counters"]
    steps = out.obs["steps"]
    assert c["moe_layer_steps"] == 2 * steps == c["bias_updates"]
    assert c["moe_routes"] == c["moe_layer_steps"] * 2 * 32 * 6
    assert 0 < c["moe_held_routes"] < c["moe_routes"]
    assert {"mfu.train8k", "expert_load_max.train8k",
            "idle_share.train8k"} <= set(line["metrics"])
    assert line["metrics"]["expert_load_max.train8k"]["value"] >= 1.0


def _no_bias_update(monkeypatch):
    monkeypatch.setattr(MOE.HeldExperts, "update_bias",
                        lambda self, gamma: self.load.zero_())


def _held_experts_add_nothing(monkeypatch):
    plain = GM.grouped_mm_plain
    monkeypatch.setattr(GM, "grouped_mm_plain",
                        lambda x, w, offs: plain(x, w, offs) * 0)


def _routes_shifted(monkeypatch):
    route = MOE.HeldExperts.route

    def shifted(self, x, seqs):
        gates, choice = route(self, x, seqs)
        return gates, (choice + 1) % self.n_experts

    monkeypatch.setattr(MOE.HeldExperts, "route", shifted)


@pytest.mark.parametrize("fault,fails", [
    (_no_bias_update, "bias"),
    (_held_experts_add_nothing, "loss"),
    (_routes_shifted, "route_agree"),
])
def test_a_fault_is_not_correct(bench, monkeypatch, fault, fails):
    fault(monkeypatch)
    _, line = run.run_cell(bench, CELL, SEED + 2, 0.5, 0, device="cpu")
    assert line["correct"] is False
    row = line["checks"][fails]
    if fails == "route_agree":
        assert row["value"] < row["limit"]
    else:
        assert row["value"] > row["limit"]
