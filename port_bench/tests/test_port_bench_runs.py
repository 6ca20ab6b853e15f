"""Whole runs of tiny cells on the CPU, past the chip look: sound runs
come out correct, each fault the cells can have under the timed path
comes out not correct, and a cell added from files alone runs."""

import json
import os

import pytest

from port_bench import run
from port_bench.tests import tiny

from container_engine_accelerators_tpu_torch.models import generate as G
from container_engine_accelerators_tpu_torch.models import transformer as T

CELLS = ["gpt2xl.decode", "gpt2m.train", "gpt2xl.chat"]
SEED = 2 ** 31 + 77


@pytest.fixture
def bench(tmp_path):
    return tiny.write(str(tmp_path))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    out, line = run.run_cell(bench, cell, SEED, 1.5, 0, device="cpu")
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in bench.end_to_end(bench.cell(cell))}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "checks" and line["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_per_layer_metrics(bench, cell):
    _, line = run.run_cell(bench, cell, SEED + 1, 1.5, 1, device="cpu")
    names = {m["name"] for m in bench.per_layer(bench.cell(cell))}
    assert set(line["metrics"]) <= names and line["metrics"]
    assert line["correct"] is True
    assert {"device_ops", "idle_gaps"} <= set(line["breakdown"])


def _token_altered(monkeypatch):
    sample = G._sample

    def altered(logits, *a, **k):
        return (sample(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(G, "_sample", altered)


def _prefill_writes_nothing(monkeypatch):
    monkeypatch.setattr(G, "paged_scatter_row", lambda cache, *a, **k: cache)


def _optimizer_does_nothing(monkeypatch):
    build = T._adamw

    def still(model, lr):
        opt = build(model, lr)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(T, "_adamw", still)


def _half_batch(monkeypatch):
    loss = T.cross_entropy_loss

    def half(logits, labels):
        n = logits.shape[0] // 2
        return loss(logits[:n], labels[:n])

    monkeypatch.setattr(T, "cross_entropy_loss", half)


FAULTS = [
    ("gpt2xl.decode", _token_altered),
    ("gpt2xl.decode", _prefill_writes_nothing),
    ("gpt2xl.chat", _token_altered),
    ("gpt2xl.chat", _prefill_writes_nothing),
    ("gpt2m.train", _optimizer_does_nothing),
    ("gpt2m.train", _half_batch),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_under_the_timed_path_is_not_correct(bench, monkeypatch, cell,
                                                   fault):
    fault(monkeypatch)
    _, line = run.run_cell(bench, cell, SEED, 1.5, 0, device="cpu")
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_cell_added_from_files_alone_runs(bench, tmp_path):
    base = bench.base
    mix = json.load(open(os.path.join(base, "traffic", "decode.json")))
    mix.update(clients=2, output_len={"dist": "uniform", "lo": 8, "hi": 12})
    json.dump(mix, open(os.path.join(base, "traffic", "pairs.json"), "w"))
    with open(os.path.join(base, "metrics", "tokens.pairs.py"), "w") as f:
        f.write("def read(obs):\n    return float(obs['out_tokens'])\n")
    doc = bench.doc
    doc["workloads"].append({"name": "gpt2xl.pairs", "config": "gpt2-xl",
                             "traffic": "pairs", "chips": 1, "why": "test"})
    for m in doc["end_to_end"]:
        if "workloads" in m and "gpt2xl.decode" in m["workloads"]:
            m["workloads"].append("gpt2xl.pairs")
    doc["per_layer"].append({"name": "tokens.pairs", "unit": "tokens",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "out_tok_s",
                             "workloads": ["gpt2xl.pairs"]})
    json.dump(doc, open(bench.path, "w"))
    fresh = type(bench)(bench.path, base)
    _, line = run.run_cell(fresh, "gpt2xl.pairs", SEED, 1.0, 0, device="cpu")
    assert line["correct"] and "out_tok_s" in line["metrics"]
    _, line = run.run_cell(fresh, "gpt2xl.pairs", SEED, 1.0, 1, device="cpu")
    assert line["metrics"]["tokens.pairs"]["value"] > 0
