"""A benchmark of tiny cells laid out as BENCHMARK.json and its files,
written into a directory, so a test drives whole runs on the CPU."""

from __future__ import annotations

import json
import os
import shutil

from port_bench import spec

SMALL = {"n_embd": 64, "n_layer": 2, "n_head": 4, "vocab_size": 256}


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def write(root):
    """A copy of the real benchmark at tiny sizes under `root`: every
    metric reader as it is, the configurations and mixes shrunk.
    Returns spec.Bench over it."""
    real = spec.Bench()
    base = os.path.join(root, "port_bench")
    for sub in ("configs", "traffic", "metrics"):
        os.makedirs(os.path.join(base, sub))
    for m in real.doc["per_layer"]:
        shutil.copy(os.path.join(real.base, "metrics", m["name"] + ".py"),
                    os.path.join(base, "metrics"))
    for c in real.doc["configs"]:
        cfg = dict(real.config({"config": c["name"]}), **SMALL)
        if cfg["kind"] == "serve":
            cfg.update(n_positions=128)
            cfg["engine"] = dict(cfg["engine"], slots=4, kv_pages=64,
                                 page_size=16, prefill_chunk=32,
                                 decode_steps=4, max_queue=32)
        else:
            # bf16 on the CPU at this size rounds the loss ~1e-4 apart
            # from the f32 reference (the card's cells ~2e-5): the loss
            # limit here is this size's own.
            cfg.update(n_positions=64, check=dict(cfg["check"], loss=1e-3))
        _dump(os.path.join(base, "configs", c["name"] + ".json"), cfg)
    small = {
        "decode": dict(clients=4, warm_s=0.3, trace_s=0.5, check_requests=4,
                       prompt_len={"dist": "uniform", "lo": 8, "hi": 24},
                       output_len={"dist": "uniform", "lo": 16, "hi": 32},
                       first_output_len={"dist": "uniform", "lo": 4,
                                         "hi": 32}),
        "chat": dict(rate_per_s=6.0, lead_s=0.3, trace_s=0.5,
                     check_requests=4, drain_s=30,
                     system_prompts={"count": 4, "len": 32, "zipf": 1.0},
                     prompt_len={"dist": "lognormal", "median": 12,
                                 "sigma": 0.6, "lo": 4, "hi": 32},
                     output_len={"dist": "lognormal", "median": 12,
                                 "sigma": 0.6, "lo": 4, "hi": 32}),
        "train": dict(batch=4, seq_len=64, trace_s=0.5),
    }
    for w in real.doc["workloads"]:
        mix = dict(real.traffic(w), **small[w["traffic"]])
        _dump(os.path.join(base, "traffic", w["traffic"] + ".json"), mix)
    # An open-loop cell of the tests' own (no such cell is benchmarked
    # yet): shared system prompts, arrivals at a rate, TTFT.
    _dump(os.path.join(base, "traffic", "chat.json"), dict(
        loop="open", **small["chat"]))
    with open(os.path.join(base, "metrics", "prefix_hit_share.chat.py"),
              "w") as f:
        f.write("def read(obs):\n"
                "    c = obs['counters']\n"
                "    return 100.0 * c['prefix_hit_tokens'] / "
                "max(1, c['prefix_lookup_tokens'])\n")
    doc = real.doc
    doc["workloads"].append({"name": "gpt2xl.chat", "config": "gpt2-xl",
                             "traffic": "chat", "chips": 1, "why": "tests"})
    doc["end_to_end"].append({"name": "ttft_p95_ms", "unit": "ms",
                              "better": "lower", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["gpt2xl.chat"]})
    for m in doc["end_to_end"]:
        if m["name"] == "itl_p95_ms":
            m["workloads"].append("gpt2xl.chat")
    doc["per_layer"].append({"name": "prefix_hit_share.chat", "unit": "%",
                             "better": "higher", "source": "program_counter",
                             "layer": "engine", "moves": "ttft_p95_ms",
                             "workloads": ["gpt2xl.chat"]})
    path = os.path.join(root, "BENCHMARK.json")
    _dump(path, doc)
    return spec.Bench(path, base)
