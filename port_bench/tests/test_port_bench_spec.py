"""BENCHMARK.json against the contract's rules, and every file it names
found and loaded by name."""

import os
import re

import pytest

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.Bench()
DOC = BENCH.doc


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["port_bench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert os.path.getsize(BENCH.path) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in DOC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in DOC["workloads"] + DOC["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_files_load_by_name(cell):
    w = BENCH.cell(cell)
    cfg, mix = BENCH.config(w), BENCH.traffic(w)
    assert cfg["name"] == w["config"] and cfg["kind"] in ("serve", "train")
    assert spec.driver(cfg["kind"]).run
    assert mix["loop"] in ("closed", "open", "steps")
    e2e = [m["name"] for m in BENCH.end_to_end(w)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert BENCH.per_layer(w)


@pytest.mark.parametrize("metric", [m["name"] for m in DOC["per_layer"]])
def test_metric_readers_load_by_name(metric):
    m = next(x for x in DOC["per_layer"] if x["name"] == metric)
    assert callable(BENCH.reader(m).read)
    moved = next(x for x in DOC["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert BENCH._applies(moved, BENCH.cell(cell))


def test_configs_files_match_entries():
    for c in DOC["configs"]:
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert cfg[key] != cfg["source_values"][key]


def test_bounds():
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
