"""The reader of the engine's `prefill_replays` counter
(port_bench/metrics/prefill_graph_share.decode.py): replays over
admissions in percent, nothing where the program keeps no such counter
or admitted nothing, and 0 on a traced CPU run of a tiny cell, where
every seam is called eagerly."""

import math

import pytest

from port_bench import run, spec
from port_bench.tests import tiny

NAME = "prefill_graph_share.decode"
BENCH = spec.Bench()


def _reader():
    return BENCH.reader(next(m for m in BENCH.doc["per_layer"]
                             if m["name"] == NAME))


@pytest.mark.parametrize("replays, admitted, share",
                         [(9, 12, 75.0), (12, 12, 100.0), (0, 5, 0.0)])
def test_share_of_admissions(replays, admitted, share):
    obs = {"counters": {"prefill_replays": replays, "admitted": admitted,
                        "prefill_chunks": admitted},
           "window_s": 3.0}
    assert math.isclose(_reader().read(obs), share)


@pytest.mark.parametrize("counters", [
    {"admitted": 12, "prefill_chunks": 12},  # a program without it
    {"prefill_replays": 0, "admitted": 0},   # nothing admitted
])
def test_nothing_to_read(counters):
    assert _reader().read({"counters": counters, "window_s": 3.0}) is None


def test_traced_cpu_run_reads_no_replay(tmp_path):
    bench = tiny.write(str(tmp_path))
    _, line = run.run_cell(bench, "gpt2xl.decode", 2 ** 31 + 93, 1.5, 1,
                           device="cpu")
    assert line["metrics"][NAME]["value"] == 0.0
