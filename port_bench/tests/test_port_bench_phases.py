"""The readers of the engine's phase counters (port_bench/metrics/
*_share.decode.py over serving/engine.py's `stats`): each a share of
the window or of the longer stretch its counters cover, nothing where
the program keeps no such counter, and the starved parts within the
whole on a traced run of a tiny cell."""

import math

import pytest

from port_bench import run, spec
from port_bench.tests import tiny

READS = {
    "starved_share.decode": "starved_ns",
    "starved_commit_share.decode": "starved_commit_ns",
    "starved_admit_share.decode": "starved_admit_ns",
    "launch_idle_share.decode": "launch_idle_ns",
    "sync_wait_share.decode": "phase_sync_ns",
}
BENCH = spec.Bench()


def _reader(name):
    return BENCH.reader(next(m for m in BENCH.doc["per_layer"]
                             if m["name"] == name))


@pytest.mark.parametrize("window_s, share", [(6.0, 12.5), (2.5, 25.0)])
@pytest.mark.parametrize("name", sorted(READS))
def test_share_of_the_longer_of_window_and_counters(name, window_s, share):
    # 3 s of scheduler time, a quarter of it synchronizing, starved,
    # ...: a share of the window where that is longer (the counters
    # folded short of its end), else of the counters' 3 s (a stall
    # folded before the reading).
    counters = dict.fromkeys(READS.values(), 750_000_000)
    counters.update(phase_wait_ns=2_000_000_000, phase_stage_ns=250_000_000,
                    steps=10)
    obs = {"counters": counters, "window_s": window_s}
    assert math.isclose(_reader(name).read(obs), share)


@pytest.mark.parametrize("name", sorted(READS))
def test_nothing_without_the_counter(name):
    # A program without the phase counters (the parent of the change
    # that brought them) gives no reading, and no error.
    obs = {"counters": {"steps": 10, "step_rows": 640}, "window_s": 3.0}
    assert _reader(name).read(obs) is None


def test_traced_run_reads_every_share(tmp_path):
    bench = tiny.write(str(tmp_path))
    _, line = run.run_cell(bench, "gpt2xl.decode", 2 ** 31 + 91, 1.5, 1,
                           device="cpu")
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(READS) <= set(m)
    assert all(0.0 <= m[k] <= 100.0 for k in READS)
    assert (m["starved_commit_share.decode"]
            + m["starved_admit_share.decode"]
            <= m["starved_share.decode"] + 1e-9)
